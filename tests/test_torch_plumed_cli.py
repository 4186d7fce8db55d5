"""The port's PLUMED driver module (deep_cartograph_torch/plumed/cli.py)
against the JAX package's, on the CPU: the command strings and the CRYST1
sanitizer equal; run_plumed runs a stub `plumed` script placed on a
temporary PATH (its output, a failing run, a timeout), and leaves the
calling process' working directory and environment as they were."""

import os
import stat

import pytest

from deep_cartograph_torch.plumed import cli as tcli
from deep_cartograph_tpu.plumed import cli as jcli

PDB = (
    "CRYST1    1.000    1.000    1.000  90.00  90.00  90.00 P 1           1\n"
    "ATOM      1  CA  ALA A   1       0.000   0.000   0.000  1.00  0.00           C\n"
    "END\n"
)
PDB_REAL_CELL = PDB.replace("CRYST1    1.000    1.000    1.000",
                            "CRYST1   50.000   50.000   50.000")


def test_flags_equal():
    assert tcli.TRAJ_FLAGS == jcli.TRAJ_FLAGS
    for suffix in tcli.TRAJ_FLAGS:
        assert tcli.get_traj_flag("t" + suffix.upper()) == jcli.get_traj_flag("t" + suffix.upper())
    for mod in (tcli, jcli):
        with pytest.raises(ValueError, match="Unsupported trajectory format"):
            mod.get_traj_flag("traj.nc")


def test_sanitize_and_commands_equal(tmp_path):
    for text, fixed in ((PDB, True), (PDB_REAL_CELL, False)):
        for mod, sub in ((tcli, "port"), (jcli, "jax")):
            folder = tmp_path / sub / str(fixed)
            folder.mkdir(parents=True)
            (folder / "top.pdb").write_text(text)
        port = tcli.sanitize_cryst1_record(str(tmp_path / "port" / str(fixed) / "top.pdb"), None)
        jax = jcli.sanitize_cryst1_record(str(tmp_path / "jax" / str(fixed) / "top.pdb"), None)
        assert os.path.basename(port) == os.path.basename(jax)
        assert open(port).read() == open(jax).read()
        assert port.endswith("_sanitized.pdb") == fixed
        if fixed:
            assert "CRYST1" not in open(port).read()
    out = tmp_path / "out"
    out.mkdir()
    (tmp_path / "in.pdb").write_text(PDB)
    cases = [
        ("plumed.dat", None, None, None),
        ("plumed.dat", "traj.dcd", 48, None),
        ("plumed.dat", "traj.xtc", None, None),
        ("plumed.dat", str(tmp_path / "in.pdb"), 1, str(out)),
    ]
    for args in cases:
        assert tcli.get_driver_command(*args) == jcli.get_driver_command(*args)
    assert tcli.get_driver_command("p.dat").endswith("--noatoms")


@pytest.fixture
def stub_plumed(tmp_path, monkeypatch):
    """A `plumed` on PATH that prints its arguments, working directory and
    PLUMED_KERNEL, fails on `fail`, and sleeps on `sleep`."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    script = bindir / "plumed"
    script.write_text(
        "#!/bin/sh\n"
        'if [ "$1" = fail ]; then echo "bad input" >&2; exit 3; fi\n'
        'if [ "$1" = sleep ]; then sleep 2; fi\n'
        'echo "args: $*"\n'
        'echo "cwd: $(pwd)"\n'
        'echo "kernel: ${PLUMED_KERNEL:-none}"\n'
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.delenv("PLUMED_KERNEL", raising=False)
    return bindir


def test_run_plumed_with_a_stub(stub_plumed, tmp_path):
    assert tcli.plumed_available()
    assert not tcli.plumed_available({"bin_path": "no-such-plumed"})
    work = tmp_path / "work"
    work.mkdir()
    cwd = os.getcwd()
    out, err = tcli.run_plumed("driver --noatoms", working_dir=str(work),
                               plumed_settings={"kernel_path": "/usr/local/lib/libplumedKernel.so",
                                                "env_commands": ["true"]})
    assert out.splitlines() == ["args: driver --noatoms", f"cwd: {work}",
                                "kernel: /usr/local/lib/libplumedKernel.so"]
    assert err == ""
    # the caller's working directory and environment are untouched
    assert os.getcwd() == cwd and "PLUMED_KERNEL" not in os.environ
    out, _ = tcli.run_plumed("driver")
    assert out.splitlines()[1:] == [f"cwd: {cwd}", "kernel: none"]
    with pytest.raises(RuntimeError, match="PLUMED execution failed: bad input"):
        tcli.run_plumed("fail")
    assert tcli.run_plumed("sleep", plumed_timeout=0.5) == (None, "TimeoutExpired")
    # the JAX package's run gives the same output where it does not leak
    assert jcli.run_plumed("driver --noatoms", working_dir=str(work))[0] == \
        tcli.run_plumed("driver --noatoms", working_dir=str(work))[0]
    assert os.getcwd() == cwd
