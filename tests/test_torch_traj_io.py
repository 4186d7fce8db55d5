"""The port's trajectory and topology readers and writers
(deep_cartograph_torch/io) against the JAX package's, on the CPU.

Every format one package writes reads bit-equal in the other, XTC files
are byte-equal, and the checks of the JAX package's own IO tests
(tests/test_io.py, tests/test_native.py) that concern these formats are
repeated on the port."""

import struct
import threading
import time

import numpy as np
import pytest

import deep_cartograph_torch.io.xtc as txtc
import deep_cartograph_tpu.io.xtc as jxtc
from deep_cartograph_torch.io import boxes as tboxes
from deep_cartograph_torch.io import traj as ttraj
from deep_cartograph_torch.io.crd import read_crd
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.io.trr import TRRError, count_trr_frames, read_trr, write_trr
from deep_cartograph_tpu.io import boxes as jboxes
from deep_cartograph_tpu.io import traj as jtraj
from deep_cartograph_tpu.io.topology import Topology as JTopology
from tests.fixtures import make_backbone_system
from tests.test_torch_jax_native import jax_native, jax_native_library  # noqa: F401

FORMATS = (".dcd", ".xtc", ".trr", ".pdb", ".xyz", ".crd", ".nc")


def coords_for(seed, n_frames=7, n_atoms=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_frames, n_atoms, 3)) * 9).astype(np.float32)


def write_gro(path, top, frames, box=(2.5, 3.0, 3.5)):
    """A multi-frame GROMACS .gro file of `frames` (Angstrom) over `top`."""
    with open(path, "w") as fh:
        for f, pos in enumerate(frames):
            fh.write(f"frame {f}\n{top.n_atoms:5d}\n")
            for i in range(top.n_atoms):
                x, y, z = pos[i] / 10.0
                fh.write(f"{int(top.resids[i]):>5}{str(top.resnames[i]):<5}"
                         f"{str(top.names[i]):>5}{i + 1:>5}{x:8.3f}{y:8.3f}{z:8.3f}\n")
            fh.write("".join(f"{b:10.5f}" for b in box) + "\n")


def assert_same_topology(got, want):
    for field in ("names", "resids", "resnames", "chain_ids", "segids", "elements",
                  "record_types"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    for field in ("positions", "occupancies", "bfactors"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got.bonds is None) == (want.bonds is None)
    if got.bonds is not None:
        np.testing.assert_array_equal(got.bonds, want.bonds)


# ---------------------------------------------------------------------------
# Cross-package round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suffix", FORMATS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_format_reads_equal_in_both_packages(tmp_path, ca_system, suffix, writer):
    coords = coords_for(len(suffix))
    coords = coords[:, : ca_system.n_residues] if suffix in (".pdb", ".crd") else coords
    path = str(tmp_path / f"t{suffix}")
    if writer == "jax":
        jtraj.write_traj(path, coords, JTopology.from_pdb(ca_system.pdb_path))
    else:
        ttraj.write_traj(path, coords, Topology.from_pdb(ca_system.pdb_path))
    top = ca_system.pdb_path if suffix == ".crd" else None
    got = ttraj.read_traj(path, top)
    want = jtraj.read_traj(path, top)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ttraj.read_traj(path, top, start=1, stop=6, stride=2),
                                  jtraj.read_traj(path, top, start=1, stop=6, stride=2))
    assert ttraj.get_num_frames(path, top) == jtraj.get_num_frames(path, top) == 7
    assert np.abs(got - coords).max() < 0.02     # the coarsest format: 3 decimals
    sel = np.array([0, 3, 5])
    np.testing.assert_array_equal(ttraj.read_traj(path, top, selection_indices=sel),
                                  got[:, sel])
    got_box, want_box = tboxes.read_box(path), jboxes.read_box(path)
    assert (got_box is None) == (want_box is None)


def test_gro_topology_and_frames_equal_jax(tmp_path):
    system = make_backbone_system(str(tmp_path), n_residues=4, n_frames=5)
    top = Topology.from_pdb(system.pdb_path)
    gro = str(tmp_path / "peptide.gro")
    write_gro(gro, top, system.coords)
    got, want = Topology.from_file(gro), JTopology.from_file(gro)
    assert_same_topology(got, want)
    assert got.source_path == gro
    np.testing.assert_array_equal(ttraj.read_traj(gro), jtraj.read_traj(gro))
    np.testing.assert_array_equal(tboxes.read_box(gro), jboxes.read_box(gro))
    np.testing.assert_array_equal(tboxes.read_box(gro)[0], [25.0, 30.0, 35.0])
    with pytest.raises(ValueError, match="Unsupported topology format"):
        Topology.from_file(str(tmp_path / "x.mol2"))


def test_bonds_and_subset_equal_jax(tmp_path):
    system = make_backbone_system(str(tmp_path), n_residues=5, n_frames=3)
    got, want = Topology.from_pdb(system.pdb_path), JTopology.from_pdb(system.pdb_path)
    assert got.has_bonds() == want.has_bonds()
    np.testing.assert_array_equal(got.guess_bonds(), want.guess_bonds())
    idx = np.arange(3, 17)
    np.testing.assert_array_equal(got.guess_bonds(idx), want.guess_bonds(idx))
    box = np.array([6.0, 7.0, 50.0], np.float32)
    np.testing.assert_array_equal(got.guess_bonds(box=box), want.guess_bonds(box=box))
    assert got.bond_neighbor_sets() == want.bond_neighbor_sets()
    assert_same_topology(got.subset(idx), want.subset(idx))
    # explicit bonds are kept and renumbered by subset
    got.bonds = want.bonds = np.array([[3, 4], [4, 5], [0, 3], [10, 16]])
    assert got.has_bonds()
    assert_same_topology(got.subset(idx), want.subset(idx))
    got._bond_sets = None
    assert got.bond_neighbor_sets()[4] == {3, 5}


def test_xtc_writes_byte_equal_files(tmp_path):
    for n_atoms in (5, 40):   # uncompressed (<= 9 atoms) and compressed frames
        coords = coords_for(n_atoms, n_frames=9, n_atoms=n_atoms)
        a, b = str(tmp_path / f"port{n_atoms}.xtc"), str(tmp_path / f"jax{n_atoms}.xtc")
        txtc.write_xtc(a, coords, timestep_ps=2.0)
        jxtc.write_xtc(b, coords, timestep_ps=2.0)
        assert open(a, "rb").read() == open(b, "rb").read()


def test_xtc_box_reads_equal_jax(tmp_path):
    coords = coords_for(3, n_frames=4, n_atoms=20)
    path = str(tmp_path / "boxed.xtc")
    txtc.write_xtc(path, coords)
    raw = bytearray(open(path, "rb").read())
    off, frame = 0, 0
    while off < len(raw):   # give each frame an orthorhombic box (nm)
        struct.pack_into(">9f", raw, off + 16, 3.0 + frame, 0, 0, 0, 3.5, 0, 0, 0, 4.0)
        nbytes = struct.unpack_from(">i", raw, off + 56 + 32)[0]
        off += 56 + 36 + (nbytes + 3) // 4 * 4
        frame += 1
    open(path, "wb").write(bytes(raw))
    got = tboxes.read_box(path)
    np.testing.assert_array_equal(got, jboxes.read_box(path))
    np.testing.assert_array_equal(got[:, 0], [30.0, 40.0, 50.0, 60.0])


def test_pdb_box_and_frames_equal_jax(tmp_path, ca_system):
    top = Topology.from_pdb(ca_system.pdb_path)
    path = str(tmp_path / "multi.pdb")
    ttraj.write_traj(path, ca_system.coords[:3], top)
    text = open(path).read()
    open(path, "w").write(
        "CRYST1   40.000   41.000   42.000  90.00  90.00  90.00 P 1           1\n" + text)
    np.testing.assert_array_equal(ttraj.read_pdb_frames(path), jtraj.read_pdb_frames(path))
    got = tboxes.read_box(path)
    np.testing.assert_array_equal(got, jboxes.read_box(path))
    assert got.shape == (3, 3)


def test_extract_frames_equal_jax(tmp_path, ca_system):
    for pkg, name in ((ttraj, "port"), (jtraj, "jax")):
        pkg.extract_frames_to_pdb(ca_system.dcd_path, ca_system.pdb_path, 7,
                                  str(tmp_path / f"{name}.pdb"))
        pkg.extract_frames_to_traj(ca_system.dcd_path, ca_system.pdb_path, [9, 2, 30],
                                   str(tmp_path / f"{name}.xtc"))
        pkg.extract_frames_to_traj(ca_system.dcd_path, ca_system.pdb_path, [],
                                   str(tmp_path / f"{name}_none.xtc"))
    assert open(tmp_path / "port.pdb").read() == open(tmp_path / "jax.pdb").read()
    assert open(tmp_path / "port.xtc", "rb").read() == open(tmp_path / "jax.xtc", "rb").read()
    assert not (tmp_path / "port_none.xtc").exists()
    np.testing.assert_allclose(ttraj.read_traj(str(tmp_path / "port.xtc")),
                               ca_system.coords[[2, 9, 30]], atol=0.02)


# ---------------------------------------------------------------------------
# XTC codec checks (tests/test_native.py, tests/test_io.py)
# ---------------------------------------------------------------------------

def test_xtc_roundtrip_counts_and_stride(tmp_path):
    coords = coords_for(30, n_frames=9, n_atoms=40)
    path = str(tmp_path / "t.xtc")
    txtc.write_xtc(path, coords)
    back = txtc.read_xtc(path)
    assert back.shape == coords.shape
    assert txtc.count_xtc_frames(path) == 9
    # precision 1000/nm: 0.005 Angstrom worst case
    assert np.abs(back - coords).max() < 0.02
    np.testing.assert_array_equal(txtc.read_xtc(path, start=2, stop=8, stride=3),
                                  back[2:8:3])
    np.testing.assert_array_equal(back, jxtc.read_xtc(path))


def test_xtc_batch_decode_matches_serial(tmp_path):
    coords = coords_for(31, n_frames=25, n_atoms=40)
    path = str(tmp_path / "traj.xtc")
    txtc.write_xtc(path, coords)
    data = open(path, "rb").read()
    buf = np.frombuffer(data, np.uint8)
    selected = txtc._index_frames(data, 0, None, 1, path)
    lib = txtc._lib()
    serial = txtc._decode_frames_serial(lib, data, buf, selected)
    np.testing.assert_array_equal(txtc._batch_decode(lib, data, buf, selected, 40), serial)
    np.testing.assert_array_equal(txtc.read_xtc(path), serial)


def test_xtc_tiny_and_mixed_frames_decode_serially(tmp_path):
    tiny = coords_for(32, n_frames=6, n_atoms=4)
    path = str(tmp_path / "tiny.xtc")
    txtc.write_xtc(path, tiny)
    np.testing.assert_array_equal(txtc.read_xtc(path), jxtc.read_xtc(path))
    chunks = list(txtc.iter_xtc_chunks_prefetch(path, chunk=4))
    assert [c.shape[0] for c in chunks] == [4, 2]
    np.testing.assert_array_equal(np.concatenate(chunks), txtc.read_xtc(path))


def test_truncated_trajectories_raise(tmp_path):
    coords = coords_for(33, n_frames=6, n_atoms=40)
    xtc = str(tmp_path / "full.xtc")
    txtc.write_xtc(xtc, coords)
    data = open(xtc, "rb").read()
    for cut in (len(data) - 5, len(data) // 2 + 60):
        trunc = str(tmp_path / f"trunc_{cut}.xtc")
        open(trunc, "wb").write(data[:cut])
        with pytest.raises(txtc.XTCError):
            txtc.read_xtc(trunc)
    trr = str(tmp_path / "t.trr")
    write_trr(trr, coords[:, :30])
    data = open(trr, "rb").read()
    for cut in (len(data) - 7, len(data) // 2 + 13):
        trunc = str(tmp_path / f"t_{cut}.trr")
        open(trunc, "wb").write(data[:cut])
        with pytest.raises(TRRError):
            read_trr(trunc)


def test_corrupt_sizes_raise_instead_of_looping(tmp_path):
    coords = coords_for(34, n_frames=3, n_atoms=12)
    path = str(tmp_path / "bad.xtc")
    txtc.write_xtc(path, coords)
    raw = bytearray(open(path, "rb").read())
    struct.pack_into(">i", raw, 16 + 36 + 4 + 32, -172)   # first frame's nbytes
    open(path, "wb").write(bytes(raw))
    with pytest.raises(txtc.XTCError):
        txtc.count_xtc_frames(path)
    with pytest.raises(txtc.XTCError):
        txtc.read_xtc(path)
    trr = str(tmp_path / "bad.trr")
    write_trr(trr, coords[:2, :5])
    raw = bytearray(open(trr, "rb").read())
    struct.pack_into(">i", raw, len(raw) // 2 + 4 + 4 + 12 + 7 * 4, -100)   # x_size
    open(trr, "wb").write(bytes(raw))
    with pytest.raises(TRRError):
        count_trr_frames(trr)


def test_iter_xtc_chunks_prefetch_matches_read(tmp_path):
    coords = coords_for(35, n_frames=53, n_atoms=24)
    path = str(tmp_path / "stream.xtc")
    txtc.write_xtc(path, coords)
    full = txtc.read_xtc(path)
    chunks = list(txtc.iter_xtc_chunks_prefetch(path, chunk=16))
    assert [c.shape[0] for c in chunks] == [16, 16, 16, 5]
    np.testing.assert_array_equal(np.concatenate(chunks), full)
    strided = np.concatenate(list(txtc.iter_xtc_chunks_prefetch(path, 8, stride=3)))
    np.testing.assert_array_equal(strided, txtc.read_xtc(path, stride=3))
    np.testing.assert_array_equal(np.concatenate(list(ttraj.iter_frame_chunks(path, 16))),
                                  full)
    np.testing.assert_array_equal(
        np.concatenate(list(ttraj.iter_frame_chunks(path, 5, stride=4))), full[::4])


@pytest.mark.parametrize("suffix", [".dcd", ".trr", ".nc"])
def test_iter_frame_chunks_stride_equals_jax(tmp_path, suffix):
    coords = coords_for(36, n_frames=23, n_atoms=10)
    path = str(tmp_path / f"s{suffix}")
    jtraj.write_traj(path, coords)
    for chunk, stride in ((5, 1), (4, 3), (30, 2)):
        got = list(ttraj.iter_frame_chunks(path, chunk, stride=stride))
        want = list(jtraj.iter_frame_chunks(path, chunk, stride=stride))
        assert [c.shape for c in got] == [c.shape for c in want]
        np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))


def test_abandoning_the_xtc_prefetch_joins_its_worker(tmp_path):
    coords = coords_for(37, n_frames=64, n_atoms=24)
    path = str(tmp_path / "abandon.xtc")
    txtc.write_xtc(path, coords)
    before = set(threading.enumerate())
    it = txtc.iter_xtc_chunks_prefetch(path, chunk=4, prefetch_depth=1)
    assert next(it).shape == (4, 24, 3)
    it.close()
    deadline = time.time() + 5.0
    while time.time() < deadline:
        new_threads = [t for t in threading.enumerate() if t not in before and t.is_alive()]
        if not new_threads:
            break
        time.sleep(0.05)
    assert not new_threads, new_threads


# ---------------------------------------------------------------------------
# TRR, CRD checks (tests/test_io.py)
# ---------------------------------------------------------------------------

def test_trr_layout_and_legacy_layout(tmp_path):
    coords = coords_for(38, n_frames=2, n_atoms=5)
    path = str(tmp_path / "fmt.trr")
    write_trr(path, coords)
    raw = open(path, "rb").read()
    assert struct.unpack_from(">3i", raw, 0) == (1993, 13, 12)
    assert raw[12:24] == b"GMX_trn_file"
    assert count_trr_frames(path) == 2
    frame_bytes = len(raw) // 2
    legacy = b"".join(raw[f * frame_bytes:(f + 1) * frame_bytes][:4]
                      + raw[f * frame_bytes:(f + 1) * frame_bytes][8:] for f in range(2))
    legacy_path = str(tmp_path / "legacy.trr")
    open(legacy_path, "wb").write(legacy)
    np.testing.assert_array_equal(read_trr(legacy_path), read_trr(path))
    np.testing.assert_allclose(read_trr(path), coords, atol=1e-4)


@pytest.mark.parametrize("n_atoms,boxed", [(11, True), (11, False), (2, True), (1, False)])
def test_crd_box_autodetection_equals_jax(tmp_path, n_atoms, boxed):
    from deep_cartograph_tpu.io.crd import read_crd as jax_read_crd

    coords = coords_for(39 + n_atoms, n_frames=4, n_atoms=n_atoms)
    path = str(tmp_path / "m.crd")
    with open(path, "w") as fh:
        fh.write("mdcrd\n")
        for f in range(4):
            flat = coords[f].reshape(-1)
            for i in range(0, len(flat), 10):
                fh.write("".join(f"{v:8.3f}" for v in flat[i:i + 10]) + "\n")
            if boxed:
                fh.write(f"{20.0:8.3f}{20.0:8.3f}{20.0:8.3f}\n")
    got = read_crd(path, n_atoms)
    assert got.shape == (4, n_atoms, 3)
    np.testing.assert_array_equal(got, jax_read_crd(path, n_atoms))
    np.testing.assert_allclose(got, coords, atol=1e-3)
    with pytest.raises(ValueError, match="requires a topology"):
        ttraj.read_traj(path)


def test_unsupported_formats_raise(tmp_path):
    with pytest.raises(ValueError, match="Unsupported trajectory format"):
        ttraj.read_traj(str(tmp_path / "t.mol2"))
    with pytest.raises(ValueError, match="Unsupported output trajectory format"):
        ttraj.write_traj(str(tmp_path / "t.mol2"), coords_for(1))
    with pytest.raises(ValueError, match="requires a topology"):
        ttraj.write_traj(str(tmp_path / "t.pdb"), coords_for(1))
    assert tboxes.read_box(str(tmp_path / "t.xyz")) is None


def test_host_build_failure_raises_with_the_compiler_output(tmp_path):
    from deep_cartograph_torch.ops.build import load_host_library

    src = tmp_path / "broken_codec.cpp"
    src.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken_codec.cpp") as err:
        load_host_library(src)
    assert "error" in str(err.value)
