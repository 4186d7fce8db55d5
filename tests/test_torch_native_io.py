"""The port's native host code against the JAX package's, on the CPU: the
colvars text (io/csrc/colvars_io.cpp), the prefetching DCD reader
(io/csrc/dcdloader.cpp) and the batch dip test (stats/csrc/diptest.cpp),
each compiled by the port's own build, against the JAX package's
libcarto_native build of the same sources and against the plain versions.

Tolerances: colvars files byte-equal; parsing bit-equal to the JAX native
parser and within 1 float32 ulp of numpy's loadtxt (which rounds each
token through float64); DCD chunks bit-equal; dip statistics bit-equal to
the JAX batch, p-values within 1e-12 of the Python dip. The one stated
difference: glibc prints a NaN whose sign bit is set as `-nan`, Python's
`%` as `nan`."""

import struct

import numpy as np
import pytest

from deep_cartograph_torch.io import colvars as tcolvars
from deep_cartograph_torch.io import dcd as tdcd
from deep_cartograph_torch.io import traj as ttraj
from deep_cartograph_torch.stats import descriptors as tdesc
from deep_cartograph_tpu.io import colvars as jcolvars
from deep_cartograph_tpu.io import dcd as jdcd
from deep_cartograph_tpu.native.build import load_native
from deep_cartograph_tpu.stats import descriptors as jdesc
from tests.test_torch_jax_native import jax_native, jax_native_library  # noqa: F401


@pytest.fixture(autouse=True)
def fresh_cache(monkeypatch):
    monkeypatch.delenv("DEEP_CARTO_COLVARS_CACHE_BYTES", raising=False)
    tcolvars.clear_memory_cache()
    jcolvars.clear_memory_cache()
    yield
    tcolvars.clear_memory_cache()
    jcolvars.clear_memory_cache()


def test_the_jax_native_library_loads():
    """Every comparison below is with the JAX package's native routines."""
    lib = load_native()
    assert lib is not None
    for name in ("colvars_parse", "colvars_format_rt", "dcd_open", "dip_statistics_batch"):
        assert hasattr(lib, name), name


def test_host_libraries_build_together(tmp_path, monkeypatch):
    """build_host_all compiles the port's host sources at once into the
    build folder, where load_host_library then finds them."""
    from deep_cartograph_torch.io import xtc
    from deep_cartograph_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    sources = [xtc._CODEC_SOURCE, tcolvars._SOURCE, tdcd._SOURCE, tdesc._DIP_SOURCE]
    build.build_host_all(sources)
    built = sorted(p.name for p in tmp_path.glob("*.so"))
    assert len(built) == 4 and all(p.startswith("lib") for p in built)
    for src in sources:
        build.load_host_library(src)
    assert sorted(p.name for p in tmp_path.glob("*.so")) == built
    build.build_host_all(sources)  # nothing left to build


# ---------------------------------------------------------------------------
# Colvars text
# ---------------------------------------------------------------------------

NEG_NAN = np.frombuffer(struct.pack("<I", 0xFFC00000), np.float32)[0]


def _special_matrix(seed, decimals):
    """Random values and the tokens that go through snprintf: NaN of both
    signs, +-inf, -0.0, tiny negatives that print as -0, values exactly on
    a rounding half-step of `decimals`, and large magnitudes."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((40, 9)) * 10 ** rng.uniform(-3, 5, (40, 9)))
    half = np.array([(2 * k + 1) / 2 ** (decimals + 2) for k in range(9)])
    x[0] = [np.nan, NEG_NAN, np.inf, -np.inf, -0.0, 0.0, -1e-9, 3.4e38, -3.4e38]
    x[1] = half
    x[2] = -half
    x[3] = [2.5, 0.125, 0.375, 1e10 + 0.5, 12345.5, -0.0625, 7.5e-5, 2.5e-5, 0.5]
    return x.astype(np.float32)


@pytest.mark.parametrize("fmt", ["%.2f", "%.4f", "%.6f"])
def test_colvars_files_equal_the_jax_and_plain_writers(tmp_path, fmt):
    data = _special_matrix(0, int(fmt[2]))
    names = [f"f{i}" for i in range(data.shape[1])]
    paths = {k: str(tmp_path / f"{k}.dat") for k in ("port", "jax", "plain")}
    tcolvars.write_colvars(paths["port"], data, names, fmt=fmt)
    jcolvars.write_colvars(paths["jax"], data, names, fmt=fmt)
    tcolvars.write_colvars_plain(paths["plain"], data, names, fmt=fmt)
    port, jax, plain = (open(paths[k], "rb").read() for k in ("port", "jax", "plain"))
    assert port == jax
    # the one difference from Python's %: the sign of a negative NaN
    assert port.count(b"-nan") == 1 and b"-nan" not in plain
    assert port.replace(b"-nan", b"nan") == plain


def test_colvars_random_files_equal_the_plain_writer(tmp_path):
    rng = np.random.default_rng(1)
    data = (rng.standard_normal((3000, 17)) * 50).astype(np.float32)
    names = [f"f{i}" for i in range(17)]
    tcolvars.write_colvars(str(tmp_path / "a.dat"), data, names)
    tcolvars.write_colvars_plain(str(tmp_path / "b.dat"), data, names)
    assert (tmp_path / "a.dat").read_bytes() == (tmp_path / "b.dat").read_bytes()


def _within_one_ulp(a, b):
    both_nan = np.isnan(a) & np.isnan(b)
    with np.errstate(invalid="ignore"):
        close = np.abs(a.astype(np.float64) - b) <= np.spacing(np.maximum(np.abs(a),
                                                                        np.abs(b)))
    return bool((both_nan | close | (a == b)).all())


def test_colvars_parse_matches_jax_and_loadtxt():
    rng = np.random.default_rng(2)
    values = rng.standard_normal((200, 6)) * 10 ** rng.uniform(-4, 6, (200, 6))
    lines = ["#! FIELDS a b c d e f"]
    for r, row in enumerate(values):
        fmts = ["%.4f", "%.9f", "%.12g", "%.3e", "%.17g", "%d"]
        toks = [f % (int(v) if f == "%d" else v) for f, v in zip(fmts, row)]
        lines.append(("\t" if r % 3 else " ").join(toks))
        if r % 50 == 7:
            lines += ["# a comment", "", "   "]
    lines.append("nan -nan inf -inf -0.0 +1.5")
    # just above the float32 midpoint 1 + 2**-24 by less than half a double
    # ulp: loadtxt's double is the midpoint itself, which rounds to even (1.0),
    # while the parser rounds the decimal straight to float32 (up)
    lines.append("1.0000000596046447753906251 1 2 3 4 5")
    body = ("\n".join(lines) + "\n").encode()
    got = tcolvars._parse_body(body, 6)
    want = jcolvars._parse_body(body, 6)
    assert got.shape == want.shape == (202, 6)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    plain = tcolvars.parse_body_plain(body, 6)
    assert _within_one_ulp(got, plain)
    assert plain[-1, 0] == 1.0 and got[-1, 0] == np.nextafter(np.float32(1), np.float32(2))
    # no trailing newline, and an empty body
    np.testing.assert_array_equal(tcolvars._parse_body(body[:-1], 6), got)
    assert tcolvars._parse_body(b"#! FIELDS a\n", 1).shape == (0, 1)


def test_colvars_short_row_raises():
    body = b"#! FIELDS time a b\n0.0 1.0 2.0\n1.0 3.0\n2.0 4.0 5.0\n"
    with pytest.raises(ValueError, match="does not hold 3 numbers"):
        tcolvars._parse_body(body, 3)
    with pytest.raises(ValueError, match="does not hold 3 numbers"):
        tcolvars._parse_body(b"1.0 abc 2.0\n", 3)


@pytest.mark.parametrize("fmt", ["%.4f", "%.3e"])
def test_cold_read_equals_the_cached_read(tmp_path, fmt):
    """The cache holds what a reader parses from the file, bit for bit,
    for the native formatter and for the Python writer alike."""
    data = _special_matrix(3, 4)
    names = [f"f{i}" for i in range(data.shape[1])]
    path = str(tmp_path / "c.dat")
    tcolvars.write_colvars(path, data, names, fmt=fmt)
    cached, cached_names = tcolvars.read_features_matrix(path)
    assert tcolvars._cache_get(path) is not None
    tcolvars.clear_memory_cache()
    cold, cold_names = tcolvars.read_features_matrix(path)
    assert cached_names == cold_names == names
    np.testing.assert_array_equal(cached.view(np.uint32), cold.view(np.uint32))
    # and the JAX package reads the port's file alike
    jax = jcolvars.read_features_matrix(path)[0]
    np.testing.assert_array_equal(jax.view(np.uint32), cold.view(np.uint32))


def test_streaming_chunks_parse_natively(tmp_path):
    rng = np.random.default_rng(4)
    data = rng.normal(2, 0.3, (500, 5)).astype(np.float32)
    path = str(tmp_path / "s.dat")
    tcolvars.write_colvars(path, data, list("abcde"))
    tcolvars.clear_memory_cache()
    full = tcolvars.read_features_matrix(path)[0]
    chunks = list(tcolvars.iter_features_chunks(path, chunk_rows=64, start=3, stride=2))
    np.testing.assert_array_equal(np.concatenate(chunks), full[3::2])


# ---------------------------------------------------------------------------
# DCD prefetch
# ---------------------------------------------------------------------------

def _coords(seed, n_frames=37, n_atoms=9):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_frames, n_atoms, 3)) * 12).astype(np.float32)


def _write_dcd_with_cell(path, coords, header_frames=None):
    """A DCD whose frames carry the 48-byte unit-cell record."""
    def rec(payload):
        return struct.pack("<i", len(payload)) + payload + struct.pack("<i", len(payload))

    n_frames, n_atoms, _ = coords.shape
    icntrl = [0] * 20
    icntrl[0] = n_frames if header_frames is None else header_frames
    icntrl[10] = 1
    icntrl[19] = 24
    with open(path, "wb") as fh:
        fh.write(rec(b"CORD" + struct.pack("<20i", *icntrl)))
        fh.write(rec(struct.pack("<i", 1) + b"cell".ljust(80)))
        fh.write(rec(struct.pack("<i", n_atoms)))
        for f in range(n_frames):
            fh.write(rec(struct.pack("<6d", 30.0 + f, 90.0, 31.0, 90.0, 90.0, 32.0)))
            for axis in range(3):
                fh.write(rec(coords[f, :, axis].astype("<f4").tobytes()))


def _set_header_frames(path, n):
    with open(path, "r+b") as fh:
        fh.seek(8)
        fh.write(struct.pack("<i", n))


def _chunks(module, path, chunk):
    """The chunks a reader yields, and the error that ended them (or None)."""
    got = []
    try:
        for block in module.iter_dcd_chunks_prefetch(path, chunk):
            got.append(block)
    except jdcd.DCDError as exc:
        return got, type(exc).__name__
    except tdcd.DCDError as exc:
        return got, type(exc).__name__
    return got, None


def _same_chunks(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))


@pytest.mark.parametrize("cell", [False, True])
@pytest.mark.parametrize("chunk", [1, 8, 37, 64])
def test_dcd_prefetch_equals_jax_and_read_dcd(tmp_path, cell, chunk):
    coords = _coords(chunk)
    path = str(tmp_path / "t.dcd")
    if cell:
        _write_dcd_with_cell(path, coords)
        assert tdcd.read_dcd_header(path)[2]
    else:
        tdcd.write_dcd(path, coords)
    got, err = _chunks(tdcd, path, chunk)
    want, jerr = _chunks(jdcd, path, chunk)
    assert err is None and jerr is None
    _same_chunks(got, want)
    assert [c.shape[0] for c in got] == [min(chunk, 37 - s) for s in range(0, 37, chunk)]
    np.testing.assert_array_equal(np.concatenate(got), tdcd.read_dcd(path))
    np.testing.assert_array_equal(np.concatenate(got), coords)
    # iter_frame_chunks takes the prefetch reader at stride 1
    _same_chunks(list(ttraj.iter_frame_chunks(path, chunk)), got)


@pytest.mark.parametrize("cell", [False, True])
def test_dcd_prefetch_reads_frames_across_slabs(tmp_path, cell):
    """Frames of 30,000 atoms (360 kB) make a chunk of 5 span several of the
    native reader's 1 MiB slabs; a cut in the last frame raises at its chunk."""
    coords = _coords(11, n_frames=7, n_atoms=30_000)
    path = str(tmp_path / "wide.dcd")
    (_write_dcd_with_cell if cell else tdcd.write_dcd)(path, coords)
    got, err = _chunks(tdcd, path, 5)
    want, jerr = _chunks(jdcd, path, 5)
    assert err is None and jerr is None
    _same_chunks(got, want)
    np.testing.assert_array_equal(np.concatenate(got), coords)
    cut = str(tmp_path / "wide_cut.dcd")
    open(cut, "wb").write(open(path, "rb").read()[:-1000])
    got, err = _chunks(tdcd, cut, 5)
    assert err == "DCDError" and len(got) == 1
    np.testing.assert_array_equal(got[0], coords[:5])


@pytest.mark.parametrize("cell", [False, True])
def test_dcd_header_count_zero(tmp_path, cell):
    """A header frame count of 0: both readers count the body's frames."""
    coords = _coords(5, n_frames=20)
    path = str(tmp_path / "z.dcd")
    (_write_dcd_with_cell if cell else tdcd.write_dcd)(path, coords)
    _set_header_frames(path, 0)
    got, err = _chunks(tdcd, path, 6)
    want, jerr = _chunks(jdcd, path, 6)
    assert err is None and jerr is None
    _same_chunks(got, want)
    np.testing.assert_array_equal(np.concatenate(got), coords)
    np.testing.assert_array_equal(tdcd.read_dcd(path), coords)


def test_dcd_truncated_file(tmp_path, caplog):
    """A body cut inside its last frame, the header still counting it: the
    native reader, in both packages, yields the chunks before the cut and
    raises; the slice reader returns the complete frames with a warning."""
    coords = _coords(6, n_frames=20)
    full = str(tmp_path / "full.dcd")
    tdcd.write_dcd(full, coords)
    path = str(tmp_path / "cut.dcd")
    raw = open(full, "rb").read()
    open(path, "wb").write(raw[:-50])
    got, err = _chunks(tdcd, path, 8)
    want, jerr = _chunks(jdcd, path, 8)
    assert err == jerr == "DCDError"
    _same_chunks(got, want)
    assert [c.shape[0] for c in got] == [8, 8]
    np.testing.assert_array_equal(np.concatenate(got), coords[:16])
    np.testing.assert_array_equal(tdcd.read_dcd(path), coords[:19])
    assert "ends mid-frame" in caplog.text


@pytest.mark.parametrize("header_frames", [30, 12])
def test_dcd_header_count_off_the_body(tmp_path, header_frames):
    """A positive header count that disagrees with a whole body: the native
    readers trust it (stop early, or raise past the body); the slice reader
    counts the body."""
    coords = _coords(7, n_frames=20)
    path = str(tmp_path / "h.dcd")
    tdcd.write_dcd(path, coords)
    _set_header_frames(path, header_frames)
    got, err = _chunks(tdcd, path, 8)
    want, jerr = _chunks(jdcd, path, 8)
    assert err == jerr
    _same_chunks(got, want)
    if header_frames > 20:
        assert err == "DCDError" and sum(c.shape[0] for c in got) == 16
    else:
        assert err is None
        np.testing.assert_array_equal(np.concatenate(got), coords[:header_frames])
    np.testing.assert_array_equal(tdcd.read_dcd(path), coords)


def test_dcd_big_endian_takes_the_slice_reader(tmp_path):
    coords = _coords(8, n_frames=11)
    n_frames, n_atoms, _ = coords.shape

    def rec(payload):
        return struct.pack(">i", len(payload)) + payload + struct.pack(">i", len(payload))

    path = str(tmp_path / "be.dcd")
    icntrl = [0] * 20
    icntrl[0] = n_frames
    with open(path, "wb") as fh:
        fh.write(rec(b"CORD" + struct.pack(">20i", *icntrl)))
        fh.write(rec(struct.pack(">i", 1) + b"be".ljust(80)))
        fh.write(rec(struct.pack(">i", n_atoms)))
        for f in range(n_frames):
            for axis in range(3):
                fh.write(rec(coords[f, :, axis].astype(">f4").tobytes()))
    got = list(tdcd.iter_dcd_chunks_prefetch(path, 4))
    assert [c.shape[0] for c in got] == [4, 4, 3]
    np.testing.assert_array_equal(np.concatenate(got), coords)
    _same_chunks(got, list(jdcd.iter_dcd_chunks_prefetch(path, 4)))


def test_dcd_prefetch_abandoned_and_refused(tmp_path):
    """An abandoned generator closes its reader; a file the native reader
    cannot open raises, and so does a chunk size that is not positive."""
    coords = _coords(9, n_frames=100, n_atoms=7)
    path = str(tmp_path / "a.dcd")
    tdcd.write_dcd(path, coords)
    for depth in (1, 8):
        gen = tdcd.iter_dcd_chunks_prefetch(path, 16, prefetch_depth=depth)
        np.testing.assert_array_equal(next(gen), coords[:16])
        gen.close()
    with pytest.raises(ValueError, match="must be positive"):
        next(tdcd.iter_dcd_chunks_prefetch(path, 0))
    bad = str(tmp_path / "bad.dcd")
    raw = bytearray(open(path, "rb").read())
    header_size = tdcd.read_dcd_header(path)[4]
    raw[header_size - 8:header_size - 4] = struct.pack("<i", -3)  # atom count
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(tdcd.DCDError, match="cannot open"):
        next(tdcd.iter_dcd_chunks_prefetch(bad, 16))


# ---------------------------------------------------------------------------
# Batch dip test
# ---------------------------------------------------------------------------

def _dip_features(seed, n=400):
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.standard_normal(n),
        np.concatenate([rng.standard_normal(n // 2) - 3, rng.standard_normal(n - n // 2) + 3]),
        rng.random(n),
        np.full(n, 1.5),
        np.round(rng.standard_normal(n), 1),   # ties
        rng.exponential(size=n),
    ]).astype(np.float32)


@pytest.mark.parametrize("n", [3, 4, 57, 400])
def test_dip_batch_equals_jax_and_python(n):
    x = _dip_features(n, n)
    got = tdesc.dip_statistics_batch(x)
    want = jdesc.dip_statistics_batch(x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tdesc.dip_pvalues(x), tdesc.dip_pvalues_plain(x),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tdesc.dip_pvalues(x), jdesc.dip_pvalues(x),
                               rtol=0, atol=1e-12)
