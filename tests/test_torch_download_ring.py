"""The featurize copy back (`geom/engine.py`): both entry points run one
chunk loop, each chunk's features coming down the featurizer's download
ring into the rows of their trajectory's matrix.

On the CPU: `featurize_trajectory` and `iter_featurize_trajectories` give
the matrices that the per-chunk evaluator gives on the same chunks, bit for
bit (the chunks are those the loop cuts across trajectory seams, so every
frame takes the same route through PyTorch's CPU kernels), with strides,
short last chunks, chunks wider than a slot, the int16 upload, empty
trajectories, formats counted ahead or not and counts that miss; the
timeout's text; the counter (`DOWNLOAD_STATS`). On the card (marker
`cuda`, run as the module docstring of tests/test_torch_cuda.py says): the
matrix bit for bit what the whole pass's outputs joined on the card and
copied back give, with small slots too, and the pass's device memory under
the matrix's size, which joining the outputs on the card exceeds.
"""

import errno

import numpy as np
import pytest
import torch

from deep_cartograph_torch.geom import engine, transport
from deep_cartograph_torch.geom.engine import DOWNLOAD_STATS, Featurizer
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.io.traj import iter_frame_chunks, read_traj, write_traj
from deep_cartograph_torch.utils.demo_data import ca_coords, write_ca_pdb

N_RES = 12
LABELS = ["dist-@CA_1-@CA_5", "dist-@CA_2-@CA_9", "dist-@CA_3-@CA_12",
          "sin-@CA_1-@CA_2-@CA_3-@CA_4", "cos-@CA_5-@CA_6-@CA_7-@CA_8",
          "tor-@CA_8-@CA_9-@CA_10-@CA_11"]


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    """(folder, topology, frames): a 12-residue CA chain, 90 frames."""
    folder = tmp_path_factory.mktemp("download")
    coords = ca_coords(N_RES, 90, seed=5).astype(np.float32)
    write_ca_pdb(str(folder / "ca.pdb"), coords[0])
    return folder, Topology.from_pdb(str(folder / "ca.pdb")), coords


def trajectories(folder, coords, sizes, suffix, name):
    """Files of consecutive pieces of `coords`, `sizes` frames each."""
    paths, start = [], 0
    for i, n in enumerate(sizes):
        paths.append(str(folder / f"{name}{i}{suffix}"))
        write_traj(paths[-1], coords[start:start + n])
        start += n
    return paths


def per_chunk(featurizer, paths, stride, chunk, evaluate=None):
    """Each trajectory's features as the per-chunk evaluator gives them on
    the chunks the loop cuts: the trajectories' frames (as their files
    hold them, at `stride`) joined, cut every `chunk` frames, evaluated a
    chunk at a time and split back."""
    evaluate = evaluate or (lambda block: featurizer.evaluator(block))
    frames = [read_traj(p, stride=stride) for p in paths]
    joined = np.concatenate(frames)
    features = np.concatenate([evaluate(joined[a:a + chunk])
                               for a in range(0, len(joined), chunk)]
                              or [np.zeros((0, len(LABELS)), np.float32)])
    return np.split(features, np.cumsum([len(f) for f in frames])[:-1])


CASES = {
    # name: (trajectory sizes, suffix, stride, frame_chunk, slot rows or None,
    #        bytes of a matrix mapped at a time or None)
    "one": ([90], ".dcd", 1, 32, None, None),
    "seams": ([11, 37, 42], ".dcd", 1, 16, None, None),
    "stride_3": ([11, 37, 42], ".dcd", 3, 8, None, None),
    "short_last": ([61], ".dcd", 1, 20, None, None),
    "wider_than_a_slot": ([29, 61], ".dcd", 1, 32, 5, None),
    "mapped_a_page_at_a_time": ([300, 600], ".dcd", 1, 64, None, 4096),
    "empty": ([0, 40, 0, 50], ".dcd", 1, 16, None, None),
    "xtc_seams": ([11, 37, 42], ".xtc", 2, 16, None, None),   # not counted ahead
    "xyz_not_counted": ([30, 60], ".xyz", 1, 16, None, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_entry_points_equal_the_per_chunk_evaluator(system, monkeypatch, case):
    sizes, suffix, stride, chunk, slot_rows, map_step = CASES[case]
    folder, top, coords = system
    if slot_rows is not None:
        monkeypatch.setattr(transport, "SLOT_BYTES", 4 * len(LABELS) * slot_rows)
    if map_step is not None:
        monkeypatch.setattr(transport, "MAP_STEP", map_step)
        coords = np.concatenate([coords] * 10)
    paths = trajectories(folder, coords, sizes, suffix, case)
    featurizer = Featurizer(top, LABELS, device="cpu")
    want = per_chunk(featurizer, paths, stride, chunk)
    DOWNLOAD_STATS.reset()
    got = list(featurizer.iter_featurize_trajectories(paths, traj_stride=stride,
                                                      frame_chunk=chunk))
    assert [p for p, _ in got] == paths
    for (_, g), w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    frames = sum(len(w) for w in want)
    assert DOWNLOAD_STATS.chunks == -(-frames // chunk)
    assert DOWNLOAD_STATS.bytes == 4 * frames * len(LABELS)
    rows = slot_rows or chunk
    assert DOWNLOAD_STATS.pieces == sum(-(-min(chunk, frames - a) // rows)
                                        for a in range(0, frames, chunk))
    assert DOWNLOAD_STATS.slot_waits == 0   # nothing to wait for on the CPU
    for path, w in zip(paths, want):
        single = featurizer.featurize_trajectory(path, traj_stride=stride, frame_chunk=chunk)
        np.testing.assert_array_equal(single, np.concatenate(
            per_chunk(featurizer, [path], stride, chunk)))
        assert single.shape == w.shape


def test_int16_upload_equals_the_per_chunk_quantized_evaluator(system):
    folder, top, coords = system
    (path,) = trajectories(folder, coords * 3.0, [90], ".dcd", "int16_")
    featurizer = Featurizer(top, LABELS, device="cpu")
    (want,) = per_chunk(featurizer, [path], 1, 32, lambda block: engine._eval_quantized(
        featurizer.evaluator, block).numpy())
    got = featurizer.featurize_trajectory(path, frame_chunk=32, upload="int16")
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, featurizer.featurize_trajectory(path, frame_chunk=32))


def test_mapping_pages_gives_fresh_zero_pages_and_refuses_an_unaligned_start():
    import mmap

    page = mmap.PAGESIZE
    memory = mmap.mmap(-1, 3 * page, flags=mmap.MAP_PRIVATE)
    array = np.frombuffer(memory, np.uint8)
    array[:] = 7
    assert transport.map_pages(array.ctypes.data + page, page + 1) == 0
    assert (array[:page] == 7).all() and (array[page:] == 0).all()
    assert transport.map_pages(array.ctypes.data + 1, page) == errno.EINVAL
    assert (array[:page] == 7).all()


def test_copy_rows_copies_and_checks_its_buffers():
    src = torch.arange(12 * 7, dtype=torch.float32).reshape(12, 7)
    dst = np.full((12, 7), -1, np.float32)
    transport.copy_rows(dst, src)
    np.testing.assert_array_equal(dst, src.numpy())
    for bad_dst, bad_src in [(np.empty((12, 6), np.float32), src),
                             (np.empty((12, 7), np.float64), src),
                             (np.empty((7, 12), np.float32).T, src),
                             (dst, src.double()), (dst, src.t().contiguous().t())]:
        with pytest.raises(ValueError):
            transport.copy_rows(bad_dst, bad_src)


@pytest.mark.parametrize("cores, floats, team", [
    (8, 1, 1),
    (8, transport.GATHER_GRAIN + 1, 2),
    (8, 2048 * 3235, 4),    # a lambda80 chunk: half the cores
    (32, 2048 * 3235, 16),
    (1, 2048 * 3235, 1),
])
def test_the_copy_s_team_leaves_cores_to_the_threads_beside_it(monkeypatch, cores, floats,
                                                               team):
    """A thread a GATHER_GRAIN floats, at most half the cores, whatever is
    staging at once."""
    monkeypatch.setattr(transport.os, "sched_getaffinity", lambda pid: set(range(cores)),
                        raising=False)
    monkeypatch.setattr(transport, "_staging_calls", 3)
    assert transport._copy_team(floats) == team


@pytest.mark.parametrize("suffix, counted", [(".dcd", True), (".xtc", False), (".trr", False),
                                             (".xyz", False)])
def test_only_a_header_count_is_read_ahead(system, monkeypatch, suffix, counted):
    """A DCD's count comes from its header and size; an XTC's or TRR's would
    read the whole file, so those formats gather their rows in parts."""
    folder, top, coords = system
    (path,) = trajectories(folder, coords, [61], suffix, "ahead")
    read = []
    real = engine.get_num_frames
    monkeypatch.setattr(engine, "get_num_frames", lambda p: read.append(p) or real(p))
    assert engine._frames_ahead(path, 3) == (21 if counted else None)
    assert read == ([path] if counted else [])


@pytest.mark.parametrize("miss", [-7, -1, 1, 9, None])
def test_a_frame_count_that_misses_still_gives_every_row(system, monkeypatch, miss):
    """A count ahead that is wrong (or none) leaves the rows as they are:
    those past it are gathered in parts, a shortfall trimmed."""
    folder, top, coords = system
    paths = trajectories(folder, coords, [23, 67], ".dcd", "miss")
    counted = engine._frames_ahead
    monkeypatch.setattr(engine, "_frames_ahead", lambda path, stride: None if miss is None
                        else max(0, counted(path, stride) + miss))
    featurizer = Featurizer(top, LABELS, device="cpu")
    for got, want in zip(featurizer.featurize_trajectories(paths, frame_chunk=16),
                         per_chunk(featurizer, paths, 1, 16)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("entry, text", [
    ("featurize_trajectory",
     r"^Featurization exceeded the configured timeout of -1\.0 s after 0 frames\.$"),
    ("featurize_trajectories",
     r"^Featurization of .*late0\.dcd exceeded the configured timeout of -1\.0 s\.$"),
])
def test_the_timeout_s_text(system, entry, text):
    folder, top, coords = system
    (path,) = trajectories(folder, coords, [40], ".dcd", "late")
    featurizer = Featurizer(top, LABELS, device="cpu")
    call = getattr(featurizer, entry)
    with pytest.raises(TimeoutError, match=text):
        call(path if entry == "featurize_trajectory" else [path], frame_chunk=8,
             timeout=-1.0)
    # the ring the failed call held is the featurizer's again, and empty
    (ring,) = featurizer._rings.values()
    assert len(ring) == 0
    np.testing.assert_array_equal(featurizer.featurize_trajectory(path, frame_chunk=8),
                                  np.concatenate(per_chunk(featurizer, [path], 1, 8)))


def test_interleaved_and_abandoned_calls_keep_their_own_rows(system):
    """A call made while another is open takes a ring of its own; an
    abandoned call gives its ring back empty."""
    folder, top, coords = system
    paths = trajectories(folder, coords, [20, 31, 39], ".dcd", "inter")
    featurizer = Featurizer(top, LABELS, device="cpu")
    want = per_chunk(featurizer, paths, 1, 8)
    first = featurizer.iter_featurize_trajectories(paths, frame_chunk=8)
    second = featurizer.iter_featurize_trajectories(paths, frame_chunk=8)
    for (_, a), (_, b), w in zip(first, second, want):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(b, w)
    abandoned = featurizer.iter_featurize_trajectories(paths, frame_chunk=8)
    next(abandoned)
    abandoned.close()
    assert all(len(ring) == 0 for ring in featurizer._rings.values())
    for got, w in zip(featurizer.featurize_trajectories(paths, frame_chunk=8), want):
        np.testing.assert_array_equal(got, w)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

LAMBDA_RES = 80


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def wide_system(cuda, tmp_path_factory):
    """(topology, labels, DCD path, frames): an 80-residue CA chain with
    every non-neighbour CA distance and each CA dihedral's sin and cos
    (3,235 features, the benchmark's lambda80 set), 40,000 frames."""
    folder = tmp_path_factory.mktemp("download_card")
    coords = ca_coords(LAMBDA_RES, 40_000, seed=3).astype(np.float32)
    write_ca_pdb(str(folder / "ca.pdb"), coords[0])
    path = str(folder / "traj.dcd")
    write_traj(path, coords)
    labels = [f"dist-@CA_{i}-@CA_{j}" for i in range(1, LAMBDA_RES + 1)
              for j in range(i + 2, LAMBDA_RES + 1)]
    for i in range(1, LAMBDA_RES - 2):
        quad = "-".join(f"@CA_{k}" for k in range(i, i + 4))
        labels += [f"sin-{quad}", f"cos-{quad}"]
    assert len(labels) == 3235
    return Topology.from_pdb(str(folder / "ca.pdb")), labels, path, len(coords)


def joined_on_the_card(featurizer, path, chunk):
    """The pass as it was before the download ring: every chunk's output
    kept on the card, joined, and copied back once."""
    outputs = [featurizer.evaluator.eval_raw(block)
               for block in iter_frame_chunks(path, chunk, featurizer.topology.source_path)]
    return torch.cat(outputs).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("slot_rows", [None, 300])
def test_the_card_s_matrix_is_the_joined_outputs_bit_for_bit(cuda, wide_system, monkeypatch,
                                                             slot_rows):
    top, labels, path, n = wide_system
    if slot_rows is not None:   # a 2,048-frame chunk in 7 pieces, the ring of 3 lapped
        monkeypatch.setattr(transport, "SLOT_BYTES", 4 * len(labels) * slot_rows)
    featurizer = Featurizer(top, labels, device=cuda)
    want = joined_on_the_card(featurizer, path, 2048)
    DOWNLOAD_STATS.reset()
    got = featurizer.featurize_trajectory(path, frame_chunk=2048)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want)
    assert DOWNLOAD_STATS.chunks == -(-n // 2048)
    assert DOWNLOAD_STATS.bytes == 4 * n * len(labels)
    rows = slot_rows or 2048
    assert DOWNLOAD_STATS.pieces == sum(-(-min(2048, n - a) // rows)
                                        for a in range(0, n, 2048))
    streamed = featurizer.featurize_trajectories([path, path], frame_chunk=1500)
    for part in streamed:
        np.testing.assert_array_equal(part, want)


@pytest.mark.cuda
def test_the_pass_s_device_memory_stays_under_the_matrix(cuda, wide_system):
    """Joining the outputs on the card holds the matrix twice; the ring
    holds a few chunks."""
    top, labels, path, n = wide_system
    matrix_bytes = 4 * n * len(labels)
    featurizer = Featurizer(top, labels, device=cuda)
    featurizer.featurize_trajectory(path, frame_chunk=2048)   # the ring and slots made
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    featurizer.featurize_trajectory(path, frame_chunk=2048)
    torch.cuda.synchronize()
    ring_pass = torch.cuda.max_memory_allocated(cuda) - base
    torch.cuda.reset_peak_memory_stats(cuda)
    joined_on_the_card(featurizer, path, 2048)
    torch.cuda.synchronize()
    joined_pass = torch.cuda.max_memory_allocated(cuda) - base
    assert ring_pass < matrix_bytes / 2 < 2 * matrix_bytes <= joined_pass
