"""The staged copy up of host frames (`geom/kernels.py::PlanEvaluator`:
the plan's atoms gathered into the evaluator's ring, a chunk a slot) held
to the whole frames evaluated with the plan's own atom indices, on the CPU:
the index remap, the bypasses, the chunk boundaries of `FramesToCV`, the
counter (`UPLOAD_STATS`) and a mesh of several entries.

Chunks here are multiples of 32 frames. PyTorch's CPU kernels run sin, cos
and atan2 two vectors (up to 16 floats each) an iteration and the tail
through the scalar library, which can differ in the last bit; with every
chunk boundary on a multiple of 32 frames a frame takes the same route
chunked or not, so the features can be compared bit for bit."""

import numpy as np
import pytest
import torch

from deep_cartograph_torch.deploy import FramesToCV, LinearProjection
from deep_cartograph_torch.features.grammar import compile_plan
from deep_cartograph_torch.geom import kernels, transport
from deep_cartograph_torch.geom.kernels import UPLOAD_STATS, PlanEvaluator
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.parallel.mesh import Mesh, use_mesh
from deep_cartograph_torch.utils.demo_data import ca_coords, write_ca_pdb

N_ATOMS = 12
CHUNK = 64
# CVs of chunked and unchunked calls: a linear projection's products of other
# row counts may sum in another order (float32, values of order 10).
CV_ATOL = 2e-5

PLANS = {
    "distances": ["dist-@CA_1-@CA_5", "dist-@CA_2-@CA_9", "dist-@CA_3-@CA_7"],
    "dihedrals": ["tor-@CA_1-@CA_2-@CA_3-@CA_4", "sin-@CA_5-@CA_6-@CA_7-@CA_9",
                  "cos-@CA_5-@CA_6-@CA_7-@CA_9"],
    "coordinates": ["coord-@CA_3.x", "coord-@CA_3.y", "coord-@CA_8.z"],
    "centers": ["dist-center_resid_1to4-@CA_9", "dist-center_resid_1to3-center_resid_7to8",
                "dist-@CA_2-@CA_6"],
    "column_order": ["cos-@CA_2-@CA_3-@CA_4-@CA_6", "dist-@CA_1-@CA_5", "coord-@CA_7.z",
                     "dist-center_resid_2to3-@CA_9", "sin-@CA_2-@CA_3-@CA_4-@CA_6"],
}
SERVED = PLANS["column_order"] + ["dist-@CA_4-@CA_8", "tor-@CA_3-@CA_4-@CA_5-@CA_6"]


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    """(topology, frames): a 12-atom CA chain, 400 frames, float32."""
    folder = tmp_path_factory.mktemp("staged")
    coords = ca_coords(N_ATOMS, 400, seed=11).astype(np.float32)
    write_ca_pdb(str(folder / "ca.pdb"), coords[0])
    return Topology.from_pdb(str(folder / "ca.pdb")), coords


@pytest.fixture
def chunk_of(monkeypatch):
    """Set the ring's slot to hold `frames` frames of `width` atoms, for
    evaluators built after the call."""

    def set_chunk(frames, width):
        monkeypatch.setattr(transport, "SLOT_BYTES", frames * width * 12)

    return set_chunk


def todays_path(plan, frames, fit=None):
    """Every feature of the whole frames, on the plan's own atom indices,
    in one piece: the evaluation before the staged copy up."""
    t = lambda a, dtype=torch.int32: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    order = np.concatenate([plan.dist_out, plan.dihedral_out, plan.coord_out])
    ref, weights = (None, None) if fit is None else (t(fit[0], torch.float32),
                                                     t(fit[1], torch.float32))
    return kernels.evaluate_plan_chunk(
        torch.as_tensor(frames), t(plan.dist_pairs.reshape(-1, 2)), t(plan.dist_center_a),
        t(plan.dist_center_b), t(plan.dihedral_quads.reshape(-1, 4)), t(plan.dihedral_mode),
        t(plan.coord_atoms), t(plan.coord_axes), t(plan.center_atoms),
        t(plan.center_mask, torch.float32), t(np.argsort(order), torch.int64), ref, weights,
        n_features=plan.n_features,
        has_centers=bool((plan.dist_center_a >= 0).any() or (plan.dist_center_b >= 0).any()),
        identity_layout=False)


def read_atoms(plan):
    """The atoms the plan's features read, worked out from its labels' parts."""
    atoms = set(plan.dihedral_quads.reshape(-1).tolist()) | set(plan.coord_atoms.tolist())
    for (a, b), ca, cb in zip(plan.dist_pairs.reshape(-1, 2), plan.dist_center_a,
                              plan.dist_center_b):
        atoms |= {int(a)} if ca < 0 else set(plan.center_atoms[ca][plan.center_mask[ca] > 0])
        atoms |= {int(b)} if cb < 0 else set(plan.center_atoms[cb][plan.center_mask[cb] > 0])
    return sorted(int(a) for a in atoms)


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("n", [1, 63, 64, 65, 160])
def test_staged_features_equal_todays_path_bit_for_bit(system, chunk_of, name, n):
    top, coords = system
    plan = compile_plan(PLANS[name], top)
    chunk_of(CHUNK, len(read_atoms(plan)))
    ev = PlanEvaluator(plan, device="cpu")
    assert ev._atoms.tolist() == read_atoms(plan) and len(ev._atoms) < N_ATOMS
    UPLOAD_STATS.reset()
    got = ev.eval_raw(coords[:n])
    assert UPLOAD_STATS.chunks == -(-n // CHUNK)
    assert torch.equal(got, todays_path(plan, coords[:n]))
    # frames as a CPU tensor and as a view that skips atoms go the same way
    assert torch.equal(ev.eval_raw(torch.as_tensor(coords[:n])), got)
    wide = np.concatenate([coords[:n], coords[:n, :3] + 100.0], axis=1)
    assert torch.equal(ev.eval_raw(wide), got)


def test_a_fit_reference_stages_whole_frames(system, chunk_of):
    top, coords = system
    plan = compile_plan(["coord-@CA_3.x", "coord-@CA_7.z", "dist-@CA_1-@CA_5"], top)
    fit = (coords[0] + 1.0, np.linspace(0.5, 1.5, N_ATOMS).astype(np.float32))
    chunk_of(CHUNK, N_ATOMS)
    ev = PlanEvaluator(plan, *fit, device="cpu")
    UPLOAD_STATS.reset()
    got = ev.eval_raw(coords[:150])
    assert UPLOAD_STATS.bytes_sent == UPLOAD_STATS.bytes_held == 150 * N_ATOMS * 12
    assert UPLOAD_STATS.chunks == 3
    assert torch.equal(got, todays_path(plan, coords[:150], fit))


def test_frames_of_only_the_plan_s_atoms_are_not_gathered(system, chunk_of):
    top, coords = system
    plan = compile_plan(["dist-@CA_1-@CA_9", "sin-@CA_2-@CA_3-@CA_4-@CA_5",
                         "dist-@CA_6-@CA_7", "coord-@CA_8.y"], top)
    chunk_of(CHUNK, 9)
    ev = PlanEvaluator(plan, device="cpu")
    assert ev._atoms.tolist() == list(range(9))
    UPLOAD_STATS.reset()
    only = ev.eval_raw(coords[:100, :9])
    assert UPLOAD_STATS.bytes_sent == UPLOAD_STATS.bytes_held == 100 * 9 * 12
    UPLOAD_STATS.reset()
    whole = ev.eval_raw(coords[:100])
    assert (UPLOAD_STATS.bytes_sent, UPLOAD_STATS.bytes_held) == (100 * 9 * 12, 100 * 12 * 12)
    want = todays_path(plan, coords[:100])
    assert torch.equal(only, want) and torch.equal(whole, want)


def test_frames_lacking_the_plan_s_atoms_raise(system):
    top, coords = system
    ev = PlanEvaluator(compile_plan(PLANS["distances"], top), device="cpu")
    for frames in (coords[:4, :8], coords[:4, :, :2], coords[0]):
        with pytest.raises(IndexError, match="9 atoms"):
            ev.eval_raw(frames)


@pytest.mark.parametrize("n", [0, 1, 64, 129, 400])
def test_the_counter_s_arithmetic(system, chunk_of, n):
    top, coords = system
    plan = compile_plan(PLANS["centers"], top)
    width = len(read_atoms(plan))
    chunk_of(CHUNK, width)
    ev = PlanEvaluator(plan, device="cpu")
    UPLOAD_STATS.reset()
    out = ev.eval_raw(coords[:n].astype(np.float64))
    assert out.shape == (n, 3)
    assert (UPLOAD_STATS.calls, UPLOAD_STATS.chunks, UPLOAD_STATS.frames) == (
        1, max(1, -(-n // CHUNK)), n)
    assert UPLOAD_STATS.bytes_sent == n * width * 12
    assert UPLOAD_STATS.bytes_held == n * N_ATOMS * 12
    assert UPLOAD_STATS.slot_waits == 0


def pipeline(top, labels):
    n = len(labels)
    rng = np.random.default_rng(3)
    projection = LinearProjection(rng.normal(size=n), rng.uniform(0.5, 2.0, n),
                                  rng.normal(size=(n, 3)), rng.normal(size=3),
                                  rng.uniform(0.5, 2.0, 3))
    return FramesToCV(projection, top, labels, device="cpu")


@pytest.mark.parametrize("n", [1, CHUNK - 1, CHUNK, CHUNK + 1, CHUNK * 5 // 2])
def test_frames_to_cv_at_chunk_boundaries(system, monkeypatch, chunk_of, n):
    """A call of `n` frames in chunks of 64 against one unchunked
    evaluation: the features bit for bit, the CVs within CV_ATOL, one chunk
    for every 64 frames begun."""
    top, coords = system
    frames = coords[7:7 + n]
    whole = pipeline(top, SERVED)
    want_features = whole.evaluator.eval_raw(frames)
    want = whole(frames)
    chunk_of(CHUNK, len(whole.evaluator.evaluators[0]._atoms))
    chunked = pipeline(top, SERVED)
    UPLOAD_STATS.reset()
    got = chunked(frames)
    assert UPLOAD_STATS.chunks == -(-n // CHUNK) and UPLOAD_STATS.calls == 1
    assert got.shape == want.shape == (n, 3)
    np.testing.assert_allclose(got, want, atol=CV_ATOL, rtol=0)
    assert torch.equal(chunked.evaluator.eval_raw(frames), want_features)
    assert torch.equal(want_features, todays_path(whole.plan, frames))


def test_a_cpu_mesh_of_several_entries_is_one_device(system, chunk_of):
    """Four shards of 96 frames, each in chunks of 64 through the ring of
    the one evaluator they share, against one device unchunked."""
    top, coords = system
    frames = coords[:384]
    one = pipeline(top, SERVED)
    want_features, want = one.evaluator.eval_raw(frames), one(frames)
    chunk_of(CHUNK, len(one.evaluator.evaluators[0]._atoms))
    with use_mesh(Mesh(("cpu",) * 4)):
        sharded = pipeline(top, SERVED)
        assert len(sharded.mesh) == 4
        UPLOAD_STATS.reset()
        got = sharded(frames)
        assert (UPLOAD_STATS.calls, UPLOAD_STATS.chunks) == (4, 8)
        got_features = sharded.evaluator.eval_raw(frames)
    np.testing.assert_allclose(got, want, atol=CV_ATOL, rtol=0)
    assert torch.equal(got_features, want_features)


@pytest.mark.parametrize("mesh_size", [1, 3])
def test_k1_runs_once_a_staged_chunk_of_each_slice(system, chunk_of, mesh_size):
    """What `chip_smoke.py` counts of `FramesToCV` on the card: K1 once for
    every chunk of `chunk_frames` frames begun, in each mesh entry's slice
    (here 134, 133, 133 frames)."""
    from deep_cartograph_torch.ops import pair_distances

    top, coords = system
    chunk_of(CHUNK, len(read_atoms(compile_plan(SERVED, top))))
    with use_mesh(Mesh(("cpu",) * mesh_size)):
        served = pipeline(top, SERVED)
        step = served.evaluator.evaluators[0].chunk_frames(N_ATOMS)
        assert step == CHUNK
        pair_distances.STATS.plain_calls = 0
        served(coords)
    want = sum(-(-len(part) // step) for part in np.array_split(coords, mesh_size))
    assert pair_distances.STATS.plain_calls == want == (7 if mesh_size == 1 else 9)


@pytest.mark.parametrize("floats, calls, team", [
    (1, 1, 1),
    (transport.GATHER_GRAIN, 1, 1),
    (transport.GATHER_GRAIN + 1, 1, 2),
    (2048 * 80 * 3, 1, 2),        # a featurize block of 2,048 CA frames
    (transport.SLOT_BYTES // 4, 1, 7),     # a full slot: every core but one
    (transport.SLOT_BYTES // 4, 2, 3),     # two evaluators staging at once share them
    (transport.SLOT_BYTES // 4, 4, 1),
    (transport.SLOT_BYTES // 4, 9, 1),
])
def test_the_gather_s_team_follows_the_block_and_the_calls_staging(monkeypatch, floats,
                                                                   calls, team):
    """On eight cores: a thread a GATHER_GRAIN floats, at most seven, split
    among the calls staging at once."""
    monkeypatch.setattr(transport.os, "sched_getaffinity", lambda pid: set(range(8)),
                        raising=False)
    monkeypatch.setattr(transport, "_staging_calls", calls)
    assert transport._gather_team(floats) == team


def test_calls_staging_at_once_are_counted(system):
    """Two evaluators' calls inside their staged loops at once read a count
    of 2; one alone reads 1, and none is left counted after."""
    import threading

    top, coords = system
    evaluators = [PlanEvaluator(compile_plan(PLANS[name], top), device="cpu")
                  for name in ("distances", "dihedrals")]
    both_in = threading.Barrier(2, timeout=60)
    seen = []

    def then(features):
        both_in.wait()
        seen.append(transport._staging_calls)
        both_in.wait()
        return features

    threads = [threading.Thread(target=ev.eval_raw, args=(coords[:50], then))
               for ev in evaluators]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert seen == [2, 2]
    evaluators[0].eval_raw(coords[:50], lambda f: seen.append(transport._staging_calls) or f)
    assert seen[-1] == 1 and transport._staging_calls == 0


def test_the_gather_copies_the_named_atoms_and_checks_its_buffers():
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(70_000, 5, 3)).astype(np.float32)   # threads split it
    atoms = np.array([4, 0, 2], np.int64)
    out = torch.empty(70_000 * 3 * 3)
    transport.stage_atoms(frames, atoms, out, threads=4)
    assert np.array_equal(out.numpy().reshape(70_000, 3, 3), frames[:, atoms])
    whole = torch.empty(frames.size)
    transport.stage_atoms(frames, None, whole, threads=3)
    assert np.array_equal(whole.numpy().reshape(frames.shape), frames)
    for bad in (frames.astype(np.float64), frames[:, ::2]):
        with pytest.raises(ValueError, match="stage_atoms needs"):
            transport.stage_atoms(bad, atoms, out[:bad.shape[0] * 9])
    with pytest.raises(ValueError, match="stage_atoms needs"):
        transport.stage_atoms(frames, atoms, out[:-1])
    for bad_atoms in (np.array([4, 0, 5]), np.array([4, -1, 2]), atoms.astype(np.int32)):
        with pytest.raises(ValueError, match="int64 atoms in"):
            transport.stage_atoms(frames, bad_atoms, out)


def test_threads_sharing_an_evaluator_each_get_their_frames(system, chunk_of):
    """More threads than cores call one evaluator at once, each on frames
    of its own in several chunks of the one ring, with the interpreter
    switching threads every microsecond: every result is its own frames'
    features, and the counter loses no update."""
    import os
    import sys
    import threading

    top, coords = system
    plan = compile_plan(PLANS["column_order"], top)
    chunk_of(32, len(read_atoms(plan)))
    ev = PlanEvaluator(plan, device="cpu")
    n_threads = 2 * (os.cpu_count() or 4)
    starts = [(7 * i) % 300 for i in range(n_threads)]
    results = [None] * n_threads

    def work(i):
        results[i] = ev.eval_raw(coords[starts[i]:starts[i] + 96])

    UPLOAD_STATS.reset()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    for start, got in zip(starts, results):
        assert torch.equal(got, todays_path(plan, coords[start:start + 96]))
    assert (UPLOAD_STATS.calls, UPLOAD_STATS.chunks, UPLOAD_STATS.frames) == (
        n_threads, 3 * n_threads, 96 * n_threads)
