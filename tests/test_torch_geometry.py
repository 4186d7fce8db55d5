"""The port's geometry analysis, augmentation, hydrogen bonds and md surface
(deep_cartograph_torch/geom/{kernels,analysis,pbc,interpolate,hbonds}.py,
utils/demo_data.py, md.py) against the JAX package's, on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_cartograph_torch.geom.analysis as ta
import deep_cartograph_torch.geom.hbonds as th
import deep_cartograph_torch.geom.interpolate as ti
import deep_cartograph_torch.geom.pbc as tp
import deep_cartograph_torch.md as tmd
import deep_cartograph_tpu.geom.analysis as ja
import deep_cartograph_tpu.geom.hbonds as jh
import deep_cartograph_tpu.geom.interpolate as ji
import deep_cartograph_tpu.geom.pbc as jp
import deep_cartograph_tpu.md as jmd
from deep_cartograph_torch.geom.kernels import rmsd_per_frame
from deep_cartograph_torch.io.traj import read_traj
from deep_cartograph_torch.utils import demo_data as tdemo
from deep_cartograph_tpu.geom.kernels import rmsd_per_frame as jax_rmsd_per_frame
from deep_cartograph_tpu.utils import demo_data as jdemo
from tests.fixtures import make_backbone_system, make_ca_system, make_shifted_ca_pdb

torch.set_num_threads(2)

TOL = 1e-5   # Angstrom


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    root = tmp_path_factory.mktemp("geometry")
    ca = make_ca_system(str(root / "ca"), n_residues=12, n_frames=40, seed=21)
    return {
        "ca": ca,
        "ca_shifted": make_shifted_ca_pdb(str(root / "ca"), ca, resid_offset=100),
        "backbone": make_backbone_system(str(root / "bb"), n_residues=6, n_frames=50,
                                         seed=22),
    }


# ---------------------------------------------------------------------------
# RMSD, RMSF, dRMSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_weights,with_indices", [(False, False), (True, False),
                                                       (False, True), (True, True)])
def test_rmsd_per_frame_matches_jax(with_weights, with_indices):
    rng = np.random.default_rng(31)
    ref = rng.normal(0, 5, (17, 3)).astype(np.float32)
    mobile = (ref[None] + rng.normal(0, 0.7, (25, 17, 3))).astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    mobile = mobile @ rot.T + 3.0
    weights = rng.uniform(0.5, 2.0, 17).astype(np.float32) if with_weights else None
    indices = np.array([0, 3, 4, 9, 16]) if with_indices else None
    want = jax_rmsd_per_frame(jnp.asarray(mobile), jnp.asarray(ref),
                              None if weights is None else jnp.asarray(weights),
                              None if indices is None else jnp.asarray(indices))
    got = rmsd_per_frame(torch.as_tensor(mobile), torch.as_tensor(ref),
                         None if weights is None else torch.as_tensor(weights),
                         None if indices is None else torch.as_tensor(indices))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


RMSD_CASES = [
    ("ca", "name CA", "name CA", None),
    ("ca", "resid 1:8", "name CA", None),
    ("ca", "name CA", "name CA", "ca_shifted"),
    ("ca", "name CA", "name CA", "ca_pdb"),
    ("backbone", "name CA", "name N or name CA or name C", None),
    ("backbone", "name O", "name CA", "backbone_pdb"),
]


@pytest.mark.parametrize("system,selection,fit_selection,reference", RMSD_CASES)
def test_rmsd_matches_jax(systems, system, selection, fit_selection, reference):
    s = systems[system]
    reference_path = {None: None, "ca_shifted": systems["ca_shifted"],
                      "ca_pdb": s.pdb_path, "backbone_pdb": s.pdb_path}[reference]
    want = ja.RMSD(s.dcd_path, s.pdb_path, selection, fit_selection, reference_path)
    got = ta.RMSD(s.dcd_path, s.pdb_path, selection, fit_selection, reference_path,
                  device="cpu")
    assert got.shape == (s.coords.shape[0],) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_rmsd_across_topologies_maps_residues(systems):
    """The shifted topology numbers its residues from 101: the mapping
    pairs them by sequence, so the RMSD against it is the RMSD against the
    first frame."""
    s = systems["ca"]
    shifted = ta.RMSD(s.dcd_path, s.pdb_path, "name CA", "name CA", systems["ca_shifted"],
                      device="cpu")
    plain = ta.RMSD(s.dcd_path, s.pdb_path, "name CA", "name CA", device="cpu")
    np.testing.assert_allclose(shifted, plain, atol=TOL)
    assert shifted[0] < 1e-2 < shifted.max()


@pytest.mark.parametrize("system,selection,fit_selection", [
    ("ca", "name CA", "name CA"),
    ("ca", "resid 4:9", "resid 1:6"),
    ("backbone", "name CA or name O", "name N or name CA or name C"),
])
def test_rmsf_matches_jax(systems, system, selection, fit_selection):
    s = systems[system]
    want_values, want_residues = ja.RMSF(s.dcd_path, s.pdb_path, selection, fit_selection)
    values, residues = ta.RMSF(s.dcd_path, s.pdb_path, selection, fit_selection,
                               device="cpu")
    assert residues == want_residues
    np.testing.assert_allclose(values, want_values, atol=TOL, rtol=0)


@pytest.mark.parametrize("system,selection,stride,reference", [
    ("ca", "name CA", 1, "self"),
    ("ca", "name CA", 2, "self"),
    ("ca", "name CA", 1, "ca_shifted"),
    ("backbone", "name CA", 1, "self"),
    ("backbone", "name N or name O", 1, "self"),
])
def test_drmsd_matches_jax(systems, system, selection, stride, reference):
    s = systems[system]
    reference_path = s.pdb_path if reference == "self" else systems[reference]
    want = ja.dRMSD(s.dcd_path, s.pdb_path, selection, stride, reference_path)
    got = ta.dRMSD(s.dcd_path, s.pdb_path, selection, stride, reference_path,
                   device="cpu")
    assert got.shape == (s.coords.shape[0],)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_drmsd_goes_through_k1(systems):
    """dRMSD featurizes the reference and the trajectory through kernel
    K1's wrapper (its plain version for CPU tensors)."""
    from deep_cartograph_torch.ops import pair_distances as k1

    s = systems["ca"]
    calls = []
    real = k1.pair_distances_plain
    k1.pair_distances_plain = lambda *a: calls.append(a[0].shape) or real(*a)
    try:
        ta.dRMSD(s.dcd_path, s.pdb_path, "name CA", 1, s.pdb_path, device="cpu")
    finally:
        k1.pair_distances_plain = real
    assert [c[0] for c in calls] == [1, s.coords.shape[0]]


def test_empty_selections_raise(systems, tmp_path):
    s = systems["ca"]
    for module, kw in ((ja, {}), (ta, {"device": "cpu"})):
        with pytest.raises(ValueError, match="matched 0 atoms"):
            module.RMSD(s.dcd_path, s.pdb_path, "name ZZ", "name CA", **kw)
        with pytest.raises(ValueError, match="matched 0 atoms"):
            module.RMSD(s.dcd_path, s.pdb_path, "name CA", "name ZZ", **kw)
        with pytest.raises(ValueError, match="matched 0 atoms"):
            module.RMSF(s.dcd_path, s.pdb_path, "name ZZ", "name CA", **kw)
    for module in (ji, ti):
        with pytest.raises(ValueError, match="matched 0 atoms"):
            module.interpolate_trajectory(s.pdb_path, s.dcd_path, 60,
                                          atom_selection="name ZZ",
                                          output_path=str(tmp_path))
    for module, kw in ((ja, {}), (ta, {"device": "cpu"})):
        with pytest.raises(ValueError, match="'name ZZ' is empty"):
            module.dRMSD(s.dcd_path, s.pdb_path, "name ZZ", 1, s.pdb_path, **kw)


# ---------------------------------------------------------------------------
# Periodic boundaries
# ---------------------------------------------------------------------------

def _boxed_molecules(seed: int, n_frames: int = 6):
    """Three chains and a lone atom in a box, wrapped into the primary cell
    frame by frame; bonds along each chain."""
    rng = np.random.default_rng(seed)
    box = np.array([18.0, 21.0, 25.0], np.float32)
    frames, bonds, start = [], [], 0
    sizes = (9, 5, 7, 1)
    for size in sizes:
        bonds += [(start + i, start + i + 1) for i in range(size - 1)]
        start += size
    for _ in range(n_frames):
        atoms = []
        for size in sizes:
            origin = rng.uniform(0, box)
            direction = rng.standard_normal(3)
            direction /= np.linalg.norm(direction)
            atoms.append(origin + np.arange(size)[:, None] * 1.5 * direction)
        pos = np.concatenate(atoms)
        frames.append(pos - box * np.floor(pos / box))
    boxes = np.tile(box, (n_frames, 1)).astype(np.float32)
    return np.asarray(frames, np.float32), boxes, bonds


@pytest.mark.parametrize("group", [None, np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 21])])
def test_pbc_is_bit_equal_to_jax(group):
    coords, boxes, bonds = _boxed_molecules(41)
    n_atoms = coords.shape[1]
    want_levels = jp.bond_spanning_levels(bonds, n_atoms, group)
    levels = tp.bond_spanning_levels(bonds, n_atoms, group)
    assert len(levels) == len(want_levels)
    for (p, c), (wp, wc) in zip(levels, want_levels):
        np.testing.assert_array_equal(p, wp)
        np.testing.assert_array_equal(c, wc)
    for box in (boxes, boxes[0]):
        np.testing.assert_array_equal(tp.make_whole(coords, box, levels),
                                      jp.make_whole(coords, box, want_levels))
        for wrap in (True, False):
            np.testing.assert_array_equal(tp.center_in_box(coords, box, group, wrap),
                                          jp.center_in_box(coords, box, group, wrap))
    np.testing.assert_array_equal(tp.prepare_frames(coords, boxes, bonds, group),
                                  jp.prepare_frames(coords, boxes, bonds, group))
    np.testing.assert_array_equal(tp.prepare_frames(coords, boxes, [], group),
                                  jp.prepare_frames(coords, boxes, [], group))
    np.testing.assert_array_equal(tp.prepare_frames(coords, None, bonds, group),
                                  jp.prepare_frames(coords, None, bonds, group))


# ---------------------------------------------------------------------------
# Augmentation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["pchip", "akima", None])
@pytest.mark.parametrize("keep_original_frames", [True, False])
@pytest.mark.parametrize("noise_std", [None, 0.05])
def test_interpolate_trajectory_matches_jax(systems, tmp_path, method,
                                            keep_original_frames, noise_std):
    s = systems["ca"]
    out = {}
    for name, module in (("jax", ji), ("torch", ti)):
        folder = tmp_path / name
        folder.mkdir()
        traj, top = module.interpolate_trajectory(
            s.pdb_path, s.dcd_path, 97, keep_original_frames=keep_original_frames,
            interpolation_method=method, noise_std=noise_std, random_seed=7,
            atom_selection="resid 2:10", traj_format="dcd", output_path=str(folder),
            suffix="_x")
        out[name] = (traj, top)
    (jt, jtop), (tt, ttop) = out["jax"], out["torch"]
    assert os.path.basename(tt) == os.path.basename(jt) == f"ca_example_augmented_{method}_x.dcd"
    assert os.path.basename(ttop) == os.path.basename(jtop)
    got, want = read_traj(tt), read_traj(jt)
    assert got.shape == want.shape == ((97 if method else 40), 9, 3)
    np.testing.assert_array_equal(got, want)
    with open(ttop) as a, open(jtop) as b:
        assert a.read() == b.read()


def _write_boxed_pdb(path: str, coords: np.ndarray, box: np.ndarray) -> None:
    with open(path, "w") as fh:
        fh.write(f"CRYST1{box[0]:9.3f}{box[1]:9.3f}{box[2]:9.3f}"
                 f"{90.0:7.2f}{90.0:7.2f}{90.0:7.2f} P 1           1\n")
        for f, frame in enumerate(coords):
            fh.write(f"MODEL     {f + 1:>4}\n")
            for i, (x, y, z) in enumerate(frame):
                fh.write(f"ATOM  {i + 1:>5}  CA  ALA A{i + 1:>4}    "
                         f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}           C\n")
            fh.write("ENDMDL\n")
        fh.write("END\n")


@pytest.mark.parametrize("traj_format", ["xtc", "pdb"])
def test_interpolate_prepared_trajectory_matches_jax(tmp_path, traj_format):
    """A boxed, wrapped trajectory unwrapped and centred (prepare_frames)
    before it is interpolated; written as XTC or PDB; the second call skips
    the work when both outputs exist."""
    coords, boxes, _ = _boxed_molecules(43, n_frames=8)
    chain = coords[:, :9]
    traj = str(tmp_path / "boxed.pdb")
    _write_boxed_pdb(traj, chain, boxes[0])
    out = {}
    for name, module in (("jax", ji), ("torch", ti)):
        folder = tmp_path / name
        folder.mkdir()
        out[name] = module.interpolate_trajectory(
            traj, traj, 20, prepare_trajectory=True, traj_format=traj_format,
            output_path=str(folder))
    got, want = read_traj(out["torch"][0]), read_traj(out["jax"][0])
    np.testing.assert_array_equal(got, want)
    with open(out["torch"][0], "rb") as a, open(out["jax"][0], "rb") as b:
        assert a.read() == b.read()
    stamp = os.path.getmtime(out["torch"][0])
    again = ti.interpolate_trajectory(traj, traj, 20, prepare_trajectory=True,
                                      traj_format=traj_format,
                                      output_path=str(tmp_path / "torch"))
    assert again == out["torch"] and os.path.getmtime(again[0]) == stamp


def test_unknown_interpolation_method_raises(systems, tmp_path):
    s = systems["ca"]
    with pytest.raises(ValueError, match="not supported"):
        ti.interpolate_trajectory(s.pdb_path, s.dcd_path, 60, interpolation_method="cubic",
                                  output_path=str(tmp_path))


# ---------------------------------------------------------------------------
# Hydrogen bonds
# ---------------------------------------------------------------------------

def test_backbone_generator_equals_jax():
    for args in ((6, 20, 13, True), (4, 7, 5, False)):
        got, want = tdemo.backbone_coords(*args), jdemo.backbone_coords(*args)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def _triplet_frame(ha_dist: float, angle_deg: float) -> np.ndarray:
    d, h = np.zeros(3), np.array([1.0, 0.0, 0.0])
    theta = np.deg2rad(angle_deg)
    return np.stack([d, h, h + ha_dist * np.array([-np.cos(theta), np.sin(theta), 0.0])])


def test_hbond_mask_matches_jax():
    rng = np.random.default_rng(51)
    frames = [_triplet_frame(1.9, 170.0), _triplet_frame(3.5, 170.0),
              _triplet_frame(1.9, 90.0)]
    frames += [_triplet_frame(rng.uniform(1.0, 3.0), rng.uniform(60, 180)) for _ in range(200)]
    coords = np.asarray(frames, np.float32)
    trip = [np.array([0], np.int32), np.array([1], np.int32), np.array([2], np.int32)]
    want = np.asarray(jh._hbond_mask(jnp.asarray(coords), *map(jnp.asarray, trip), 3.0, 150.0))
    got = th.hbond_mask(coords, *trip, 3.0, 150.0, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got[:3, 0].tolist() == [True, False, False]
    assert 20 < got.sum() < 180


@pytest.mark.parametrize("kwargs", [
    dict(first_selection="resid 2", second_selection="resid 3", d_a_cutoff=9.0,
         d_h_a_angle_cutoff=40.0, donors_sel="name N", hydrogens_sel="name H",
         acceptors_sel="name O"),
    dict(first_selection="all", second_selection="all", d_a_cutoff=6.0,
         d_h_a_angle_cutoff=90.0),
    dict(first_selection="resid 1:3", second_selection="resid 4:6",
         d_a_cutoff=8.0, d_h_a_angle_cutoff=60.0, remove_pbc=True),
    dict(first_selection="resid 1", second_selection="resid 4", donors_sel="name ZZ"),
])
def test_hbond_events_match_jax(systems, kwargs):
    s = systems["backbone"]
    want, want_frames = jh.analyze_residue_hbonds(s.pdb_path, s.dcd_path, **kwargs)
    got, n_frames = th.analyze_residue_hbonds(s.pdb_path, s.dcd_path, device="cpu", **kwargs)
    assert n_frames == want_frames == s.coords.shape[0]
    assert list(got) == list(want.columns)
    for column in got:
        assert len(got[column]) == len(want)
        np.testing.assert_array_equal(got[column], want[column].to_numpy())
    assert th.hbond_occupancy(got, n_frames) == jh.hbond_occupancy(want, want_frames)
    if kwargs.get("donors_sel") == "name ZZ":
        assert len(got["frame"]) == 0
    else:
        assert len(got["frame"]) > 0


def test_hbond_mask_chunks_do_not_change_events(systems, monkeypatch):
    s = systems["backbone"]
    kwargs = dict(first_selection="all", second_selection="all", d_a_cutoff=6.0,
                  d_h_a_angle_cutoff=90.0, device="cpu")
    whole, _ = th.analyze_residue_hbonds(s.pdb_path, s.dcd_path, **kwargs)
    monkeypatch.setattr(th, "_MASK_BYTE_BUDGET", 1)  # one frame a chunk
    chunked, _ = th.analyze_residue_hbonds(s.pdb_path, s.dcd_path, **kwargs)
    for column in whole:
        np.testing.assert_array_equal(chunked[column], whole[column])


# ---------------------------------------------------------------------------
# The md compatibility surface
# ---------------------------------------------------------------------------

def test_md_surface_names_match_jax():
    assert tmd.__all__ == jmd.__all__
    for name in tmd.__all__:
        assert callable(getattr(tmd, name)), name


def test_md_surface_gives_the_jax_results(systems, tmp_path):
    s, bb = systems["ca"], systems["backbone"]
    top, traj = bb.pdb_path, bb.dcd_path
    for name, args in [
        ("get_number_atoms", (top, "name CA")),
        ("get_indices", (top, "name N or name O")),
        ("atom_entity_to_index", ("@CA_3", top)),
        ("find_distances", (top, "name CA", "name O", 1, 1, True, True)),
        ("find_dihedrals", (top, "all", "protein_backbone")),
        ("find_coordinates", (top, "name CA", 2)),
        ("get_distance_labels", (top, {"first_selection": "name CA",
                                       "second_selection": "name CA"})),
        ("find_virtual_dihedral", (s.pdb_path, "name CA")),
        ("find_protein_back_dihedrals", (top, "all")),
        ("find_all_real_dihedrals", (top, "all")),
        ("to_entity_name", ("name CA and resid 3",)),
        ("to_mda_selection", ("@CA_3",)),
    ]:
        assert getattr(tmd, name)(*args) == getattr(jmd, name)(*args), name
    for kw in ({}, {"selection": "name CA", "start": 3, "stop": 40, "step": 4},
               {"selection": "resid 2:4", "prepare_trajectory": True}):
        got, want = tmd.load_coordinates(top, traj, **kw), jmd.load_coordinates(top, traj, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    universe, jax_universe = tmd.load_universe(top, traj), jmd.load_universe(top, traj)
    np.testing.assert_array_equal(universe.trajectory.coords, jax_universe.trajectory.coords)
    assert len(universe.select_atoms("name H")) == len(jax_universe.select_atoms("name H"))
    with pytest.raises(ValueError, match="matched 0 atoms"):
        tmd.load_universe(top, traj, selection="name ZZ")
    assert tmd.find_supported_top(os.path.dirname(top)) == \
        jmd.find_supported_top(os.path.dirname(top))
    assert tmd.find_supported_traj(os.path.dirname(top)) == \
        jmd.find_supported_traj(os.path.dirname(top))
    np.testing.assert_allclose(
        tmd.RMSD(traj, top, "name CA", "name CA", device="cpu"),
        jmd.RMSD(traj, top, "name CA", "name CA"), atol=TOL)
    np.testing.assert_allclose(
        tmd.dRMSD(traj, top, "name CA", 1, top, device="cpu"),
        jmd.dRMSD(traj, top, "name CA", 1, top), atol=TOL)
    got = tmd.RMSF(traj, top, "name CA", "name CA", device="cpu")
    want = jmd.RMSF(traj, top, "name CA", "name CA")
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], atol=TOL)
    for name, module in (("t", tmd), ("j", jmd)):
        module.extract_PDB(traj, top, 5, str(tmp_path / f"{name}.pdb"))
        module.extract_XTC(traj, top, [1, 4, 9], str(tmp_path / f"{name}.xtc"))
    for ext in ("pdb", "xtc"):
        with open(tmp_path / f"t.{ext}", "rb") as a, open(tmp_path / f"j.{ext}", "rb") as b:
            assert a.read() == b.read()
