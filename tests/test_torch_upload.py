"""The port's int16 coordinate transport (deep_cartograph_torch/io/upload.py)
and the Featurizer's upload="int16" against the JAX package's, on the CPU.

Tolerances: quantization bit-equal (the same numpy arithmetic);
dequantization within 1 float32 ulp of the JAX package's (XLA may fuse the
multiply-add); int16 features within 1e-5 of the JAX package's int16
features; int16 features within the bound derived below of the port's own
float32 features."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_cartograph_torch.geom.engine import Featurizer
from deep_cartograph_torch.io import upload as tup
from deep_cartograph_torch.io.dcd import write_dcd
from deep_cartograph_torch.io.topology import Topology
from deep_cartograph_torch.utils.demo_data import ca_coords, write_ca_pdb
from deep_cartograph_tpu.geom.engine import Featurizer as JaxFeaturizer
from deep_cartograph_tpu.io import upload as jup
from deep_cartograph_tpu.io.topology import Topology as JaxTopology

torch.set_num_threads(2)

N_RES, N_FRAMES, CHUNK = 10, 90, 32


def _blocks():
    rng = np.random.default_rng(0)
    yield (rng.standard_normal((17, 12, 3)) * 20 + 5).astype(np.float32)
    yield (rng.standard_normal((40, 3)) * 3).astype(np.float32)
    flat = (rng.standard_normal((9, 5, 3)) * 7).astype(np.float32)
    flat[:, :, 1] = 2.5  # a zero-span axis round-trips exactly
    yield flat
    yield np.zeros((4, 2, 3), np.float32)


def test_quantize_is_bit_equal_and_dequantize_within_an_ulp():
    for block in _blocks():
        q, scale, offset = tup.quantize_coords(block)
        jq, jscale, joffset = jup.quantize_coords(block)
        assert q.dtype == np.int16 and scale.dtype == offset.dtype == np.float32
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(scale.view(np.uint32), jscale.view(np.uint32))
        np.testing.assert_array_equal(offset.view(np.uint32), joffset.view(np.uint32))
        got = tup.dequantize_coords(torch.from_numpy(q), torch.from_numpy(scale),
                                    torch.from_numpy(offset)).numpy()
        want = np.asarray(jup.dequantize_coords(jnp.asarray(jq), jnp.asarray(jscale),
                                                jnp.asarray(joffset)))
        assert got.dtype == np.float32
        ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
        assert (np.abs(got - want) <= ulp).all()
        # the error bound the step states
        step = tup.quantization_step(scale)
        assert step == jup.quantization_step(jscale)
        assert np.abs(got - block).max() <= step * (1 + 1e-5) + np.spacing(
            np.abs(block).max())


def test_upload_coords_modes():
    block = next(_blocks())
    exact = tup.upload_coords(block, "float32", device="cpu")
    assert exact.dtype == torch.float32 and np.array_equal(exact.numpy(), block)
    q, scale, offset = tup.quantize_coords(block)
    got = tup.upload_coords(block, "int16", device="cpu").numpy()
    np.testing.assert_array_equal(got, tup.dequantize_coords(
        torch.from_numpy(q), torch.from_numpy(scale), torch.from_numpy(offset)).numpy())
    with pytest.raises(ValueError, match="unknown upload mode"):
        tup.upload_coords(block, "bfloat16", device="cpu")


def test_upload_mode_setting(system, monkeypatch):
    """The port takes "float32" or "int16" and refuses every other mode,
    "auto" too: DC_TPU_UPLOAD, which the JAX package reads, picks nothing."""
    monkeypatch.setenv("DC_TPU_UPLOAD", "int16")
    assert jup.resolve_upload_mode() == "int16"
    for mode in ("auto", "half", "int8"):
        with pytest.raises(ValueError, match="unknown upload mode"):
            _port_features(system, mode)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    root = tmp_path_factory.mktemp("upload")
    coords = ca_coords(N_RES, N_FRAMES, seed=3) * 3.0  # spans of tens of Angstrom
    pdb, dcd = str(root / "ca.pdb"), str(root / "ca.dcd")
    write_ca_pdb(pdb, coords[0])
    write_dcd(dcd, coords)
    pairs = [(i, j) for i in range(1, N_RES + 1) for j in range(i + 1, N_RES + 1)]
    quads = [tuple(range(i, i + 4)) for i in range(1, N_RES - 2)]
    labels = [f"dist-@CA_{i}-@CA_{j}" for i, j in pairs]
    for kind in ("sin", "cos"):
        labels += [f"{kind}-" + "-".join(f"@CA_{a}" for a in q) for q in quads]
    return {"coords": coords, "pdb": pdb, "dcd": dcd, "labels": labels,
            "n_pairs": len(pairs), "pairs": pairs, "quads": quads}


def _port_features(system, upload):
    top = Topology.from_pdb(system["pdb"])
    featurizer = Featurizer(top, system["labels"], device="cpu")
    return featurizer.featurize_trajectory(system["dcd"], frame_chunk=CHUNK, upload=upload)


def test_int16_features_match_jax(system):
    got = _port_features(system, "int16")
    jtop = JaxTopology.from_pdb(system["pdb"])
    want = JaxFeaturizer(jtop, system["labels"], device="cpu").featurize_trajectory(
        system["dcd"], frame_chunk=CHUNK, upload="int16")
    assert got.shape == want.shape == (N_FRAMES, len(system["labels"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_upload_default_ignores_the_setting(system, monkeypatch):
    """The Featurizer's default is the exact float32 copy: DC_TPU_UPLOAD
    (set for a JAX run, say) does not reach the port."""
    monkeypatch.setenv("DC_TPU_UPLOAD", "int16")
    top = Topology.from_pdb(system["pdb"])
    default = Featurizer(top, system["labels"], device="cpu").featurize_trajectory(
        system["dcd"], frame_chunk=CHUNK)
    np.testing.assert_array_equal(default, _port_features(system, "float32"))


def _dihedral_error_bound(coords, quads, delta):
    """(frames, quads): how far the sine or cosine of a dihedral can move
    when each coordinate moves by at most delta (per frame, per axis), plus
    the float32 rounding of two evaluations. With F = r0 - r1, G = r1 - r2,
    H = r3 - r2 (each moving by at most d = 2 sqrt(3) delta), A = F x G and
    B = H x G, the sine and cosine are products of the unit vectors of A, B
    and G; a unit vector moves by at most 2 |dV| / |V| (and by 2 at most),
    and |dA| <= d |G| + |F| d + d^2. Float32 loses eps |F||G| / |A| of A
    (the cross product's cancellation), in each evaluation."""
    x = coords.astype(np.float64)
    q = np.asarray(quads) - 1
    f = x[:, q[:, 0]] - x[:, q[:, 1]]
    g = x[:, q[:, 1]] - x[:, q[:, 2]]
    h = x[:, q[:, 3]] - x[:, q[:, 2]]
    nf, ng, nh = (np.linalg.norm(v, axis=-1) for v in (f, g, h))
    na = np.linalg.norm(np.cross(f, g), axis=-1)
    nb = np.linalg.norm(np.cross(h, g), axis=-1)
    d = 2 * np.sqrt(3) * delta[:, None]
    moved = (np.minimum(2, 2 * (d * ng + nf * d + d * d) / na)
             + np.minimum(2, 2 * (d * ng + nh * d + d * d) / nb)
             + np.minimum(2, 2 * d / ng))
    eps = float(np.finfo(np.float32).eps)
    return moved + FLOAT32_ALLOWANCE + 16 * eps * (nf * ng / na + nh * ng / nb)


# Float32 arithmetic of the two feature computations (distances of a few nm,
# angles through float32 atan2), beyond the quantization's own error.
FLOAT32_ALLOWANCE = 4e-6


def test_int16_features_within_the_quantization_bound(system):
    """Every coordinate of a chunk moves by at most delta = its
    quantization_step (scale / 2) plus the float32 rounding of the
    dequantized value, per axis, so by at most sqrt(3) delta in norm. A
    distance (nm) then moves by at most 0.1 * 2 sqrt(3) delta, a dihedral's
    sine or cosine by `_dihedral_error_bound`."""
    got = _port_features(system, "int16")
    exact = _port_features(system, "float32")
    coords = system["coords"]
    eps = float(np.finfo(np.float32).eps)
    delta = np.empty(N_FRAMES)
    for s in range(0, N_FRAMES, CHUNK):
        block = coords[s:s + CHUNK]
        delta[s:s + CHUNK] = (tup.quantization_step(tup.quantize_coords(block)[1])
                              + 2 * eps * np.abs(block).max())
    assert 1e-5 < delta.max() < 1e-2
    n_pairs = system["n_pairs"]
    dist_bound = 0.1 * 2 * np.sqrt(3) * delta[:, None] + FLOAT32_ALLOWANCE
    dist_err = np.abs(got[:, :n_pairs] - exact[:, :n_pairs])
    assert (dist_err <= dist_bound).all(), float((dist_err - dist_bound).max())
    bound = _dihedral_error_bound(coords, system["quads"], delta)
    n_q = len(system["quads"])
    for k in range(2):  # sin, then cos
        cols = slice(n_pairs + k * n_q, n_pairs + (k + 1) * n_q)
        err = np.abs(got[:, cols] - exact[:, cols])
        assert (err <= bound).all(), float((err - bound).max())
    # the quantization is visible: the bound is not vacuous
    assert dist_err.max() > 10 * FLOAT32_ALLOWANCE
