#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deep_cartograph_torch) on one CUDA card.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) if it fails:

1. Device and build: requires CUDA, prints the card's name and power limit
   (nvidia-smi), builds every kernel from ops/csrc with nvcc in parallel.
2. Kernels against their plain PyTorch versions at the main path's shapes:
   K1 (pair distances) on one featurize chunk (the 20,000 frames asked for,
   clamped by auto_chunk_size to 13,899) of 48 CA atoms x 1,081 pairs,
   K2 (KDE logsumexp) on a 150 x 150 grid x 100,000 samples.
   Each is timed with CUDA events beside its plain version, one PyTorch
   library call computing the same function, and its bound on this card.
3. Main path, the serving path at the shape of the repo's headline
   workload (BASELINE.md config 2): write a 100,000-frame x 48-atom DCD and
   its CA PDB, featurize it (1,171 features), project every frame through
   a seeded (1171, 64, 64, 2) tanh deep-TICA net with FramesToCV, and draw
   the 1-D FES of each CV (dense branch) and the 2-D FES (K2 branch). The
   kernels' launch counters are zeroed just before and read just after,
   and the outputs are checked against numpy references on a small input.

Prints the nvidia-smi line, then one JSON line {"kernels": [...]}, then, as
the last line, {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_FRAMES = 100_000
N_ATOMS = 48
CHUNK = 20_000           # featurize frame chunk asked for (bench.py's CHUNK)
NUM_BINS = 150           # FES grid per axis (the config's default num_bins)
BANDWIDTH = 0.05
SEED = 0

# Published peaks of one H100 SXM (NVIDIA data sheet; 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SFU_OPS_PER_CLOCK_PER_SM = 16   # exp2 etc. on the special-function units

K1_TOL = 1e-5                   # nm, absolute
K2_ATOL, K2_RTOL = 1e-4, 1e-5   # log density: fp32 rounding of -|d|^2
FES_TOL = 1e-3                  # kJ/mol against float64 numpy


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# Workload (bench.py:97-125, copied: bench.py imports JAX)
# ---------------------------------------------------------------------------

def make_trajectory(n_frames: int, n_atoms: int) -> np.ndarray:
    rng = np.random.default_rng(SEED)
    t = np.linspace(0, 4 * np.pi, n_atoms)
    base = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * t], 1).astype(
        np.float32
    )
    n_modes = 8
    phases = rng.uniform(0, 2 * np.pi, n_modes).astype(np.float32)
    freqs = rng.uniform(0.5, 3.0, n_modes).astype(np.float32)
    shapes = (rng.standard_normal((n_modes, n_atoms, 3)) * 0.3).astype(np.float32)
    tt = np.arange(n_frames, dtype=np.float32) / n_frames * 2 * np.pi
    waves = np.sin(freqs[None, :] * tt[:, None] + phases[None, :])
    return (base[None] + np.einsum("fm,mad->fad", waves, shapes)).astype(
        np.float32
    )


def make_labels(n_atoms: int):
    """All non-neighbor CA pair distances + sin/cos of consecutive virtual
    dihedrals — the feature families of the reference's default config."""
    labels = []
    for i in range(1, n_atoms + 1):
        for j in range(i + 2, n_atoms + 1):
            labels.append(f"dist-@CA_{i}-@CA_{j}")
    n_dihedrals = n_atoms - 3
    for i in range(1, n_dihedrals + 1):
        labels.append(f"sin-@CA_{i}-@CA_{i + 1}-@CA_{i + 2}-@CA_{i + 3}")
        labels.append(f"cos-@CA_{i}-@CA_{i + 1}-@CA_{i + 2}-@CA_{i + 3}")
    return labels


def write_ca_pdb(path: str, coords_frame: np.ndarray) -> None:
    residues = ["ALA", "GLY", "SER", "VAL", "LEU", "THR", "PRO", "PHE"]
    with open(path, "w") as fh:
        for i, (x, y, z) in enumerate(coords_frame):
            fh.write(
                f"ATOM  {i + 1:>5}  CA  {residues[i % 8]:<4}A{i + 1:>4}    "
                f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}           C\n"
            )
        fh.write("END\n")


def cv_like_samples(n: int, seed: int) -> np.ndarray:
    """Two-basin 2-D samples in [-1, 1]^2, the range of post-normalized CVs."""
    rng = np.random.default_rng(seed)
    centers = np.array([[-0.5, 0.3], [0.4, -0.2]])
    x = centers[rng.integers(0, 2, n)] + rng.normal(0, 0.2, (n, 2))
    return np.clip(x, -1, 1).astype(np.float32)


# ---------------------------------------------------------------------------
# Measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    """First line of nvidia-smi's answer to --query-gpu=`query`."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bound_ms(n_bytes: float, flops: float, sfu_ops: float, sfu_rate: float):
    """Least time for the work on this card, and what sets it."""
    times = {
        "bytes": n_bytes / HBM_BYTES_PER_S,
        "operations": max(flops / FP32_FLOPS, sfu_ops / sfu_rate),
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def check_kernels(coords: np.ndarray, pairs_np: np.ndarray, sfu_rate: float):
    """Phase 2: each kernel against its plain version at the main path's
    shapes, with timings. Returns the per-kernel records."""
    import torch

    from deep_cartograph_torch.geom.engine import auto_chunk_size
    from deep_cartograph_torch.ops import kde as k2
    from deep_cartograph_torch.ops import pair_distances as k1

    dev = torch.device("cuda")
    records = {}

    # K1 on one featurize chunk.
    chunk = auto_chunk_size(CHUNK, N_ATOMS, len(make_labels(N_ATOMS)))
    points = torch.tensor(coords[:chunk], device=dev)
    pairs = torch.tensor(pairs_np, device=dev)
    got = k1.pair_distances(points, pairs)
    torch.cuda.synchronize()
    want = k1.pair_distances_plain(points, pairs)
    err = float((got - want).abs().max())
    check(err <= K1_TOL, f"K1 agrees with its plain version (max err {err})")
    out = torch.empty_like(got)
    a, b = pairs[:, 0].long(), pairs[:, 1].long()
    C, N, P = points.shape[0], points.shape[1], pairs.shape[0]
    k1_bound, k1_by = bound_ms(
        n_bytes=C * N * 12 + P * 8 + C * P * 4, flops=10.0 * C * P,
        sfu_ops=0.0, sfu_rate=sfu_rate,
    )
    records["K1"] = {
        "name": "pair_distances_kernel",
        "route": "cuda",
        "source": "deep_cartograph_torch/ops/csrc/pair_distances.cu",
        "replaces": "deep_cartograph_tpu/ops/pallas_kernels.py:220",
        "tpu_function": "selector_pair_distances",
        "shape": {"C": C, "N": N, "P": P},
        "max_abs_err": err,
        "tolerance": f"abs {K1_TOL} nm",
        "ms": cuda_ms(lambda: k1.launch(points, pairs, out), 50),
        "plain_ms": cuda_ms(lambda: k1.pair_distances_plain(points, pairs), 10),
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": cuda_ms(
            lambda: torch.cdist(points, points)[:, a, b] * 0.1, 10
        ),
        "library_call": "torch.cdist over the chunk's atoms, pairs gathered",
    }

    # K2 on the 2-D FES shape: 150 x 150 grid, 100,000 samples.
    samples = torch.tensor(cv_like_samples(N_FRAMES, SEED + 1), device=dev)
    axis = torch.linspace(-1, 1, NUM_BINS, device=dev)
    gx, gy = torch.meshgrid(axis, axis, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], 1).contiguous()
    inv_two_bw2 = 1.0 / (2.0 * BANDWIDTH * BANDWIDTH)
    got = k2.kde_logsumexp(grid, samples, inv_two_bw2)
    torch.cuda.synchronize()
    scale = float(torch.sqrt(torch.tensor(inv_two_bw2, dtype=torch.float32)))
    grid_s, samples_s = grid * scale, samples * scale
    want = k2.kde_logsumexp_plain(grid_s, samples_s)
    diff = (got - want).abs()
    err = float(diff.max())
    check(bool((diff <= K2_ATOL + K2_RTOL * want.abs()).all()),
          f"K2 agrees with its plain version (max err {err})")
    out = torch.empty_like(got)
    G, D, Ns = grid.shape[0], grid.shape[1], samples.shape[0]

    def library_k2():
        return torch.cat([
            torch.logsumexp(-torch.cdist(g, samples_s) ** 2, dim=1)
            for g in torch.split(grid_s, 2048)
        ])

    k2_bound, k2_by = bound_ms(
        n_bytes=(G * D + Ns * D + G) * 4, flops=(3.0 * D + 1) * G * Ns,
        sfu_ops=float(G) * Ns, sfu_rate=sfu_rate,
    )
    records["K2"] = {
        "name": "kde_logsumexp_kernel",
        "route": "cuda",
        "source": "deep_cartograph_torch/ops/csrc/kde_logsumexp.cu",
        "replaces": "deep_cartograph_tpu/ops/pallas_kernels.py:137",
        "tpu_function": "kde_logsumexp",
        "shape": {"G": G, "D": D, "N": Ns},
        "max_abs_err": err,
        "tolerance": f"abs {K2_ATOL} + {K2_RTOL} x |plain|",
        "ms": cuda_ms(lambda: k2.launch(grid_s, samples_s, out), 10),
        "plain_ms": cuda_ms(lambda: k2.kde_logsumexp_plain(grid_s, samples_s), 3),
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": cuda_ms(library_k2, 3),
        "library_call": "torch.logsumexp over -torch.cdist(grid, samples)**2, "
                        "2048 grid rows at a time",
    }
    return records


def numpy_features(coords: np.ndarray, labels) -> np.ndarray:
    """Independent float64 reference for the make_labels features."""
    c = coords.astype(np.float64)
    cols = []
    for label in labels:
        kind, *ents = label.split("-")
        idx = [int(e.rsplit("_", 1)[1]) - 1 for e in ents]
        if kind == "dist":
            cols.append(np.linalg.norm(c[:, idx[0]] - c[:, idx[1]], axis=-1) * 0.1)
            continue
        p0, p1, p2, p3 = (c[:, i] for i in idx)
        b0, b1, b2 = p0 - p1, p2 - p1, p3 - p2
        b1n = b1 / np.linalg.norm(b1, axis=-1, keepdims=True)
        v = b0 - np.sum(b0 * b1n, -1, keepdims=True) * b1n
        w = b2 - np.sum(b2 * b1n, -1, keepdims=True) * b1n
        ang = np.arctan2(np.sum(np.cross(b1n, v) * w, -1), np.sum(v * w, -1))
        cols.append(np.sin(ang) if kind == "sin" else np.cos(ang))
    return np.stack(cols, 1)


def numpy_fes_1d(x: np.ndarray, axis: np.ndarray, kt: float) -> np.ndarray:
    logk = -((axis[:, None].astype(np.float64) - x[None, :]) ** 2) / (
        2.0 * BANDWIDTH**2
    )
    m = logk.max(1, keepdims=True)
    fes = -kt * (m[:, 0] + np.log(np.exp(logk - m).sum(1)))
    return fes - fes.min()


def seeded_net(n_features: int, norm_mean, norm_range, gen):
    """(n_features, 64, 64, 2) tanh deep-TICA net with weights drawn from
    `gen` (uniform +-1/sqrt(fan_in), torch.nn.Linear's default scale)."""
    import torch

    from deep_cartograph_torch.models.networks import DeepTICANet

    net = DeepTICANet(
        (n_features, 64, 64, 2),
        {"activation": ["tanh", "tanh", None]},
        norm_mean=norm_mean,
        norm_range=norm_range,
    )
    with torch.no_grad():
        for layer in net.nn.dense:
            bound = 1.0 / math.sqrt(layer.in_features)
            for p in (layer.weight, layer.bias):
                p.copy_(torch.rand(p.shape, generator=gen) * 2 * bound - bound)
    return net


def main_path(coords: np.ndarray, tmp: str, stats) -> dict:
    """Phase 3: the serving path, driven through the port's entry points."""
    import torch

    from deep_cartograph_torch.deploy import DeepTICAProjection, FramesToCV
    from deep_cartograph_torch.fes.kde import KB_KJ_MOL, compute_fes
    from deep_cartograph_torch.geom.engine import Featurizer
    from deep_cartograph_torch.io.dcd import read_dcd, write_dcd
    from deep_cartograph_torch.io.topology import Topology
    from deep_cartograph_torch.io.traj import iter_frame_chunks

    pdb_path = os.path.join(tmp, "ca.pdb")
    dcd_path = os.path.join(tmp, "traj.dcd")
    write_ca_pdb(pdb_path, coords[0])
    write_dcd(dcd_path, coords)
    labels = make_labels(N_ATOMS)
    top = Topology.from_pdb(pdb_path)
    featurizer = Featurizer(top, labels)
    gen = torch.Generator().manual_seed(SEED)
    result = {}

    # Host decode alone, for the breakdown of the featurize time.
    t0 = time.perf_counter()
    for _ in iter_frame_chunks(dcd_path, CHUNK):
        pass
    result["decode_s"] = time.perf_counter() - t0

    for s in stats:
        s.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    features = featurizer.featurize_trajectory(dcd_path, frame_chunk=CHUNK)
    result["featurize_s"] = time.perf_counter() - t0

    feats_d = torch.tensor(features, device="cuda")
    net = seeded_net(
        features.shape[1], feats_d.mean(0), feats_d.std(0).clamp_min(1e-6), gen
    )
    theta = float(torch.rand((), generator=gen)) * math.pi
    evecs = torch.tensor([[math.cos(theta), -math.sin(theta)],
                          [math.sin(theta), math.cos(theta)]])
    with torch.no_grad():
        latent = net.to("cuda")(feats_d) @ evecs.to("cuda")
    lmin, lmax = latent.amin(0), latent.amax(0)
    projection = DeepTICAProjection(
        net, evecs, ((lmax + lmin) / 2).cpu(), ((lmax - lmin) / 2).cpu()
    )
    pipeline = FramesToCV(projection, top, labels)
    frames = read_dcd(dcd_path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cv = pipeline(frames)
    result["project_s"] = time.perf_counter() - t0
    with torch.no_grad():
        cv_from_features = projection(feats_d).cpu().numpy()

    kt = KB_KJ_MOL * 300.0
    fes_1d = []
    t0 = time.perf_counter()
    for k in range(2):
        fes_1d.append(compute_fes(cv[:, k], bandwidth=BANDWIDTH,
                                  num_bins=NUM_BINS, num_blocks=100))
    result["fes_1d_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    axes_2d, fes_2d, err_2d = compute_fes(
        cv, bandwidth=BANDWIDTH, num_bins=NUM_BINS, num_blocks=1
    )
    result["fes_2d_s"] = time.perf_counter() - t0
    result["launches"] = {s.name: s.launches for s in stats}

    # Checks.
    check(features.shape == (N_FRAMES, len(labels)) == (N_FRAMES, 1171),
          f"feature matrix shape {features.shape}")
    check(bool(np.isfinite(features).all()), "features are finite")
    ref = numpy_features(coords[:256], labels)
    result["features_err_vs_numpy"] = float(np.abs(features[:256] - ref).max())
    check(result["features_err_vs_numpy"] <= 1e-4, "features match numpy")
    check(cv.shape == (N_FRAMES, 2) and bool(np.isfinite(cv).all()),
          f"CV values finite, shape {cv.shape}")
    result["cv_err_vs_features_path"] = float(np.abs(cv - cv_from_features).max())
    check(result["cv_err_vs_features_path"] <= 1e-4,
          "FramesToCV matches the projection of featurize_trajectory's output")
    for k, (axes, fes, err) in enumerate(fes_1d):
        check(fes.shape == err.shape == (NUM_BINS,), f"1-D FES {k} shape")
        check(bool(np.isfinite(fes).all()) and fes.min() == 0.0,
              f"1-D FES {k} finite with min 0")
        ref = numpy_fes_1d(cv[:, k].astype(np.float64), axes[0], kt)
        result[f"fes_1d_{k}_err_vs_numpy"] = float(np.abs(fes - ref).max())
        check(result[f"fes_1d_{k}_err_vs_numpy"] <= FES_TOL,
              f"1-D FES {k} matches numpy within {FES_TOL} kJ/mol")
    check(fes_2d.shape == (NUM_BINS, NUM_BINS) and err_2d is None, "2-D FES shape")
    check(bool(np.isfinite(fes_2d).all()) and fes_2d.min() == 0.0,
          "2-D FES finite with min 0")
    for s in stats:
        check(s.launches > 0, f"{s.name} was launched on the main path")
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from deep_cartograph_torch.ops import build
    from deep_cartograph_torch.ops import kde as k2
    from deep_cartograph_torch.ops import pair_distances as k1
    from deep_cartograph_torch.features.grammar import compile_plan
    from deep_cartograph_torch.io.topology import Topology

    # Phase 1: device and build.
    print(nvidia_smi("name,power.limit"), flush=True)
    sm_clock_hz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_rate = SFU_OPS_PER_CLOCK_PER_SM * num_sms * sm_clock_hz
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{num_sms} SMs at {sm_clock_hz / 1e6:.0f} MHz max")
    t0 = time.perf_counter()
    build.build_all()
    log(f"built {len(build.SOURCES)} kernels in {time.perf_counter() - t0:.1f} s")

    coords = make_trajectory(N_FRAMES, N_ATOMS)
    with tempfile.TemporaryDirectory() as tmp:
        pdb_path = os.path.join(tmp, "ca.pdb")
        write_ca_pdb(pdb_path, coords[0])
        plan = compile_plan(make_labels(N_ATOMS), Topology.from_pdb(pdb_path))
    pairs = plan.dist_pairs.astype(np.int32)

    # Phase 2: kernels against their plain versions.
    records = check_kernels(coords, pairs, sfu_rate)
    for name, rec in records.items():
        log(f"{name} {rec['name']}: err {rec['max_abs_err']:.3g}, "
            f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
            f"library {rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} "
            f"by {rec['bound_by']})")

    # Phase 3: the main path.
    with tempfile.TemporaryDirectory() as tmp:
        result = main_path(coords, tmp, [k1.STATS, k2.STATS])
    log(f"featurize {N_FRAMES / result['featurize_s']:.0f} frames/s "
        f"({result['featurize_s']:.3f} s, host decode alone "
        f"{result['decode_s']:.3f} s), projection "
        f"{result['project_s'] * 1e3:.1f} ms, FES 1-D x2 "
        f"{result['fes_1d_s'] * 1e3:.1f} ms, FES 2-D {result['fes_2d_s'] * 1e3:.1f} ms")
    log(json.dumps(result))

    kernels = []
    for key in ("K1", "K2"):
        rec = dict(records[key])
        rec["launches"] = result["launches"][rec["name"]]
        rec["kernel_ms"] = rec["ms"]
        kernels.append(rec)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
