"""Müller-Brown potential: a Langevin sampler on the device for validation
data.

The port of the JAX package's data/muller_brown.py. The reference ships a
Müller-Brown dataset (deep_cartograph/data/muller_brown); this module
generates it instead: the classic 2-D potential (Müller & Brown, Theor.
Chim. Acta 1979) sampled with overdamped Langevin dynamics, one step after
another on the device. Used by examples and by physics-grounded tests (a
good CV must separate the metastable basins).

The noise comes from a torch generator seeded with `seed`, drawn in one
block before the loop, so a trajectory matches the JAX package's only in
distribution; `noise` passes a given sequence in instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from deep_cartograph_torch.utils.device import DeviceLike, resolve_device

# Standard Müller-Brown parameters, one column per term
_A = (-200.0, -100.0, -170.0, 15.0)
_a = (-1.0, -1.0, -6.5, 0.7)
_b = (0.0, 0.0, 11.0, 0.6)
_c = (-10.0, -10.0, -6.5, 0.7)
_x0 = (1.0, 0.0, -0.5, -1.0)
_y0 = (0.0, 0.5, 1.5, 1.0)

# Approximate basin minima (for tests/labels)
MINIMA = np.asarray(
    [[-0.558, 1.442], [0.623, 0.028], [-0.050, 0.467]], dtype=np.float32
)


def _params(like: torch.Tensor):
    return [torch.tensor(p, dtype=like.dtype, device=like.device)
            for p in (_A, _a, _b, _c, _x0, _y0)]


def potential(xy) -> torch.Tensor:
    """V(x, y) for points of shape (..., 2)."""
    xy = torch.as_tensor(xy)
    A, a, b, c, x0, y0 = _params(xy)
    dx = xy[..., 0:1] - x0
    dy = xy[..., 1:2] - y0
    terms = A * torch.exp(a * dx ** 2 + b * dx * dy + c * dy ** 2)
    return torch.sum(terms, dim=-1)


def grad_potential(xy: torch.Tensor, params=None) -> torch.Tensor:
    """dV/d(x, y) for points of shape (..., 2), in closed form. `params`:
    the potential's parameters already on xy's device (`_params`)."""
    A, a, b, c, x0, y0 = _params(xy) if params is None else params
    dx = xy[..., 0:1] - x0
    dy = xy[..., 1:2] - y0
    e = A * torch.exp(a * dx ** 2 + b * dx * dy + c * dy ** 2)
    gx = torch.sum(e * (2.0 * a * dx + b * dy), dim=-1)
    gy = torch.sum(e * (b * dx + 2.0 * c * dy), dim=-1)
    return torch.stack([gx, gy], dim=-1)


def sample_trajectory(
    n_frames: int = 5000,
    stride: int = 10,
    dt: float = 1e-4,
    kt: float = 15.0,
    seed: int = 0,
    x_init: Tuple[float, float] = (-0.5, 1.4),
    device: DeviceLike = None,
    noise: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(n_frames, 2) overdamped Langevin trajectory on the Müller-Brown
    surface: x += -clip(grad V, -1e3, 1e3) dt + sqrt(2 kT dt) xi, keeping
    every `stride`-th step from the first. `noise`: the (n_frames * stride,
    2) sequence xi to use instead of the seeded draws."""
    dev = resolve_device(device)
    n_steps = n_frames * stride
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        xi = torch.randn((n_steps, 2), generator=gen, device=dev)
    else:
        xi = torch.as_tensor(np.asarray(noise, np.float32), device=dev)
        if xi.shape != (n_steps, 2):
            raise ValueError(f"noise of shape {tuple(xi.shape)}, expected ({n_steps}, 2)")
    noise_scale = float(np.sqrt(np.float32(2.0) * np.float32(kt) * np.float32(dt)))
    xi = xi * noise_scale
    dt32 = torch.tensor(dt, dtype=torch.float32, device=dev)
    x = torch.tensor(x_init, dtype=torch.float32, device=dev)
    path = torch.empty((n_frames, 2), dtype=torch.float32, device=dev)
    params = _params(x)
    # no host sync inside the loop: each step only queues work on the device
    for step in range(n_steps):
        g = torch.clamp(grad_potential(x, params), -1e3, 1e3)
        x = x - g * dt32 + xi[step]
        if step % stride == 0:
            path[step // stride] = x
    return path.cpu().numpy()


def basin_labels(xy: np.ndarray) -> np.ndarray:
    """Nearest-minimum label per sample (0: upper-left, 1: lower-right,
    2: middle)."""
    d2 = ((xy[:, None, :] - MINIMA[None, :, :]) ** 2).sum(-1)
    return d2.argmin(axis=1)


def as_ca_trajectory(xy: np.ndarray) -> np.ndarray:
    """Embed the 2-D samples as a fake 3-atom 'CA' system so the full
    pipeline (featurization from coordinates) can run on this data:
    atom0 at origin, atom1 encodes x on the x-axis, atom2 encodes y."""
    n = xy.shape[0]
    coords = np.zeros((n, 3, 3), np.float32)
    coords[:, 1, 0] = 10.0 + xy[:, 0]
    coords[:, 2, 1] = 10.0 + xy[:, 1]
    return coords
