"""Data-parallel training step over a device mesh: the port of the JAX
package's parallel/training.py.

The batch axis is sharded over the mesh; every device takes the gradient
of its shard's loss, scaled by its share of the batch weight, so that the
summed (`psum`, and across the process group) gradient is the full
batch's. The parameters and the optimizer state stay replicated: one copy
on the mesh's first device in each process, copied to the others for
each step, updated by the port's optimizer (`models/training.Optimizer`)
with the same summed gradient in every process.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from deep_cartograph_torch.models.training import Optimizer
from deep_cartograph_torch.parallel.mesh import Mesh, shard
from deep_cartograph_torch.parallel.sharding import _to, psum

Params = Dict[str, torch.Tensor]


def make_dp_train_step(loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor],
                       optimizer: Optimizer, mesh: Mesh, lr: float
                       ) -> Callable[[Params, Dict, Dict], Tuple[Params, Dict, torch.Tensor]]:
    """step(params, opt_state, batch) -> (params, opt_state, loss).

    loss_fn(params, batch) -> the weighted mean loss of a batch, a scalar;
    `batch` holds arrays whose leading axis is sharded, among them the
    per-row 'weight'. `params` live on the mesh's first device and are
    updated in place; `opt_state` is `optimizer.init(params)`. The loss
    returned is the full batch's."""
    lr_t = torch.tensor([lr], dtype=torch.float32, device=mesh.devices[0])

    def step(params: Params, opt_state: Dict, batch: Dict) -> Tuple[Params, Dict, torch.Tensor]:
        shards = {k: shard(v, mesh) for k, v in batch.items()}
        local_w = [w.float().sum() for w in shards["weight"]]
        total_w = torch.clamp_min(psum(local_w, mesh), 1e-12)
        names = list(params)
        grads, losses = [], []
        for i, dev in enumerate(mesh.devices):
            if shards["weight"][i].shape[0] == 0:
                continue
            p_i = {k: _to(params[k].detach(), dev).requires_grad_(True) for k in names}
            loss = loss_fn(p_i, {k: s[i] for k, s in shards.items()}) * (
                local_w[i] / _to(total_w, dev))
            grads.append(torch.autograd.grad(loss, [p_i[k] for k in names]))
            losses.append(loss.detach())
        summed = {k: psum([g[j] for g in grads], mesh) for j, k in enumerate(names)}
        optimizer.step(params, summed, opt_state, lr_t)
        return params, opt_state, psum(losses, mesh)

    return step
