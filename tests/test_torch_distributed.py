"""The port's multi-process seam on the CPU: two processes joined by gloo
(torch.distributed), each with a mesh that lists the CPU twice, so four
shards in all (the shape of tests/test_distributed_smoke.py).

The children import no JAX; the parent compares what they write with the
port in one process and with the JAX package's `make_dp_train_step` on its
8-device virtual mesh, from the same parameters and batch. Tolerances:
collectives and halo pairs exact; covariances and one training step 1e-5
(float32 sums in another order); SGD's step against the full batch's
gradient rel 1e-4.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch

N_FRAMES, N_FEATURES, LAG = 64, 5, 3
BATCH, IN = 64, 4
LR = 0.05
CHILD_SECONDS = 120


def _frames():
    return np.random.default_rng(0).standard_normal((N_FRAMES, N_FEATURES)).astype(np.float32)


def _batch():
    rng = np.random.default_rng(1)
    data = rng.standard_normal((BATCH, IN)).astype(np.float32)
    weight = np.ones(BATCH, np.float32)
    weight[-5:] = 0.0  # a ragged tail at weight 0, all on the last shard
    return {"data": data, "data_lag": data, "weight": weight}


def _params():
    return {"w": np.random.default_rng(2).standard_normal((IN, 1)).astype(np.float32)}


def _loss(params, batch):
    pred = batch["data"] @ params["w"]
    err = torch.mean((pred - batch["data"].sum(1, keepdim=True)) ** 2, dim=1)
    w = batch["weight"]
    return torch.sum(err * w) / torch.clamp_min(torch.sum(w), 1e-9)


OPTIMIZERS = ("SGD", "Adam")


def _dp_step(mesh, batch, name):
    from deep_cartograph_torch.models.training import Optimizer
    from deep_cartograph_torch.parallel.training import make_dp_train_step

    optimizer = Optimizer(name, {"lr": LR})
    params = {k: torch.as_tensor(v) for k, v in _params().items()}
    state = optimizer.init(params)
    step = make_dp_train_step(_loss, optimizer, mesh, LR)
    params, state, loss = step(params, state, batch)
    return params["w"].numpy(), float(loss)


def _child(rank, port, out_dir):
    """One process of two: the collectives, the halo, the covariances and a
    training step on its half of the data, written to rank<k>.npz."""
    import torch.distributed as dist

    from deep_cartograph_torch.parallel.mesh import Mesh, init_distributed, local_shard
    from deep_cartograph_torch.parallel import sharding

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu")
    try:
        out = {"world": dist.get_world_size(), "rank": dist.get_rank(),
               "backend": dist.get_backend()}
        mesh = Mesh(("cpu", "cpu"), group=dist.group.WORLD)
        out["local_shard"] = np.array(local_shard(list("abcde")))
        mine = [torch.tensor([2.0 * rank + i]) for i in range(2)]
        out["psum"] = sharding.psum(mine, mesh).numpy()
        out["pmax"] = sharding.pmax(mine, mesh).numpy()
        out["pmin"] = sharding.pmin(mine, mesh).numpy()
        out["all_gather"] = sharding.all_gather(
            [torch.arange(float(rank + i + 1)) for i in range(2)], mesh).numpy()
        out["ppermute"] = torch.cat(sharding.ppermute(mine, mesh)).numpy()

        half = slice(rank * N_FRAMES // 2, (rank + 1) * N_FRAMES // 2)
        x_t, x_lag, valid = sharding.lag_pairs_with_halo(_frames()[half], LAG, mesh)
        out["halo_x_t"], out["halo_x_lag"], out["halo_valid"] = (
            torch.cat(v).numpy() for v in (x_t, x_lag, valid))

        frames = _frames()
        pairs = slice(rank * (N_FRAMES - LAG) // 2, (rank + 1) * (N_FRAMES - LAG) // 2)
        c0, ctau = sharding.sharded_covariances(frames[:-LAG][pairs], frames[LAG:][pairs],
                                                mesh)
        out["c0"], out["ctau"] = c0.numpy(), ctau.numpy()

        batch = {k: v[rank * BATCH // 2: (rank + 1) * BATCH // 2] for k, v in _batch().items()}
        for name in OPTIMIZERS:
            out[f"dp_w_{name}"], out[f"dp_loss_{name}"] = _dp_step(mesh, batch, name)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the two gloo processes wrote."""
    import torch.multiprocessing as mp

    out = tmp_path_factory.mktemp("distributed")
    ctx = mp.start_processes(_child, args=(_free_port(), str(out)), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + CHILD_SECONDS
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the two processes did not end within {CHILD_SECONDS} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def test_init_distributed_sets_up_the_group(ranks):
    for r, got in enumerate(ranks):
        assert int(got["world"]) == 2 and int(got["rank"]) == r
        assert str(got["backend"]) == "gloo"


def test_local_shard_takes_every_second_item(ranks):
    items = list("abcde")
    for r, got in enumerate(ranks):
        assert got["local_shard"].tolist() == items[r::2]


def test_collectives_span_both_processes(ranks):
    for r, got in enumerate(ranks):
        assert got["psum"].tolist() == [6.0]
        assert got["pmax"].tolist() == [3.0]
        assert got["pmin"].tolist() == [0.0]
        assert got["all_gather"].tolist() == [0, 0, 1, 0, 1, 0, 1, 2]
    # the ring: entry g receives entry g + 1 of the 4 (0 1 | 2 3)
    assert ranks[0]["ppermute"].tolist() == [1.0, 2.0]
    assert ranks[1]["ppermute"].tolist() == [3.0, 0.0]


def test_halo_pairs_cross_the_process_seam(ranks):
    x = _frames()
    x_t = np.concatenate([g["halo_x_t"] for g in ranks])
    x_lag = np.concatenate([g["halo_x_lag"] for g in ranks])
    valid = np.concatenate([g["halo_valid"] for g in ranks]).astype(bool)
    assert valid.sum() == N_FRAMES - LAG and not valid[-LAG:].any()
    np.testing.assert_array_equal(x_t[valid], x[:-LAG])
    np.testing.assert_array_equal(x_lag[valid], x[LAG:])


def test_sharded_covariances_over_four_shards_equal_one_process(ranks):
    from deep_cartograph_torch.cv.tica_math import timelagged_covariances
    from deep_cartograph_torch.parallel.mesh import Mesh
    from deep_cartograph_torch.parallel.sharding import sharded_covariances

    x = _frames()
    c0, ctau, _ = timelagged_covariances(torch.as_tensor(x[:-LAG]), torch.as_tensor(x[LAG:]))
    one0, one_tau = sharded_covariances(x[:-LAG], x[LAG:], Mesh(("cpu",)))
    for got in ranks:
        for want in (c0, one0):
            np.testing.assert_allclose(got["c0"], want.numpy(), atol=1e-5)
        for want in (ctau, one_tau):
            np.testing.assert_allclose(got["ctau"], want.numpy(), atol=1e-5)


def _full_batch_gradient():
    params = {k: torch.as_tensor(v).requires_grad_(True) for k, v in _params().items()}
    loss = _loss(params, {k: torch.as_tensor(v) for k, v in _batch().items()})
    return torch.autograd.grad(loss, [params["w"]])[0].numpy()


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_dp_train_step_equals_the_full_batch_step_and_jax(ranks, name):
    """One step of each optimizer. SGD's update is -LR times the summed
    gradient, so it shows the gradient's size (Adam's first update is
    about LR times its sign): held to the full batch's autograd gradient,
    rel 1e-4."""
    import jax
    import jax.numpy as jnp
    import optax

    from deep_cartograph_torch.parallel.mesh import Mesh
    from deep_cartograph_tpu.parallel.mesh import get_mesh
    from deep_cartograph_tpu.parallel.training import make_dp_train_step

    full = {k: torch.as_tensor(v) for k, v in _batch().items()}
    w0 = _params()["w"]
    want_w, want_loss = _dp_step(Mesh(("cpu",)), full, name)
    for got in ranks:
        np.testing.assert_allclose(got[f"dp_w_{name}"], want_w, atol=1e-5)
        np.testing.assert_allclose(float(got[f"dp_loss_{name}"]), want_loss, rtol=1e-5)
    # the port's step on its own 1-process mesh of four entries
    four_w, _ = _dp_step(Mesh(("cpu",) * 4), full, name)
    np.testing.assert_allclose(four_w, want_w, atol=1e-5)
    if name == "SGD":
        grad = _full_batch_gradient()
        for w in [four_w, want_w] + [got["dp_w_SGD"] for got in ranks]:
            np.testing.assert_allclose((w0 - w) / LR, grad, rtol=1e-4,
                                       atol=1e-4 * np.abs(grad).max())

    def jax_loss(params, batch, rng):
        pred = batch["data"] @ params["w"]
        err = jnp.mean((pred - jnp.sum(batch["data"], axis=1, keepdims=True)) ** 2, axis=1)
        w = batch["weight"]
        return jnp.sum(err * w) / jnp.maximum(jnp.sum(w), 1e-9)

    optimizer = {"SGD": optax.sgd, "Adam": optax.adam}[name](LR)
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    step = make_dp_train_step(jax_loss, optimizer, get_mesh())
    assert len(jax.devices()) == 8
    new, _, loss = step(params, optimizer.init(params),
                        {k: jnp.asarray(v) for k, v in _batch().items()},
                        jax.random.PRNGKey(0))
    np.testing.assert_allclose(want_w, np.asarray(new["w"]), atol=1e-5)
    np.testing.assert_allclose(want_loss, float(loss), rtol=1e-5)
