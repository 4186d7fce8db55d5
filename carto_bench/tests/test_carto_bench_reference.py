"""The float64 reference against plain NumPy at tiny sizes."""

import numpy as np
import torch

from carto_bench import reference, synth
from carto_bench.harness import Cell

VILLIN = Cell.find("villin35.train").config


def numpy_features(c, pairs, quads):
    c = c.astype(np.float64)
    cols = [np.linalg.norm(c[:, i] - c[:, j], axis=-1) * 0.1 for i, j in pairs]
    for q in quads:
        p0, p1, p2, p3 = (c[:, k] for k in q)
        b0, b1, b2 = p0 - p1, p2 - p1, p3 - p2
        b1n = b1 / np.linalg.norm(b1, axis=-1, keepdims=True)
        v = b0 - np.sum(b0 * b1n, -1, keepdims=True) * b1n
        w = b2 - np.sum(b2 * b1n, -1, keepdims=True) * b1n
        ang = np.arctan2(np.sum(np.cross(b1n, v) * w, -1), np.sum(v * w, -1))
        cols += [np.sin(ang), np.cos(ang)]
    return np.stack(cols, 1)


def test_features_match_numpy():
    mol = synth.Molecule.from_config(VILLIN)
    coords = synth.trajectory(VILLIN, 20, 3, "cpu")
    got = reference.features(coords, mol.ca_index, mol.pairs, mol.quads).numpy()
    want = numpy_features(coords.numpy()[:, mol.ca_index], mol.pairs, mol.quads)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def numpy_loss(qt, ql, reg):
    mu = qt.mean(0)
    a, b = qt - mu, ql - mu
    c0 = a.T @ a / len(a)
    ct = 0.5 * (a.T @ b + b.T @ a) / len(a)
    li = np.linalg.inv(np.linalg.cholesky(c0 + reg * np.eye(len(c0))))
    return -np.linalg.eigvalsh(li @ ct @ li.T).sum()


def test_loss_and_network_match_numpy():
    rng = np.random.default_rng(0)
    params = {"nn/dense_0/kernel": rng.normal(size=(6, 4)), "nn/dense_0/bias": rng.normal(size=4),
              "nn/dense_1/kernel": rng.normal(size=(4, 2)), "nn/dense_1/bias": rng.normal(size=2)}
    x = rng.normal(size=(30, 6))
    options = reference.layer_options({"activation": ["leaky_relu"], "dropout": [None]}, 2)
    assert options == {"activation": ["leaky_relu", None], "dropout": [None, None]}
    h = x @ params["nn/dense_0/kernel"] + params["nn/dense_0/bias"]
    h = np.where(h >= 0, h, 0.01 * h)
    want = h @ params["nn/dense_1/kernel"] + params["nn/dense_1/bias"]
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    got = reference.mlp(tp, torch.as_tensor(x), options).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    q = rng.normal(size=(2, 40, 2))
    loss = reference.deep_tica_loss(torch.as_tensor(q[0])[None], torch.as_tensor(q[1])[None], 1e-6)
    assert abs(float(loss[0]) - numpy_loss(q[0], q[1], 1e-6)) < 1e-12


def test_upstream_layer_rule_gives_the_last_layer_the_listed_activation():
    # the schema's default list has three entries for [15, 15]: three layers
    enc = {"activation": ["leaky_relu"] * 3, "dropout": [0.1, 0.1],
           "last_layer_activation": None, "last_layer_dropout": None}
    assert reference.layer_options(enc, 3) == {
        "activation": ["leaky_relu"] * 3, "dropout": [0.1, 0.1, None]}


def test_adam_first_step_and_gradient_match_numpy():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(50, 5)))
    layers = [5, 3, 2]
    options = {"activation": ["tanh", None], "dropout": [None, None]}
    params = reference.initial_params(layers, [7], torch.float64)
    batches = np.arange(40).reshape(1, 1, 40)
    out = reference.adam_steps(x[:-1], x[1:], torch.zeros(5), torch.ones(5), params, batches,
                               [[]], options, 1e-6, lr=1e-3)
    for k, g in out["first_grad"].items():
        step = 1e-3 * g.numpy() / (np.abs(g.numpy()) + 1e-8)
        np.testing.assert_allclose(out["params"][k].numpy(), params[k].numpy() - step,
                                   rtol=0, atol=1e-15)
    # the gradient by central differences of the loss on one kernel entry
    k, idx, h = "nn/dense_0/kernel", (0, 0, 1), 1e-6

    def loss_at(delta):
        p = {n: v.clone() for n, v in params.items()}
        p[k][idx] += delta
        xt, xl = x[:-1][torch.as_tensor(batches[0])], x[1:][torch.as_tensor(batches[0])]
        return float(reference.deep_tica_loss(reference.mlp(p, xt, options),
                                              reference.mlp(p, xl, options), 1e-6)[0])

    fd = (loss_at(h) - loss_at(-h)) / (2 * h)
    assert abs(fd - float(out["first_grad"][k][idx])) < 1e-6 * max(1.0, abs(fd))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 3.0], dtype=torch.float32)
    got = reference._tf32_round(x)
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -10, 3.0]
