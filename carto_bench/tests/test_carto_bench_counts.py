"""Byte and operation counts against hand counts at tiny shapes."""

from carto_bench import counts


def test_k1_bytes_and_flops():
    # 2 frames of 3 CA atoms (36 B each) and 1 pair (4 B each)
    assert counts.k1_bytes(2, 3, 1) == 2 * (36 + 4)
    assert counts.k1_flops(2, 1) == 2 * 10


def test_feature_flops():
    # one distance (10) and one dihedral (62) with its sin and cos (2)
    assert counts.feature_flops(1, 1, 1) == 74
    assert counts.feature_flops(3, 2, 0) == 60


def test_mlp_and_serve_flops():
    # [2, 3, 1]: 2*2*3 + 2*3 = 18, then 2*3*1 + 2*1 = 8
    assert counts.mlp_forward_flops(1, [2, 3, 1]) == 26
    # dropout on the first layer adds 2 * 3
    assert counts.mlp_forward_flops(2, [2, 3, 1], dropout_layers=1) == 2 * 32
    # features 74, normalization 2 * 2, network 26, TICA 2 * 1 + post 2
    assert counts.serve_flops(1, 1, 1, [2, 3, 1]) == 74 + 4 + 26 + 4


def test_train_step_flops():
    # batch 1, one try, [2, 3, 1], dropout on the first layer:
    # per half: normalization 4 + forward 32 + backward 2 * (12 + 6) - 12 = 24
    # -> 2 * 60; covariances 3 * 2 * 1; Adam 12 * (6 + 3 + 3 + 1) = 156
    assert counts.train_step_flops(1, 1, [2, 3, 1], 1) == 120 + 6 + 156
    assert counts.train_step_flops(1, 4, [2, 3, 1], 1) == 4 * 282


def test_peaks_table():
    h100 = counts.peaks("NVIDIA H100 80GB HBM3")
    assert h100["hbm_bytes_per_s"] == 3.35e12 and h100["fp32_flops_per_s"] == 67e12
    assert counts.peaks("a card the table lacks") is None
