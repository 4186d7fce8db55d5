"""Operations and bytes of a UMAP fit (`jobs/train_umap.py`), from the
work's shapes, not from how the program tiles it: n points of d features,
k neighbours, c components, E edges, N negative samples an edge. Counted as
`counts.py` counts, a power or a division one operation; a comparison, a
clip or a select none."""

from __future__ import annotations

ATTRACT_COEF_FLOPS = 6   # d2^(b-1), d2^b, a d2^b, 1 +, -2ab x, the division
REPULSE_COEF_FLOPS = 6   # 0.001 + d2, d2^b, a d2^b, 1 +, the product, 2b / x
INDEX_BYTES = 4          # a point's index: n < 2^31 fits 32 bits
VALUE_BYTES = 4          # float32


def knn_flops(n_queries: int, n: int, d: int) -> int:
    """The d2 expansion's products q.x of every (query, data row) pair:
    2 d each. The norms (2 d a row) and the ranking are left out."""
    return 2 * n_queries * n * d


def knn_bytes(n: int, d: int, k: int) -> int:
    """The least traffic of the kNN of every row among the others: the
    float32 data read once, each row's k distances and indices written
    once."""
    return n * d * VALUE_BYTES + n * k * (VALUE_BYTES + INDEX_BYTES)


def knn_roofline_s(n: int, d: int, k: int, peaks: dict) -> float:
    """The kNN's least time on the card: its operations at the float32
    peak or its bytes at the memory's, whichever is longer."""
    return max(knn_flops(n, n, d) / peaks["fp32_flops_per_s"],
               knn_bytes(n, d, k) / peaks["hbm_bytes_per_s"])


def pca_flops(n: int, d: int) -> int:
    """The PCA start's covariance xc^T xc: 2 n d^2 (the eigh and the
    projection left out)."""
    return 2 * n * d * d


def layout_epoch_flops(n_edges: int, c: int, negative_samples: int) -> int:
    """One layout epoch. An edge's attraction: the difference (c), its
    squared length (2c), the coefficient (6), the gradient (c), its scale by
    the rate (c) and the two updates (2c): 7c + 6. Each negative sample's
    repulsion: the difference (c), squared length (2c), coefficient (6),
    gradient (c) and its share of the head's sum and update (c): 5c + 6."""
    return n_edges * (7 * c + ATTRACT_COEF_FLOPS
                      + negative_samples * (5 * c + REPULSE_COEF_FLOPS))


def layout_epoch_bytes(n: int, n_edges: int, c: int) -> int:
    """An epoch's least traffic: the graph read once (head and tail
    indices, a float32 weight an edge) and the float32 embedding read and
    written once; the draws are made where they are used and the embedding
    (n c floats) stays in cache."""
    return n_edges * (2 * INDEX_BYTES + VALUE_BYTES) + 2 * n * c * VALUE_BYTES


def fit_flops(n: int, d: int, c: int, n_edges: int, epochs: int,
              negative_samples: int) -> int:
    """A fit's float32 operations: the kNN, the PCA start's covariance and
    the layout's epochs."""
    return (knn_flops(n, n, d) + pca_flops(n, d)
            + epochs * layout_epoch_flops(n_edges, c, negative_samples))
