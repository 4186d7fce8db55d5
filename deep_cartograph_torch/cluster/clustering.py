"""Clustering of projected CVs: k-means and validity scores on the device,
HDBSCAN with its core distances and Prim's tree on the device and its tree
steps on the host, hierarchical clustering with scipy on the host.

The port of the JAX package's cluster/clustering.py (itself the reference's
statistics.py:17-379): the same optimize_clustering recipe (scan the number
of clusters, keep the best normalized Calinski-Harabasz - Davies-Bouldin +
silhouette), the same dispatch and centroid marking. Where the JAX package
calls scikit-learn (HDBSCAN, agglomerative clustering), the port has its own
copy of the algorithm scikit-learn runs for that call, so it needs no
scikit-learn. Entry points take `device`: None means CUDA (raises without a
card), "cpu" runs on the host.
"""

from __future__ import annotations

import heapq
import logging
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deep_cartograph_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

MAX_LLOYD_ITERATIONS = 300
SHIFT_TOL = 1e-6
# Elements of one distance tile (2**26 float32 = 256 MB): the silhouette's
# row blocks and the nearest-neighbour search's query blocks.
TILE_ELEMENTS = 1 << 26


# ---------------------------------------------------------------------------
# k-means: k-means++ seeding, then Lloyd iterations, n_init restarts batched
# ---------------------------------------------------------------------------

def _squared_distances(data: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(R, n, k) squared distances of data (n, d) to each restart's centres
    (R, k, d), as differences (not the matmul expansion)."""
    return ((data[None, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)


def _kmeans_plus_plus(data: torch.Tensor, k: int, n_init: int,
                      generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding of n_init restarts at once: (n_init, k, d) centres.
    Each next centre is drawn with probability proportional to the squared
    distance to the nearest centre drawn so far."""
    n, d = data.shape
    first = torch.randint(0, n, (n_init,), generator=generator, device=data.device)
    centers = torch.empty((n_init, k, d), dtype=data.dtype, device=data.device)
    centers[:, 0] = data[first]
    nearest = torch.full((n_init, n), math.inf, dtype=data.dtype, device=data.device)
    for i in range(1, k):
        nearest = torch.minimum(
            nearest, ((data[None] - centers[:, i - 1, None, :]) ** 2).sum(-1))
        # With fewer distinct points than k every weight can be 0 (each point
        # sits on a centre); torch.multinomial refuses that, so such a
        # restart draws uniformly: every choice is then a repeated centre.
        weights = torch.where(nearest.sum(1, keepdim=True) > 0, nearest,
                              torch.ones_like(nearest))
        nxt = torch.multinomial(weights, 1, generator=generator)[:, 0]
        centers[:, i] = data[nxt]
    return centers


def _lloyd(data: torch.Tensor, centers: torch.Tensor,
           max_iter: int = MAX_LLOYD_ITERATIONS):
    """Lloyd iterations of R restarts (centres (R, k, d)), each stopping on
    its own once its largest centre shift is <= SHIFT_TOL or after max_iter
    iterations: a finished restart is frozen while the others go on. One
    host read per iteration, for all restarts together.

    Returns (centres (R, k, d), assignments (R, n), inertias (R,),
    iterations (R,))."""
    n_restarts, k, _ = centers.shape
    shift = torch.full((n_restarts,), math.inf, dtype=data.dtype, device=data.device)
    iters = torch.zeros(n_restarts, dtype=torch.int64, device=data.device)
    active = torch.ones(n_restarts, dtype=torch.bool, device=data.device)
    while bool(active.any()):
        assign = _squared_distances(data, centers).argmin(-1)
        one_hot = torch.nn.functional.one_hot(assign, k).to(data.dtype)  # (R, n, k)
        counts = one_hot.sum(1)                                          # (R, k)
        sums = one_hot.transpose(1, 2) @ data                            # (R, k, d)
        new = torch.where(counts[..., None] > 0,
                          sums / counts.clamp(min=1)[..., None], centers)
        new_shift = ((new - centers) ** 2).sum(-1).amax(-1)
        centers = torch.where(active[:, None, None], new, centers)
        shift = torch.where(active, new_shift, shift)
        iters = iters + active
        active = (shift > SHIFT_TOL) & (iters < max_iter)
    d2 = _squared_distances(data, centers)
    min_d2, assign = d2.min(-1)
    return centers, assign, min_d2.sum(-1), iters


def kmeans_clustering(
    feature_matrix: np.ndarray,
    num_clusters: int,
    n_init: int,
    initial_centroids: Optional[np.ndarray] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """k-means on the device: (labels (n,), centroids (k, d)).

    With initial_centroids, one Lloyd run from them; otherwise n_init
    k-means++ restarts from a generator seeded with `seed`, batched, keeping
    the lowest inertia (the first on ties)."""
    dev = resolve_device(device)
    data = torch.as_tensor(np.asarray(feature_matrix, np.float32), device=dev)
    if initial_centroids is not None:
        centers = torch.as_tensor(np.asarray(initial_centroids, np.float32), device=dev)
        centers, assign, _, _ = _lloyd(data, centers[None])
        return assign[0].cpu().numpy(), centers[0].cpu().numpy()
    generator = torch.Generator(device=dev).manual_seed(int(seed))
    seeds = _kmeans_plus_plus(data, int(num_clusters), int(n_init), generator)
    centers, assign, inertia, _ = _lloyd(data, seeds)
    best = int(inertia.argmin())
    return assign[best].cpu().numpy(), centers[best].cpu().numpy()


# ---------------------------------------------------------------------------
# Validity scores on the device
# ---------------------------------------------------------------------------

def _scores_device(data: torch.Tensor, labels: torch.Tensor, k: int, block: int):
    """(calinski_harabasz, davies_bouldin, silhouette) as 0-d tensors.

    The silhouette's pairwise distances are computed in row blocks of
    `block` samples, each (block, n) tile reduced straight into (block, k)
    per-cluster sums: peak memory O(block * n), never the (n, n) matrix."""
    n, _ = data.shape
    one_hot = torch.nn.functional.one_hot(labels, k).to(data.dtype)  # (n, k)
    counts = one_hot.sum(0)
    safe_counts = counts.clamp(min=1.0)
    centers = one_hot.T @ data / safe_counts[:, None]
    overall = data.mean(0)

    # Calinski-Harabasz
    between = (counts * ((centers - overall) ** 2).sum(-1)).sum()
    diff_to_center = data - centers[labels]
    within = (diff_to_center ** 2).sum()
    ch = (between / max(k - 1, 1)) / (within / max(n - k, 1)).clamp(min=1e-12)

    # Davies-Bouldin: s_i = mean Euclidean distance to the centroid
    dist_to_center = (diff_to_center ** 2).sum(-1).clamp(min=0.0).sqrt()
    s = (one_hot.T @ dist_to_center) / safe_counts
    center_d = ((centers[:, None, :] - centers[None, :, :]) ** 2).sum(-1).clamp(
        min=1e-18).sqrt()
    ratio = (s[:, None] + s[None, :]) / center_d
    eye = torch.eye(k, dtype=torch.bool, device=data.device)
    db = ratio.masked_fill(eye, -math.inf).amax(1).mean()

    # Silhouette: per-cluster distance sums accumulated block by block
    sq = (data ** 2).sum(1)
    sums = torch.empty((n, k), dtype=data.dtype, device=data.device)
    for start in range(0, n, block):
        rows, row_sq = data[start:start + block], sq[start:start + block]
        d2 = row_sq[:, None] - 2.0 * rows @ data.T + sq[None, :]
        sums[start:start + block] = d2.clamp(min=0.0).sqrt() @ one_hot
    own_count = counts[labels]
    a = sums.gather(1, labels[:, None])[:, 0] / (own_count - 1).clamp(min=1)
    mean_other = (sums / safe_counts[None, :]).masked_fill(one_hot.bool(), math.inf)
    b = mean_other.amin(1)
    sil = torch.where(own_count > 1,
                      (b - a) / torch.maximum(a, b).clamp(min=1e-12),
                      torch.zeros_like(a))
    return ch, db, sil.mean()


def clustering_scores(
    data: np.ndarray, labels: np.ndarray, device: DeviceLike = None
) -> Tuple[float, float, float]:
    """(Calinski-Harabasz, Davies-Bouldin, silhouette) of a labelling.

    Label -1 (HDBSCAN noise) counts as a cluster of its own, as
    scikit-learn's scores count it; all-noise input gives NaN scores."""
    dev = resolve_device(device)
    labels = np.asarray(labels)
    if labels.min() < 0:
        if labels.max() < 0:
            logger.warning(
                "clustering_scores: every point is noise (all labels -1); "
                "returning NaN scores"
            )
            return float("nan"), float("nan"), float("nan")
        labels = np.where(labels < 0, labels.max() + 1, labels)
    k = int(labels.max()) + 1
    n = int(np.asarray(data).shape[0])
    block = int(min(n, max(128, TILE_ELEMENTS // max(n, 1))))
    scores = _scores_device(
        torch.as_tensor(np.asarray(data, np.float32), device=dev),
        torch.as_tensor(labels.astype(np.int64), device=dev), k, block)
    ch, db, sil = torch.stack(scores).tolist()
    return ch, db, sil


# ---------------------------------------------------------------------------
# HDBSCAN: scikit-learn's algorithm for Euclidean data ("auto" -> the
# kd-tree route, _hdbscan_prims), in float64 as scikit-learn computes it
# ---------------------------------------------------------------------------

_NOISE = -1
_INFINITE_LABEL, _INFINITE_PROB = -2, 0.0    # rows holding an inf
_MISSING_LABEL, _MISSING_PROB = -3, np.nan   # rows holding a NaN


def _row_distances(queries: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(q, n) Euclidean distances, summed feature by feature in order and
    square-rooted, as scikit-learn's DistanceMetric does (float64)."""
    acc = (queries[:, None, 0] - data[None, :, 0]) ** 2
    for j in range(1, data.shape[1]):
        acc = acc + (queries[:, None, j] - data[None, :, j]) ** 2
    return acc.sqrt()


def _core_distances(data: torch.Tensor, min_samples: int) -> torch.Tensor:
    """Distance of each point to its min_samples-th nearest neighbour, the
    point itself included (k-NN blocked by query rows)."""
    n = data.shape[0]
    block = max(1, min(n, (TILE_ELEMENTS // 2) // max(n, 1)))
    core = torch.empty(n, dtype=data.dtype, device=data.device)
    for start in range(0, n, block):
        dist = _row_distances(data[start:start + block], data)
        core[start:start + block] = dist.topk(min_samples, dim=1, largest=False,
                                              sorted=False).values.amax(1)
    return core


def _prim_mst(data: torch.Tensor, core: torch.Tensor):
    """Prim's minimum spanning tree of the mutual-reachability graph
    (max(d_ij, core_i, core_j)), as scikit-learn's mst_from_data_matrix
    builds it: start at node 0, a node's best reach and its source change
    only on a strictly smaller reach, the next node is the first index
    holding the least reach. The next node stays on the device, so no step
    waits on the host.

    Returns numpy (sources, nodes, distances) of the n - 1 edges in the
    order they were added."""
    n = data.shape[0]
    dev = data.device
    in_tree = torch.zeros(n, dtype=torch.bool, device=dev)
    min_reach = torch.full((n,), math.inf, dtype=data.dtype, device=dev)
    sources = torch.ones(n, dtype=torch.int64, device=dev)
    current = torch.zeros(1, dtype=torch.int64, device=dev)
    order = torch.empty(n - 1, dtype=torch.int64, device=dev)
    for i in range(n - 1):
        in_tree.index_fill_(0, current, True)
        reach = torch.maximum(_row_distances(data.index_select(0, current), data)[0],
                              core)
        reach = torch.maximum(reach, core.index_select(0, current))
        better = (reach < min_reach) & ~in_tree
        min_reach = torch.where(better, reach, min_reach)
        sources = torch.where(better, current, sources)
        current = min_reach.masked_fill(in_tree, math.inf).argmin(0, keepdim=True)
        order[i:i + 1] = current
    # A node's reach and source never change once it is picked (it joins
    # the tree before the next update), so they are read at the end.
    nodes = order.cpu().numpy()
    return (sources.cpu().numpy()[nodes], nodes, min_reach.cpu().numpy()[nodes])


def _single_linkage(sources: np.ndarray, nodes: np.ndarray, distances: np.ndarray):
    """scikit-learn's _process_mst: sort the edges by distance (numpy's
    default sort kind) and label the merges with a union-find
    (make_single_linkage). Returns (left, right, value, size) arrays."""
    row_order = np.argsort(distances)
    a, b, dist = sources[row_order], nodes[row_order], distances[row_order]
    n = len(a) + 1
    parent = [-1] * (2 * n - 1)
    size = [1] * n + [0] * (n - 1)
    left = np.empty(n - 1, dtype=np.int64)
    right = np.empty(n - 1, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != -1:
            root = parent[root]
        while parent[x] != -1 and parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for i, (u, v) in enumerate(zip(a.tolist(), b.tolist())):
        cu, cv = find(u), find(v)
        left[i], right[i] = cu, cv
        parent[cu] = parent[cv] = n + i
        size[n + i] = size[cu] + size[cv]
    return left, right, dist.astype(np.float64), np.asarray(size[n:], dtype=np.int64)


def _bfs_from_hierarchy(left, right, root: int, n_samples: int) -> List[int]:
    result: List[int] = []
    queue = [root]
    while queue:
        result.extend(queue)
        queue = [x - n_samples for x in queue if x >= n_samples]
        if queue:
            queue = [c for node in queue for c in (left[node], right[node])]
    return result


def _condense_tree(left, right, value, size, min_cluster_size: int):
    """scikit-learn's _condense_tree: (parent, child, lambda, size) arrays."""
    n_samples = len(left) + 1
    root = 2 * (n_samples - 1)
    left_l, right_l, value_l, size_l = (left.tolist(), right.tolist(),
                                        value.tolist(), size.tolist())
    next_label = n_samples + 1
    node_list = _bfs_from_hierarchy(left_l, right_l, root, n_samples)
    relabel = [0] * (root + 1)
    relabel[root] = n_samples
    ignore = [False] * len(node_list)
    rows: List[tuple] = []

    def drop(node: int, sub_root: int, lambda_value: float) -> None:
        for sub_node in _bfs_from_hierarchy(left_l, right_l, sub_root, n_samples):
            if sub_node < n_samples:
                rows.append((relabel[node], sub_node, lambda_value, 1))
            ignore[sub_node] = True

    for node in node_list:
        if ignore[node] or node < n_samples:
            continue
        k = node - n_samples
        lft, rgt, distance = left_l[k], right_l[k], value_l[k]
        lambda_value = 1.0 / distance if distance > 0.0 else math.inf
        left_count = size_l[lft - n_samples] if lft >= n_samples else 1
        right_count = size_l[rgt - n_samples] if rgt >= n_samples else 1
        if left_count >= min_cluster_size and right_count >= min_cluster_size:
            relabel[lft] = next_label
            next_label += 1
            rows.append((relabel[node], relabel[lft], lambda_value, left_count))
            relabel[rgt] = next_label
            next_label += 1
            rows.append((relabel[node], relabel[rgt], lambda_value, right_count))
        elif left_count < min_cluster_size and right_count < min_cluster_size:
            drop(node, lft, lambda_value)
            drop(node, rgt, lambda_value)
        elif left_count < min_cluster_size:
            relabel[rgt] = relabel[node]
            drop(node, lft, lambda_value)
        else:
            relabel[lft] = relabel[node]
            drop(node, rgt, lambda_value)
    parent, child, lam, csize = (np.asarray(c) for c in zip(*rows))
    return (parent.astype(np.int64), child.astype(np.int64), lam.astype(np.float64),
            csize.astype(np.int64))


def _compute_stability(parent, child, lam, size) -> Dict[int, float]:
    smallest_cluster = int(parent.min())
    largest_child = max(int(child.max()), smallest_cluster)
    births = np.full(largest_child + 1, np.nan)
    births[child] = lam
    births[smallest_cluster] = 0.0
    # bincount adds in row order, as scikit-learn's loop does
    result = np.bincount(parent - smallest_cluster,
                         weights=(lam - births[parent]) * size,
                         minlength=int(parent.max()) - smallest_cluster + 1)
    return {idx + smallest_cluster: float(v) for idx, v in enumerate(result)}


def _bfs_from_cluster_tree(children_of: Dict[int, List[int]], root: int) -> List[int]:
    result: List[int] = []
    queue = [root]
    while queue:
        result.extend(queue)
        queue = [c for node in queue for c in children_of.get(node, ())]
    return result


def _cluster_tree_leaves(children_of: Dict[int, List[int]], root: int) -> List[int]:
    """Leaves of the cluster tree in depth-first order (recurse_leaf_dfs)."""
    leaves: List[int] = []
    stack = [root]
    while stack:
        node = stack.pop()
        children = children_of.get(node, [])
        if not children:
            leaves.append(node)
        stack.extend(reversed(children))
    return leaves


def _epsilon_search(leaves: set, children_of, parent_of, lambda_of, root: int,
                    epsilon: float) -> set:
    selected: List[int] = []
    processed: List[int] = []
    for leaf in leaves:
        eps = 1 / lambda_of[leaf]
        if eps < epsilon:
            if leaf not in processed:
                node = leaf
                # traverse_upwards without allow_single_cluster
                while True:
                    parent = parent_of[node]
                    if parent == root:
                        break
                    if 1 / lambda_of[parent] > epsilon:
                        node = parent
                        break
                    node = parent
                selected.append(node)
                for sub_node in _bfs_from_cluster_tree(children_of, node):
                    if sub_node != node:
                        processed.append(sub_node)
        else:
            selected.append(leaf)
    return set(selected)


def _get_clusters(parent, child, lam, size, stability: Dict[int, float],
                  method: str, epsilon: float, max_cluster_size: Optional[int]):
    """scikit-learn's _get_clusters with allow_single_cluster=False:
    (labels, probabilities)."""
    node_list = sorted(stability.keys(), reverse=True)[:-1]
    is_tree = size > 1
    t_parent, t_child, t_lam, t_size = parent[is_tree], child[is_tree], lam[is_tree], \
        size[is_tree]
    children_of: Dict[int, List[int]] = {}
    for p, c in zip(t_parent.tolist(), t_child.tolist()):
        children_of.setdefault(p, []).append(c)
    parent_of = dict(zip(t_child.tolist(), t_parent.tolist()))
    lambda_of = dict(zip(t_child.tolist(), t_lam.tolist()))
    cluster_sizes = dict(zip(t_child.tolist(), t_size.tolist()))
    is_cluster = {cluster: True for cluster in node_list}
    n_samples = int(child[size == 1].max()) + 1
    if max_cluster_size is None:
        max_cluster_size = n_samples + 1
    root = int(parent.min())

    if method == "eom":
        for node in node_list:
            subtree_stability = float(np.sum(
                [stability[c] for c in children_of.get(node, [])]))
            if subtree_stability > stability[node] or \
                    cluster_sizes[node] > max_cluster_size:
                is_cluster[node] = False
                stability[node] = subtree_stability
            else:
                for sub_node in _bfs_from_cluster_tree(children_of, node):
                    if sub_node != node:
                        is_cluster[sub_node] = False
        if epsilon != 0.0 and len(t_parent) > 0:
            eom_clusters = [c for c in is_cluster if is_cluster[c]]
            selected: set = set()
            if not (len(eom_clusters) == 1 and eom_clusters[0] == int(t_parent.min())):
                selected = _epsilon_search(set(eom_clusters), children_of, parent_of,
                                           lambda_of, int(t_parent.min()), epsilon)
            for c in is_cluster:
                is_cluster[c] = c in selected
    elif method == "leaf":
        leaves = set(_cluster_tree_leaves(children_of, int(t_parent.min()))) \
            if len(t_parent) else set()
        if epsilon != 0.0:
            selected = _epsilon_search(leaves, children_of, parent_of, lambda_of,
                                       int(t_parent.min()), epsilon)
        else:
            selected = leaves
        for c in is_cluster:
            is_cluster[c] = c in selected
    else:
        raise ValueError(f"cluster_selection_method {method!r}: expected eom or leaf")

    clusters = {c for c in is_cluster if is_cluster[c]}
    cluster_map = {c: i for i, c in enumerate(sorted(clusters))}
    labels = _do_labelling(parent, child, clusters, cluster_map, root)
    probs = _probabilities(parent, child, lam, labels,
                           {i: c for c, i in cluster_map.items()}, root)
    return labels, probs


def _do_labelling(parent, child, clusters: set, cluster_map: Dict[int, int],
                  root: int) -> np.ndarray:
    """scikit-learn's _do_labelling (its union-find by rank, iterative find)."""
    size = int(parent.max()) + 1
    up = list(range(size))
    rank = [0] * size

    def find(x: int) -> int:
        r = x
        while up[r] != r:
            r = up[r]
        while up[x] != r:
            up[x], x = r, up[x]
        return r

    for p, c in zip(parent.tolist(), child.tolist()):
        if c not in clusters:
            xr, yr = find(p), find(c)
            if rank[xr] < rank[yr]:
                up[xr] = yr
            elif rank[xr] > rank[yr]:
                up[yr] = xr
            else:
                up[yr] = xr
                rank[xr] += 1
    labels = np.empty(root, dtype=np.int64)
    for n in range(root):
        cluster = find(n)
        labels[n] = _NOISE if cluster == root else cluster_map[cluster]
    return labels


def _probabilities(parent, child, lam, labels, reverse_map: Dict[int, int],
                   root: int) -> np.ndarray:
    """scikit-learn's get_probabilities. A cluster's death lambda is the
    maximum over the LAST run of consecutive condensed-tree rows it parents
    (max_lambdas), not over all its rows."""
    deaths = np.zeros(int(parent.max()) + 1)
    current, max_lambda = int(parent[0]), float(lam[0])
    for p, v in zip(parent[1:].tolist(), lam[1:].tolist()):
        if p == current:
            max_lambda = max(max_lambda, v)
        else:
            deaths[current] = max_lambda
            current, max_lambda = p, v
    deaths[current] = max_lambda

    result = np.zeros(labels.shape[0])
    point = child < root
    pts, point_lam = child[point], lam[point]
    cluster_num = labels[pts]
    keep = cluster_num != _NOISE
    pts, point_lam, cluster_num = pts[keep], point_lam[keep], cluster_num[keep]
    death = deaths[np.asarray([reverse_map[c] for c in cluster_num.tolist()],
                              dtype=np.int64)]
    one = (death == 0.0) | np.isinf(point_lam)
    with np.errstate(divide="ignore", invalid="ignore"):
        result[pts] = np.where(one, 1.0, np.minimum(point_lam, death) / death)
    return result


def _check_hdbscan_args(min_cluster_size, min_samples, epsilon, max_cluster_size,
                        method) -> None:
    if int(min_cluster_size) < 2:
        raise ValueError(f"min_cluster_size must be >= 2, got {min_cluster_size}")
    if min_samples is not None and int(min_samples) < 1:
        raise ValueError(f"min_samples must be >= 1 or None, got {min_samples}")
    if epsilon < 0:
        raise ValueError(f"cluster_selection_epsilon must be >= 0, got {epsilon}")
    if max_cluster_size is not None and int(max_cluster_size) < 1:
        raise ValueError(f"max_cluster_size must be >= 1 or None, got {max_cluster_size}")
    if method not in ("eom", "leaf"):
        raise ValueError(f"cluster_selection_method {method!r}: expected eom or leaf")


def hdbscan_fit(
    feature_matrix: np.ndarray,
    min_cluster_size: int = 5,
    max_cluster_size: Optional[int] = None,
    min_samples: Optional[int] = None,
    cluster_selection_epsilon: float = 0.0,
    cluster_selection_method: str = "eom",
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """HDBSCAN labels (-1 noise, -2 a row with an inf, -3 a row with a NaN)
    and membership probabilities, as scikit-learn's HDBSCAN computes them
    for Euclidean data with allow_single_cluster=False."""
    _check_hdbscan_args(min_cluster_size, min_samples, cluster_selection_epsilon,
                        max_cluster_size, cluster_selection_method)
    dev = resolve_device(device)
    x = np.asarray(feature_matrix, dtype=np.float64)
    with np.errstate(invalid="ignore"):   # inf - inf in a row is a NaN row
        row_sums = x.sum(axis=1)
    finite = np.isfinite(row_sums).nonzero()[0]
    xf = x[finite]
    if xf.shape[0] == 1:
        raise ValueError("n_samples=1 while HDBSCAN requires more than one sample")
    k = int(min_cluster_size if min_samples is None else min_samples)
    if k > xf.shape[0]:
        raise ValueError(f"min_samples ({k}) must be at most the number of samples "
                         f"in X ({xf.shape[0]})")
    data = torch.as_tensor(np.ascontiguousarray(xf), device=dev)
    core = _core_distances(data, k)
    tree = _single_linkage(*_prim_mst(data, core))
    condensed = _condense_tree(*tree, int(min_cluster_size))
    stability = _compute_stability(*condensed)
    labels_f, probs_f = _get_clusters(
        *condensed, stability, cluster_selection_method,
        float(cluster_selection_epsilon), max_cluster_size)
    if finite.shape[0] == x.shape[0]:
        return labels_f, probs_f
    labels = np.empty(x.shape[0], dtype=np.int64)
    probs = np.zeros(x.shape[0])
    labels[finite], probs[finite] = labels_f, probs_f
    missing, infinite = np.isnan(row_sums), np.isinf(row_sums)
    labels[infinite], probs[infinite] = _INFINITE_LABEL, _INFINITE_PROB
    labels[missing], probs[missing] = _MISSING_LABEL, _MISSING_PROB
    return labels, probs


def weighted_centroids(feature_matrix: np.ndarray, labels: np.ndarray,
                       probabilities: np.ndarray) -> np.ndarray:
    """Probability-weighted mean of each cluster 0..max(labels) (float64),
    over the rows whose values are finite."""
    x = np.asarray(feature_matrix, dtype=np.float64)
    n_clusters = int(labels.max()) + 1 if (labels >= 0).any() else 0
    centroids = np.empty((n_clusters, x.shape[1]))
    for idx in range(n_clusters):
        mask = labels == idx
        centroids[idx] = np.average(x[mask], weights=probabilities[mask], axis=0)
    return centroids


def hdbscan_clustering(
    feature_matrix: np.ndarray,
    min_cluster_size: int = 5,
    max_cluster_size: Optional[int] = None,
    min_samples: Optional[int] = None,
    cluster_selection_epsilon: float = 0.0,
    cluster_selection_method: str = "eom",
    n_jobs: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """HDBSCAN: (labels, probability-weighted centroids).

    The core distances and Prim's tree run on the device in float64; the
    condensed tree, the cluster selection and the labels on the host.
    `n_jobs` keeps the JAX package's signature and its SLURM default
    (SLURM_CPUS_PER_TASK * SLURM_NTASKS); it has no effect here."""
    if n_jobs is None:
        n_jobs = int(os.environ.get("SLURM_CPUS_PER_TASK", 1)) * int(
            os.environ.get("SLURM_NTASKS", 1))
    labels, probs = hdbscan_fit(
        feature_matrix, min_cluster_size, max_cluster_size, min_samples,
        cluster_selection_epsilon, cluster_selection_method, device)
    return labels, weighted_centroids(feature_matrix, labels, probs)


# ---------------------------------------------------------------------------
# Hierarchical (agglomerative) clustering on the host
# ---------------------------------------------------------------------------

def _hc_cut(n_clusters: int, children: np.ndarray, n_leaves: int) -> np.ndarray:
    """scikit-learn's _hc_cut: labels of the n_clusters subtrees that remain
    after undoing the last n_clusters - 1 merges."""
    if n_clusters > n_leaves:
        raise ValueError(
            "Cannot extract more clusters than samples: "
            f"{n_clusters} clusters were given for a tree with {n_leaves} leaves."
        )
    nodes = [-(max(children[-1]) + 1)]
    for _ in range(n_clusters - 1):
        these_children = children[-nodes[0] - n_leaves]
        heapq.heappush(nodes, -these_children[0])
        heapq.heappushpop(nodes, -these_children[1])
    label = np.zeros(n_leaves, dtype=np.intp)
    for i, node in enumerate(nodes):
        stack, leaves = [-node], []
        while stack:
            top = stack.pop()
            if top < n_leaves:
                leaves.append(top)
            else:
                stack.extend(children[top - n_leaves])
        label[leaves] = i
    return label


def hierarchical_clustering(
    feature_matrix: np.ndarray,
    cutoff: Optional[float],
    num_clusters: Optional[int] = None,
    linkage: str = "complete",
) -> Tuple[np.ndarray, np.ndarray]:
    """Agglomerative clustering as scikit-learn's AgglomerativeClustering
    without connectivity: scipy's linkage tree, cut into num_clusters (or at
    the distance `cutoff`); centroids are the cluster means, in the order of
    the sorted labels."""
    from scipy.cluster import hierarchy

    if cutoff is None and num_clusters is None:
        raise ValueError("Either cutoff or num_clusters must be provided")
    if cutoff is not None and num_clusters is not None:
        raise ValueError("Only one of cutoff or num_clusters must be provided")
    x = np.asarray(feature_matrix)
    if not np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float64)
    tree = hierarchy.linkage(x, method=linkage, metric="euclidean")
    children = tree[:, :2].astype(int)
    if cutoff is not None:
        num_clusters = int(np.count_nonzero(tree[:, 2] >= cutoff)) + 1
    labels = _hc_cut(int(num_clusters), children, x.shape[0])
    centroids = np.stack([x[labels == u].mean(axis=0) for u in np.unique(labels)])
    return labels, centroids


# ---------------------------------------------------------------------------
# Dispatch and optimization (cf. the reference's statistics.py:17-157)
# ---------------------------------------------------------------------------

def cluster_data(
    features: np.ndarray,
    settings: Dict,
    initial_centroids: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster with settings["algorithm"]. Its fallback defaults are the JAX
    package's (n_init 10, min_cluster_size 10 % of the rows), not the
    schema's."""
    settings = dict(settings)
    settings.setdefault("algorithm", "kmeans")
    settings.setdefault("num_clusters", 10)
    settings.setdefault("n_init", 10)
    settings.setdefault("min_cluster_size", int(0.1 * features.shape[0]))
    settings.setdefault("min_samples", max(int(0.001 * features.shape[0]), 1))
    settings.setdefault("cluster_selection_epsilon", 0)
    settings.setdefault("linkage", "complete")
    settings.setdefault("max_cluster_size", None)
    settings.setdefault("cluster_selection_method", "eom")

    algo = settings["algorithm"]
    if algo == "kmeans":
        return kmeans_clustering(features, settings["num_clusters"], settings["n_init"],
                                 initial_centroids, device=device)
    if algo == "hdbscan":
        return hdbscan_clustering(
            features,
            settings["min_cluster_size"],
            settings["max_cluster_size"],
            settings["min_samples"],
            settings["cluster_selection_epsilon"],
            settings["cluster_selection_method"],
            device=device,
        )
    if algo == "hierarchical":
        return hierarchical_clustering(
            features, None, settings["num_clusters"], settings["linkage"]
        )
    raise ValueError(f"clustering algorithm {algo} not implemented")


def optimize_clustering(
    features: np.ndarray, settings: Dict, device: DeviceLike = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Scan num_clusters over settings["search_interval"] and keep the best
    combined score (CH normalized - DB normalized + silhouette normalized,
    equal weights), for k-means and hierarchical; HDBSCAN runs once."""
    if settings["algorithm"] in ("kmeans", "hierarchical") and settings.get(
        "opt_num_clusters", True
    ):
        interval = settings.get("search_interval", [2, 15])
        candidates = range(interval[0], interval[1] + 1)
        ch_scores, db_scores, sil_scores, results = [], [], [], []
        for n in candidates:
            run_settings = dict(settings)
            run_settings["num_clusters"] = n
            labels, centroids = cluster_data(features, run_settings, device=device)
            ch, db, sil = clustering_scores(features, labels, device=device)
            ch_scores.append(ch)
            db_scores.append(db)
            sil_scores.append(sil)
            results.append((labels, centroids))

        def norm(v):
            v = np.asarray(v, float)
            span = v.max() - v.min()
            return (v - v.min()) / span if span > 0 else np.zeros_like(v)

        combined = (norm(ch_scores) - norm(db_scores) + norm(sil_scores)) / 3
        best = int(np.argmax(combined))
        logger.info("Best number of clusters: %d", list(candidates)[best])
        labels, centroids = results[best]
    else:
        labels, centroids = cluster_data(features, settings, device=device)

    if len(centroids) == 0:
        logger.warning(
            "No clusters found using the provided settings. Try different "
            "settings or a different algorithm"
        )
    return labels, centroids


def find_centroids(
    samples: np.ndarray, centroids: np.ndarray, device: DeviceLike = None
) -> np.ndarray:
    """Boolean mask (n,) of the samples closest to each centroid (argmin
    over the samples, the first on ties). `samples` is the (n, d) matrix of
    the clustering features, where the JAX package takes a DataFrame."""
    samples = np.asarray(samples)
    mask = np.zeros(samples.shape[0], dtype=bool)
    if len(centroids) == 0:
        logger.warning("No centroids found")
        return mask
    if len(centroids[0]) != samples.shape[1]:
        raise ValueError(
            "The dimension of the centroids does not match the clustering "
            "features dimension."
        )
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(samples, np.float32), device=dev)
    c = torch.as_tensor(np.asarray(centroids, np.float32), device=dev)
    d2 = (x ** 2).sum(1)[:, None] - 2 * x @ c.T + (c ** 2).sum(1)[None, :]
    mask[d2.argmin(0).cpu().numpy()] = True
    return mask


def assign_nearest_neighbor(
    new_points: np.ndarray, reference_points: np.ndarray, device: DeviceLike = None
) -> np.ndarray:
    """Index of the nearest reference sample for each new point: brute-force
    1-NN as device matmuls, blocked by query rows so that a tile holds at
    most TILE_ELEMENTS distances (the (new x reference) matrix of 100,000 x
    100,000 points would be 40 GB); each row's argmin is taken whole."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(new_points, np.float32), device=dev)
    b = torch.as_tensor(np.asarray(reference_points, np.float32), device=dev)
    b_sq = (b ** 2).sum(1)
    block = max(1, TILE_ELEMENTS // max(b.shape[0], 1))
    out = torch.empty(a.shape[0], dtype=torch.int64, device=dev)
    for start in range(0, a.shape[0], block):
        rows = a[start:start + block]
        d2 = (rows ** 2).sum(1)[:, None] - 2 * rows @ b.T + b_sq[None, :]
        out[start:start + block] = d2.argmin(1)
    return out.cpu().numpy()
