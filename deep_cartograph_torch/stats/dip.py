"""Hartigan's dip test of unimodality (numpy, host).

A copy of the JAX package's stats/dip.py: the dip statistic (Hartigan &
Hartigan, Ann. Stat. 1985; the AS 217 iteration of greatest-convex-minorant
and least-concave-majorant refinement) and p-values interpolated from a
Monte-Carlo null table of uniform samples built by this module
(`build_null_table`). The port ships its own copy of the table,
`dip_null_table.npz`, identical to the JAX package's.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_TABLE_PATH = os.path.join(os.path.dirname(__file__), "dip_null_table.npz")
_TABLE_CACHE: Optional[dict] = None


def _gcm_touchpoints(x: np.ndarray) -> np.ndarray:
    """Greatest convex minorant predecessor array for points (x_j, j).

    mn[j] is the previous touch point of the GCM through (x_0,0)..(x_j,j).
    """
    n = len(x)
    mn = np.zeros(n, dtype=np.int64)
    for j in range(1, n):
        mn[j] = j - 1
        while True:
            mnj = mn[j]
            if mnj == 0:
                break
            mnmnj = mn[mnj]
            # keep popping while (mnmnj, mnj, j) is not convex
            if (x[j] - x[mnj]) * (mnj - mnmnj) < (x[mnj] - x[mnmnj]) * (j - mnj):
                break
            mn[j] = mnmnj
    return mn


def _lcm_touchpoints(x: np.ndarray) -> np.ndarray:
    """Least concave majorant successor array (mirror of the GCM)."""
    n = len(x)
    mj = np.zeros(n, dtype=np.int64)
    mj[n - 1] = n - 1
    for j in range(n - 2, -1, -1):
        mj[j] = j + 1
        while True:
            mjj = mj[j]
            if mjj == n - 1:
                break
            mjmjj = mj[mjj]
            if (x[j] - x[mjj]) * (mjj - mjmjj) < (x[mjj] - x[mjmjj]) * (j - mjj):
                break
            mj[j] = mjmjj
    return mj


def dip_statistic(samples: np.ndarray) -> float:
    """The dip statistic of a 1-D sample (in [1/(2n), 1/4]).

    Follows the AS 217 iteration: compute GCM/LCM touch points over the
    current modal interval, find the largest GCM-LCM separation d, accumulate
    the one-sided dips on the flanks, shrink the interval to where d occurs,
    and stop when d no longer exceeds the accumulated dip. All bookkeeping is
    in "count" units (ecdf steps of 1); the returned dip is d/(2n).
    """
    x = np.sort(np.asarray(samples, dtype=np.float64))
    n = len(x)
    if n < 2 or x[0] == x[-1]:
        return 0.0
    if n < 4:
        return 1.0 / (2.0 * n)

    mn = _gcm_touchpoints(x)
    mj = _lcm_touchpoints(x)

    low, high = 0, n - 1
    dip = 1.0  # count units; lower bound (=> 1/(2n) after scaling)

    for _ in range(n + 8):  # interval shrinks every cycle; guard anyway
        # GCM touch points, stored high -> low (descending)
        gcm = [high]
        while gcm[-1] > low:
            gcm.append(int(mn[gcm[-1]]))
        l_gcm = len(gcm)
        # LCM touch points, stored low -> high (ascending)
        lcm = [low]
        while lcm[-1] < high:
            lcm.append(int(mj[lcm[-1]]))
        l_lcm = len(lcm)

        # Largest separation d between GCM and LCM over [low, high]
        ix, iv = l_gcm - 2, 1
        ig, ih = l_gcm - 1, l_lcm - 1
        d = 0.0
        if l_gcm != 2 or l_lcm != 2:
            while True:
                gcmix, lcmiv = gcm[ix], lcm[iv]
                if gcmix > lcmiv:
                    # LCM touch point first: LCM value minus GCM chord there
                    gcmi1 = gcm[ix + 1]
                    dx = (lcmiv - gcmi1 + 1) - (x[lcmiv] - x[gcmi1]) * (
                        gcmix - gcmi1
                    ) / (x[gcmix] - x[gcmi1])
                    if dx >= d:
                        d, ig, ih = dx, ix + 1, iv
                    iv += 1
                else:
                    # GCM touch point first: LCM chord there minus GCM value
                    lcmiv1 = lcm[iv - 1]
                    dx = (x[gcmix] - x[lcmiv1]) * (lcmiv - lcmiv1) / (
                        x[lcmiv] - x[lcmiv1]
                    ) - (gcmix - lcmiv1 - 1)
                    if dx >= d:
                        d, ig, ih = dx, ix, iv
                    ix -= 1
                if ix < 0:
                    ix = 0
                if iv > l_lcm - 1:
                    iv = l_lcm - 1
                if gcm[ix] == lcm[iv]:
                    break
        else:
            d = 1.0

        if d < dip:
            break

        # One-sided dip on the low flank: ecdf above its GCM chords between
        # the d-location and `low`.
        dip_l = 0.0
        for j in range(ig, l_gcm - 1):
            jb, je = gcm[j + 1] + 1, gcm[j]
            max_t = 1.0
            if je - jb > 1 and x[je] != x[jb]:
                slope = (je - jb) / (x[je] - x[jb])
                for jj in range(jb, je + 1):
                    t = (jj - jb + 1) - (x[jj] - x[jb]) * slope
                    if t > max_t:
                        max_t = t
            dip_l = max(dip_l, max_t)

        # One-sided dip on the high flank: ecdf below its LCM chords between
        # the d-location and `high`.
        dip_u = 0.0
        for j in range(ih, l_lcm - 1):
            jb, je = lcm[j], lcm[j + 1] - 1
            max_t = 1.0
            if je - jb > 1 and x[je] != x[jb]:
                slope = (je - jb) / (x[je] - x[jb])
                for jj in range(jb, je + 1):
                    t = (x[jj] - x[jb]) * slope - (jj - jb - 1)
                    if t > max_t:
                        max_t = t
            dip_u = max(dip_u, max_t)

        dip = max(dip, dip_l, dip_u)
        new_low, new_high = gcm[ig], lcm[ih]
        if new_low == low and new_high == high:
            break
        low, high = new_low, new_high

    return float(dip) / (2.0 * n)


# ---------------------------------------------------------------------------
# Null distribution (Monte Carlo over uniform samples) and p-values
# ---------------------------------------------------------------------------

DEFAULT_TABLE_NS = (
    4, 6, 8, 10, 15, 20, 30, 50, 75, 100, 150, 200, 300, 500, 750, 1000,
    2000, 5000, 10000, 20000, 50000, 100000,
)


def build_null_table(
    ns=DEFAULT_TABLE_NS,
    n_reps: int = 2000,
    n_quantiles: int = 201,
    seed: int = 0,
    path: str = _TABLE_PATH,
) -> dict:
    """Monte-Carlo null table: quantiles of sqrt(n)*dip for uniform samples."""
    rng = np.random.default_rng(seed)
    qs = np.linspace(0.0, 1.0, n_quantiles)
    rows = []
    for n in ns:
        dips = np.empty(n_reps)
        for r in range(n_reps):
            dips[r] = dip_statistic(rng.random(n))
        rows.append(np.quantile(np.sqrt(n) * dips, qs))
        logger.info("dip null table: n=%d done", n)
    table = {
        "ns": np.asarray(ns, dtype=np.int64),
        "quantiles": qs,
        "values": np.asarray(rows),
    }
    np.savez_compressed(path, **table)
    return table


def _load_table() -> dict:
    global _TABLE_CACHE
    if _TABLE_CACHE is None:
        if not os.path.exists(_TABLE_PATH):
            logger.warning(
                "Dip null table missing — generating a small one now "
                "(run stats.dip.build_null_table for a finer table)."
            )
            _TABLE_CACHE = build_null_table(
                ns=(10, 50, 100, 500, 1000, 10000), n_reps=500
            )
        else:
            data = np.load(_TABLE_PATH)
            _TABLE_CACHE = {k: data[k] for k in data.files}
    return _TABLE_CACHE


def pvalue_from_dip(dip: float, n: int) -> float:
    """P-value for a precomputed dip statistic at sample size n."""
    if n < 4:
        return 1.0
    table = _load_table()
    ns = table["ns"].astype(float)
    logn = np.log(float(n))
    values = table["values"]
    col = np.empty(values.shape[1])
    for q in range(values.shape[1]):
        col[q] = np.interp(logn, np.log(ns), values[:, q])
    stat = np.sqrt(n) * dip
    cdf = np.interp(stat, col, table["quantiles"], left=0.0, right=1.0)
    return float(1.0 - cdf)


def dip_pvalue(samples: np.ndarray) -> Tuple[float, float]:
    """(dip, p-value) via sqrt(n)-scaled interpolation of the null table.

    Small p-value => evidence against unimodality (same convention as the
    reference's diptest usage, statistics.py:595-635).
    """
    x = np.asarray(samples)
    n = len(x)
    dip = dip_statistic(x)
    if n < 4:
        return dip, 1.0
    table = _load_table()
    ns = table["ns"].astype(float)
    # Interpolate each null quantile value across log(n)
    logn = np.log(float(n))
    values = table["values"]
    col = np.empty(values.shape[1])
    for q in range(values.shape[1]):
        col[q] = np.interp(logn, np.log(ns), values[:, q])
    stat = np.sqrt(n) * dip
    # p = 1 - F_null(stat)
    cdf = np.interp(stat, col, table["quantiles"], left=0.0, right=1.0)
    return dip, float(1.0 - cdf)


def diptest(samples: np.ndarray) -> Tuple[float, float]:
    """API-compatible with `diptest.diptest`: returns (dip, pvalue)."""
    return dip_pvalue(samples)
