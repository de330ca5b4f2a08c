"""PyTorch port: a NumPy model of K5's plan.

`csrc/select_extremes.cu` (K5) gives a row of ``W`` values to one thread,
which streams them into two sorted register arrays of ``K`` slots, the
``K`` smallest ascending and the ``K`` largest descending. For ``K <= 4`` it inserts each value by min/max from
the top slot down: ``lo[i] = max(lo[i-1], min(lo[i], v))``,
``hi[i] = min(hi[i-1], max(hi[i], v))``. For ``K >= 5`` it takes chunks of
``K'`` values (``K'`` the power of two >= ``K``), sorts each with the
bitonic sorting network and merges it into both arrays; a chunk whose sum
is NaN (a NaN, or +inf with -inf) is inserted value by value instead and
its NaNs counted, as are the NaNs of the tail past the last chunk. A
merge of a sorted run ``b`` into ``a`` keeps ``c[i] = min(a[i],
b[K'-1-i])`` (``a`` padded with +inf), a bitonic sequence, and sorts it with
the bitonic merge network (the hi side with min and max exchanged). The
thread sums ``lo`` and ``hi`` from slot 0 and divides by ``k``; where the
row holds a NaN the hi mean is NaN, and so is the lo mean where fewer than
``k_lo`` values are not NaN.

A CUDA kernel cannot run here, so this file repeats those steps in NumPy
float32, with ``np.fmin``/``np.fmax`` for ``fminf``/``fmaxf`` (all four
return the other operand of a NaN), and holds the result against the port's
plain twin ``quantile_extreme_means_plain`` bit for bit, NaN matching NaN:
k = 1..16; W = k, W = k + 1, W not a multiple of the chunk and W = 431;
random rows, rows full of ties, rows with +-inf and rows with NaN (the
twin's ``topk`` ranks a NaN above +inf). The merge alone is also held
against a sort of the union of its two runs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_port_util import signals

from mlx_audio_primitives_tpu_torch.kernels.select_extremes import (
    MAX_K,
    quantile_extreme_means_plain,
)

DEPTH = 8  # select_extremes.cu: kDepth, the chunk of the insertion (K <= 4)
SORT_MERGE_FROM = 5  # select_extremes.cu: kSortMerge = K >= 5
F32 = np.float32
INF = F32(np.inf)


def pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def insert(lo: np.ndarray, hi: np.ndarray, v: np.ndarray, nan_safe: bool = True) -> None:
    """The kernel's insertion of ``v`` (rows,) into ``lo``/``hi`` (K, rows),
    in place. Every slot reads the old slots, as the top-down order gives.
    ``nan_safe=False`` is the other operand order, which the kernel avoids."""
    if nan_safe:
        new_lo = np.fmax(lo[:-1], np.fmin(lo[1:], v))
        new_hi = np.fmin(hi[:-1], np.fmax(hi[1:], v))
    else:
        new_lo = np.fmin(lo[1:], np.fmax(lo[:-1], v))
        new_hi = np.fmax(hi[1:], np.fmin(hi[:-1], v))
    lo[0], hi[0] = np.fmin(lo[0], v), np.fmax(hi[0], v)
    lo[1:], hi[1:] = new_lo, new_hi


def sort_ascending(v: np.ndarray) -> np.ndarray:
    """The bitonic sorting network over axis 0 (a power of two long), as
    ``sort_ascending`` runs it, with fmin/fmax."""
    v = v.copy()
    n = v.shape[0]
    log_n = n.bit_length() - 1
    for lk in range(1, log_n + 1):
        for lj in reversed(range(lk)):
            for i in range(n):
                j = i ^ (1 << lj)
                if j < i:
                    continue
                u, w = np.fmin(v[i], v[j]), np.fmax(v[i], v[j])
                up = ((i >> lk) & 1) == 0
                v[i], v[j] = (u, w) if up else (w, u)
    return v


def stream(x: np.ndarray, K: int,
           nan_safe: bool = True) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A thread's arrays after streaming its row, and its count of NaNs:
    chunks of K' values sorted and merged (K >= 5) or of ``DEPTH`` values
    inserted (K <= 4); a chunk whose float32 sum is NaN inserted value by
    value (K >= 5) and its NaNs counted; then the tail one by one, counted.
    ``nan_safe=False`` inserts every value, in the other operand order."""
    R, W = x.shape
    lo = np.full((K, R), INF, F32)
    hi = np.full((K, R), -INF, F32)
    nans = np.zeros(R, np.int64)
    sort_merge = K >= SORT_MERGE_FROM and nan_safe
    D = pow2_ceil(K) if sort_merge else DEPTH
    t = 0
    while t + D <= W:
        chunk = x[:, t:t + D].T
        t += D
        total = chunk[0].copy()
        with np.errstate(invalid="ignore"):
            for u in range(1, D):
                total = total + chunk[u]
        clean = ~np.isnan(total)
        nans += np.where(clean, 0, np.isnan(chunk).sum(0))
        if sort_merge:
            if clean.any():  # threads that merge; the others insert (a divergent branch)
                s = sort_ascending(chunk[:, clean])
                lo[:, clean] = merge(lo[:, clean], s, True)
                hi[:, clean] = merge(hi[:, clean], s[::-1], False)
            if clean.all():
                continue
            rest = ~clean
            lo_r, hi_r = lo[:, rest].copy(), hi[:, rest].copy()
            for v in chunk[:, rest]:
                insert(lo_r, hi_r, v, nan_safe)
            lo[:, rest], hi[:, rest] = lo_r, hi_r
            continue
        for v in chunk:
            insert(lo, hi, v, nan_safe)
    for t in range(t, W):
        nans += np.isnan(x[:, t])
        insert(lo, hi, x[:, t], nan_safe)
    return lo, hi, nans


def is_bitonic(c: np.ndarray) -> bool:
    """Non-decreasing, then non-increasing, along axis 0, for every row."""
    with np.errstate(invalid="ignore"):
        d = np.diff(c.astype(np.float64), axis=0)
    d = np.where(np.isnan(d), 0.0, d)  # inf - inf: equal infinities
    for col in d.T:
        down = np.flatnonzero(col < 0)
        if down.size and (col[down[0]:] > 0).any():
            return False
    return True


def merge(a: np.ndarray, b: np.ndarray, smallest: bool) -> np.ndarray:
    """The K smallest (ascending) or largest (descending) of ``a`` (K
    slots) and ``b`` (a sorted chunk of K' values, in ``a``'s order): the half-cleaner against ``b`` reversed, then the
    bitonic merge network of K' slots, as ``merge_into`` runs it."""
    K = a.shape[0]
    KP = pow2_ceil(K)
    pad = INF if smallest else -INF
    first, second = (np.fmin, np.fmax) if smallest else (np.fmax, np.fmin)
    ap = np.full((KP,) + a.shape[1:], pad, F32)
    bp = ap.copy()
    ap[:K], bp[:b.shape[0]] = a, b
    c = first(ap, bp[::-1])
    assert is_bitonic(c if smallest else -c)
    for level in reversed(range(KP.bit_length() - 1)):
        s = 1 << level
        for i in range(KP):
            if (i >> level) & 1:
                continue
            u, w = c[i].copy(), c[i + s].copy()
            c[i], c[i + s] = first(u, w), second(u, w)
    return c[:K]


def model(x: np.ndarray, k_lo: int, k_hi: int,
          nan_safe: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """K5 on rows ``x`` (R, W) -> (lo, hi) means: NaN for hi where the row
    holds a NaN, for lo where fewer than ``k_lo`` values are not NaN."""
    lo, hi, nans = stream(x, max(k_lo, k_hi), nan_safe)
    s_lo, s_hi = lo[0].copy(), hi[0].copy()
    with np.errstate(invalid="ignore"):  # -inf + inf in a row of infinities
        for i in range(1, k_lo):
            s_lo = s_lo + lo[i]
        for i in range(1, k_hi):
            s_hi = s_hi + hi[i]
    W = x.shape[1]
    return (np.where(W - nans < k_lo, F32(np.nan), s_lo / F32(k_lo)),
            np.where(nans > 0, F32(np.nan), s_hi / F32(k_hi)))


def reference(x: np.ndarray, k_lo: int, k_hi: int) -> tuple[np.ndarray, np.ndarray]:
    """The plain twin on the rows as they are."""
    lo, hi = quantile_extreme_means_plain(torch.from_numpy(x), k_lo, k_hi)
    return lo.numpy(), hi.numpy()


def exact(a: np.ndarray, b: np.ndarray) -> bool:
    """float32 arrays equal bit for bit, NaN matching NaN."""
    nan = np.isnan(a)
    return (a.dtype == b.dtype == F32 and a.shape == b.shape
            and np.array_equal(nan, np.isnan(b))
            and np.array_equal(a[~nan].view(np.uint32), b[~nan].view(np.uint32)))


def rows(kind: str, seed: int, shape: tuple[int, int]) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(-3, 4, shape).astype(F32)
    x = signals(seed, shape)
    if kind in ("inf", "nan"):
        u = rng.random(shape)
        x[u < 0.1] = np.inf
        x[(u >= 0.1) & (u < 0.2)] = -np.inf
        if kind == "nan":
            x[u >= 0.8] = np.nan
    return x


def widths(k: int) -> list[int]:
    """W = k, k + 1, one not a multiple of the chunk (a tail after whole
    chunks), and 431, the widest default contrast band."""
    D = pow2_ceil(k) if k >= SORT_MERGE_FROM else DEPTH
    return sorted({k, k + 1, 2 * D + 3, 431})


KINDS = ("random", "ties", "inf", "nan")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", range(1, MAX_K + 1))
def test_plan_matches_twin_bit_for_bit(k, kind):
    for W in widths(k):
        x = rows(kind, 1000 * k + W, (24, W))
        for k_lo, k_hi in ((k, k), (k, max(1, k // 2)), (max(1, k - 3), k)):
            got_lo, got_hi = model(x, k_lo, k_hi)
            ref_lo, ref_hi = reference(x, k_lo, k_hi)
            assert exact(got_lo, ref_lo), (W, k_lo, k_hi)
            assert exact(got_hi, ref_hi), (W, k_lo, k_hi)


@pytest.mark.parametrize("kind", ("random", "ties", "inf"))
@pytest.mark.parametrize("k", range(1, MAX_K + 1))
def test_merge_keeps_the_k_extremes(k, kind):
    # a (K slots, sorted) merged with a sorted run of K' values holds the K
    # smallest (largest) of the union, in order, bit for bit
    KP = pow2_ceil(k)
    x = rows(kind, 7 * k + len(kind), (40, k + KP))
    a, b = x[:, :k], x[:, k:]
    union = np.sort(x, axis=1)
    lo = merge(np.sort(a, axis=1).T, np.sort(b, axis=1).T, True).T
    hi = merge(-np.sort(-a, axis=1).T, -np.sort(-b, axis=1).T, False).T
    assert exact(np.ascontiguousarray(lo), union[:, :k])
    assert exact(np.ascontiguousarray(hi), np.ascontiguousarray(union[:, ::-1][:, :k]))


def test_plan_reads_a_strided_band():
    # the natural (B, n_bins, F) layout, rows = frames: the model on the
    # band's rows equals the twin on the strided view
    mag = np.abs(signals(7, (2, 120, 33)))
    band = torch.from_numpy(mag)[:, 20:95, :].transpose(1, 2)  # (B, F, W), strided
    x = band.reshape(-1, band.shape[-1]).numpy()
    got_lo, got_hi = model(x, 6, 6)
    ref_lo, ref_hi = quantile_extreme_means_plain(band, 6, 6)
    assert exact(got_lo, ref_lo.reshape(-1).numpy()) and exact(got_hi, ref_hi.reshape(-1).numpy())


@pytest.mark.parametrize("k", (2, 5, 9))
def test_plan_other_operand_order_copies_a_slot_on_nan(k):
    # min(lo[i], max(lo[i-1], v)) is the same insertion for numbers, but a
    # NaN v makes it copy lo[i-1] into slot i; the kernel's order skips it
    finite = rows("random", 3 + k, (64, 60))
    x = finite.copy()
    x[np.random.default_rng(k).random(x.shape) < 0.2] = np.nan
    assert all(exact(a, b) for a, b in zip(model(finite, k, k, nan_safe=False),
                                           reference(finite, k, k)))
    bad_lo, bad_hi = model(x, k, k, nan_safe=False)
    ref_lo, ref_hi = reference(x, k, k)
    assert not (exact(bad_lo, ref_lo) and exact(bad_hi, ref_hi))
