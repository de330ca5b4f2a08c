"""PyTorch port: recurrence / cross-similarity matrices, nearest-neighbour
filtering and LPC against the JAX package.

Contracts:

* ``recurrence_matrix`` / ``cross_similarity``: the kept neighbour pairs
  equal the JAX package's; distances and affinities within 1e-6 of max.
  A row's threshold is its k-th smallest distance, a value, so ties do not
  move it (a test with exact ties);
* medians: ``jnp.nanmedian`` averages the two middle values of an even
  count, and so does the port (``torch.nanmedian`` would take the lower
  one): the affinity bandwidth and ``nn_filter``'s median are held on even
  counts, and ``nn_filter``'s median against a NumPy median per frame;
  the chunking over feature rows gives the same bits as one sort;
* ``lpc`` (Burg): within 5e-4 of the JAX package and of a float64 Burg
  transliteration at order 16 (`NUMERICAL_ACCURACY.md`, LPC row).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
from torch_port_util import signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap

ts = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.segment")

torch.set_num_threads(1)

X = signals(110, (12, 60))
Y = signals(111, (12, 40))

REC_CASES = {
    "default": {},
    "distance": dict(mode="distance"),
    "affinity": dict(mode="affinity"),
    "sym-width3": dict(sym=True, width=3),
    "cosine-self": dict(metric="cosine", mode="affinity", self_=True),
    "k5": dict(k=5),
    "k-large": dict(k=100, mode="distance"),
}


@pytest.mark.parametrize("case", list(REC_CASES))
def test_recurrence_matrix_matches_jax(case):
    kw = REC_CASES[case]
    got = to_np(tap.recurrence_matrix(X, **kw))
    ref = np.asarray(jap.recurrence_matrix(X, **kw))
    assert got.shape == ref.shape == (60, 60)
    np.testing.assert_array_equal(got != 0, ref != 0)
    assert np.abs(got - ref).max() <= 1e-6 * max(np.abs(ref).max(), 1.0)


def test_recurrence_matrix_scalar_features_and_ties():
    # integer features: many exactly equal distances around each row's
    # k-th smallest, all kept as the JAX package keeps them
    q = np.round(signals(112, (40,)) * 2).astype(np.float32)
    for kw in ({}, dict(mode="affinity"), dict(k=7, mode="distance")):
        np.testing.assert_array_equal(to_np(tap.recurrence_matrix(q, **kw)),
                                      np.asarray(jap.recurrence_matrix(q, **kw)))


@pytest.mark.parametrize("kw", [{}, dict(mode="affinity"), dict(metric="cosine", mode="distance"),
                                dict(k=3)], ids=["default", "affinity", "cosine", "k3"])
def test_cross_similarity_matches_jax(kw):
    got = to_np(tap.cross_similarity(X, Y, **kw))
    ref = np.asarray(jap.cross_similarity(X, Y, **kw))
    assert got.shape == ref.shape == (60, 40)
    np.testing.assert_array_equal(got != 0, ref != 0)
    assert np.abs(got - ref).max() <= 1e-6


@pytest.mark.parametrize("n", [1, 2, 5, 6, 7])
def test_masked_median_of_even_and_odd_counts(n):
    rng = np.random.default_rng(n)
    vals = rng.standard_normal((4, 9)).astype(np.float32)
    keep = np.zeros((4, 9), bool)
    for r in range(4):
        keep[r, rng.choice(9, n, replace=False)] = True
    got = to_np(ts._masked_median(torch.from_numpy(vals), torch.from_numpy(keep)))
    ref = np.array([np.median(vals[r][keep[r]]) for r in range(4)], np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-7)
    none = ts._masked_median(torch.from_numpy(vals), torch.zeros((4, 9), dtype=torch.bool))
    assert bool(torch.isnan(none).all())


def test_affinity_bandwidth_is_the_two_middle_mean():
    # sym with k=1 keeps an even number of pairs (each mutual pair twice)
    R = to_np(tap.recurrence_matrix(X, k=1, sym=True, mode="affinity"))
    D = to_np(tap.recurrence_matrix(X, k=1, sym=True, mode="distance"))
    keep = D > 0
    assert keep.sum() % 2 == 0 and keep.sum() > 0
    bw = np.median(D[keep].astype(np.float64))
    np.testing.assert_allclose(R[keep], np.exp(-D[keep] / bw), rtol=2e-6)
    np.testing.assert_allclose(R, np.asarray(jap.recurrence_matrix(X, k=1, sym=True, mode="affinity")),
                               rtol=2e-6, atol=1e-7)


NN_CASES = {
    "mean": {},
    "median": dict(aggregate="median"),
    "median-k4": dict(aggregate="median", k=4),
    "mean-connectivity": dict(mode="connectivity", k=6),
}


@pytest.mark.parametrize("case", list(NN_CASES))
def test_nn_filter_matches_jax(case):
    kw = NN_CASES[case]
    got = to_np(tap.nn_filter(X, **kw))
    ref = np.asarray(jap.nn_filter(X, **kw))
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_nn_filter_median_is_numpys_and_chunks_equal_one_sort(monkeypatch):
    R = to_np(tap.recurrence_matrix(X, k=5))
    got = to_np(tap.nn_filter(X, rec=R, aggregate="median"))
    keep = (R + np.eye(60)) > 0
    ref = np.stack([[np.median(X[d][keep[i]]) for i in range(60)] for d in range(12)])
    np.testing.assert_allclose(got, ref.astype(np.float32), rtol=1e-7)
    monkeypatch.setattr(ts, "_NN_CHUNK_ELEMS", 60 * 60 * 5)  # 5 feature rows a chunk
    np.testing.assert_array_equal(to_np(tap.nn_filter(X, rec=R, aggregate="median")), got)


def test_segment_errors_match_jax():
    for fn in (
        lambda m: m.recurrence_matrix(X, width=40),
        lambda m: m.recurrence_matrix(X, mode="bad"),
        lambda m: m.recurrence_matrix(X, metric="manhattan"),
        lambda m: m.recurrence_matrix(np.zeros((2, 3, 4), np.float32)),
        lambda m: m.cross_similarity(X, Y[:5]),
        lambda m: m.nn_filter(X, aggregate="max"),
        lambda m: m.nn_filter(X, rec=np.zeros((3, 3), np.float32)),
    ):
        with pytest.raises(ValueError) as e_port:
            fn(tap)
        with pytest.raises(ValueError) as e_jax:
            fn(jap)
        assert str(e_port.value) == str(e_jax.value)


def burg_f64(y: np.ndarray, order: int) -> np.ndarray:
    """Burg's method in float64 (librosa's loop, transliterated)."""
    y = y.astype(np.float64)
    ar = np.zeros(order + 1)
    ar[0] = 1.0
    fwd, bwd = y[1:].copy(), y[:-1].copy()
    den = np.dot(fwd, fwd) + np.dot(bwd, bwd)
    for i in range(order):
        r = -2.0 * np.dot(bwd, fwd) / den
        prev = ar.copy()
        for j in range(1, i + 2):
            ar[j] = prev[j] + r * prev[i + 1 - j]
        fwd_new = fwd + r * bwd
        bwd_new = bwd + r * fwd
        den = (1.0 - r * r) * den - fwd_new[0] ** 2 - bwd_new[-1] ** 2
        fwd, bwd = fwd_new[1:], bwd_new[:-1]
    return ar


AR = np.stack([
    np.convolve(signals(113, (3000,)), [1.0, 0.6, 0.3, -0.2], "same"),
    np.sin(2 * np.pi * 0.05 * np.arange(3000)) + 0.1 * signals(114, (3000,)),
]).astype(np.float32)


@pytest.mark.parametrize("order", [1, 4, 16, 32])
def test_lpc_matches_jax_and_float64_burg(order):
    got = to_np(tap.lpc(AR, order))
    assert got.shape == (2, order + 1) and np.all(got[:, 0] == 1.0)
    np.testing.assert_allclose(got, np.asarray(jap.lpc(AR, order)), atol=5e-4)
    tol = 5e-4 if order <= 16 else 2e-3
    for b in range(2):
        np.testing.assert_allclose(got[b], burg_f64(AR[b], order), atol=tol)


def test_lpc_axis_and_short_signal():
    y3 = np.stack([AR, AR[::-1].copy()])  # (2, 2, 3000)
    got = to_np(tap.lpc(np.moveaxis(y3, -1, 1), 8, axis=1))
    assert got.shape == (2, 9, 2)
    np.testing.assert_allclose(got, np.asarray(jap.lpc(np.moveaxis(y3, -1, 1), 8, axis=1)), atol=5e-4)
    for fn in (lambda m: m.lpc(AR[0, :5], 5), lambda m: m.lpc(AR, 0)):
        with pytest.raises(ValueError) as e_port:
            fn(tap)
        with pytest.raises(ValueError) as e_jax:
            fn(jap)
        assert str(e_port.value) == str(e_jax.value)
