"""PyTorch port: median filtering, HPSS and NMF against the JAX package.

Contracts (`NUMERICAL_ACCURACY.md`, HPSS and decompose rows):

* ``median_filter_1d`` equals ``scipy.ndimage.median_filter`` (mode
  'reflect') and the JAX package bit for bit, including even sizes (the
  upper middle of the window), windows longer than the axis, ties and the
  edges; the row chunking gives the same bits as one sort;
* ``hpss``: the soft masks sum to 1 within 1e-5 and ``H + P = S`` within
  1e-4 of max; against the JAX package within 1e-6 of max on a magnitude
  input (identical medians, so hard masks too) and 1e-5 on a complex one;
* ``harmonic`` / ``percussive`` against the JAX package within 1e-5 of
  max, on the plain route and on the kernel route (on the CPU the
  wrappers run the kernels' twins);
* NMF: the Frobenius objective never rises; after the same seed the
  factors match the JAX package's within 2e-5 of max (a float32 ``mean``
  sets the initial scale, then 200 multiplicative updates), and with given
  templates ``W`` (fixed or a warm start) likewise.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import scipy.ndimage
import torch
from torch_port_util import max_rel, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch.utils import dispatch as tap_dispatch

jd = importlib.import_module("mlx_audio_primitives_tpu.ops.decompose")
td = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.decompose")

torch.set_num_threads(1)

SR = 22050
N_FFT, HOP = 512, 128
# noise plus a tone: every bin carries energy
Y = signals(80, (2, SR)) * 0.3 + np.sin(2 * np.pi * 440.0 * np.arange(SR) / SR).astype(np.float32)
S_C = np.asarray(jap.stft(Y, n_fft=N_FFT, hop_length=HOP))
S_MAG = np.abs(S_C).astype(np.float32)
# integer-valued data: many ties inside a window
TIES = np.round(signals(81, (3, 7, 40)) * 3).astype(np.float32)


@pytest.fixture(params=["plain", "kernels"])
def port_route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setattr(tap_dispatch, "resolve_use_pallas", lambda flag, device: flag is not False)
    return request.param


#: (size, axis) with size <= 2 n + 1 (beyond it the filter raises):
#: even sizes, a window longer than the axis (15 on 7 values, 81 on 40)
MEDIAN_CASES = [(size, axis) for axis in (-1, -2, 0) for size in (1, 2, 3, 4, 7, 8, 15, 31, 81)
                if size <= 2 * TIES.shape[axis] + 1]


@pytest.mark.parametrize("size,axis", MEDIAN_CASES)
def test_median_filter_matches_scipy_and_jax(size, axis):
    footprint = [1] * TIES.ndim
    footprint[axis] = size
    ref = scipy.ndimage.median_filter(TIES, size=footprint, mode="reflect")
    got = to_np(td.median_filter_1d(TIES, size, axis=axis))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(jd.median_filter_1d(TIES, size, axis=axis)))


def test_median_filter_chunks_equal_one_sort(monkeypatch):
    whole = to_np(td.median_filter_1d(S_MAG, 31, axis=-1))
    monkeypatch.setattr(td, "_MEDIAN_CHUNK_ELEMS", 31 * S_MAG.shape[-1] * 5)  # 5 rows a chunk
    np.testing.assert_array_equal(to_np(td.median_filter_1d(S_MAG, 31, axis=-1)), whole)


def test_median_filter_errors():
    with pytest.raises(ValueError, match="may not exceed"):
        td.median_filter_1d(np.zeros((4, 5), np.float32), 12)
    with pytest.raises(ValueError, match="size must be positive"):
        td.median_filter_1d(np.zeros(5, np.float32), 0)


HPSS_CASES = {
    "default": {},
    "kernels-17-31": dict(kernel_size=(17, 31)),
    "power-1": dict(power=1.0),
    "margin": dict(margin=(2.0, 3.0)),
    "hard": dict(power=np.inf),
    "masks": dict(mask=True),
}


#: hard masks compare two medians; on a complex input the port's and the
#: JAX package's float32 |S| differ in the last bit, so a tie can flip a
#: hard mask there: they are compared on a magnitude input
HPSS_PAIRS = [(case, kind) for case in HPSS_CASES for kind in ("magnitude", "complex")
              if not (case == "hard" and kind == "complex")]


@pytest.mark.parametrize("case,kind", HPSS_PAIRS)
def test_hpss_matches_jax(case, kind):
    kw = HPSS_CASES[case]
    S = S_MAG if kind == "magnitude" else S_C
    got, ref = tap.hpss(S, **kw), jap.hpss(S, **kw)
    tol = 1e-6 if kind == "magnitude" else 1e-5
    for g, r in zip(got, ref):
        assert max_rel(g, r) <= tol


@pytest.mark.parametrize("kind", ["magnitude", "complex"])
def test_hpss_masks_sum_to_one_and_parts_to_the_whole(kind):
    S = S_MAG if kind == "magnitude" else S_C
    mh, mp = tap.hpss(S, mask=True)
    assert float((mh + mp - 1.0).abs().max()) <= 1e-5
    H, P = tap.hpss(S)
    assert max_rel(H + P, S) <= 1e-4


def test_hpss_split_zeros_and_hard_masks():
    # all-zero input: both soft masks 0.5 (split_zeros at margin 1), hard
    # masks 0; with a margin > 1 the soft masks are 0
    Z = np.zeros((9, 12), np.float32)
    for kw in ({}, dict(power=np.inf), dict(margin=2.0)):
        kw["kernel_size"] = 7
        for g, r in zip(tap.hpss(Z, mask=True, **kw), jap.hpss(Z, mask=True, **kw)):
            np.testing.assert_array_equal(to_np(g), np.asarray(r))
        assert float(to_np(g).max()) == (0.5 if len(kw) == 1 else 0.0)
    mh, mp = tap.hpss(S_MAG, mask=True, power=np.inf)
    assert set(np.unique(to_np(mh))) <= {0.0, 1.0} and set(np.unique(to_np(mp))) <= {0.0, 1.0}


def test_hpss_errors():
    for kw in (dict(kernel_size=0), dict(power=0.0), dict(margin=0.5)):
        with pytest.raises(ValueError):
            tap.hpss(S_MAG, **kw)
    with pytest.raises(ValueError, match="2-D or 3-D"):
        tap.hpss(np.zeros(5, np.float32))


@pytest.mark.parametrize("fn", ["harmonic", "percussive"])
@pytest.mark.parametrize("kw", [{}, dict(kernel_size=(11, 21), margin=2.0), dict(center=False)],
                         ids=["default", "margin", "no-center"])
def test_harmonic_percussive_match_jax(fn, kw, port_route):
    got = getattr(tap, fn)(Y, n_fft=N_FFT, hop_length=HOP, **kw)
    ref = getattr(jap, fn)(Y, n_fft=N_FFT, hop_length=HOP, **kw)
    assert got.shape == ref.shape == Y.shape
    assert max_rel(got, ref) <= 1e-5


def test_harmonic_one_clip_and_default_hop():
    y = Y[0, : SR // 2]
    assert max_rel(tap.harmonic(y, n_fft=1024), jap.harmonic(y, n_fft=1024)) <= 1e-5


def _objective(S, W, H):
    return float(np.linalg.norm(np.asarray(S, np.float64) - to_np(W).astype(np.float64)
                                @ to_np(H).astype(np.float64)))


@pytest.mark.parametrize("n_iter", [1, 10, 200])
def test_nmf_matches_jax(n_iter):
    S = S_MAG[0]
    W, H = tap.decompose(S, n_components=4, n_iter=n_iter, seed=3)
    Wj, Hj = jap.decompose(S, n_components=4, n_iter=n_iter, seed=3)
    assert W.shape == (S.shape[0], 4) and H.shape == (4, S.shape[1])
    assert max_rel(W, Wj) <= 2e-5 and max_rel(H, Hj) <= 2e-5


def test_nmf_objective_is_monotone():
    S = S_MAG[1]
    objs = [_objective(S, *tap.decompose(S, n_components=6, n_iter=n, seed=1)) for n in range(1, 41)]
    assert all(b <= a * (1 + 1e-6) for a, b in zip(objs, objs[1:]))
    assert objs[-1] < objs[0]


def test_nmf_recovers_planted_factors():
    rng = np.random.default_rng(5)
    W0 = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    H0 = rng.uniform(0, 1, (3, 60)).astype(np.float32)
    S = W0 @ H0
    W, H = tap.decompose(S, n_components=3, n_iter=2000, seed=0)
    assert _objective(S, W, H) / np.linalg.norm(S) < 1e-2


@pytest.mark.parametrize("fit_W", [False, True])
def test_nmf_with_templates_matches_jax(fit_W):
    S = S_MAG[0]
    W_t = np.abs(signals(82, (S.shape[0], 5)))
    W, H = tap.decompose(S, n_components=5, n_iter=50, W=W_t, fit_W=fit_W, seed=2)
    Wj, Hj = jap.decompose(S, n_components=5, n_iter=50, W=W_t, fit_W=fit_W, seed=2)
    if not fit_W:
        np.testing.assert_array_equal(to_np(W), W_t)
    assert max_rel(W, Wj) <= 2e-5 and max_rel(H, Hj) <= 2e-5


def test_nmf_errors_match_jax():
    for args, kw in (((S_MAG,), {}), ((-S_MAG[0],), {}), ((S_MAG[0],), dict(W=np.ones((3, 8))))):
        with pytest.raises(ValueError) as e_port:
            tap.decompose(*args, **kw)
        with pytest.raises(ValueError) as e_jax:
            jap.decompose(*args, **kw)
        assert str(e_port.value) == str(e_jax.value)
