"""PyTorch port: the chroma family against the JAX package.

``chroma_stft`` of a signal runs, on the port's kernel route, the fused
filterbank kernel (K1) with the ``(n_bins, 12)`` chroma weight; on the CPU
its wrapper runs K1's plain twin (the kernel routes are forced on by
patching ``kernel_route``). Contract (`NUMERICAL_ACCURACY.md`:
chromagram fused vs XLA ~2e-6): both port routes, the kernel route with
K1's exact contraction (``ANALYSIS_FAST_GEMM`` off), and the ``S`` route
(one FP32 product), within 2e-6 of max of the JAX package's XLA route; the
port's default kernel route (the bf16x3 contraction) against the JAX
package's Pallas route (interpret mode, 3-pass bf16-split products at
~2.7e-5) within the mel contract, 1e-4. The CQT/VQT chroma, tonnetz and
CENS within 2e-6 of max (the CQT row allows 3e-5 abs + 2e-4 rel; the
chroma fold and per-frame norm add nothing measurable).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_port_util import max_rel, signals

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch import _config as tap_config
from mlx_audio_primitives_tpu_torch.ops import mel as tap_mel
from mlx_audio_primitives_tpu_torch.utils import dispatch as tap_dispatch

torch.set_num_threads(1)

CHROMA_TOL = 2e-6  # relative to max
SR = 22050
KW = dict(n_fft=2048, hop_length=512)
Y = signals(80, (2, 3 * SR))
Y1 = signals(81, (SR,))
CQ = dict(fmin=110.0, n_bins=36)  # n_fft 4096 at hop 512


def _harmonic(f0s, n=2 * SR):
    t = np.arange(n) / SR
    y = sum(np.sin(2 * np.pi * k * f * t) / k for f in f0s for k in range(1, 4))
    return (y / np.abs(y).max()).astype(np.float32)


@pytest.fixture(params=["plain", "kernels"])
def port_route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setattr(tap_dispatch, "kernel_route",
                            lambda flag, device: flag is not False)
        # the exact contraction, whose class the XLA route's 2e-6 is
        monkeypatch.setattr(tap_config, "ANALYSIS_FAST_GEMM", False)
    return request.param


@pytest.mark.parametrize("kw", [
    {}, dict(power=1.0), dict(tuning=0.3), dict(power=1.0, tuning=-0.2, norm=2.0),
    dict(n_chroma=24, base_c=False, octwidth=None), dict(norm=None, ctroct=4.0),
], ids=["default", "p1", "tuned", "p1-tuned-l2", "24-unweighted", "raw"])
def test_chroma_stft_y_matches_jax(kw, port_route, monkeypatch):
    calls = []
    real = tap_mel.melspectrogram_fused

    def spy(y, win, fb_t, **k):
        calls.append((tuple(fb_t.shape), k["power"]))
        return real(y, win, fb_t, **k)

    monkeypatch.setattr(tap_mel, "melspectrogram_fused", spy)
    got = tap.chroma_stft(y=Y, **KW, **kw)
    ref = jap.chroma_stft(y=Y, use_pallas=False, **KW, **kw)
    assert got.shape == ref.shape
    assert max_rel(got, ref) <= CHROMA_TOL
    # the kernel route takes K1 once, with the (n_bins, n_chroma) weight
    n_chroma = kw.get("n_chroma", 12)
    expect = [((KW["n_fft"] // 2 + 1, n_chroma), kw.get("power", 2.0))]
    assert calls == (expect if port_route == "kernels" else [])


@pytest.mark.parametrize("power", [2.0, 1.0])
def test_chroma_stft_matches_jax_pallas(power):
    ref = jap.chroma_stft(y=Y1, power=power, use_pallas=True, **KW)
    for up in (None, True):
        got = tap.chroma_stft(y=Y1, power=power, use_pallas=up, **KW)
        assert max_rel(got, ref) <= 1e-4


@pytest.mark.parametrize("ndim", [2, 3])
def test_chroma_stft_S_matches_jax(ndim):
    S = np.abs(np.asarray(jap.stft(Y if ndim == 3 else Y[0], **KW))) ** 2
    got = tap.chroma_stft(S=S, **KW)
    ref = jap.chroma_stft(S=S, **KW)
    assert got.shape == ref.shape and max_rel(got, ref) <= CHROMA_TOL


def test_chroma_stft_finds_the_pitch_class():
    # A3 and E4 (A and E, classes 9 and 4 from C): the two strongest rows
    C = tap.chroma_stft(y=_harmonic([220.0, 329.63]), **KW).numpy()
    assert set(np.argsort(C.mean(axis=1))[-2:]) == {9, 4}


@pytest.mark.parametrize("name,kw", [
    ("chroma_cqt", {}), ("chroma_cqt", dict(norm=2.0, base_c=False, tuning=0.1)),
    ("chroma_vqt", {}), ("chroma_vqt", dict(gamma=0.0, bins_per_octave=24, n_bins=72)),
], ids=["cqt", "cqt-l2-a", "vqt", "vqt-24"])
def test_cq_chroma_matches_jax(name, kw):
    got = getattr(tap, name)(Y, sr=SR, **{**CQ, **kw})
    ref = getattr(jap, name)(Y, sr=SR, **{**CQ, **kw})
    assert got.shape == ref.shape and max_rel(got, ref) <= CHROMA_TOL


@pytest.mark.parametrize("source", ["chroma", "y"])
def test_tonnetz_matches_jax(source):
    if source == "chroma":
        chroma = np.asarray(jap.chroma_stft(y=Y, **KW))
        got, ref = tap.tonnetz(chroma=chroma), jap.tonnetz(chroma=chroma)
    else:
        got, ref = tap.tonnetz(y=Y1, sr=SR, **CQ), jap.tonnetz(y=Y1, sr=SR, **CQ)
    assert got.shape == ref.shape and max_rel(got, ref) <= CHROMA_TOL


@pytest.mark.parametrize("kw", [{}, dict(win_len_smooth=None), dict(win_len_smooth=10),
                                dict(smoothing_window="hamming", win_len_smooth=7)],
                         ids=["41", "none", "10", "hamming-7"])
def test_chroma_cens_matches_jax(kw):
    chroma = np.asarray(jap.chroma_cqt(Y, sr=SR, norm=None, **CQ))
    got, ref = tap.chroma_cens(chroma=chroma, **kw), jap.chroma_cens(chroma=chroma, **kw)
    assert got.shape == ref.shape and max_rel(got, ref) <= CHROMA_TOL


def test_chroma_cens_from_y_matches_jax():
    got, ref = tap.chroma_cens(y=Y1, sr=SR, **CQ), jap.chroma_cens(y=Y1, sr=SR, **CQ)
    assert got.shape == ref.shape and max_rel(got, ref) <= CHROMA_TOL


def test_octave_converters_equal():
    f = np.array([0.0, 27.5, 110.0, 440.0, 1000.0])
    for tuning in (0.0, 0.25):
        o = tap.ops.chroma.hz_to_octs(f, tuning=tuning)
        np.testing.assert_array_equal(o, jap.ops.chroma.hz_to_octs(f, tuning=tuning))
        np.testing.assert_array_equal(tap.ops.chroma.octs_to_hz(o[1:], tuning=tuning),
                                      jap.ops.chroma.octs_to_hz(o[1:], tuning=tuning))


@pytest.mark.parametrize("call", [
    lambda m: m.chroma_stft(sr=SR),
    lambda m: m.chroma_stft(S=np.ones((100, 4), np.float32), n_fft=2048),
    lambda m: m.chroma_filterbank(SR, 0),
    lambda m: m.tonnetz(),
    lambda m: m.chroma_cens(chroma=np.ones(12, np.float32)),
    lambda m: m.chroma_cqt(Y1, sr=SR, fmin=110.0, bins_per_octave=12, n_chroma=5),
    lambda m: m.chroma_cqt(Y1, sr=SR, fmin=3000.0, n_bins=48),
], ids=["no-input", "S-bins", "n_fft", "tonnetz-none", "cens-1d", "fold", "nyquist"])
def test_chroma_errors_match(call):
    with pytest.raises(ValueError) as jerr:
        np.asarray(call(jap))
    with pytest.raises(ValueError) as terr:
        call(tap)
    assert str(terr.value) == str(jerr.value)
