"""PyTorch port: the reassigned spectrogram and harmonic interpolation /
salience against the JAX package.

Contracts (`NUMERICAL_ACCURACY.md`, reassigned_spectrogram row):

* ``reassigned_spectrogram`` against the JAX package: ``mags`` within
  1e-6 of max; NaN cells (power at or below ``ref_power``) equal; on the
  cells within 50 dB of the clip's peak the reassigned frequency within
  0.05 Hz and time within 1e-5 s. Cells far below the peak divide two
  small STFTs, so their coordinates follow the last bits of two float32
  transforms (0.12 Hz apart at 60 dB under a Hamming window, Hz apart
  near ``ref_power``) and are not compared;
* its physics on the port alone: an off-bin tone's cells reassign to the
  tone within 0.05 Hz, a click's to its instant within 2e-3 s, on the
  plain and the kernel route;
* ``interp_harmonics`` and ``salience`` equal the JAX package's (the same
  host plan, two gathers and a lerp), NaN matching NaN.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
from torch_port_util import max_rel, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch.utils import dispatch as tap_dispatch

jh = importlib.import_module("mlx_audio_primitives_tpu.ops.harmonics")
th = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.harmonics")

torch.set_num_threads(1)

SR, N_FFT, HOP = 22050, 512, 128
T = np.arange(SR) / SR
TONE_CLICK = np.stack([
    np.sin(2 * np.pi * 1000.3 * T) + 0.3 * np.sin(2 * np.pi * 2345.6 * T),
    0.5 * np.sin(2 * np.pi * 523.1 * T) + 0.05 * signals(100, (SR,)),
]).astype(np.float32)
TONE_CLICK[0, SR // 2] += 4.0


@pytest.fixture(params=["plain", "kernels"])
def port_route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setattr(tap_dispatch, "kernel_route", lambda flag, device: flag is not False)
    return request.param


REASSIGN_CASES = {
    "default": {},
    "no-center": dict(center=False),
    "hamming-400": dict(window="hamming", win_length=400),
    "no-clip": dict(clip=False, ref_power=1e-3),
    "matmul": dict(fft_mode="matmul"),
}


@pytest.mark.parametrize("case", list(REASSIGN_CASES))
@pytest.mark.parametrize("batched", [True, False])
def test_reassigned_spectrogram_matches_jax(case, batched):
    kw = REASSIGN_CASES[case]
    y = TONE_CLICK if batched else TONE_CLICK[0]
    got = [to_np(a) for a in tap.reassigned_spectrogram(y, sr=SR, n_fft=N_FFT, hop_length=HOP, **kw)]
    ref = [np.asarray(a) for a in jap.reassigned_spectrogram(y, sr=SR, n_fft=N_FFT, hop_length=HOP,
                                                            **kw)]
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == np.float32
    assert max_rel(got[2], ref[2]) <= 1e-6
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(ref[0]))
    np.testing.assert_array_equal(np.isnan(got[1]), np.isnan(ref[1]))
    mags = ref[2]
    peak = mags.max(axis=(-2, -1), keepdims=True)
    strong = mags > 10 ** (-50 / 20) * peak
    assert np.abs(got[0] - ref[0])[strong].max() <= 0.05
    assert np.abs(got[1] - ref[1])[strong].max() <= 1e-5


def test_reassign_tone_and_click_physics(port_route):
    f0 = 440.7  # off the bin centres (43.07 Hz apart)
    y = np.sin(2 * np.pi * f0 * T).astype(np.float32)
    freqs, _, mags = (to_np(a) for a in tap.reassigned_spectrogram(y, sr=SR, n_fft=N_FFT,
                                                                   hop_length=HOP))
    k = int(round(f0 / (SR / N_FFT)))
    for kk in (k - 1, k, k + 1):
        assert abs(np.nanmedian(freqs[kk, 8:-8]) - f0) <= 0.05
    click = np.zeros(SR, np.float32)
    click[11025] = 1.0
    _, times, _ = (to_np(a) for a in tap.reassigned_spectrogram(click, sr=SR, n_fft=N_FFT,
                                                                hop_length=HOP, ref_power=1e-10))
    for fr in (85, 86, 87, 88):  # frames whose window covers the click
        assert abs(np.nanmedian(times[20:230, fr]) - 0.5) <= 2e-3


def test_reassign_errors_match_jax():
    for kw in (dict(ref_power=-1.0), dict(hop_length=0), dict(n_fft=0)):
        with pytest.raises(ValueError) as e_port:
            tap.reassigned_spectrogram(TONE_CLICK[0], **kw)
        with pytest.raises(ValueError) as e_jax:
            jap.reassigned_spectrogram(TONE_CLICK[0], **kw)
        assert str(e_port.value) == str(e_jax.value)


S = np.abs(np.asarray(jap.stft(TONE_CLICK, n_fft=N_FFT, hop_length=HOP)))
FREQS = np.linspace(0, SR / 2, N_FFT // 2 + 1)
LOG_FREQS = 55.0 * 2.0 ** (np.arange(60) / 12.0)


@pytest.mark.parametrize("kw", [{}, dict(harmonics=(0.5, 1, 1.5, 2, 3)), dict(fill_value=-1.0)],
                         ids=["default", "fractional", "fill"])
@pytest.mark.parametrize("batched", [True, False])
def test_interp_harmonics_matches_jax(kw, batched):
    x = S if batched else S[0]
    got = th.interp_harmonics(x, FREQS, **kw)
    ref = np.asarray(jap.interp_harmonics(x, FREQS, **kw))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(to_np(got), ref)


def test_interp_harmonics_on_a_log_grid_and_plan_matches_jax():
    x = np.abs(signals(101, (60, 7)))
    np.testing.assert_array_equal(to_np(th.interp_harmonics(x, LOG_FREQS)),
                                  np.asarray(jap.interp_harmonics(x, LOG_FREQS)))
    key = (tuple(FREQS.tolist()), (1.0, 2.0, 3.5))
    for a, b in zip(th._interp_plan(*key), jh._interp_plan(*key)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [{}, dict(weights=(1.0, 0.5, 0.33, 0.25)), dict(filter_peaks=False),
                                dict(fill_value=0.0, harmonics=(1, 2))],
                         ids=["default", "weights", "no-peaks", "fill0"])
def test_salience_matches_jax(kw):
    got = to_np(tap.salience(S, FREQS, **kw))
    ref = np.asarray(jap.salience(S, FREQS, **kw))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert np.abs(got[ok] - ref[ok]).max() <= 1e-6 * np.abs(ref[ok]).max()


def test_harmonics_errors_match_jax():
    for fn in (
        lambda m: m.interp_harmonics(S[0, 0], FREQS),
        lambda m: m.interp_harmonics(S, FREQS[:-1]),
        lambda m: m.interp_harmonics(S, FREQS[::-1]),
        lambda m: m.salience(S, FREQS, weights=(1.0, 2.0)),
    ):
        with pytest.raises(ValueError) as e_port:
            fn(tap)
        with pytest.raises(ValueError) as e_jax:
            fn(jap)
        assert str(e_port.value) == str(e_jax.value)
