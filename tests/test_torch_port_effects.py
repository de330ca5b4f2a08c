"""PyTorch port: the phase vocoder, time stretch, pitch shift and the
silence tools (trim / split / remix) against the JAX package.

Contracts (`NUMERICAL_ACCURACY.md`, phase_vocoder and trim/split rows):

* ``phase_vocoder``: magnitude within 2e-5 of max against the JAX package
  on the same spectrum, the complex field within 1e-4 of max (the phase is
  the same float32 sum in the same order), and against a float64
  per-frame recurrence (librosa's loop) on a short input within 2e-5 in
  magnitude and 1e-5 in the field; its host tables equal the JAX
  package's bit for bit, and tables carried across through
  ``tables_from_numpy`` give the same spectrum as the port's own;
* ``time_stretch`` and ``pitch_shift`` against the JAX package within 1e-5
  of max, on the plain route and on the kernel route (twins on the CPU).
  The signals carry energy in every bin: the vocoder accumulates each
  bin's phase through every frame, so where a bin passes through
  near-silence its phase, and the stretched signal after it, follows the
  last bits of the input spectrum (two float32 STFTs give outputs ~10% of
  max apart on a tone with clicks);
* the stretched spectrum's DC and Nyquist bins are not real; ``istft``
  drops those imaginary parts on both routes, as the JAX package does;
* ``trim`` and ``split``: index-equal to the JAX package and to an rms +
  dB formulation in float64.
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
from mlx_audio_primitives_tpu_torch.utils.interop import tables_from_numpy

je = importlib.import_module("mlx_audio_primitives_tpu.ops.effects")
te = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.effects")

torch.set_num_threads(1)

SR = 22050
N_FFT, HOP = 512, 128
Y = signals(90, (2, SR))
D = np.asarray(jap.stft(Y, n_fft=N_FFT, hop_length=HOP))


@pytest.fixture(params=["plain", "kernels"])
def port_route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setattr(tap_dispatch, "resolve_use_pallas", lambda flag, device: flag is not False)
    return request.param


def pv_oracle(D: np.ndarray, rate: float, hop: int) -> np.ndarray:
    """librosa's sequential phase vocoder in float64 (one clip)."""
    n_bins, F = D.shape
    steps = np.arange(0, F, rate)
    Dp = np.pad(D.astype(np.complex128), ((0, 0), (0, 2)))
    phi = np.linspace(0, np.pi * hop, n_bins)
    acc = np.angle(Dp[:, 0])
    out = np.zeros((n_bins, len(steps)), np.complex128)
    for t, step in enumerate(steps):
        c = Dp[:, int(step) : int(step) + 2]
        a = step - int(step)
        out[:, t] = ((1 - a) * np.abs(c[:, 0]) + a * np.abs(c[:, 1])) * np.exp(1j * acc)
        dp = np.angle(c[:, 1]) - np.angle(c[:, 0]) - phi
        acc += phi + dp - 2 * np.pi * np.round(dp / (2 * np.pi))
    return out


@pytest.mark.parametrize("rate", [0.5, 0.8, 1.0, 1.25, 2.0])
@pytest.mark.parametrize("batched", [True, False])
def test_phase_vocoder_matches_jax(rate, batched):
    S = D if batched else D[0]
    got = tap.phase_vocoder(S, rate, hop_length=HOP)
    ref = np.asarray(jap.phase_vocoder(S, rate, hop_length=HOP))
    assert got.shape == ref.shape and got.dtype == torch.complex64
    assert got.shape[-1] == int(np.ceil(D.shape[-1] / rate))
    assert max_rel(got.abs(), np.abs(ref)) <= 2e-5
    assert max_rel(got, ref) <= 1e-4


@pytest.mark.parametrize("rate", [0.8, 1.25])
def test_phase_vocoder_matches_the_float64_recurrence(rate):
    S = D[0, :, :40]
    got = to_np(tap.phase_vocoder(S, rate, hop_length=HOP))
    ref = pv_oracle(S, rate, HOP)
    assert max_rel(np.abs(got), np.abs(ref)) <= 2e-5
    assert max_rel(got, ref) <= 1e-5


def test_phase_vocoder_tables_match_jax_and_carry_across():
    args = (D.shape[1], D.shape[2], HOP, 0.8)
    mine, theirs = te._pv_tables(*args), je._pv_tables(*args)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    idx, alpha, phi, linear = theirs
    carried = tables_from_numpy({"alpha": alpha, "phi": phi, "linear": linear})
    got = te._pv_core(torch.from_numpy(D), torch.from_numpy(idx.astype(np.int64)),
                      carried["alpha"], carried["phi"], carried["linear"])
    np.testing.assert_array_equal(to_np(got), to_np(tap.phase_vocoder(D, 0.8, hop_length=HOP)))


@pytest.mark.parametrize("rate", [0.8, 1.25])
@pytest.mark.parametrize("kw", [{}, dict(center=False), dict(win_length=400, window="hamming")],
                         ids=["default", "no-center", "hamming-400"])
def test_time_stretch_matches_jax(rate, kw, port_route):
    got = tap.time_stretch(Y, rate, n_fft=N_FFT, hop_length=HOP, **kw)
    ref = jap.time_stretch(Y, rate, n_fft=N_FFT, hop_length=HOP, **kw)
    assert got.shape == ref.shape == (2, int(round(SR / rate)))
    # without the centre pad the first samples lie under one frame's window
    # edge, where the envelope is below 1e-3 (29 samples of a 512-point
    # Hann) and the division amplifies rounding: compared from sample 32
    edge = 0 if kw.get("center", True) else N_FFT // 16
    assert max_rel(got[:, edge:], np.asarray(ref)[:, edge:]) <= 1e-5


def test_time_stretch_default_hop_one_clip():
    y = Y[0]
    assert max_rel(tap.time_stretch(y, 1.1, n_fft=1024), jap.time_stretch(y, 1.1, n_fft=1024)) <= 1e-5


@pytest.mark.parametrize("port_route_", ["plain", "kernels"])
def test_istft_drops_stretched_dc_and_nyquist_imaginary_parts(port_route_, monkeypatch):
    if port_route_ == "kernels":
        monkeypatch.setattr(tap_dispatch, "resolve_use_pallas", lambda flag, device: flag is not False)
    Sv = to_np(tap.phase_vocoder(D, 0.8, hop_length=HOP))
    # the accumulated phase of the real DC and Nyquist bins is a multiple
    # of pi whose float32 sine is not 0
    assert np.abs(Sv[:, 0].imag).max() > 1e-6 and np.abs(Sv[:, -1].imag).max() > 1e-6
    Sr = Sv.copy()
    Sr[:, 0] = Sr[:, 0].real
    Sr[:, -1] = Sr[:, -1].real
    L = int(round(SR / 0.8))
    got = tap.istft(Sv, hop_length=HOP, length=L)
    np.testing.assert_array_equal(to_np(got), to_np(tap.istft(Sr, hop_length=HOP, length=L)))
    assert max_rel(got, jap.istft(Sv, hop_length=HOP, length=L)) <= 1e-5


@pytest.mark.parametrize("n_steps", [2, -2, 0.5, -7])
def test_pitch_shift_matches_jax(n_steps, port_route):
    got = tap.pitch_shift(Y, SR, n_steps, n_fft=N_FFT, hop_length=HOP)
    ref = jap.pitch_shift(Y, SR, n_steps, n_fft=N_FFT, hop_length=HOP)
    assert got.shape == ref.shape == Y.shape
    assert max_rel(got, ref) <= 1e-5


def test_pitch_shift_options_and_zero_steps():
    kw = dict(n_fft=N_FFT, hop_length=HOP, bins_per_octave=24, res_type="linear")
    assert max_rel(tap.pitch_shift(Y[0], SR, 3, **kw), jap.pitch_shift(Y[0], SR, 3, **kw)) <= 1e-5
    np.testing.assert_array_equal(to_np(tap.pitch_shift(Y, SR, 0)), Y)


def _gappy(seed: int, n: int = 3) -> np.ndarray:
    """Clips of noise bursts at several levels between silent stretches."""
    rng = np.random.default_rng(seed)
    y = np.zeros((n, 3 * SR), np.float32)
    for b in range(n):
        for s0, s1, amp in ((0.3, 0.9, 1.0), (1.3, 1.5, 0.02), (2.0, 2.6, 1e-3)):
            a, e = int((s0 + 0.05 * b) * SR), int((s1 + 0.03 * b) * SR)
            y[b, a:e] = amp * rng.standard_normal(e - a)
    return y


def _nonsilent_f64(y: np.ndarray, top_db: float, ref, frame_length=2048, hop=512) -> np.ndarray:
    """The rms + dB formulation in float64: per-frame mean square of the
    centred frames against the reference, max over leading axes."""
    y = np.atleast_2d(y.astype(np.float64))
    yp = np.pad(y, ((0, 0), (frame_length // 2, frame_length // 2)))
    frames = np.lib.stride_tricks.sliding_window_view(yp, frame_length, axis=-1)[:, ::hop]
    mse = (frames**2).mean(-1)
    ref_p = mse.max() if ref is None else ref**2
    db = 10 * np.log10(np.maximum(mse, 1e-10) / ref_p)
    return db.max(0) > -top_db


@pytest.mark.parametrize("kw", [{}, dict(top_db=30.0), dict(top_db=80.0, ref=0.5),
                                dict(frame_length=1024, hop_length=256)],
                         ids=["default", "top30", "ref", "frame1024"])
@pytest.mark.parametrize("batched", [True, False])
def test_trim_and_split_match_jax(kw, batched):
    y = _gappy(91) if batched else _gappy(92)[1]
    got_y, got_iv = tap.trim(y, **kw)
    ref_y, ref_iv = jap.trim(y, **kw)
    np.testing.assert_array_equal(got_iv, ref_iv)
    np.testing.assert_array_equal(to_np(got_y), np.asarray(ref_y))
    np.testing.assert_array_equal(tap.split(y, **kw), jap.split(y, **kw))


@pytest.mark.parametrize("top_db", [20.0, 45.0, 60.0])
def test_split_matches_float64_formulation(top_db):
    y = _gappy(93)
    ns = _nonsilent_f64(y, top_db, None)
    edges = np.flatnonzero(np.diff(np.concatenate([[0], ns.astype(np.int8), [0]])))
    ref = np.minimum(edges * 512, y.shape[-1]).reshape(-1, 2)
    np.testing.assert_array_equal(tap.split(y, top_db=top_db), ref)
    start, end = tap.trim(y, top_db=top_db)[1]
    assert (start, end) == (ref[0, 0], ref[-1, 1])


def test_trim_all_silent_and_errors():
    z = np.zeros(5000, np.float32)
    y, iv = tap.trim(z, ref=1.0)
    assert y.shape == (0,) and list(iv) == [0, 0]
    assert tap.split(z, ref=1.0).shape == (0, 2)
    for fn in (tap.trim, tap.split):
        with pytest.raises(ValueError, match="top_db"):
            fn(z, top_db=0.0)


@pytest.mark.parametrize("align_zeros", [True, False])
def test_remix_matches_jax(align_zeros):
    y = Y[:, :4000]
    iv = np.array([[1000, 2000], [0, 500], [3000, 3999], [700, 700]])
    got = tap.remix(y, iv, align_zeros=align_zeros)
    np.testing.assert_array_equal(to_np(got), np.asarray(jap.remix(y, iv, align_zeros=align_zeros)))
    assert tap.remix(y, np.array([[5, 5]])).shape == (2, 0)


def test_errors_match_jax():
    cases = [
        (lambda m: m.phase_vocoder(D, 0.0), None),
        (lambda m: m.phase_vocoder(np.zeros(5, np.complex64), 1.0), None),
        (lambda m: m.time_stretch(Y, -1.0), None),
        (lambda m: m.pitch_shift(Y, 0, 2), None),
        (lambda m: m.remix(Y, np.array([[0, 10 ** 6]])), None),
        (lambda m: m.remix(Y, np.array([0, 10])), None),
    ]
    for fn, _ in cases:
        with pytest.raises(ValueError) as e_port:
            fn(tap)
        with pytest.raises(ValueError) as e_jax:
            fn(jap)
        assert str(e_port.value).split(",")[0] == str(e_jax.value).split(",")[0]
