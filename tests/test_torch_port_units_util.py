"""PyTorch port: units, signals, util and the convert extras against the
JAX package.

``units`` is host NumPy in both packages: the same arrays, exactly. The
test signals are host float64 waveforms rounded to float32, the same bits
as the JAX package's. The util ops are elementwise or reductions: the same
values (``normalize`` within 1e-6 relative), and ``peak_pick`` the same
indices (`NUMERICAL_ACCURACY.md`: onset peak picking index-equal). Mu-law
codes equal the JAX package's except at float32 bin edges, at most 1% of
codes one off (`NUMERICAL_ACCURACY.md`: mu-law companding); perceptual
weighting within the dB contract, 2e-6 of max.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_port_util import max_rel, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap

F_GRID = np.array([0.0, 20.0, 100.0, 440.0, 1000.0, 4000.0, 11025.0, 16000.0])

UNIT_CASES = [
    ("frames_to_samples", (np.arange(10),), dict(hop_length=256, n_fft=1024)),
    ("samples_to_frames", (np.arange(0, 5000, 333),), dict(hop_length=256, n_fft=1024)),
    ("frames_to_time", (np.arange(10),), dict(sr=16000, hop_length=160)),
    ("time_to_frames", (np.linspace(0, 3, 17),), dict(sr=22050, hop_length=512, n_fft=2048)),
    ("samples_to_time", (np.arange(0, 50000, 777),), dict(sr=44100)),
    ("time_to_samples", (np.linspace(0, 2, 9),), dict(sr=22050)),
    ("fft_frequencies", (), dict(sr=16000, n_fft=512)),
    ("mel_frequencies", (), dict(n_mels=40, fmin=20.0, fmax=8000.0)),
    ("mel_frequencies", (), dict(n_mels=40, fmin=20.0, fmax=8000.0, htk=True)),
    ("tempo_frequencies", (384,), dict(hop_length=512, sr=22050)),
    ("fourier_tempo_frequencies", (), dict(sr=22050, win_length=384, hop_length=512)),
    ("midi_to_hz", (np.arange(0, 128, 7),), {}),
    ("hz_to_midi", (F_GRID,), {}),
    ("note_to_midi", (["C4", "A#3", "Bb-1", "A4+25", "C♯5", "E𝄫2"],), {}),
    ("note_to_midi", (["A4+25", "G#2-30"],), dict(round_midi=False)),
    ("midi_to_note", (np.array([21, 60, 61.4, 69, 108]),), dict(cents=True)),
    ("midi_to_note", (np.array([60, 61, 70]),), dict(octave=False, unicode=False)),
    ("note_to_hz", (["A4", "C1", "F#6"],), {}),
    ("hz_to_note", (np.array([27.5, 261.63, 440.0, 3951.07]),), {}),
    ("A_weighting", (F_GRID,), {}),
    ("B_weighting", (F_GRID,), dict(min_db=None)),
    ("C_weighting", (F_GRID,), {}),
    ("D_weighting", (F_GRID,), dict(min_db=-40.0)),
    ("frequency_weighting", (F_GRID,), dict(kind="Z")),
    ("frequency_weighting", (F_GRID,), dict(kind="C")),
]


@pytest.mark.parametrize("name,args,kw", UNIT_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(UNIT_CASES)])
def test_units_equal(name, args, kw):
    got = getattr(tap.units, name)(*args, **kw)
    ref = getattr(jap.units, name)(*args, **kw)
    assert isinstance(got, type(ref))
    np.testing.assert_array_equal(got, ref)


def test_units_surface_and_errors():
    assert tap.units.__all__ == jap.units.__all__
    for fn, arg in (("note_to_midi", "H4"), ("frequency_weighting", F_GRID)):
        kw = dict(kind="Q") if fn == "frequency_weighting" else {}
        with pytest.raises(ValueError) as jerr:
            getattr(jap.units, fn)(arg, **kw)
        with pytest.raises(ValueError) as terr:
            getattr(tap.units, fn)(arg, **kw)
        assert str(terr.value) == str(jerr.value)


SIGNAL_CASES = [
    ("tone", dict(frequency=440.0, sr=22050, duration=0.5)),
    ("tone", dict(frequency=97.3, sr=16000, length=4001, phi=0.3)),
    ("chirp", dict(fmin=110.0, fmax=3520.0, sr=22050, duration=1.0)),
    ("chirp", dict(fmin=200.0, fmax=2000.0, sr=16000, length=9000, linear=True)),
    ("clicks", dict(times=np.arange(0.25, 3.0, 0.5), sr=22050, length=3 * 22050)),
    ("clicks", dict(frames=np.array([0, 10, 30, 31]), hop_length=256, click_freq=2000.0)),
    ("clicks", dict(times=[0.0, 0.1], sr=8000, click=np.hanning(31), length=2000)),
]


@pytest.mark.parametrize("name,kw", SIGNAL_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SIGNAL_CASES)])
def test_signals_same_bits(name, kw):
    got = getattr(tap, name)(**kw)
    ref = getattr(jap, name)(**kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_signal_errors_match():
    for name, kw in (("tone", dict(frequency=-1.0, duration=1.0)),
                     ("chirp", dict(fmin=100.0, fmax=200.0)),
                     ("clicks", {})):
        with pytest.raises(ValueError) as jerr:
            getattr(jap, name)(**kw)
        with pytest.raises(ValueError) as terr:
            getattr(tap, name)(**kw)
        assert str(terr.value) == str(jerr.value)


X = signals(70, (6, 40))
X[2] = 0.0  # a silent row: below the threshold


@pytest.mark.parametrize("norm", [np.inf, -np.inf, 0, 1, 2, 3.5, None])
@pytest.mark.parametrize("axis", [0, 1, None])
@pytest.mark.parametrize("fill", [None, False, True])
def test_normalize_matches(norm, axis, fill):
    if norm == 0 and fill is True:
        for pkg in (jap, tap):
            with pytest.raises(ValueError, match="norm=0 and fill=True"):
                pkg.util.normalize(X, norm=norm, axis=axis, fill=fill)
        return
    got = tap.util.normalize(X, norm=norm, axis=axis, fill=fill)
    ref = jap.util.normalize(X, norm=norm, axis=axis, fill=fill)
    assert got.shape == ref.shape
    np.testing.assert_allclose(to_np(got), to_np(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fn", ["localmax", "localmin"])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_local_extrema_equal(fn, axis):
    x = np.round(signals(71, (5, 64)), 1)  # rounding makes ties
    np.testing.assert_array_equal(to_np(getattr(tap.util, fn)(x, axis=axis)),
                                  to_np(getattr(jap.util, fn)(x, axis=axis)))


@pytest.mark.parametrize("size,kw", [
    (30, {}), (64, {}), (100, {}), (100, dict(mode="edge")), (150, dict(mode="reflect")),
    (300, dict(mode="reflect")), (90, dict(mode="constant", constant_values=2.5)),
])
@pytest.mark.parametrize("axis", [-1, 0])
def test_fix_length_equal(size, kw, axis):
    x = signals(72, (64, 64))
    got = tap.util.fix_length(x, size, axis=axis, **kw)
    np.testing.assert_array_equal(to_np(got), to_np(jap.util.fix_length(x, size, axis=axis, **kw)))


@pytest.mark.parametrize("threshold,pad", [(1e-10, True), (0.5, False), (0.0, True)])
def test_zero_crossings_equal(threshold, pad):
    y = signals(73, (3, 500))
    y[0, 100:120] = 0.0
    np.testing.assert_array_equal(to_np(tap.util.zero_crossings(y, threshold=threshold, pad=pad)),
                                  to_np(jap.util.zero_crossings(y, threshold=threshold, pad=pad)))


@pytest.mark.parametrize("pre_max,post_max,pre_avg,post_avg,delta,wait", [
    (1, 1, 4, 5, 0.07, 1), (3, 3, 3, 5, 0.5, 10), (0, 1, 0, 1, 0.0, 0), (5, 2, 10, 10, 0.1, 4),
])
def test_peak_pick_index_equal(pre_max, post_max, pre_avg, post_avg, delta, wait):
    x = np.abs(signals(74, (1000,)))
    args = (pre_max, post_max, pre_avg, post_avg, delta, wait)
    got, ref = tap.util.peak_pick(x, *args), jap.util.peak_pick(x, *args)
    assert got.size > 10
    np.testing.assert_array_equal(got, ref)


def test_util_surface_and_errors():
    assert tap.util.__all__ == jap.util.__all__
    for args in ((X[0], -1, 1, 1, 1, 0.1, 1), (X[0], 1, 0, 1, 1, 0.1, 1),
                 (X, 1, 1, 1, 1, 0.1, 1), (X[0], 1, 1, 1, 1, -0.1, 1)):
        with pytest.raises(ValueError) as jerr:
            jap.util.peak_pick(*args)
        with pytest.raises(ValueError) as terr:
            tap.util.peak_pick(*args)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("mu", [255.0, 15.0])
@pytest.mark.parametrize("quantize", [True, False])
def test_mu_law_matches(mu, quantize):
    x = np.clip(signals(75, (2, 4000)) / 3.0, -1.2, 1.2)
    got = tap.mu_compress(x, mu=mu, quantize=quantize)
    ref = np.asarray(jap.mu_compress(x, mu=mu, quantize=quantize))
    if quantize:
        assert got.dtype == torch.int32
        off = np.abs(got.numpy().astype(np.int64) - ref)
        assert off.max() <= 1 and np.count_nonzero(off) <= 0.01 * off.size
    else:
        assert max_rel(got, ref) <= 1e-6
    back = tap.mu_expand(ref, mu=mu, quantize=quantize)
    assert max_rel(back, jap.mu_expand(ref, mu=mu, quantize=quantize)) <= 1e-6


@pytest.mark.parametrize("kind", ["A", "B", "C", "D", "Z"])
def test_perceptual_weighting_matches(kind):
    S = np.abs(signals(76, (2, 40, 30))) ** 2
    f = tap.units.mel_frequencies(40, fmax=8000.0)
    got = tap.perceptual_weighting(S, f, kind=kind, top_db=60.0)
    ref = jap.perceptual_weighting(S, f, kind=kind, top_db=60.0)
    assert max_rel(got, ref) <= 2e-6


def test_convert_extras_errors_match():
    for fn, args, kw in ((tap.mu_compress, (X,), dict(mu=0)), (tap.mu_expand, (X,), dict(mu=-1)),
                         (tap.perceptual_weighting, (X, F_GRID), {})):
        with pytest.raises(ValueError) as jerr:
            np.asarray(getattr(jap, fn.__name__)(*args, **kw))
        with pytest.raises(ValueError) as terr:
            fn(*args, **kw)
        assert str(terr.value) == str(jerr.value)
