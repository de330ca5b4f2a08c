"""PyTorch port: the tempogram, tempo and the Fourier tempogram against the
JAX package.

The tempogram pads the envelope with NumPy's ``linear_ramp`` mode (written
out in the port: torch has no such mode), weights its frames with
``np.hanning`` and takes each frame's autocorrelation through ``|rfft|^2``
and the inverse. Contracts (`NUMERICAL_ACCURACY.md`: tempo / tempogram):
the tempogram and the Fourier tempogram within 1e-5 of max; ``tempo``
equal, on click tracks at known tempi and on noise envelopes, per clip and
per frame.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_port_util import max_rel, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch.ops.rhythm import _linear_ramp_pad

torch.set_num_threads(1)

TG_TOL = 1e-5  # relative to max
SR = 22050


def _click_envelope(bpm: float, seconds: float = 12.0) -> np.ndarray:
    y = np.asarray(jap.clicks(times=np.arange(0.2, seconds - 0.1, 60.0 / bpm), sr=SR,
                              length=int(seconds * SR)))
    return np.asarray(jap.onset_strength(y, sr=SR))


ENVS = {
    "clicks-96": _click_envelope(96.0),
    "clicks-128": _click_envelope(128.0),
    "noise": np.abs(signals(110, (400,))),
    "noise-batch": np.abs(signals(111, (3, 300))),
}


@pytest.mark.parametrize("before,after", [(0, 0), (1, 0), (0, 1), (5, 4), (192, 191), (7, 7)])
def test_linear_ramp_pad_equals_numpy(before, after):
    x = signals(112, (2, 30))
    got = _linear_ramp_pad(torch.from_numpy(x), before, after)
    ref = np.pad(x, ((0, 0), (before, after)), mode="linear_ramp", end_values=0.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", list(ENVS))
@pytest.mark.parametrize("win_length", [384, 97, 64])
def test_tempogram_matches_jax(case, win_length):
    got = tap.tempogram(onset_envelope=ENVS[case], win_length=win_length)
    ref = jap.tempogram(onset_envelope=ENVS[case], win_length=win_length)
    assert got.shape == ref.shape and max_rel(got, ref) <= TG_TOL


def test_tempogram_from_y_matches_jax():
    y = signals(113, (2, 4 * SR))
    got, ref = tap.tempogram(y=y, sr=SR, win_length=128), jap.tempogram(y=y, sr=SR, win_length=128)
    assert got.shape == ref.shape and max_rel(got, ref) <= TG_TOL


@pytest.mark.parametrize("case", list(ENVS))
@pytest.mark.parametrize("kw", [{}, dict(start_bpm=90.0, std_bpm=0.5, ac_size=4.0),
                                dict(max_tempo=None), dict(aggregate=False)],
                         ids=["default", "prior", "no-max", "per-frame"])
def test_tempo_equal(case, kw):
    got = tap.tempo(onset_envelope=ENVS[case], sr=SR, **kw)
    ref = jap.tempo(onset_envelope=ENVS[case], sr=SR, **kw)
    assert isinstance(got, np.ndarray) and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bpm", [96.0, 128.0])
def test_tempo_of_clicks(bpm):
    est = float(tap.tempo(onset_envelope=ENVS[f"clicks-{int(bpm)}"], sr=SR)[0])
    assert abs(est / bpm - 1.0) < 0.03


@pytest.mark.parametrize("case", ["clicks-96", "noise-batch"])
@pytest.mark.parametrize("kw", [{}, dict(win_length=100, center=False),
                                dict(window="hamming", win_length=64)],
                         ids=["default", "uncentered-100", "hamming-64"])
def test_fourier_tempogram_matches_jax(case, kw):
    got = tap.fourier_tempogram(onset_envelope=ENVS[case], **kw)
    ref = jap.fourier_tempogram(onset_envelope=ENVS[case], **kw)
    assert got.shape == ref.shape and max_rel(got, ref) <= TG_TOL


def test_tempo_frequencies_equal():
    for args in ((384,), (100, 256, 16000)):
        np.testing.assert_array_equal(tap.tempo_frequencies(*args),
                                      jap.tempo_frequencies(*args))


@pytest.mark.parametrize("call", [
    lambda m: m.tempogram(),
    lambda m: m.tempogram(onset_envelope=ENVS["noise"], win_length=0),
    lambda m: m.tempo(onset_envelope=ENVS["noise"], std_bpm=0.0),
    lambda m: m.fourier_tempogram(),
], ids=["no-input", "win", "std", "fourier-no-input"])
def test_rhythm_errors_match(call):
    with pytest.raises(ValueError) as jerr:
        to_np(call(jap))
    with pytest.raises(ValueError) as terr:
        call(tap)
    assert str(terr.value) == str(jerr.value)
