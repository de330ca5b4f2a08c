"""PyTorch port: onset strength, onset detection and beat tracking against
the JAX package.

``onset_strength`` of a signal takes its mel from ``melspectrogram``: on
the port's kernel route (forced on by patching ``resolve_use_pallas``) the
fused filterbank kernel's twin, once, with the 128-mel weight. Its dB
clip is taken per clip. Contracts (`NUMERICAL_ACCURACY.md`): the envelope
within the mel / dB contracts, here 1e-5 of max; onset peak picking
index-equal; beat frames index-equal with the cumulative score within
1e-3 abs / 1e-4 rel of the JAX package's DP. Click tracks at known tempi
come from ``clicks``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_port_util import max_rel, signals

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu.ops import beat as jax_beat
from mlx_audio_primitives_tpu_torch.ops import beat as tap_beat
from mlx_audio_primitives_tpu_torch.ops import mel as tap_mel
from mlx_audio_primitives_tpu_torch.utils import dispatch as tap_dispatch

torch.set_num_threads(1)

ENV_TOL = 1e-5  # relative to max
SR = 22050
HOP = 512


def click_track(bpm: float, seconds: float = 8.0, offset: float = 0.3) -> np.ndarray:
    """Clicks every 60/bpm s from ``offset``, over noise at 1% (JAX's
    ``clicks``, the default 1 kHz decaying burst)."""
    n = int(seconds * SR)
    y = np.asarray(jap.clicks(times=np.arange(offset, seconds - 0.1, 60.0 / bpm), sr=SR,
                              length=n))
    return (y + 0.01 * signals(int(bpm), (n,))).astype(np.float32)


CLICKS = {bpm: click_track(bpm) for bpm in (92.0, 120.0, 150.0)}
Y = signals(100, (2, 3 * SR))


@pytest.fixture(params=["plain", "kernels"])
def port_route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setattr(tap_dispatch, "resolve_use_pallas",
                            lambda flag, device: flag is not False)
    return request.param


@pytest.mark.parametrize("kw", [
    {}, dict(lag=2, max_size=4), dict(max_size=3, detrend=True), dict(center=False, n_mels=64),
    dict(fmin=30.0, fmax=8000.0, n_fft=1024, hop_length=256),
], ids=["default", "lag2-max4", "max3-detrend", "uncentered-64", "band-1024"])
def test_onset_strength_y_matches_jax(kw, port_route, monkeypatch):
    calls = []
    real = tap_mel.melspectrogram_fused

    def spy(y, win, fb_t, **k):
        calls.append((tuple(fb_t.shape), k["power"]))
        return real(y, win, fb_t, **k)

    monkeypatch.setattr(tap_mel, "melspectrogram_fused", spy)
    got = tap.onset_strength(Y, sr=SR, **kw)
    ref = jap.onset_strength(Y, sr=SR, use_pallas=False, **kw)
    assert got.shape == ref.shape and max_rel(got, ref) <= ENV_TOL
    n_bins = kw.get("n_fft", 2048) // 2 + 1
    expect = [((n_bins, kw.get("n_mels", 128)), 2.0)]
    assert calls == (expect if port_route == "kernels" else [])


def test_onset_strength_clips_db_per_clip():
    # a loud and a quiet clip: each is clipped 80 dB under its own max, so
    # the batch equals each clip alone (and the JAX package's vmap)
    y = np.stack([Y[0], 1e-3 * Y[1]])
    y[1, SR:] = 0.0  # silence under the quiet clip's floor
    got = tap.onset_strength(y, sr=SR)
    alone = torch.stack([tap.onset_strength(c, sr=SR) for c in y])
    assert torch.equal(got, alone)
    assert max_rel(got, jap.onset_strength(y, sr=SR)) <= ENV_TOL


def test_onset_strength_S_matches_jax():
    S = np.asarray(jap.power_to_db(jap.melspectrogram(Y[0], sr=SR)))
    for kw in ({}, dict(lag=3, max_size=5, detrend=True)):
        got, ref = tap.onset_strength(S=S, **kw), jap.onset_strength(S=S, **kw)
        assert got.shape == ref.shape and max_rel(got, ref) <= ENV_TOL


ENVELOPE = np.asarray(jap.onset_strength(Y[0], sr=SR))


@pytest.mark.parametrize("kw", [
    {}, dict(units="time"), dict(units="samples", backtrack=True),
    dict(normalize=False, delta=0.05, wait=3), dict(pre_max=3, post_max=2, pre_avg=6, post_avg=3),
    dict(backtrack=True, energy=np.abs(signals(101, ENVELOPE.shape))),
], ids=["default", "time", "samples-backtrack", "raw-wait3", "windows", "energy"])
def test_onset_detect_index_equal(kw):
    got = tap.onset_detect(onset_envelope=ENVELOPE, sr=SR, **kw)
    ref = jap.onset_detect(onset_envelope=ENVELOPE, sr=SR, **kw)
    assert got.size > 3
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bpm", sorted(CLICKS))
def test_onset_detect_from_clicks(bpm):
    got = tap.onset_detect(y=CLICKS[bpm], sr=SR)
    np.testing.assert_array_equal(got, jap.onset_detect(y=CLICKS[bpm], sr=SR))
    assert abs(len(got) - len(np.arange(0.3, 7.9, 60.0 / bpm))) <= 1


def test_onset_backtrack_equal():
    events = np.array([5, 17, 40, 41, 80])
    energy = np.round(np.abs(signals(102, (100,))), 1)
    np.testing.assert_array_equal(tap.onset_backtrack(events, energy),
                                  jap.onset_backtrack(events, energy))


@pytest.mark.parametrize("bpm", sorted(CLICKS))
def test_beat_track_clicks_index_equal(bpm):
    tb, got = tap.beat_track(y=CLICKS[bpm], sr=SR)
    jb, ref = jap.beat_track(y=CLICKS[bpm], sr=SR)
    assert tb == jb
    np.testing.assert_array_equal(got, ref)
    # the estimate lies within a few percent of the click tempo (or its
    # half or double)
    assert min(abs(tb / bpm - r) for r in (0.5, 1.0, 2.0)) < 0.05
    assert got.size >= 5


@pytest.mark.parametrize("kw", [
    dict(trim=False), dict(bpm=100.0), dict(units="time"), dict(units="samples", tightness=20.0),
    dict(start_bpm=80.0),
], ids=["untrimmed", "given-bpm", "time", "samples-loose", "start-80"])
def test_beat_track_options_match(kw):
    env = np.asarray(jap.onset_strength(CLICKS[120.0], sr=SR))
    tb, got = tap.beat_track(onset_envelope=env, sr=SR, **kw)
    jb, ref = jap.beat_track(onset_envelope=env, sr=SR, **kw)
    assert tb == jb
    np.testing.assert_array_equal(got, ref)


def test_beat_track_silence_and_short_envelopes():
    assert tap.beat_track(y=np.zeros(2 * SR, np.float32), sr=SR)[1].size == 0
    assert tap.beat_track(y=np.zeros(2 * SR, np.float32), sr=SR)[0] == 0.0
    # shorter than two periods: the single best frame, as the JAX package
    env = np.asarray(jap.onset_strength(CLICKS[92.0][: SR], sr=SR))
    for kw in (dict(bpm=60.0), dict(bpm=60.0, trim=False)):
        tb, got = tap.beat_track(onset_envelope=env, sr=SR, **kw)
        jb, ref = jap.beat_track(onset_envelope=env, sr=SR, **kw)
        assert tb == jb and got.size <= 1
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("period,tightness", [(43, 100.0), (21, 400.0), (60, 5.0), (2, 100.0)])
def test_beat_dp_matches_jax(period, tightness):
    # random scores make near ties; the DP runs the scan body's operations
    # in order, in float32, with argmax's first-index rule
    score = np.abs(signals(103 + period, (1300,)))
    score[:40] *= 1e-4  # a quiet start: the first-beat rule
    cum, link = tap_beat._beat_dp(score, period=period, tightness=tightness)
    jcum, jlink = jax_beat._beat_dp(score, period=period, tightness=tightness)
    np.testing.assert_array_equal(link, np.asarray(jlink))
    d = np.abs(cum - np.asarray(jcum))
    assert d.max() <= 1e-3 and (d / np.abs(np.asarray(jcum)).max()).max() <= 1e-4


def test_local_score_matches_jax():
    env = np.asarray(jap.onset_strength(CLICKS[150.0], sr=SR))
    got = tap_beat._local_score(torch.from_numpy(env), period=37)
    assert max_rel(got, jax_beat._local_score(env, period=37)) <= 1e-6


@pytest.mark.parametrize("call", [
    lambda m: m.onset_strength(sr=SR),
    lambda m: m.onset_strength(Y[0], lag=0),
    lambda m: m.onset_detect(onset_envelope=ENVELOPE[None]),
    lambda m: m.onset_detect(onset_envelope=ENVELOPE, units="bars"),
    lambda m: m.beat_track(onset_envelope=ENVELOPE[None]),
    lambda m: m.beat_track(onset_envelope=ENVELOPE, bpm=-3.0),
    lambda m: m.beat_track(onset_envelope=ENVELOPE, units="bars"),
    lambda m: m.beat_track(sr=SR),
], ids=["no-input", "lag", "detect-2d", "detect-units", "beat-2d", "bpm", "beat-units",
        "beat-no-input"])
def test_onset_beat_errors_match(call):
    with pytest.raises(ValueError) as jerr:
        call(jap)
    with pytest.raises(ValueError) as terr:
        call(tap)
    assert str(terr.value) == str(jerr.value)
