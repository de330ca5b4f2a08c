"""PyTorch port: autocorrelation, ACF pitch, periodicity, YIN and piptrack.

The same seeded NumPy input goes through the JAX package and the port. The
port runs on CPU tensors on its plain route, or with its kernel route
forced on (``kernel_route`` patched: the framewise ACF then runs K1's
wrapper, which on a CPU tensor runs its plain twin); the JAX package on its
XLA route or its kernel route (``has_pallas_tpu`` patched: its fused
kernel in interpret mode, with its exact GEMMs). Limits: ACF values 1e-5 absolute (they are
normalized to 1 at lag 0), f0 and the voicing mask equal, YIN f0 within
5e-3 relative (`NUMERICAL_ACCURACY.md:30`), piptrack 1e-5 of max.

Degenerate frames (silence, silence->onset, constant and piecewise-constant
audio, a DC offset) are gated by noise floors calibrated to float32
rounding. On them the port's two routes give the same masks, equal to the
JAX kernel route's; the JAX XLA route voices, in addition, frames that are
exactly constant, where its mean subtraction leaves rounding residue above
its floor and torch's leaves none: on those frames, and only those, the
port is unvoiced where the JAX XLA route is voiced (ROADMAP, differences
recorded).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
from torch_port_util import max_abs, max_rel, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu import _config as jax_config
from mlx_audio_primitives_tpu.utils import dispatch as jax_dispatch
from mlx_audio_primitives_tpu_torch.utils import dispatch as tap_dispatch

jax_pitch = importlib.import_module("mlx_audio_primitives_tpu.ops.pitch")
tap_pitch = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.pitch")

torch.set_num_threads(1)

SR = 22050
ACF = dict(frame_length=512, hop_length=128, fmin=80.0, fmax=1000.0)  # n_fft 1024: in the gate


def tone(freq: float, n: int, seed: int = 0, noise: float = 0.2) -> np.ndarray:
    t = np.arange(n) / SR
    y = np.sin(2 * np.pi * freq * t) + noise * np.random.default_rng(seed).standard_normal(n)
    return y.astype(np.float32)


@pytest.fixture(params=["plain", "kernels"])
def port_route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setattr(tap_dispatch, "kernel_route",
                            lambda flag, device: flag is not False)
    return request.param


def _jax(fn, route, *args, **kw):
    """The JAX package's result on its XLA or kernel route; the kernel route
    with its exact GEMMs (``ANALYSIS_FAST_GEMM`` off: its bf16-split
    magnitude moves near-tied peaks)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dispatch, "has_pallas_tpu", lambda: route == "kernels")
        mp.setattr(jax_config, "ANALYSIS_FAST_GEMM", False)
        out = fn(*args, **kw)
    return tuple(map(to_np, out)) if isinstance(out, tuple) else to_np(out)


@pytest.mark.parametrize("max_lag", [None, 300, 5000])
@pytest.mark.parametrize("normalize,center", [(True, True), (False, True), (True, False)])
def test_autocorrelation_matches_jax(max_lag, normalize, center):
    y = np.stack([tone(220.0, 11025, 1), signals(80, (11025,))])
    kw = dict(max_lag=max_lag, normalize=normalize, center=center)
    ref = to_np(jap.autocorrelation(y, **kw))
    got = tap.autocorrelation(y, **kw)
    assert got.shape == ref.shape and max_rel(got, ref) <= 1e-5
    assert tap.autocorrelation(y[0], **kw).shape == ref.shape[1:]


CASES = {
    "tones": lambda: np.stack([tone(220.0, 8192, 2), tone(440.0, 8192, 3, noise=0.05)]),
    "noise": lambda: signals(81, (2, 8192)),
}
CONFIGS = {
    "512/128": ACF,
    "1024/256": dict(frame_length=1024, hop_length=256, fmin=60.0, fmax=800.0),
    "2048/512": dict(frame_length=2048, hop_length=512),
}


@pytest.mark.parametrize("jax_route", ["xla", "kernels"])
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("case", list(CASES))
def test_pitch_detect_acf_matches_jax(case, config, jax_route, port_route):
    y, kw = CASES[case](), CONFIGS[config]
    f0_ref, v_ref = _jax(jap.pitch_detect_acf, jax_route, y, sr=SR, **kw)
    f0, v = tap.pitch_detect_acf(y, sr=SR, **kw)
    assert v.dtype == torch.bool and np.array_equal(to_np(v), v_ref)
    assert max_abs(f0, f0_ref) <= 1e-5 * max(np.abs(f0_ref).max(), 1.0)
    p_ref = _jax(jap.periodicity, jax_route, y, sr=SR, **kw)
    p = tap.periodicity(y, sr=SR, **kw)
    assert p.shape == p_ref.shape and max_abs(p, p_ref) <= 1e-5


def test_kernel_route_runs_k1_with_the_lag_basis(port_route, monkeypatch):
    """The kernel route calls K1's wrapper once, with the boxcar window
    over half the transform and the (n_bins, 1 + hi - lo) lag basis at
    power 2 without a centre pad; the plain route never calls it."""
    calls = []
    real = tap_pitch.melspectrogram_fused

    def spy(y, win, w, **kw):
        calls.append((int(win.sum()), tuple(win.shape), tuple(w.shape), kw["center"], kw["power"]))
        return real(y, win, w, **kw)

    monkeypatch.setattr(tap_pitch, "melspectrogram_fused", spy)
    tap.pitch_detect_acf(CASES["tones"](), sr=SR, **ACF)
    lo, hi = tap_pitch._lag_bounds(SR, ACF["fmin"], ACF["fmax"])
    want = [(512, (1024,), (513, 1 + min(hi + 1, 1024) - lo), False, 2.0)]
    assert calls == (want if port_route == "kernels" else [])


def _degenerate(n: int = 8192) -> dict[str, np.ndarray]:
    t = np.arange(n) / SR
    half = n // 2
    return {
        "silence": np.zeros(n),
        "onset": np.concatenate([np.zeros(half), np.sin(2 * np.pi * 220 * t[:half])]),
        "constant": np.full(n, 0.9),
        "piecewise": np.concatenate([np.full(half, 0.9), np.full(half, -0.9)]),
        "dc-offset": 0.9 + 0.001 * np.sin(2 * np.pi * 330 * t),
        "large-dc-offset": 100.0 + 0.1 * np.sin(2 * np.pi * 330 * t),
    }


def _constant_frames(y: np.ndarray, kw: dict) -> np.ndarray:
    W, hop = kw["frame_length"], kw["hop_length"]
    fr = np.lib.stride_tricks.sliding_window_view(np.pad(y, (W // 2, W // 2)), W)[::hop]
    return (fr == fr[:, :1]).all(-1)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("case", list(_degenerate()))
def test_degenerate_frames_masks(case, config, monkeypatch):
    """Both port routes give equal masks and equal f0; they equal the JAX
    kernel route's masks, and the JAX XLA route's except on exactly
    constant frames, where the port is unvoiced."""
    y, kw = _degenerate()[case].astype(np.float32), CONFIGS[config]
    f0_p, v_p = map(to_np, tap.pitch_detect_acf(y, sr=SR, **kw))
    monkeypatch.setattr(tap_dispatch, "kernel_route", lambda flag, device: flag is not False)
    f0_k, v_k = map(to_np, tap.pitch_detect_acf(y, sr=SR, **kw))
    assert np.array_equal(v_k, v_p)
    assert np.array_equal(f0_k, f0_p)
    _, v_jk = _jax(jap.pitch_detect_acf, "kernels", y, sr=SR, **kw)
    f0_jx, v_jx = _jax(jap.pitch_detect_acf, "xla", y, sr=SR, **kw)
    assert np.array_equal(v_p, v_jk)
    const = _constant_frames(y, kw)
    assert np.array_equal(v_p[~const], v_jx[~const]) and not v_p[const].any()
    both = v_p & v_jx
    assert np.abs(f0_p[both] - f0_jx[both]).max(initial=0.0) <= 1e-5 * max(f0_jx.max(), 1.0)


def tones_and_saw() -> np.ndarray:
    t = np.arange(SR) / SR
    saw = sum(np.sin(2 * np.pi * 110.0 * k * t) / k for k in range(1, 11))
    return np.stack([tone(196.0, SR, 4, noise=0.01), tone(523.25, SR, 5, noise=0.0),
                     (saw / np.abs(saw).max()).astype(np.float32)])


@pytest.mark.parametrize("kw", [
    dict(fmin=65.0, fmax=2093.0, frame_length=1024),
    dict(fmin=80.0, fmax=1000.0, frame_length=2048, hop_length=256, win_length=900),
    dict(fmin=65.0, fmax=2093.0, frame_length=1024, center=False),
    dict(fmin=65.0, fmax=2093.0, frame_length=1024, pad_mode="reflect", trough_threshold=0.2),
], ids=["defaults-1024", "win900", "not-centered", "reflect"])
def test_yin_matches_jax(kw):
    y = tones_and_saw()
    ref = to_np(jap.yin(y, sr=SR, **kw))
    got = to_np(tap.yin(y, sr=SR, **kw))
    assert got.shape == ref.shape
    assert (np.abs(got - ref) / ref).max() <= 5e-3
    assert to_np(tap.yin(y[0], sr=SR, **kw)).shape == ref.shape[1:]


def test_yin_chunks_of_lags(monkeypatch):
    """The difference function runs over chunks of lags; a chunk of one lag
    gives the same CMND as one chunk of all."""
    y = tones_and_saw()[:, :4096]
    kw = dict(frame_length=1024, win_length=512, hop_length=256, min_period=10, max_period=300)
    yt = torch.from_numpy(y)
    whole = tap_pitch._yin_cmnd(yt, **kw)
    monkeypatch.setattr(tap_pitch, "_YIN_CHUNK_BYTES", 1)
    assert max_rel(tap_pitch._yin_cmnd(yt, **kw), whole) <= 1e-6


@pytest.mark.parametrize("kw", [
    dict(), dict(fmin=100.0, fmax=2000.0, threshold=0.2), dict(ref=0.5),
    dict(ref=lambda S: S.max()), dict(n_fft=512, hop_length=256, center=False),
], ids=["defaults", "band", "ref-scalar", "ref-callable", "n_fft-512"])
@pytest.mark.parametrize("jax_route", ["xla", "kernels"])
def test_piptrack_matches_jax(kw, jax_route, port_route):
    """From ``y``: the port's magnitude route (K2m's wrapper on the kernel
    route) against the JAX package's (its magnitude kernel in interpret
    mode on its kernel route)."""
    y = tones_and_saw()[:2]
    if callable(kw.get("ref")):
        ref_fn = kw["ref"]
        ref = _jax(jap.piptrack, jax_route, y=y, sr=SR, **dict(kw, ref=lambda S: S.max()))
        got = tap.piptrack(y=y, sr=SR, **dict(kw, ref=ref_fn))
    else:
        ref = _jax(jap.piptrack, jax_route, y=y, sr=SR, **kw)
        got = tap.piptrack(y=y, sr=SR, **kw)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and max_abs(g, r) <= 1e-5 * np.abs(r).max()


def test_piptrack_on_a_spectrogram_and_tuning():
    y = tones_and_saw()
    S = np.abs(np.asarray(jap.stft(y, n_fft=1024, hop_length=256)))
    for g, r in zip(tap.piptrack(S=S, sr=SR), jap.piptrack(S=S, sr=SR)):
        assert max_abs(g, r) <= 1e-5 * np.abs(to_np(r)).max()
    for g, r in zip(tap.piptrack(S=S[0], sr=SR), jap.piptrack(S=S[0], sr=SR)):
        assert g.dim() == 2 and max_abs(g, r) <= 1e-5 * np.abs(to_np(r)).max()
    for x in (y[0], y[2]):
        assert tap.estimate_tuning(y=x, sr=SR) == jap.estimate_tuning(y=x, sr=SR)
    freqs = np.array([440.0, 445.0, 0.0, np.nan, 261.6, 452.0])
    assert tap.pitch_tuning(freqs) == jap.pitch_tuning(freqs)
    assert tap.pitch_tuning(torch.tensor(freqs)) == jap.pitch_tuning(freqs)


def test_errors_match_jax():
    y = tone(220.0, 4096)
    for call in (lambda m: m.pitch_detect_acf(y, fmin=500.0, fmax=100.0),
                 lambda m: m.pitch_detect_acf(y, hop_length=0),
                 lambda m: m.periodicity(y, frame_length=0),
                 lambda m: m.yin(y, 0.0, 500.0),
                 lambda m: m.yin(y, 65.0, 2093.0, frame_length=512, win_length=512),
                 lambda m: m.yin(y, 20.0, 21.0, frame_length=256),
                 lambda m: m.piptrack(sr=SR),
                 lambda m: m.pitch_tuning([440.0], resolution=0.0)):
        with pytest.raises(ValueError) as ref:
            call(jap)
        with pytest.raises(ValueError) as got:
            call(tap)
        assert str(got.value) == str(ref.value)
