"""PyTorch port: K2s (the STFT kernel's per-frame statistics emit) on the CPU.

K2s has no CPU mode: on a CPU tensor its wrapper runs its plain twin (K2m's
twin and the plain route's per-frame formulas), which these tests hold
against the JAX package's ``spectral_bandwidth`` / ``spectral_rolloff`` /
``spectral_flatness`` (its kernel paths and its XLA paths) on the feature
tests' signals: within 1e-4 of max (`NUMERICAL_ACCURACY.md:19`), rolloff
within one bin (``_assert_rolloff_agrees``). The routing: with the kernel
routes taken on the CPU (``kernel_route`` patched), a signal takes K2s,
counted ``dispatch.kernel.<op>``; an ``S`` input, a ``centroid`` given, a
``freq`` of another length, an exponent K2s lacks and a shape off the
radix gate take the magnitude route, counted
``dispatch.plain.<op>.<reason>``.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
from test_torch_port_features import KW, SR, _assert_rolloff_agrees, _jax, _port_kernel_routes
from torch_port_util import launch_counts, max_rel, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window, magnitude_spectrogram
from mlx_audio_primitives_tpu_torch.utils import profiler

tap_features = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.features")

torch.set_num_threads(1)

FEAT_TOL = 1e-4  # relative to max
STFT_KW = dict(n_fft=KW["n_fft"], hop_length=KW["hop_length"], center=True, pad_mode="constant")
#: the feature tests' signals: 65 frames of 2 clips, 33 frames of one
SIGNALS = {"y-2d": lambda: signals(50, (2, 16384)), "y-1d": lambda: signals(51, (8192,))}


def twin(y: np.ndarray, stat: str, freq=None, **params) -> torch.Tensor:
    """K2s's wrapper on a CPU tensor (its twin), shaped as the op's output."""
    y2 = torch.from_numpy(y).reshape(-1, y.shape[-1])
    win = _get_padded_window("hann", KW["n_fft"], KW["n_fft"], "cpu")
    if stat != "flatness":
        freq = torch.as_tensor(np.linspace(0, SR / 2, KW["n_fft"] // 2 + 1) if freq is None
                               else freq, dtype=torch.float32)
    before = launch_counts()
    out = k2.stft_stats_fused(y2, win, freq, stat=stat, **STFT_KW, **params)
    assert launch_counts() == before
    return out[0] if y.ndim == 1 else out


@pytest.mark.parametrize("jax_route", ["kernels", "xla"])
@pytest.mark.parametrize("case", list(SIGNALS))
@pytest.mark.parametrize("params", [dict(p=2.0), dict(p=1.0, norm=False), dict(p=2.0, freq=True)],
                         ids=["p2", "p1-unnormed", "per-bin-freq"])
def test_bandwidth_twin_matches_jax(params, case, jax_route):
    params = dict(params)
    kw = dict(sr=SR, p=params.get("p"), norm=params.get("norm", True))
    freq = None
    if params.pop("freq", False):
        # a grid of one value per bin that is not the rfft's: log-spaced
        freq = np.geomspace(20.0, SR / 2, KW["n_fft"] // 2 + 1)
        kw["freq"] = tuple(freq)  # hashable: the JAX results are cached by their arguments
    ref = _jax("spectral_bandwidth", case, jax_route, **kw)
    got = twin(SIGNALS[case](), "bandwidth", freq, **params)
    assert got.shape == ref.shape
    assert max_rel(got, ref) <= FEAT_TOL


@pytest.mark.parametrize("jax_route", ["kernels", "xla"])
@pytest.mark.parametrize("case", list(SIGNALS))
@pytest.mark.parametrize("roll_percent", [0.05, 0.5, 0.85, 0.99, 1.0])
def test_rolloff_twin_matches_jax_within_one_bin(roll_percent, case, jax_route):
    ref = _jax("spectral_rolloff", case, jax_route, sr=SR, roll_percent=roll_percent)
    got = twin(SIGNALS[case](), "rolloff", roll_percent=roll_percent)
    assert got.shape == ref.shape
    _assert_rolloff_agrees(got, ref, KW["n_fft"])


@pytest.mark.parametrize("jax_route", ["kernels", "xla"])
@pytest.mark.parametrize("case", list(SIGNALS))
@pytest.mark.parametrize("power", [2.0, 1.0])
def test_flatness_twin_matches_jax(power, case, jax_route):
    ref = _jax("spectral_flatness", case, jax_route, power=power)
    got = twin(SIGNALS[case](), "flatness", power=power, amin=1e-10)
    assert got.shape == ref.shape
    assert max_rel(got, ref) <= FEAT_TOL


def test_flatness_twin_on_a_tone_at_the_amin_floor():
    """A quiet tone: most bins' powers fall under amin = 1e-10, so the
    floor sets the geometric mean; the twin holds the JAX package's
    f32-exact route to 1e-4 of max and each frame to 10% (the rule of the
    feature tests' tone)."""
    t = np.arange(16384) / SR
    y = (1e-4 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    S = to_np(magnitude_spectrogram(y, **KW))
    assert np.mean(S**2 < 1e-10) > 0.5  # the floor really is reached
    ref = to_np(jap.spectral_flatness(y, **KW))
    got = to_np(twin(y, "flatness", power=2.0, amin=1e-10))
    assert got.shape == ref.shape
    assert max_rel(got, ref) <= FEAT_TOL
    np.testing.assert_allclose(got, ref, rtol=0.1, atol=0)


def test_twin_refuses_what_k2s_lacks():
    y = torch.from_numpy(signals(53, (1, 4096)))
    win = _get_padded_window("hann", 1024, 1024, "cpu")
    freq = torch.ones(513)
    with pytest.raises(ValueError, match="p and power"):
        k2.stft_stats_fused(y, win, freq, stat="bandwidth", p=1.5, **STFT_KW)
    with pytest.raises(ValueError, match="stat must be"):
        k2.stft_stats_fused(y, win, freq, stat="centroid", **STFT_KW)
    with pytest.raises(ValueError, match="takes no freq"):
        k2.stft_stats_fused(y, win, freq, stat="flatness", **STFT_KW)
    with pytest.raises(ValueError, match="fused STFT kernel requires"):
        k2.stft_stats_fused(y, win, freq, stat="rolloff", n_fft=1024, hop_length=100,
                            center=True, pad_mode="constant")


def _counted(call) -> dict[str, int]:
    profiler.clear_profiling()
    profiler.enable_profiling()
    try:
        call()
        return profiler.get_profiling_data()["counters"]
    finally:
        profiler.disable_profiling()
        profiler.clear_profiling()


OPS = {"spectral_bandwidth": "bandwidth", "spectral_rolloff": "rolloff",
       "spectral_flatness": "flatness"}


@pytest.mark.parametrize("op", list(OPS))
def test_a_signal_takes_k2s(op, monkeypatch):
    """On the kernel routes each op hands a signal to K2s once, with the
    op's own parameters, and returns its result, a 1-D signal as ``(1, F)``."""
    _port_kernel_routes(monkeypatch)
    calls = []
    real = tap_features.stft_stats_fused

    def spy(y, win, freq, **kw):
        calls.append(kw["stat"])
        return real(y, win, freq, **kw)

    monkeypatch.setattr(tap_features, "stft_stats_fused", spy)
    y = signals(54, (8192,))
    kw = dict(KW) if op == "spectral_flatness" else dict(KW, sr=SR)
    out = {}
    counters = _counted(lambda: out.setdefault("v", getattr(tap, op)(y, **kw)))
    assert calls == [OPS[op]]
    assert counters == {f"dispatch.kernel.{op}": 1}
    assert out["v"].shape == (1, 1 + 8192 // KW["hop_length"])


@pytest.mark.parametrize("op,case,reason", [
    ("spectral_bandwidth", dict(S=True), "spectrum"),
    ("spectral_rolloff", dict(S=True), "spectrum"),
    ("spectral_flatness", dict(S=True), "spectrum"),
    ("spectral_bandwidth", dict(centroid=True), "centroid"),
    ("spectral_bandwidth", dict(freq=100), "freq"),
    ("spectral_bandwidth", dict(p=1.5), "power"),
    ("spectral_flatness", dict(power=0.5), "power"),
    ("spectral_rolloff", dict(hop_length=200), "gate"),
    ("spectral_flatness", dict(n_fft=1000, hop_length=250), "gate"),
])
def test_other_inputs_take_the_magnitude_route(op, case, reason, monkeypatch):
    """Each refusal is counted with its reason; the result is the magnitude
    route's, which matches the JAX package's. A ``freq`` of another length
    reaches the magnitude route, which cannot broadcast it against the bins,
    as the JAX package cannot."""
    _port_kernel_routes(monkeypatch)
    monkeypatch.setattr(tap_features, "stft_stats_fused", None)  # must not be called
    case = dict(case)
    y = signals(55, (2, 8192))
    kw = dict(KW, **{k: case.pop(k) for k in ("n_fft", "hop_length") if k in case})
    if op != "spectral_flatness":
        kw["sr"] = SR
    if case.pop("S", False):
        S = np.abs(np.asarray(jap.stft(y, **KW)))
        args = dict(S=S)
    else:
        args = dict(y=y)
    if case.pop("centroid", False):
        kw["centroid"] = to_np(tap.spectral_centroid(y, sr=SR, **KW))
    if "freq" in case:
        kw["freq"] = np.linspace(0, SR / 2, case.pop("freq"))
    kw.update(case)
    out = {}

    def call():
        if reason == "freq":
            with pytest.raises((RuntimeError, IndexError)):
                getattr(tap, op)(**args, **kw)
        else:
            out["v"] = getattr(tap, op)(**args, **kw)

    assert _counted(call).get(f"dispatch.plain.{op}.{reason}") == 1
    if reason != "freq":
        ref = to_np(getattr(jap, op)(**args, **kw))
        assert out["v"].shape == ref.shape
        assert max_rel(out["v"], ref) <= FEAT_TOL
