"""PyTorch port: K2s (the STFT kernel's per-frame statistics emit) on the
card, against its plain twin and a float64 reference.

A CUDA kernel has no CPU mode, so these tests skip without a card. They
import no JAX: on a machine with the card, run them with the repository's
conftest left out (it imports JAX)::

    python -m pytest --noconftest -m cuda tests/test_torch_port_stft_stats_cuda.py

K2s forms K2m's float32 magnitudes and reduces each frame in another order
than the twin's torch reductions. Against the same statistic worked out in
float64 from K2m's magnitude (the same float32 spectrum), bandwidth and
flatness agree within 5e-6 of their largest value (the float32 sums of
1,025 values) and rolloff within one bin in at most 0.5% of frames (the
CPU tests' rule). Against the twin and against float64 from a float64 FFT,
bandwidth within 2e-5 (the feature cell's limit), rolloff by the same
rule, flatness within 3e-4: the twin's FFT (cuFFT) and K2's round a bin
whose magnitude is near zero differently, and on noise, where 84 M bins at
64 x 30 s hold some at ~1e-4 of a frame's typical one, flatness's mean log
carries that rounding (1.1e-4 measured at n_fft 512; the cell's tones read
2.7e-6). The public ops take K2s for a signal on the card, one launch a
call and no K2m; the other inputs take the magnitude route.
"""

from __future__ import annotations

import math

import pytest
import torch

import mlx_audio_primitives_tpu_torch as ap
from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
from mlx_audio_primitives_tpu_torch.ops.features import _get_frequencies
from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window, magnitude_spectrogram
from mlx_audio_primitives_tpu_torch.utils import profiler

pytestmark = pytest.mark.cuda

SR = 22050
#: of the largest value: against float64 of K2m's magnitude; against the
#: twin or float64 of a float64 FFT
TOL = {"bandwidth": (5e-6, 2e-5), "flatness": (5e-6, 3e-4), "rolloff": (None, None)}
#: (stat, parameters): the feature cell's defaults and the other branches
STATS = [("bandwidth", dict(p=2.0, norm=True)), ("bandwidth", dict(p=1.0, norm=False)),
         ("rolloff", dict(roll_percent=0.85)), ("rolloff", dict(roll_percent=0.5)),
         ("flatness", dict(power=2.0, amin=1e-10)), ("flatness", dict(power=1.0, amin=1e-10))]
IDS = ["bandwidth", "bandwidth-p1", "rolloff", "rolloff-0.5", "flatness", "flatness-power1"]


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2s has no CPU mode")
    return torch.device("cuda", 0)


def clips(shape, card, seed=0) -> torch.Tensor:
    gen = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=card)


def statistic64(S, freq, stat, *, p=2.0, norm=True, roll_percent=0.85, power=2.0,
                amin=1e-10) -> torch.Tensor:
    """The statistic in float64 of the magnitude ``S`` (B, n_bins, F)."""
    S = S.double()
    if stat == "bandwidth":
        f = freq.double()[None, :, None]
        total = S.sum(1, keepdim=True) + 1e-10
        c = (f * S).sum(1, keepdim=True) / total
        w = (S * (f - c).abs() ** p).sum(1, keepdim=True)
        return (w / total if norm else w) ** (1.0 / p)
    if stat == "rolloff":
        cs = S.cumsum(1)
        first = torch.argmax((cs >= roll_percent * cs[:, -1:]).to(torch.uint8), 1)
        return freq.double()[first][:, None]
    x = torch.clamp(S**power, min=amin)
    return torch.exp(torch.log(x).mean(1, keepdim=True)) / (x.mean(1, keepdim=True) + 1e-10)


def references(y, win, freq, stat, params, **kw) -> list[tuple[torch.Tensor, float]]:
    """(reference, tolerance): the statistic in float64 of K2m's magnitude,
    of a float64 FFT of the float32 clips, and the twin's."""
    mag32 = k2.stft_magnitude_fused(y, win, **kw)
    mag64 = k2.stft_magnitude_plain(y.double(), win.double(), **kw)
    exact, contract = TOL[stat]
    return [(statistic64(mag32, freq, stat, **params), exact),
            (statistic64(mag64, freq, stat, **params), contract),
            (k2.stft_stats_plain(y, win, freq, stat=stat, **kw, **params), contract)]


def rel(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def assert_agrees(stat, got, ref, n_fft, tol):
    assert got.shape == ref.shape and got.dtype == torch.float32
    if stat == "rolloff":
        d = torch.round(got.double() / (SR / n_fft)) - torch.round(ref.double() / (SR / n_fft))
        assert float(d.abs().max()) <= 1
        assert int(torch.count_nonzero(d)) <= 0.005 * d.numel()
    else:
        assert rel(got, ref) <= tol


def launches() -> dict[str, int]:
    return {k.name: k.launches for k in (k2.KERNEL_MAG, k2.KERNEL_STATS)}


def counted(call) -> dict[str, int]:
    """The routing counters of ``call()``, recorded alone."""
    profiler.clear_profiling()
    profiler.enable_profiling()
    try:
        call()
        torch.cuda.synchronize()
        return profiler.get_profiling_data()["counters"]
    finally:
        profiler.disable_profiling()
        profiler.clear_profiling()


@pytest.mark.parametrize("shape", [(64, 661_500), (3, 33_333)], ids=["64x30s", "odd-length"])
@pytest.mark.parametrize("stat,params", STATS, ids=IDS)
def test_k2s_against_twin_and_float64(card, stat, params, shape):
    y = clips(shape, card, seed=shape[0])
    kw = dict(n_fft=2048, hop_length=512, center=True, pad_mode="constant")
    win = _get_padded_window("hann", 2048, 2048, card)
    freq = None if stat == "flatness" else _get_frequencies(SR, 2048, device=card)
    before = launches()
    got = k2.stft_stats_fused(y, win, freq, stat=stat, **kw, **params)
    torch.cuda.synchronize()
    assert launches() == {k2.KERNEL_MAG.name: before[k2.KERNEL_MAG.name],
                          k2.KERNEL_STATS.name: before[k2.KERNEL_STATS.name] + 1}
    assert got.shape == (shape[0], 1, 1 + shape[1] // 512)
    for ref, tol in references(y, win, freq, stat, params, **kw):
        assert_agrees(stat, got, ref, 2048, tol)


# every instance of the radix gate's FFT sizes: a frame's threads within one
# warp (n_fft 128-512), one warp (1024) and two to eight warps (2048-8192),
# with the other pad modes, center=False and frame counts that are not
# whole tiles
@pytest.mark.parametrize("n_fft,hop_length,pad_mode,center", [
    (128, 128, "constant", True), (256, 128, "reflect", True), (512, 128, "edge", True),
    (1024, 256, "reflect", False), (2048, 512, "edge", True), (4096, 1024, "reflect", True),
    (8192, 1024, "constant", False)])
@pytest.mark.parametrize("stat,params", STATS[::2], ids=IDS[::2])
def test_k2s_on_every_fft_size(card, stat, params, n_fft, hop_length, pad_mode, center):
    y = clips((5, 44_101), card, seed=n_fft)
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode)
    win = _get_padded_window("hann", n_fft, n_fft, card)
    freq = None if stat == "flatness" else _get_frequencies(SR, n_fft, device=card)
    got = k2.stft_stats_fused(y, win, freq, stat=stat, **kw, **params)
    for ref, tol in references(y, win, freq, stat, params, **kw):
        assert_agrees(stat, got, ref, n_fft, tol)


def test_k2s_frames_that_hold_nan(card):
    """A NaN sample makes its frames' bandwidth and flatness NaN and their
    rolloff the first bin's frequency (argmax of an all-False mask), as the
    twin gives them."""
    y = clips((2, 50_000), card, seed=7)
    y[1, 20_000] = float("nan")
    kw = dict(n_fft=2048, hop_length=512, center=True, pad_mode="constant")
    win = _get_padded_window("hann", 2048, 2048, card)
    freq = _get_frequencies(SR, 2048, device=card)
    for stat, params in STATS[::2]:
        f = None if stat == "flatness" else freq
        got = k2.stft_stats_fused(y, win, f, stat=stat, **kw, **params)
        want = k2.stft_stats_plain(y, win, f, stat=stat, **kw, **params)
        assert torch.equal(torch.isnan(got), torch.isnan(want)), stat
        assert int(torch.isnan(want).sum()) == (0 if stat == "rolloff" else 4), stat
        assert_agrees(stat, torch.nan_to_num(got), torch.nan_to_num(want), 2048, TOL[stat][1])


@pytest.mark.parametrize("op,params", [
    ("spectral_bandwidth", {}), ("spectral_rolloff", {}), ("spectral_flatness", {})])
@pytest.mark.parametrize("shape", [(4, 66_150), (66_150,)], ids=["2d", "1d"])
def test_public_ops_take_k2s(card, op, params, shape):
    """One K2s launch and no K2m a call, counted as ``dispatch.kernel.<op>``;
    a 1-D signal gives ``(1, F)``, the first row of its batch of one."""
    y = clips(shape, card, seed=11)
    kw = dict(n_fft=2048, hop_length=512, **({} if op == "spectral_flatness" else dict(sr=SR)))
    before = launches()
    out = []
    counters = counted(lambda: out.append(getattr(ap, op)(y, **kw, **params)))
    got = out[0]
    assert launches() == {k2.KERNEL_MAG.name: before[k2.KERNEL_MAG.name],
                          k2.KERNEL_STATS.name: before[k2.KERNEL_STATS.name] + 1}
    assert counters.get(f"dispatch.kernel.{op}") == 1
    F = 1 + shape[-1] // 512
    assert got.shape == ((1, F) if len(shape) == 1 else (shape[0], 1, F))
    if len(shape) == 1:
        assert torch.equal(got, getattr(ap, op)(y[None], **kw, **params)[0])


@pytest.mark.parametrize("case,reason", [
    (dict(S=True), "spectrum"), (dict(centroid=True), "centroid"), (dict(freq=True), "freq"),
    (dict(hop_length=500), "gate")])
def test_other_inputs_take_the_magnitude_route(card, case, reason):
    y = clips((2, 30_000), card, seed=13)
    kw = dict(sr=SR, n_fft=2048, hop_length=case.get("hop_length", 512))
    if case.get("S"):
        kw["S"] = magnitude_spectrogram(y, n_fft=2048, hop_length=512)
    else:
        kw["y"] = y
    if case.get("centroid"):
        kw["centroid"] = ap.spectral_centroid(y, sr=SR, n_fft=2048, hop_length=512)
    if case.get("freq"):
        kw["freq"] = torch.linspace(0, SR / 2, 1000, device=card)
    before = launches()

    def call():
        if reason != "freq":
            return ap.spectral_bandwidth(**kw)
        # the magnitude route takes the freq as it is: here one of the wrong
        # length, which it cannot broadcast against the bins
        with pytest.raises(RuntimeError):
            ap.spectral_bandwidth(**kw)

    counters = counted(call)
    assert counters.get(f"dispatch.plain.spectral_bandwidth.{reason}") == 1
    assert launches()[k2.KERNEL_STATS.name] == before[k2.KERNEL_STATS.name]
    # a signal's magnitude through K2m where the gate admits its shape
    assert launches()[k2.KERNEL_MAG.name] == before[k2.KERNEL_MAG.name] + (
        1 if reason in ("centroid", "freq") else 0)


def test_k2s_on_a_side_stream(card):
    """The launch runs on the caller's current stream, and its result there
    is the default stream's, bit for bit."""
    y = clips((8, 100_000), card, seed=17)
    kw = dict(n_fft=2048, hop_length=512, center=True, pad_mode="constant")
    win = _get_padded_window("hann", 2048, 2048, card)
    freq = _get_frequencies(SR, 2048, device=card)
    want = k2.stft_stats_fused(y, win, freq, stat="bandwidth", **kw)
    side = torch.cuda.Stream(device=card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        got = k2.stft_stats_fused(y, win, freq, stat="bandwidth", **kw)
    side.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("stat,params", [STATS[0], STATS[4]], ids=["bandwidth", "flatness"])
def test_k2s_gradient_is_the_twins(card, stat, params):
    y = clips((2, 30_000), card, seed=19)
    kw = dict(n_fft=2048, hop_length=512, center=True, pad_mode="constant")
    win = _get_padded_window("hann", 2048, 2048, card)
    freq = None if stat == "flatness" else _get_frequencies(SR, 2048, device=card)
    g = clips((2, 1, 59), card, seed=23)
    grads = []
    for fn in (k2.stft_stats_fused, k2.stft_stats_plain):
        x = y.clone().requires_grad_(True)
        (fn(x, win, freq, stat=stat, **kw, **params) * g).sum().backward()
        grads.append(x.grad)
    assert torch.isfinite(grads[0]).all()
    assert rel(grads[0], grads[1]) <= 1e-6


def test_rolloff_passes_a_gradient_to_freq_only(card):
    y = clips((2, 30_000), card, seed=29).requires_grad_(True)
    kw = dict(n_fft=2048, hop_length=512, center=True, pad_mode="constant")
    win = _get_padded_window("hann", 2048, 2048, card)
    freq = _get_frequencies(SR, 2048, device=card)
    assert not k2.stft_stats_fused(y, win, freq, stat="rolloff", **kw).requires_grad
    f = freq.clone().requires_grad_(True)
    out = k2.stft_stats_fused(y, win, f, stat="rolloff", **kw)
    out.sum().backward()
    # each frame adds one to the bin it landed on
    assert math.isclose(float(f.grad.sum()), out.numel())
    assert y.grad is None
