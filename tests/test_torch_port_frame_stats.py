"""PyTorch port: K7's plain twin, its route and its launcher's tile rule
(on the CPU).

``frame_stats_plain`` is the composition ``rms`` and ``zero_crossing_rate``
ran before K7 existed, moved unchanged: it is held here bit for bit against
that composition, written out below, over both statistics, both pad modes,
``center=False``, frame lengths and hops the kernel takes through its
16-byte and its scalar path, and signals holding exact zeros, -0.0, NaN and
+-inf. The public ops keep their checks and messages, ask the route for K7
with its gates, and on a CPU tensor take the twin. On the kernel route,
with the launch standing in, the RMS is differentiated as the twin and the
rate has no gradient, as the twin's has none. K7 itself runs only on the
card (``tests/test_torch_port_frame_stats_cuda.py``).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch
from torch_port_util import same_bits, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch.kernels import frame_stats as k7
from mlx_audio_primitives_tpu_torch.ops._frames import frame_signal_batched, pad_signal
from mlx_audio_primitives_tpu_torch.utils import dispatch, profiler

OPS = {"rms": (tap.rms, jap.rms, "constant"),
       "zero_crossing_rate": (tap.zero_crossing_rate, jap.zero_crossing_rate, "edge")}


def composition_before_k7(y, stat, frame_length, hop_length, center, pad_mode):
    """The bodies of ``ops/framing.py::rms`` and
    ``ops/features.py::zero_crossing_rate`` before K7, after their checks,
    on a ``(B, L)`` signal."""
    if center:
        y = pad_signal(y, frame_length // 2, pad_mode)
    frames = frame_signal_batched(y, frame_length, hop_length)
    if stat == "rms":
        energy = torch.sqrt(torch.mean(frames**2, dim=-1, keepdim=True))
        return energy.transpose(1, 2)
    sign = torch.signbit(frames)
    crossings = (sign[..., 1:] != sign[..., :-1]).to(torch.float32)
    zcr = torch.sum(crossings, dim=-1, keepdim=True) / frame_length
    return zcr.transpose(1, 2)


def clips(shape, seed=0, special=False) -> torch.Tensor:
    """Standard-normal clips; with ``special``, runs of exact zeros and of
    -0.0, a NaN and +-inf."""
    y = signals(seed, shape)
    if special:
        y[..., 100:180] = 0.0
        y[..., 200:230] = -0.0
        y[..., 181::97] = -0.0
        y[..., 777] = np.nan
        y[0, 1500] = np.inf
        y[-1, 2500] = -np.inf
    return torch.from_numpy(y)


# (frame_length, hop_length, length): the ops' default (16-byte path), the
# Whisper frame, a hop of 1, and frames and hops that are not multiples of 4
# (the scalar path); lengths that are and are not multiples of 4
GEOMETRIES = [(2048, 512, 9000), (400, 160, 4001), (1024, 1, 1200), (7, 3, 101), (64, 4, 603)]
CASES = list(itertools.product(("rms", "zero_crossing_rate"), GEOMETRIES, ("constant", "edge", "no-center")))
IDS = [f"{s}-{n}-{h}-{L}-{p}" for s, (n, h, L), p in CASES]


@pytest.mark.parametrize("stat,geometry,pad", CASES, ids=IDS)
def test_twin_is_the_composition_before_k7(stat, geometry, pad):
    n, hop, L = geometry
    center = pad != "no-center"
    pad_mode = "constant" if pad == "no-center" else pad
    y = clips((2, L), seed=L, special=L > 3000)
    want = composition_before_k7(y, stat, n, hop, center, pad_mode)
    kw = dict(stat=stat, frame_length=n, hop_length=hop, center=center, pad_mode=pad_mode)
    assert same_bits(k7.frame_stats_plain(y, **kw), want)
    assert same_bits(k7.frame_stats_fused(y, **kw), want)
    public = OPS[stat][0]
    args = dict(frame_length=n, hop_length=hop, center=center, pad_mode=pad_mode)
    assert same_bits(public(y, **args), want)
    assert same_bits(public(y[1], **args), want[1])


def _gates(monkeypatch, stat, y, **kw) -> dict:
    seen = {}

    def route(op, flag, device, **gates):
        seen.update(op=op, flag=flag, device=device.type, **gates)
        return False

    monkeypatch.setattr(dispatch, "route", route)
    OPS[stat][0](y, **kw)
    return seen


@pytest.mark.parametrize("stat", ["rms", "zero_crossing_rate"])
@pytest.mark.parametrize("case", ["batch", "1d", "long_frame", "3d", "empty"])
def test_the_route_is_asked_for_k7_with_its_gates(monkeypatch, stat, case):
    y, kw = clips((2, 40000)), {}
    if case == "1d":
        y = y[0]
    elif case == "long_frame":
        kw = dict(frame_length=k7.MAX_FRAME_LENGTH + 1)
    elif case == "3d":
        y = y.reshape(2, 2, 20000)
    elif case == "empty":
        y, kw = y[:0], dict(pad_mode="constant")
    seen = _gates(monkeypatch, stat, y, **kw)
    assert seen == dict(op=stat, flag=None, device="cpu",
                        gate=case not in ("long_frame", "3d"), nonempty=case != "empty")


def test_the_route_counts_k7_and_why_it_was_not_taken():
    profiler.clear_profiling()
    profiler.enable_profiling()
    try:
        cuda = torch.device("cuda", 0)
        for op in OPS:
            assert dispatch.route(op, None, cuda, gate=False, nonempty=True) is False
            assert dispatch.route(op, None, cuda, gate=True, nonempty=False) is False
            assert dispatch.route(op, None, cuda, gate=True, nonempty=True) is True
        counters = profiler.get_profiling_data()["counters"]
    finally:
        profiler.disable_profiling()
        profiler.clear_profiling()
    assert counters == {f"dispatch.{k}.{op}{r}": 1 for op in OPS
                        for k, r in (("plain", ".gate"), ("plain", ".nonempty"), ("kernel", ""))}


@pytest.mark.parametrize("stat", ["rms", "zero_crossing_rate"])
def test_a_cpu_tensor_takes_the_twin(stat):
    """On the CPU the route says no and nothing is launched; forced onto the
    wrapper, the wrapper runs the twin."""
    y = clips((3, 5000), special=True)
    assert dispatch.route(stat, None, y.device, gate=True, nonempty=True) is False
    before = k7.KERNEL.launches
    got = OPS[stat][0](y)
    assert k7.KERNEL.launches == before
    kw = dict(frame_length=2048, hop_length=512, center=True, pad_mode=OPS[stat][2])
    assert same_bits(got, k7.frame_stats_plain(y, stat=stat, **kw))


@pytest.mark.parametrize("center,pad_mode", [(True, "constant"), (True, "edge"), (False, "edge")])
@pytest.mark.parametrize("stat", ["rms", "zero_crossing_rate"])
def test_k7_launch_arguments(monkeypatch, stat, center, pad_mode):
    """The launcher's arguments, its call recorded instead of made: a
    contiguous float32 (B, L), the frame count of the padded signal's
    unfold, the pad and its code (0 without a centre pad), the statistic's
    code and the float32 reciprocal of the frame length."""
    calls = []
    monkeypatch.setattr(k7.KERNEL, "launch", lambda device, *args: calls.append(args))
    monkeypatch.setattr(k7, "require", lambda *args: None)  # a CPU tensor stands in
    y = clips((6, 5001))[::2]
    n, hop = 400, 160
    out = k7._launch(y, stat=stat, frame_length=n, hop_length=hop, center=center,
                     pad_mode=pad_mode)
    pad = n // 2 if center else 0
    F = frame_signal_batched(pad_signal(y, pad, pad_mode), n, hop).shape[1]
    assert out.shape == (3, 1, F) and out.dtype == torch.float32
    [(y_ptr, B, L, out_ptr, n_, hop_, F_, pad_, mode, code, inv)] = calls
    assert (B, L, n_, hop_, F_, pad_) == (3, 5001, n, hop, F, pad)
    assert out_ptr == out.data_ptr() and y_ptr != y.data_ptr()  # a strided view is copied
    assert mode == ({"constant": 0, "edge": 2}[pad_mode] if center else 0)
    assert code == k7.STATS[stat]
    assert np.float32(inv) == np.float32(1.0) / np.float32(n)


@pytest.mark.parametrize("stat", ["rms", "zero_crossing_rate"])
@pytest.mark.parametrize("case", ["pad_mode", "short", "short_by_one", "frame_length", "hop_length"])
def test_errors_are_unchanged(stat, case):
    """The checks and their messages, the JAX package's: an unknown pad
    mode, a signal shorter than the frame (without a centre pad: the pad of
    ``frame_length // 2`` a side makes any signal long enough), a frame
    length or hop that is not positive."""
    y = signals(3, (2, 1000))
    kw = {"pad_mode": dict(pad_mode="reflect"), "short": dict(frame_length=2048, center=False),
          "short_by_one": dict(frame_length=1001, center=False),
          "frame_length": dict(frame_length=0), "hop_length": dict(hop_length=-1)}[case]
    port, jax_fn, _ = OPS[stat]
    with pytest.raises(ValueError) as jerr:
        jax_fn(y, **kw)
    with pytest.raises(ValueError) as terr:
        port(y, **kw)
    assert str(terr.value) == str(jerr.value)
    if case.startswith("short"):
        n = kw["frame_length"]
        assert str(terr.value) == f"signal length (1000) must be >= frame_length ({n})"
        with pytest.raises(ValueError) as kerr:
            k7.frame_stats_fused(torch.from_numpy(y), stat=stat, frame_length=n, hop_length=512,
                                 center=False, pad_mode="constant")
        assert str(kerr.value) == str(terr.value)


def test_wrapper_refuses_what_k7_does_not_take():
    y = clips((2, 40000))
    with pytest.raises(ValueError, match="stat must be one of"):
        k7.frame_stats_fused(y, stat="mean", frame_length=2048, hop_length=512, center=True,
                             pad_mode="constant")
    for bad, n in ((y.reshape(2, 2, 20000), 2048), (y, k7.MAX_FRAME_LENGTH + 1)):
        with pytest.raises(ValueError, match="frame_stats_kernel takes"):
            k7.frame_stats_fused(bad, stat="rms", frame_length=n, hop_length=512, center=True,
                                 pad_mode="constant")


@pytest.fixture(params=["plain", "kernels"])
def port_route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setattr(dispatch, "kernel_route", lambda flag, device: flag is not False)
    return request.param


@pytest.mark.parametrize("kw", [dict(), dict(pad_mode="edge"), dict(center=False),
                                dict(frame_length=400, hop_length=160)],
                         ids=["default", "edge", "no-center", "400"])
@pytest.mark.parametrize("shape", [(2, 8192), (8191,)], ids=["2d", "1d"])
@pytest.mark.parametrize("stat", ["rms", "zero_crossing_rate"])
def test_ops_match_jax(stat, shape, kw, port_route):
    """Both ops against the JAX package on the CPU, on both port routes:
    ZCR exact, RMS within 1e-6 of its largest value."""
    y = signals(70, shape)
    y[..., 100:200] = 0.0
    y[..., 300:310] = -0.0
    port, jax_fn, _ = OPS[stat]
    got, ref = to_np(port(y, **kw)), np.asarray(jax_fn(y, **kw))
    assert got.shape == ref.shape
    if stat == "zero_crossing_rate":
        assert np.array_equal(got, ref)
    else:
        assert np.abs(got.astype(np.float64) - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("center,pad_mode", [(True, "constant"), (True, "edge"), (False, "edge")])
@pytest.mark.parametrize("geometry", [(2048, 512), (400, 160)], ids=["2048-512", "400-160"])
def test_gradients_on_the_kernel_route(monkeypatch, geometry, center, pad_mode):
    """The wrapper's kernel route, its launch standing in (the twin's value,
    made without a graph as the kernel's is): a loss that sums the rate and
    the RMS back-propagates, through the RMS alone, the plain route's
    gradient; the rate, as the twin's, requires none."""
    n, hop = geometry
    monkeypatch.setattr(k7, "on_cuda", lambda *tensors: True)
    launches = []

    def launch(y, **kw):
        launches.append(kw["stat"])
        with torch.no_grad():
            return k7.frame_stats_plain(y, **kw)

    monkeypatch.setattr(k7, "_launch", launch)
    kw = dict(frame_length=n, hop_length=hop, center=center, pad_mode=pad_mode)
    y = clips((3, 9001), seed=n + hop)
    grads = []
    for fn in (k7.frame_stats_fused, k7.frame_stats_plain):
        x = y.clone().requires_grad_(True)
        zcr, rms = fn(x, stat="zero_crossing_rate", **kw), fn(x, stat="rms", **kw)
        assert not zcr.requires_grad and rms.requires_grad
        (zcr.sum() + rms.sum()).backward()
        grads.append(x.grad)
    assert launches == ["zero_crossing_rate", "rms"]
    assert torch.isfinite(grads[0]).all() and grads[0].abs().max() > 0
    assert torch.equal(grads[0], grads[1])


# --- the launcher's tile rule (csrc/frame_stats.cu, frame_stats_launch) ------

SEG_BUDGET, MAX_TILE_FRAMES, WARPS = 10240, 64, 8


def tile_frames(n: int, hop: int, F: int) -> int:
    """The launcher's frames a tile."""
    ft = (SEG_BUDGET - n) // hop + 1 if n < SEG_BUDGET else 1
    ft = min(ft, MAX_TILE_FRAMES, F)
    return ft - ft % WARPS if ft > WARPS else ft


def test_model_tiles_cover_the_frames():
    """The launcher's tiles: 16 frames of 2048 at hop 512 (38 KB), whole
    rounds of the block's eight warps, one frame of the longest frame K7
    takes, and every tile's segment within the budget where it holds more
    than one frame."""
    assert tile_frames(2048, 512, 1292) == 16
    assert tile_frames(400, 160, 3001) == 56
    assert tile_frames(2048, 1, 10 ** 6) == 64
    assert tile_frames(k7.MAX_FRAME_LENGTH, 512, 100) == 1
    assert tile_frames(2048, 512, 5) == 5
    for n, hop in itertools.product((7, 400, 2048, 8192), (1, 3, 160, 512, 4096)):
        ft = tile_frames(n, hop, 10 ** 5)
        assert ft >= 1 and (ft <= WARPS or ft % WARPS == 0)
        assert ft == 1 or (ft - 1) * hop + n <= SEG_BUDGET
