"""PyTorch port: K7 (the frame statistics kernel) on the card, against its
plain twin.

A CUDA kernel has no CPU mode, so these tests skip without a card. They
import no JAX: on a machine with the card, run them with the repository's
conftest left out (it imports JAX)::

    python -m pytest --noconftest -m cuda tests/test_torch_port_frame_stats_cuda.py

K7's zero-crossing rate counts sign-bit changes exactly and divides as the
twin does on the card (a product with the float32 reciprocal of the frame
length), so it is the twin's bit for bit (``torch.equal``, NaN nowhere: a
NaN sample has a sign bit like any other). Its RMS sums each frame's
squares in another order than PyTorch's reduction: within 1e-6 of the
twin's largest value, NaN where the twin's is. The public ops take K7 for a
non-empty (B, L) or (L,) signal on the card, one launch a call, counted as
``dispatch.kernel.<op>`` while the port records.
"""

from __future__ import annotations

import itertools

import pytest
import torch

import mlx_audio_primitives_tpu_torch as ap
from mlx_audio_primitives_tpu_torch.kernels import frame_stats as k7
from mlx_audio_primitives_tpu_torch.utils import profiler

pytestmark = pytest.mark.cuda

OPS = {"zero_crossing_rate": ap.zero_crossing_rate, "rms": ap.rms}


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 has no CPU mode")
    return torch.device("cuda", 0)


def clips(shape, card, seed=0, special=False) -> torch.Tensor:
    """Standard-normal clips made on the card; with ``special``, runs of
    exact zeros and of -0.0 and a NaN in every clip, +-inf in two."""
    gen = torch.Generator(device=card).manual_seed(seed)
    y = torch.randn(shape, generator=gen, device=card)
    if special:
        y[..., 100:180] = 0.0
        y[..., 200:230] = -0.0
        y[..., 181::97] = -0.0
        y[..., 777] = float("nan")
        y[0, 1500] = float("inf")
        y[-1, 2500] = float("-inf")
    return y


def assert_agrees(stat, got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    if stat == "zero_crossing_rate":
        assert torch.equal(got, want)
        return
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    finite = torch.isfinite(want)
    assert torch.equal(got[~finite & ~nan], want[~finite & ~nan])
    if finite.any():  # a clip shorter than a frame may hold a NaN in every one
        gap = (got[finite].double() - want[finite].double()).abs().max()
        assert float(gap) <= 1e-6 * float(want[finite].abs().max())


def run(stat, y, **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 (one launch counted) and its twin."""
    kw = dict(stat=stat, **kw)
    before = k7.KERNEL.launches
    got = k7.frame_stats_fused(y, **kw)
    torch.cuda.synchronize()
    assert k7.KERNEL.launches == before + 1
    return got, k7.frame_stats_plain(y, **kw)


PADS = [(True, "constant"), (True, "edge"), (False, "constant")]
PAD_IDS = ["constant", "edge", "no-center"]


@pytest.mark.parametrize("center,pad_mode", PADS, ids=PAD_IDS)
@pytest.mark.parametrize("stat", ["zero_crossing_rate", "rms"])
def test_k7_at_the_feature_cells_batch(card, stat, center, pad_mode):
    """64 x 30 s at frame 2048, hop 512 (the 16-byte path), with zeros,
    -0.0, NaN and +-inf in the clips."""
    y = clips((64, 661_500), card, seed=1, special=True)
    got, want = run(stat, y, frame_length=2048, hop_length=512, center=center, pad_mode=pad_mode)
    assert got.shape == (64, 1, 1 + (661_500 - (0 if center else 2048)) // 512)
    assert_agrees(stat, got, want)


# frame and hop: the ops' default, a 1024-sample frame, Whisper's 400 at 160,
# hops of 1, and a length that is not a multiple of 4 (clips whose starts
# are not 16-byte aligned: the scalar path), at batch 1 and 64
GEOMETRIES = list(itertools.product((2048, 1024, 400), (512, 160, 1)))


@pytest.mark.parametrize("frame_length,hop_length", GEOMETRIES,
                         ids=[f"{n}-{h}" for n, h in GEOMETRIES])
@pytest.mark.parametrize("stat", ["zero_crossing_rate", "rms"])
def test_k7_frames_and_hops(card, stat, frame_length, hop_length):
    for (B, L), (center, pad_mode) in itertools.product(((1, 30_001), (64, 4_099)), PADS):
        if hop_length == 1:
            L = min(L, 3_001)
        y = clips((B, L), card, seed=frame_length + hop_length + B, special=L > 3_000)
        got, want = run(stat, y, frame_length=frame_length, hop_length=hop_length, center=center,
                        pad_mode=pad_mode)
        assert_agrees(stat, got, want)


@pytest.mark.parametrize("stat", ["zero_crossing_rate", "rms"])
def test_k7_scalar_path_and_long_frames(card, stat):
    """Frames and hops that are not multiples of 4, a clip shorter than
    the centre pad, the longest frame K7 takes, and a strided input (copied
    first)."""
    for (B, L), n, hop, center in (((3, 10_001), 7, 3, True), ((2, 5_000), 1_001, 333, True),
                                   ((4, 300), 2048, 512, True),
                                   ((2, 70_000), k7.MAX_FRAME_LENGTH, 4096, True),
                                   ((2, 70_000), k7.MAX_FRAME_LENGTH, 5, False)):
        for pad_mode in ("constant", "edge"):
            y = clips((B, L), card, seed=n + hop)
            got, want = run(stat, y, frame_length=n, hop_length=hop, center=center,
                            pad_mode=pad_mode)
            assert_agrees(stat, got, want)
    y = clips((6, 44_100), card, seed=5)[::2, 1:]
    got, want = run(stat, y, frame_length=2048, hop_length=512, center=True, pad_mode="edge")
    assert_agrees(stat, got, want)


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


@pytest.mark.parametrize("shape", [(4, 66_150), (66_150,)], ids=["2d", "1d"])
@pytest.mark.parametrize("stat", ["zero_crossing_rate", "rms"])
def test_public_ops_take_k7(card, stat, shape):
    """One K7 launch a call, counted as ``dispatch.kernel.<op>``; a 1-D
    signal gives ``(1, F)``, the row of its batch of one; the result is the
    twin's (the op's own pad mode)."""
    y = clips(shape, card, seed=11)
    before = k7.KERNEL.launches
    out = []
    counters = counted(lambda: out.append(OPS[stat](y)))
    assert k7.KERNEL.launches == before + 1
    assert counters.get(f"dispatch.kernel.{stat}") == 1
    F = 1 + shape[-1] // 512
    got = out[0]
    assert got.shape == ((1, F) if len(shape) == 1 else (shape[0], 1, F))
    pad_mode = "edge" if stat == "zero_crossing_rate" else "constant"
    want = k7.frame_stats_plain(y if len(shape) == 2 else y[None], stat=stat, frame_length=2048,
                                hop_length=512, center=True, pad_mode=pad_mode)
    assert_agrees(stat, got if len(shape) == 2 else got[None], want)


@pytest.mark.parametrize("stat", ["zero_crossing_rate", "rms"])
def test_other_inputs_take_the_twin(card, stat):
    """A frame longer than K7 takes and an empty batch take the twin,
    counted with their reasons; no launch."""
    y = clips((2, 40_000), card, seed=13)
    before = k7.KERNEL.launches
    counters = counted(lambda: (OPS[stat](y, frame_length=k7.MAX_FRAME_LENGTH + 1),
                                OPS[stat](y[:0], pad_mode="constant")))
    assert k7.KERNEL.launches == before
    assert counters.get(f"dispatch.plain.{stat}.gate") == 1
    assert counters.get(f"dispatch.plain.{stat}.nonempty") == 1


def test_k7_on_a_side_stream(card):
    """The launch runs on the caller's current stream, and its result there
    is the default stream's, bit for bit."""
    y = clips((8, 100_000), card, seed=17)
    kw = dict(stat="rms", frame_length=2048, hop_length=512, center=True, pad_mode="constant")
    want = k7.frame_stats_fused(y, **kw)
    side = torch.cuda.Stream(device=card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        got = k7.frame_stats_fused(y, **kw)
    side.synchronize()
    assert torch.equal(got, want)


def test_rms_gradient_is_the_twins(card):
    y = clips((2, 30_000), card, seed=19)
    kw = dict(stat="rms", frame_length=2048, hop_length=512, center=True, pad_mode="constant")
    g = clips((2, 1, 59), card, seed=23)
    grads = []
    for fn in (k7.frame_stats_fused, k7.frame_stats_plain):
        x = y.clone().requires_grad_(True)
        (fn(x, **kw) * g).sum().backward()
        grads.append(x.grad)
    assert torch.isfinite(grads[0]).all()
    # the twin's backward in both (unfold's backward may add in any order)
    gap = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert float(gap) <= 1e-6


@pytest.mark.parametrize("shape", [(2, 30_000), (30_000,)], ids=["2d", "1d"])
def test_a_loss_over_both_ops_back_propagates(card, shape):
    """``(zcr.sum() + rms.sum()).backward()`` through the public ops on K7:
    the rate requires no gradient, as the twin's (``signbit`` cuts the
    graph), and the signal's gradient is the plain route's, the RMS twin's."""
    y = clips(shape, card, seed=29)
    grads = []
    for kernel in (True, False):
        x = y.clone().requires_grad_(True)
        if kernel:
            zcr, rms = ap.zero_crossing_rate(x), ap.rms(x)
        else:
            x2 = x if len(shape) == 2 else x[None]
            zcr = k7.frame_stats_plain(x2, stat="zero_crossing_rate", frame_length=2048,
                                       hop_length=512, center=True, pad_mode="edge")
            rms = k7.frame_stats_plain(x2, stat="rms", frame_length=2048, hop_length=512,
                                       center=True, pad_mode="constant")
        assert not zcr.requires_grad and rms.requires_grad
        (zcr.sum() + rms.sum()).backward()
        grads.append(x.grad)
    assert torch.isfinite(grads[0]).all()
    gap = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert float(gap) <= 1e-6
