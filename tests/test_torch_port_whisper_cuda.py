"""PyTorch port: Whisper large-v3's front end on the card: K1's mixed-radix
entry (K1m) against its plain twin, K6's per-item form against its twin, and
the front end against the float64 reference.

A CUDA kernel has no CPU mode, so these tests skip without a card. They
import no JAX: on a machine with the card, run them with the repository's
conftest left out (it imports JAX)::

    python -m pytest --noconftest -m cuda tests/test_torch_port_whisper_cuda.py

K1m's FFT rounds in another order than the twin's passes in torch, and the
bf16 split of a power can move by one bf16 step where the two powers differ
by an ulp, so kernel and twin are held within 2e-5 of the maximum (the fast
entry's class, as K1's fast entry is held to its twin). K6's per-item form
computes the twin's float32 operations in the twin's order: bit for bit, NaN
where the twin has NaN.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

from mlx_audio_primitives_tpu_torch.kernels import db_fused as k6
from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
from mlx_audio_primitives_tpu_torch.models import presets
from mlx_audio_primitives_tpu_torch.ops.mel import mel_filterbank

sys.path.insert(0, str(Path(__file__).parent))
import torch_port_whisper_reference as whisper_ref  # noqa: E402

pytestmark = pytest.mark.cuda

TWIN_TOL = 2e-5
FEATURE_TOL = 2e-4  # Whisper's units (tests/test_torch_port_whisper.py)


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1m and K6 have no CPU mode")
    return torch.device("cuda", 0)


def audio(shape, card, seed=0) -> torch.Tensor:
    """Tones of 100-2,000 Hz and noise at -30 dB, made on the card."""
    gen = torch.Generator(device=card).manual_seed(seed)
    t = torch.arange(shape[-1], device=card) / 16000.0
    f = 100.0 + 1900.0 * torch.rand((shape[0], 1), generator=gen, device=card)
    noise = torch.randn(shape, generator=gen, device=card)
    return (0.3 * torch.sin(2 * torch.pi * f * t) + 0.01 * noise).contiguous()


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype == torch.float32 and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


KW = dict(n_fft=400, hop_length=160, center=True, pad_mode="reflect", power=2.0)


@pytest.mark.parametrize("shape", [(64, 480_000), (1, 8_000)])
def test_k1m_is_its_twin(card, shape):
    """64 windows of 30 s and one of 0.5 s."""
    y = audio(shape, card, seed=shape[0])
    fb = mel_filterbank(16000, 400, 128, 0.0, 8000.0, device=card)
    win = torch.hann_window(400, periodic=True, device=card)
    got = k1.melspectrogram_fused(y, win, fb.t(), **KW)
    want = k1.melspectrogram_mixed_plain(y, win, fb.t(), **KW)
    assert got.shape == (shape[0], 128, 1 + shape[1] // 160)
    assert max_rel(got, want) <= TWIN_TOL


@pytest.mark.parametrize("hop,center,pad_mode,power", [
    (100, False, "constant", 1.0), (400, True, "edge", 2.0), (50, False, "reflect", 1.0),
    (161, True, "reflect", 2.0)])
def test_k1m_over_its_class(card, hop, center, pad_mode, power):
    """The other hops of the class (one that is odd, so that frames start on
    odd samples), uncentred, power 1."""
    y = audio((3, 23_456), card, seed=hop)
    fb = mel_filterbank(16000, 400, 80, 0.0, 8000.0, device=card)
    win = torch.hann_window(400, periodic=True, device=card)
    kw = dict(n_fft=400, hop_length=hop, center=center, pad_mode=pad_mode, power=power)
    got = k1.melspectrogram_fused(y, win, fb.t(), **kw)
    assert max_rel(got, k1.melspectrogram_mixed_plain(y, win, fb.t(), **kw)) <= TWIN_TOL


def test_k1m_with_a_weight_given_per_call(card):
    """A W that no table cache handed out: its plan is packed on the card."""
    gen = torch.Generator(device=card).manual_seed(3)
    w_t = torch.rand((201, 40), generator=gen, device=card)
    y = audio((2, 16_000), card, seed=4)
    win = torch.hann_window(400, periodic=True, device=card)
    got = k1.melspectrogram_fused(y, win, w_t, **KW)
    assert max_rel(got, k1.melspectrogram_mixed_plain(y, win, w_t, **KW)) <= TWIN_TOL


def test_k1m_on_values_that_are_not_finite(card):
    """An inf sample makes the frames that hold it NaN or inf in every
    column, as in the twin's dense product; the other frames are unmoved."""
    y = audio((2, 16_000), card, seed=5)
    y[1, 8_000] = float("inf")
    fb = mel_filterbank(16000, 400, 128, 0.0, 8000.0, device=card)
    win = torch.hann_window(400, periodic=True, device=card)
    got = k1.melspectrogram_fused(y, win, fb.t(), **KW)
    want = k1.melspectrogram_mixed_plain(y, win, fb.t(), **KW)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    ok = torch.isfinite(want)
    assert float((got[ok] - want[ok]).abs().max() / want[ok].abs().max()) <= TWIN_TOL


def per_item_cases(card):
    gen = torch.Generator(device=card).manual_seed(11)
    S = 10.0 ** (torch.rand((64, 128, 3001), generator=gen, device=card) * 14.0 - 12.0)
    special = S.clone()
    special[3, 5, 7], special[9, 100, 2_000], special[63, 127, 2_999] = (
        float("nan"), float("inf"), float("inf"))
    return {"mel": S[..., :-1], "special": special[..., :-1], "dense": S[:5, :7, :333].contiguous(),
            "rows": S[:, 3, :-1]}


@pytest.mark.parametrize("case", ["mel", "special", "dense", "rows"])
@pytest.mark.parametrize("top_db", [80.0, None])
@pytest.mark.parametrize("per_item", [True, False])
def test_k6_per_item_is_its_twin_bit_for_bit(card, case, top_db, per_item):
    S = per_item_cases(card)[case]
    kw = dict(per_item=per_item, scale=1.0 / 40.0, offset=1.0)
    got = k6.to_db_fused(S, 10.0, 1.0, 1e-10, top_db, **kw)
    want = k6.to_db_plain(S, 10.0, 1.0, 1e-10, top_db, **kw)
    assert got.is_contiguous() and got.shape == S.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert same_bits(torch.nan_to_num(got), torch.nan_to_num(want))


def test_k6_per_item_over_more_items_than_slots(card):
    """More items than the workspace has slots: one chunk an item."""
    gen = torch.Generator(device=card).manual_seed(12)
    S = 10.0 ** (torch.rand((5_000, 3, 7), generator=gen, device=card) * 14.0 - 12.0)
    got = k6.to_db_fused(S, 20.0, 2.5, 1e-5, 60.0, per_item=True)
    assert same_bits(got, k6.to_db_plain(S, 20.0, 2.5, 1e-5, 60.0, per_item=True))


def test_front_end_matches_the_reference(card):
    y = audio((8, 480_000), card, seed=6)
    got = presets.whisper_v3_logmel()(y)
    assert got.shape == (8, 128, 3000)
    assert float((got.double() - whisper_ref.log_mel_spectrogram(y)).abs().max()) <= FEATURE_TOL


def test_one_launch_each_and_no_host_wait(card):
    """A batch of the cell: K1m once, K6's per-item form twice (the maximum,
    the floor), nothing on the host waits."""
    y = audio((64, 480_000), card, seed=7)
    front = presets.whisper_v3_logmel()
    front(y)  # the first call builds and loads the library and the tables
    before = k1.KERNEL_MIXED.launches, k6.KERNEL_ITEM.launches, k6.KERNEL.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = front(y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = k1.KERNEL_MIXED.launches, k6.KERNEL_ITEM.launches, k6.KERNEL.launches
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (1, 2, 0)
    assert out.shape == (64, 128, 3000) and bool(torch.isfinite(out).all())


def test_launches_go_to_the_current_stream(card):
    """K1m and K6 launch on the current stream, a side stream too, and
    agree there with the default stream's results."""
    y = audio((2, 16_000), card, seed=8)
    front = presets.whisper_v3_logmel()
    want = front(y)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        got = front(y)
    torch.cuda.current_stream(card).wait_stream(side)
    assert torch.equal(got, want)
