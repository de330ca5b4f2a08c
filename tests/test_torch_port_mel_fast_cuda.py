"""PyTorch port: K1's two contraction entries on the card, against their twins.

A CUDA kernel has no CPU mode, so these tests skip without a card. They
import no JAX: on a machine with the card, run them with the repository's
conftest left out (it imports JAX)::

    python -m pytest --noconftest -m cuda tests/test_torch_port_mel_fast_cuda.py

Limits, of max: the fast entry (bf16x3, over its plan's band) within 1e-5
of its twin (the same splits; they differ where the kernel's and the twin's
float32 powers round ``lo`` to different bf16 neighbours, 2^-17 of a bin's
power at most) and within 3e-5 of float64, the JAX fast mode's class; the
dense entry (3xTF32) within 1e-5 of its twin, as before the fast entry
existed.
"""

from __future__ import annotations

import pytest
import torch

from mlx_audio_primitives_tpu_torch import _config as tap_config
from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
from mlx_audio_primitives_tpu_torch.ops._frames import windowed_frames
from mlx_audio_primitives_tpu_torch.ops.mel import mel_filterbank

pytestmark = pytest.mark.cuda


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1's entries have no CPU mode")
    return torch.device("cuda", 0)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


# (n_fft, hop, n_cols, power, center): the 128-mel weight at the scale
# configuration's shape, the chroma-width 12 columns, a centroid's 2, power 1,
# and the radix gate's ends
SHAPES = [(2048, 512, 128, 2.0, True), (2048, 512, 12, 2.0, True), (2048, 512, 2, 1.0, True),
          (128, 128, 40, 2.0, True), (512, 128, 200, 1.0, False), (8192, 1024, 96, 2.0, True)]


@pytest.mark.parametrize("n_fft,hop,n_cols,power,center", SHAPES)
def test_entries_match_their_twins(card, n_fft, hop, n_cols, power, center):
    gen = torch.Generator(device=card).manual_seed(n_fft + n_cols)
    y = torch.randn((3, 40 * hop + 77), generator=gen, device=card)
    win = torch.hann_window(n_fft, device=card)
    fb_t = (mel_filterbank(22050, n_fft, n_cols, device=card).t().contiguous() if n_cols > 12
            else torch.rand((n_fft // 2 + 1, n_cols), generator=gen, device=card))
    kw = dict(n_fft=n_fft, hop_length=hop, center=center, pad_mode="reflect", power=power)
    frames = windowed_frames(y.double(), win.double(), n_fft, hop, center, "reflect")
    exact = torch.matmul(torch.fft.rfft(frames).abs() ** power, fb_t.double()).transpose(1, 2)
    for kernel, fast, limit_64 in ((k1.KERNEL, False, 1e-5), (k1.KERNEL_FAST, True, 3e-5)):
        before = kernel.launches
        got = k1.melspectrogram_fused(y, win, fb_t, fast_gemm=fast, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        ref = k1.melspectrogram_plain(y, win, fb_t, fast_gemm=fast, **kw)
        assert got.shape == ref.shape == exact.shape
        assert rel(got, ref) <= 1e-5
        assert rel(got, exact) <= limit_64


def test_fast_entry_on_a_cached_table_and_frames_that_are_not_finite(card):
    """The 128-mel table through its transpose view (its cached band plan,
    73 of 520 blocks) on clips with an inf and a NaN sample: NaN in every
    column of each frame they reach, as in the twin, the finite values
    within 1e-5 of max of it."""
    y = torch.randn((4, 22050), device=card)
    y[1, 5000] = float("inf")
    y[2, 9000] = float("nan")
    win = torch.hann_window(2048, device=card)
    fb_t = mel_filterbank(22050, 2048, 128, device=card).t()
    assert k1.contracted_blocks(fb_t) == (73, 520)
    kw = dict(n_fft=2048, hop_length=512, center=True, pad_mode="constant")
    got = k1.melspectrogram_fused(y, win, fb_t, fast_gemm=True, **kw)
    ref = k1.melspectrogram_plain(y, win, fb_t, fast_gemm=True, **kw)
    bad = ~torch.isfinite(ref).all(1)
    assert bad.any() and torch.isnan(got).all(1)[bad].all()
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = torch.isfinite(ref)
    assert rel(got[fin], ref[fin]) <= 1e-5


@pytest.mark.parametrize("per_call", [False, True])
def test_fast_entry_with_an_all_zero_m_tile(card, per_call):
    """A cached table whose second m-tile is all zero (one k-step in its
    plan), and the same W given per call (a full-range plan packed by the
    launch): both within 1e-5 of the twin, the empty columns zero."""
    import numpy as np

    from mlx_audio_primitives_tpu_torch.utils.cache import TableCache

    def build():
        fb = mel_filterbank(22050, 2048, 40, device="cpu").double().numpy()
        return np.concatenate([fb[:16], np.zeros((16, fb.shape[1])), fb[16:]])

    table = TableCache("cuda_test_zero_tile", build)(device=card)
    fb_t = table.t().contiguous() if per_call else table.t()
    used, every = k1.contracted_blocks(fb_t)
    assert every == 260 and (used == every) == per_call
    y = torch.randn((3, 44100), device=card)
    win = torch.hann_window(2048, device=card)
    kw = dict(n_fft=2048, hop_length=512, center=True, pad_mode="reflect")
    got = k1.melspectrogram_fused(y, win, fb_t, fast_gemm=True, **kw)
    ref = k1.melspectrogram_plain(y, win, fb_t, fast_gemm=True, **kw)
    assert rel(got, ref) <= 1e-5 and not got[:, 16:32].any()


def test_none_follows_the_config(card, monkeypatch):
    y = torch.randn((2, 22050), device=card)
    win = torch.hann_window(2048, device=card)
    fb_t = mel_filterbank(22050, 2048, 128, device=card).t().contiguous()
    kw = dict(n_fft=2048, hop_length=512, center=True, pad_mode="constant")
    for mode, kernel in ((True, k1.KERNEL_FAST), (False, k1.KERNEL)):
        monkeypatch.setattr(tap_config, "ANALYSIS_FAST_GEMM", mode)
        before = kernel.launches
        auto = k1.melspectrogram_fused(y, win, fb_t, **kw)
        assert kernel.launches == before + 1
        assert torch.equal(auto, k1.melspectrogram_fused(y, win, fb_t, fast_gemm=mode, **kw))
