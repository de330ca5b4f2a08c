"""PyTorch port: K1's ACF entry on the card, against its plain twin.

A CUDA kernel has no CPU mode, so these tests skip without a card. They
import no JAX: on a machine with the card, run them with the repository's
conftest left out (it imports JAX)::

    python -m pytest --noconftest -m cuda tests/test_torch_port_acf_cuda.py

Limit: 1e-5 of max (lag 0 of the loudest frame); the kernel's two float32
FFTs and the twin's FFT and GEMM each round ~1e-7 of it.
"""

from __future__ import annotations

import pytest
import torch

from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
from mlx_audio_primitives_tpu_torch.ops import pitch as tap_pitch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ACF entry's kernel has no CPU mode")
    return torch.device("cuda", 0)


# (frame_length, hop, lo, hi): the port tests' configs and the defaults'
# lag windows at frame 2048 (fmin 50 / fmax 2000, and YIN's 65 / 2093)
SHAPES = [(512, 128, 22, 276), (1024, 256, 27, 368), (2048, 512, 11, 442), (2048, 512, 10, 340),
          (64, 128, 1, 65), (4096, 1024, 3, 4097)]


@pytest.mark.parametrize("W,hop,lo,hi", SHAPES)
def test_acf_entry_matches_its_twin(card, W, hop, lo, hi):
    n_fft = 2 * W
    gen = torch.Generator(device=card).manual_seed(W + lo)
    ypad = torch.randn((3, n_fft + 37 * hop), generator=gen, device=card)
    win = tap_pitch._acf_window_table(W, n_fft, device=card)
    before = k1.KERNEL_ACF.launches
    got = k1.acf_fused(ypad, win, n_fft=n_fft, hop_length=hop, lo=lo, hi=hi)
    torch.cuda.synchronize()
    assert k1.KERNEL_ACF.launches == before + 1
    ref = k1.acf_plain(ypad, win, n_fft=n_fft, hop_length=hop, lo=lo, hi=hi)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5


def test_acf_entry_raises_on_what_it_cannot_take(card):
    ypad = torch.zeros((2, 8192), device=card)
    win = torch.ones(1024, device=card)
    kw = dict(n_fft=1024, hop_length=128, lo=1, hi=300)
    with pytest.raises(ValueError):
        k1.acf_fused(ypad[:, ::2], win, **kw)  # not contiguous
    with pytest.raises(ValueError):
        k1.acf_fused(ypad.double(), win.double(), **kw)
    with pytest.raises(ValueError):
        k1.acf_fused(ypad, win.cpu(), **kw)
