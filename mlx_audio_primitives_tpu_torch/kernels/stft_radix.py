"""K2: the fused STFT, as a CUDA kernel and its plain twin.

Counterpart of `mlx_audio_primitives_tpu/kernels/stft_radix.py` (the module
keeps that name so the two are easy to pair; the port's kernel is a plain
radix-2 FFT, not the TPU's radix-decimated DFT): ``(B, L)`` signal and
padded window -> complex64 ``(B, n_bins, F)``.

Source note (`csrc/stft.cu`, ``stft_kernel``). Replaces ``stft_pallas``:
both TPU cores, the grouped emit (``pallas_call`` in ``_stft_radix_core``)
and the transposed emit (``pallas_call`` in ``_stft_radix_core_t``), and
the gathers that naturalize their layouts, become one kernel that writes
natural bin order. Staging, padding, windowing and the shared-memory FP32
FFT are K1's (`csrc/fft_common.cuh::frames_fft`); each bin goes to the
output interleaved (re, im), which ``torch.view_as_real`` of the complex64
output receives. What bounds it on this card: the FFT's shared-memory
butterflies (5*n_fft*log2(n_fft) flops per frame, each stage a pass over
shared memory between barriers) and the output write, 8 bytes per bin per
frame, 4x the input it reads. The design reads the input once per tile
and writes each bin once, frames fastest across threads so neighbouring
threads store neighbouring addresses.
"""

from __future__ import annotations

import torch

from .._config import COMPLEX_DTYPE
from ..ops._frames import windowed_frames
from ..utils.dispatch import on_cuda, radix_shape_ok
from ._build import I32, I64, MAX_BATCH, Kernel, P, register, require, with_plain_backward
from .dft import rfft_frames, rfft_twiddles
from .mel_fused import PAD_CODES

KERNEL = register(Kernel(
    "stft_kernel", "stft_launch",
    (P, I64, P, P, P, I32, I32, I32, I32, I32, I32),
    source="mlx_audio_primitives_tpu_torch/csrc/stft.cu",
    # also the transposed-emit core's pallas_call at :390 (see the note above)
    replaces="mlx_audio_primitives_tpu/kernels/stft_radix.py:624",
))


def stft_plain(
    y: torch.Tensor,  # (B, L)
    win: torch.Tensor,  # (n_fft,) padded window
    *,
    n_fft: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
    basis: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain twin and plain composition: pad, frame, window, rfft (or the
    forward-basis GEMM) -> complex64 ``(B, n_bins, F)``."""
    frames = windowed_frames(y, win, n_fft, hop_length, center, pad_mode)
    return rfft_frames(frames, n_fft, basis).transpose(1, 2)


def _launch(y, win, *, n_fft, hop_length, center, pad_mode):
    require(y, "y", torch.float32, 2)
    require(win, "win", torch.float32, 1)
    if win.shape[0] != n_fft:
        raise ValueError(f"stft_kernel needs a ({n_fft},) window, got {tuple(win.shape)}")
    B, L = y.shape
    if B > MAX_BATCH:
        raise ValueError(f"stft_kernel takes at most {MAX_BATCH} clips, got {B}")
    pad = n_fft // 2 if center else 0
    F = 1 + (L + 2 * pad - n_fft) // hop_length
    tw = rfft_twiddles(n_fft, device=y.device)
    out = torch.empty((B, n_fft // 2 + 1, F), dtype=COMPLEX_DTYPE, device=y.device)
    KERNEL.launch(y.device, y.data_ptr(), L, win.data_ptr(), tw.data_ptr(),
                  torch.view_as_real(out).data_ptr(), B, n_fft, hop_length, F, pad,
                  PAD_CODES[pad_mode])
    return out


def stft_fused(
    y: torch.Tensor,
    win: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
) -> torch.Tensor:
    """``(B, L) -> complex64 (B, n_bins, F)`` through ``stft_kernel`` on a
    CUDA tensor, through the plain twin on a CPU tensor. The backward
    differentiates the plain twin."""
    if not radix_shape_ok(n_fft, hop_length):
        raise ValueError(
            f"fused STFT kernel requires pow2 n_fft = C*hop, hop = R2*128, "
            f"C,R2 <= 8; got n_fft={n_fft}, hop={hop_length}"
        )
    pad_total = n_fft if center else 0
    if y.shape[1] + pad_total < n_fft:
        raise ValueError(
            f"signal length ({y.shape[1]}) must be >= n_fft ({n_fft}) when center=False"
        )
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode)
    if not on_cuda(y, win):
        return stft_plain(y, win, **kw)
    return with_plain_backward(_launch, stft_plain, y, win, **kw)
