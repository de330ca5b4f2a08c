"""K1: the fused filterbank spectrogram, as a CUDA kernel and its plain twin.

Counterpart of `mlx_audio_primitives_tpu/kernels/mel_fused.py`:
``(B, L)`` signal, padded window and a dense ``(n_bins, n_cols)`` matrix W
-> ``|rDFT(window * frame)|^p @ W`` as ``(B, n_cols, F)``, p in {1, 2}.

Source note (`csrc/mel_fused.cu`, ``mel_fused_kernel``). Replaces
``melspectrogram_pallas`` (its ``pallas_call`` in ``_mel_radix_core``).
One block takes one clip and a tile of FB frames (16 at n_fft 2048). In
sub-batches it stages the padded signal segment in shared memory (framing
is index math), runs an FP32 FFT of n_fft/2 complex points per frame in
shared memory plus the real-input split, and keeps one ``|X|^p`` row per
frame in shared memory; then it contracts the FB rows with W, streamed
through shared memory in double-buffered tiles, each thread holding a
register tile of FB/8 frames x 4 columns. Frames and spectrum never reach
device memory; the output is written as ``(B, n_cols, F)`` with no separate
transpose.

What bounds it on this card. The contraction is ~11.6 GFLOP at the scale
configuration (256 x 4 s clips at 22.05 kHz, n_fft 2048, 128 mels;
2 * n_bins * n_cols per frame) on the CUDA cores in FP32, limited by
shared-memory loads per FMA; the FFT front end is limited by latency: each
radix-4 pass is a shared-memory round trip between block barriers, with
two blocks per SM. The layout keeps two blocks per SM and reads each W
element from device memory once per FB frames; tensor-core schemes with
FP32 accuracy (3xTF32, bf16x3) and a register-resident FFT are the next
steps (measurements in ``PERF.md``).

The TPU kernel's radix decimation, folded filterbank (``fold_filterbank``),
128-lane group layout, VMEM block picker and DMA double buffering have no
counterpart: this kernel emits natural bin order, so W is used as given.
"""

from __future__ import annotations

import torch

from ..ops._frames import windowed_frames
from ..utils.dispatch import on_cuda, radix_shape_ok
from ._build import I32, I64, MAX_BATCH, Kernel, P, register, require, with_plain_backward
from .dft import rfft_frames, rfft_twiddles

KERNEL = register(Kernel(
    "mel_fused_kernel", "mel_fused_launch",
    (P, I64, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32),
    source="mlx_audio_primitives_tpu_torch/csrc/mel_fused.cu",
    replaces="mlx_audio_primitives_tpu/kernels/mel_fused.py:581",
))

#: pad_mode -> the kernels' padding code (fft_common.cuh::padded_sample)
PAD_CODES = {"constant": 0, "reflect": 1, "edge": 2}


def melspectrogram_plain(
    y: torch.Tensor,  # (B, L)
    win: torch.Tensor,  # (n_fft,) padded window
    fb_t: torch.Tensor,  # (n_bins, n_cols)
    *,
    n_fft: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
    power: float = 2.0,
    basis: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain twin and plain composition: pad, frame, window, rfft (or the
    forward-basis GEMM), ``|X|^power``, ``@ fb_t`` -> ``(B, n_cols, F)``.
    Any power."""
    frames = windowed_frames(y, win, n_fft, hop_length, center, pad_mode)
    spec = rfft_frames(frames, n_fft, basis)
    p = spec.real**2 + spec.imag**2
    if power == 1.0:
        p = torch.sqrt(p)
    elif power != 2.0:
        p = torch.pow(p, power / 2.0)
    return torch.matmul(p, fb_t).transpose(1, 2)


def _launch(y, win, fb_t, *, n_fft, hop_length, center, pad_mode, power):
    require(y, "y", torch.float32, 2)
    require(win, "win", torch.float32, 1)
    require(fb_t, "fb_t", torch.float32, 2)
    B, L = y.shape
    n_bins, n_cols = fb_t.shape
    if win.shape[0] != n_fft or n_bins != n_fft // 2 + 1:
        raise ValueError(
            f"mel_fused_kernel needs win ({n_fft},) and fb_t ({n_fft // 2 + 1}, n_cols); "
            f"got {tuple(win.shape)} and {tuple(fb_t.shape)}"
        )
    if B > MAX_BATCH:
        raise ValueError(f"mel_fused_kernel takes at most {MAX_BATCH} clips, got {B}")
    pad = n_fft // 2 if center else 0
    F = 1 + (L + 2 * pad - n_fft) // hop_length
    tw = rfft_twiddles(n_fft, device=y.device)
    out = torch.empty((B, n_cols, F), dtype=torch.float32, device=y.device)
    KERNEL.launch(y.device, y.data_ptr(), L, win.data_ptr(), tw.data_ptr(), fb_t.data_ptr(),
                  out.data_ptr(), B, n_fft, hop_length, F, n_cols, pad,
                  PAD_CODES[pad_mode], int(power))
    return out


def melspectrogram_fused(
    y: torch.Tensor,
    win: torch.Tensor,
    fb_t: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
    power: float = 2.0,
) -> torch.Tensor:
    """``(B, L) -> (B, n_cols, F)`` through ``mel_fused_kernel`` on a CUDA
    tensor, through the plain twin on a CPU tensor.

    Requires the radix shape gate (`utils/dispatch.py::radix_shape_ok`) and
    ``power`` in {1, 2}; any window and any dense ``fb_t`` (the contraction
    loops over column tiles, so shared memory does not grow with the
    columns). The backward differentiates the plain twin."""
    if not radix_shape_ok(n_fft, hop_length):
        raise ValueError(
            f"fused mel kernel requires pow2 n_fft = C*hop, hop = R2*128, "
            f"C,R2 <= 8; got n_fft={n_fft}, hop={hop_length}"
        )
    if power not in (1.0, 2.0):
        raise ValueError(f"fused mel kernel supports power in {{1, 2}}, got {power}")
    pad_total = n_fft if center else 0
    if y.shape[1] + pad_total < n_fft:
        raise ValueError(
            f"signal length ({y.shape[1]}) must be >= n_fft ({n_fft}) when center=False"
        )
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode,
              power=float(power))
    if not on_cuda(y, win, fb_t):
        return melspectrogram_plain(y, win, fb_t, **kw)
    return with_plain_backward(_launch, melspectrogram_plain, y, win, fb_t, **kw)
