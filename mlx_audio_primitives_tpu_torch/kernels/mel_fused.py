"""K1: the fused filterbank spectrogram, as a CUDA kernel and its plain twin.

Counterpart of `mlx_audio_primitives_tpu/kernels/mel_fused.py`:
``(B, L)`` signal, padded window and a dense ``(n_bins, n_cols)`` matrix W
-> ``|rDFT(window * frame)|^p @ W`` as ``(B, n_cols, F)``, p in {1, 2}.

Source note (`csrc/mel_fused.cu`, ``mel_fused_kernel``). Replaces
``melspectrogram_pallas`` (its ``pallas_call`` in ``_mel_radix_core``).
A persistent grid walks (clip, tile of FT frames) pairs, FT = 16 up to
n_fft 2048. Each tile runs K2's register-resident FFT front end
(`csrc/fft_common.cuh`: the padded segment staged with ``cp.async`` while
the previous tile is contracted, ``first_pass``, ``rexchange_passes``),
then writes each frame's ``|X|^p`` row in natural bin order over the
frame's own spectrum (in rounds of a few frames, through per-thread
scratch slots), split into TF32 hi and lo parts, and contracts the
FT rows with W on the tensor cores: 3xTF32 ``mma.sync`` (lo*hi + hi*lo +
hi*hi in FP32 accumulators), 16 weight columns by 8 frames per product.
A warp owns one 16-column m-tile and a slice of the bins; the number of
m-tiles is ``ceil(n_cols / 16)``, so the cost follows W's columns (a
2-column weight costs one m-tile), and the slices' partial sums meet in
shared memory. Frames, spectra and power rows never reach device memory;
the output is written as ``(B, n_cols, F)`` with no separate transpose.

What bounds it on this card. At the scale configuration (256 x 4 s clips
at 22.05 kHz, n_fft 2048, 128 mels) the three TF32 products are 35 GFLOP
(0.07 ms at the TF32 peak) and the bytes 0.03 ms; W is read from L2 once
per 16-frame tile (1.5 GB there), straight into the tensor-core fragments,
since the frame buffers fill shared memory. The contraction's time grows
with W's columns, that is with this traffic, and it and the front end (no
overlap with the contraction inside a block) are what remain
(measurements in ``PERF.md``).

The TPU kernel's radix decimation, folded filterbank (``fold_filterbank``),
128-lane group layout, VMEM block picker and DMA double buffering have no
counterpart: this kernel emits natural bin order, so W is used as given.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops._frames import windowed_frames
from ..utils.dispatch import on_cuda, radix_shape_ok
from ._build import I32, I64, Kernel, P, library, register, require, with_plain_backward
from .dft import rfft_frames, rfft_twiddles

KERNEL = register(Kernel(
    "mel_fused_kernel", "mel_fused_launch",
    (P, I64, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32),
    source="mlx_audio_primitives_tpu_torch/csrc/mel_fused.cu",
    replaces="mlx_audio_primitives_tpu/kernels/mel_fused.py:581",
))

#: pad_mode -> the kernels' padding code (fft_common.cuh::padded_sample)
PAD_CODES = {"constant": 0, "reflect": 1, "edge": 2}


def launch_geometry(n_fft: int, hop_length: int, device: torch.device) -> dict:
    """K1's launch at ``(n_fft, hop_length)`` on a CUDA ``device``: threads
    per block, frames per tile, dynamic shared memory per block (bytes) and
    resident blocks per SM."""
    fn = library().mel_fused_geometry
    fn.argtypes = [I32, I32, I32, P]
    fn.restype = I32
    info = (ctypes.c_int * 4)()
    err = fn(n_fft, hop_length, device.index, ctypes.cast(info, P))
    if err != 0:
        raise RuntimeError(f"mel_fused_geometry failed: CUDA error {err}")
    return dict(threads=info[0], frames_per_tile=info[1], smem_bytes=info[2],
                blocks_per_sm=info[3])


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
    walks ``ceil(n_cols / 16)`` column tiles, so shared memory does not grow
    with the columns and time follows them). The backward differentiates
    the plain twin."""
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
