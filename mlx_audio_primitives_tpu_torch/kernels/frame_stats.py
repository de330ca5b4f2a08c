"""K7: the per-frame statistics of time-domain frames, the zero-crossing rate
and the RMS energy, as one CUDA kernel, and its plain twin.

Counterpart of `mlx_audio_primitives_tpu/ops/features.py::zero_crossing_rate`
and `mlx_audio_primitives_tpu/ops/framing.py::rms`: the JAX package leaves
both to XLA, so there is no ``pallas_call`` to replace. In the port each was
a composition of PyTorch passes over an ``unfold`` view of the centre-padded
signal, which wrote (B, F, frame_length) intermediates: the squares for
RMS; the sign bits, their comparison and its float32 cast for ZCR.

Source note (`csrc/frame_stats.cu`, ``frame_stats_kernel<STAT>``). On this
card it is bound by device-memory bytes: one read of the audio and one
write of a float a frame. A block stages the segment of a tile of
consecutive frames of one clip in shared memory (cp.async, 16 bytes a copy;
the centre pad read through the index, never written), so the audio is read
from device memory once and the frames' overlap is served from shared
memory, and each warp reduces whole frames: ZCR by warp votes of the sign
bits and popcounts, exact, so bit for bit the twin; RMS as float32 sums of
squares per lane and a warp tree, each frame on its own, ~1e-7 of the twin's
value apart (the twin sums in PyTorch's order).
"""

from __future__ import annotations

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..ops._frames import check_frame_length, frame_signal_batched, pad_signal
from ..utils.dispatch import on_cuda
from ..utils.profiler import traced
from ._build import F32, I32, I64, Kernel, P, register, require, with_plain_backward
from .mel_fused import PAD_CODES

KERNEL = register(Kernel(
    "frame_stats_kernel", "frame_stats_launch",
    (P, I64, I64, P, I32, I32, I32, I32, I32, I32, F32),
    source="mlx_audio_primitives_tpu_torch/csrc/frame_stats.cu",
    replaces="mlx_audio_primitives_tpu/ops/features.py:374",
))

#: The statistics K7 computes, by the code its launcher takes
STATS = {"zero_crossing_rate": 0, "rms": 1}

#: The longest frame K7 takes: its segment alone fills 64 KB of shared
#: memory (`csrc/frame_stats.cu`, ``kMaxFrameLength``)
MAX_FRAME_LENGTH = 16384


def frame_stats_ok(y: torch.Tensor, frame_length: int) -> bool:
    """K7's shape gate: a batch of signals ``(B, L)`` and a frame of at
    most :data:`MAX_FRAME_LENGTH` samples."""
    return y.dim() == 2 and frame_length <= MAX_FRAME_LENGTH


def frame_stats_plain(
    y: torch.Tensor,
    *,
    stat: str,
    frame_length: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
) -> torch.Tensor:
    """Plain twin and plain composition of K7: the centre pad of
    ``frame_length // 2`` samples (when ``center``), the frames as an
    ``unfold`` view, then per frame the root-mean-square (``rms``) or the
    share of neighbouring samples whose sign bits differ
    (``zero_crossing_rate``) ->
    ``(B, 1, F)``."""
    if center:
        y = pad_signal(y, frame_length // 2, pad_mode)
    frames = frame_signal_batched(y, frame_length, hop_length)
    if stat == "rms":
        out = torch.sqrt(torch.mean(frames**2, dim=-1, keepdim=True))
    else:
        sign = torch.signbit(frames)
        crossings = (sign[..., 1:] != sign[..., :-1]).to(REAL_DTYPE)
        out = torch.sum(crossings, dim=-1, keepdim=True) / frame_length
    return out.transpose(1, 2)


def _launch(y: torch.Tensor, *, stat: str, frame_length: int, hop_length: int, center: bool,
            pad_mode: str) -> torch.Tensor:
    y = y.contiguous()
    require(y, "y", torch.float32, 2)
    B, L = y.shape
    pad = frame_length // 2 if center else 0
    F = 1 + (L + 2 * pad - frame_length) // hop_length
    # the rate's divisor as PyTorch's CUDA division by a host scalar forms
    # it: the float32 reciprocal, rounded on the host
    inv = float(np.float32(1.0) / np.float32(frame_length))
    out = torch.empty((B, 1, F), dtype=torch.float32, device=y.device)
    KERNEL.launch(y.device, y.data_ptr(), B, L, out.data_ptr(), frame_length, hop_length, F, pad,
                  PAD_CODES[pad_mode] if center else 0, STATS[stat], inv)
    return out


@traced("kernels.frame_stats_fused")
def frame_stats_fused(
    y: torch.Tensor,
    *,
    stat: str,
    frame_length: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
) -> torch.Tensor:
    """``(B, L) -> float32 (B, 1, F)``: per frame of ``frame_length``
    samples at ``hop_length``, after the centre pad when ``center``
    ('constant' or 'edge'), the RMS energy (``stat="rms"``) or the
    zero-crossing rate (``"zero_crossing_rate"``), through ``frame_stats_kernel`` on a
    CUDA tensor, through the plain twin on a CPU tensor. The RMS's backward
    differentiates the plain twin; the rate, like the twin's (``signbit``
    cuts the graph), has none."""
    if stat not in STATS:
        raise ValueError(f"stat must be one of {sorted(STATS)}, got {stat!r}")
    if not frame_stats_ok(y, frame_length):
        raise ValueError(f"{KERNEL.name} takes (B, L) signals and frames of at most "
                         f"{MAX_FRAME_LENGTH} samples, got {tuple(y.shape)} and {frame_length}")
    check_frame_length(y.shape[-1] + (2 * (frame_length // 2) if center else 0), frame_length)
    kw = dict(stat=stat, frame_length=frame_length, hop_length=hop_length, center=center,
              pad_mode=pad_mode)
    if not on_cuda(y):
        return frame_stats_plain(y, **kw)
    if stat == "zero_crossing_rate":
        return _launch(y, **kw)
    return with_plain_backward(_launch, frame_stats_plain, y, **kw)
