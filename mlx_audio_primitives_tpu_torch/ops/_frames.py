"""Padding, framing and overlap-add as plain PyTorch.

Counterpart of `mlx_audio_primitives_tpu/ops/_frames.py`. The JAX version
rebuilds framing and overlap-add as chunk algebra because the TPU has no
strided views and no cheap scatter; PyTorch has both, so framing is
``Tensor.unfold`` (a view) and overlap-add is ``torch.nn.functional.fold``,
which on CUDA is an output-centric gather (no atomics).

``pad_signal`` gives NumPy's padding semantics, which ``jnp.pad`` shares and
``torch.nn.functional.pad`` does not: a 'reflect' pad may be longer than the
signal (the reflection repeats with period ``2*(L-1)``), as it is for a
1000-sample clip under a centered 2048-point STFT.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tnf


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def num_frames(signal_length: int, frame_length: int, hop_length: int) -> int:
    """Number of full frames: ``1 + (L - frame) // hop``."""
    return 1 + (signal_length - frame_length) // hop_length


def pad_signal(y: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Pad the last axis by ``pad`` samples on both sides with NumPy's
    'constant' (zeros), 'reflect' or 'edge' semantics, for any ``pad``."""
    if pad == 0:
        return y
    if mode == "constant":
        return tnf.pad(y, (pad, pad))
    L = y.shape[-1]
    if L == 0:
        raise ValueError(f"cannot '{mode}'-pad an empty signal")
    i = torch.arange(-pad, L + pad, device=y.device)
    if mode == "edge":
        idx = i.clamp(0, L - 1)
    elif mode == "reflect":
        if L == 1:
            idx = torch.zeros_like(i)
        else:
            period = 2 * (L - 1)
            m = torch.remainder(i, period)
            idx = torch.where(m < L, m, period - m)
    else:
        raise ValueError(f"Unknown pad_mode: '{mode}'")
    return y.index_select(-1, idx)


def frame_signal_batched(
    y: torch.Tensor, frame_length: int, hop_length: int
) -> torch.Tensor:
    """Frame ``(B, L)`` -> ``(B, F, frame_length)`` with F full frames (a
    strided view of ``y``)."""
    check_frame_length(y.shape[-1], frame_length)
    return y.unfold(-1, frame_length, hop_length)


def check_frame_length(signal_length: int, frame_length: int) -> None:
    """Raise unless a (padded) signal holds at least one whole frame."""
    if signal_length < frame_length:
        raise ValueError(
            f"signal length ({signal_length}) must be >= frame_length ({frame_length})"
        )


def windowed_frames(
    y: torch.Tensor, win: torch.Tensor, n_fft: int, hop_length: int,
    center: bool, pad_mode: str,
) -> torch.Tensor:
    """``(B, L)`` -> ``(B, F, n_fft)`` frames times the window, after the
    centre pad of ``n_fft // 2`` when ``center``."""
    if center:
        y = pad_signal(y, n_fft // 2, pad_mode)
    return frame_signal_batched(y, n_fft, hop_length) * win


def overlap_add(fw: torch.Tensor, hop_length: int, output_length: int) -> torch.Tensor:
    """Overlap-add ``(B, F, n_fft)`` frames -> ``(B, output_length)``: frame
    ``f`` lands at sample ``f * hop_length``; the sum is cropped or
    zero-extended to ``output_length``."""
    B, F, n_fft = fw.shape
    total = n_fft + (F - 1) * hop_length
    out = tnf.fold(
        fw.transpose(1, 2), output_size=(1, total), kernel_size=(1, n_fft),
        stride=(1, hop_length),
    ).reshape(B, total)
    if output_length <= total:
        return out[:, :output_length]
    return tnf.pad(out, (0, output_length - total))


def window_envelope(
    win: torch.Tensor, n_frames: int, hop_length: int, output_length: int
) -> torch.Tensor:
    """Sum of squared windows at every output sample (the NOLA denominator)."""
    sq = (win * win).expand(1, n_frames, win.shape[0])
    return overlap_add(sq, hop_length, output_length)[0]
