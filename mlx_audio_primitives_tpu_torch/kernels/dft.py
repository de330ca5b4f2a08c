"""Host-built DFT tables.

Counterpart of `mlx_audio_primitives_tpu/kernels/dft.py`, which carries the
stacked real-DFT bases of ``fft_mode='matmul'``. The bases are built in
float64 on the host and cached per device as float32 (call a table with
``device=``); the GEMMs that use them are plain ``torch.matmul`` calls.

``rfft_twiddles`` is the one table the port's CUDA FFTs share (K1-K3): the
float64 roots of unity, rounded once to float32. The kernels take it as an
argument, so no kernel evaluates a sine or a cosine.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.cache import table_cache


@table_cache("dft_basis_fwd", maxsize=8)
def forward_basis(n_fft: int) -> np.ndarray:
    """Stacked ``(n_fft, 2*n_bins)`` [cos | -sin] forward rDFT basis (f64 host)."""
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)


@table_cache("dft_basis_inv", maxsize=8)
def inverse_basis(n_fft: int) -> np.ndarray:
    """Stacked ``(2*n_bins, n_fft)`` inverse rDFT basis with hermitian weights."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    w = np.full((n_bins, 1), 2.0, dtype=np.float64)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    w /= n_fft
    return np.concatenate([w * np.cos(ang), -w * np.sin(ang)], axis=0)


@table_cache("rfft_twiddles", maxsize=8)
def rfft_twiddles(n_fft: int) -> np.ndarray:
    """``(n_fft//2 + 1, 2)`` table of ``exp(-2*pi*i*k/n_fft)``, k = 0..n_fft/2,
    as (cos, sin) pairs in float64, with values within 1e-12 of 0 or +-1
    snapped to them (``k < n_fft``, so the angle needs no further
    reduction)."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    ang = -2.0 * np.pi * k / n_fft
    t = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    r = np.round(t)
    return np.where(np.abs(t - r) < 1e-12, r, t)


def rfft_frames(frames: torch.Tensor, n_fft: int, basis: torch.Tensor | None = None) -> torch.Tensor:
    """rfft over the last axis, ``(..., n_fft) -> (..., n_bins)`` complex64:
    ``torch.fft.rfft``, or one FP32 GEMM with the forward basis."""
    if basis is None:
        return torch.fft.rfft(frames, dim=-1)
    n_bins = n_fft // 2 + 1
    ri = torch.matmul(frames, basis)
    return torch.complex(ri[..., :n_bins], ri[..., n_bins:])


def irfft_frames(spec: torch.Tensor, n_fft: int, basis: torch.Tensor | None = None) -> torch.Tensor:
    """irfft over the last axis, ``(..., n_bins) -> (..., n_fft)`` float32:
    ``torch.fft.irfft``, or one FP32 GEMM with the inverse basis."""
    if basis is None:
        return torch.fft.irfft(spec, n=n_fft, dim=-1)
    return torch.matmul(torch.cat([spec.real, spec.imag], dim=-1), basis)
