"""Host-built DFT tables and the exact-length real FFT helpers.

Counterpart of `mlx_audio_primitives_tpu/kernels/dft.py`, which carries the
stacked real-DFT bases of ``fft_mode='matmul'``. The bases are built in
float64 on the host and cached per device as float32 (call a table with
``device=``); the GEMMs that use them are plain ``torch.matmul`` calls.

``rfft_len``, ``irfft_len``, ``rfft_power_len`` and ``_next_pow2`` are the
counterparts of the helpers of `mlx_audio_primitives_tpu/kernels/bluestein.py`.
There they route a length that is not a power of two through a DFT GEMM,
a two-factor GEMM FFT or Bluestein's algorithm, because the TPU's FFT is
fast only at powers of two; ``torch.fft`` takes any length, so here each is
one ``torch.fft`` call (XLA compositions in the JAX package, not kernels).
``irfft_len`` is the one inverse real FFT of the port's plain paths
(``irfft_frames`` goes through it): it carries the repair of cuFFT's
DC and Nyquist bins described there.

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


def irfft_frames(spec: torch.Tensor, n_fft: int, basis: torch.Tensor | None = None, *,
                 owned: bool = False) -> torch.Tensor:
    """irfft over the last axis, ``(..., n_bins) -> (..., n_fft)`` float32:
    :func:`irfft_len` (``owned`` as there), or one FP32 GEMM with the
    inverse basis, whose weights drop the same imaginary parts."""
    if basis is None:
        return irfft_len(spec, n_fft, owned=owned)
    return torch.matmul(torch.cat([spec.real, spec.imag], dim=-1), basis)


def _next_pow2(n: int) -> int:
    """The least power of two >= ``n`` (1 for ``n <= 1``)."""
    return 1 << (int(n - 1)).bit_length()


def rfft_len(x: torch.Tensor, n: int) -> torch.Tensor:
    """rfft of real input already of length ``n`` -> ``(..., n//2+1)``."""
    return torch.fft.rfft(x, n=n, dim=-1)


@table_cache("irfft_keep", maxsize=8)
def _irfft_keep(n_bins: int, n: int) -> np.ndarray:
    """``(n_bins, 2)`` multiplier of a spectrum's (real, imaginary) pairs
    that zeroes the imaginary parts an irfft to length ``n`` drops."""
    m = np.ones((n_bins, 2))
    m[0, 1] = 0.0
    if n % 2 == 0 and n_bins > n // 2:
        m[n // 2, 1] = 0.0
    return m


def _drop_edge_imag(X: torch.Tensor, n: int, owned: bool) -> torch.Tensor:
    """``X`` with the imaginary parts of the DC bin and, for even ``n``, the
    Nyquist bin zeroed: in place when ``owned`` (two column writes), else in
    one pass that copies and zeroes together."""
    if owned:
        X[..., 0].imag.zero_()
        if n % 2 == 0 and X.shape[-1] > n // 2:
            X[..., n // 2].imag.zero_()
        return X
    keep = _irfft_keep(X.shape[-1], n, device=X.device)
    return torch.view_as_complex(torch.view_as_real(X.resolve_conj()) * keep)


def irfft_len(X: torch.Tensor, n: int, *, owned: bool = False) -> torch.Tensor:
    """irfft to real output of length ``n`` from ``(..., n//2+1)`` bins.

    The imaginary parts of the DC bin and, for even ``n``, the Nyquist bin
    are dropped, as NumPy's and XLA's irfft (and K3) drop them. cuFFT's
    inverse real transform keeps them, so on CUDA they are zeroed first: in
    ``X`` itself when the caller ``owned`` it (a spectrum it built, whose
    zeroed parts nothing else reads), else in a copy. Without this a
    spectrum that is not Hermitian there (Griffin-Lim's random initial
    phases, the folded Nyquist bin of a downsampling ``resample``, a
    caller's ``istft`` input) would give another signal on CUDA than on
    the CPU."""
    if X.is_cuda and X.is_complex():
        X = _drop_edge_imag(X, n, owned)
    return torch.fft.irfft(X, n=n, dim=-1)


def rfft_power_len(x: torch.Tensor, n: int) -> torch.Tensor:
    """``|rfft(x)|^2`` of real input of length ``n`` -> ``(..., n//2+1)``."""
    S = rfft_len(x, n)
    return S.real**2 + S.imag**2
