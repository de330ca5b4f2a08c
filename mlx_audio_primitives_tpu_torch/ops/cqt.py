"""Constant-Q and variable-Q transforms.

Counterpart of `mlx_audio_primitives_tpu/ops/cqt.py`, with the same
signatures, geometry (fmin C1, 84 bins at 12 an octave) and results: the
Brown & Puckette (1992) frequency-domain method. A float64 host table holds
the conjugated rfft of each hann-windowed, l1-normalized complex wavelet,
centered in a shared power-of-two ``n_fft`` (stacked real and imaginary
planes, equal in bits to the JAX package's), and the transform is one
rectangular-window :func:`~.stft.stft` at that ``n_fft`` followed by one
complex product ``basis @ STFT``.

No kernel runs here, in either package: at the defaults ``n_fft`` is
16384 at hop 512, outside the radix gate, so the STFT is the plain
composition. The product is one complex64 ``torch.matmul`` (FP32; TF32
applies only if the caller turned it on), taken as ``STFT^T @ basis^T``
on the spectrum's ``(B, F, n_bins)`` storage, so no copy of the spectrum
is made; the result is a ``(B, n_bins, F)`` view. Magnitude contract: a
tone of amplitude ``A`` at a bin's center gives ``|C| ~= A/2`` there.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import FILTERBANK_CACHE_SIZE
from ..utils.cache import table_cache
from ..utils.validation import validate_positive
from .stft import magnitude_spectrogram, stft

ArrayLike = Any

# C1 in Hz (MIDI note 24 at A440): librosa's default CQT anchor.
_C1 = 32.70319566257483


def cqt_frequencies(
    n_bins: int, fmin: float = _C1, bins_per_octave: int = 12,
    tuning: float = 0.0,
) -> np.ndarray:
    """Center frequencies of CQT bins (host float64, geometric spacing)."""
    validate_positive(n_bins, "n_bins")
    validate_positive(bins_per_octave, "bins_per_octave")
    correction = 2.0 ** (float(tuning) / bins_per_octave)
    return correction * fmin * 2.0 ** (
        np.arange(n_bins, dtype=np.float64) / bins_per_octave
    )


def _cqt_window(n: int) -> np.ndarray:
    """Symmetric hann in float64."""
    if n == 1:
        return np.ones(1)
    m = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * m / (n - 1))


def _cqt_q(bins_per_octave: int, filter_scale: float) -> float:
    return float(filter_scale) / (2.0 ** (1.0 / bins_per_octave) - 1.0)


def cqt_filter_length(
    sr: int, fmin: float, bins_per_octave: int = 12, filter_scale: float = 1.0
) -> int:
    """Length in samples of the longest (lowest-frequency) CQT filter."""
    return int(np.ceil(_cqt_q(bins_per_octave, filter_scale) * sr / fmin))


def _fft_basis(sr: int, n_fft: int, freqs: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Stacked real/imaginary planes ``(2, n_bins, n_fft//2+1)`` of the
    conjugated rfft of each wavelet, divided by ``n_fft``: row k is a hann-
    windowed complex exponential at ``freqs[k]`` of ``lengths[k]`` samples,
    l1-normalized and centered in the frame, so that by Parseval
    ``basis @ FFT(frame)`` is ``sum_n conj(h_k[n]) frame[n]`` with the phase
    referenced to the filter's center."""
    basis = np.zeros((len(freqs), n_fft), dtype=np.complex128)
    for k, (f, ilen) in enumerate(zip(freqs, lengths)):
        w = _cqt_window(ilen)
        t = np.arange(ilen, dtype=np.float64) - (ilen - 1) / 2.0
        h = w * np.exp(2j * np.pi * f * t / sr)
        h /= np.sum(np.abs(h))
        start = (n_fft - ilen) // 2
        basis[k, start : start + ilen] = h
    B = np.conj(np.fft.fft(basis, axis=1)[:, : n_fft // 2 + 1]) / n_fft
    return np.ascontiguousarray(np.stack([B.real, B.imag]))


@table_cache("cqt_basis", maxsize=FILTERBANK_CACHE_SIZE)
def _cqt_fft_basis(
    sr: int, n_fft: int, n_bins: int, fmin: float, bins_per_octave: int,
    filter_scale: float,
) -> np.ndarray:
    """The constant-Q wavelet bank's table (see :func:`_fft_basis`): filter
    k has ``Q * sr / f_k`` samples, at most ``n_fft``."""
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    Q = _cqt_q(bins_per_octave, filter_scale)
    lengths = [min(int(np.ceil(Q * sr / f)), n_fft) for f in freqs]
    return _fft_basis(sr, n_fft, freqs, lengths)


def _cqt_setup(
    sr: int, n_bins: int, fmin: float | None, bins_per_octave: int,
    filter_scale: float, tuning: float,
) -> tuple[float, int]:
    validate_positive(n_bins, "n_bins")
    validate_positive(bins_per_octave, "bins_per_octave")
    validate_positive(filter_scale, "filter_scale")
    if fmin is None:
        fmin = _C1
    fmin = float(fmin) * 2.0 ** (float(tuning) / bins_per_octave)
    if fmin <= 0:
        raise ValueError(f"fmin must be positive, got {fmin}")
    f_top = fmin * 2.0 ** ((n_bins - 1) / bins_per_octave)
    if f_top > sr / 2.0:
        raise ValueError(
            f"highest CQT bin ({f_top:.1f} Hz) exceeds Nyquist "
            f"({sr / 2.0:.1f} Hz): reduce n_bins or raise sr"
        )
    max_len = cqt_filter_length(sr, fmin, bins_per_octave, filter_scale)
    n_fft = 1 << int(np.ceil(np.log2(max_len)))
    return fmin, n_fft


def _cqt_apply(table: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """``basis @ D`` for the stacked ``(2, n_bins, n_freq)`` table and a
    complex ``(B, n_freq, F)`` spectrum -> ``(B, n_bins, F)``, one complex
    product over the spectrum's ``(B, F, n_freq)`` storage."""
    basis = torch.complex(table[0], table[1])
    return torch.matmul(D.transpose(-1, -2), basis.t()).transpose(-1, -2)


def _transform(y, table_fn, table_args, n_fft, hop_length, pad_mode, fft_mode):
    D = stft(y, n_fft=n_fft, hop_length=hop_length, window="ones", center=True,
             pad_mode=pad_mode, fft_mode=fft_mode)
    return _cqt_apply(table_fn(*table_args, device=D.device), D)


def cqt(
    y: ArrayLike,
    sr: int = 22050,
    hop_length: int = 512,
    fmin: float | None = None,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    tuning: float = 0.0,
    filter_scale: float = 1.0,
    pad_mode: str = "constant",
    fft_mode: str = "auto",
) -> torch.Tensor:
    """Complex constant-Q transform, ``(n_bins, F)`` / ``(B, n_bins, F)``
    complex64 on the input's device. ``fmin`` defaults to C1 (~32.70 Hz);
    frames are centered at the internal ``n_fft``. A tone of amplitude
    ``A`` at a bin's center frequency gives ``|C| ~= A/2`` at that bin."""
    fmin, n_fft = _cqt_setup(sr, n_bins, fmin, bins_per_octave, filter_scale, tuning)
    validate_positive(hop_length, "hop_length")
    args = (int(sr), n_fft, int(n_bins), fmin, int(bins_per_octave), float(filter_scale))
    return _transform(y, _cqt_fft_basis, args, n_fft, hop_length, pad_mode, fft_mode)


def pseudo_cqt(
    y: ArrayLike,
    sr: int = 22050,
    hop_length: int = 512,
    fmin: float | None = None,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    tuning: float = 0.0,
    filter_scale: float = 1.0,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """Magnitude-only approximate CQT: ``|basis| @ |STFT|``, one real
    product. Peak locations track ``|cqt|``; the absolute scale does not
    (``sum |B||Y| >= |sum conj(B) Y|``), as librosa documents for its
    `pseudo_cqt`."""
    fmin, n_fft = _cqt_setup(sr, n_bins, fmin, bins_per_octave, filter_scale, tuning)
    validate_positive(hop_length, "hop_length")
    M = magnitude_spectrogram(y, n_fft=n_fft, hop_length=hop_length, window="ones",
                              center=True, pad_mode=pad_mode)
    table = _cqt_fft_basis(int(sr), n_fft, int(n_bins), fmin, int(bins_per_octave),
                           float(filter_scale), device=M.device)
    return torch.matmul(torch.sqrt(table[0] ** 2 + table[1] ** 2), M)


def _vqt_alpha(bins_per_octave: int) -> float:
    """Relative bandwidth of one bin: (2^(1/B) - 2^(-1/B)) / 2."""
    r = 2.0 ** (1.0 / bins_per_octave)
    return (r - 1.0 / r) / 2.0


@table_cache("vqt_basis", maxsize=FILTERBANK_CACHE_SIZE)
def _vqt_fft_basis(
    sr: int, n_fft: int, n_bins: int, fmin: float, bins_per_octave: int,
    filter_scale: float, gamma: float,
) -> np.ndarray:
    """The variable-Q bank's table (see :func:`_fft_basis`): filter k has
    ``Q_a * sr / (f_k + gamma / alpha)`` samples with ``Q_a =
    filter_scale / alpha``, constant-Q at high frequency and nearing a
    constant ``gamma`` Hz bandwidth at the low end."""
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    alpha = _vqt_alpha(bins_per_octave)
    Qa = float(filter_scale) / alpha
    lengths = [min(int(np.ceil(Qa * sr / (f + gamma / alpha))), n_fft) for f in freqs]
    return _fft_basis(sr, n_fft, freqs, lengths)


def vqt(
    y: ArrayLike,
    sr: int = 22050,
    hop_length: int = 512,
    fmin: float | None = None,
    n_bins: int = 84,
    gamma: float | None = None,
    bins_per_octave: int = 12,
    tuning: float = 0.0,
    filter_scale: float = 1.0,
    pad_mode: str = "constant",
    fft_mode: str = "auto",
) -> torch.Tensor:
    """Complex variable-Q transform, ``(n_bins, F)`` / ``(B, n_bins, F)``
    (librosa `vqt` semantics): each filter's bandwidth is ``alpha * f_k +
    gamma``; ``gamma = 0`` is the constant-Q bank, the default ``24.7 *
    alpha / 0.108`` Hz tracks the ERB bandwidth (Glasberg & Moore). Same
    evaluation and magnitude contract as :func:`cqt`."""
    validate_positive(hop_length, "hop_length")
    validate_positive(n_bins, "n_bins")
    validate_positive(bins_per_octave, "bins_per_octave")
    validate_positive(filter_scale, "filter_scale")
    if fmin is None:
        fmin = _C1
    fmin = float(fmin) * 2.0 ** (float(tuning) / bins_per_octave)
    if fmin <= 0:
        raise ValueError(f"fmin must be positive, got {fmin}")
    alpha = _vqt_alpha(int(bins_per_octave))
    if gamma is None:
        gamma = 24.7 * alpha / 0.108
    if gamma < 0:
        raise ValueError(f"gamma must be non-negative, got {gamma}")
    f_top = fmin * 2.0 ** ((n_bins - 1) / bins_per_octave)
    if f_top > sr / 2.0:
        raise ValueError(
            f"highest VQT bin ({f_top:.1f} Hz) exceeds Nyquist "
            f"({sr / 2.0:.1f} Hz): reduce n_bins or raise sr"
        )
    # longest filter sets the shared transform length
    max_len = int(np.ceil(
        (float(filter_scale) / alpha) * sr / (fmin + float(gamma) / alpha)
    ))
    n_fft = 1 << int(np.ceil(np.log2(max(max_len, 2))))
    args = (int(sr), n_fft, int(n_bins), fmin, int(bins_per_octave), float(filter_scale),
            float(gamma))
    return _transform(y, _vqt_fft_basis, args, n_fft, hop_length, pad_mode, fft_mode)


__all__ = ["cqt_frequencies", "cqt_filter_length", "cqt", "pseudo_cqt", "vqt"]
