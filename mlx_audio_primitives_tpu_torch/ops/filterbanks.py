"""Bark- and linear-scale filterbanks.

Counterpart of `mlx_audio_primitives_tpu/ops/filterbanks.py`, with the same
signatures and tables. The Bark conversions are host float64 utilities
(Zwicker with Newton-Raphson inversion, Traunmuller with edge corrections);
the filterbank matrices are host float64 triangular-filter tables cached
per device as float32, like the mel filterbank. As in the JAX package,
the native C++ builders (`_native.py`) are tried first and the NumPy
builders, the JAX package's fallbacks, stand in without them
(`tests/test_torch_port_native.py` holds the two bit-equal).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import FILTERBANK_CACHE_SIZE
from ..utils import dispatch
from ..utils.cache import table_cache
from ..utils.validation import validate_non_negative, validate_positive

ArrayLike = Any

_FORMULAS = ("zwicker", "traunmuller")


def _unknown_formula(formula: str) -> ValueError:
    return ValueError(f"Unknown formula: '{formula}'. Supported: 'zwicker', 'traunmuller'")


def hz_to_bark(frequencies: ArrayLike, formula: str = "zwicker") -> np.ndarray:
    """Convert Hz to Bark (host float64 NumPy).

    'zwicker': 13*atan(0.00076 f) + 3.5*atan((f/7500)^2)  (Zwicker & Terhardt 1980)
    'traunmuller': 26.81 f/(1960+f) - 0.53 with low/high edge corrections.
    """
    f = np.asarray(frequencies, dtype=np.float64)
    if formula == "zwicker":
        return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)
    if formula == "traunmuller":
        bark = (26.81 * f) / (1960.0 + f) - 0.53
        bark = np.where(bark < 2.0, bark + 0.15 * (2.0 - bark), bark)
        bark = np.where(bark > 20.1, bark + 0.22 * (bark - 20.1), bark)
        return bark
    raise _unknown_formula(formula)


def _zwicker_derivative(f: np.ndarray) -> np.ndarray:
    """Analytic d(bark)/d(f) for the Zwicker formula."""
    t1 = 13.0 * 0.00076 / (1.0 + (0.00076 * f) ** 2)
    t2 = 3.5 * (2.0 * f / 7500.0**2) / (1.0 + (f / 7500.0) ** 4)
    return t1 + t2


def bark_to_hz(bark: ArrayLike, formula: str = "zwicker") -> np.ndarray:
    """Convert Bark to Hz (host float64 NumPy).

    The Zwicker formula has no closed-form inverse: a sinh initial guess is
    refined by eight Newton-Raphson steps on the analytic derivative. The
    Traunmuller edge corrections are inverted exactly.
    """
    z = np.asarray(bark, dtype=np.float64)
    if formula == "zwicker":
        hz = 600.0 * np.sinh(z / 6.0)
        for _ in range(8):
            err = hz_to_bark(hz, formula="zwicker") - z
            hz = np.maximum(hz - err / np.maximum(_zwicker_derivative(hz), 1e-12), 0.0)
        return hz
    if formula == "traunmuller":
        zz = np.where(z < 2.0, (z - 0.3) / 0.85, z)
        zz = np.where(zz > 20.1, (zz + 0.22 * 20.1) / 1.22, zz)
        return 1960.0 * (zz + 0.53) / (26.28 - zz)
    raise _unknown_formula(formula)


def _triangular_filterbank(hz_points: np.ndarray, sr: int, n_fft: int,
                           n_bands: int, norm: str | None) -> np.ndarray:
    """Triangular filters on the given Hz edge points, with the optional
    slaney norm (shared by the bark and linear tables)."""
    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    f_lower = hz_points[:-2, None]
    f_center = hz_points[1:-1, None]
    f_upper = hz_points[2:, None]
    freqs = fft_freqs[None, :]
    lower_slope = (freqs - f_lower) / (f_center - f_lower + 1e-10)
    upper_slope = (f_upper - freqs) / (f_upper - f_center + 1e-10)
    fb = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    if norm == "slaney":
        enorm = 2.0 / (hz_points[2 : n_bands + 2] - hz_points[:n_bands])
        fb *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"Unknown norm: '{norm}'. Supported: 'slaney', None")
    return fb


@table_cache("bark_filterbank", maxsize=FILTERBANK_CACHE_SIZE)
def _bark_filterbank_table(
    sr: int, n_fft: int, n_bands: int, fmin: float, fmax: float,
    formula: str, norm: str | None,
) -> np.ndarray:
    """The native C++ builder first (`csrc/tables.cpp::mapt_bark_filterbank`),
    the NumPy builder without it."""
    from .._native import native_bark_filterbank

    fb = native_bark_filterbank(sr, n_fft, n_bands, fmin, fmax, formula, norm)
    if fb is not None:
        return fb
    bark_min = hz_to_bark(np.array([fmin]), formula=formula)[0]
    bark_max = hz_to_bark(np.array([fmax]), formula=formula)[0]
    bark_points = np.linspace(bark_min, bark_max, n_bands + 2)
    hz_points = bark_to_hz(bark_points, formula=formula)
    return _triangular_filterbank(hz_points, sr, n_fft, n_bands, norm)


@table_cache("linear_filterbank", maxsize=FILTERBANK_CACHE_SIZE)
def _linear_filterbank_table(
    sr: int, n_fft: int, n_bands: int, fmin: float, fmax: float, norm: str | None
) -> np.ndarray:
    """The native C++ builder first, the NumPy builder without it."""
    from .._native import native_linear_filterbank

    fb = native_linear_filterbank(sr, n_fft, n_bands, fmin, fmax, norm)
    if fb is not None:
        return fb
    hz_points = np.linspace(fmin, fmax, n_bands + 2)
    return _triangular_filterbank(hz_points, sr, n_fft, n_bands, norm)


def _validate_band_params(n_bands, fmin, fmax, sr, name="n_bands") -> float:
    validate_positive(n_bands, name)
    validate_non_negative(fmin, "fmin")
    if fmax is None:
        fmax = sr / 2.0
    if fmin >= fmax:
        raise ValueError(f"fmin ({fmin}) must be less than fmax ({fmax})")
    if fmax > sr / 2.0:
        raise ValueError(
            f"fmax ({fmax}) cannot exceed Nyquist frequency ({sr / 2.0})"
        )
    return float(fmax)


def bark_filterbank(
    sr: int,
    n_fft: int,
    n_bands: int = 24,
    fmin: float = 0.0,
    fmax: float | None = None,
    formula: str = "zwicker",
    norm: str | None = "slaney",
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Bark-scale filterbank ``(n_bands, n_fft//2 + 1)`` on ``device`` (the
    default device when None, as for a non-tensor input), cached per device."""
    fmax = _validate_band_params(n_bands, fmin, fmax, sr)
    if formula not in _FORMULAS:
        raise _unknown_formula(formula)
    return _bark_filterbank_table(sr, n_fft, n_bands, float(fmin), fmax, formula, norm,
                                  device=dispatch.default_device(device))


def linear_filterbank(
    sr: int,
    n_fft: int,
    n_bands: int = 64,
    fmin: float = 0.0,
    fmax: float | None = None,
    norm: str | None = "slaney",
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Linear-scale filterbank ``(n_bands, n_fft//2 + 1)`` on ``device``
    (the default device when None, as for a non-tensor input), cached per
    device."""
    fmax = _validate_band_params(n_bands, fmin, fmax, sr)
    return _linear_filterbank_table(sr, n_fft, n_bands, float(fmin), fmax, norm,
                                    device=dispatch.default_device(device))
