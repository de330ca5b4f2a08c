"""Harmonic interpolation and salience maps.

Counterpart of `mlx_audio_primitives_tpu/ops/harmonics.py`, with the same
signatures and results (librosa `interp_harmonics` / `salience`): for a
fixed frequency grid the linear interpolation at each harmonic is a static
(gather index, lerp weight) plan, built once on the host per (grid,
harmonics) and applied on the device as two gathers and one fused
multiply-add over every frame and batch axis.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..utils import dispatch

ArrayLike = Any

__all__ = ["interp_harmonics", "salience"]


@lru_cache(maxsize=32)
def _interp_plan_on(freqs_key: tuple, harmonics_key: tuple, device: str):
    """:func:`_interp_plan` on ``device``: the low indices flattened as
    int64, the weights and the validity ``(n_h, n_bins, 1)`` (shared;
    callers must not modify them)."""
    idx_lo, w_hi, valid = _interp_plan(freqs_key, harmonics_key)
    return (torch.from_numpy(idx_lo.astype(np.int64).ravel()).to(device),
            torch.from_numpy(w_hi).to(device)[:, :, None],
            torch.from_numpy(valid).to(device)[:, :, None])


@lru_cache(maxsize=32)
def _interp_plan(freqs_key: tuple, harmonics_key: tuple):
    """``(idx_lo, w_hi, valid)`` host arrays, each ``(n_h, n_bins)``."""
    freqs = np.asarray(freqs_key, dtype=np.float64)
    harmonics = np.asarray(harmonics_key, dtype=np.float64)
    n = len(freqs)
    targets = harmonics[:, None] * freqs[None, :]  # (n_h, n)
    idx_hi = np.searchsorted(freqs, targets)  # first freq >= target
    idx_hi = np.clip(idx_hi, 1, n - 1)
    idx_lo = idx_hi - 1
    span = freqs[idx_hi] - freqs[idx_lo]
    span = np.where(span <= 0, 1.0, span)
    w_hi = (targets - freqs[idx_lo]) / span
    valid = (targets >= freqs[0]) & (targets <= freqs[-1])
    return idx_lo.astype(np.int32), w_hi.astype(np.float32), valid


def interp_harmonics(
    x: ArrayLike,
    freqs: ArrayLike,
    harmonics: ArrayLike = (1, 2, 3, 4),
    fill_value: float = 0.0,
) -> torch.Tensor:
    """Resample ``x`` at harmonic multiples of its frequency axis:
    ``(n_harmonics, ..., n_bins, F)`` with ``out[h, ..., k, t] = x[...,
    freq -> harmonics[h] * freqs[k], t]`` (linear interpolation along the
    frequency axis, ``fill_value`` outside the grid)."""
    x = dispatch.to_tensor(x, REAL_DTYPE)
    if x.dim() < 2:
        raise ValueError(
            f"interp_harmonics expects (..., n_bins, F) input, got {x.dim()}-D"
        )
    f = np.asarray(freqs.cpu() if isinstance(freqs, torch.Tensor) else freqs, dtype=np.float64)
    if f.ndim != 1 or f.shape[0] != x.shape[-2]:
        raise ValueError(
            f"freqs must be 1-D with one value per bin ({x.shape[-2]}), got shape {f.shape}"
        )
    if np.any(np.diff(f) <= 0):
        raise ValueError("freqs must be strictly increasing")
    h = np.atleast_1d(np.asarray(harmonics, dtype=np.float64))
    lo, w, v = _interp_plan_on(tuple(f.tolist()), tuple(h.tolist()), str(x.device))
    shape = (*x.shape[:-2], *w.shape[:2], x.shape[-1])
    # gather along the bins axis for every harmonic at once
    xl = x.index_select(-2, lo).reshape(shape)
    xh = x.index_select(-2, lo + 1).reshape(shape)
    out = (xl * (1.0 - w) + xh * w).masked_fill(~v, fill_value)
    # the harmonics axis to the front (librosa's layout)
    return out.movedim(-3, 0)


def salience(
    S: ArrayLike,
    freqs: ArrayLike,
    harmonics: ArrayLike = (1, 2, 3, 4),
    weights: ArrayLike | None = None,
    filter_peaks: bool = True,
    fill_value: float = np.nan,
) -> torch.Tensor:
    """Harmonic pitch-salience map, shaped like ``S`` (librosa `salience`):
    the weighted mean of ``S`` resampled at each candidate frequency's
    harmonics. ``filter_peaks`` keeps the map only at the frequency axis's
    local maxima of ``S`` (``fill_value`` elsewhere)."""
    S = dispatch.to_tensor(S, REAL_DTYPE)
    h = np.atleast_1d(np.asarray(harmonics, dtype=np.float64))
    if weights is None:
        wts = np.ones(len(h), dtype=np.float32)
    else:
        wts = np.asarray(weights, dtype=np.float32)
        if wts.shape != (len(h),):
            raise ValueError(
                f"weights must have one value per harmonic ({len(h)}), got shape {wts.shape}"
            )
    layers = interp_harmonics(S, freqs, harmonics=h, fill_value=0.0)
    wsum = float(np.abs(wts).sum()) or 1.0
    wn = torch.from_numpy(wts / wsum).to(S.device)
    sal = torch.tensordot(wn, layers, dims=1)
    if filter_peaks:
        Sp = torch.cat([S[..., :1, :], S, S[..., -1:, :]], dim=-2)  # edge pad
        is_peak = (S > Sp[..., :-2, :]) & (S >= Sp[..., 2:, :])
        sal = sal.masked_fill(~is_peak, fill_value)
    return sal
