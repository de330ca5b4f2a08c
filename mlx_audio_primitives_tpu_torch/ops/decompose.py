"""Harmonic/percussive separation (``hpss``), median filtering and NMF.

Counterpart of `mlx_audio_primitives_tpu/ops/decompose.py`, with the same
signatures and results:

* ``median_filter_1d`` has scipy ``ndimage.median_filter``'s semantics:
  a 'reflect' boundary (NumPy's 'symmetric': the edge sample repeats) and
  rank ``size // 2`` of the sorted window, the upper middle for an even
  ``size`` (``torch.median`` would take the lower one). The padded index is
  built on the host with ``np.pad``; the windows are sorted in chunks of
  rows, so the peak memory stays near ``_MEDIAN_CHUNK_ELEMS`` window
  values (the JAX package materialises every window: 10.5 GB for the
  harmonic filter of 64 x 30 s);
* ``harmonic`` and ``percussive`` run ``stft`` -> ``hpss`` -> ``istft``:
  on a CUDA tensor the STFT kernel (K2) once and the ISTFT kernel (K3)
  once, under the radix gate;
* ``decompose`` is Lee-Seung multiplicative-update NMF in FP32, the
  three-operand products in XLA's order, ``(W^T W) H`` and ``W (H H^T)``,
  with the initial factors drawn from ``np.random.default_rng(seed)`` as
  the JAX package draws them.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..utils import dispatch
from ..utils.validation import validate_positive
from .stft import istft, stft

ArrayLike = Any

__all__ = ["median_filter_1d", "hpss", "harmonic", "percussive", "decompose"]

_TINY32 = float(np.finfo(np.float32).tiny)

#: window values one sort of the median filter holds (256 MB of float32,
#: plus the sort's values and int64 indices): rows are filtered in chunks
#: of this many windows' values
_MEDIAN_CHUNK_ELEMS = 1 << 26


@lru_cache(maxsize=32)
def _symmetric_index(n: int, left: int, right: int) -> np.ndarray:
    """Indices of NumPy's 'symmetric' pad of ``n`` samples (scipy.ndimage's
    'reflect'), for any pad length."""
    return np.pad(np.arange(n), (left, right), mode="symmetric")


def _median_filter_last(x: torch.Tensor, size: int) -> torch.Tensor:
    """scipy-exact 1-D median (rank) filter along the last axis."""
    if size == 1:
        return x
    left = size // 2
    n = x.shape[-1]
    idx = torch.from_numpy(_symmetric_index(n, left, size - 1 - left)).to(x.device)
    rows = x.reshape(-1, n)
    out = torch.empty_like(rows)
    step = max(1, _MEDIAN_CHUNK_ELEMS // (n * size))
    for r0 in range(0, rows.shape[0], step):
        windows = rows[r0 : r0 + step].index_select(-1, idx).unfold(-1, size, 1)
        out[r0 : r0 + step] = torch.sort(windows, dim=-1).values[..., size // 2]
    return out.reshape(x.shape)


def median_filter_1d(x: ArrayLike, size: int, axis: int = -1) -> torch.Tensor:
    """Median-filter ``x`` along one axis (scipy ``median_filter`` semantics:
    'reflect' boundary, rank ``size // 2`` selection), on the input's
    device. The engine behind :func:`hpss`."""
    validate_positive(size, "size")
    x = dispatch.to_tensor(x)
    if not x.is_floating_point():
        x = x.to(REAL_DTYPE)
    axis = axis % x.dim()
    n = x.shape[axis]
    if size > 2 * n + 1:
        raise ValueError(
            f"size ({size}) may not exceed 2 * axis length + 1 ({2 * n + 1})"
        )
    xm = x.movedim(axis, -1)
    return _median_filter_last(xm, int(size)).movedim(-1, axis)


def _softmask(X: torch.Tensor, X_ref: torch.Tensor, power: float,
              split_zeros: bool) -> torch.Tensor:
    """librosa ``util.softmask``: relative power mask, safe where both
    inputs underflow to zero."""
    if np.isinf(power):
        return (X > X_ref).to(REAL_DTYPE)
    Z = torch.maximum(X, X_ref)
    bad = Z < _TINY32
    Zs = torch.where(bad, 1.0, Z)
    m = (X / Zs) ** power
    m_ref = (X_ref / Zs) ** power
    fill = 0.5 if split_zeros else 0.0
    return torch.where(bad, fill, m / (m + m_ref))


def hpss(
    S: ArrayLike,
    kernel_size: int | tuple[int, int] = 31,
    power: float = 2.0,
    mask: bool = False,
    margin: float | tuple[float, float] = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Median-filtering harmonic/percussive separation (Fitzgerald 2010,
    Driedger 2014 margins) on a spectrogram (``librosa.decompose.hpss``):
    the harmonic enhancement median-filters each frequency row across time,
    the percussive one each frame across frequency; soft masks compare the
    two with exponent ``power`` (``inf``: hard masks). ``margin`` > 1
    leaves a residual. ``S`` is ``(n_bins, F)`` or ``(batch, n_bins, F)``,
    magnitude or complex (the phase is kept on both outputs). Returns
    ``(harmonic, percussive)``, or the two masks when ``mask=True``."""
    if isinstance(kernel_size, (tuple, list)):
        win_harm, win_perc = int(kernel_size[0]), int(kernel_size[1])
    else:
        win_harm = win_perc = int(kernel_size)
    validate_positive(win_harm, "kernel_size[harmonic]")
    validate_positive(win_perc, "kernel_size[percussive]")
    validate_positive(power, "power")
    if isinstance(margin, (tuple, list)):
        margin_harm, margin_perc = float(margin[0]), float(margin[1])
    else:
        margin_harm = margin_perc = float(margin)
    if margin_harm < 1 or margin_perc < 1:
        raise ValueError(f"margins must be >= 1.0, got {margin}")

    S = dispatch.to_tensor(S)
    if S.dim() not in (2, 3):
        raise ValueError(f"S must be 2-D or 3-D, got shape {tuple(S.shape)}")
    if S.is_complex():
        mag = S.abs()
        phase = S / torch.clamp(mag, min=_TINY32)
    else:
        mag = S.to(REAL_DTYPE)
        phase = None

    harm = median_filter_1d(mag, win_harm, axis=-1)  # across time
    perc = median_filter_1d(mag, win_perc, axis=-2)  # across frequency

    split_zeros = margin_harm == 1 and margin_perc == 1
    mask_harm = _softmask(harm, perc * margin_harm, power, split_zeros)
    mask_perc = _softmask(perc, harm * margin_perc, power, split_zeros)
    if mask:
        return mask_harm, mask_perc
    H = mag * mask_harm
    P = mag * mask_perc
    if phase is not None:
        return H * phase, P * phase
    return H, P


def _hpss_audio(
    y: ArrayLike, which: int, n_fft: int, hop_length: int | None, win_length: int | None,
    window: str | ArrayLike, center: bool, pad_mode: str, **hpss_kwargs: Any,
) -> torch.Tensor:
    y = dispatch.to_tensor(y, REAL_DTYPE)
    D = stft(y, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
             window=window, center=center, pad_mode=pad_mode)
    D_sep = hpss(D, **hpss_kwargs)[which]
    del D
    return istft(D_sep, hop_length=hop_length, win_length=win_length, n_fft=n_fft,
                 window=window, center=center, length=y.shape[-1])


def harmonic(
    y: ArrayLike,
    n_fft: int = 2048,
    hop_length: int | None = None,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    **hpss_kwargs: Any,
) -> torch.Tensor:
    """The harmonic component of a waveform (``librosa.effects.harmonic``):
    STFT -> :func:`hpss` -> ISTFT at the input length. Extra keyword
    arguments go to :func:`hpss`."""
    return _hpss_audio(y, 0, n_fft, hop_length, win_length, window, center, pad_mode,
                       **hpss_kwargs)


def percussive(
    y: ArrayLike,
    n_fft: int = 2048,
    hop_length: int | None = None,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    **hpss_kwargs: Any,
) -> torch.Tensor:
    """The percussive component of a waveform
    (``librosa.effects.percussive``); see :func:`harmonic`."""
    return _hpss_audio(y, 1, n_fft, hop_length, win_length, window, center, pad_mode,
                       **hpss_kwargs)


def _nmf_mu(S: torch.Tensor, W: torch.Tensor, H: torch.Tensor, n_iter: int):
    """Multiplicative-update NMF (Lee & Seung 2001, Frobenius objective):
    W, H >= 0 minimizing ||S - W H||_F, ``n_iter`` updates of both."""
    for _ in range(n_iter):
        # H <- H * (W^T S) / (W^T W H)
        Wt = W.t()
        H = H * (Wt @ S) / ((Wt @ W) @ H + _TINY32)
        # W <- W * (S H^T) / (W H H^T)
        Ht = H.t()
        W = W * (S @ Ht) / (W @ (H @ Ht) + _TINY32)
    return W, H


def decompose(
    S: ArrayLike,
    n_components: int = 8,
    n_iter: int = 200,
    seed: int = 0,
    W: ArrayLike | None = None,
    fit_W: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nonnegative spectrogram factorization ``S ~ W @ H``.

    librosa's `decompose.decompose` role with Lee-Seung multiplicative
    updates in FP32 on the input's device: deterministic given ``seed``,
    the Frobenius objective nonincreasing. Returns ``(components,
    activations)`` = ``(W (bins, k), H (k, frames))``. ``W`` supplies fixed
    (``fit_W=False``: only the activations are fitted) or warm-start
    templates."""
    validate_positive(n_components, "n_components")
    validate_positive(n_iter, "n_iter")
    S = dispatch.to_tensor(S, REAL_DTYPE)
    if S.dim() != 2:
        raise ValueError(
            f"decompose expects a 2-D (bins, frames) spectrogram, got {S.dim()}-D"
        )
    if bool((S < 0).any()):
        raise ValueError("decompose requires a nonnegative spectrogram")
    nb, nf = S.shape
    rng = np.random.default_rng(seed)
    scale = float(np.sqrt(float(S.mean()) / max(n_components, 1) + 1e-12))
    if W is None:
        W0 = torch.as_tensor(scale * rng.uniform(0.1, 1.0, (nb, n_components)),
                             dtype=REAL_DTYPE, device=S.device)
    else:
        W0 = torch.as_tensor(W, dtype=REAL_DTYPE, device=S.device)
        if tuple(W0.shape) != (nb, n_components):
            raise ValueError(
                f"W must have shape ({nb}, {n_components}), got {tuple(W0.shape)}"
            )
    H0 = torch.as_tensor(scale * rng.uniform(0.1, 1.0, (n_components, nf)),
                         dtype=REAL_DTYPE, device=S.device)
    if W is not None and not fit_W:
        WtW = W0.t() @ W0
        WtS = W0.t() @ S
        H = H0
        for _ in range(n_iter):
            H = H * WtS / (WtW @ H + _TINY32)
        return W0, H
    return _nmf_mu(S, W0, H0, n_iter)
