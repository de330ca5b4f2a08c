"""Array utilities: normalize, local extrema, peak picking, length fixing.

Counterpart of `mlx_audio_primitives_tpu/ops/utilx.py` (the
`librosa.util` workhorses), with the same signatures and results.
``normalize``, ``localmax``, ``localmin``, ``fix_length`` and
``zero_crossings`` are tensor ops on the input's device; ``peak_pick``
returns a host index array, from the mask :func:`~.onset.onset_detect`
uses.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as tnf

from .._config import REAL_DTYPE
from ..utils import dispatch
from ._frames import pad_signal

ArrayLike = Any


def _reduce(fn, x: torch.Tensor, axis: int | None) -> torch.Tensor:
    """``fn`` (amax, amin, sum) over ``axis`` with the reduced axis kept;
    over every axis, kept as ones, when ``axis`` is None."""
    if axis is None:
        return fn(x.reshape(-1), 0).reshape((1,) * x.dim())
    return fn(x, axis, keepdim=True)


def normalize(
    S: ArrayLike,
    norm: float | None = np.inf,
    axis: int | None = 0,
    threshold: float | None = None,
    fill: bool | None = None,
) -> torch.Tensor:
    """Scale an array to unit norm along ``axis`` (librosa
    `util.normalize` semantics).

    ``norm``: inf (max-abs), -inf (min-abs), 0 (L0 / count), any p > 0
    (Lp), or None (no-op). Slices whose norm falls below ``threshold``
    (default: the dtype's tiny) are left as-is (``fill=None``), zeroed
    (``fill=False``), or set to the uniform unit-norm vector
    (``fill=True``; undefined for norm=0).
    """
    x = dispatch.to_tensor(S, REAL_DTYPE)
    if norm is None:
        return x
    mag = x.abs()
    if np.isinf(norm):
        length = _reduce(torch.amax if norm > 0 else torch.amin, mag, axis)
        fill_norm = 1.0
    elif norm == 0:
        if fill is True:
            raise ValueError("Cannot normalize with norm=0 and fill=True")
        length = _reduce(torch.sum, (mag > 0).to(REAL_DTYPE), axis)
        fill_norm = 1.0
    elif norm > 0:
        length = _reduce(torch.sum, mag**norm, axis) ** (1.0 / norm)
        n = x.shape[axis] if axis is not None else x.numel()
        fill_norm = n ** (-1.0 / norm)
    else:
        raise ValueError(f"Unsupported norm: {norm}")
    if threshold is None:
        threshold = float(np.finfo(np.float32).tiny)
    elif threshold <= 0:
        raise ValueError(f"threshold must be positive, got {threshold}")
    small = length < threshold
    out = x / torch.where(small, torch.ones_like(length), length)
    if fill is None:
        return torch.where(small, x, out)
    return torch.where(small, torch.full_like(out, fill_norm if fill else 0.0), out)


def _neighbours(x: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x`` with ``axis`` moved last, and its edge-padded previous and next
    elements."""
    x = x.movedim(axis, -1)
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    nxt = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    return x, prev, nxt


def localmax(x: ArrayLike, axis: int = 0) -> torch.Tensor:
    """Boolean mask of local maxima along ``axis`` (librosa
    `util.localmax`: strictly above the previous element, >= the next,
    edge-padded — so ``x[0]`` is never a max and ``x[-1]`` is one when it
    beats its predecessor)."""
    x, prev, nxt = _neighbours(dispatch.to_tensor(x), axis)
    return ((x > prev) & (x >= nxt)).movedim(-1, axis)


def localmin(x: ArrayLike, axis: int = 0) -> torch.Tensor:
    """Boolean mask of local minima (mirror of :func:`localmax`:
    strictly below the previous element, <= the next)."""
    x, prev, nxt = _neighbours(dispatch.to_tensor(x), axis)
    return ((x < prev) & (x <= nxt)).movedim(-1, axis)


def peak_pick(
    x: ArrayLike,
    pre_max: int,
    post_max: int,
    pre_avg: int,
    post_avg: int,
    delta: float,
    wait: int,
) -> np.ndarray:
    """Indices of picked peaks in a 1-D signal (librosa `util.peak_pick`
    semantics): ``x[n]`` must equal the max over ``[n-pre_max,
    n+post_max)``, exceed the mean over ``[n-pre_avg, n+post_avg)`` by
    ``delta``, and sit more than ``wait`` samples after the previously
    accepted peak. The pools run on the input's device; the ``wait``
    debounce walks the candidates on the host (see
    :func:`~.onset._peak_pick_mask`)."""
    from .onset import _peak_pick_mask

    x = dispatch.to_tensor(x, REAL_DTYPE)
    if x.dim() != 1:
        raise ValueError(f"peak_pick expects a 1-D signal, got {x.dim()}-D")
    for name, v in [("pre_max", pre_max), ("post_max", post_max),
                    ("pre_avg", pre_avg), ("post_avg", post_avg),
                    ("wait", wait)]:
        if v < 0:
            raise ValueError(f"{name} must be non-negative, got {v}")
    if post_max < 1 or post_avg < 1:
        raise ValueError("post_max and post_avg must be at least 1")
    if delta < 0:
        raise ValueError(f"delta must be non-negative, got {delta}")
    mask = _peak_pick_mask(
        x[None],
        pre_max=int(pre_max),
        post_max=int(post_max) - 1,  # librosa slices are post-EXCLUSIVE
        pre_avg=int(pre_avg),
        post_avg=int(post_avg) - 1,
        delta=float(delta),
        wait=int(wait),
    )[0]
    return np.flatnonzero(mask)


_FIX_MODES = ("constant", "edge", "reflect")


def fix_length(
    data: ArrayLike, size: int, axis: int = -1, **pad_kwargs
) -> torch.Tensor:
    """Crop or zero-pad ``data`` to exactly ``size`` along ``axis``
    (librosa `util.fix_length`). ``pad_kwargs`` are NumPy's: ``mode``
    ('constant', 'edge' or 'reflect') and, for 'constant',
    ``constant_values``."""
    if size < 0:
        raise ValueError(f"size must be non-negative, got {size}")
    x = dispatch.to_tensor(data)
    n = x.shape[axis]
    if n > size:
        return x.narrow(axis, 0, size)
    if n < size:
        mode = pad_kwargs.pop("mode", "constant")
        value = pad_kwargs.pop("constant_values", 0)
        if mode not in _FIX_MODES or pad_kwargs or (mode != "constant" and value != 0):
            raise ValueError(
                f"fix_length pads with mode in {_FIX_MODES} (and constant_values for "
                f"'constant'); got mode={mode!r}, {sorted(pad_kwargs)}"
            )
        xm = x.movedim(axis, -1)
        if mode == "constant":
            out = tnf.pad(xm, (0, size - n), value=value)
        else:  # both ends padded NumPy's way, the left one dropped
            out = pad_signal(xm, size - n, mode)[..., size - n :]
        return out.movedim(-1, axis)
    return x


def zero_crossings(
    y: ArrayLike, threshold: float = 1e-10, pad: bool = True
) -> torch.Tensor:
    """Boolean mask marking sign changes (librosa `util.zero_crossings`
    semantics): ``True`` where ``sign(y[i]) != sign(y[i-1])``, with
    sub-``threshold`` samples clipped to zero first; ``pad=True`` marks
    index 0."""
    y = dispatch.to_tensor(y, REAL_DTYPE)
    if threshold and threshold > 0:
        y = torch.where(y.abs() <= threshold, torch.zeros_like(y), y)
    s = torch.signbit(y)
    cross = s[..., 1:] != s[..., :-1]
    first = torch.full(y.shape[:-1] + (1,), bool(pad), device=y.device)
    return torch.cat([first, cross], dim=-1)


__all__ = [
    "normalize", "localmax", "localmin", "peak_pick", "fix_length",
    "zero_crossings",
]
