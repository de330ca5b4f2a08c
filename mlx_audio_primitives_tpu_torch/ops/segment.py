"""Self- and cross-similarity matrices and nearest-neighbour filtering.

Counterpart of `mlx_audio_primitives_tpu/ops/segment.py`, with the same
signatures and results (librosa `segment.recurrence_matrix` /
`cross_similarity` / `decompose.nn_filter` roles): the pairwise distance
matrix is one FP32 product (``|x|^2 + |y|^2 - 2 x.y`` for euclidean, a
normalized dot for cosine), the diagonal band a mask, and each row's
threshold its k-th smallest distance, a value, so ties do not move it.

Medians: ``jnp.nanmedian`` averages the two middle values of an even
count, ``torch.nanmedian`` returns the lower one, so the affinity
bandwidth and ``nn_filter``'s median average the two middle values of a
sort with the excluded cells pushed past the end. ``nn_filter``'s median
sorts ``(d, t, t)`` values; it runs in chunks of feature rows, each near
``_NN_CHUNK_ELEMS`` values.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..utils import dispatch
from ..utils.validation import validate_positive

ArrayLike = Any

__all__ = ["recurrence_matrix", "cross_similarity", "nn_filter"]

_TINY32 = float(np.finfo(np.float32).tiny)
_MODES = ("connectivity", "distance", "affinity")

#: values one chunk of ``nn_filter``'s median sorts (64 MB of float32)
_NN_CHUNK_ELEMS = 1 << 24


def _features(data: ArrayLike) -> torch.Tensor:
    X = dispatch.to_tensor(data, REAL_DTYPE)
    return X[None] if X.dim() == 1 else X


def _pairwise_distance(X: torch.Tensor, Y: torch.Tensor, metric: str) -> torch.Tensor:
    """(t_x, d) x (t_y, d) -> (t_x, t_y) distances through one product."""
    if metric == "euclidean":
        sq = (X * X).sum(-1)[:, None] + (Y * Y).sum(-1)[None, :] - 2.0 * (X @ Y.t())
        return torch.sqrt(torch.clamp(sq, min=0.0))
    if metric == "cosine":
        nx = torch.clamp(torch.linalg.vector_norm(X, dim=-1), min=_TINY32)
        ny = torch.clamp(torch.linalg.vector_norm(Y, dim=-1), min=_TINY32)
        cos = (X @ Y.t()) / (nx[:, None] * ny[None, :])
        return 1.0 - torch.clamp(cos, -1.0, 1.0)
    raise ValueError(f"Unknown metric: '{metric}'. Supported: 'euclidean', 'cosine'")


def _masked_median(vals: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """NumPy's median of ``vals[keep]`` over the last axis (the mean of the
    two middle values for an even count; NaN where nothing is kept), with
    no host synchronisation: the excluded values sort past the end."""
    s = torch.sort(torch.where(keep, vals, float("inf")), dim=-1).values
    n = keep.sum(-1, keepdim=True)
    lo = s.gather(-1, torch.clamp((n - 1) // 2, min=0))
    hi = s.gather(-1, torch.clamp(n // 2, max=s.shape[-1] - 1))
    return torch.where(n > 0, 0.5 * (lo + hi), float("nan"))[..., 0]


def _from_keep(keep: torch.Tensor, D: torch.Tensor, mode: str) -> torch.Tensor:
    """The matrix of ``mode`` from the kept neighbour pairs."""
    if mode == "connectivity":
        return keep.to(REAL_DTYPE)
    if mode == "distance":
        return torch.where(keep, D, 0.0)
    # affinity: exp(-D / bandwidth), the bandwidth the median kept distance
    bw = _masked_median(D.reshape(-1), keep.reshape(-1))
    bw = torch.where(torch.isfinite(bw) & (bw > 0), bw, 1.0)
    return torch.where(keep, torch.exp(-D / bw), 0.0)


def recurrence_matrix(
    data: ArrayLike,
    k: int | None = None,
    width: int = 1,
    metric: str = "euclidean",
    sym: bool = False,
    mode: str = "connectivity",
    self_: bool = False,
) -> torch.Tensor:
    """k-NN self-similarity matrix over frames, ``(t, t)``. ``data`` is
    ``(d, t)`` (or ``(t,)``). ``R[i, j]`` nonzero: frame ``j`` is among
    frame ``i``'s ``k`` nearest neighbours at least ``width`` frames from
    the diagonal. ``mode``: 'connectivity' (0/1), 'distance' or 'affinity'
    (``exp(-D/bandwidth)``); ``sym`` keeps mutual pairs only; ``self_``
    admits the zero-distance self-match."""
    validate_positive(width, "width")
    X = _features(data)
    if X.dim() != 2:
        raise ValueError(f"recurrence_matrix expects (d, t) features, got {X.dim()}-D")
    t = X.shape[1]
    if t - 2 * width + 1 < 1:
        raise ValueError(f"width ({width}) leaves no admissible neighbors for {t} frames")
    if mode not in _MODES:
        raise ValueError(
            f"Unknown mode: '{mode}'. Supported: 'connectivity', 'distance', 'affinity'"
        )
    if k is None:
        k = int(2 * np.ceil(np.sqrt(t - 2 * width + 1)))
    k = int(min(max(k, 1), t - 1))
    D = _pairwise_distance(X.t(), X.t(), metric)
    idx = torch.arange(t, device=X.device)
    band = (idx[:, None] - idx[None, :]).abs() < width
    if self_:
        band = band & (idx[:, None] != idx[None, :])
    Dm = torch.where(band, float("inf"), D)
    # k nearest per row: the k-th smallest distance is the row's threshold
    kth = torch.topk(Dm, k, dim=-1, largest=False).values[:, -1]
    keep = (Dm <= kth[:, None]) & torch.isfinite(Dm)
    if sym:
        keep = keep & keep.t()
    return _from_keep(keep, D, mode)


def cross_similarity(
    data: ArrayLike,
    data_ref: ArrayLike,
    k: int | None = None,
    metric: str = "euclidean",
    mode: str = "connectivity",
) -> torch.Tensor:
    """k-NN cross-similarity ``(t, t_ref)`` between two feature sequences:
    row ``i`` marks the ``k`` reference frames nearest to query frame
    ``i``."""
    X, Y = _features(data), _features(data_ref)
    if X.dim() != 2 or Y.dim() != 2:
        raise ValueError("cross_similarity expects (d, t) feature matrices")
    if X.shape[0] != Y.shape[0]:
        raise ValueError(f"feature dimensions disagree: {X.shape[0]} vs {Y.shape[0]}")
    if mode not in _MODES:
        raise ValueError(
            f"Unknown mode: '{mode}'. Supported: 'connectivity', 'distance', 'affinity'"
        )
    t_ref = Y.shape[1]
    if k is None:
        k = int(2 * np.ceil(np.sqrt(t_ref)))
    k = int(min(max(k, 1), t_ref))
    D = _pairwise_distance(X.t(), Y.t(), metric)
    kth = torch.topk(D, k, dim=-1, largest=False).values[:, -1]
    return _from_keep(D <= kth[:, None], D, mode)


def nn_filter(
    data: ArrayLike,
    rec: ArrayLike | None = None,
    aggregate: str = "mean",
    **recurrence_kwargs,
) -> torch.Tensor:
    """Nearest-neighbour smoothing of a feature sequence: each frame is
    replaced by the aggregate of its recurrence neighbours (REPET-SIM on a
    spectrogram). ``rec`` is a precomputed ``(t, t)`` recurrence or
    affinity matrix, else :func:`recurrence_matrix` runs with
    ``**recurrence_kwargs`` (affinity mode by default). ``aggregate``:
    'mean' (affinity-weighted, one product) or 'median' (over the
    neighbours and the frame itself)."""
    X = _features(data)
    if X.dim() != 2:
        raise ValueError("nn_filter expects (d, t) features")
    t = X.shape[1]
    if rec is None:
        recurrence_kwargs.setdefault("mode", "affinity")
        R = recurrence_matrix(X, **recurrence_kwargs)
    else:
        R = torch.as_tensor(rec, dtype=REAL_DTYPE, device=X.device)
        if tuple(R.shape) != (t, t):
            raise ValueError(f"rec must be ({t}, {t}), got {tuple(R.shape)}")
    eye = torch.eye(t, dtype=REAL_DTYPE, device=X.device)
    if aggregate == "mean":
        # each frame counts itself with unit weight, so a frame without
        # neighbours passes through unchanged
        Rw = R + eye
        return X @ Rw.t() / Rw.sum(1)[None, :]
    if aggregate == "median":
        keep = (R + eye) > 0  # (t, t): frame i's neighbours j
        out = torch.empty_like(X)
        step = max(1, _NN_CHUNK_ELEMS // (t * t))
        for r0 in range(0, X.shape[0], step):
            vals = X[r0 : r0 + step, None, :].expand(-1, t, t)
            out[r0 : r0 + step] = _masked_median(vals, keep.expand_as(vals))
        return out
    raise ValueError(f"Unknown aggregate: '{aggregate}'. Supported: 'mean', 'median'")
