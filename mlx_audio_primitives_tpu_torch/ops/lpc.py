"""Linear prediction coefficients (Burg's method).

Counterpart of `mlx_audio_primitives_tpu/ops/lpc.py`, with the same
signature and results (librosa `lpc`: the same Burg recursion, the
``[1, a_1, ..., a_order]`` output). The recursion keeps the JAX package's
fixed-shape form: the forward and backward prediction errors keep their
full ``N - 1`` length under a shrinking validity mask, librosa's ``fwd =
fwd_new[1:]`` is a left roll, and the coefficient update reads the
previous coefficients reversed through a roll of the flipped vector. It
runs ``order`` steps, each over every signal of the batch at once.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..utils import dispatch
from ..utils.validation import validate_positive

ArrayLike = Any

__all__ = ["lpc"]

_TINY32 = float(np.finfo(np.float32).tiny)


def _lpc_burg(y: torch.Tensor, order: int) -> torch.Tensor:
    B, N = y.shape
    M = N - 1  # the prediction-error arrays' length
    fwd = y[:, 1:]
    bwd = y[:, :-1]
    den = (fwd * fwd + bwd * bwd).sum(-1)
    ar = torch.zeros((B, order + 1), dtype=REAL_DTYPE, device=y.device)
    ar[:, 0] = 1.0
    t = torch.arange(M, device=y.device)
    j = torch.arange(order + 1, device=y.device)
    for i in range(order):
        n_valid = M - i
        mask = (t < n_valid).to(REAL_DTYPE)
        num = (mask * bwd * fwd).sum(-1)
        small = den.abs() < _TINY32
        reflect = -2.0 * num / torch.where(small, _TINY32, den)
        reflect = torch.where(small, 0.0, reflect)[:, None]
        # a[j] = a_prev[j] + r * a_prev[i+1-j] for j = 1..i+1, the reversed
        # read a_prev[i+1-j] = flip(a_prev)[j + order-i-1]
        rev = torch.roll(torch.flip(ar, dims=[-1]), -(order - 1 - i), dims=-1)
        upd = (j >= 1) & (j <= i + 1)
        ar = torch.where(upd[None, :], ar + reflect * rev, ar)
        fwd_new = fwd + reflect * bwd
        bwd = bwd + reflect * fwd
        # den' = (1 - r^2) den - fwd_new[first]^2 - bwd_new[last valid]^2
        last = bwd[:, n_valid - 1]
        den = (1.0 - reflect[:, 0] ** 2) * den - fwd_new[:, 0] ** 2 - last**2
        fwd = torch.roll(fwd_new, -1, dims=-1)
    return ar


def lpc(y: ArrayLike, order: int, axis: int = -1) -> torch.Tensor:
    """LPC coefficients ``[1, a_1, ..., a_order]`` by Burg's method
    (librosa `lpc`): the denominator of the all-pole model ``1 / A(z)``
    (scipy.signal.lfilter's convention). The output has the input's shape
    with ``axis`` replaced by ``order + 1``."""
    validate_positive(order, "order")
    y = dispatch.to_tensor(y, REAL_DTYPE)
    if y.dim() == 0:
        raise ValueError("lpc expects at least a 1-D signal")
    y = y.movedim(axis, -1)
    if y.shape[-1] <= order:
        raise ValueError(
            f"signal length along axis ({y.shape[-1]}) must exceed order ({order})"
        )
    lead = y.shape[:-1]
    ar = _lpc_burg(y.reshape(-1, y.shape[-1]), int(order))
    return ar.reshape(*lead, order + 1).movedim(-1, axis)
