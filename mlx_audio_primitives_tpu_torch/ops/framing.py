"""Time-domain primitives: frame, rms, preemphasis, deemphasis.

Counterpart of `mlx_audio_primitives_tpu/ops/framing.py`, with the same
signatures and scipy ``lfilter`` state semantics. Every op runs on the
device of its input tensor; a non-tensor input goes to the default device
(`utils/dispatch.py::to_tensor`). ``rms`` of a non-empty signal on the
card runs the frame statistics kernel (K7, `kernels/frame_stats.py`), as
``zero_crossing_rate`` does (:func:`frame_stat`); elsewhere, and for a frame
longer than K7 takes, its plain twin.

``deemphasis`` is the first-order IIR ``out[n] = y[n] + coef*out[n-1]``.
It keeps the JAX formulation and its numerics: blocks of 256 samples, each
a lower-triangular matmul with ``L[i, j] = coef**(i-j)`` (a plain FP32
product), and a recurrence over the block boundaries. The JAX package runs
the boundary recurrence as a ``lax.scan``; here it is the same blocked
recurrence applied again to the boundary values (coefficient
``coef**256``), so its depth is logarithmic in the length and no Python
loop runs per block.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..kernels.frame_stats import frame_stats_fused, frame_stats_ok, frame_stats_plain
from ..utils import dispatch
from ..utils.profiler import traced
from ..utils.validation import validate_positive
from ._frames import frame_signal_batched

ArrayLike = Any

_IIR_BLOCK = 256


def _as_2d(y: ArrayLike) -> tuple[torch.Tensor, bool]:
    y = dispatch.to_tensor(y, REAL_DTYPE)
    input_is_1d = y.dim() == 1
    return (y[None] if input_is_1d else y), input_is_1d


@traced("ops.frame")
def frame(y: ArrayLike, frame_length: int, hop_length: int, axis: int = -1) -> torch.Tensor:
    """Frame a signal into overlapping windows, ``(..., F, frame_length)``
    (a strided view of the input)."""
    validate_positive(frame_length, "frame_length")
    validate_positive(hop_length, "hop_length")
    if axis != -1:
        raise ValueError(f"axis must be -1, got {axis}")
    y, input_is_1d = _as_2d(y)
    frames = frame_signal_batched(y, frame_length, hop_length)
    return frames[0] if input_is_1d else frames


def frame_stat(
    op: str, y: ArrayLike, frame_length: int, hop_length: int, center: bool, pad_mode: str,
) -> torch.Tensor:
    """The body of ``op``, ``rms`` or ``zero_crossing_rate``: the argument
    checks, then the per-frame statistic ``(..., 1, F)`` from the frame
    statistics kernel (K7, ``frame_stats_fused``) for a non-empty ``(B, L)``
    or ``(L,)`` signal on the card, from its plain twin otherwise."""
    validate_positive(frame_length, "frame_length")
    validate_positive(hop_length, "hop_length")
    y, input_is_1d = _as_2d(y)
    if center and pad_mode not in ("constant", "edge"):
        raise ValueError(
            f"Unknown pad_mode: '{pad_mode}'. Supported: 'constant', 'edge'"
        )
    kw = dict(stat=op, frame_length=frame_length, hop_length=hop_length, center=center,
              pad_mode=pad_mode)
    if dispatch.route(op, None, y.device, gate=frame_stats_ok(y, frame_length),
                      nonempty=y.numel() > 0):
        out = frame_stats_fused(y, **kw)
    else:
        out = frame_stats_plain(y, **kw)
    return out[0] if input_is_1d else out


@traced("ops.rms")
def rms(
    y: ArrayLike,
    frame_length: int = 2048,
    hop_length: int = 512,
    center: bool = True,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """Root-mean-square energy per frame, ``(..., 1, F)``."""
    return frame_stat("rms", y, frame_length, hop_length, center, pad_mode)


def _normalize_zi(zi, batch_size: int, device: torch.device) -> torch.Tensor:
    zi = torch.as_tensor(zi, dtype=REAL_DTYPE, device=device)
    if zi.dim() == 0:
        zi = zi.reshape(1, 1).expand(batch_size, 1)
    elif zi.dim() == 1:
        zi = zi[:, None] if zi.shape[0] == batch_size else zi[None, :].expand(batch_size, 1)
    return zi


@traced("ops.preemphasis")
def preemphasis(
    y: ArrayLike,
    coef: float = 0.97,
    zi: ArrayLike | None = None,
    return_zf: bool = False,
    use_mlx: bool = True,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Pre-emphasis FIR ``out[n] = y[n] - coef*y[n-1]`` with scipy-lfilter
    state: ``out[0] = y[0] + zi``, default zi librosa's linear extrapolation
    ``2*y[0] - y[1]``; the final state is ``-coef*y[-1]``."""
    del use_mlx
    if not 0.0 <= coef <= 1.0:
        raise ValueError(f"coef must be in [0, 1], got {coef}")
    y, input_is_1d = _as_2d(y)
    if zi is None:
        zi_arr = 2 * y[:, 0:1] - y[:, 1:2]
    else:
        zi_arr = _normalize_zi(zi, y.shape[0], y.device)
    out = torch.cat([y[:, :1] + zi_arr, y[:, 1:] - coef * y[:, :-1]], dim=-1)
    zf = -coef * y[:, -1:]
    if input_is_1d:
        out, zf = out[0], zf[0]
    return (out, zf) if return_zf else out


def _host_powers(coef: float, n: int, start: int = 0) -> np.ndarray:
    with np.errstate(over="ignore", divide="ignore"):
        return float(coef) ** np.arange(start, start + n, dtype=np.float64)


def _recurrence(x: torch.Tensor, coef: float) -> torch.Tensor:
    """``out[..., n] = x[..., n] + coef*out[..., n-1]`` with zero initial
    state, over the last axis of ``(B, n)``, in blocks of 256."""
    B, n = x.shape
    nb = -(-n // _IIR_BLOCK)
    blocks = torch.nn.functional.pad(x, (0, nb * _IIR_BLOCK - n)).reshape(B, nb, _IIR_BLOCK)
    # intra-block scan: s[i] = sum_{j<=i} coef^(i-j) x[j], one product
    ij = np.arange(_IIR_BLOCK)
    expo = ij[:, None] - ij[None, :]
    with np.errstate(over="ignore"):
        L = np.where(expo >= 0, float(coef) ** np.maximum(expo, 0), 0.0)
    Lt = torch.as_tensor(L.T.astype(np.float32), device=x.device)
    intra = torch.matmul(blocks, Lt)
    if nb > 1:
        # state entering block k: H[k-1], where H[k] = e[k] + coef^256 H[k-1]
        H = _recurrence(intra[:, :, -1], float(coef) ** _IIR_BLOCK)
        h_prev = torch.nn.functional.pad(H[:, :-1], (1, 0))
        cpow = torch.as_tensor(_host_powers(coef, _IIR_BLOCK, 1).astype(np.float32),
                               device=x.device)
        intra = intra + h_prev[:, :, None] * cpow
    return intra.reshape(B, nb * _IIR_BLOCK)[:, :n]


@traced("ops.deemphasis")
def deemphasis(
    y: ArrayLike,
    coef: float = 0.97,
    zi: ArrayLike | None = None,
    return_zf: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """De-emphasis IIR, the inverse of :func:`preemphasis`: scipy ``lfilter``
    of ``[1], [1, -coef]``; with no ``zi``, the closed-form correction for
    librosa's default pre-emphasis state. The final state ``zf`` is taken
    before that correction, so chunked calls continue the stream."""
    if not 0.0 <= coef <= 1.0:
        raise ValueError(f"coef must be in [0, 1], got {coef}")
    y, input_is_1d = _as_2d(y)
    out = _recurrence(y, coef)
    powers = torch.as_tensor(_host_powers(coef, y.shape[1]).astype(np.float32),
                             device=y.device)[None, :]
    if zi is not None:
        out = out + _normalize_zi(zi, y.shape[0], y.device) * powers
        zf = coef * out[:, -1:]
    else:
        zf = coef * out[:, -1:]
        corr = ((2.0 - coef) * y[:, 0:1] - y[:, 1:2]) / (3.0 - coef)
        out = out - corr * powers
    if input_is_1d:
        out, zf = out[0], zf[0]
    return (out, zf) if return_zf else out


__all__ = ["frame", "rms", "preemphasis", "deemphasis"]
