"""Per-channel energy normalization (PCEN).

Counterpart of `mlx_audio_primitives_tpu/ops/pcen.py`, with the same
signatures and results (librosa `pcen`; Wang et al., "Trainable Frontend
For Robust and Far-Field Keyword Spotting", ICASSP 2017): a one-pole
running mean ``M[t] = (1-b) M[t-1] + b S[t]`` normalizes ``S``, then a
root compression, with scipy ``lfilter``'s ``zi``/``zf`` state so that
chunks chained through it equal the whole.

The smoother is a blocked scan (the JAX package runs an associative scan).
Inside blocks of 32 frames it is one product with the lower-triangular
``L[i, j] = (1-b)^(i-j)``; the 32 block-end values form the same
recurrence with coefficient ``(1-b)^32``, which is scanned the same way, so
the depth grows as log32 of the frame count and no Python loop runs per
frame. Every power in it is of a number in [0, 1) and at most 32, so
nothing overflows, and a power that underflows is a weight that is 0 in
float32 anyway: unlike the closed form ``M[t] = (1-b)^t * cumsum(d /
(1-b)^j)``, whose ``(1-b)^t`` reaches ~1e-33 after 1,292 frames at
librosa's defaults and underflows after that. ``b`` may be one value per
channel (``pcen_smoother``); the products then carry one ``L`` a channel.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..utils import dispatch
from ..utils.validation import validate_positive

ArrayLike = Any

_SCAN_BLOCK = 32


def _one_pole(d: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``M[..., t] = c * M[..., t-1] + d[..., t]`` with ``M[..., -1] = 0``
    over the last axis of ``(N, F)``; ``c`` is ``(N,)``, or ``(1,)`` for one
    coefficient shared by the rows (then the products are one GEMM), each
    in [0, 1]."""
    N, F = d.shape
    T = _SCAN_BLOCK
    nb = -(-F // T)
    blocks = torch.nn.functional.pad(d, (0, nb * T - F)).reshape(N, nb, T)
    k = torch.arange(T, device=d.device)
    expo = k[:, None] - k[None, :]  # i - j
    # c^(i-j) on and below the diagonal, 0 above; transposed for x @ L^T
    powers = c[:, None, None] ** expo.clamp(min=0).to(d.dtype)
    Lt = torch.where(expo >= 0, powers, torch.zeros((), dtype=d.dtype, device=d.device))
    Lt = Lt.transpose(1, 2)
    intra = torch.matmul(blocks, Lt[0] if c.numel() == 1 else Lt)
    if nb > 1:
        # state entering block k: H[k-1], where H[k] = e[k] + c^T H[k-1]
        H = _one_pole(intra[:, :, -1], c**T)
        h_prev = torch.nn.functional.pad(H[:, :-1], (1, 0))
        cpow = c[:, None] ** (k + 1).to(d.dtype)  # c^1 .. c^T
        intra = torch.addcmul(intra, h_prev[:, :, None], cpow[:, None, :])
    return intra.reshape(N, nb * T)[:, :F]


def _smooth(ref: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            zi: torch.Tensor | None) -> torch.Tensor:
    """The running mean of ``ref`` ``(..., F)`` with coefficients ``b`` and
    ``c = 1 - b`` (tensors broadcastable to ``ref.shape[:-1]``) and scipy's
    ``zi`` convention: ``M[0] = b*ref[0] + zi``, or ``M[0] = ref[0]``
    (lfilter_zi's steady state) when None."""
    lead, F = ref.shape[:-1], ref.shape[-1]
    b = torch.broadcast_to(b, lead).reshape(-1, 1)
    c = c.reshape(1) if c.numel() == 1 else torch.broadcast_to(c, lead).reshape(-1)
    r = ref.reshape(-1, F)
    d = b * r
    if zi is None:
        d[:, :1] = r[:, :1]
    else:
        d[:, :1] += torch.broadcast_to(zi, lead).reshape(-1, 1)
    return _one_pole(d, c).reshape(ref.shape)


def pcen(
    S: ArrayLike,
    sr: int = 22050,
    hop_length: int = 512,
    gain: float = 0.98,
    bias: float = 2.0,
    power: float = 0.5,
    time_constant: float = 0.4,
    eps: float = 1e-6,
    b: float | None = None,
    max_size: int = 1,
    zi: ArrayLike | None = None,
    return_zf: bool = False,
):
    """PCEN of a (mel) power spectrogram ``(..., n_bands, F)`` (librosa
    `pcen`): the running mean ``M`` (coefficient ``b`` from
    ``time_constant`` seconds unless given) normalizes ``S`` as
    ``(S / (eps + M)^gain + bias)^power - bias^power`` (log1p/expm1
    forms; ``power=0`` is the ``log1p`` limit). ``max_size > 1`` first
    max-filters the smoother's input over frequency (scipy's window,
    ``max_size // 2`` bands before the center).

    Streaming: ``zi`` is the scipy ``lfilter`` state (S without its time
    axis); ``return_zf=True`` also returns the final state, and chunks
    chained through it equal the whole."""
    validate_positive(hop_length, "hop_length")
    validate_positive(sr, "sr")
    if gain < 0:
        raise ValueError(f"gain must be non-negative, got {gain}")
    if bias < 0:
        raise ValueError(f"bias must be non-negative, got {bias}")
    if power < 0:
        raise ValueError(f"power must be non-negative, got {power}")
    if eps <= 0:
        raise ValueError(f"eps must be strictly positive, got {eps}")
    if max_size < 1:
        raise ValueError(f"max_size must be at least 1, got {max_size}")
    if b is None:
        t_frames = time_constant * sr / float(hop_length)
        b = (np.sqrt(1.0 + 4.0 * t_frames**2) - 1.0) / (2.0 * t_frames**2)
    if not 0 < b <= 1:
        raise ValueError(f"b must be in (0, 1], got {b}")

    S = dispatch.to_tensor(S, REAL_DTYPE)
    if S.dim() < 2:
        raise ValueError(
            f"pcen expects at least a 2-D (n_bands, frames) input, got {S.dim()}-D"
        )
    if max_size > S.shape[-2]:
        raise ValueError(
            f"max_size ({max_size}) cannot exceed the frequency axis ({S.shape[-2]})"
        )
    zi_t = None if zi is None else torch.as_tensor(zi, dtype=REAL_DTYPE, device=S.device)
    ref = S
    if max_size > 1:
        lo = max_size // 2
        hi = max_size - 1 - lo
        padded = torch.nn.functional.pad(S.movedim(-2, -1), (lo, hi), value=float("-inf"))
        ref = padded.unfold(-1, max_size, 1).amax(-1).movedim(-1, -2)
    # torch.full fills on the device: no host-to-device copy waits on S
    c_t = torch.full((), 1.0 - float(b), dtype=REAL_DTYPE, device=S.device)
    M = _smooth(ref, torch.full((), float(b), dtype=REAL_DTYPE, device=S.device), c_t, zi_t)

    smooth = (eps + M) ** (-gain)
    if power == 0.0:
        out = torch.log1p(S * smooth)
    elif bias == 0.0:
        out = torch.exp(power * (torch.log(torch.clamp(S, min=0.0)) + torch.log(smooth)))
    else:
        out = (bias**power) * torch.expm1(power * torch.log1p(S * smooth / bias))
    if return_zf:
        return out, c_t * M[..., -1]
    return out


def pcen_smoother(
    ref: torch.Tensor, b: ArrayLike, zi: ArrayLike | None = None
) -> torch.Tensor:
    """The PCEN running mean ``M[t] = (1 - b) M[t-1] + b ref[t]`` along the
    last axis, with scipy's ``zi`` convention (None: ``M[0] = ref[0]``).
    ``b`` is a scalar or one value per channel (any shape broadcastable to
    ``ref`` without its time axis), as a trainable frontend learns it;
    differentiable in ``ref`` and ``b``."""
    ref = dispatch.to_tensor(ref)
    b = torch.as_tensor(b, dtype=ref.dtype, device=ref.device)
    zi_t = None if zi is None else torch.as_tensor(zi, dtype=ref.dtype, device=ref.device)
    return _smooth(ref, b, 1.0 - b, zi_t)


__all__ = ["pcen", "pcen_smoother"]
