"""Mel and MFCC inversion: ``mel_to_stft``, ``mel_to_audio``, ``mfcc_to_mel``
and ``mfcc_to_audio``.

Counterpart of `mlx_audio_primitives_tpu/ops/inverse.py`, with the same
signatures and numerics (librosa's ``feature.inverse``). Every op runs on
the device of its input tensor; a non-tensor input goes to the default
device (`utils/dispatch.py::to_tensor`).

The non-negative least squares behind ``mel_to_stft`` solves all frames at
once by FISTA (projected gradient with Nesterov momentum): each iteration
is two FP32 products, ``A @ X`` and ``A^T @ R``, over the whole batch, with
the step ``1/L`` fixed by the filterbank's largest singular value (float64
on the host, cached per table). The products are plain ``torch.matmul``,
as they are XLA contractions in the JAX package. ``mel_to_audio`` then runs
:func:`griffinlim` (K2 and K3 on a CUDA tensor).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..utils import dispatch
from ..utils.validation import validate_positive
from .convert import db_to_power
from .griffinlim import griffinlim
from .mel import _mel_filterbank_table, mel_filterbank
from .mfcc import _dct_basis_t, lifter_coeffs

ArrayLike = Any

__all__ = ["mel_to_stft", "mel_to_audio", "mfcc_to_mel", "mfcc_to_audio", "nnls"]


@lru_cache(maxsize=64)
def _lipschitz(
    sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float, htk: bool, norm: str | None,
) -> float:
    """``sigma_max(A)^2`` of the mel filterbank, the gradient's Lipschitz
    constant of ``0.5 ||A x - m||^2``, in float64 on the host."""
    A = _mel_filterbank_table.host(sr, n_fft, n_mels, fmin, fmax, htk, norm)
    return float(np.linalg.norm(A, 2) ** 2)


def _nnls_fista(A: torch.Tensor, M: torch.Tensor, L: float, n_iter: int) -> torch.Tensor:
    """FISTA for ``min_{X>=0} 0.5 ||A X - M||_F^2`` over every column of
    ``M`` ``(B, m, F)`` at once; ``A`` is ``(m, n)``."""
    # the step and momentum scalars in float32, as the JAX package carries them
    f32 = np.float32
    inv_L = float(f32(1.0) / f32(L))
    At = A.t()
    # warm start: one projected gradient step from zero
    x = torch.clamp(torch.matmul(At, M) * inv_L, min=0.0)
    yk, t = x, f32(1.0)
    for _ in range(n_iter):
        x_prev = x
        g = torch.matmul(At, torch.matmul(A, yk) - M)
        x = torch.clamp(yk - g * inv_L, min=0.0)
        t_next = f32(0.5) * (f32(1.0) + np.sqrt(f32(1.0) + f32(4.0) * t * t))
        yk = x + float((t - f32(1.0)) / t_next) * (x - x_prev)
        t = t_next
    return x


def nnls(A: ArrayLike, B: ArrayLike, n_iter: int = 300) -> torch.Tensor:
    """Solve ``min_{X>=0} ||A @ X - B||_F`` by FISTA on ``B``'s device.
    ``A`` is ``(m, n)``; ``B`` is ``(m, F)`` or ``(batch, m, F)``."""
    validate_positive(n_iter, "n_iter")
    B = dispatch.to_tensor(B, REAL_DTYPE)
    A = torch.as_tensor(A, dtype=REAL_DTYPE, device=B.device)
    if A.dim() != 2:
        raise ValueError(f"A must be 2-D, got shape {tuple(A.shape)}")
    batched = B.dim() == 3
    if not batched:
        B = B[None]
    if B.shape[1] != A.shape[0]:
        raise ValueError(
            f"A rows ({A.shape[0]}) must match B's contraction dim ({B.shape[1]})"
        )
    L = float(np.linalg.norm(A.detach().cpu().double().numpy(), 2) ** 2)
    X = _nnls_fista(A, B, L, n_iter)
    return X if batched else X[0]


def mel_to_stft(
    M: ArrayLike,
    sr: int = 22050,
    n_fft: int = 2048,
    power: float = 2.0,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    nnls_iter: int = 300,
) -> torch.Tensor:
    """The magnitude spectrogram behind a mel spectrogram: NNLS
    ``mel_basis @ S^power ~ M``, then ``S``. ``M`` is ``(n_mels, F)`` or
    ``(batch, n_mels, F)``; the result has ``n_fft // 2 + 1`` rows."""
    validate_positive(power, "power")
    M = dispatch.to_tensor(M, REAL_DTYPE)
    if M.dim() not in (2, 3):
        raise ValueError(f"M must be 2-D or 3-D, got shape {tuple(M.shape)}")
    batched = M.dim() == 3
    n_mels = M.shape[-2]
    if fmax is None:
        fmax = sr / 2.0
    A = mel_filterbank(sr, n_fft, n_mels=n_mels, fmin=fmin, fmax=fmax, htk=htk, norm=norm,
                       device=M.device)
    L = _lipschitz(sr, n_fft, n_mels, float(fmin), float(fmax), htk, norm)
    X = _nnls_fista(A, M if batched else M[None], L, nnls_iter)
    S = torch.pow(X, 1.0 / power)
    return S if batched else S[0]


def mel_to_audio(
    M: ArrayLike,
    sr: int = 22050,
    n_fft: int = 2048,
    hop_length: int | None = None,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    power: float = 2.0,
    n_iter: int = 32,
    length: int | None = None,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    nnls_iter: int = 300,
    random_state: int | None = None,
) -> torch.Tensor:
    """A mel spectrogram back to audio: :func:`mel_to_stft`, then
    :func:`griffinlim` (librosa's ``feature.inverse.mel_to_audio``)."""
    S = mel_to_stft(M, sr=sr, n_fft=n_fft, power=power, fmin=fmin, fmax=fmax, htk=htk,
                    norm=norm, nnls_iter=nnls_iter)
    return griffinlim(S, n_iter=n_iter, hop_length=hop_length, win_length=win_length,
                      n_fft=n_fft, window=window, center=center, length=length,
                      pad_mode=pad_mode, random_state=random_state)


def mfcc_to_mel(
    M: ArrayLike,
    n_mels: int = 128,
    dct_type: int = 2,
    norm: str | None = "ortho",
    ref: float = 1.0,
    lifter: int = 0,
) -> torch.Tensor:
    """The mel power spectrogram behind an MFCC matrix (librosa
    ``mfcc_to_mel``): undo the lifter, inverse DCT with the missing
    coefficients as zeros, dB to power. For ``norm='ortho'`` the inverse is
    the DCT-II basis's transpose; for ``norm=None`` the unnormalized
    DCT-III, the same table with its DC column halved."""
    validate_positive(n_mels, "n_mels")
    if dct_type != 2:
        raise ValueError(
            f"Unsupported dct_type: {dct_type}. Only type 2 (librosa's "
            "default) is invertible here"
        )
    M = dispatch.to_tensor(M, REAL_DTYPE)
    if M.dim() not in (2, 3):
        raise ValueError(f"M must be 2-D or 3-D, got shape {tuple(M.shape)}")
    n_mfcc = M.shape[-2]
    if n_mfcc > n_mels:
        raise ValueError(f"n_mfcc ({n_mfcc}) cannot exceed n_mels ({n_mels})")
    if lifter > 0:
        M = M / lifter_coeffs(n_mfcc, lifter, device=M.device)[:, None]
    elif lifter != 0:
        raise ValueError(f"lifter must be non-negative, got {lifter}")

    A = _dct_basis_t.host(n_mfcc, n_mels, "ortho" if norm == "ortho" else None)  # (n_mels, n_mfcc)
    if norm is None:
        A = A.copy()
        A[:, 0] *= 0.5
    elif norm != "ortho":
        raise ValueError(f"Unknown norm: '{norm}'. Supported: 'ortho', None")
    A = torch.as_tensor(A, dtype=REAL_DTYPE, device=M.device)
    return db_to_power(torch.matmul(A, M), ref=ref)


def mfcc_to_audio(
    M: ArrayLike,
    n_mels: int = 128,
    dct_type: int = 2,
    norm: str | None = "ortho",
    ref: float = 1.0,
    lifter: int = 0,
    sr: int = 22050,
    n_fft: int = 2048,
    hop_length: int | None = None,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    power: float = 2.0,
    n_iter: int = 32,
    length: int | None = None,
    **mel_kwargs,
) -> torch.Tensor:
    """MFCC to audio: :func:`mfcc_to_mel`, then :func:`mel_to_audio`
    (librosa's ``feature.inverse.mfcc_to_audio``)."""
    mel = mfcc_to_mel(M, n_mels=n_mels, dct_type=dct_type, norm=norm, ref=ref, lifter=lifter)
    return mel_to_audio(mel, sr=sr, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                        window=window, center=center, pad_mode=pad_mode, power=power,
                        n_iter=n_iter, length=length, **mel_kwargs)
