"""Decibel conversions (librosa-compatible).

Counterpart of `mlx_audio_primitives_tpu/ops/convert.py`: callable-or-scalar
``ref``, ``amin`` clamping of both S and ref, and a ``top_db`` clip against
the global max. The JAX package computes ``log10``/``10**x`` with its own
polynomials (`kernels/precise_math.py`) because XLA's fast log misses the
~2e-6 dB contract; the port uses ``torch.log10`` and ``torch.pow``, whose
CPU and CUDA float32 versions are accurate to a few ulp.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE

ArrayLike = Any


def _to_db(
    S: ArrayLike,
    ref: float | Callable,
    coefficient: float,
    amin: float,
    top_db: float | None,
) -> torch.Tensor:
    if amin <= 0:
        raise ValueError(f"amin must be positive, got {amin}")
    S = torch.as_tensor(S, dtype=REAL_DTYPE)
    if callable(ref):
        ref_value = torch.as_tensor(ref(S), dtype=S.dtype, device=S.device)
        ref_clamped = torch.clamp(ref_value, min=amin)
    else:
        # a scalar ref stays on the host: a device tensor made from it costs a
        # blocking host-to-device copy, which stalls the host until the kernel
        # that produced S has finished
        ref_clamped = float(max(np.float32(ref), np.float32(amin)))
    S_db = coefficient * torch.log10(torch.clamp(S, min=amin) / ref_clamped)
    if top_db is not None:
        if top_db <= 0:
            raise ValueError(f"top_db must be positive, got {top_db}")
        S_db = torch.maximum(S_db, S_db.max() - top_db)
    return S_db


def power_to_db(
    S: ArrayLike,
    ref: float | Callable = 1.0,
    amin: float = 1e-10,
    top_db: float | None = 80.0,
) -> torch.Tensor:
    """Convert a power spectrogram to dB: ``10 * log10(S / ref)``."""
    return _to_db(S, ref, coefficient=10.0, amin=amin, top_db=top_db)


def db_to_power(S_db: ArrayLike, ref: float = 1.0) -> torch.Tensor:
    """Invert :func:`power_to_db`: ``ref * 10**(S_db / 10)``."""
    S_db = torch.as_tensor(S_db, dtype=REAL_DTYPE)
    return ref * torch.pow(10.0, S_db / 10.0)


def amplitude_to_db(
    S: ArrayLike,
    ref: float | Callable = 1.0,
    amin: float = 1e-5,
    top_db: float | None = 80.0,
) -> torch.Tensor:
    """Convert an amplitude spectrogram to dB: ``20 * log10(S / ref)``."""
    return _to_db(S, ref, coefficient=20.0, amin=amin, top_db=top_db)


def db_to_amplitude(S_db: ArrayLike, ref: float = 1.0) -> torch.Tensor:
    """Invert :func:`amplitude_to_db`: ``ref * 10**(S_db / 20)``."""
    S_db = torch.as_tensor(S_db, dtype=REAL_DTYPE)
    return ref * torch.pow(10.0, S_db / 20.0)
