"""Decibel conversions, perceptual weighting and mu-law companding
(librosa-compatible).

Counterpart of `mlx_audio_primitives_tpu/ops/convert.py`: callable-or-scalar
``ref``, ``amin`` clamping of both S and ref, and a ``top_db`` clip against
the global max; ``perceptual_weighting``, ``mu_compress`` and
``mu_expand`` with the JAX package's semantics. The JAX package computes ``log10``/``10**x`` with its own
polynomials (`kernels/precise_math.py`) because XLA's fast log misses the
~2e-6 dB contract; the port uses ``torch.log10`` and ``torch.pow``, whose
CPU and CUDA float32 versions are accurate to a few ulp. On a CUDA tensor
the dB conversion runs K6 (`kernels/db_fused.py`), one launch with the
plain route's float32 operations in its order.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..kernels.db_fused import to_db_fused, to_db_plain
from ..utils import dispatch
from ..utils.profiler import traced

ArrayLike = Any


def _to_db(
    op: str,
    S: ArrayLike,
    ref: float | Callable,
    coefficient: float,
    amin: float,
    top_db: float | None,
    *,
    per_item: bool = False,
    scale: float = 1.0,
    offset: float = 0.0,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """The dB conversion of ``op`` and its route. ``per_item``, ``scale``
    and ``offset`` (K6's per-item form: a ``top_db`` floor per index of the
    leading dimension, then ``* scale + offset``) serve the port's own front
    ends (`models/pipelines.py::WhisperLogMelFrontend`); the public ops keep
    the whole-input floor."""
    if amin <= 0:
        raise ValueError(f"amin must be positive, got {amin}")
    S = dispatch.to_tensor(S, REAL_DTYPE)
    if top_db is not None and top_db <= 0:
        raise ValueError(f"top_db must be positive, got {top_db}")
    kw = dict(per_item=per_item, scale=scale, offset=offset)
    # K6 takes a scalar ref and a non-empty input of any layout; an empty one
    # keeps the plain route's result (with top_db, its error)
    if dispatch.route(op, use_pallas, S.device, ref=not callable(ref), nonempty=S.numel() > 0):
        return to_db_fused(S, coefficient, ref, amin, top_db, **kw)
    return to_db_plain(S, coefficient, ref, amin, top_db, **kw)


@traced("ops.power_to_db")
def power_to_db(
    S: ArrayLike,
    ref: float | Callable = 1.0,
    amin: float = 1e-10,
    top_db: float | None = 80.0,
) -> torch.Tensor:
    """Convert a power spectrogram to dB: ``10 * log10(S / ref)``."""
    return _to_db("power_to_db", S, ref, coefficient=10.0, amin=amin, top_db=top_db)


@traced("ops.db_to_power")
def db_to_power(S_db: ArrayLike, ref: float = 1.0) -> torch.Tensor:
    """Invert :func:`power_to_db`: ``ref * 10**(S_db / 10)``."""
    S_db = dispatch.to_tensor(S_db, REAL_DTYPE)
    return ref * torch.pow(10.0, S_db / 10.0)


@traced("ops.amplitude_to_db")
def amplitude_to_db(
    S: ArrayLike,
    ref: float | Callable = 1.0,
    amin: float = 1e-5,
    top_db: float | None = 80.0,
) -> torch.Tensor:
    """Convert an amplitude spectrogram to dB: ``20 * log10(S / ref)``."""
    return _to_db("amplitude_to_db", S, ref, coefficient=20.0, amin=amin, top_db=top_db)


@traced("ops.db_to_amplitude")
def db_to_amplitude(S_db: ArrayLike, ref: float = 1.0) -> torch.Tensor:
    """Invert :func:`amplitude_to_db`: ``ref * 10**(S_db / 20)``."""
    S_db = dispatch.to_tensor(S_db, REAL_DTYPE)
    return ref * torch.pow(10.0, S_db / 20.0)


def perceptual_weighting(
    S: ArrayLike,
    frequencies: ArrayLike,
    kind: str = "A",
    **power_to_db_kwargs,
) -> torch.Tensor:
    """Perceptually weighted power spectrogram in dB:
    ``frequency_weighting(f)[:, None] + power_to_db(S)`` (librosa
    `perceptual_weighting` semantics). ``frequencies`` is one center
    frequency per row of ``S``; ``kind`` selects the A/B/C/D/Z curve
    (:func:`~.units.frequency_weighting`, a host float64 table rounded to
    float32) on ``S``'s device."""
    from .units import frequency_weighting

    S = dispatch.to_tensor(S, REAL_DTYPE)
    if isinstance(frequencies, torch.Tensor):
        frequencies = frequencies.detach().cpu().numpy()
    w = np.atleast_1d(
        frequency_weighting(np.asarray(frequencies, dtype=np.float64), kind=kind)
    )
    if w.shape[0] != S.shape[-2]:
        raise ValueError(
            f"frequencies must have one value per spectrogram row "
            f"({S.shape[-2]}), got {w.shape[0]}"
        )
    w_t = torch.as_tensor(w.astype(np.float32), device=S.device)[:, None]
    return w_t + power_to_db(S, **power_to_db_kwargs)


def mu_compress(
    x: ArrayLike, mu: float = 255.0, quantize: bool = True
) -> torch.Tensor:
    """Mu-law companding (librosa `mu_compress` semantics): map [-1, 1]
    through ``sign(x) ln(1 + mu|x|) / ln(1 + mu)``; ``quantize=True``
    bins the companded value with librosa's ``np.digitize`` over
    ``linspace(-1, 1, mu+1)``, giving int32 codes in
    ``[-(mu+1)/2 + 1, (mu+1)/2]`` (e.g. [-127, 128] for mu=255)."""
    if mu <= 0:
        raise ValueError(f"mu must be positive, got {mu}")
    x = torch.clamp(dispatch.to_tensor(x, REAL_DTYPE), -1.0, 1.0)
    mu = float(mu)
    y = torch.sign(x) * torch.log1p(mu * x.abs()) / float(np.float32(np.log1p(mu)))
    if not quantize:
        return y
    # np.digitize(y, linspace(-1, 1, mu+1)) == searchsorted(edges, y,
    # side='right'); for uniform edges that is floor((y+1)*mu/2) + 1.
    idx = torch.floor((y + 1.0) * (mu / 2.0)).to(torch.int32) + 1
    idx = torch.clamp(idx, 1, int(mu) + 1)
    return idx - int((mu + 1) // 2)


def mu_expand(
    x: ArrayLike, mu: float = 255.0, quantize: bool = True
) -> torch.Tensor:
    """Inverse of :func:`mu_compress`: ``quantize=True`` treats ``x`` as
    integer codes and de-quantizes with librosa's ``x * 2/(1+mu)``
    (no offset), else as companded floats in [-1, 1]."""
    if mu <= 0:
        raise ValueError(f"mu must be positive, got {mu}")
    mu = float(mu)
    y = dispatch.to_tensor(x).to(REAL_DTYPE)
    if quantize:
        y = y * 2.0 / (1.0 + mu)
    y = torch.clamp(y, -1.0, 1.0)
    return torch.sign(y) * (torch.pow(1.0 + mu, y.abs()) - 1.0) / mu
