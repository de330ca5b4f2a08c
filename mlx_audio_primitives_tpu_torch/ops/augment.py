"""Training-time augmentations: SpecAugment masking, noise, random gain.

Counterpart of `mlx_audio_primitives_tpu/ops/augment.py`, with the same
signatures and semantics (torchaudio's `TimeMasking` / `FrequencyMasking` /
`AddNoise` analogs). Where the JAX functions take a ``jax.random`` key,
these take a ``torch.Generator`` in the same place (``key``): the draws
come from it, so they cannot match the JAX package's bits. Each function
is a draw (``_draw_*``, on the generator's device) and an apply
(``_mask_apply``, ``_noise_apply``, ``_gain_apply``, on the input's
device), so a caller, or a test, can apply given draws.

Layout as the library's features: ``(..., n_mels, F)``, frequency on
``-2`` and frames on ``-1``.
"""

from __future__ import annotations

from typing import Any

import torch

from .._config import REAL_DTYPE
from ..utils import dispatch
from ..utils.validation import validate_non_negative, validate_positive

ArrayLike = Any

__all__ = ["time_mask", "freq_mask", "spec_augment", "add_noise", "random_gain"]


def _draw_masks(key: torch.Generator, batch_shape: tuple, n_masks: int, mask_param: int,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Widths ``w ~ U{0..mask_param}`` and uniforms ``u ~ U[0, 1)``, each
    ``batch_shape + (n_masks,)``: independent per mask and per leading
    batch element."""
    shape = tuple(batch_shape) + (n_masks,)
    w = torch.randint(0, mask_param + 1, shape, generator=key, device=key.device)
    u = torch.rand(shape, generator=key, device=key.device)
    return w.to(device), u.to(device)


def _mask_apply(feats: torch.Tensor, w: torch.Tensor, u: torch.Tensor, axis: int,
                mask_value: float) -> torch.Tensor:
    """Fill ``[t0, t0 + w)`` along ``axis`` for every mask, with the start
    ``t0 = floor(u * (size - w + 1))`` uniform over the valid range."""
    size = feats.shape[axis]
    batch_shape = feats.shape[: feats.dim() - 2]
    t0 = torch.floor(u * (size - w + 1)).to(torch.int32)
    idx = torch.arange(size, device=feats.device)
    # (..., n_masks, size) -> any over the masks
    hit = ((idx >= t0[..., None]) & (idx < (t0 + w)[..., None])).any(-2)
    shape = [1] * feats.dim()
    shape[: len(batch_shape)] = batch_shape
    shape[axis] = size
    return feats.masked_fill(hit.reshape(shape), mask_value)


def _mask_axis(feats: torch.Tensor, key: torch.Generator, n_masks: int, mask_param: int,
               axis: int, mask_value: float) -> torch.Tensor:
    """Fill ``n_masks`` random index ranges along ``axis`` (torchaudio's
    semantics per mask; ``mask_param`` is clipped to the axis size)."""
    mask_param = min(mask_param, feats.shape[axis])
    w, u = _draw_masks(key, feats.shape[: feats.dim() - 2], n_masks, mask_param, feats.device)
    return _mask_apply(feats, w, u, axis, mask_value)


def time_mask(
    feats: ArrayLike,
    key: torch.Generator,
    mask_param: int = 20,
    n_masks: int = 1,
    mask_value: float = 0.0,
) -> torch.Tensor:
    """SpecAugment time masking: fill ``n_masks`` random frame ranges of
    width ``U{0..mask_param}`` per sample. ``feats`` is ``(..., n_mels,
    F)``; every leading batch element draws independent masks from the
    generator ``key``."""
    validate_positive(n_masks, "n_masks")
    validate_non_negative(mask_param, "mask_param")
    feats = dispatch.to_tensor(feats, REAL_DTYPE)
    return _mask_axis(feats, key, n_masks, mask_param, feats.dim() - 1, mask_value)


def freq_mask(
    feats: ArrayLike,
    key: torch.Generator,
    mask_param: int = 10,
    n_masks: int = 1,
    mask_value: float = 0.0,
) -> torch.Tensor:
    """SpecAugment frequency masking: :func:`time_mask` over the mel-band
    axis (``-2``)."""
    validate_positive(n_masks, "n_masks")
    validate_non_negative(mask_param, "mask_param")
    feats = dispatch.to_tensor(feats, REAL_DTYPE)
    return _mask_axis(feats, key, n_masks, mask_param, feats.dim() - 2, mask_value)


def spec_augment(
    feats: ArrayLike,
    key: torch.Generator,
    n_time_masks: int = 2,
    time_mask_param: int = 20,
    n_freq_masks: int = 2,
    freq_mask_param: int = 10,
    mask_value: float = 0.0,
) -> torch.Tensor:
    """The SpecAugment recipe (Park et al. 2019, without time warp):
    ``n_freq_masks`` frequency masks, then ``n_time_masks`` time masks,
    all independent per batch element, drawn from ``key`` in that order."""
    feats = freq_mask(feats, key, mask_param=freq_mask_param, n_masks=n_freq_masks,
                      mask_value=mask_value)
    return time_mask(feats, key, mask_param=time_mask_param, n_masks=n_time_masks,
                     mask_value=mask_value)


def _noise_apply(y: torch.Tensor, noise: torch.Tensor, snr_db) -> torch.Tensor:
    """``y`` plus ``noise`` scaled to each sample's own power at ``snr_db``."""
    p_sig = (y**2).mean(-1, keepdim=True)
    p_noise = (noise**2).mean(-1, keepdim=True)
    snr = torch.as_tensor(snr_db, dtype=y.dtype, device=y.device)
    snr = snr.reshape(snr.shape + (1,) * (y.dim() - snr.dim()))
    scale = torch.sqrt(p_sig / (p_noise * 10.0 ** (snr / 10.0) + 1e-30))
    return y + noise * scale


def add_noise(y: ArrayLike, key: torch.Generator, snr_db: float | ArrayLike = 20.0) -> torch.Tensor:
    """Add white Gaussian noise at a target signal-to-noise ratio.

    ``snr_db`` is a scalar or a per-sample array broadcastable to the
    leading batch shape. The noise power is scaled to each sample's own
    measured power (torchaudio ``AddNoise``), so silence stays silent."""
    y = dispatch.to_tensor(y, REAL_DTYPE)
    noise = torch.randn(y.shape, generator=key, device=key.device, dtype=y.dtype)
    return _noise_apply(y, noise.to(y.device), snr_db)


def _gain_apply(y: torch.Tensor, g_db: torch.Tensor) -> torch.Tensor:
    return y * (10.0 ** (g_db / 20.0))[..., None]


def random_gain(
    y: ArrayLike,
    key: torch.Generator,
    min_gain_db: float = -6.0,
    max_gain_db: float = 6.0,
) -> torch.Tensor:
    """Scale each batch element by an independent uniform gain in dB."""
    if min_gain_db > max_gain_db:
        raise ValueError(
            f"min_gain_db ({min_gain_db}) must be <= max_gain_db ({max_gain_db})"
        )
    y = dispatch.to_tensor(y, REAL_DTYPE)
    u = torch.rand(y.shape[:-1], generator=key, device=key.device, dtype=y.dtype)
    g_db = min_gain_db + (max_gain_db - min_gain_db) * u
    return _gain_apply(y, g_db.to(y.device))
