"""Griffin-Lim phase reconstruction.

Counterpart of `mlx_audio_primitives_tpu/ops/griffinlim.py`, with the same
signatures and numerics. The JAX package compiles its whole iteration into
one ``lax.fori_loop``; PyTorch runs eagerly, so here the loop is driven from
Python, one inverse, one forward transform and the projection per
iteration, on the device of the magnitude.

Tiers, as the JAX package picks them: under the radix gate each iteration
runs K3 (`kernels/istft_fused.py`) then K2 (`kernels/stft_radix.py`); else,
within K4's gate, the inverse transform plus the overlap-add kernel
(`kernels/overlap_add.py`) and the plain forward transform; else the plain
compositions. An explicit ``fft_mode`` pins the plain transforms unless
``use_pallas=True`` (K4 still applies). ``n_iter`` iterations launch K2
``n_iter`` times and K3 ``n_iter + 1`` times.

The spectrum stays in K2's natural ``(B, n_bins, F)`` layout through the
loop and K3 reads its ``(B, F, n_bins)`` transpose in place, so no layout
copy runs between the kernels (the JAX package's group-layout loop,
``_griffinlim_grouped_core``, has no counterpart: natural order is the
port's form of it).

Numerical details kept: the loop-invariant clamped envelope, computed once
a call; the seeded ``np.random.default_rng`` phase initialisation on the
host (the same angles as the JAX package); the +/-1-frame fixup; the
projection ``S * X/|X|`` with ``|X| = 0 -> phase 0``; Perraudin momentum
``rebuilt = new + m*(new - prev)``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import COMPLEX_DTYPE, REAL_DTYPE
from ..kernels.dft import forward_basis, inverse_basis
from ..kernels.stft_radix import stft_fused, stft_plain
from ..utils import dispatch
from ..utils.profiler import traced
from ..utils.validation import validate_positive
from .stft import (
    _get_padded_window,
    _istft_core,
    _istft_envelope,
    _istft_tier,
    _resolve_fft_mode,
    istft,
    magnitude,
    phase,
    stft,
)

ArrayLike = Any


def _project(S: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """The magnitude constraint ``S * X/|X|``, with ``|X| = 0 -> S`` (phase 0)."""
    mag = X.abs()
    nz = mag > 0
    one = torch.ones((), dtype=X.dtype, device=X.device)
    return S * torch.where(nz, X / torch.where(nz, mag, 1.0), one)


def _fix_frames(X: torch.Tensor, F: int) -> torch.Tensor:
    """Crop or zero-pad the last (frame) axis to ``F``."""
    F2 = X.shape[-1]
    if F2 > F:
        return X[..., :F]
    if F2 < F:
        return torch.nn.functional.pad(X, (0, F - F2))
    return X


def _griffinlim_core(
    S: torch.Tensor,  # (B, n_bins, F) magnitude
    angles0: torch.Tensor,  # (B, n_bins, F) initial phase
    win: torch.Tensor,
    *,
    window,
    win_length: int,
    n_fft: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
    length: int | None,
    n_iter: int,
    momentum: float,
    fft_mode: str,
    tier: str,
) -> torch.Tensor:
    B, n_bins, F = S.shape
    pad = n_fft // 2
    if length is not None:
        padded_length = length + n_fft if center else length
    else:
        padded_length = n_fft + (F - 1) * hop_length
    if center:
        L_sig = length if length is not None else max(padded_length - 2 * pad, 0)
    else:
        L_sig = length if length is not None else padded_length

    env = _istft_envelope(window, win, win_length, n_fft, F, hop_length, padded_length)
    matmul = fft_mode == "matmul" and tier != "fused"
    inv = inverse_basis(n_fft, device=S.device) if matmul else None
    fwd = forward_basis(n_fft, device=S.device) if matmul else None
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode)

    def istft_step(spec: torch.Tensor) -> torch.Tensor:
        # ``spec`` is the loop's own: the inverse may zero its DC and Nyquist
        # imaginary parts in place, as those reach only the next inverse
        # (through the momentum step), which drops them too
        y = _istft_core(spec.transpose(1, 2), win, env, inv, n_fft=n_fft,
                        hop_length=hop_length, padded_length=padded_length, tier=tier,
                        owned=True)
        if center:
            return y[:, pad : pad + L_sig]
        if length is not None and length > y.shape[1]:
            return torch.nn.functional.pad(y, (0, length - y.shape[1]))
        return y[:, :L_sig]

    def stft_step(y: torch.Tensor) -> torch.Tensor:
        y = y.contiguous()
        if tier == "fused":
            X = stft_fused(y, win, **kw)
        else:
            X = stft_plain(y, win, basis=fwd, **kw)
        return _fix_frames(X, F)

    rebuilt = torch.polar(S, angles0)
    tprev = rebuilt
    for _ in range(n_iter):
        new = _project(S, stft_step(istft_step(rebuilt)))
        rebuilt = new + momentum * (new - tprev) if momentum > 0 else new
        tprev = new
    return istft_step(rebuilt)


@traced("ops.griffinlim")
def griffinlim(
    S: ArrayLike,
    n_iter: int = 32,
    hop_length: int | None = None,
    win_length: int | None = None,
    n_fft: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    length: int | None = None,
    pad_mode: str = "constant",
    momentum: float = 0.99,
    init: str = "random",
    random_state: int | None = None,
    fft_mode: str = "auto",
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """Griffin-Lim phase reconstruction from a magnitude spectrogram
    ``(n_bins, F)`` / ``(B, n_bins, F)``, on its device (librosa-compatible
    signature). ``use_pallas`` selects the kernel tiers (see the module
    docstring)."""
    validate_positive(n_iter, "n_iter")
    # momentum in [0, 1): 0 = classic Griffin-Lim, < 1 for stability
    if not 0.0 <= momentum < 1.0:
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")

    S = dispatch.to_tensor(S, REAL_DTYPE)
    is_batched = S.dim() == 3
    if not is_batched:
        S = S[None]
    B, freq_bins, n_frames = S.shape

    if n_fft is None:
        n_fft = 2 * (freq_bins - 1)
    if hop_length is None:
        hop_length = n_fft // 4
    if win_length is None:
        win_length = n_fft
    if win_length > n_fft:
        raise ValueError(f"win_length ({win_length}) must be <= n_fft ({n_fft})")

    rng = np.random.default_rng(random_state)
    if init == "random":
        # drawn as the JAX package draws them, (B, F, n_bins), then laid out
        # as the spectrum is
        angles = torch.from_numpy(
            rng.uniform(-np.pi, np.pi, (B, n_frames, freq_bins)).astype(np.float32)
        ).to(S.device).transpose(1, 2)
    elif init == "zeros":
        angles = torch.zeros_like(S)
    else:
        raise ValueError(f"Unknown init: '{init}'. Supported: 'random', 'zeros'")

    win = _get_padded_window(window, win_length, n_fft, S.device)
    fft_mode_r = _resolve_fft_mode(fft_mode, n_fft)
    tier = _istft_tier(use_pallas, S.device, fft_mode, n_fft, hop_length, freq_bins)
    y = _griffinlim_core(
        S, angles, win, window=window, win_length=win_length, n_fft=n_fft,
        hop_length=hop_length, center=center, pad_mode=pad_mode, length=length,
        n_iter=n_iter, momentum=float(momentum), fft_mode=fft_mode_r, tier=tier,
    )
    return y if is_batched else y[0]


def griffinlim_iter(
    S: ArrayLike,
    angles: ArrayLike,
    hop_length: int,
    win_length: int,
    n_fft: int,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    momentum: float = 0.99,
    tprev: ArrayLike | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Griffin-Lim iteration: returns ``(new_angles, rebuilt, mse)``.

    Unexported single-step API for custom stopping criteria, as in the JAX
    package; it goes through the public :func:`istft` and :func:`stft`, so
    their kernel tiers.
    """
    S = dispatch.to_tensor(S, REAL_DTYPE)
    angles = torch.as_tensor(angles, dtype=REAL_DTYPE, device=S.device)
    rebuilt = torch.polar(S, angles)
    y_est = istft(rebuilt, hop_length=hop_length, win_length=win_length, n_fft=n_fft,
                  window=window, center=center)
    rebuilt_new = _fix_frames(
        stft(y_est, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
             window=window, center=center, pad_mode=pad_mode),
        S.shape[-1],
    )
    error = torch.mean((S - magnitude(rebuilt_new)) ** 2)
    new_angles = phase(rebuilt_new)
    projected = torch.polar(S, new_angles)
    if momentum > 0 and tprev is not None:
        tprev = torch.as_tensor(tprev, dtype=COMPLEX_DTYPE, device=S.device)
        out = projected + momentum * (projected - tprev)
    else:
        out = projected
    return new_angles, out, error
