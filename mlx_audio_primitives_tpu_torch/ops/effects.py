"""Time-scale and pitch effects and silence handling: ``phase_vocoder``,
``time_stretch``, ``pitch_shift``, ``trim``, ``split``, ``remix``.

Counterpart of `mlx_audio_primitives_tpu/ops/effects.py`, with the same
signatures and results. The phase vocoder is one vectorised pass (two
gathers, the phase arithmetic and one ``cumsum`` over frames), as in the
JAX package: the accumulator ``acc[t] = angle(D[..., 0]) + t * phi_advance
+ sum_{tau<t} dphase[tau]`` has its linear part, which grows to ~1e6
radians, reduced mod 2 pi in float64 on the host (`_pv_tables`), so only
the bounded deviations are summed in float32.

``time_stretch`` is STFT -> vocoder -> ISTFT: on a CUDA tensor the STFT
kernel (K2) once and the ISTFT kernel (K3) once under the radix gate.
The stretched spectrum's DC and Nyquist bins are not exactly real (a
float32 sine of an accumulated k pi is not 0); every inverse of the port
drops those imaginary parts, as NumPy, XLA and K3 do
(`kernels/dft.py::irfft_len`). ``pitch_shift`` adds the port's
``resample``. ``trim`` and ``split`` take the frame energies from ``rms``
on the device and the ragged intervals on the host.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any

import numpy as np
import torch

from .._config import COMPLEX_DTYPE, REAL_DTYPE
from ..utils import dispatch
from ..utils.validation import validate_positive
from .resample import resample as _resample
from .stft import istft, stft

ArrayLike = Any

__all__ = ["phase_vocoder", "time_stretch", "pitch_shift", "trim", "split", "remix"]

_TWO_PI = 2.0 * np.pi


@lru_cache(maxsize=32)
def _pv_tables(
    n_bins: int, n_frames: int, hop_length: int, rate: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host tables ``(idx, alpha, phi_mod, linear_phase)`` of a config.

    ``linear_phase`` is the accumulated per-hop expected advance
    ``t * phi_advance`` reduced mod 2 pi in float64, exact where a float32
    running sum drifts by ~0.1 rad over a thousand frames; ``phi_mod`` is
    ``phi_advance`` mod 2 pi (the deviation wrap is invariant under it,
    and the raw ~pi*hop value would lose ~5e-5 rad a step in float32).
    """
    time_steps = np.arange(0, n_frames, rate, dtype=np.float64)
    idx = np.floor(time_steps).astype(np.int32)
    alpha = (time_steps - idx).astype(np.float32)
    phi_advance = np.linspace(0.0, np.pi * hop_length, n_bins, dtype=np.float64)
    t = np.arange(len(time_steps), dtype=np.float64)
    linear = np.mod(phi_advance[:, None] * t[None, :], _TWO_PI)
    phi_mod = np.mod(phi_advance, _TWO_PI)
    return idx, alpha, phi_mod.astype(np.float32), linear.astype(np.float32)


@lru_cache(maxsize=32)
def _pv_tables_on(n_bins: int, n_frames: int, hop_length: int, rate: float,
                  device: str) -> tuple[torch.Tensor, ...]:
    """:func:`_pv_tables` on ``device``, cached per device: the indices as
    int64, the rest float32 (shared; callers must not modify them)."""
    idx, alpha, phi, linear = _pv_tables(n_bins, n_frames, hop_length, rate)
    return (torch.from_numpy(idx.astype(np.int64)).to(device),
            *(torch.from_numpy(a).to(device) for a in (alpha, phi, linear)))


def _pv_core(D: torch.Tensor, idx: torch.Tensor, alpha: torch.Tensor, phi_mod: torch.Tensor,
             linear_phase: torch.Tensor) -> torch.Tensor:
    """``(B, n_bins, n_frames)`` complex -> ``(B, n_bins, T)``: magnitudes
    interpolated at the fractional frames, phases accumulated."""
    # two trailing zero frames so idx + 1 never reads past the end
    Dp = torch.cat([D, torch.zeros_like(D[..., :2])], dim=-1)
    c0 = Dp.index_select(-1, idx)
    c1 = Dp.index_select(-1, idx + 1)
    mag = (1.0 - alpha) * c0.abs() + alpha * c1.abs()
    # the observed hop-to-hop phase step less the bin's expected advance,
    # wrapped to [-pi, pi] (round half to even, as jnp.round)
    dphase = torch.angle(c1) - torch.angle(c0) - phi_mod[:, None]
    del c0, c1
    dphase = dphase - _TWO_PI * torch.round(dphase / _TWO_PI)
    dev = torch.cumsum(dphase[..., :-1], dim=-1)
    dev = torch.cat([torch.zeros_like(dphase[..., :1]), dev], dim=-1)
    del dphase
    acc = torch.angle(D[..., :1]) + linear_phase + dev
    return torch.polar(mag, acc).to(COMPLEX_DTYPE)


def phase_vocoder(
    D: ArrayLike,
    rate: float,
    hop_length: int | None = None,
    n_fft: int | None = None,
) -> torch.Tensor:
    """Time-stretch an STFT by ``rate`` without changing pitch
    (``librosa.phase_vocoder``): magnitudes linearly interpolated at the
    fractional frames ``arange(0, F, rate)``, phases advanced by each bin's
    expected per-hop rotation plus the wrapped deviation observed in the
    input. ``D`` is ``(n_fft//2+1, F)`` or ``(batch, n_fft//2+1, F)``
    complex; the output has ``ceil(F / rate)`` frames."""
    validate_positive(rate, "rate")
    D = dispatch.to_tensor(D)
    if D.dim() not in (2, 3):
        raise ValueError(f"D must be 2-D or 3-D, got shape {tuple(D.shape)}")
    if not D.is_complex():
        D = D.to(COMPLEX_DTYPE)
    input_is_2d = D.dim() == 2
    if input_is_2d:
        D = D[None]
    n_bins, n_frames = D.shape[-2], D.shape[-1]
    if n_fft is None:
        n_fft = 2 * (n_bins - 1)
    if hop_length is None:
        hop_length = n_fft // 4
    validate_positive(hop_length, "hop_length")
    tables = _pv_tables_on(n_bins, n_frames, hop_length, float(rate), str(D.device))
    out = _pv_core(D, *tables)
    return out[0] if input_is_2d else out


def time_stretch(
    y: ArrayLike,
    rate: float,
    n_fft: int = 2048,
    hop_length: int | None = None,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """Stretch audio in time by ``rate``, pitch kept
    (``librosa.effects.time_stretch``): STFT -> phase vocoder -> ISTFT cut
    to ``round(len(y) / rate)`` samples. ``rate > 1`` shortens, ``rate <
    1`` lengthens. Input ``(samples,)`` or ``(batch, samples)``."""
    validate_positive(rate, "rate")
    y = dispatch.to_tensor(y, REAL_DTYPE)
    if hop_length is None:
        hop_length = n_fft // 4
    D = stft(y, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
             window=window, center=center, pad_mode=pad_mode)
    D_stretch = phase_vocoder(D, rate, hop_length=hop_length, n_fft=n_fft)
    del D
    len_stretch = int(round(y.shape[-1] / rate))
    return istft(D_stretch, hop_length=hop_length, win_length=win_length, n_fft=n_fft,
                 window=window, center=center, length=len_stretch)


def _fix_length(y: torch.Tensor, size: int) -> torch.Tensor:
    """Crop or zero-pad the last axis to exactly ``size`` samples."""
    n = y.shape[-1]
    if n == size:
        return y
    if n > size:
        return y[..., :size]
    return torch.nn.functional.pad(y, (0, size - n))


def pitch_shift(
    y: ArrayLike,
    sr: int,
    n_steps: float,
    bins_per_octave: int = 12,
    res_type: str = "fft",
    n_fft: int = 2048,
    hop_length: int | None = None,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """Shift pitch by ``n_steps`` steps (``bins_per_octave`` per octave),
    duration kept (``librosa.effects.pitch_shift``): time-stretch by
    ``2**(-n_steps/bins_per_octave)``, resample back to ``sr``, fix the
    length to the input's. ``n_steps`` may be fractional and negative."""
    validate_positive(sr, "sr")
    validate_positive(bins_per_octave, "bins_per_octave")
    y = dispatch.to_tensor(y, REAL_DTYPE)
    if float(n_steps) == 0.0:
        return y
    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    y_stretch = time_stretch(y, rate, n_fft=n_fft, hop_length=hop_length,
                             win_length=win_length, window=window, center=center,
                             pad_mode=pad_mode)
    y_shift = _resample(y_stretch, sr / rate, sr, res_type=res_type)
    return _fix_length(y_shift, y.shape[-1])


def _nonsilent_frames(
    y: torch.Tensor, frame_length: int, hop_length: int, top_db: float, ref: float | None,
) -> np.ndarray:
    """Per-frame "above the silence threshold" mask (host NumPy), librosa
    `effects._signal_to_frame_nonsilent` semantics: the framewise mean
    square against ``top_db`` below the reference power (default: the peak
    frame's, over every leading axis)."""
    from .convert import power_to_db
    from .framing import rms

    if top_db <= 0:
        raise ValueError(f"top_db must be positive, got {top_db}")
    mse = rms(y, frame_length=frame_length, hop_length=hop_length) ** 2
    ref_power = float(mse.max()) if ref is None else float(ref) ** 2
    db = power_to_db(mse[..., 0, :], ref=ref_power, top_db=None).cpu().numpy()
    if db.ndim > 1:
        db = db.max(axis=tuple(range(db.ndim - 1)))
    return db > -float(top_db)


def trim(
    y: ArrayLike,
    top_db: float = 60.0,
    ref: float | None = None,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> tuple[torch.Tensor, np.ndarray]:
    """Trim leading and trailing silence: ``(y_trimmed, [start, end])``
    (librosa `effects.trim`): the slice spans the first through the last
    frame whose energy is within ``top_db`` of the reference, in samples
    (``end`` exclusive, clipped to the signal); an all-silent signal gives
    an empty slice and ``[0, 0]``. Batched input is trimmed on every
    leading axis by the batch's aggregated (max) mask."""
    validate_positive(frame_length, "frame_length")
    validate_positive(hop_length, "hop_length")
    y = dispatch.to_tensor(y, REAL_DTYPE)
    non_silent = _nonsilent_frames(y, frame_length, hop_length, top_db, ref)
    nz = np.flatnonzero(non_silent)
    if nz.size:
        start = int(nz[0]) * hop_length
        end = min(int(y.shape[-1]), (int(nz[-1]) + 1) * hop_length)
    else:
        start = end = 0
    return y[..., start:end], np.asarray([start, end])


def split(
    y: ArrayLike,
    top_db: float = 60.0,
    ref: float | None = None,
    frame_length: int = 2048,
    hop_length: int = 512,
) -> np.ndarray:
    """Non-silent intervals ``(n_intervals, 2)`` in samples, end exclusive
    (librosa `effects.split`): maximal runs of frames above the silence
    threshold, edges clipped to the signal length."""
    validate_positive(frame_length, "frame_length")
    validate_positive(hop_length, "hop_length")
    y = dispatch.to_tensor(y, REAL_DTYPE)
    non_silent = _nonsilent_frames(y, frame_length, hop_length, top_db, ref)
    edges = np.flatnonzero(np.diff(non_silent.astype(np.int8))) + 1
    parts = [edges]
    if non_silent.size and non_silent[0]:
        parts.insert(0, np.asarray([0]))
    if non_silent.size and non_silent[-1]:
        parts.append(np.asarray([non_silent.size]))
    edges = np.concatenate(parts)
    samples = np.minimum(edges * hop_length, int(y.shape[-1]))
    return samples.reshape(-1, 2)


def remix(y: ArrayLike, intervals: ArrayLike, align_zeros: bool = True) -> torch.Tensor:
    """Re-order a signal by concatenating the given sample intervals
    (librosa `effects.remix`). ``align_zeros`` snaps each boundary to the
    nearest zero crossing of the (first-channel) signal. The intervals are
    ragged, so the assembly runs on the host; the result goes back to the
    input's device."""
    y = dispatch.to_tensor(y, REAL_DTYPE)
    yh = y.cpu().numpy()
    n = yh.shape[-1]
    iv = np.asarray(intervals, dtype=np.int64)
    if iv.ndim != 2 or iv.shape[1] != 2:
        raise ValueError(f"intervals must be (n_intervals, 2), got {tuple(iv.shape)}")
    if np.any(iv < 0) or np.any(iv > n):
        raise ValueError(f"interval bounds out of range for length {n}")
    if align_zeros and n > 1:
        mono = yh.reshape(-1, n)[0]
        zc = np.flatnonzero(np.abs(np.diff(np.signbit(mono))) > 0)
        if zc.size:
            snapped = zc[np.clip(np.searchsorted(zc, iv.ravel()), 0, zc.size - 1)].reshape(iv.shape)
            iv = np.minimum(snapped, n)
    parts = [yh[..., a:b] for a, b in iv if b > a]
    if not parts:
        return torch.zeros(yh.shape[:-1] + (0,), dtype=REAL_DTYPE, device=y.device)
    return torch.from_numpy(np.concatenate(parts, axis=-1)).to(y.device)
