"""Probabilistic YIN (pYIN) pitch tracking.

Counterpart of `mlx_audio_primitives_tpu/ops/pyin.py`, with the same
signature and results (Mauch & Dixon, ICASSP 2014; librosa.pyin). Every
trough of the cumulative mean normalized difference (CMND, the port's
`ops/pitch.py::_yin_cmnd`) is a pitch candidate whose probability
integrates a Beta(2, 18) prior over thresholds with a Boltzmann
preference for earlier troughs; an HMM over (pitch bin x voicing) states
is decoded by Viterbi.

* Memory: the threshold integration compares every trough with every
  threshold, ``(frames, periods, thresholds)`` values, 2.7 G of them at
  64 x 30 s with 65-2093 Hz and 100 thresholds. It runs in chunks of
  frames, each near ``_OBS_CHUNK_CELLS`` cells.
* The candidates' probabilities are added into log2-spaced pitch bins by
  ``scatter_add_``. On CUDA its order of additions is unspecified, but two
  addends commute exactly, so the bits can change only where three or more
  troughs fall into one bin. Troughs lie at least two lags apart and a bin
  of 0.1 semitone spans at most three lags below 700 lags (fmin above ~31
  Hz at 22,050 Hz), so at the default resolution a bin holds at most two.
* The Viterbi runs on the device, one step a frame over ``(B, S, S)``
  scores (S = 2 x n_bins), in the JAX scan body's order: add the
  transition, take the max, add the observation, subtract the row max.
  Its best predecessor is ``argmax``'s first index, as ``jnp.argmax``'s;
  the scores are laid out ``(B, cur, prev)`` so each step reduces over
  contiguous values. Backpointers are kept as int32; the backtrace walks
  them on the host.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..utils import dispatch
from ..utils.validation import validate_positive
from ._frames import pad_signal

ArrayLike = Any

__all__ = ["pyin"]

_TINY32 = float(np.finfo(np.float32).tiny)

#: (frame, period, threshold) cells one chunk of the threshold integration
#: holds (each cell takes ~17 bytes of temporaries)
_OBS_CHUNK_CELLS = 1 << 25


@lru_cache(maxsize=8)
def _beta_threshold_prior(n_thresholds: int, a: float, b: float) -> np.ndarray:
    """Mass of each threshold level under Beta(a, b): CDF differences on a
    uniform grid over (0, 1] (host float64; the regularized incomplete beta
    by a fine trapezoid, error ~1e-10 at 4,096 panels)."""
    grid = np.linspace(0.0, 1.0, 4097)
    pdf = grid ** (a - 1.0) * (1.0 - grid) ** (b - 1.0)
    # endpoint singularities are absent for a, b > 1 (default 2, 18); guard any
    pdf = np.nan_to_num(pdf, posinf=0.0)
    cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) * 0.5)])
    cdf /= cdf[-1]
    t = np.linspace(0.0, 1.0, n_thresholds + 1)
    return np.diff(np.interp(t, grid, cdf))


@lru_cache(maxsize=8)
def _transition_tables(n_bins: int, width: int, switch_prob: float) -> tuple[np.ndarray, np.ndarray]:
    """(log local (n_bins, n_bins), log switch (2, 2)) host tables, float32."""
    delta = np.abs(np.subtract.outer(np.arange(n_bins), np.arange(n_bins)))
    half = width // 2
    tri = np.maximum(half + 1 - delta, 0).astype(np.float64)
    tri /= tri.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore"):
        log_local = np.log(tri)
    sw = np.array([[1.0 - switch_prob, switch_prob], [switch_prob, 1.0 - switch_prob]])
    return log_local.astype(np.float32), np.log(sw).astype(np.float32)


def _trough_probs(band: torch.Tensor, beta: torch.Tensor, *, boltzmann_parameter: float,
                  no_trough_prob: float, min_period: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(R, P)`` CMND rows -> (each trough's probability ``(R, P)``, its
    refined period ``(R, P)``)."""
    R, P = band.shape
    n_thr = beta.shape[0]
    # interior local minima (librosa localmin: < prev, <= next); the global
    # minimum is always admitted as the fallback candidate
    prev = torch.cat([band[:, :1] + 1.0, band[:, :-1]], dim=-1)
    nxt = torch.cat([band[:, 1:], band[:, -1:] + 1.0], dim=-1)
    gmin = band.argmin(-1)
    is_gmin = torch.arange(P, device=band.device)[None, :] == gmin[:, None]
    trough = ((band < prev) & (band <= nxt)) | is_gmin
    # a silent frame (CMND ~0 everywhere) has no trough below any threshold
    dead = band.amax(-1, keepdim=True) < 1e-7
    d = torch.where(trough & ~dead, band, 1e6)

    # parabolic refinement of each trough's period
    denom = prev + nxt - 2.0 * band
    shift = torch.where(denom.abs() > _TINY32, 0.5 * (prev - nxt) / denom, 0.0)
    shift = torch.clamp(shift, -0.5, 0.5)
    period = torch.arange(P, dtype=band.dtype, device=band.device)[None, :] + min_period + shift

    # threshold integration: at each level t_i (mass beta[i]) the troughs
    # with depth < t_i share the mass by Boltzmann rank
    t_levels = torch.linspace(1.0 / n_thr, 1.0, n_thr, dtype=band.dtype, device=band.device)
    lam = float(boltzmann_parameter)
    c0 = 1.0 - float(np.exp(np.float32(-lam)))
    prob = torch.empty_like(band)
    empty_mass = torch.empty((R,), dtype=band.dtype, device=band.device)
    step = max(1, _OBS_CHUNK_CELLS // (P * n_thr))
    for r0 in range(0, R, step):
        below = d[r0 : r0 + step, :, None] < t_levels  # (r, P, T)
        below_f = below.to(band.dtype)
        rank = torch.cumsum(below_f, dim=-2) - 1.0
        n_below = below_f.sum(-2, keepdim=True)  # (r, 1, T)
        del below_f
        # Boltzmann pmf over ranks 0..N-1: (1-e^-lam) e^(-lam r) / (1-e^-lam N)
        bw = c0 * torch.exp(-lam * rank) / torch.clamp(1.0 - torch.exp(-lam * n_below),
                                                       min=_TINY32)
        prob[r0 : r0 + step] = (torch.where(below, bw, 0.0) * beta).sum(-1)
        empty_mass[r0 : r0 + step] = torch.where(n_below[:, 0, :] == 0, beta, 0.0).sum(-1)
        del below, rank, bw
    # thresholds with no trough below: no_trough_prob of their mass goes to
    # the global minimum, except in a silent frame, which gets no voiced mass
    fallback = torch.where(dead[:, 0], 0.0, no_trough_prob * empty_mass)
    return prob + is_gmin * fallback[:, None], period


def _pyin_observations(band: torch.Tensor, beta: torch.Tensor, *, boltzmann_parameter: float,
                       no_trough_prob: float, n_bins: int, bins_per_semitone: int,
                       min_period: int, sr: int, fmin: float):
    """``(B, F, P)`` CMND band -> (observation ``(B, F, n_bins)``,
    voiced probability ``(B, F)``)."""
    B, F, P = band.shape
    prob, period = _trough_probs(band.reshape(B * F, P), beta,
                                 boltzmann_parameter=boltzmann_parameter,
                                 no_trough_prob=no_trough_prob, min_period=min_period)
    voiced_prob = torch.clamp(prob.sum(-1), 0.0, 1.0)
    # candidate probabilities into log2-spaced pitch bins
    f0 = sr / torch.clamp(period, min=_TINY32)
    bin_f = 12.0 * bins_per_semitone * torch.log2(torch.clamp(f0, min=_TINY32) / fmin)
    bin_idx = torch.clamp(torch.round(bin_f).long(), 0, n_bins - 1)
    obs = torch.zeros((B * F, n_bins), dtype=band.dtype, device=band.device)
    obs.scatter_add_(1, bin_idx, prob)
    return obs.reshape(B, F, n_bins), voiced_prob.reshape(B, F)


def _log_observations(obs: torch.Tensor, voiced_prob: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``(B, F, 2 x n_bins)`` observation log-probabilities: voiced bins
    carry the trough mass, unvoiced bins share (1 - voiced_prob)
    uniformly."""
    o_v = torch.log(torch.clamp(obs, min=_TINY32))
    o_u = torch.log(torch.clamp((1.0 - voiced_prob)[..., None] / n_bins, min=_TINY32))
    return torch.cat([o_v, o_u.expand_as(o_v)], dim=-1)


def _pyin_viterbi(obs: torch.Tensor, voiced_prob: torch.Tensor, log_local: torch.Tensor,
                  log_switch: torch.Tensor, *, n_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Viterbi over 2 x n_bins (voiced bin | unvoiced bin) states: (last
    state ``(B,)``, backpointers ``(B, F-1, S)`` int32)."""
    B, F, _ = obs.shape
    logO = _log_observations(obs, voiced_prob, n_bins)
    S = 2 * n_bins
    # (S, S) log transition, kron(voicing switch, local pitch band), with
    # states [voiced bins | unvoiced bins]: T[prev, cur]
    T = torch.cat([
        torch.cat([log_switch[0, 0] + log_local, log_switch[0, 1] + log_local], dim=1),
        torch.cat([log_switch[1, 0] + log_local, log_switch[1, 1] + log_local], dim=1),
    ], dim=0)
    Tt = T.t().contiguous()  # [cur, prev]
    bps = torch.empty((B, max(F - 1, 0), S), dtype=torch.int32, device=obs.device)
    delta = logO[:, 0, :] - float(np.log(np.float32(S)))
    for t in range(1, F):
        scores = delta[:, None, :] + Tt  # (B, cur, prev)
        bp = scores.argmax(-1)
        best = scores.gather(-1, bp[..., None])[..., 0]
        bps[:, t - 1] = bp
        delta = best + logO[:, t, :]
        # renormalize to stop drift over long signals
        delta = delta - delta.amax(-1, keepdim=True)
    return delta.argmax(-1), bps


def _decode(last: torch.Tensor, bps: torch.Tensor, *, n_bins: int, fmin: float,
            bins_per_semitone: int, fill_na: float) -> tuple[np.ndarray, np.ndarray]:
    """The Viterbi backtrace on the host, sequential in frames: (f0, voiced)
    NumPy arrays ``(B, F)``; f0 is the pitch bin's centre."""
    bps = bps.cpu().numpy()
    B, Fm1, _ = bps.shape
    states = np.empty((B, Fm1 + 1), np.int64)
    states[:, -1] = last.cpu().numpy()
    rows = np.arange(B)
    for t in range(Fm1 - 1, -1, -1):
        states[:, t] = bps[rows, t, states[:, t + 1]]
    voiced = states < n_bins
    freqs = fmin * 2.0 ** (np.arange(n_bins) / (12.0 * bins_per_semitone))
    return np.where(voiced, freqs[states % n_bins], fill_na).astype(np.float32), voiced


def pyin(
    y: ArrayLike,
    fmin: float,
    fmax: float,
    sr: int = 22050,
    frame_length: int = 2048,
    win_length: int | None = None,
    hop_length: int | None = None,
    n_thresholds: int = 100,
    beta_parameters: tuple[float, float] = (2.0, 18.0),
    boltzmann_parameter: float = 2.0,
    resolution: float = 0.1,
    max_transition_rate: float = 35.92,
    switch_prob: float = 0.01,
    no_trough_prob: float = 0.01,
    fill_na: float = np.nan,
    center: bool = True,
    pad_mode: str = "constant",
):
    """pYIN fundamental frequency track: ``(f0, voiced_flag, voiced_prob)``,
    each ``(F,)`` / ``(B, F)`` NumPy arrays (as the JAX package returns);
    unvoiced frames get ``fill_na`` in ``f0``. Parameters follow
    librosa.pyin: ``resolution`` in semitones per pitch bin,
    ``max_transition_rate`` in octaves per second (the Viterbi's
    triangular transition band), ``switch_prob`` the voicing switch
    probability, ``beta_parameters`` the threshold prior. The decoded f0
    is the Viterbi's pitch-bin centre, accurate to ``resolution``."""
    from .pitch import _yin_cmnd

    validate_positive(frame_length, "frame_length")
    if win_length is None:
        win_length = frame_length // 2
    if hop_length is None:
        hop_length = frame_length // 4
    validate_positive(hop_length, "hop_length")
    validate_positive(win_length, "win_length")
    validate_positive(n_thresholds, "n_thresholds")
    if win_length >= frame_length:
        raise ValueError(
            f"win_length ({win_length}) must be less than frame_length ({frame_length})"
        )
    if fmin <= 0:
        raise ValueError(f"fmin must be positive, got {fmin}")
    if fmin >= fmax:
        raise ValueError(f"fmin ({fmin}) must be less than fmax ({fmax})")
    if not 0 <= switch_prob <= 1:
        raise ValueError(f"switch_prob must be in [0, 1], got {switch_prob}")
    if resolution <= 0 or resolution > 1:
        raise ValueError(f"resolution must be in (0, 1], got {resolution}")

    min_period = max(int(np.floor(sr / fmax)), 1)
    max_period = min(int(np.ceil(sr / fmin)), frame_length - win_length - 1)
    if max_period <= min_period:
        raise ValueError(
            f"the period band [{min_period}, {max_period}] is empty: raise "
            f"frame_length ({frame_length}) or narrow [fmin, fmax]"
        )

    y = dispatch.to_tensor(y, REAL_DTYPE)
    input_is_1d = y.dim() == 1
    if input_is_1d:
        y = y[None]
    if center:
        y = pad_signal(y, frame_length // 2, pad_mode)
    if y.shape[-1] < frame_length:
        raise ValueError(
            f"signal of length {y.shape[-1]} is shorter than frame_length ({frame_length})"
        )

    bins_per_semitone = max(int(round(1.0 / resolution)), 1)
    n_bins = int(np.ceil(12.0 * bins_per_semitone * np.log2(fmax / fmin))) + 1
    band = _yin_cmnd(y, frame_length=frame_length, win_length=win_length,
                     hop_length=hop_length, min_period=min_period, max_period=max_period)
    beta = torch.from_numpy(_beta_threshold_prior(
        int(n_thresholds), float(beta_parameters[0]), float(beta_parameters[1]),
    ).astype(np.float32)).to(y.device)
    obs, voiced_prob = _pyin_observations(
        band, beta, boltzmann_parameter=float(boltzmann_parameter),
        no_trough_prob=float(no_trough_prob), n_bins=n_bins,
        bins_per_semitone=bins_per_semitone, min_period=min_period, sr=int(sr),
        fmin=float(fmin),
    )
    del band

    frames_per_sec = sr / hop_length
    width = 2 * max(int(round(max_transition_rate * 12.0 * bins_per_semitone / frames_per_sec)),
                    1) + 1
    log_local, log_switch = (torch.from_numpy(a).to(y.device) for a in _transition_tables(
        n_bins, min(width, 2 * n_bins - 1), float(switch_prob)))
    last, bps = _pyin_viterbi(obs, voiced_prob, log_local, log_switch, n_bins=n_bins)

    f0, voiced = _decode(last, bps, n_bins=n_bins, fmin=float(fmin),
                         bins_per_semitone=bins_per_semitone, fill_na=fill_na)
    vp = voiced_prob.cpu().numpy()
    if input_is_1d:
        return f0[0], voiced[0], vp[0]
    return f0, voiced, vp
