"""Onset strength envelope and onset detection.

Counterpart of `mlx_audio_primitives_tpu/ops/onset.py`, with the same
signatures and results (`librosa.onset.onset_strength` / `onset_detect`:
spectral flux, then librosa's peak picking).

* ``onset_strength`` of a signal takes its mel spectrogram from
  :func:`~.mel.melspectrogram`, so on a CUDA tensor it runs the fused
  filterbank kernel (K1, `kernels/mel_fused.py`) once. Its dB clip
  (``top_db`` 80) is taken against each clip's own maximum, as the JAX
  package's ``vmap`` of ``power_to_db`` does, never against the batch's.
* The pools are scipy's windows: the ``max_size`` frequency max filter is
  left-biased for an even size (``max_size // 2`` bins before the center),
  with edge padding; peak picking's max and mean windows clip at the ends,
  the mean dividing by the count of samples inside.
* The ``wait`` debounce of peak picking is sequential in the frames. Its
  candidates (the frames that pass the max and mean tests, computed on the
  input's device) go to the host, where a loop over the candidates alone
  keeps each one more than ``wait`` frames after the last one kept: the
  result is an index list on the host in any case.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as tnf

from .._config import REAL_DTYPE
from ..utils import dispatch
from ..utils.validation import validate_non_negative, validate_positive
from .convert import power_to_db
from .mel import melspectrogram

ArrayLike = Any


def _freq_max_filter(S: torch.Tensor, max_size: int) -> torch.Tensor:
    """scipy's ``maximum_filter`` of ``max_size`` bins over axis -2 with
    edge padding: ``max_size // 2`` bins before the center, the rest after."""
    lo = max_size // 2
    hi = max_size - 1 - lo
    n = S.shape[-2]
    idx = torch.arange(-lo, n + hi, device=S.device).clamp(0, n - 1)
    return S.index_select(-2, idx).unfold(-2, max_size, 1).amax(-1)


def _onset_strength_core(S_db: torch.Tensor, *, lag: int, max_size: int, detrend: bool,
                         center_pad: int) -> torch.Tensor:
    """(B, n_bands, F) dB spectrogram -> (B, F) onset envelope."""
    ref = _freq_max_filter(S_db, max_size) if max_size > 1 else S_db
    # rectified spectral flux with lag, averaged over the bands
    env = torch.clamp(S_db[..., lag:] - ref[..., :-lag], min=0.0).mean(dim=-2)
    # the lost `lag` frames are padded at the start; centering adds
    # n_fft // (2*hop) more, then the envelope is cut back to F frames
    F = env.shape[-1] + lag
    env = tnf.pad(env, (lag + center_pad, 0))[..., :F]
    if detrend:
        # scipy.signal.detrend(type='linear'): the least-squares line over
        # the frames, subtracted
        n = env.shape[-1]
        xc = torch.arange(n, dtype=REAL_DTYPE, device=env.device) - (n - 1) / 2.0
        slope = (env * xc).sum(dim=-1, keepdim=True) / (xc * xc).sum()
        env = env - (env.mean(dim=-1, keepdim=True) + slope * xc)
    return env


def onset_strength(
    y: ArrayLike | None = None,
    sr: int = 22050,
    S: ArrayLike | None = None,
    lag: int = 1,
    max_size: int = 1,
    detrend: bool = False,
    center: bool = True,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """Spectral-flux onset strength envelope, ``(n_frames,)`` / ``(B, F)``
    (librosa `onset.onset_strength`): the rectified first difference of the
    dB mel spectrogram, averaged over the mel bands. ``max_size > 1`` takes
    the difference against a max filter over frequency (superflux). The
    ``lag`` frames lost to the difference are padded at the start;
    ``center=True`` adds ``n_fft // (2*hop_length)`` more and cuts back to
    the frame count. ``S`` replaces the mel front end: a dB spectrogram
    ``(..., n_bands, F)``. ``use_pallas`` picks the mel route as for
    :func:`~.mel.melspectrogram`."""
    validate_positive(lag, "lag")
    validate_positive(max_size, "max_size")
    if S is None:
        if y is None:
            raise ValueError("Either y or S must be provided")
        M = melspectrogram(y, sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels,
                           fmin=fmin, fmax=fmax, use_pallas=use_pallas)
        # power_to_db's top_db of 80 against each clip's own maximum
        S_db = power_to_db(M, top_db=None)
        S_db = torch.maximum(S_db, S_db.amax(dim=(-2, -1), keepdim=True) - 80.0)
    else:
        S_db = dispatch.to_tensor(S, REAL_DTYPE)
    input_is_1d = S_db.dim() == 2
    if input_is_1d:
        S_db = S_db[None]
    center_pad = n_fft // (2 * hop_length) if center else 0
    env = _onset_strength_core(S_db, lag=lag, max_size=max_size, detrend=detrend,
                               center_pad=center_pad)
    return env[0] if input_is_1d else env


def _pool_max(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Sliding max over [n-before, n+after], the window clipped at the ends."""
    xp = tnf.pad(x, (before, after), value=float("-inf"))
    return xp.unfold(-1, before + after + 1, 1).amax(-1)


def _pool_mean(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Sliding mean over [n-before, n+after]; a window clipped at an end
    divides by the samples it holds, as NumPy slicing does in librosa."""
    F = x.shape[-1]
    s = tnf.pad(x, (before, after)).unfold(-1, before + after + 1, 1).sum(-1)
    n = np.arange(F)
    count = np.minimum(n + after, F - 1) - np.maximum(n - before, 0) + 1
    return s / torch.as_tensor(count.astype(np.float32), device=x.device)


def _peak_pick_mask(
    env: torch.Tensor,
    *,
    pre_max: int,
    post_max: int,
    pre_avg: int,
    post_avg: int,
    delta: float,
    wait: int,
) -> np.ndarray:
    """librosa `util.peak_pick` as a host boolean mask over frames (B, F):
    (1) x[n] == max over [n-pre_max, n+post_max]; (2) x[n] >= mean over
    [n-pre_avg, n+post_avg] + delta, both on the input's device; (3) the
    greedy debounce, at least ``wait + 1`` frames after the last peak
    kept, on the host over the candidates of (1) and (2)."""
    is_max = env >= _pool_max(env, pre_max, post_max)
    above = env >= _pool_mean(env, pre_avg, post_avg) + delta
    cand = (is_max & above).cpu().numpy()
    if wait == 0:
        return cand
    out = np.zeros_like(cand)
    for r, row in enumerate(cand):
        last = -wait - 1
        for n in np.flatnonzero(row):
            if n - last > wait:
                out[r, n] = True
                last = n
    return out


def onset_detect(
    y: ArrayLike | None = None,
    sr: int = 22050,
    onset_envelope: ArrayLike | None = None,
    hop_length: int = 512,
    backtrack: bool = False,
    energy: ArrayLike | None = None,
    units: str = "frames",
    normalize: bool = True,
    pre_max: int | None = None,
    post_max: int | None = None,
    pre_avg: int | None = None,
    post_avg: int | None = None,
    delta: float = 0.07,
    wait: int | None = None,
    **strength_kwargs: Any,
) -> np.ndarray:
    """Onset events picked from the strength envelope, as a host NumPy
    array of frames, samples or seconds (librosa `onset.onset_detect`):
    the envelope is scaled to [0, 1], then peak-picked with librosa's
    windows (0.03 s max, 0.10 s mean, 0.03 s wait, floor-divided by the
    hop). ``backtrack=True`` moves each onset back to the preceding local
    minimum of ``energy`` (default: the envelope). 1-D input only: event
    lists are ragged."""
    if onset_envelope is None:
        if y is None:
            raise ValueError("Either y or onset_envelope must be provided")
        onset_envelope = onset_strength(y, sr=sr, hop_length=hop_length, **strength_kwargs)
    env = dispatch.to_tensor(onset_envelope, REAL_DTYPE)
    if env.dim() != 1:
        raise ValueError(
            f"onset_detect expects a 1-D envelope, got {env.dim()}-D "
            "(event lists are ragged; loop batches on the host)"
        )
    validate_positive(hop_length, "hop_length")
    validate_non_negative(delta, "delta")

    # librosa's defaults: seconds * sr FLOOR-divided by hop (at sr 22050,
    # hop 512: pre_max 1, pre_avg 4, wait 1)
    if pre_max is None:
        pre_max = int(0.03 * sr // hop_length)
    if post_max is None:
        post_max = int(0.00 * sr // hop_length) + 1
    if pre_avg is None:
        pre_avg = int(0.10 * sr // hop_length)
    if post_avg is None:
        post_avg = int(0.10 * sr // hop_length) + 1
    if wait is None:
        wait = int(0.03 * sr // hop_length)

    if normalize:
        lo = env.min()
        rng = env.max() - lo
        env = torch.where(rng > 0, (env - lo) / torch.where(rng > 0, rng, torch.ones_like(rng)),
                          env)

    mask = _peak_pick_mask(
        env[None],
        pre_max=int(pre_max),
        # librosa's max slice x[n-pre : n+post] excludes its end
        post_max=int(post_max) - 1,
        pre_avg=int(pre_avg),
        post_avg=int(post_avg) - 1,
        delta=float(delta),
        wait=int(wait),
    )[0]
    onsets = np.flatnonzero(mask)

    if backtrack:
        e = env if energy is None else energy
        if isinstance(e, torch.Tensor):
            e = e.detach().cpu().numpy()
        onsets = _backtrack(onsets, np.asarray(e, dtype=np.float64))

    if units == "frames":
        return onsets
    if units == "samples":
        return onsets * hop_length
    if units == "time":
        return onsets * (hop_length / float(sr))
    raise ValueError(f"Unknown units: '{units}'. Supported: 'frames', 'samples', 'time'")


def _backtrack(onsets: np.ndarray, energy: np.ndarray) -> np.ndarray:
    """Move each onset back to the preceding local minimum of ``energy``
    (librosa `onset_backtrack`), on the host."""
    if len(onsets) == 0 or len(energy) < 3:
        return onsets
    # librosa util.localmin: strictly below the PREVIOUS sample, <= the NEXT
    # — a flat-bottomed valley backtracks to its FIRST frame, not its last
    interior = (energy[1:-1] < energy[:-2]) & (energy[1:-1] <= energy[2:])
    minima = np.flatnonzero(np.concatenate(([True], interior, [False])))
    pos = np.searchsorted(minima, onsets, side="right") - 1
    return minima[np.maximum(pos, 0)]


def onset_backtrack(events: ArrayLike, energy: ArrayLike) -> np.ndarray:
    """Move each detected onset back to the preceding local minimum of an
    energy curve (librosa `onset.onset_backtrack`; the routine
    :func:`onset_detect` uses for ``backtrack=True``), on the host."""
    if isinstance(energy, torch.Tensor):
        energy = energy.detach().cpu().numpy()
    return _backtrack(
        np.asarray(events, dtype=np.int64),
        np.asarray(energy, dtype=np.float64).ravel(),
    )


__all__ = ["onset_strength", "onset_detect", "onset_backtrack"]
