"""Beat tracking (Ellis dynamic programming).

Counterpart of `mlx_audio_primitives_tpu/ops/beat.py`, with the same
signature and results (librosa `beat.beat_track`; Ellis, "Beat Tracking by
Dynamic Programming", JNMR 2007):

    C(t) = O(t) + max_{t-2p <= tau <= t-p/2} [ C(tau) - alpha * log^2((t-tau)/p) ]

with O the Gaussian-smoothed onset envelope, p the beat period from the
global tempo and alpha the ``tightness``.

The envelope, the tempo's tempogram and the local score stay on the
input's device. The forward pass is sequential in t and small (about 1,300
frames of a 30 s clip, a window of ``1.5 p + 1`` predecessors), so it runs
on the host in float32 NumPy, in the JAX scan body's order of operations:
the window's candidates are the transition weights plus the previous
scores (zero before the first frame), ``argmax`` takes the first of equal
maxima, and the first-beat rule leaves frames below 1% of the peak score
unlinked until the first one above. Backtracking and trimming are host
NumPy too: a beat list is ragged output.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..utils import dispatch
from ..utils.validation import validate_positive

ArrayLike = Any


def _beat_dp(localscore: np.ndarray, *, period: int, tightness: float):
    """Forward pass over a float32 local score ``(F,)``: returns
    ``(cumscore, backlink)``; ``backlink[i]`` is the chosen predecessor, or
    -1 where frame i starts a chain (before the first confident beat)."""
    F = localscore.shape[0]
    lo = 2 * period                        # earliest predecessor: i - 2p
    hi = max(int(round(period / 2.0)), 1)  # latest: i - round(p/2)
    offs = np.arange(-lo, -hi + 1, dtype=np.float32)
    txwt = (-np.float32(tightness) * np.log(-offs / np.float32(period)) ** 2).astype(np.float32)
    score_thresh = np.float32(0.01) * localscore.max()
    # cum[k + lo] is cumscore[k]; the lo zeros before it are the scores
    # before the first frame
    cum = np.zeros(lo + F, dtype=np.float32)
    backlink = np.empty(F, dtype=np.int64)
    first_beat = True
    W = lo - hi + 1
    for i in range(F):
        cand = txwt + cum[i : i + W]
        best = int(np.argmax(cand))
        cum[lo + i] = localscore[i] + cand[best]
        if first_beat and localscore[i] < score_thresh:
            backlink[i] = -1
        else:
            backlink[i] = i - lo + best
            first_beat = False
    return cum[lo:], backlink


def _local_score(oe: torch.Tensor, *, period: int) -> torch.Tensor:
    """The onset envelope over its standard deviation (``ddof=1``),
    smoothed by a Gaussian of ``2 * period + 1`` taps (Ellis eq. 2), with
    zero padding: one product of the padded envelope's windows with the
    taps."""
    std = torch.std(oe, correction=1)
    tiny = float(np.finfo(np.float32).tiny)
    oe = oe / torch.where(std < tiny, torch.ones_like(std), std)
    t = np.arange(-period, period + 1, dtype=np.float64)
    win = torch.as_tensor(np.exp(-0.5 * (t * 32.0 / period) ** 2).astype(np.float32),
                          device=oe.device)
    ope = torch.nn.functional.pad(oe, (period, period))
    return torch.matmul(ope.unfold(-1, 2 * period + 1, 1), win)


def _last_beat(cumscore: np.ndarray) -> int:
    """Final beat: the last local max of cumscore at or above half the
    median local max (Ellis's endpoint rule as librosa has it)."""
    n = len(cumscore)
    if n == 1:
        return 0
    interior = (cumscore[1:-1] > cumscore[:-2]) & (cumscore[1:-1] >= cumscore[2:])
    lm = np.concatenate(([False], interior, [cumscore[-1] > cumscore[-2]]))
    if not lm.any():
        return n - 1
    thresh = 0.5 * np.median(cumscore[lm])
    good = np.flatnonzero(lm & (cumscore >= thresh))
    return int(good[-1]) if good.size else n - 1


def _trim_beats(localscore: np.ndarray, beats: np.ndarray) -> np.ndarray:
    """Drop weak leading and trailing beats: keep the span where the
    hann(5)-smoothed beat-onset strength exceeds half its RMS."""
    if beats.size == 0:
        return beats
    w = np.hanning(5)
    boe = np.convolve(localscore[beats], w, "same")
    thresh = 0.5 * np.sqrt(np.mean(boe**2))
    valid = np.flatnonzero(boe > thresh)
    if valid.size == 0:
        return beats[:0]
    return beats[valid[0] : valid[-1] + 1]


def beat_track(
    y: ArrayLike | None = None,
    sr: int = 22050,
    onset_envelope: ArrayLike | None = None,
    hop_length: int = 512,
    start_bpm: float = 120.0,
    tightness: float = 100.0,
    trim: bool = True,
    bpm: float | None = None,
    units: str = "frames",
    **strength_kwargs: Any,
) -> tuple[float, np.ndarray]:
    """Track beats: ``(bpm, beat_positions)``, the positions a host array
    (librosa `beat.beat_track`, Ellis 2007): the global tempo
    (:func:`~.rhythm.tempo`, unless ``bpm`` is given), the onset envelope
    smoothed by a period-matched Gaussian, the DP with the ``tightness *
    log^2`` penalty, the backtrace from the best late local maximum, and
    with ``trim`` weak leading and trailing beats dropped. An all-zero
    envelope gives ``(0.0, [])``. 1-D input only: beat lists are ragged."""
    from .onset import onset_strength
    from .rhythm import tempo as _tempo

    validate_positive(hop_length, "hop_length")
    validate_positive(tightness, "tightness")
    validate_positive(start_bpm, "start_bpm")
    if onset_envelope is None:
        if y is None:
            raise ValueError("Either y or onset_envelope must be provided")
        onset_envelope = onset_strength(y, sr=sr, hop_length=hop_length, **strength_kwargs)
    oe = dispatch.to_tensor(onset_envelope, REAL_DTYPE)
    if oe.dim() != 1:
        raise ValueError(
            f"beat_track expects a 1-D envelope, got {oe.dim()}-D "
            "(beat lists are ragged; loop batches on the host)"
        )
    if not bool(torch.any(oe != 0.0)):
        return 0.0, np.empty(0, dtype=np.int64)

    if bpm is None:
        bpm = float(np.atleast_1d(
            _tempo(onset_envelope=oe, sr=sr, hop_length=hop_length, start_bpm=start_bpm)
        ).ravel()[0])
    if not np.isfinite(bpm) or bpm <= 0:
        raise ValueError(f"bpm must be positive and finite, got {bpm}")

    period = max(int(round(60.0 * sr / (bpm * hop_length))), 1)
    localscore = _local_score(oe, period=period).cpu().numpy()
    if int(oe.shape[0]) <= 2 * period:
        # too short for the DP window: every frame could only link to a
        # predecessor before the signal; the single best frame
        beats = np.asarray([int(np.argmax(localscore))])
    else:
        cumscore, backlink = _beat_dp(localscore, period=period, tightness=float(tightness))
        chain = [_last_beat(cumscore)]
        while backlink[chain[-1]] >= 0:
            chain.append(int(backlink[chain[-1]]))
        beats = np.asarray(chain[::-1], dtype=np.int64)
    if trim:
        beats = _trim_beats(localscore, beats)

    if units == "frames":
        return bpm, beats
    if units == "samples":
        return bpm, beats * hop_length
    if units == "time":
        return bpm, beats * (hop_length / float(sr))
    raise ValueError(
        f"Unknown units: '{units}'. Supported: 'frames', 'samples', 'time'"
    )


__all__ = ["beat_track"]
