"""Rhythm: the autocorrelation tempogram, tempo and the Fourier tempogram.

Counterpart of `mlx_audio_primitives_tpu/ops/rhythm.py`, with the same
signatures and results (`librosa.feature.tempogram` /
`librosa.feature.rhythm.tempo` / `fourier_tempogram`).

The tempogram pads the onset envelope with NumPy's ``linear_ramp`` mode
(end values 0; ``torch.nn.functional.pad`` has no such mode, so the ramps
are written out), frames it at a hop of one envelope frame (a strided
view), weights each frame with a float64 ``np.hanning`` table, and takes
every frame's autocorrelation at once: ``|rfft|^2`` at the next power of
two >= ``2*win_length - 1``, then the inverse, through
`kernels/dft.py::rfft_power_len` and ``irfft_len``. ``tempo`` moves the
tempogram's mean (or, per frame, the tempogram) to the host for the
log-normal prior and its ``argmax``, as the JAX package does.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..kernels.dft import _next_pow2, irfft_len, rfft_power_len
from ..utils import dispatch
from ..utils.cache import table_cache
from ..utils.validation import validate_positive
from ._frames import frame_signal_batched
from .onset import onset_strength

ArrayLike = Any


def tempo_frequencies(
    n: int, hop_length: int = 512, sr: int = 22050
) -> np.ndarray:
    """BPM of each tempogram lag bin (host float64): lag ``i`` frames is
    ``60 * sr / (hop * i)`` BPM; bin 0 is +inf (librosa convention)."""
    bins = np.arange(n, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return 60.0 * sr / (hop_length * bins)


def _linear_ramp_pad(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """NumPy's ``pad(mode='linear_ramp', end_values=0)`` of the last axis:
    ``before`` values rising from 0 toward the first sample (0 at the outer
    end, the sample itself excluded), ``after`` values falling from the last
    sample toward 0 (0 at the outer end)."""
    up = torch.arange(before, dtype=x.dtype, device=x.device) / max(before, 1)
    down = torch.arange(after, 0, -1, dtype=x.dtype, device=x.device) - 1
    down = down / max(after, 1)
    return torch.cat([x[..., :1] * up, x, x[..., -1:] * down], dim=-1)


@table_cache("tempogram_window", maxsize=8)
def _hanning(n: int) -> np.ndarray:
    """``np.hanning(n)``: the symmetric Hann window, float64 on the host."""
    return np.hanning(n)


def _tempogram_core(env: torch.Tensor, win_length: int) -> torch.Tensor:
    """(B, F) envelope -> (B, win_length, F) local ACF, inf-normalized per
    frame."""
    lo = win_length // 2
    hi = win_length - 1 - lo  # frames tile to exactly F windows
    env = _linear_ramp_pad(env, lo, hi)
    frames = frame_signal_batched(env, win_length, 1) * _hanning(win_length, device=env.device)
    n_fft = _next_pow2(2 * win_length - 1)
    frames = torch.nn.functional.pad(frames, (0, n_fft - win_length))
    ac = irfft_len(rfft_power_len(frames, n_fft), n_fft)[..., :win_length]
    # per-frame inf-norm (librosa util.normalize), silent frames kept as 0
    peak = ac.abs().amax(dim=-1, keepdim=True)
    tiny = float(np.finfo(np.float32).tiny)
    ac = ac / torch.where(peak < tiny, torch.ones_like(peak), peak)
    return ac.transpose(1, 2)  # (B, win, F)


def _envelope(y, sr, onset_envelope, hop_length, strength_kwargs) -> torch.Tensor:
    if onset_envelope is None:
        if y is None:
            raise ValueError("Either y or onset_envelope must be provided")
        onset_envelope = onset_strength(y, sr=sr, hop_length=hop_length, **strength_kwargs)
    return dispatch.to_tensor(onset_envelope, REAL_DTYPE)


def tempogram(
    y: ArrayLike | None = None,
    sr: int = 22050,
    onset_envelope: ArrayLike | None = None,
    hop_length: int = 512,
    win_length: int = 384,
    **strength_kwargs: Any,
) -> torch.Tensor:
    """Local ACF tempogram ``(win_length, F)`` / ``(B, win_length, F)``:
    row ``i`` is the onset envelope's autocorrelation at a lag of ``i``
    frames (``tempo_frequencies(win_length, hop_length, sr)[i]`` BPM) in a
    centered ``win_length``-frame hann window around each frame, with
    linear-ramp edge padding, inf-normalized per frame."""
    validate_positive(win_length, "win_length")
    env = _envelope(y, sr, onset_envelope, hop_length, strength_kwargs)
    input_is_1d = env.dim() == 1
    tg = _tempogram_core(env[None] if input_is_1d else env, int(win_length))
    return tg[0] if input_is_1d else tg


def tempo(
    y: ArrayLike | None = None,
    sr: int = 22050,
    onset_envelope: ArrayLike | None = None,
    hop_length: int = 512,
    start_bpm: float = 120.0,
    std_bpm: float = 1.0,
    ac_size: float = 8.0,
    max_tempo: float | None = 320.0,
    aggregate: bool = True,
    **strength_kwargs: Any,
) -> np.ndarray:
    """Tempo estimate in BPM, a host array (librosa
    `feature.rhythm.tempo`): the tempogram (window ``ac_size`` seconds)
    averaged over time, weighted by a log-normal prior at ``start_bpm``
    with spread ``std_bpm`` octaves; the best lag wins, tempi at or above
    ``max_tempo`` excluded. ``aggregate=True`` gives shape ``(1,)`` /
    ``(B, 1)``; ``aggregate=False`` scores each frame, ``(F,)`` /
    ``(B, F)``."""
    validate_positive(start_bpm, "start_bpm")
    validate_positive(std_bpm, "std_bpm")
    validate_positive(ac_size, "ac_size")
    win_length = max(int(ac_size * sr // hop_length), 2)
    tg = tempogram(y=y, sr=sr, onset_envelope=onset_envelope, hop_length=hop_length,
                   win_length=win_length, **strength_kwargs)
    input_is_1d = tg.dim() == 2
    if input_is_1d:
        tg = tg[None]
    if aggregate:
        ac = tg.mean(dim=-1).cpu().numpy()  # (B, win)
    else:
        ac = tg.transpose(1, 2).cpu().numpy()  # (B, F, win)

    bpms = tempo_frequencies(win_length, hop_length, sr)
    with np.errstate(divide="ignore"):
        logprior = -0.5 * ((np.log2(bpms) - np.log2(start_bpm)) / std_bpm) ** 2
    if max_tempo is not None:
        logprior[bpms >= max_tempo] = -np.inf
    logprior[0] = -np.inf  # lag 0 = infinite BPM
    best = np.argmax(np.log1p(1e6 * np.maximum(ac, 0.0)) + logprior, axis=-1)
    out = bpms[best] if not aggregate else bpms[best][:, None]
    return out[0] if input_is_1d else out


def fourier_tempogram(
    y: ArrayLike | None = None,
    sr: int = 22050,
    onset_envelope: ArrayLike | None = None,
    hop_length: int = 512,
    win_length: int = 384,
    center: bool = True,
    window: str = "hann",
    **strength_kwargs: Any,
) -> torch.Tensor:
    """Fourier tempogram: the complex STFT of the onset envelope at a hop of
    one frame, ``(1 + win_length//2, F)`` / ``(B, 1 + win_length//2, F)``
    (librosa `feature.fourier_tempogram`); bin ``k`` is ``60 * k * sr /
    (hop_length * win_length)`` BPM. With ``center`` the envelope is
    linear-ramp padded by ``win_length // 2`` at both ends and the STFT is
    not centered, so the edge frames taper to zero."""
    from .stft import stft as _stft

    validate_positive(win_length, "win_length")
    env = _envelope(y, sr, onset_envelope, hop_length, strength_kwargs)
    if center:
        env = _linear_ramp_pad(env, win_length // 2, win_length // 2)
    return _stft(env, n_fft=win_length, hop_length=1, window=window, center=False,
                 pad_mode="constant")


__all__ = ["tempo_frequencies", "tempogram", "tempo", "fourier_tempogram"]
