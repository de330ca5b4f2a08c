"""Time-frequency reassigned spectrogram (Auger-Flandrin method).

Counterpart of `mlx_audio_primitives_tpu/ops/reassign.py`, with the same
signature and results (librosa `reassigned_spectrogram`): each STFT cell's
energy is relocated to the instantaneous frequency and group-delay time of
what it measured, from three STFTs with the window ``h``, its derivative
``dh`` (cyclic spectral differentiation, exact for the sampled window) and
the time-ramped ``th = h * (m - n_fft/2)``:

    f_hat[k, t] = f_k  - sr/(2 pi) * Im(S_dh * conj(S_h)) / |S_h|^2
    t_hat[k, t] = t_fr + (1 / sr)  * Re(S_th * conj(S_h)) / |S_h|^2

The three windows are built on the host in float64 and rounded once to
float32, as in the JAX package; on a CUDA tensor each STFT is one launch
of the STFT kernel (K2), which takes any window: ``dh`` has negative taps
and ``th`` reaches +-n_fft/2 times ``h``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..utils import dispatch
from ..utils.validation import validate_positive
from .stft import _get_padded_window, stft

ArrayLike = Any

__all__ = ["reassigned_spectrogram"]

_TINY32 = float(np.finfo(np.float32).tiny)


def _reassign_windows(window, win_length: int, n_fft: int) -> tuple[np.ndarray, ...]:
    """``(h, dh, th)`` as float32 host arrays, each built in float64 from
    the padded float32 window."""
    h = _get_padded_window(window, win_length, n_fft, "cpu").double().numpy()
    # cyclic spectral differentiation: the exact d/dm of the bandlimited
    # interpolant of h, in per-sample units
    H = np.fft.fft(h)
    kk = np.fft.fftfreq(n_fft) * n_fft
    dh = np.real(np.fft.ifft(H * 2j * np.pi * kk / n_fft))
    th = h * (np.arange(n_fft) - n_fft / 2.0)
    return h.astype(np.float32), dh.astype(np.float32), th.astype(np.float32)


def _reassign_post(Sh: torch.Tensor, Sdh: torch.Tensor, Sth: torch.Tensor,
                   bin_freqs: torch.Tensor, frame_times: torch.Tensor, sr: float,
                   ref_power: float):
    p = Sh.real**2 + Sh.imag**2
    denom = torch.clamp(p, min=_TINY32)
    # sr / 2 pi as the float32 quotient of float32 operands, as the JAX
    # package computes it; Python scalars, so nothing is copied to the device
    f_scale = float(np.float32(sr) / np.float32(2.0 * np.pi))
    Shc = Sh.conj()
    corr_f = (Sdh * Shc).imag / denom * f_scale
    corr_t = (Sth * Shc).real / denom / float(np.float32(sr))
    freqs = bin_freqs[:, None] - corr_f
    times = frame_times[None, :] + corr_t
    bad = ~(p > ref_power)  # NaN power too, as the JAX package's where(p > ref)
    return freqs.masked_fill(bad, float("nan")), times.masked_fill(bad, float("nan")), torch.sqrt(p)


def reassigned_spectrogram(
    y: ArrayLike,
    sr: int = 22050,
    n_fft: int = 2048,
    hop_length: int | None = None,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    ref_power: float = 1e-6,
    clip: bool = True,
    fft_mode: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(freqs, times, mags)``, each shaped like the magnitude STFT.

    ``freqs[k, t]`` / ``times[k, t]`` are the reassigned position (Hz,
    seconds) of cell ``(k, t)``'s energy; ``mags`` is ``|STFT|``. Cells at
    or below ``ref_power`` (absolute) get NaN coordinates. ``clip`` limits
    the coordinates to ``[0, sr/2]`` and the signal's duration. Batched
    input gives ``(B, bins, F)`` everywhere."""
    validate_positive(n_fft, "n_fft")
    if hop_length is None:
        hop_length = n_fft // 4
    validate_positive(hop_length, "hop_length")
    if win_length is None:
        win_length = n_fft
    if ref_power < 0:
        raise ValueError(f"ref_power must be non-negative, got {ref_power}")
    y = dispatch.to_tensor(y, REAL_DTYPE)
    dur_samples = y.shape[-1]

    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode,
              fft_mode=fft_mode)
    Sh, Sdh, Sth = (stft(y, window=torch.from_numpy(w).to(y.device), **kw)
                    for w in _reassign_windows(window, win_length, n_fft))

    n_frames = Sh.shape[-1]
    bin_freqs = torch.linspace(0.0, sr / 2.0, n_fft // 2 + 1, dtype=REAL_DTYPE, device=y.device)
    start = 0.0 if center else (n_fft / 2.0)
    frame_times = (start + hop_length * torch.arange(n_frames, dtype=REAL_DTYPE,
                                                     device=y.device)) / float(sr)
    freqs, times, mags = _reassign_post(Sh, Sdh, Sth, bin_freqs, frame_times, float(sr),
                                        float(ref_power))
    if clip:
        freqs = torch.clamp(freqs, 0.0, sr / 2.0)
        times = torch.clamp(times, 0.0, dur_samples / float(sr))
    return freqs, times, mags
