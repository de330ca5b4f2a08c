"""Test-signal generators: tone, chirp, clicks.

Counterpart of `mlx_audio_primitives_tpu/ops/signals.py` (librosa `tone` /
`chirp` / `clicks` semantics). Each waveform is built on the host in
float64 NumPy, with the JAX package's formulas, rounded to float32 and
placed on the default device, as a named window is
(`ops/windows.py::get_window`): the same values as the JAX package's
arrays, as a tensor.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils import dispatch
from ..utils.validation import validate_positive

ArrayLike = Any


def _placed(x: np.ndarray) -> torch.Tensor:
    """A host waveform as a float32 tensor on the default device."""
    return torch.as_tensor(x.astype(np.float32), device=dispatch.default_device())


def _host(x: ArrayLike) -> ArrayLike:
    """A tensor argument (on any device) as a host array; others as given."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _resolve_length(sr: int, length: int | None, duration: float | None,
                    default_duration: float | None = None) -> int:
    if length is not None:
        validate_positive(length, "length")
        return int(length)
    if duration is None:
        if default_duration is None:
            raise ValueError("Either length or duration must be provided")
        duration = default_duration
    if duration <= 0:
        raise ValueError(f"duration must be positive, got {duration}")
    return int(duration * sr)


def tone(
    frequency: float,
    sr: int = 22050,
    length: int | None = None,
    duration: float | None = None,
    phi: float | None = None,
) -> torch.Tensor:
    """Pure sinusoid ``cos(2 pi f t + phi)`` (librosa default
    ``phi = -pi/2``, i.e. a sine starting at zero)."""
    validate_positive(sr, "sr")
    if frequency <= 0:
        raise ValueError(f"frequency must be positive, got {frequency}")
    n = _resolve_length(sr, length, duration)
    if phi is None:
        phi = -np.pi / 2
    t = np.arange(n, dtype=np.float64) / sr
    return _placed(np.cos(2 * np.pi * frequency * t + phi))


def chirp(
    fmin: float,
    fmax: float,
    sr: int = 22050,
    length: int | None = None,
    duration: float | None = None,
    linear: bool = False,
    phi: float | None = None,
) -> torch.Tensor:
    """Frequency sweep from ``fmin`` to ``fmax`` — exponential (librosa
    default) or ``linear``; instantaneous frequency hits ``fmax`` exactly
    at the final sample's end."""
    validate_positive(sr, "sr")
    if fmin <= 0 or fmax <= 0:
        raise ValueError(
            f"fmin and fmax must be positive, got {fmin}, {fmax}"
        )
    n = _resolve_length(sr, length, duration)
    dur = n / sr
    if phi is None:
        phi = -np.pi / 2
    t = np.arange(n, dtype=np.float64) / sr
    if linear:
        phase = 2 * np.pi * (fmin * t + 0.5 * (fmax - fmin) / dur * t * t)
    else:
        k = (fmax / fmin) ** (1.0 / dur)
        phase = 2 * np.pi * fmin * (np.power(k, t) - 1.0) / np.log(k) \
            if fmax != fmin else 2 * np.pi * fmin * t
    return _placed(np.cos(phase + phi))


def clicks(
    times: ArrayLike | None = None,
    frames: ArrayLike | None = None,
    sr: int = 22050,
    hop_length: int = 512,
    click_freq: float = 1000.0,
    click_duration: float = 0.1,
    click: ArrayLike | None = None,
    length: int | None = None,
) -> torch.Tensor:
    """Click track: one click waveform placed at each event time (librosa
    `clicks` semantics — default click is an exponentially decaying
    1 kHz tone burst)."""
    validate_positive(sr, "sr")
    validate_positive(hop_length, "hop_length")
    if times is None and frames is None:
        raise ValueError("Either times or frames must be provided")
    times, frames, click = _host(times), _host(frames), _host(click)
    if times is not None:
        positions = (np.asarray(times, dtype=np.float64) * sr).astype(int)
    else:
        positions = np.asarray(frames, dtype=np.int64) * hop_length
    if click is not None:
        click = np.asarray(click, dtype=np.float32).ravel()
    else:
        if click_duration <= 0:
            raise ValueError(
                f"click_duration must be positive, got {click_duration}"
            )
        angular = 2 * np.pi * click_freq / sr
        n = int(sr * click_duration)
        click = np.sin(angular * np.arange(n)) * np.exp(
            -np.arange(n) / (sr * click_duration / 10.0)
        )
        click = click.astype(np.float32)
    if length is None:
        length = int(positions.max()) + len(click) if positions.size else len(click)
    validate_positive(length, "length")
    out = np.zeros(length, np.float32)
    for p in positions:
        if p >= length:
            continue
        end = min(length, p + len(click))
        out[p:end] += click[: end - p]
    return _placed(out)


__all__ = ["tone", "chirp", "clicks"]
