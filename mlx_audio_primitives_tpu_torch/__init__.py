"""PyTorch and CUDA port of mlx-audio-primitives-tpu.

Librosa-compatible audio primitives on PyTorch tensors, with the JAX
package's signatures and conventions, so a call site moves between the two
packages unchanged. Every op runs on the device of its input: pass a tensor
moved with ``.to("cuda")`` to run on the GPU; a NumPy array becomes a CPU
tensor. On a CUDA tensor the main path runs four hand-written CUDA kernels
(`kernels/`, sources in `csrc/`), built with nvcc on first use.

This package holds the STFT / ISTFT / mel slice of the JAX package and
exports that slice's part of the JAX package's top-level names. It imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

from .ops.convert import amplitude_to_db, db_to_amplitude, db_to_power, power_to_db
from .ops.mel import hz_to_mel, mel_filterbank, mel_to_hz, melspectrogram
from .ops.stft import check_nola, istft, magnitude, magphase, phase, stft  # noqa: F401
from .ops.windows import get_window

__all__ = [
    # STFT
    "stft",
    "istft",
    "magnitude",
    "phase",
    "check_nola",
    # Windows
    "get_window",
    # Mel
    "mel_filterbank",
    "melspectrogram",
    "hz_to_mel",
    "mel_to_hz",
    # Conversions
    "power_to_db",
    "db_to_power",
    "amplitude_to_db",
    "db_to_amplitude",
]
