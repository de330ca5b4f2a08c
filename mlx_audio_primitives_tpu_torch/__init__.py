"""PyTorch and CUDA port of mlx-audio-primitives-tpu.

Librosa-compatible audio primitives on PyTorch tensors, with the JAX
package's signatures and conventions, so a call site moves between the two
packages unchanged.

Placement: every op runs on the device of its input tensor, and a
non-tensor input (a NumPy array, a list) goes to ``cuda``, as ``jnp.asarray``
places data on the TPU; without a CUDA device such an input raises.
Passing a CPU tensor runs an op on the CPU; :func:`set_default_device`
(``"cpu"``) sends non-tensor inputs there instead. On a CUDA tensor the
ops run six hand-written CUDA kernels (`kernels/`, sources in `csrc/`),
built with nvcc on first use.

This package holds the STFT / ISTFT / mel slice and the spectral-feature
slice (magnitude STFT, spectral features, MFCC, deltas, framing) of the JAX
package and exports their part of its top-level names;
``magnitude_spectrogram`` is reached as ``ops.stft.magnitude_spectrogram``,
as in the JAX package. It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

try:  # the distribution's version, as the JAX package reads it
    from importlib.metadata import version as _get_version

    __version__ = _get_version("mlx-audio-primitives-tpu")
except Exception:  # editable / in-tree use
    __version__ = "0.1.0"

from ._config import set_default_device
from .ops.convert import amplitude_to_db, db_to_amplitude, db_to_power, power_to_db
from .ops.features import (  # noqa: F401
    poly_features,
    spectral_bandwidth,
    spectral_centroid,
    spectral_contrast,
    spectral_flatness,
    spectral_rolloff,
    stack_memory,
    sync,
    zero_crossing_rate,
)
from .ops.framing import deemphasis, frame, preemphasis, rms
from .ops.mel import hz_to_mel, mel_filterbank, mel_to_hz, melspectrogram
from .ops.mfcc import dct, delta, mfcc
from .ops.stft import check_nola, istft, magnitude, magphase, phase, stft  # noqa: F401
from .ops.windows import get_window

__all__ = [
    "__version__",
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
    # Spectral features
    "spectral_centroid",
    "spectral_bandwidth",
    "spectral_rolloff",
    "spectral_flatness",
    "spectral_contrast",
    "zero_crossing_rate",
    # MFCC
    "mfcc",
    "delta",
    "dct",
    # Time-domain
    "frame",
    "rms",
    "preemphasis",
    "deemphasis",
    # Conversions
    "power_to_db",
    "db_to_power",
    "amplitude_to_db",
    "db_to_amplitude",
    # Placement of non-tensor inputs
    "set_default_device",
]
