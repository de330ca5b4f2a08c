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

This package holds the JAX package's whole 40-name public surface
(``__all__``, plus :func:`set_default_device`): STFT / ISTFT, windows, mel
and the bark/linear filterbanks, the spectral features, MFCC, framing,
resampling, Griffin-Lim, autocorrelation and ACF pitch, and the dB
conversions; and, as the JAX package does outside ``__all__``, ``yin``,
``piptrack``, ``estimate_tuning``, ``pitch_tuning``, the mel/MFCC
inversion, ``magphase``, the rhythm-and-harmony names (onset strength and
detection, tempo and the tempograms, beat tracking, the chroma family and
tonnetz, the CQT/VQT, PCEN, mu-law and perceptual weighting), the test
signals (``tone``, ``chirp``, ``clicks``), the ``units`` and ``util``
modules, and the effects, decomposition and streaming names (``hpss``,
``harmonic``, ``percussive``, ``decompose``, ``phase_vocoder``,
``time_stretch``, ``pitch_shift``, ``trim``, ``split``, ``remix``,
``reassigned_spectrogram``, ``interp_harmonics``, ``salience``,
``recurrence_matrix``, ``cross_similarity``, ``nn_filter``, ``lpc``,
``pyin``, and the ``augment`` and ``streaming`` modules). ``magnitude_spectrogram`` is reached as
``ops.stft.magnitude_spectrogram`` and ``griffinlim_iter`` as
``ops.griffinlim.griffinlim_iter``, as in the JAX package. It imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

try:  # the distribution's version, as the JAX package reads it
    from importlib.metadata import version as _get_version

    __version__ = _get_version("mlx-audio-primitives-tpu")
except Exception:  # editable / in-tree use
    __version__ = "0.1.0"

from ._config import set_default_device
from .ops import augment  # noqa: F401  (spec_augment/time_mask/freq_mask/...)
from .ops import streaming  # noqa: F401  (StreamingSTFT/ISTFT/LogMel/MFCC/Pitch/...)
from .ops import units  # noqa: F401  (frames/time/notes/MIDI converters)
from .ops import utilx as util  # noqa: F401  (normalize/peak_pick/localmax/...)
from .ops.beat import beat_track  # noqa: F401
from .ops.chroma import (  # noqa: F401
    chroma_cens,
    chroma_cqt,
    chroma_filterbank,
    chroma_stft,
    chroma_vqt,
    tonnetz,
)
from .ops.convert import (  # noqa: F401
    amplitude_to_db,
    db_to_amplitude,
    db_to_power,
    mu_compress,
    mu_expand,
    perceptual_weighting,
    power_to_db,
)
from .ops.cqt import cqt, cqt_frequencies, pseudo_cqt, vqt  # noqa: F401
from .ops.decompose import decompose, harmonic, hpss, percussive  # noqa: F401
from .ops.effects import (  # noqa: F401
    phase_vocoder,
    pitch_shift,
    remix,
    split,
    time_stretch,
    trim,
)
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
from .ops.filterbanks import bark_filterbank, bark_to_hz, hz_to_bark, linear_filterbank
from .ops.framing import deemphasis, frame, preemphasis, rms
from .ops.griffinlim import griffinlim
from .ops.harmonics import interp_harmonics, salience  # noqa: F401
from .ops.inverse import mel_to_audio, mel_to_stft, mfcc_to_audio, mfcc_to_mel  # noqa: F401
from .ops.lpc import lpc  # noqa: F401
from .ops.mel import hz_to_mel, mel_filterbank, mel_to_hz, melspectrogram
from .ops.mfcc import dct, delta, mfcc
from .ops.onset import onset_backtrack, onset_detect, onset_strength  # noqa: F401
from .ops.pcen import pcen  # noqa: F401
from .ops.pitch import (  # noqa: F401
    autocorrelation,
    estimate_tuning,
    periodicity,
    piptrack,
    pitch_detect_acf,
    pitch_tuning,
    yin,
)
from .ops.pyin import pyin  # noqa: F401
from .ops.reassign import reassigned_spectrogram  # noqa: F401
from .ops.resample import resample, resample_poly
from .ops.rhythm import fourier_tempogram, tempo, tempo_frequencies, tempogram  # noqa: F401
from .ops.segment import cross_similarity, nn_filter, recurrence_matrix  # noqa: F401
from .ops.signals import chirp, clicks, tone  # noqa: F401
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
    # Filterbanks
    "linear_filterbank",
    "bark_filterbank",
    "hz_to_bark",
    "bark_to_hz",
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
    # Resampling
    "resample",
    "resample_poly",
    # Phase reconstruction
    "griffinlim",
    # Pitch/periodicity
    "autocorrelation",
    "pitch_detect_acf",
    "periodicity",
    # Conversions
    "power_to_db",
    "db_to_power",
    "amplitude_to_db",
    "db_to_amplitude",
    # Placement of non-tensor inputs
    "set_default_device",
]
