"""Core and composite DSP ops (librosa-compatible): the counterparts of the
JAX package's `ops/`, bound under the same names. As there, ``stft``,
``pyin``, ``pcen``, ``lpc``, ``resample`` and ``griffinlim`` name the
functions, not their modules: reach a module's other names with
``from mlx_audio_primitives_tpu_torch.ops.stft import ...`` or
``importlib.import_module``."""

from .convert import amplitude_to_db, db_to_amplitude, db_to_power, power_to_db
from .features import (
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
from .filterbanks import bark_filterbank, bark_to_hz, hz_to_bark, linear_filterbank
from .framing import deemphasis, frame, preemphasis, rms
from .griffinlim import griffinlim
from .mel import hz_to_mel, mel_filterbank, mel_to_hz, melspectrogram
from .mfcc import dct, delta, mfcc
from .beat import beat_track
from .lpc import lpc
from .pcen import pcen
from .harmonics import interp_harmonics, salience
from .reassign import reassigned_spectrogram
from .segment import cross_similarity, nn_filter, recurrence_matrix
from . import units
from . import utilx
from .pitch import (
    autocorrelation,
    estimate_tuning,
    periodicity,
    piptrack,
    pitch_detect_acf,
    pitch_tuning,
    yin,
)
from .pyin import pyin
from .signals import chirp, clicks, tone
from .rhythm import fourier_tempogram, tempo, tempo_frequencies, tempogram
from .resample import resample, resample_poly
from .stft import check_nola, istft, magnitude, magphase, phase, stft
from .windows import get_window

__all__ = [
    "stft",
    "istft",
    "magnitude",
    "phase",
    "check_nola",
    "get_window",
    "mel_filterbank",
    "melspectrogram",
    "hz_to_mel",
    "mel_to_hz",
    "linear_filterbank",
    "bark_filterbank",
    "hz_to_bark",
    "bark_to_hz",
    "spectral_centroid",
    "spectral_bandwidth",
    "spectral_rolloff",
    "spectral_flatness",
    "spectral_contrast",
    "zero_crossing_rate",
    "mfcc",
    "delta",
    "dct",
    "frame",
    "rms",
    "preemphasis",
    "deemphasis",
    "resample",
    "resample_poly",
    "griffinlim",
    "autocorrelation",
    "pitch_detect_acf",
    "periodicity",
    "power_to_db",
    "db_to_power",
    "amplitude_to_db",
    "db_to_amplitude",
]
