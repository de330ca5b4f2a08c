"""Unit conversions: frames/samples/time, frequency grids, notes and MIDI.

Counterpart of `mlx_audio_primitives_tpu/ops/units.py`: the port's own copy
of those host NumPy converters (`librosa.core.convert` semantics), with the
same results. They make coordinate grids, axis labels and scalar
conversions, not device work, so they take and return NumPy arrays
(float64/int64 like librosa), never tensors.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

ArrayLike = Any

_NOTE_MAP = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
_NOTE_RE = re.compile(
    r"^(?P<note>[A-Ga-g])"
    r"(?P<accidental>[#♯b!♭𝄪𝄫]*)"
    r"(?P<octave>[+-]?\d+)?"
    r"(?P<cents>[+-]\d+)?$"
)
_ACC_VALUE = {"#": 1, "♯": 1, "b": -1, "!": -1, "♭": -1, "𝄪": 2, "𝄫": -2}
_PITCHES_SHARP = ["C", "C♯", "D", "D♯", "E", "F", "F♯", "G", "G♯", "A",
                  "A♯", "B"]
_PITCHES_FLAT = ["C", "D♭", "D", "E♭", "E", "F", "G♭", "G", "A♭", "A",
                 "B♭", "B"]


# ---------------------------------------------------------------- time axes

def frames_to_samples(frames: ArrayLike, hop_length: int = 512,
                      n_fft: int | None = None) -> np.ndarray:
    """Frame index -> sample index (librosa: offset ``n_fft // 2`` when
    ``n_fft`` is given, for center-framed spectrogram alignment)."""
    offset = 0 if n_fft is None else n_fft // 2
    return (np.asanyarray(frames) * hop_length + offset).astype(np.int64)


def samples_to_frames(samples: ArrayLike, hop_length: int = 512,
                      n_fft: int | None = None) -> np.ndarray:
    offset = 0 if n_fft is None else n_fft // 2
    return np.floor_divide(
        np.asanyarray(samples) - offset, hop_length
    ).astype(np.int64)


def frames_to_time(frames: ArrayLike, sr: int = 22050, hop_length: int = 512,
                   n_fft: int | None = None) -> np.ndarray:
    return frames_to_samples(frames, hop_length, n_fft) / float(sr)


def time_to_frames(times: ArrayLike, sr: int = 22050, hop_length: int = 512,
                   n_fft: int | None = None) -> np.ndarray:
    return samples_to_frames(
        np.floor(np.asanyarray(times) * sr).astype(np.int64), hop_length,
        n_fft,
    )


def samples_to_time(samples: ArrayLike, sr: int = 22050) -> np.ndarray:
    return np.asanyarray(samples) / float(sr)


def time_to_samples(times: ArrayLike, sr: int = 22050) -> np.ndarray:
    return np.floor(np.asanyarray(times) * sr).astype(np.int64)


# ----------------------------------------------------------- frequency axes

def fft_frequencies(sr: int = 22050, n_fft: int = 2048) -> np.ndarray:
    """Center frequency of each rfft bin, ``(1 + n_fft//2,)``."""
    return np.linspace(0, sr / 2.0, 1 + n_fft // 2)


def mel_frequencies(n_mels: int = 128, fmin: float = 0.0,
                    fmax: float = 11025.0, htk: bool = False) -> np.ndarray:
    """Center frequencies of ``n_mels`` mel bands (librosa semantics:
    uniform grid in mel space between ``hz_to_mel(fmin/fmax)``)."""
    from .mel import hz_to_mel, mel_to_hz

    mels = np.linspace(
        float(np.asarray(hz_to_mel(fmin, htk=htk))),
        float(np.asarray(hz_to_mel(fmax, htk=htk))),
        n_mels,
    )
    return np.asarray(mel_to_hz(mels, htk=htk), dtype=np.float64)


def tempo_frequencies(n: int, hop_length: int = 512,
                      sr: int = 22050) -> np.ndarray:
    """Alias of :func:`~.rhythm.tempo_frequencies` for the librosa
    `core.convert` namespace."""
    from .rhythm import tempo_frequencies as _tf

    return _tf(n, hop_length=hop_length, sr=sr)


def fourier_tempo_frequencies(sr: int = 22050, win_length: int = 384,
                              hop_length: int = 512) -> np.ndarray:
    """BPM of each :func:`~.rhythm.fourier_tempogram` bin."""
    return np.linspace(0, sr * 30.0 / hop_length, 1 + win_length // 2)


# ------------------------------------------------------------- notes / MIDI

def midi_to_hz(notes: ArrayLike) -> np.ndarray:
    return 440.0 * (2.0 ** ((np.asanyarray(notes, dtype=np.float64) - 69.0)
                            / 12.0))


def hz_to_midi(frequencies: ArrayLike) -> np.ndarray:
    f = np.asanyarray(frequencies, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return 12.0 * (np.log2(f) - np.log2(440.0)) + 69.0


def note_to_midi(note: str | ArrayLike, round_midi: bool = True):
    """Note name(s) -> MIDI number(s). Accepts ``C``, ``C#4``, ``Bb-1``,
    ``A4+25`` (cents), unicode accidentals, double sharps/flats."""
    if not isinstance(note, str):
        out = np.asarray([note_to_midi(n, round_midi) for n in note])
        return out
    m = _NOTE_RE.match(note)
    if m is None:
        raise ValueError(f"Improper note format: '{note}'")
    pitch = _NOTE_MAP[m.group("note").upper()]
    acc = sum(_ACC_VALUE[ch] for ch in (m.group("accidental") or ""))
    octave = int(m.group("octave")) if m.group("octave") else 0
    cents = int(m.group("cents")) * 1e-2 if m.group("cents") else 0.0
    value = 12 * (octave + 1) + pitch + acc + cents
    return int(round(value)) if round_midi else value


def midi_to_note(midi: ArrayLike, octave: bool = True, cents: bool = False,
                 unicode: bool = True):
    """MIDI number(s) -> note name(s) (sharp spelling, librosa default)."""
    arr = np.asanyarray(midi)
    if arr.ndim:
        return np.asarray(
            [midi_to_note(m, octave=octave, cents=cents, unicode=unicode)
             for m in arr]
        )
    m = float(arr)
    note_num = int(round(m))
    pitches = _PITCHES_SHARP if unicode else [
        p.replace("♯", "#") for p in _PITCHES_SHARP
    ]
    name = pitches[note_num % 12]
    if octave:
        name = f"{name}{note_num // 12 - 1}"
    if cents:
        name = f"{name}{int(round(100 * (m - note_num))):+d}"
    return name


def note_to_hz(note: str | ArrayLike, round_midi: bool = True) -> np.ndarray:
    return midi_to_hz(note_to_midi(note, round_midi=round_midi))


def hz_to_note(frequencies: ArrayLike, **kwargs):
    return midi_to_note(hz_to_midi(frequencies), **kwargs)


__all__ = [
    "frames_to_samples", "samples_to_frames", "frames_to_time",
    "time_to_frames", "samples_to_time", "time_to_samples",
    "fft_frequencies", "mel_frequencies", "tempo_frequencies",
    "fourier_tempo_frequencies",
    "midi_to_hz", "hz_to_midi", "note_to_midi", "midi_to_note",
    "note_to_hz", "hz_to_note",
    "A_weighting", "B_weighting", "C_weighting", "D_weighting",
    "frequency_weighting",
]


# ------------------------------------------------------- weighting curves

def A_weighting(frequencies: ArrayLike, min_db: float | None = -80.0) -> np.ndarray:
    """A-weighting in dB (IEC 61672:2003), librosa-compatible."""
    f2 = np.asanyarray(frequencies, dtype=np.float64) ** 2
    const = np.array([12194.217, 20.598997, 107.65265, 737.86223]) ** 2
    with np.errstate(divide="ignore"):
        weights = 2.0 + 20.0 * (
            np.log10(const[0])
            + 2 * np.log10(f2)
            - np.log10(f2 + const[0])
            - np.log10(f2 + const[1])
            - 0.5 * np.log10(f2 + const[2])
            - 0.5 * np.log10(f2 + const[3])
        )
    return weights if min_db is None else np.maximum(min_db, weights)


def B_weighting(frequencies: ArrayLike, min_db: float | None = -80.0) -> np.ndarray:
    """B-weighting in dB, librosa-compatible."""
    f2 = np.asanyarray(frequencies, dtype=np.float64) ** 2
    const = np.array([12194.217, 20.598997, 158.48932]) ** 2
    with np.errstate(divide="ignore"):
        weights = 0.17 + 20.0 * (
            np.log10(const[0])
            + 1.5 * np.log10(f2)
            - np.log10(f2 + const[0])
            - np.log10(f2 + const[1])
            - 0.5 * np.log10(f2 + const[2])
        )
    return weights if min_db is None else np.maximum(min_db, weights)


def C_weighting(frequencies: ArrayLike, min_db: float | None = -80.0) -> np.ndarray:
    """C-weighting in dB, librosa-compatible."""
    f2 = np.asanyarray(frequencies, dtype=np.float64) ** 2
    const = np.array([12194.217, 20.598997]) ** 2
    with np.errstate(divide="ignore"):
        weights = 0.062 + 20.0 * (
            np.log10(const[0])
            + np.log10(f2)
            - np.log10(f2 + const[0])
            - np.log10(f2 + const[1])
        )
    return weights if min_db is None else np.maximum(min_db, weights)


def D_weighting(frequencies: ArrayLike, min_db: float | None = -80.0) -> np.ndarray:
    """D-weighting in dB (IEC 537 aircraft-noise curve), librosa-compatible."""
    f2 = np.asanyarray(frequencies, dtype=np.float64) ** 2
    freq_sq = f2
    h_freq = (1037918.48 - freq_sq) ** 2 + 1080768.16 * freq_sq
    l_freq = (9837328.0 - freq_sq) ** 2 + 11723776.0 * freq_sq
    with np.errstate(divide="ignore"):
        weights = 20.0 * (
            0.5 * (np.log10(h_freq) - np.log10(l_freq))
            - np.log10(6.8966888496476e-5)
            + 0.5 * (np.log10(freq_sq) - np.log10(freq_sq + 79919.29)
                     - np.log10(freq_sq + 1345600.0))
        )
    return weights if min_db is None else np.maximum(min_db, weights)


_WEIGHTINGS = {"A": A_weighting, "B": B_weighting, "C": C_weighting,
               "D": D_weighting, "Z": lambda f, min_db=None: np.zeros_like(
                   np.asanyarray(f, dtype=np.float64))}


def frequency_weighting(frequencies: ArrayLike, kind: str = "A",
                        **kwargs) -> np.ndarray:
    """Dispatch to one of the A/B/C/D/Z weighting curves."""
    try:
        return _WEIGHTINGS[kind](frequencies, **kwargs)
    except KeyError:
        raise ValueError(
            f"Unknown weighting kind: '{kind}'. Supported: "
            f"{sorted(_WEIGHTINGS)}"
        ) from None
