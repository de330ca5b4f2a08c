"""Ready-made frontend configurations for common speech/audio models.

Counterpart of `mlx_audio_primitives_tpu/models/presets.py`: the
industry-standard log-mel configurations on top of :class:`LogMelFrontend`.
Each returns a callable ``(batch, samples) -> (batch, n_mels, n_frames)``.

On a CUDA tensor ``music_logmel`` (n_fft 2048, hop 512) takes K1, and
Whisper's n_fft 400 at hop 160 K1's mixed-radix entry (in the fast
contraction mode, ``_config.ANALYSIS_FAST_GEMM``); the VGGish/Kaldi shape
(n_fft 512 at hop 160) lies outside both gates and takes the plain
composition (``torch.fft`` takes any length).

:func:`whisper_v3_logmel` is Whisper large-v3's own front end
(:class:`.pipelines.WhisperLogMelFrontend`); it is not in ``PRESETS``,
which holds the JAX package's.
"""

from __future__ import annotations

from .pipelines import LogMelFrontend, WhisperLogMelFrontend


def whisper_logmel() -> LogMelFrontend:
    """Whisper-style frontend: 16 kHz, n_fft=400, hop=160, 80 mels.
    Whisper's own padding, last frame and normalisation: :func:`whisper_v3_logmel`."""
    return LogMelFrontend(
        sr=16000, n_fft=400, hop_length=160, n_mels=80, fmin=0.0, fmax=8000.0
    )


def whisper_v3_logmel(use_pallas: bool | None = None) -> WhisperLogMelFrontend:
    """Whisper large-v3's front end: 30 s windows at 16 kHz, n_fft 400, hop
    160, 128 mels, Whisper's per-clip normalisation -> ``(batch, 128,
    3000)``."""
    return WhisperLogMelFrontend(use_pallas=use_pallas)


def vggish_logmel() -> LogMelFrontend:
    """VGGish/AudioSet-style frontend: 16 kHz, 25 ms (400-sample) window
    zero-padded to n_fft=512, 10 ms hop, 64 HTK-scale mel bands."""
    return LogMelFrontend(
        sr=16000, n_fft=512, hop_length=160, win_length=400, n_mels=64,
        fmin=125.0, fmax=7500.0, htk=True, norm=None,
    )


def speech_kaldi_logmel() -> LogMelFrontend:
    """Kaldi-style fbank: 16 kHz, 25 ms (400-sample) window, 10 ms hop,
    80 HTK-scale mel bands."""
    return LogMelFrontend(
        sr=16000, n_fft=512, hop_length=160, win_length=400, n_mels=80,
        fmin=20.0, fmax=7600.0, htk=True, norm=None,
    )


def music_logmel() -> LogMelFrontend:
    """Music-tagging frontend: 22.05 kHz, n_fft=2048, hop=512, 128 mels."""
    return LogMelFrontend(sr=22050, n_fft=2048, hop_length=512, n_mels=128)


PRESETS = {
    "whisper": whisper_logmel,
    "vggish": vggish_logmel,
    "kaldi": speech_kaldi_logmel,
    "music": music_logmel,
}
