"""Ready-made frontend configurations for common speech/audio models.

Counterpart of `mlx_audio_primitives_tpu/models/presets.py`: the
industry-standard log-mel configurations on top of :class:`LogMelFrontend`.
Each returns a callable ``(batch, samples) -> (batch, n_mels, n_frames)``.

Whisper's n_fft of 400 and the VGGish/Kaldi hop of 160 lie outside the
radix shape gate, so they take the plain composition (``torch.fft`` takes
any length); ``music_logmel`` (n_fft 2048, hop 512) takes K1 on a CUDA
tensor.
"""

from __future__ import annotations

from .pipelines import LogMelFrontend


def whisper_logmel() -> LogMelFrontend:
    """Whisper-style frontend: 16 kHz, n_fft=400, hop=160, 80 mels."""
    return LogMelFrontend(
        sr=16000, n_fft=400, hop_length=160, n_mels=80, fmin=0.0, fmax=8000.0
    )


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
