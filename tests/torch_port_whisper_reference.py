"""A plain reference of Whisper's log-mel front end, for the port's tests.

Written from openai/whisper, ``whisper/audio.py`` (``pad_or_trim`` and
``log_mel_spectrogram``), in plain torch and NumPy; it imports neither JAX
nor anything of the port. The steps, per clip:

1. pad with zeros at the end, or trim, to ``N_SAMPLES`` = 480,000 (30 s at
   ``SAMPLE_RATE`` 16,000);
2. ``torch.stft(audio, N_FFT=400, HOP_LENGTH=160, window=hann_window(400),
   return_complex=True)``: a periodic Hann window, ``center=True`` with a
   reflect pad;
3. ``magnitudes = stft[..., :-1].abs() ** 2``: the last frame dropped, 3,000
   left;
4. ``mel = filters @ magnitudes`` with ``filters =
   librosa.filters.mel(sr=16000, n_fft=400, n_mels=128)``: Slaney's mel
   scale and area norm, 0 to 8 kHz, built here in NumPy;
5. ``log_spec = log10(clamp(mel, 1e-10))``, floored at its maximum less
   8.0, then ``(log_spec + 4.0) / 4.0``. The maximum is each clip's own, as
   Hugging Face's ``WhisperFeatureExtractor`` takes it in a batch.

Its one departure: float64 throughout, where Whisper computes in float32.
TF32 is off for matrix products and cuDNN (it would be for a CUDA input).
"""

from __future__ import annotations

import numpy as np
import torch

SAMPLE_RATE, N_FFT, HOP_LENGTH, N_SAMPLES = 16000, 400, 160, 480_000


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney's scale: 200/3 Hz a mel to 1 kHz (15 mels), then log-spaced
    with a step of ln(6.4) / 27."""
    f = np.asarray(f, dtype=np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / logstep,
                    f / (200.0 / 3))


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)), m * (200.0 / 3))


def mel_filters(n_mels: int = 128) -> np.ndarray:
    """``librosa.filters.mel(sr=16000, n_fft=400, n_mels=n_mels)``:
    ``(n_mels, 201)`` triangles between neighbouring mel points, each
    scaled by 2 / its width in Hz."""
    fft_f = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    lower, upper = -ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]


def pad_or_trim(audio: torch.Tensor) -> torch.Tensor:
    n = audio.shape[-1]
    if n > N_SAMPLES:
        return audio[..., :N_SAMPLES]
    return torch.nn.functional.pad(audio, (0, N_SAMPLES - n))


def log_mel_spectrogram(audio, n_mels: int = 128) -> torch.Tensor:
    """``(samples,)`` or ``(batch, samples)`` -> ``(n_mels, 3000)`` or
    ``(batch, n_mels, 3000)`` in float64, on the input's device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    audio = pad_or_trim(torch.as_tensor(audio).to(torch.float64))
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=audio.device)
    stft = torch.stft(audio, N_FFT, HOP_LENGTH, window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    magnitudes = stft[..., :-1].abs() ** 2
    filters = torch.from_numpy(mel_filters(n_mels)).to(audio.device)
    mel = filters @ magnitudes
    log_spec = torch.clamp(mel, min=1e-10).log10()
    top = log_spec.amax(dim=(-2, -1), keepdim=True)
    return (torch.maximum(log_spec, top - 8.0) + 4.0) / 4.0
