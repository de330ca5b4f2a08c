"""Mel scale, mel filterbank, and mel spectrogram.

Counterpart of `mlx_audio_primitives_tpu/ops/mel.py`, with the same
signatures and results:

* ``hz_to_mel``/``mel_to_hz`` are host NumPy float64 utilities that feed
  table construction;
* the filterbank is librosa's fdiff/ramps algorithm in float64 on the host,
  cached per device as float32 (bit-equal to the JAX package's table);
* ``melspectrogram`` goes through :func:`filterbank_spectrogram`, which
  runs the fused mel kernel (K1, `kernels/mel_fused.py`) where its gate
  admits and ``power`` is 1 or 2, and the plain composition otherwise.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import FILTERBANK_CACHE_SIZE, REAL_DTYPE
from ..kernels.dft import forward_basis
from ..kernels.mel_fused import melspectrogram_fused, melspectrogram_plain
from ..utils import dispatch
from ..utils.cache import table_cache
from ..utils.validation import validate_non_negative, validate_positive
from .stft import _as_batched, _get_padded_window, _resolve_fft_mode, _validate_stft_params

ArrayLike = Any

# Slaney mel-scale constants (librosa default).
_F_MIN = 0.0
_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = (_MIN_LOG_HZ - _F_MIN) / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies: ArrayLike, htk: bool = False) -> np.ndarray:
    """Convert Hz to mel (host float64 NumPy)."""
    f = np.asarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(
            f < _MIN_LOG_HZ,
            (f - _F_MIN) / _F_SP,
            _MIN_LOG_MEL + np.log(f / _MIN_LOG_HZ) / _LOGSTEP,
        )


def mel_to_hz(mels: ArrayLike, htk: bool = False) -> np.ndarray:
    """Convert mel to Hz (host float64 NumPy)."""
    m = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    return np.where(
        m < _MIN_LOG_MEL,
        _F_MIN + _F_SP * m,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
    )


@table_cache("mel_filterbank", maxsize=FILTERBANK_CACHE_SIZE)
def _mel_filterbank_table(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float,
    fmax: float,
    htk: bool,
    norm: str | None,
) -> np.ndarray:
    """librosa's exact fdiff/ramps triangular-filter algorithm in float64:
    the native C++ builder first, the NumPy builder without it."""
    if norm in (None, "slaney"):
        from .._native import native_mel_filterbank

        fb = native_mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm)
        if fb is not None:
            return fb
    fftfreqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mels = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    mel_f = mel_to_hz(mels, htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    # "+ 0.0" turns the -0.0 of a zero lower ramp into +0.0, the bits the
    # JAX package's native builder gives
    weights = np.maximum(0.0, np.minimum(lower, upper)) + 0.0
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"Unknown norm: '{norm}'. Supported: 'slaney', None")
    return weights


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Mel filterbank matrix ``(n_mels, n_fft//2 + 1)`` on ``device`` (the
    default device when None, as for a non-tensor input), cached per device."""
    validate_positive(n_mels, "n_mels")
    validate_non_negative(fmin, "fmin")
    if fmax is None:
        fmax = sr / 2.0
    if fmin >= fmax:
        raise ValueError(f"fmin ({fmin}) must be less than fmax ({fmax})")
    if fmax > sr / 2.0:
        raise ValueError(
            f"fmax ({fmax}) cannot exceed Nyquist frequency ({sr / 2.0})"
        )
    return _mel_filterbank_table(sr, n_fft, n_mels, float(fmin), float(fmax), htk, norm,
                                 device=dispatch.default_device(device))


def melspectrogram(
    y: ArrayLike,
    sr: int = 22050,
    n_fft: int = 2048,
    hop_length: int | None = None,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    power: float = 2.0,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    fft_mode: str = "auto",
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """Mel spectrogram ``(n_mels, n_frames)`` / ``(batch, n_mels, n_frames)``
    on the input's device (librosa-compatible signature). ``use_pallas``
    picks between the fused mel kernel and the plain composition (see
    :mod:`..utils.dispatch`)."""
    if hop_length is None:
        hop_length = n_fft // 4
    if win_length is None:
        win_length = n_fft
    _validate_stft_params(n_fft, hop_length, win_length, pad_mode)
    y, input_is_1d = _as_batched(y, n_fft, center)

    fb = mel_filterbank(
        sr=sr, n_fft=n_fft, n_mels=n_mels, fmin=fmin, fmax=fmax, htk=htk, norm=norm,
        device=y.device,
    )
    win = _get_padded_window(window, win_length, n_fft, y.device)
    out = filterbank_spectrogram(
        y, win, fb, n_fft=n_fft, hop_length=hop_length, center=center,
        pad_mode=pad_mode, power=power, fft_mode=fft_mode, use_pallas=use_pallas,
    )
    return out[0] if input_is_1d else out


def filterbank_spectrogram(
    y: ArrayLike,
    win: ArrayLike,
    fb: ArrayLike,
    *,
    n_fft: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
    power: float,
    fft_mode: str = "auto",
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """``fb @ |STFT(y)|^power`` for any ``(n_bands, n_bins)`` filterbank:
    ``(B, L) -> (B, n_bands, F)``, the dispatch :func:`melspectrogram`
    shares with future filterbank features. ``win`` and ``fb`` move to the
    device of ``y``."""
    if fft_mode != "auto":
        # validate eagerly: an explicit fft_mode must never be swallowed by
        # the kernel dispatch below
        _resolve_fft_mode(fft_mode, n_fft)
    y = dispatch.to_tensor(y, REAL_DTYPE).contiguous()
    win = torch.as_tensor(win, dtype=REAL_DTYPE, device=y.device).contiguous()
    fb_t = torch.as_tensor(fb, dtype=REAL_DTYPE, device=y.device).t().contiguous()
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode,
              power=float(power))

    if (
        dispatch.kernel_route(use_pallas, y.device)
        and (fft_mode == "auto" or use_pallas is True)
        and power in (1.0, 2.0)
        and dispatch.radix_shape_ok(n_fft, hop_length)
    ):
        return melspectrogram_fused(y, win, fb_t, **kw)
    matmul = _resolve_fft_mode(fft_mode, n_fft) == "matmul"
    basis = forward_basis(n_fft, device=y.device) if matmul else None
    return melspectrogram_plain(y, win, fb_t, basis=basis, **kw)
