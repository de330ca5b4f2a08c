"""Spectral features: centroid, bandwidth, rolloff, flatness, contrast, ZCR,
polynomial fits, memory stacking and segment sync.

Counterpart of `mlx_audio_primitives_tpu/ops/features.py`, with the same
signatures, defaults, errors and ``(..., n, F)`` output conventions. Every
op runs on the device of its input tensor; a non-tensor input goes to the
default device (`utils/dispatch.py::to_tensor`). On a CUDA tensor the
kernels of this path are:

* the spectrogram of the S-or-y protocol: ``magnitude_spectrogram``, the
  STFT kernel's magnitude emit (K2m, `kernels/stft_radix.py`);
* the contrast bands' quantile means: the extreme-selection kernel (K5,
  `kernels/select_extremes.py`), reading each band of the natural
  ``(B, n_bins, F)`` magnitude in place;
* the centroid of a signal ``y``: its two moments ``(sum S, sum f*S)``
  out of the fused filterbank kernel (K1, `kernels/mel_fused.py`) with the
  weight ``[1, f]`` and power 1, as the JAX package takes them
  (``_moments_fused``), so the magnitude never reaches device memory. K1's
  contraction walks ``ceil(n_cols / 16)`` column tiles, so the two columns
  cost one tile (``chip_smoke.py`` phase 5 times this route against the
  magnitude and two reductions);
* the bandwidth, rolloff and flatness of a signal ``y``: the STFT kernel's
  per-frame statistics emit (K2s, ``stft_stats_fused``), which reduces each
  frame's magnitudes on chip and writes one value a frame
  (``_frame_stat``). An ``S`` input, a ``centroid`` given to the bandwidth,
  a ``freq`` other than one value per bin, a ``p`` or ``power`` other than
  1 and 2 and a shape outside the radix gate take the magnitude route,
  counted as ``dispatch.plain.<op>.spectrum``, ``.centroid``, ``.freq``,
  ``.power`` and ``.gate``;
* the zero-crossing rate of a non-empty signal: the frame statistics
  kernel (K7, `kernels/frame_stats.py`), which reads the audio once and
  writes one value a frame (``ops/framing.py::frame_stat``, shared with
  ``rms``); a frame longer than K7 takes, or a signal of more than two
  dimensions, goes to the plain composition, counted as
  ``dispatch.plain.zero_crossing_rate.gate``.

Elsewhere each takes its plain composition. The JAX package computes the
dB and geometric-mean logs with its own polynomials
(`kernels/precise_math.py`) because the TPU's ``log10`` is imprecise; the
port uses ``torch.log10`` and ``torch.pow``. ``use_cpp``/``use_mlx`` are
accepted for signature compatibility and ignored.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..kernels.mel_fused import melspectrogram_fused
from ..kernels.select_extremes import quantile_extreme_means_fused, select_supported
from ..kernels.stft_radix import stats_power_ok, stft_stats_fused
from ..utils import dispatch
from ..utils.cache import table_cache
from ..utils.profiler import traced
from ..utils.validation import validate_positive, validate_range
from .framing import frame_stat
from .stft import _as_batched, _get_padded_window, _validate_stft_params, magnitude_spectrogram

ArrayLike = Any


@table_cache("fft_frequencies", maxsize=16)
def _get_frequencies(sr: int, n_fft: int) -> np.ndarray:
    """Centre frequencies of the rfft bins, ``linspace(0, sr/2, n_bins)``,
    float64 on the host (cached per device as float32)."""
    return np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)


def _freq(freq, sr: int, n_fft: int, device: torch.device) -> torch.Tensor:
    """``freq`` as a float32 tensor on ``device``; the rfft bin grid when
    None."""
    if freq is None:
        return _get_frequencies(sr, n_fft, device=device)
    return torch.as_tensor(freq, dtype=REAL_DTYPE, device=device)


def _compute_spectrogram(
    y, S, n_fft, hop_length, win_length, window, center, pad_mode, power=1.0,
    fast_gemm=None,
) -> torch.Tensor:
    """S-or-y input protocol (librosa style). A provided ``S`` is taken
    as-is: no ``power`` is applied and ``n_fft`` is not inferred from its
    bin count, as in the JAX package."""
    if S is not None:
        return dispatch.to_tensor(S, REAL_DTYPE)
    if y is None:
        raise ValueError("Either y (audio) or S (spectrogram) must be provided")
    S = magnitude_spectrogram(
        y, n_fft=n_fft, hop_length=hop_length, win_length=win_length, window=window,
        center=center, pad_mode=pad_mode, fast_gemm=fast_gemm,
    )
    if power != 1.0:
        S = torch.pow(S, power)
    return S


@traced("ops.spectral_centroid")
def spectral_centroid(
    y: ArrayLike | None = None,
    sr: int = 22050,
    S: ArrayLike | None = None,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    freq: ArrayLike | None = None,
) -> torch.Tensor:
    """Spectral centroid ``sum(f*S)/sum(S)`` per frame, shape ``(..., 1, F)``.

    From a signal on a CUDA device (radix shapes) both moments come out of
    the fused filterbank kernel (K1) with the weight ``[1, f]``; otherwise,
    and for an ``S`` input, from the magnitude and two reductions."""
    if S is None and y is not None:
        moments = _moments_fused(y, sr, freq, n_fft=n_fft, hop_length=hop_length,
                                 win_length=win_length, window=window, center=center,
                                 pad_mode=pad_mode)
        if moments is not None:
            M0, M1 = moments
            return M1 / (M0 + 1e-10)
    S = _compute_spectrogram(y, S, n_fft, hop_length, win_length, window, center, pad_mode)
    freq = _freq(freq, sr, n_fft, S.device)
    is_batched = S.dim() == 3
    if not is_batched:
        S = S[None]
    weighted = torch.sum(freq[:, None] * S, dim=1, keepdim=True)
    total = torch.sum(S, dim=1, keepdim=True) + 1e-10
    out = weighted / total
    return out if is_batched else out[0]


@table_cache("centroid_moments_weight", maxsize=16)
def _moments_weight(sr: int, n_fft: int) -> np.ndarray:
    """``(n_bins, 2)`` weight ``[1, f]`` on the rfft bin grid, float64 on
    the host (cached per device as float32)."""
    freq = _get_frequencies.host(sr, n_fft)
    return np.stack([np.ones_like(freq), freq], axis=1)


def _moments_fused(y, sr, freq, *, n_fft, hop_length, win_length, window, center, pad_mode):
    """``(M0, M1) = (sum S, sum f*S)`` per frame, each ``(..., 1, F)``, from
    the fused filterbank kernel with the weight ``[1, f]`` at power 1; None
    where the kernel does not take the call (kernels off or not on CUDA, a
    shape outside the radix gate, a ``freq`` other than one value per bin),
    and the caller takes the magnitude route."""
    if win_length is None:
        win_length = n_fft
    # the same argument checks as the magnitude route, so both raise alike
    _validate_stft_params(n_fft, hop_length, win_length, pad_mode)
    y, input_is_1d = _as_batched(y, n_fft, center)
    if not dispatch.route("spectral_moments", None, y.device,
                          gate=dispatch.radix_shape_ok(n_fft, hop_length)):
        return None
    if freq is None:
        w = _moments_weight(sr, n_fft, device=y.device)
    else:
        freq = torch.as_tensor(freq, dtype=REAL_DTYPE, device=y.device)
        if freq.dim() != 1 or freq.shape[0] != n_fft // 2 + 1:
            return None
        w = torch.stack([torch.ones_like(freq), freq], dim=1).contiguous()
    win = _get_padded_window(window, win_length, n_fft, y.device)
    M = melspectrogram_fused(y, win, w, n_fft=n_fft, hop_length=hop_length, center=center,
                             pad_mode=pad_mode, power=1.0)  # (B, 2, F)
    M0, M1 = M[:, 0:1], M[:, 1:2]
    return (M0[0], M1[0]) if input_is_1d else (M0, M1)


def _frame_stat(op, stat, y, S, sr, freq, *, n_fft, hop_length, win_length, window, center,
                pad_mode, centroid=None, **params):
    """``op``'s statistic per frame, ``(..., 1, F)``, from the STFT kernel's
    statistics emit (K2s) for a signal ``y``; None where the kernel does not
    take the call (an ``S`` input, a ``centroid`` given, a ``freq`` other
    than one value per bin, a ``p`` or ``power`` other than 1 and 2, a shape
    outside the radix gate, kernels off or not on CUDA), and the caller
    takes the magnitude route."""
    if S is not None:
        # librosa's protocol: a given S wins over y
        device = S.device if isinstance(S, torch.Tensor) else dispatch.default_device()
        dispatch.route(op, None, device, spectrum=False)
        return None
    if y is None:
        return None
    if hop_length is None:
        hop_length = n_fft // 4
    if win_length is None:
        win_length = n_fft
    # the same argument checks as the magnitude route, so both raise alike
    _validate_stft_params(n_fft, hop_length, win_length, pad_mode)
    y, input_is_1d = _as_batched(y, n_fft, center)
    f = None if stat == "flatness" else _freq(freq, sr, n_fft, y.device)
    per_bin = f is None or (f.dim() == 1 and f.shape[0] == n_fft // 2 + 1)
    if not dispatch.route(op, None, y.device, centroid=centroid is None, freq=per_bin,
                          power=stats_power_ok(**params),
                          gate=dispatch.radix_shape_ok(n_fft, hop_length)):
        return None
    win = _get_padded_window(window, win_length, n_fft, y.device)
    out = stft_stats_fused(y, win, None if f is None else f.contiguous(), stat=stat, n_fft=n_fft,
                           hop_length=hop_length, center=center, pad_mode=pad_mode, **params)
    return out[0] if input_is_1d else out


@traced("ops.spectral_bandwidth")
def spectral_bandwidth(
    y: ArrayLike | None = None,
    sr: int = 22050,
    S: ArrayLike | None = None,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    freq: ArrayLike | None = None,
    centroid: ArrayLike | None = None,
    p: float = 2.0,
    norm: bool = True,
) -> torch.Tensor:
    """Spectral bandwidth ``(sum(S*|f-c|^p)/sum(S))^(1/p)`` per frame.

    From a signal on a CUDA device (radix shapes, no ``centroid`` given)
    through the STFT kernel's statistics emit (K2s); otherwise from the
    magnitude and its reductions."""
    out = _frame_stat("spectral_bandwidth", "bandwidth", y, S, sr, freq, n_fft=n_fft,
                      hop_length=hop_length, win_length=win_length, window=window,
                      center=center, pad_mode=pad_mode, centroid=centroid, p=p, norm=norm)
    if out is not None:
        return out
    S = _compute_spectrogram(y, S, n_fft, hop_length, win_length, window, center, pad_mode)
    freq = _freq(freq, sr, n_fft, S.device)
    is_batched = S.dim() == 3
    if not is_batched:
        S = S[None]
    if centroid is None:
        centroid = spectral_centroid(S=S, sr=sr, n_fft=n_fft, freq=freq)
    else:
        centroid = torch.as_tensor(centroid, dtype=REAL_DTYPE, device=S.device)
    if centroid.dim() == 2:
        centroid = centroid[None]
    deviation = torch.abs(freq[None, :, None] - centroid)
    weighted = torch.sum(S * torch.pow(deviation, p), dim=1, keepdim=True)
    if norm:
        weighted = weighted / (torch.sum(S, dim=1, keepdim=True) + 1e-10)
    out = torch.pow(weighted, 1.0 / p)
    return out if is_batched else out[0]


@traced("ops.spectral_rolloff")
def spectral_rolloff(
    y: ArrayLike | None = None,
    sr: int = 22050,
    S: ArrayLike | None = None,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    freq: ArrayLike | None = None,
    roll_percent: float = 0.85,
    use_cpp: bool = True,
) -> torch.Tensor:
    """Rolloff frequency: the first bin whose cumulative energy reaches
    ``roll_percent`` of the frame's total, shape ``(..., 1, F)``: through
    the STFT kernel's statistics emit (K2s) for a signal on a CUDA device,
    as the bandwidth."""
    del use_cpp
    validate_range(roll_percent, "roll_percent", low=0.0, high=1.0)
    out = _frame_stat("spectral_rolloff", "rolloff", y, S, sr, freq, n_fft=n_fft,
                      hop_length=hop_length, win_length=win_length, window=window,
                      center=center, pad_mode=pad_mode, roll_percent=roll_percent)
    if out is not None:
        return out
    S = _compute_spectrogram(y, S, n_fft, hop_length, win_length, window, center, pad_mode)
    freq = _freq(freq, sr, n_fft, S.device)
    is_batched = S.dim() == 3
    if not is_batched:
        S = S[None]
    cumsum = torch.cumsum(S, dim=1)
    threshold = roll_percent * cumsum[:, -1:, :]
    # argmax returns the first maximum: the first bin at or above threshold
    idx = torch.argmax((cumsum >= threshold).to(torch.uint8), dim=1)  # (B, F)
    idx = torch.clamp(idx, max=S.shape[1] - 1)
    out = freq[idx][:, None, :]
    return out if is_batched else out[0]


@traced("ops.spectral_flatness")
def spectral_flatness(
    y: ArrayLike | None = None,
    S: ArrayLike | None = None,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    power: float = 2.0,
    amin: float = 1e-10,
) -> torch.Tensor:
    """Spectral flatness (Wiener entropy): geometric over arithmetic mean of
    ``max(S, amin)``, shape ``(..., 1, F)``: through the STFT kernel's
    statistics emit (K2s) for a signal on a CUDA device, as the bandwidth."""
    out = _frame_stat("spectral_flatness", "flatness", y, S, None, None, n_fft=n_fft,
                      hop_length=hop_length, win_length=win_length, window=window,
                      center=center, pad_mode=pad_mode, power=power, amin=amin)
    if out is not None:
        return out
    S = _compute_spectrogram(
        y, S, n_fft, hop_length, win_length, window, center, pad_mode, power,
        fast_gemm=False,
    )
    is_batched = S.dim() == 3
    if not is_batched:
        S = S[None]
    S = torch.clamp(S, min=amin)
    gmean = torch.pow(10.0, torch.mean(torch.log10(S), dim=1, keepdim=True))
    amean = torch.mean(S, dim=1, keepdim=True)
    out = gmean / (amean + 1e-10)
    return out if is_batched else out[0]


def contrast_bands(
    freq: np.ndarray, fmin: float, n_bands: int, quantile: float
) -> list[tuple[int, int, int] | None]:
    """``spectral_contrast``'s band table on the host, in float64: for each
    of the ``n_bands + 1`` octave bands, the contiguous bins ``start:stop``
    and the quantile count ``k``, or None for a band with no bin. librosa's
    rules: edges ``[0, fmin, 2*fmin, ...]``, the neighbour bin below each
    lower edge, the Nyquist extension of the last band, ``k`` counted
    before the shared upper bin is dropped."""
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * (2.0 ** np.arange(0, n_bands + 1))
    bands = []
    for k, (f_low, f_high) in enumerate(zip(octa[:-1], octa[1:])):
        band = np.logical_and(freq >= f_low, freq <= f_high)
        idx = np.flatnonzero(band)
        if len(idx) == 0:
            bands.append(None)
            continue
        if k > 0 and idx[0] > 0:
            band[idx[0] - 1] = True
        if k == n_bands and idx[-1] + 1 < len(band):
            band[idx[-1] + 1 :] = True
        n_quantile = int(np.maximum(np.rint(quantile * np.sum(band)), 1))
        sel = np.flatnonzero(band)
        start, stop = int(sel[0]), int(sel[-1]) + 1
        if k < n_bands and stop - start > 1:
            stop -= 1
        bands.append((start, stop, n_quantile))
    return bands


@traced("ops.spectral_contrast")
def spectral_contrast(
    y: ArrayLike | None = None,
    sr: int = 22050,
    S: ArrayLike | None = None,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    freq: ArrayLike | None = None,
    fmin: float = 200.0,
    n_bands: int = 6,
    quantile: float = 0.02,
    linear: bool = False,
) -> torch.Tensor:
    """Octave-band spectral contrast (peak minus valley quantile means),
    shape ``(..., n_bands + 1, F)``.

    librosa's algorithm: octave band edges ``[0, fmin, 2*fmin, ...]`` on the
    host in float64, the neighbour-bin extension at each lower edge, the
    Nyquist extension of the last band, ``n_quantile`` counted before the
    shared upper bin is dropped (:func:`contrast_bands`). Per band: plain
    min/max where ``n_quantile == 1``; the extraction kernel (K5) on a CUDA tensor where
    its gate admits; a sort otherwise."""
    validate_positive(n_bands, "n_bands")
    validate_range(quantile, "quantile", low=0.0, high=1.0)
    S = _compute_spectrogram(y, S, n_fft, hop_length, win_length, window, center, pad_mode)
    is_batched = S.dim() == 3
    if not is_batched:
        S = S[None]

    if freq is None:
        freq_np = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    elif isinstance(freq, torch.Tensor):
        freq_np = freq.detach().cpu().numpy().astype(np.float64)
    else:
        freq_np = np.asarray(freq, dtype=np.float64)

    B, n_bins, F = S.shape
    zeros = S.new_zeros((B, 1, F))
    valleys, peaks = [], []
    for band in contrast_bands(freq_np, fmin, n_bands, quantile):
        if band is None:
            valleys.append(zeros)
            peaks.append(zeros)
            continue
        start, stop, n_quantile = band
        sub = S[:, start:stop, :]  # (B, W, F)
        W = stop - start
        if n_quantile == 1:
            valley_bf = torch.amin(sub, dim=1)
            peak_bf = torch.amax(sub, dim=1)
        elif dispatch.route("spectral_contrast", None, S.device,
                            gate=select_supported(W, n_quantile, n_quantile)):
            # rows = frames of the natural layout, read in place
            valley_bf, peak_bf = quantile_extreme_means_fused(
                sub.transpose(1, 2), n_quantile, n_quantile
            )
        else:
            sorted_sub = torch.sort(sub, dim=1).values
            valley_bf = torch.mean(sorted_sub[:, :n_quantile, :], dim=1)
            peak_bf = torch.mean(sorted_sub[:, max(W - n_quantile, 0) :, :], dim=1)
        valleys.append(valley_bf[:, None, :])
        peaks.append(peak_bf[:, None, :])

    valley = torch.cat(valleys, dim=1)
    peak = torch.cat(peaks, dim=1)
    if linear:
        out = peak - valley
    else:
        out = 10.0 * torch.log10(torch.clamp(peak, min=1e-10)) - 10.0 * torch.log10(
            torch.clamp(valley, min=1e-10)
        )
    return out if is_batched else out[0]


@traced("ops.zero_crossing_rate")
def zero_crossing_rate(
    y: ArrayLike,
    frame_length: int = 2048,
    hop_length: int = 512,
    center: bool = True,
    pad_mode: str = "edge",
    use_mlx: bool = True,
) -> torch.Tensor:
    """Zero-crossing rate per frame, shape ``(..., 1, F)``: signbit changes
    (librosa's definition), the first position of a frame counting no
    crossing, edge padding by default."""
    del use_mlx
    return frame_stat("zero_crossing_rate", y, frame_length, hop_length, center, pad_mode)


@table_cache("poly_basis", maxsize=8)
def _poly_pinv_table(sr: int, n_fft: int, order: int) -> np.ndarray:
    """Pseudo-inverse of the Vandermonde matrix over the rfft frequency
    grid, host float64 (the least-squares operator ``np.polyfit`` applies),
    rows highest degree first; ``(order+1, n_bins)``."""
    freq = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    return np.linalg.pinv(np.vander(freq, order + 1))


def poly_features(
    y: ArrayLike | None = None,
    sr: int = 22050,
    S: ArrayLike | None = None,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    order: int = 1,
    freq: ArrayLike | None = None,
) -> torch.Tensor:
    """Per-frame least-squares polynomial fit to the spectrum,
    ``(..., order+1, F)``, highest degree first (``np.polyfit``
    convention): one cached pseudo-inverse table times the spectrogram.
    ``freq`` overrides the fit grid (1-D, one value per bin); its
    pseudo-inverse is computed on the host per call."""
    validate_positive(n_fft, "n_fft")
    if order < 0:
        raise ValueError(f"order must be non-negative, got {order}")
    S = _compute_spectrogram(y, S, n_fft, hop_length, win_length, window, center, pad_mode)
    if freq is None:
        P = _poly_pinv_table(int(sr), int(n_fft), int(order), device=S.device)
    else:
        f = (freq.detach().cpu().numpy() if isinstance(freq, torch.Tensor)
             else np.asarray(freq)).astype(np.float64)
        if f.ndim != 1 or f.shape[0] != S.shape[-2]:
            raise ValueError(
                f"freq must be 1-D with one value per bin "
                f"({S.shape[-2]}), got shape {f.shape}"
            )
        P = torch.as_tensor(np.linalg.pinv(np.vander(f, order + 1)).astype(np.float32),
                            device=S.device)
    return torch.matmul(P, S)


def stack_memory(data: ArrayLike, n_steps: int = 2, delay: int = 1) -> torch.Tensor:
    """Short-term history embedding, ``(..., d*n_steps, F)``: block ``k``
    holds the features delayed by ``k * delay`` frames, zero-filled where
    the shift runs off the edge; a negative ``delay`` embeds the future."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be at least 1, got {n_steps}")
    if delay == 0:
        raise ValueError("delay must be non-zero")
    x = dispatch.to_tensor(data, REAL_DTYPE)
    if x.dim() < 2:
        x = x[None]
    F = x.shape[-1]
    blocks = []
    for k in range(n_steps):
        shift = k * delay
        if shift == 0:
            blocks.append(x)
        elif shift > 0:
            blocks.append(torch.nn.functional.pad(x, (shift, 0))[..., :F])
        else:
            blocks.append(torch.nn.functional.pad(x, (0, -shift))[..., -F:])
    return torch.cat(blocks, dim=-2)


def sync(
    data: ArrayLike,
    idx: ArrayLike,
    aggregate: str = "mean",
    pad: bool = True,
    axis: int = -1,
) -> torch.Tensor:
    """Aggregate a feature matrix between boundary frames (librosa
    ``util.sync``): ``sync(C, beat_frames)`` gives one column per interval.

    ``idx`` holds ordered boundaries; ``pad=True`` adds 0 and the axis
    length. ``aggregate``: 'mean', 'median', 'max' or 'min'. Segments are
    ragged, so this runs in NumPy on the host by design and returns a tensor
    on the input's device. As in the JAX package, an empty segment (a
    repeated boundary) gives a zero column where librosa gives NaN or
    raises."""
    if isinstance(data, torch.Tensor):
        device = data.device
        x = data.detach().to(REAL_DTYPE).cpu().numpy()
    else:
        device = None
        x = np.asarray(data, dtype=np.float32)
    # a contiguous copy before the move, as the JAX package's device array
    # is: NumPy's reduction order, and so its rounding, follows the strides
    x = np.moveaxis(np.ascontiguousarray(x), axis, -1)
    n = x.shape[-1]
    bounds = np.asarray(idx, dtype=np.int64).ravel()
    if np.any(np.diff(bounds) < 0):
        raise ValueError("idx must be non-decreasing")
    if bounds.size and (bounds[0] < 0 or bounds[-1] > n):
        raise ValueError(f"idx out of range for axis length {n}")
    if pad:
        bounds = np.concatenate([[0], bounds, [n]])
    bounds = np.sort(bounds)
    agg = {"mean": np.mean, "median": np.median, "max": np.max, "min": np.min}.get(aggregate)
    if agg is None:
        raise ValueError(
            f"Unknown aggregate: '{aggregate}'. Supported: 'mean', "
            "'median', 'max', 'min'"
        )
    cols = [agg(x[..., a:b], axis=-1) if b > a else np.zeros(x.shape[:-1], x.dtype)
            for a, b in zip(bounds[:-1], bounds[1:])]
    out = np.stack(cols, axis=-1) if cols else np.zeros(x.shape[:-1] + (0,), x.dtype)
    out = np.ascontiguousarray(np.moveaxis(out, -1, axis))
    if device is None:
        return dispatch.to_tensor(out)
    return torch.from_numpy(out).to(device)


__all__ = [
    "spectral_centroid",
    "spectral_bandwidth",
    "spectral_rolloff",
    "spectral_flatness",
    "spectral_contrast",
    "zero_crossing_rate",
    "poly_features",
    "stack_memory",
    "sync",
]
