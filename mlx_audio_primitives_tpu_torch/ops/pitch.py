"""Autocorrelation, ACF pitch detection, periodicity, YIN and piptrack.

Counterpart of `mlx_audio_primitives_tpu/ops/pitch.py`, with the same
signatures, semantics and numerics. Every op runs on the device of its
input tensor; a non-tensor input goes to the default device
(`utils/dispatch.py::to_tensor`).

* ``autocorrelation``: Wiener-Khinchin (rfft, ``|.|^2``, irfft) on
  ``torch.fft``, or, for a short lag window of a long signal, the chunked
  overlap-save form whose chunk spectra are summed before one small
  inverse.
* The framewise ACF behind ``pitch_detect_acf`` and ``periodicity`` has two
  routes. The kernel route runs the fused filterbank kernel (K1,
  `kernels/mel_fused.py`) with a boxcar over half the transform as the
  window and the restricted inverse-DFT lag basis as the weight: the
  uncentered ACF at lag 0 and the searched lags, frames never stored; the
  per-frame mean centering is then restored exactly from hop-row sums and
  short head/tail cumsums. The plain route frames, centres, takes
  ``|rfft|^2`` and one FP32 GEMM with the same lag basis. Both gate noise
  frames exactly as the JAX package's two routes do.
* ``yin`` computes the difference function directly (squared differences
  summed per lag), vectorised over chunks of lags: the FFT identity
  cancels catastrophically in float32 on silence->onset frames.
* ``piptrack`` rides ``magnitude_spectrogram`` (K2m on a CUDA tensor);
  ``pitch_tuning`` and ``estimate_tuning`` finish on the host in NumPy.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..kernels.dft import _next_pow2, rfft_len, rfft_power_len
from ..kernels.mel_fused import melspectrogram_fused
from ..utils import dispatch
from ..utils.cache import table_cache
from ..utils.validation import validate_positive
from ._frames import frame_signal_batched, pad_signal

ArrayLike = Any

_EPS32 = float(np.finfo(np.float32).eps)
_TINY32 = float(np.finfo(np.float32).tiny)


def _as_batch(y: ArrayLike) -> tuple[torch.Tensor, bool]:
    y = dispatch.to_tensor(y, REAL_DTYPE)
    return (y[None], True) if y.dim() == 1 else (y, False)


def _autocorrelation_core(y: torch.Tensor, *, max_lag: int, normalize: bool,
                          center: bool) -> torch.Tensor:
    n = y.shape[-1]
    if center:
        y = y - y.mean(-1, keepdim=True)
    n_fft = _next_pow2(2 * n - 1)
    y = torch.nn.functional.pad(y, (0, n_fft - n))
    r = torch.fft.irfft(rfft_power_len(y, n_fft), n=n_fft, dim=-1)[:, :max_lag]
    if normalize:
        r = r / torch.clamp(r[:, :1], min=1e-10)
    return r.to(REAL_DTYPE)


# Largest max_lag the chunked overlap-save path serves; beyond it the chunk
# transform (2*max_lag wide at least) is no longer a small FFT.
_ACF_CHUNK_MAX_LAG = 4096


def _acf_chunk_nfft(max_lag: int) -> int:
    """Chunk transform length: ~8x the lag window, clamped to [2048, 8192]
    (the JAX package's choice, kept so both compute the same sums)."""
    return int(min(max(2048, _next_pow2(8 * max_lag)), 8192))


def _autocorrelation_chunked(y: torch.Tensor, *, max_lag: int, n_chunk: int,
                             normalize: bool, center: bool) -> torch.Tensor:
    """Overlap-save autocorrelation restricted to lags [0, max_lag).

    The signal is cut into K-sample chunks (K = n_chunk - max_lag); chunk
    ``c`` contributes ``sum_{t<K} a_c[t] * b_c[t+l]`` with ``a_c`` the
    zero-extended chunk and ``b_c`` the n_chunk-long slice at the same
    offset, so every cross-chunk product is captured and no circular wrap
    reaches lags < max_lag. The chunk products are summed in frequency and
    one small irfft finishes.
    """
    n = y.shape[-1]
    if center:
        y = y - y.mean(-1, keepdim=True)
    K = n_chunk - max_lag
    C = -(-n // K)
    Lp = (C - 1) * K + n_chunk
    bf = frame_signal_batched(torch.nn.functional.pad(y, (0, Lp - n)), n_chunk, K)
    af = bf * (torch.arange(n_chunk, device=y.device) < K).to(y.dtype)
    R = (torch.conj(rfft_len(af, n_chunk)) * rfft_len(bf, n_chunk)).sum(dim=1)
    r = torch.fft.irfft(R, n=n_chunk, dim=-1)[..., :max_lag]
    if normalize:
        r = r / torch.clamp(r[:, :1], min=1e-10)
    return r.to(REAL_DTYPE)


def autocorrelation(
    y: ArrayLike,
    max_lag: int | None = None,
    normalize: bool = True,
    center: bool = True,
) -> torch.Tensor:
    """Autocorrelation via Wiener-Khinchin, ``(max_lag,)`` / ``(B, max_lag)``,
    on the input's device. A short lag window of a long signal takes the
    chunked overlap-save form."""
    y, input_is_1d = _as_batch(y)
    n = y.shape[-1]
    if max_lag is None:
        max_lag = n
    max_lag = min(max_lag, n)
    kw = dict(max_lag=max_lag, normalize=normalize, center=center)
    r = None
    if 1 <= max_lag <= _ACF_CHUNK_MAX_LAG and max_lag <= n // 2:
        n_chunk = _acf_chunk_nfft(max_lag)
        if n >= n_chunk:
            r = _autocorrelation_chunked(y, n_chunk=n_chunk, **kw)
    if r is None:
        r = _autocorrelation_core(y, **kw)
    return r[0] if input_is_1d else r


@table_cache("acf_lag_basis", maxsize=8)
def _acf_lag_basis(n_fft: int, lo: int, hi: int) -> np.ndarray:
    """``(n_fft//2+1, 1 + hi - lo)`` inverse-rDFT columns for lag 0 (the
    normalizer) and lags [lo, hi): ``r[l] = sum_k c_k P_k cos(2 pi k l/N)``
    with the hermitian weights ``c`` folded in (host float64)."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    lags = np.concatenate([[0], np.arange(lo, hi)]).astype(np.float64)
    C = np.cos(2.0 * np.pi * np.outer(k, lags) / n_fft) / n_fft
    C[1:-1] *= 2.0  # interior rfft bins stand for two full-DFT bins
    return C


@table_cache("acf_window", maxsize=8)
def _acf_window_table(W: int, n_fft: int) -> np.ndarray:
    """Boxcar over the frame, zeros over the transform's zero-pad region."""
    w = np.zeros(n_fft, np.float64)
    w[:W] = 1.0
    return w


def _acf_kernel_route(n_fft: int, frame_length: int, hop_length: int, lo: int, hi: int) -> bool:
    """The kernel route's gate (the JAX package's, with the port's radix
    gate in place of its VMEM check: K1 takes any column count)."""
    return (
        n_fft % hop_length == 0
        and frame_length % hop_length == 0
        and lo >= 1
        and hi - 1 <= frame_length
        and dispatch.radix_shape_ok(n_fft, hop_length)
    )


def _framewise_acf(
    y: torch.Tensor, *, frame_length: int, hop_length: int, lo: int, hi: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame normalized ACF restricted to lags [lo, hi): ``(search,
    valid)``, ``search`` ``(B, F, hi-lo)`` and ``valid`` ``(B, F)``, the
    frames with energy above the noise floor. K1 on a CUDA tensor where
    the gate admits, else the plain route."""
    n_fft = _next_pow2(2 * frame_length - 1)
    C = _acf_lag_basis(n_fft, lo, hi, device=y.device)
    kw = dict(frame_length=frame_length, hop_length=hop_length, lo=lo, hi=hi)
    if (dispatch.kernel_route(None, y.device)
            and _acf_kernel_route(n_fft, frame_length, hop_length, lo, hi)):
        return _framewise_acf_fused(y, C, **kw)
    return _framewise_acf_plain(y, C, **kw)


def _framewise_acf_plain(
    y: torch.Tensor, C: torch.Tensor, *, frame_length: int, hop_length: int, lo: int, hi: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain route (the JAX package's ``_framewise_acf_xla``): frames,
    per-frame centering, ``|rfft|^2``, one FP32 GEMM with the lag basis."""
    frames = frame_signal_batched(y, frame_length, hop_length)
    praw = (frames * frames).sum(-1)  # uncentered power, the noise reference
    frames = frames - frames.mean(-1, keepdim=True)
    n_fft = _next_pow2(2 * frame_length - 1)
    frames = torch.nn.functional.pad(frames, (0, n_fft - frame_length))
    r = torch.matmul(rfft_power_len(frames, n_fft), C)
    r0 = r[..., :1]
    # noise floor: the centered residual of a constant frame is rounding of
    # the mean subtraction, whose power scales as eps^2 * praw
    valid = r0[..., 0] > torch.clamp(64.0 * _EPS32 * _EPS32 * praw, min=1e-10)
    rn = r[..., 1:] / torch.clamp(r0, min=1e-10)
    return torch.where(valid[..., None], rn, 0.0), valid


def _acf_prep(y: torch.Tensor, *, frame_length: int, hop_length: int):
    """DC removal and tail pad for the kernel route. The centered frame ACF
    is invariant under a constant shift of the signal, but the post-hoc
    centering subtracts terms as large as the uncentered ACF, so the shift
    should leave the frames' means as small as it can. The JAX package
    removes the global mean; a centre pad of zeros then leaves every
    interior frame of a signal riding on a DC offset with a residual mean
    (5% of the offset on a 0.4 s clip at frame 512), enough to move f0 by a
    lag. The port removes the median of the hop-row means instead: the
    offset itself, whatever the pads."""
    L = y.shape[1]
    F = 1 + (L - frame_length) // hop_length
    n_fft = _next_pow2(2 * frame_length - 1)
    Lp = (F - 1) * hop_length + n_fft
    R = L // hop_length
    rows = y[:, : R * hop_length].reshape(-1, R, hop_length).mean(-1)
    yc = y - rows.median(-1, keepdim=True).values
    return yc, torch.nn.functional.pad(yc, (0, Lp - L))


def _framewise_acf_fused(
    y: torch.Tensor, C: torch.Tensor, *, frame_length: int, hop_length: int, lo: int, hi: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel route: K1 with window ``[1]*W + [0]*(n_fft-W)`` and the
    lag basis as its weight, at power 2 without a centre pad, gives the
    uncentered linear ACF at lag 0 and lags [lo, hi) of every frame;
    :func:`_acf_center_correct` then centres it exactly."""
    W = frame_length
    n_fft = _next_pow2(2 * W - 1)
    win = _acf_window_table(W, n_fft, device=y.device)
    yc, ypad = _acf_prep(y, frame_length=W, hop_length=hop_length)
    raw = melspectrogram_fused(ypad, win, C, n_fft=n_fft, hop_length=hop_length, center=False,
                               pad_mode="constant", power=2.0)  # (B, 1 + hi - lo, F)
    return _acf_center_correct(yc, ypad, raw, frame_length=W, hop_length=hop_length,
                               lo=lo, hi=hi)


def _acf_center_correct(
    yc: torch.Tensor, ypad: torch.Tensor, raw: torch.Tensor, *, frame_length: int,
    hop_length: int, lo: int, hi: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-frame centering of the uncentered ACF ``raw``:
    ``r'(l) = r(l) - m*(2S - P_l - Q_l) + (W - l) m^2`` with ``m = S/W``,
    ``S`` the frame sum and ``P_l`` / ``Q_l`` the sums of its first / last
    ``l`` samples, from hop-row sums and (hi-1)-wide head/tail cumsums."""
    B, L = yc.shape
    W = frame_length
    F = 1 + (L - W) // hop_length
    r = raw.transpose(1, 2)  # (B, F, 1 + nl)

    # frame sums from hop-row sums (W is a whole number of hops: gate)
    Cp = W // hop_length
    rs = ypad.reshape(B, ypad.shape[1] // hop_length, hop_length).sum(-1)
    S = rs[:, :F]
    for c in range(1, Cp):
        S = S + rs[:, c : c + F]
    m = S / W

    hw = hi - 1
    Pc = torch.cumsum(frame_signal_batched(yc, hw, hop_length)[:, :F], dim=-1)
    tails = frame_signal_batched(ypad[:, W - hw :], hw, hop_length)[:, :F]
    Qc = torch.cumsum(tails.flip(-1), dim=-1)
    P = Pc[..., lo - 1 : hi - 1]
    Q = Qc[..., lo - 1 : hi - 1]

    lags = torch.arange(lo, hi, dtype=REAL_DTYPE, device=yc.device)
    r_raw = r[..., 0]
    r0 = r_raw - S * S / W
    rl = r[..., 1:] - m[..., None] * (2.0 * S[..., None] - P - Q) + (W - lags) * (m * m)[..., None]
    # noise floor relative to the uncentered power: a frame whose centered
    # energy is within ~32 eps of its raw power is cancellation residue
    valid = r0 > torch.clamp(32.0 * _EPS32 * r_raw, min=1e-10)
    rn = rl / torch.clamp(r0[..., None], min=1e-10)
    return torch.where(valid[..., None], rn, 0.0), valid


def _lag_bounds(sr: int, fmin: float, fmax: float) -> tuple[int, int]:
    # min_lag floored at 1: fmax > sr would otherwise put the trivial lag-0
    # value into the search window
    return max(1, int(sr / fmax)), int(sr / fmin)


def _centered(y: ArrayLike, frame_length: int, center: bool, mode: str = "constant"):
    """``(B, L)`` float32 on the input's device, padded by ``frame_length //
    2`` on both sides when ``center``; and whether the input was 1-D."""
    y, input_is_1d = _as_batch(y)
    if center:
        y = pad_signal(y, frame_length // 2, mode)
    return y, input_is_1d


def pitch_detect_acf(
    y: ArrayLike,
    sr: int = 22050,
    fmin: float = 50.0,
    fmax: float = 2000.0,
    frame_length: int = 2048,
    hop_length: int = 512,
    threshold: float = 0.1,
    center: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ACF pitch tracking: ``(f0, voiced_flag)`` per frame, on the input's
    device. Per frame the first interior local maximum of the normalized
    ACF above ``threshold`` within lags ``[sr/fmax, sr/fmin]`` wins, else
    the global maximum if it is above ``threshold``."""
    validate_positive(frame_length, "frame_length")
    validate_positive(hop_length, "hop_length")
    if fmin >= fmax:
        raise ValueError(f"fmin ({fmin}) must be less than fmax ({fmax})")
    min_lag, max_lag = _lag_bounds(sr, fmin, fmax)
    y, input_is_1d = _centered(y, frame_length, center)

    n_fft = _next_pow2(2 * frame_length - 1)
    lo, hi = min_lag, min(max_lag + 1, n_fft)
    if hi <= lo:
        F = 1 + (y.shape[1] - frame_length) // hop_length
        f0 = torch.zeros((y.shape[0], F), dtype=REAL_DTYPE, device=y.device)
        voiced = torch.zeros_like(f0, dtype=torch.bool)
    else:
        search, valid = _framewise_acf(y, frame_length=frame_length, hop_length=hop_length,
                                       lo=lo, hi=hi)
        f0, voiced = _pick_f0(search, valid, sr=sr, min_lag=min_lag, threshold=threshold)
    return (f0[0], voiced[0]) if input_is_1d else (f0, voiced)


def _pick_f0(
    search: torch.Tensor, valid: torch.Tensor, *, sr: int, min_lag: int, threshold: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorized "first local peak above threshold" over the ACF window:
    interior local-max mask, its first True; the global maximum above
    threshold as the fallback."""
    L = search.shape[-1]
    if L >= 3:
        mid, left, right = search[..., 1:-1], search[..., :-2], search[..., 2:]
        peak_mask = (mid > left) & (mid > right) & (mid > threshold)
        has_peak = peak_mask.any(-1)
        first_peak = peak_mask.to(torch.uint8).argmax(-1) + 1
    else:
        has_peak = torch.zeros(search.shape[:-1], dtype=torch.bool, device=search.device)
        first_peak = torch.zeros(search.shape[:-1], dtype=torch.int64, device=search.device)
    g_idx = search.argmax(-1)
    g_ok = search.gather(-1, g_idx[..., None])[..., 0] > threshold
    idx = torch.where(has_peak, first_peak, g_idx)
    voiced = valid & (has_peak | g_ok)
    period = torch.clamp(min_lag + idx, min=1).to(REAL_DTYPE)
    f0 = torch.where(voiced, sr / period, 0.0).to(REAL_DTYPE)
    return f0, voiced


# bytes of float32 differences one step of the YIN difference function may
# hold: a step covers as many lags as fit
_YIN_CHUNK_BYTES = 256 << 20


def _yin_cmnd(
    y: torch.Tensor, *, frame_length: int, win_length: int, hop_length: int,
    min_period: int, max_period: int,
) -> torch.Tensor:
    """Cumulative mean normalized difference for lags [min_period,
    max_period]. ``d(tau) = sum_{j<W} (x_j - x_{j+tau})^2`` directly, each
    summand non-negative at the scale of the answer (the identity
    ``e(0) + e(tau) - 2 r(tau)`` cancels catastrophically in float32 where
    a quiet head precedes a loud onset), over chunks of lags sized to
    ``_YIN_CHUNK_BYTES``; ``d'(tau) = d(tau) * tau / cumsum(d)(tau)``."""
    frames = frame_signal_batched(y, frame_length, hop_length)  # (B, F, L)
    W = win_length
    head = frames[..., None, :W]
    segs = frames.unfold(-1, W, 1)  # (B, F, L - W + 1, W), a view
    per_lag = 4 * head.numel()
    step = max(1, _YIN_CHUNK_BYTES // max(per_lag, 1))
    d = []
    for t0 in range(0, max_period + 1, step):
        diff = head - segs[..., t0 : min(t0 + step, max_period + 1), :]
        d.append((diff * diff).sum(-1))
    d = torch.cat(d, dim=-1)  # (B, F, P + 1)
    denom = torch.cumsum(d[..., 1:], dim=-1)
    tau = torch.arange(1, max_period + 1, dtype=REAL_DTYPE, device=y.device)
    cmnd = d[..., 1:] * tau / torch.clamp(denom, min=_TINY32)
    cmnd = torch.cat([torch.ones_like(cmnd[..., :1]), cmnd], dim=-1)  # d'(0) := 1
    return cmnd[..., min_period : max_period + 1]


def _yin_pick(band: torch.Tensor, *, sr: int, min_period: int,
              trough_threshold: float) -> torch.Tensor:
    """Trough selection and parabolic refinement on the banded CMND: the
    first local minimum below ``trough_threshold``, else the global
    minimum; the lag refined through its neighbours, clamped to +-0.5."""
    L = band.shape[-1]
    inf = torch.full_like(band[..., :1], float("inf"))
    left = torch.cat([inf, band[..., :-1]], dim=-1)
    right = torch.cat([band[..., 1:], inf], dim=-1)
    below = (band < left) & (band <= right) & (band < trough_threshold)
    has = below.any(-1)
    first = below.to(torch.uint8).argmax(-1)
    idx = torch.where(has, first, band.argmin(-1))

    def take(i):
        return band.gather(-1, i[..., None])[..., 0]

    c = take(idx)
    lft = take(torch.clamp(idx - 1, min=0))
    rgt = take(torch.clamp(idx + 1, max=L - 1))
    denom = lft + rgt - 2.0 * c
    shift = torch.where(denom.abs() > 1e-12,
                        0.5 * (lft - rgt) / torch.where(denom == 0, 1.0, denom), 0.0)
    shift = torch.where((idx > 0) & (idx < L - 1), torch.clamp(shift, -0.5, 0.5), 0.0)
    period = min_period + idx.to(REAL_DTYPE) + shift
    return (sr / torch.clamp(period, min=1e-6)).to(REAL_DTYPE)


def yin(
    y: ArrayLike,
    fmin: float,
    fmax: float,
    sr: int = 22050,
    frame_length: int = 2048,
    win_length: int | None = None,
    hop_length: int | None = None,
    trough_threshold: float = 0.1,
    center: bool = True,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """YIN fundamental-frequency estimate per frame, ``(F,)`` / ``(B, F)``,
    on the input's device (``librosa.yin`` semantics: f0 in Hz for every
    frame, no voicing decision)."""
    validate_positive(frame_length, "frame_length")
    if win_length is None:
        win_length = frame_length // 2
    if hop_length is None:
        hop_length = frame_length // 4
    validate_positive(hop_length, "hop_length")
    validate_positive(win_length, "win_length")
    if win_length >= frame_length:
        raise ValueError(
            f"win_length ({win_length}) must be less than frame_length ({frame_length})"
        )
    if fmin <= 0:
        raise ValueError(f"fmin must be positive, got {fmin}")
    if fmin >= fmax:
        raise ValueError(f"fmin ({fmin}) must be less than fmax ({fmax})")

    min_period = max(int(np.floor(sr / fmax)), 1)
    max_period = min(int(np.ceil(sr / fmin)), frame_length - win_length - 1)
    if max_period <= min_period:
        raise ValueError(
            f"the period band [{min_period}, {max_period}] is empty: raise "
            f"frame_length ({frame_length}) or narrow [fmin, fmax]"
        )
    y, input_is_1d = _centered(y, frame_length, center, pad_mode)
    if y.shape[-1] < frame_length:
        raise ValueError(
            f"signal of length {y.shape[-1]} is shorter than frame_length ({frame_length})"
        )
    band = _yin_cmnd(y, frame_length=frame_length, win_length=win_length,
                     hop_length=hop_length, min_period=min_period, max_period=max_period)
    f0 = _yin_pick(band, sr=sr, min_period=min_period, trough_threshold=float(trough_threshold))
    return f0[0] if input_is_1d else f0


def periodicity(
    y: ArrayLike,
    sr: int = 22050,
    fmin: float = 50.0,
    fmax: float = 2000.0,
    frame_length: int = 2048,
    hop_length: int = 512,
    center: bool = True,
) -> torch.Tensor:
    """Maximum normalized ACF in the pitch lag range per frame,
    ``(1, F)`` / ``(B, 1, F)``, on the input's device."""
    validate_positive(frame_length, "frame_length")
    validate_positive(hop_length, "hop_length")
    min_lag, max_lag = _lag_bounds(sr, fmin, fmax)
    y, input_is_1d = _centered(y, frame_length, center)
    n_fft = _next_pow2(2 * frame_length - 1)
    lo, hi = min_lag, min(max_lag + 1, n_fft)
    F = 1 + (y.shape[1] - frame_length) // hop_length
    if hi <= lo:
        out = torch.zeros((y.shape[0], 1, F), dtype=REAL_DTYPE, device=y.device)
    else:
        search, valid = _framewise_acf(y, frame_length=frame_length, hop_length=hop_length,
                                       lo=lo, hi=hi)
        out = torch.where(valid, search.amax(-1), 0.0).to(REAL_DTYPE)[:, None, :]
    return out[0] if input_is_1d else out


def _piptrack_core(S, freqs, fmin: float, fmax: float, threshold: float, ref,
                   sr_over_n: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense ``(pitches, mags)`` of magnitude spectrograms ``(B, bins, F)``:
    librosa.piptrack's math over the whole array, zeros off the peaks (its
    output format), instead of a scatter at ``np.nonzero``."""
    avg = 0.5 * (S[:, 2:, :] - S[:, :-2, :])
    curve = 2.0 * S[:, 1:-1, :] - S[:, 2:, :] - S[:, :-2, :]
    shift = avg / (curve + torch.where(curve.abs() < _TINY32, 1.0, 0.0))
    avg = torch.nn.functional.pad(avg, (0, 0, 1, 1))
    shift = torch.nn.functional.pad(shift, (0, 0, 1, 1))
    dskew = 0.5 * avg * shift

    # candidate peaks: local maxima (> previous, >= next, edge-padded) of
    # the thresholded spectrogram
    thr = S * (S > threshold * ref)
    tp = torch.cat([thr[:, :1], thr, thr[:, -1:]], dim=1)
    localmax = (thr > tp[:, :-2, :]) & (thr >= tp[:, 2:, :])
    mask = localmax & ((freqs >= fmin) & (freqs < fmax))[None, :, None]

    bin_idx = torch.arange(S.shape[1], dtype=S.dtype, device=S.device)[None, :, None]
    pitches = torch.where(mask, (bin_idx + shift) * sr_over_n, 0.0)
    mags = torch.where(mask, S + dskew, 0.0)
    return pitches.to(REAL_DTYPE), mags.to(REAL_DTYPE)


def piptrack(
    y: ArrayLike | None = None,
    sr: int = 22050,
    S: ArrayLike | None = None,
    n_fft: int = 2048,
    hop_length: int | None = None,
    fmin: float = 150.0,
    fmax: float = 4000.0,
    threshold: float = 0.1,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    ref: ArrayLike | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Parabolic-interpolation pitch tracking (librosa.piptrack semantics):
    ``(pitches, mags)`` shaped like the magnitude spectrogram, non-zero at
    the thresholded spectrum's local maxima within ``[fmin, fmax)``. From
    ``y`` the magnitude comes from ``magnitude_spectrogram`` (K2m on a CUDA
    tensor). ``ref``: None (the per-frame maximum), a callable
    ``ref(S)``, or a scalar or array broadcastable to S."""
    from .stft import magnitude_spectrogram

    validate_positive(n_fft, "n_fft")
    if hop_length is None:
        hop_length = n_fft // 4
    validate_positive(hop_length, "hop_length")
    if S is None:
        if y is None:
            raise ValueError("Either y (audio) or S (spectrogram) must be provided")
        S = magnitude_spectrogram(y, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                                  window=window, center=center, pad_mode=pad_mode)
    else:
        S = dispatch.to_tensor(S, REAL_DTYPE)
        # librosa infers n_fft from S, so the sr/n_fft pitch scale follows
        # the frequency grid
        if S.shape[-2] >= 2:
            n_fft = 2 * (S.shape[-2] - 1)

    input_is_1d = S.dim() == 2
    if input_is_1d:
        S = S[None]
    if S.dim() != 3:
        raise ValueError(f"piptrack expects a 2-D or 3-D spectrogram, got {S.dim()}-D")
    n_bins = S.shape[1]
    if n_bins < 3:
        z = torch.zeros_like(S)
        return (z[0], z[0]) if input_is_1d else (z, z)

    fmin_c = max(float(fmin), 0.0)
    fmax_c = min(float(fmax), sr / 2.0)
    freqs = torch.linspace(0.0, sr / 2.0, n_bins, dtype=REAL_DTYPE, device=S.device)
    if ref is None:
        ref_arr = S.amax(1, keepdim=True)
    elif callable(ref):
        ref_arr = torch.as_tensor(ref(S), dtype=REAL_DTYPE, device=S.device)
    else:
        ref_arr = torch.as_tensor(ref, dtype=REAL_DTYPE, device=S.device)
    pitches, mags = _piptrack_core(
        S, freqs, *(float(np.float32(v)) for v in (fmin_c, fmax_c, threshold)), ref_arr,
        float(np.float32(sr / float(n_fft))),
    )
    return (pitches[0], mags[0]) if input_is_1d else (pitches, mags)


def pitch_tuning(
    frequencies: ArrayLike,
    resolution: float = 0.01,
    bins_per_octave: int = 12,
) -> float:
    """Tuning offset in fractional bins from a set of detected pitches
    (librosa ``pitch_tuning``): each frequency's fractional chroma-bin
    residual folded into ``[-0.5, 0.5)``, the histogram mode at
    ``resolution``. Host NumPy."""
    validate_positive(resolution, "resolution")
    validate_positive(bins_per_octave, "bins_per_octave")
    if isinstance(frequencies, torch.Tensor):
        frequencies = frequencies.detach().cpu().numpy()
    f = np.asarray(frequencies, dtype=np.float64).ravel()
    f = f[np.isfinite(f) & (f > 0)]
    if f.size == 0:
        return 0.0
    residual = np.mod(bins_per_octave * np.log2(f / 440.0), 1.0)
    residual[residual >= 0.5] -= 1.0
    bins = np.linspace(-0.5, 0.5, int(np.ceil(1.0 / resolution)) + 1)
    counts, edges = np.histogram(residual, bins=bins)
    return float(edges[np.argmax(counts)])


def estimate_tuning(
    y: ArrayLike | None = None,
    sr: int = 22050,
    S: ArrayLike | None = None,
    n_fft: int = 2048,
    resolution: float = 0.01,
    bins_per_octave: int = 12,
    **piptrack_kwargs,
) -> float:
    """Global tuning deviation in fractional chroma bins (librosa
    ``estimate_tuning``): :func:`piptrack`, the pitches whose magnitude
    clears the median of the non-zero magnitudes, their
    :func:`pitch_tuning` histogram mode."""
    pitches, mags = piptrack(y=y, sr=sr, S=S, n_fft=n_fft, **piptrack_kwargs)
    pitches = pitches.detach().cpu().numpy().ravel()
    mags = mags.detach().cpu().numpy().ravel()
    sel = pitches > 0
    if not sel.any():
        return 0.0
    threshold = np.median(mags[sel])
    keep = sel & (mags >= threshold)
    return pitch_tuning(pitches[keep if keep.any() else sel], resolution=resolution,
                        bins_per_octave=bins_per_octave)
