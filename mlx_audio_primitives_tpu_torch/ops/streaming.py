"""Streaming (chunked) STFT / ISTFT / log-mel / MFCC / chroma / pitch /
resample / PCEN.

Counterpart of `mlx_audio_primitives_tpu/ops/streaming.py`, with the same
signatures, state and results. Chunks are a whole number of hops, so each
push yields exactly ``chunk / hop`` frames and the carried state has a
fixed shape:

* STFT state: the last ``n_fft - hop`` input samples (the frame overlap);
* ISTFT state: the last ``n_fft - hop`` unnormalized overlap-add samples
  and the same positions of the running squared-window envelope, so every
  emitted sample is divided by the window sum the offline ``istft`` uses
  and ``concat(pushes..., flush()) == istft(S, center=False)`` over the
  whole signal.

Routes on a CUDA tensor: ``StreamingSTFT`` computes ``stft(center=False)``
of the carry plus the chunk, the STFT kernel (K2) once a push;
``StreamingLogMel``, ``StreamingMFCC``, ``StreamingChroma`` and
``StreamingPCEN`` take their filterbank power rows from the fused mel
kernel (K1) once a push (``filterbank_spectrogram(center=False)`` with the
mel or chroma weight), then dB, DCT, inf-norm or PCEN with its ``zi``.
``StreamingISTFT`` (it carries an unnormalized tail, which the overlap-add
kernel does not return), ``StreamingPitch`` (the plain ACF, the faster
route at that shape) and ``StreamingResample`` (one FP32 product) run
plain torch, as their JAX counterparts run XLA. The classes keep their
carried state as tensors on the chunk's device.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from .._config import COMPLEX_DTYPE, REAL_DTYPE, WINDOW_SUM_EPSILON
from ..kernels.dft import irfft_len
from ..utils import dispatch
from ..utils.validation import validate_positive
from ._frames import frame_signal_batched, overlap_add, window_envelope
from .convert import power_to_db
from .mel import filterbank_spectrogram, mel_filterbank
from .stft import _get_padded_window, stft

ArrayLike = Any

__all__ = [
    "streaming_stft_init", "streaming_stft_push", "streaming_istft_init",
    "streaming_istft_push", "streaming_istft_flush", "StreamingSTFT", "StreamingISTFT",
    "StreamingLogMel", "StreamingChroma", "StreamingMFCC", "StreamingPitch",
    "StreamingResample", "StreamingPCEN",
]

_TINY32 = float(np.finfo(np.float32).tiny)


def _valid_hop(hop_length: int | None, n_fft: int, name: str = "n_fft") -> int:
    """Validate/default the hop (``or`` would silently rewrite hop=0)."""
    hop = n_fft // 4 if hop_length is None else hop_length
    if not 0 < hop <= n_fft:
        raise ValueError(f"hop_length must be in (0, {name}]; got {hop} with {name}={n_fft}")
    return hop


def _as_chunk(chunk: ArrayLike) -> torch.Tensor:
    chunk = dispatch.to_tensor(chunk, REAL_DTYPE)
    return chunk[None] if chunk.dim() == 1 else chunk


def _extend(carry: torch.Tensor, chunk: torch.Tensor, hop_length: int, keep: int):
    """``(ext, new_carry)``: the carry and the chunk joined, and the last
    ``keep`` samples of that (sliced from the absolute position: a negative
    ``-keep`` start would select everything when ``keep == 0``)."""
    if chunk.shape[1] % hop_length != 0:
        raise ValueError(
            f"chunk size ({chunk.shape[1]}) must be a multiple of hop_length ({hop_length})"
        )
    ext = torch.cat([carry.to(chunk.device), chunk], dim=1)
    return ext, ext[:, ext.shape[1] - keep :]


# ---------------------------------------------------------------------------
# functional cores


def streaming_stft_init(batch: int, n_fft: int, hop_length: int,
                        device: torch.device | str | None = None) -> torch.Tensor:
    """Initial carry: ``n_fft - hop`` zeros (as if preceded by silence), on
    ``device`` (the default device when None)."""
    return torch.zeros((batch, n_fft - hop_length), dtype=REAL_DTYPE,
                       device=dispatch.default_device(device))


def streaming_stft_push(
    carry: torch.Tensor, chunk: torch.Tensor, win: torch.Tensor, *, n_fft: int, hop_length: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Push ``(B, chunk)`` samples -> (new carry, ``(B, chunk/hop, n_bins)``):
    the port's ``stft(center=False)`` of the carry plus the chunk (K2 on a
    CUDA tensor under the radix gate)."""
    ext, new_carry = _extend(carry, _as_chunk(chunk), hop_length, n_fft - hop_length)
    return new_carry, _frames_spectrum(ext, win, n_fft, hop_length)


def _frames_spectrum(ext: torch.Tensor, win: torch.Tensor, n_fft: int,
                     hop_length: int) -> torch.Tensor:
    """``stft(center=False)`` of the carry plus a chunk as ``(B, k,
    n_bins)`` (no frame for an empty chunk)."""
    if ext.shape[1] < n_fft:
        return torch.zeros((ext.shape[0], 0, n_fft // 2 + 1), dtype=COMPLEX_DTYPE,
                           device=ext.device)
    return stft(ext, n_fft=n_fft, hop_length=hop_length, window=win, center=False).transpose(1, 2)


def streaming_istft_init(batch: int, n_fft: int, hop_length: int,
                         device: torch.device | str | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Initial carry: (overlap-add sample tail, squared-window envelope
    tail), on ``device`` (the default device when None)."""
    tail = n_fft - hop_length
    dev = dispatch.default_device(device)
    return (torch.zeros((batch, tail), dtype=REAL_DTYPE, device=dev),
            torch.zeros((1, tail), dtype=REAL_DTYPE, device=dev))


def streaming_istft_push(
    carry: tuple[torch.Tensor, torch.Tensor], spec: torch.Tensor, win: torch.Tensor, *,
    n_fft: int, hop_length: int,
) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Push ``(B, F, n_bins)`` frames -> (new carry, ``(B, F*hop)`` samples).
    The envelope is overlap-added beside the samples (on a batch of 1), so
    an emitted sample is divided by the window sum the offline ``istft``
    divides it by."""
    sample_tail, env_tail = carry
    spec = dispatch.to_tensor(spec, COMPLEX_DTYPE)
    B, F, _ = spec.shape
    win = win.to(spec.device)
    frames = irfft_len(spec, n_fft) * win
    out_len = n_fft + (F - 1) * hop_length
    emit_len = F * hop_length
    tail_len = n_fft - hop_length
    combined = overlap_add(frames, hop_length, out_len)
    combined_env = window_envelope(win, F, hop_length, out_len)[None]
    combined[:, :tail_len] += sample_tail.to(spec.device)
    combined_env[:, :tail_len] += env_tail.to(spec.device)
    emitted = combined[:, :emit_len] / torch.clamp(combined_env[:, :emit_len],
                                                   min=WINDOW_SUM_EPSILON)
    return (combined[:, emit_len:], combined_env[:, emit_len:]), emitted


def streaming_istft_flush(carry: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """The final ``n_fft - hop`` samples after the last push: their
    envelope is final now, as at the offline ``istft``'s tail."""
    sample_tail, env_tail = carry
    return sample_tail / torch.clamp(env_tail, min=WINDOW_SUM_EPSILON)


# ---------------------------------------------------------------------------
# convenience classes


class StreamingSTFT:
    """Chunked STFT primed with silence.

    The stream equals the offline ``stft(center=False)`` of the signal
    pre-padded with ``n_fft - hop`` zeros: streamed frame ``f`` is offline
    (unpadded, center=False) frame ``f - (n_fft - hop)/hop`` once past the
    priming region. The carry is created on the first chunk's device.

    >>> s = StreamingSTFT(n_fft=1024, hop_length=256, batch=1)
    >>> for chunk in chunks:                 # (1, k*256) each
    ...     frames = s.push(chunk)           # (1, k, 513) complex64
    """

    def __init__(self, n_fft: int = 2048, hop_length: int | None = None,
                 window: str | ArrayLike = "hann", batch: int = 1):
        self.n_fft = n_fft
        self.hop_length = _valid_hop(hop_length, n_fft)
        self.window = window
        self.batch = batch
        self.win: torch.Tensor | None = None
        self.carry: torch.Tensor | None = None

    def _advance(self, chunk: ArrayLike) -> torch.Tensor:
        """Join the carry and ``chunk`` (``(B, k*hop)``), keep the new carry
        and return the joined samples, ``k`` frames' worth."""
        chunk = _as_chunk(chunk)
        if self.win is None or self.win.device != chunk.device:
            self.win = _get_padded_window(self.window, self.n_fft, self.n_fft, chunk.device)
        if self.carry is None:
            self.carry = torch.zeros((self.batch, self.n_fft - self.hop_length),
                                     dtype=REAL_DTYPE, device=chunk.device)
        ext, self.carry = _extend(self.carry, chunk, self.hop_length,
                                  self.n_fft - self.hop_length)
        return ext

    def push(self, chunk: ArrayLike) -> torch.Tensor:
        """Push ``(B, k*hop)`` samples -> ``(B, k, n_bins)`` complex64."""
        return _frames_spectrum(self._advance(chunk), self.win, self.n_fft, self.hop_length)

    def reset(self) -> None:
        self.carry = None


class StreamingISTFT:
    """Chunked ISTFT: push frame blocks, receive hop-aligned samples.

    Emitted samples lag the pushed frames by ``n_fft - hop`` samples (the
    overlap still being accumulated); :meth:`flush` after the last push
    returns them. All pushes plus the flush equal the offline
    ``istft(S, center=False)`` (to float32 rounding), the first and last
    ``n_fft - hop`` samples included."""

    def __init__(self, n_fft: int = 2048, hop_length: int | None = None,
                 window: str | ArrayLike = "hann", batch: int = 1):
        self.n_fft = n_fft
        self.hop_length = _valid_hop(hop_length, n_fft)
        self.window = window
        self.batch = batch
        self.win: torch.Tensor | None = None
        self.carry: tuple[torch.Tensor, torch.Tensor] | None = None

    def push(self, spec: ArrayLike) -> torch.Tensor:
        """Push ``(B, F, n_bins)`` frames -> ``(B, F*hop)`` samples."""
        spec = dispatch.to_tensor(spec, COMPLEX_DTYPE)
        if self.win is None or self.win.device != spec.device:
            self.win = _get_padded_window(self.window, self.n_fft, self.n_fft, spec.device)
        if self.carry is None:
            self.carry = streaming_istft_init(self.batch, self.n_fft, self.hop_length,
                                              spec.device)
        self.carry, out = streaming_istft_push(self.carry, spec, self.win, n_fft=self.n_fft,
                                               hop_length=self.hop_length)
        return out

    def flush(self) -> torch.Tensor:
        """The final ``(B, n_fft - hop)`` samples; resets the stream."""
        carry = self.carry
        if carry is None:
            carry = streaming_istft_init(self.batch, self.n_fft, self.hop_length)
        out = streaming_istft_flush(carry)
        self.reset()
        return out

    def reset(self) -> None:
        self.carry = None


class _FilterbankStream:
    """The shared front end of the log-mel, MFCC, chroma and PCEN streams:
    a :class:`StreamingSTFT` carry and ``|STFT|^2`` through a filterbank,
    from the fused mel kernel (K1) once a push on a CUDA tensor."""

    def __init__(self, n_fft: int, hop_length: int | None, window, batch: int):
        self.stft = StreamingSTFT(n_fft, hop_length, window, batch)

    def _weight(self, device: torch.device) -> torch.Tensor:
        raise NotImplementedError

    def _bands(self, chunk: ArrayLike) -> torch.Tensor:
        """Push ``(B, k*hop)`` samples -> the ``(B, n_bands, k)`` filterbank
        power rows."""
        s = self.stft
        ext = s._advance(chunk)
        fb = self._weight(ext.device)
        if ext.shape[1] < s.n_fft:  # an empty chunk: no frame
            return torch.zeros((ext.shape[0], fb.shape[0], 0), dtype=REAL_DTYPE,
                               device=ext.device)
        return filterbank_spectrogram(ext, s.win, fb, n_fft=s.n_fft, hop_length=s.hop_length,
                                      center=False, pad_mode="constant", power=2.0)

    def reset(self) -> None:
        self.stft.reset()


class StreamingLogMel(_FilterbankStream):
    """Chunked log-mel front end: the STFT carry, the mel filterbank's power
    rows (K1 once a push on a CUDA tensor), dB without a floor."""

    def __init__(self, sr: int = 22050, n_fft: int = 2048, hop_length: int | None = None,
                 n_mels: int = 128, window: str | ArrayLike = "hann", batch: int = 1):
        super().__init__(n_fft, hop_length, window, batch)
        self.sr, self.n_mels = sr, n_mels

    def _weight(self, device):
        return mel_filterbank(self.sr, self.stft.n_fft, n_mels=self.n_mels, device=device)

    def push(self, chunk: ArrayLike) -> torch.Tensor:
        """Push ``(B, k*hop)`` samples -> ``(B, k, n_mels)`` dB frames."""
        return power_to_db(self._bands(chunk), top_db=None).transpose(1, 2)


class StreamingChroma(_FilterbankStream):
    """Chunked chromagram: the STFT carry, the chroma filterbank's power
    rows (K1 once a push on a CUDA tensor), each frame over its inf-norm.

    Streamed output equals offline ``chroma_stft(center=False, norm=inf)``
    frame for frame past the silence-primed start: the normalization is
    per frame, nothing about it global."""

    def __init__(self, sr: int = 22050, n_fft: int = 2048, hop_length: int | None = None,
                 n_chroma: int = 12, tuning: float = 0.0, window: str | ArrayLike = "hann",
                 batch: int = 1):
        super().__init__(n_fft, hop_length, window, batch)
        self.sr, self.n_chroma, self.tuning = sr, n_chroma, tuning

    def _weight(self, device):
        from .chroma import chroma_filterbank

        return chroma_filterbank(self.sr, self.stft.n_fft, n_chroma=self.n_chroma,
                                 tuning=self.tuning, device=device)

    def push(self, chunk: ArrayLike) -> torch.Tensor:
        """Push ``(B, k*hop)`` samples -> ``(B, k, n_chroma)`` frames."""
        raw = self._bands(chunk).transpose(1, 2)  # (B, k, n_chroma)
        peak = raw.abs().amax(-1, keepdim=True)
        return raw / torch.where(peak < _TINY32, 1.0, peak)


class StreamingMFCC(_FilterbankStream):
    """Chunked MFCC front end: the STFT carry, the mel power rows (K1 once a
    push on a CUDA tensor), dB, DCT-II (and a lifter).

    The offline ``mfcc`` clamps dB at 80 below the global maximum, which a
    stream cannot know, so this class uses no floor: streamed output
    equals ``mfcc(S=power_to_db(melspectrogram(...), top_db=None))`` frame
    for frame past the silence-primed start."""

    def __init__(self, sr: int = 22050, n_fft: int = 2048, hop_length: int | None = None,
                 n_mfcc: int = 20, n_mels: int = 128, window: str | ArrayLike = "hann",
                 lifter: int = 0, batch: int = 1):
        from .mfcc import lifter_coeffs

        super().__init__(n_fft, hop_length, window, batch)
        self.sr, self.n_mfcc, self.n_mels = sr, n_mfcc, n_mels
        self.lift = lifter_coeffs(n_mfcc, lifter)  # host; one copy per device in _lift_on
        self._lift_on: dict[torch.device, torch.Tensor] = {}

    def _weight(self, device):
        return mel_filterbank(self.sr, self.stft.n_fft, n_mels=self.n_mels, device=device)

    def push(self, chunk: ArrayLike) -> torch.Tensor:
        """Push ``(B, k*hop)`` samples -> ``(B, k, n_mfcc)`` coefficients."""
        from .mfcc import _dct_basis_t

        logmel = power_to_db(self._bands(chunk), top_db=None).transpose(1, 2)
        dev = logmel.device
        dct_t = _dct_basis_t(self.n_mfcc, self.n_mels, "ortho", device=dev)
        if dev not in self._lift_on:
            self._lift_on[dev] = self.lift.to(dev)
        return torch.matmul(logmel, dct_t) * self._lift_on[dev]


class StreamingPCEN(_FilterbankStream):
    """Chunked PCEN-mel front end: the STFT carry, the mel power rows (K1
    once a push on a CUDA tensor), PCEN with the smoother's state carried
    across chunks (scipy ``lfilter``'s ``zi``). PCEN is causal, so the
    stream equals offline ``pcen(melspectrogram(..., center=False))``
    frame for frame."""

    def __init__(self, sr: int = 22050, n_fft: int = 2048, hop_length: int | None = None,
                 n_mels: int = 128, gain: float = 0.98, bias: float = 2.0, power: float = 0.5,
                 time_constant: float = 0.4, eps: float = 1e-6, b: float | None = None,
                 window: str | ArrayLike = "hann", batch: int = 1):
        super().__init__(n_fft, hop_length, window, batch)
        self.sr, self.n_mels = sr, n_mels
        self._pcen_kwargs = dict(sr=sr, hop_length=self.stft.hop_length, gain=gain, bias=bias,
                                 power=power, time_constant=time_constant, eps=eps, b=b)
        self._zi: torch.Tensor | None = None

    def _weight(self, device):
        return mel_filterbank(self.sr, self.stft.n_fft, n_mels=self.n_mels, device=device)

    def push(self, chunk: ArrayLike) -> torch.Tensor:
        """Push ``(B, k*hop)`` samples -> ``(B, k, n_mels)`` PCEN frames."""
        from .pcen import pcen

        mel = self._bands(chunk)
        if mel.shape[-1] == 0:
            return mel.transpose(1, 2)
        out, self._zi = pcen(mel, zi=self._zi, return_zf=True, **self._pcen_kwargs)
        return out.transpose(1, 2)

    def reset(self) -> None:
        super().reset()
        self._zi = None


class StreamingPitch:
    """Chunked ACF pitch tracking: per push of ``(B, k*hop)`` samples, the
    last ``frame_length - hop`` carried samples complete the overlapping
    frames, giving exactly ``k`` (f0, voiced) estimates.

    Equals the offline :func:`~.pitch.pitch_detect_acf` with
    ``center=False`` frame for frame once the carry holds signal (a
    silence-primed start, as :class:`StreamingSTFT`). Each push runs the
    ACF's plain route (frames, centering, ``|rfft|^2``, one FP32 product
    with the lag basis), which at a push's few frames is faster than the
    kernel route's three steps."""

    def __init__(self, sr: int = 22050, fmin: float = 50.0, fmax: float = 2000.0,
                 frame_length: int = 2048, hop_length: int = 512, threshold: float = 0.1,
                 batch: int = 1):
        from .pitch import _lag_bounds

        if fmin >= fmax:
            raise ValueError(f"fmin ({fmin}) must be less than fmax ({fmax})")
        hop_length = _valid_hop(hop_length, frame_length, name="frame_length")
        self.sr, self.threshold = sr, threshold
        self.frame_length, self.hop_length = frame_length, hop_length
        self.min_lag, max_lag = _lag_bounds(sr, fmin, fmax)
        self._lo = self.min_lag
        self._hi = min(max_lag + 1, frame_length + 1)
        self.batch = batch
        self.reset()

    def reset(self) -> None:
        self._carry: torch.Tensor | None = None

    def push(self, chunk: ArrayLike) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, k*hop)`` samples -> ``(f0, voiced)``, each ``(B, k)``."""
        from ..kernels.dft import _next_pow2
        from .pitch import _acf_lag_basis, _framewise_acf_plain, _pick_f0

        chunk = _as_chunk(chunk)
        if chunk.shape[0] != self.batch or chunk.shape[1] == 0 or chunk.shape[1] % self.hop_length:
            raise ValueError(
                f"chunk must be ({self.batch}, k*{self.hop_length}) with k >= 1; "
                f"got {tuple(chunk.shape)}"
            )
        if self._carry is None:
            self._carry = torch.zeros((self.batch, self.frame_length - self.hop_length),
                                      dtype=REAL_DTYPE, device=chunk.device)
        ext, self._carry = _extend(self._carry, chunk, self.hop_length,
                                   self.frame_length - self.hop_length)
        if self._hi <= self._lo:
            # degenerate lag window: the carry still advances
            z = torch.zeros((self.batch, chunk.shape[1] // self.hop_length), dtype=REAL_DTYPE,
                            device=chunk.device)
            return z, z.to(torch.bool)
        n_fft = _next_pow2(2 * self.frame_length - 1)
        C = _acf_lag_basis(n_fft, self._lo, self._hi, device=chunk.device)
        search, valid = _framewise_acf_plain(ext, C, frame_length=self.frame_length,
                                             hop_length=self.hop_length, lo=self._lo,
                                             hi=self._hi)
        return _pick_f0(search, valid, sr=self.sr, min_lag=self.min_lag,
                        threshold=self.threshold)


class StreamingResample:
    """Chunked polyphase resampling with the offline filter, exactly.

    The offline left extension (``Lpmax - 1`` zeros) is the initial carry,
    each pushed ``k * down`` input samples complete ``k`` hop-``down``
    frames (one FP32 product -> ``k * up`` output samples), and the
    filter's group delay leaves the last ``m0`` outputs to :meth:`flush`.
    All pushes plus the flush equal ``resample_poly(y, up, down,
    padtype='constant')``. Only the zero boundary can stream: every other
    padtype needs the signal's ends or statistics.

    >>> r = StreamingResample(up=160, down=441, batch=1)  # 44.1k -> 16k
    >>> outs = [r.push(c) for c in chunks]                # (1, k*441) each
    >>> outs.append(r.flush())
    """

    def __init__(self, up: int, down: int, batch: int = 1):
        from .resample import _polyphase_geometry

        validate_positive(up, "up")
        validate_positive(down, "down")
        g = math.gcd(up, down)
        self.up, self.down = up // g, down // g
        self.batch = batch
        self.identity = self.up == 1 and self.down == 1
        self.W = self.m0 = 0
        if not self.identity:
            _, _, self.W, self.m0 = _polyphase_geometry(self.up, self.down)
        self.reset()

    def reset(self) -> None:
        self._started = False
        self._carry: torch.Tensor | None = None

    def _step(self, chunk: torch.Tensor, drop: int) -> torch.Tensor:
        from .resample import _polyphase_kernel

        if self._carry is None:
            self._carry = torch.zeros((self.batch, self.W - self.down), dtype=REAL_DTYPE,
                                      device=chunk.device)
        ext, self._carry = _extend(self._carry, chunk, self.down, self.W - self.down)
        frames = frame_signal_batched(ext, self.W, self.down)  # (B, k, W)
        Kt = _polyphase_kernel(self.up, self.down, device=chunk.device)
        return torch.matmul(frames, Kt).reshape(chunk.shape[0], -1)[:, drop:]

    def push(self, chunk: ArrayLike) -> torch.Tensor:
        """``(B, k*down)`` input samples -> the resampled output samples:
        ``k*up`` a push, except the first, which gives ``k*up - m0`` (the
        filter's group delay), so the first chunk needs ``k*up > m0``."""
        chunk = _as_chunk(chunk)
        if self.identity:
            return chunk
        if chunk.shape[0] != self.batch or chunk.shape[1] == 0 or chunk.shape[1] % self.down:
            raise ValueError(
                f"chunk must be ({self.batch}, k*{self.down}) with k >= 1; "
                f"got {tuple(chunk.shape)}"
            )
        drop = 0
        if not self._started:
            drop = self.m0
            if chunk.shape[1] // self.down * self.up <= drop:
                raise ValueError(
                    f"first chunk must produce more than m0={self.m0} output samples; push "
                    f"at least {(self.m0 // self.up + 1) * self.down} input samples"
                )
            self._started = True
        return self._step(chunk, drop)

    def flush(self) -> torch.Tensor:
        """The final ``(B, m0)`` output samples (zero right-extension);
        resets the stream."""
        if self.identity:
            return torch.zeros((self.batch, 0), dtype=REAL_DTYPE,
                               device=dispatch.default_device())
        dev = self._carry.device if self._carry is not None else dispatch.default_device()
        E = -(-self.m0 // self.up)  # frames of zero extension needed
        zeros = torch.zeros((self.batch, E * self.down), dtype=REAL_DTYPE, device=dev)
        out = self._step(zeros, 0)[:, : self.m0]
        self.reset()
        return out
