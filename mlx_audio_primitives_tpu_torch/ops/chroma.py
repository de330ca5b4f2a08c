"""Chroma (pitch-class) filterbank and chromagram, tonnetz and CENS.

Counterpart of `mlx_audio_primitives_tpu/ops/chroma.py`, with the same
signatures and results (`librosa.filters.chroma` /
`librosa.feature.chroma_stft` semantics, the Ellis chromagram). The tables
(the chroma filterbank, the CQT-to-chroma fold, the tonnetz basis) are the
JAX package's float64 host builders, copied, cached per device as float32.

Routes on a CUDA tensor:

* ``chroma_stft`` of a signal ``y`` goes through
  :func:`~.mel.filterbank_spectrogram` with the ``(n_bins, n_chroma)``
  chroma weight, so it runs the fused filterbank kernel (K1,
  `kernels/mel_fused.py`) under K1's gate at power 1 or 2: one launch, 12
  columns in one 16-column tile, W read and the output written only at its
  own columns;
* ``chroma_stft`` of a spectrogram ``S``, and the CQT/VQT chroma, are one
  FP32 ``torch.matmul`` with the weight;
* ``tonnetz`` is one product with the ``(6, n_chroma)`` basis, and
  ``chroma_cens``'s time smoothing one product of the frames' windows
  (``unfold``) with the smoothing window: no convolution, whose cuDNN
  kernels may take TF32 unasked.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import FILTERBANK_CACHE_SIZE, REAL_DTYPE
from ..utils import dispatch
from ..utils.cache import table_cache
from ..utils.validation import validate_positive
from .mel import filterbank_spectrogram
from .stft import _as_batched, _get_padded_window, _validate_stft_params

ArrayLike = Any

_TINY = float(np.finfo(np.float32).tiny)


def hz_to_octs(
    frequencies: ArrayLike, tuning: float = 0.0, bins_per_octave: int = 12
) -> np.ndarray:
    """Hz -> octave number relative to A440/16 (host float64): the chroma
    frequency coordinate, A440 detuned by ``tuning`` fractional bins."""
    f = np.asarray(frequencies, dtype=np.float64)
    a440 = 440.0 * 2.0 ** (float(tuning) / bins_per_octave)
    with np.errstate(divide="ignore"):
        return np.log2(f / (a440 / 16.0))


def octs_to_hz(
    octs: ArrayLike, tuning: float = 0.0, bins_per_octave: int = 12
) -> np.ndarray:
    """Octave number -> Hz; exact inverse of :func:`hz_to_octs`."""
    z = np.asarray(octs, dtype=np.float64)
    a440 = 440.0 * 2.0 ** (float(tuning) / bins_per_octave)
    return (a440 / 16.0) * (2.0**z)


@table_cache("chroma_filterbank", maxsize=FILTERBANK_CACHE_SIZE)
def _chroma_filterbank_table(
    sr: int,
    n_fft: int,
    n_chroma: int,
    tuning: float,
    ctroct: float,
    octwidth: float | None,
    norm: float | None,
    base_c: bool,
) -> np.ndarray:
    """Gaussian-bump chroma projection ``(n_chroma, n_fft//2 + 1)`` in host
    float64 (the Ellis construction): each FFT bin's fractional chroma
    coordinate, a Gaussian per class whose width follows the local bin
    spacing, column normalization, then the octave weighting (center
    ``ctroct``, width ``octwidth``)."""
    # Fractional chroma bin of every FFT bin (DC gets a sentinel 1.5 octaves
    # below bin 1, so it lands in no class's bump).
    freqs = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    frqbins = n_chroma * hz_to_octs(freqs, tuning=tuning, bins_per_octave=n_chroma)
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))

    # Local spacing between successive bins' chroma coordinates, floored at
    # one chroma bin so the bumps never collapse at the sparse low end.
    binwidth = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]))

    # Wrapped distance from each FFT bin to each chroma class, in bins.
    D = frqbins[None, :] - np.arange(n_chroma, dtype=np.float64)[:, None]
    half = round(n_chroma / 2.0)
    D = np.remainder(D + half + 10 * n_chroma, n_chroma) - half

    wts = np.exp(-0.5 * (2.0 * D / binwidth[None, :]) ** 2)

    if norm is not None:
        if np.isinf(norm):
            length = np.max(np.abs(wts), axis=0)
        else:
            length = np.sum(np.abs(wts) ** norm, axis=0) ** (1.0 / norm)
        length = np.where(length < np.finfo(np.float64).tiny, 1.0, length)
        wts = wts / length[None, :]

    if octwidth is not None:
        wts *= np.exp(
            -0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)
        )[None, :]

    if base_c:
        # Rotate so row 0 is C rather than A (A->C is -3 semitone classes).
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)

    return np.ascontiguousarray(wts[:, : 1 + n_fft // 2])


def chroma_filterbank(
    sr: int,
    n_fft: int,
    n_chroma: int = 12,
    tuning: float = 0.0,
    ctroct: float = 5.0,
    octwidth: float | None = 2.0,
    norm: float | None = 2.0,
    base_c: bool = True,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Chroma filterbank ``(n_chroma, n_fft//2 + 1)`` on ``device`` (the
    default device when None), cached per device (librosa
    `filters.chroma` semantics): ``tuning`` in fractional chroma bins,
    ``ctroct``/``octwidth`` the octave weighting (``octwidth=None`` turns
    it off), ``norm`` the per-FFT-bin column norm, ``base_c`` rotates row
    0 from A to C."""
    validate_positive(n_fft, "n_fft")
    validate_positive(n_chroma, "n_chroma")
    validate_positive(sr, "sr")
    return _chroma_filterbank_table(
        int(sr),
        int(n_fft),
        int(n_chroma),
        float(tuning),
        float(ctroct),
        None if octwidth is None else float(octwidth),
        None if norm is None else float(norm),
        bool(base_c),
        device=dispatch.default_device(device),
    )


def _normalize_frames(C: torch.Tensor, norm: float | None) -> torch.Tensor:
    """Per-frame normalization over the class axis (-2)."""
    if norm is None:
        return C
    if np.isinf(norm):
        length = C.abs().amax(dim=-2, keepdim=True)
    elif norm == 1.0:
        length = C.abs().sum(dim=-2, keepdim=True)
    elif norm == 2.0:
        length = torch.sqrt((C * C).sum(dim=-2, keepdim=True))
    else:
        length = (C.abs() ** norm).sum(dim=-2, keepdim=True) ** (1.0 / norm)
    return C / torch.where(length < _TINY, torch.ones_like(length), length)


def chroma_stft(
    y: ArrayLike | None = None,
    sr: int = 22050,
    S: ArrayLike | None = None,
    n_fft: int = 2048,
    hop_length: int | None = None,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    power: float = 2.0,
    norm: float | None = np.inf,
    tuning: float = 0.0,
    n_chroma: int = 12,
    ctroct: float = 5.0,
    octwidth: float | None = 2.0,
    base_c: bool = True,
    fft_mode: str = "auto",
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """Chromagram ``(n_chroma, n_frames)`` / ``(batch, n_chroma, n_frames)``
    (librosa `feature.chroma_stft` semantics): ``|STFT|^power`` through the
    chroma filterbank, then each frame normalized (``norm=inf``: the peak
    class is 1.0). A precomputed spectrogram ``S`` ``(..., n_fft//2+1, F)``
    replaces ``y``. ``tuning`` defaults to 0.0, not estimated. The
    ``y`` route runs K1 (see the module note); ``use_pallas`` picks as
    for :func:`~.mel.melspectrogram`."""
    if hop_length is None:
        hop_length = n_fft // 4
    if win_length is None:
        win_length = n_fft
    kw = dict(sr=sr, n_fft=n_fft, n_chroma=n_chroma, tuning=tuning, ctroct=ctroct,
              octwidth=octwidth, base_c=base_c)

    if S is not None:
        S = dispatch.to_tensor(S, REAL_DTYPE)
        input_is_1d = S.dim() == 2
        if input_is_1d:
            S = S[None]
        if S.shape[-2] != n_fft // 2 + 1:
            raise ValueError(
                f"S has {S.shape[-2]} frequency bins but n_fft={n_fft} "
                f"implies {n_fft // 2 + 1}"
            )
        raw = torch.matmul(chroma_filterbank(**kw, device=S.device), S)
        raw = _normalize_frames(raw, norm)
        return raw[0] if input_is_1d else raw

    if y is None:
        raise ValueError("Either y or S must be provided")
    _validate_stft_params(n_fft, hop_length, win_length, pad_mode)
    y, input_is_1d = _as_batched(y, n_fft, center)
    win = _get_padded_window(window, win_length, n_fft, y.device)
    raw = filterbank_spectrogram(
        y,
        win,
        chroma_filterbank(**kw, device=y.device),
        n_fft=n_fft,
        hop_length=hop_length,
        center=center,
        pad_mode=pad_mode,
        power=power,
        fft_mode=fft_mode,
        use_pallas=use_pallas,
    )
    raw = _normalize_frames(raw, norm)
    return raw[0] if input_is_1d else raw


@table_cache("cq_to_chroma", maxsize=FILTERBANK_CACHE_SIZE)
def _cq_to_chroma_table(
    n_bins: int, bins_per_octave: int, n_chroma: int, fmin: float,
    base_c: bool,
) -> np.ndarray:
    """(n_chroma, n_bins) matrix folding CQT bins onto pitch classes
    (librosa `filters.cq_to_chroma` for ``bins_per_octave % n_chroma ==
    0``): each bin's energy goes to the class of its center frequency,
    split linearly between two classes for a detuned anchor; merged bins
    average."""
    if bins_per_octave % n_chroma != 0:
        raise ValueError(
            f"bins_per_octave ({bins_per_octave}) must be a multiple of "
            f"n_chroma ({n_chroma})"
        )
    merge = bins_per_octave // n_chroma
    from .cqt import _C1

    midi_off = 12.0 * np.log2(fmin / _C1)  # semitones above C1
    class0 = (midi_off * n_chroma / 12.0) % n_chroma
    M = np.zeros((n_chroma, n_bins), dtype=np.float64)
    for b in range(n_bins):
        c = (class0 + b / merge) % n_chroma
        lo = int(np.floor(c)) % n_chroma
        frac = c - np.floor(c)
        M[lo, b] += (1.0 - frac) / merge
        M[(lo + 1) % n_chroma, b] += frac / merge
    if not base_c:
        # rotate class 0 from C to A
        M = np.roll(M, 3 * (n_chroma // 12), axis=0)
    return M


def _cq_chroma(V: torch.Tensor, n_bins: int, bins_per_octave: int, n_chroma: int,
               fmin: float, base_c: bool, norm: float | None) -> torch.Tensor:
    """``|V|`` of a complex CQT/VQT folded onto pitch classes, per-frame
    normalized."""
    M = _cq_to_chroma_table(int(n_bins), int(bins_per_octave), int(n_chroma), float(fmin),
                            bool(base_c), device=V.device)
    return _normalize_frames(torch.matmul(M, V.abs()), norm)


def chroma_cqt(
    y: ArrayLike,
    sr: int = 22050,
    hop_length: int = 512,
    fmin: float | None = None,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    tuning: float = 0.0,
    n_chroma: int = 12,
    norm: float | None = np.inf,
    base_c: bool = True,
) -> torch.Tensor:
    """Chromagram from the constant-Q transform, ``(n_chroma, F)`` /
    ``(batch, n_chroma, F)`` (librosa `feature.chroma_cqt` semantics):
    ``|CQT|`` folded onto pitch classes, then per-frame normalized like
    :func:`chroma_stft`."""
    from .cqt import _C1, cqt

    if fmin is None:
        fmin = _C1
    C = cqt(y, sr=sr, hop_length=hop_length, fmin=fmin, n_bins=n_bins,
            bins_per_octave=bins_per_octave, tuning=tuning)
    return _cq_chroma(C, n_bins, bins_per_octave, n_chroma, fmin, base_c, norm)


def chroma_vqt(
    y: ArrayLike,
    sr: int = 22050,
    hop_length: int = 512,
    fmin: float | None = None,
    n_bins: int = 84,
    gamma: float | None = None,
    bins_per_octave: int = 12,
    tuning: float = 0.0,
    n_chroma: int = 12,
    norm: float | None = np.inf,
    base_c: bool = True,
) -> torch.Tensor:
    """Chromagram from the variable-Q transform, ``(n_chroma, F)`` /
    ``(batch, n_chroma, F)``: :func:`chroma_cqt` over :func:`~.cqt.vqt`
    (the ERB-tracking ``gamma`` by default)."""
    from .cqt import _C1, vqt

    if fmin is None:
        fmin = _C1
    V = vqt(y, sr=sr, hop_length=hop_length, fmin=fmin, n_bins=n_bins, gamma=gamma,
            bins_per_octave=bins_per_octave, tuning=tuning)
    return _cq_chroma(V, n_bins, bins_per_octave, n_chroma, fmin, base_c, norm)


@table_cache("tonnetz_basis", maxsize=4)
def _tonnetz_basis(n_chroma: int) -> np.ndarray:
    """Harmonic-network projection ``(6, n_chroma)`` (librosa
    `feature.tonnetz`): (sin, cos) pairs on the circles of fifths (r=1),
    minor thirds (r=1) and major thirds (r=0.5)."""
    dim_map = np.linspace(0, 12, num=n_chroma, endpoint=False)
    scale = np.asarray([7.0 / 6, 7.0 / 6, 3.0 / 2, 3.0 / 2, 2.0 / 3, 2.0 / 3])
    V = np.multiply.outer(scale, dim_map)
    # even rows are the sin-phase coordinates
    V[::2] -= 0.5
    R = np.asarray([1.0, 1.0, 1.0, 1.0, 0.5, 0.5])
    return (R[:, None] * np.cos(np.pi * V)).astype(np.float32)


def _l1_frames(chroma: torch.Tensor) -> torch.Tensor:
    l1 = chroma.abs().sum(dim=-2, keepdim=True)
    return chroma / torch.where(l1 < _TINY, torch.ones_like(l1), l1)


def _as_chromagram(y, sr: int, chroma, name: str, kwargs: dict) -> torch.Tensor:
    """``chroma`` as a float32 tensor, or :func:`chroma_cqt` of ``y``."""
    if chroma is None:
        if y is None:
            raise ValueError("Either y (audio) or chroma must be provided")
        chroma = chroma_cqt(y, sr=sr, **kwargs)
    else:
        chroma = dispatch.to_tensor(chroma, REAL_DTYPE)
    if chroma.dim() not in (2, 3):
        raise ValueError(f"{name} expects a 2-D or 3-D chromagram, got {chroma.dim()}-D")
    return chroma


def tonnetz(
    y: ArrayLike | None = None,
    sr: int = 22050,
    chroma: ArrayLike | None = None,
    **chroma_cqt_kwargs,
) -> torch.Tensor:
    """Tonal-centroid features, ``(6, F)`` / ``(batch, 6, F)`` (librosa
    `feature.tonnetz`, Harte/Sandler/Gasser 2006): the l1-normalized
    chromagram projected onto the harmonic network. ``chroma`` may be
    given; else it is :func:`chroma_cqt` of ``y`` with
    ``**chroma_cqt_kwargs``."""
    chroma = _as_chromagram(y, sr, chroma, "tonnetz", chroma_cqt_kwargs)
    phi = _tonnetz_basis(int(chroma.shape[-2]), device=chroma.device)
    return torch.matmul(phi, _l1_frames(chroma))


_CENS_STEPS = (0.05, 0.1, 0.2, 0.4)
_CENS_WEIGHTS = (0.25, 0.25, 0.25, 0.25)


def chroma_cens(
    y: ArrayLike | None = None,
    sr: int = 22050,
    chroma: ArrayLike | None = None,
    win_len_smooth: int | None = 41,
    smoothing_window: str = "hann",
    **chroma_cqt_kwargs,
) -> torch.Tensor:
    """CENS chroma (librosa `feature.chroma_cens`, Mueller & Ewert 2011):
    l1-normalize the CQT chromagram, quantize through the
    (0.05/0.1/0.2/0.4 -> 0.25 each) staircase, smooth over time with a
    ``hann(win_len_smooth + 2)`` window, l2-normalize per frame.
    ``chroma`` may be given (a chromagram before normalization, e.g.
    ``chroma_cqt(..., norm=None)``); else :func:`chroma_cqt` of ``y``."""
    from .windows import get_window

    if chroma is None:
        chroma_cqt_kwargs.setdefault("norm", None)
    chroma = _as_chromagram(y, sr, chroma, "chroma_cens", chroma_cqt_kwargs)
    if win_len_smooth is not None:
        validate_positive(int(win_len_smooth), "win_len_smooth")
    cn = _l1_frames(chroma)
    q = sum(w * (cn > s).to(REAL_DTYPE) for s, w in zip(_CENS_STEPS, _CENS_WEIGHTS))
    if win_len_smooth:
        n = int(win_len_smooth) + 2
        win = get_window(smoothing_window, n, fftbins=False, device=q.device)
        win = win / win.sum()
        pad = n // 2
        F = q.shape[-1]
        qp = torch.nn.functional.pad(q, (pad, pad))
        q = torch.matmul(qp.unfold(-1, n, 1), win)[..., :F]
    l2 = torch.sqrt((q * q).sum(dim=-2, keepdim=True))
    return q / torch.where(l2 < _TINY, torch.ones_like(l2), l2)


__all__ = [
    "hz_to_octs", "octs_to_hz", "chroma_filterbank", "chroma_stft", "chroma_cqt",
    "chroma_vqt", "tonnetz", "chroma_cens",
]
