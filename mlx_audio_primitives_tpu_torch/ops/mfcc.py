"""MFCC, DCT-II and delta features.

Counterpart of `mlx_audio_primitives_tpu/ops/mfcc.py`, with the same
signatures and results. Every op runs on the device of its input tensor; a
non-tensor input goes to the default device (`utils/dispatch.py::to_tensor`).

* The DCT-II is a host float64 basis, cached per device as float32, in one
  plain FP32 ``torch.matmul`` (the JAX package leaves the same product to
  XLA). As there, the native C++ builder is tried first and the NumPy
  builder stands in without it; the table is bit-equal either way.
* ``mfcc`` runs ``melspectrogram`` (the fused filterbank kernel, K1, on a
  CUDA tensor), ``power_to_db``, the DCT over the mel axis and the lifter.
* ``delta`` applies the Savitzky-Golay filter as a linear operator: its
  exact coefficients come from ``scipy.signal.savgol_filter`` on the host,
  once, and the device does width shifted adds plus two small products for
  the 'interp' edges.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import DCT_CACHE_SIZE, REAL_DTYPE
from ..utils import dispatch
from ..utils.cache import table_cache
from ..utils.validation import validate_positive
from ._frames import pad_signal
from .convert import power_to_db
from .mel import melspectrogram

ArrayLike = Any


@table_cache("dct_basis", maxsize=DCT_CACHE_SIZE)
def _dct_basis_t(n_out: int, n_in: int, norm: str | None) -> np.ndarray:
    """Transposed DCT-II basis ``(n_in, n_out)``: C[k,n] = cos(pi k (2n+1) /
    (2N)), with the orthonormal scaling for ``norm='ortho'`` and scipy's
    factor 2 for ``norm=None`` (host float64). The native C++ builder
    first, the NumPy builder without it."""
    if norm in (None, "ortho"):
        from .._native import native_dct_basis_t

        basis_t = native_dct_basis_t(n_out, n_in, norm)
        if basis_t is not None:
            return basis_t
    n = np.arange(n_in, dtype=np.float64)
    k = np.arange(n_out, dtype=np.float64)
    basis = np.cos(np.pi * k[:, None] * (2.0 * n[None, :] + 1.0) / (2.0 * n_in))
    if norm == "ortho":
        basis[0, :] *= 1.0 / np.sqrt(n_in)
        basis[1:, :] *= np.sqrt(2.0 / n_in)
    elif norm is None:
        basis *= 2.0
    else:
        raise ValueError(f"Unknown norm: '{norm}'. Supported: 'ortho', None")
    return basis.T


def dct(
    x: ArrayLike,
    type: int = 2,
    n: int | None = None,
    axis: int = -1,
    norm: str | None = "ortho",
) -> torch.Tensor:
    """DCT-II along ``axis``, returning ``n`` coefficients of the N-point
    transform. Only type 2 is supported."""
    if type != 2:
        raise ValueError(f"Only DCT type 2 is supported, got {type}")
    x = dispatch.to_tensor(x, REAL_DTYPE)
    input_size = x.shape[axis]
    if n is None:
        n = input_size
    basis_t = _dct_basis_t(n, input_size, norm, device=x.device)
    move = axis not in (-1, x.dim() - 1)
    if move:
        x = torch.movedim(x, axis, -1)
    out = torch.matmul(x, basis_t)
    if move:
        out = torch.movedim(out, -1, axis)
    return out


def mfcc(
    y: ArrayLike | None = None,
    sr: int = 22050,
    S: ArrayLike | None = None,
    n_mfcc: int = 20,
    dct_type: int = 2,
    norm: str | None = "ortho",
    lifter: int = 0,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    power: float = 2.0,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    mel_norm: str | None = "slaney",
    fft_mode: str = "auto",
) -> torch.Tensor:
    """Mel-frequency cepstral coefficients, ``(..., n_mfcc, F)``.

    librosa-compatible: mel power spectrogram -> dB (``top_db`` 80 against
    the global maximum) -> DCT-II over the mel axis -> optional lifter
    ``1 + (L/2) sin(pi (n+1)/L)``. A given ``S`` is taken as an
    already-log-power mel spectrogram."""
    validate_positive(n_mfcc, "n_mfcc")
    s_was_provided = S is not None
    if S is None:
        if y is None:
            raise ValueError("Either y or S must be provided")
        S = melspectrogram(
            y, sr=sr, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
            window=window, center=center, pad_mode=pad_mode, power=power, n_mels=n_mels,
            fmin=fmin, fmax=fmax, htk=htk, norm=mel_norm, fft_mode=fft_mode,
        )
    S = dispatch.to_tensor(S, REAL_DTYPE)
    is_batched = S.dim() == 3
    if not is_batched:
        S = S[None]
    S_db = S if s_was_provided else power_to_db(S, ref=1.0, amin=1e-10, top_db=80.0)
    M = dct(S_db.transpose(1, 2), type=dct_type, n=n_mfcc, norm=norm).transpose(1, 2)
    if lifter != 0:
        M = M * lifter_coeffs(n_mfcc, lifter, device=M.device)[:, None]
    return M if is_batched else M[0]


def lifter_coeffs(n_mfcc: int, lifter: int, device: torch.device | str | None = None) -> torch.Tensor:
    """Sinusoidal cepstral lifter ``1 + (L/2) sin(pi (n+1)/L)`` as float32
    ``(n_mfcc,)`` on ``device`` (CPU when None); ones for ``lifter=0``."""
    if lifter < 0:
        raise ValueError(f"lifter must be non-negative, got {lifter}")
    if lifter == 0:
        return torch.ones((n_mfcc,), dtype=REAL_DTYPE, device=device)
    idx = np.arange(n_mfcc, dtype=np.float64)
    lift = 1.0 + (lifter / 2.0) * np.sin(np.pi * (idx + 1) / lifter)
    return torch.as_tensor(lift.astype(np.float32), device=device)


@table_cache("savgol_fir", maxsize=32)
def _savgol_tables(width: int, polyorder: int, deriv: int, delta_t: float) -> np.ndarray:
    """The Savitzky-Golay filter as a linear operator, packed:

    ``[0]``            the width-tap interior stencil;
    ``[1 : 1+half]``   left-edge rows (output i from the first ``width``);
    ``[1+half :]``     right-edge rows (output T-half+i from the last
                       ``width``), the 'interp' mode's edge polynomials.

    Built by pushing the identity through ``scipy.signal.savgol_filter`` on
    the host, so the device result equals scipy's up to float32 rounding."""
    from scipy.signal import savgol_filter

    M = savgol_filter(np.eye(width, dtype=np.float64), width, polyorder, deriv=deriv,
                      delta=delta_t, axis=0, mode="interp")
    half = width // 2
    return np.concatenate([M[half][None, :], M[:half], M[width - half :]], axis=0)


# delta's modes -> NumPy's padding modes (`_frames.pad_signal`; 'wrap' is an
# index remainder), which hold for pads longer than the data
_PAD_MODES = {"nearest": "edge", "mirror": "reflect", "constant": "constant", "wrap": "wrap"}


def delta(
    data: ArrayLike,
    width: int = 9,
    order: int = 1,
    axis: int = -1,
    mode: str = "interp",
    **kwargs,
) -> torch.Tensor:
    """Delta (derivative) features by Savitzky-Golay filtering, librosa's
    semantics. Modes: 'interp' (default), 'nearest', 'mirror', 'constant',
    'wrap'."""
    validate_positive(width, "width")
    validate_positive(order, "order")
    if width < 3:
        raise ValueError(f"width must be >= 3, got {width}")
    if width % 2 == 0:
        raise ValueError(f"width must be odd, got {width}")
    kwargs.pop("deriv", None)
    polyorder = int(kwargs.pop("polyorder", order))
    delta_t = float(kwargs.pop("delta", 1.0))
    if kwargs:
        raise TypeError(f"unexpected keyword arguments: {sorted(kwargs)}")
    if polyorder >= width:
        raise ValueError(f"polyorder ({polyorder}) must be less than width ({width})")
    if order > polyorder:
        raise ValueError(f"order ({order}) must be <= polyorder ({polyorder})")

    x = dispatch.to_tensor(data, REAL_DTYPE)
    if x.dim() == 0:
        x = x[None]
    T = x.shape[axis]
    if mode == "interp" and width > T:
        raise ValueError(
            f"when mode='interp', width={width} cannot exceed data.shape[axis]={T}"
        )
    packed = _savgol_tables(width, polyorder, order, delta_t, device=x.device)
    half = width // 2
    fir = packed[0]
    move = axis not in (-1, x.dim() - 1)
    if move:
        x = torch.movedim(x, axis, -1)

    if mode == "interp":
        interior = sum(fir[j] * x[..., j : T - width + 1 + j] for j in range(width))
        left = torch.matmul(x[..., :width], packed[1 : 1 + half].T)
        right = torch.matmul(x[..., T - width :], packed[1 + half :].T)
        out = torch.cat([left, interior, right], dim=-1)
    else:
        if mode not in _PAD_MODES:
            raise ValueError(f"Unknown mode: '{mode}'")
        if mode == "wrap":
            idx = torch.remainder(torch.arange(-half, T + half, device=x.device), T)
            xp = x.index_select(-1, idx)
        else:
            xp = pad_signal(x, half, _PAD_MODES[mode])
        out = sum(fir[j] * xp[..., j : j + T] for j in range(width))
    if move:
        out = torch.movedim(out, -1, axis)
    return out


__all__ = ["dct", "mfcc", "lifter_coeffs", "delta"]
