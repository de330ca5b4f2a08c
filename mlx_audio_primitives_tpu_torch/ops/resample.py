"""Resampling: FFT-based, linear, and polyphase.

Counterpart of `mlx_audio_primitives_tpu/ops/resample.py`, with the same
signatures and results. Every op runs on the device of its input tensor; a
non-tensor input goes to the default device (`utils/dispatch.py::to_tensor`).

* ``res_type='fft'`` is scipy.signal.resample's spectrum surgery (copy the
  shared bins, halve or double the Nyquist bin, scale by num/Nx) on
  ``torch.fft`` at the exact lengths.
* ``resample_poly`` and the polyphase ``res_type`` family: the kaiser FIR is
  designed on the host as scipy does (``firwin``, a cached table) and
  packed into a ``(W, up)`` matrix; the signal is extended, framed with hop
  ``down`` (a strided view) and multiplied by that matrix in one FP32
  ``torch.matmul``, as the JAX package does at ``Precision.HIGHEST``. Not a
  convolution: cuDNN would run it in TF32 by default on Hopper, which
  misses the kaiser contract (2e-5), and the port sets no global flag.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from ..kernels.dft import irfft_len, rfft_len
from ..utils import dispatch
from ..utils.cache import table_cache
from ..utils.profiler import traced
from ..utils.validation import validate_positive
from ._frames import frame_signal_batched

ArrayLike = Any


def _resample_fft_core(y: torch.Tensor, target_length: int) -> torch.Tensor:
    """scipy.signal.resample's algorithm for real input."""
    n = y.shape[-1]
    num = target_length
    X = rfft_len(y, n)
    N = min(num, n)
    nyq = N // 2 + 1
    out_bins = num // 2 + 1
    Y = X[:, :nyq].clone()
    if N % 2 == 0:
        if num < n:
            Y[:, N // 2] *= 2.0  # downsampling: fold energy into the shared Nyquist bin
        elif num > n:
            Y[:, N // 2] *= 0.5  # upsampling: split the original Nyquist bin
    if out_bins > nyq:
        Y = torch.nn.functional.pad(Y, (0, out_bins - nyq))
    return (irfft_len(Y, num, owned=True) * (num / n)).to(REAL_DTYPE)


def _resample_linear_core(y: torch.Tensor, target_length: int) -> torch.Tensor:
    """Linear interpolation on a grid built in float64 on the host."""
    n = y.shape[-1]
    t = np.linspace(0.0, n - 1.0, target_length)
    idx_low = np.floor(t).astype(np.int64)
    idx_high = np.minimum(idx_low + 1, n - 1)
    frac = torch.from_numpy((t - idx_low).astype(np.float32)).to(y.device)
    lo = y.index_select(-1, torch.from_numpy(idx_low).to(y.device))
    hi = y.index_select(-1, torch.from_numpy(idx_high).to(y.device))
    return (1.0 - frac) * lo + frac * hi


_POLY_TYPES = ("polyphase", "kaiser_best", "kaiser_fast")


@traced("ops.resample")
def resample(
    y: ArrayLike,
    orig_sr: int,
    target_sr: int,
    res_type: str = "fft",
    fix: bool = True,
    scale: bool = False,
    axis: int = -1,
) -> torch.Tensor:
    """Resample audio between sample rates, on the input's device.

    ``res_type``: 'fft' (bandlimited spectrum surgery), 'linear', or the
    polyphase family: 'polyphase' (scipy resample_poly's kaiser-beta-5
    FIR), 'kaiser_best' / 'kaiser_fast' (resampy's windowed-sinc designs
    on the same polyphase GEMM). librosa's ``fix``/``scale`` semantics.
    """
    validate_positive(orig_sr, "orig_sr")
    validate_positive(target_sr, "target_sr")
    y = dispatch.to_tensor(y, REAL_DTYPE)
    if orig_sr == target_sr:
        return y
    if res_type not in ("fft", "linear", *_POLY_TYPES):
        raise ValueError(
            f"Unknown res_type: '{res_type}'. Supported: 'fft', 'linear', "
            "'polyphase', 'kaiser_best', 'kaiser_fast'"
        )
    if res_type in _POLY_TYPES and (
        int(orig_sr) != orig_sr or int(target_sr) != target_sr
    ):
        raise ValueError(
            f"res_type='{res_type}' requires integer sample rates, got "
            f"{orig_sr} -> {target_sr}"
        )

    if axis != -1:
        y = y.movedim(axis, -1)
    input_is_1d = y.dim() == 1
    if input_is_1d:
        y = y[None]

    n = y.shape[-1]
    ratio = target_sr / orig_sr
    target_length = int(round(n * ratio)) if fix else int(math.ceil(n * ratio))

    if target_length == n:
        out = y
    elif res_type == "fft":
        out = _resample_fft_core(y, target_length)
    elif res_type in _POLY_TYPES:
        g = math.gcd(int(target_sr), int(orig_sr))
        up, down = int(target_sr) // g, int(orig_sr) // g
        design = "scipy" if res_type == "polyphase" else res_type
        _, Lpmax, W, m0 = _polyphase_geometry(up, down, design)
        Kt = _polyphase_kernel(up, down, design, device=y.device)
        n_poly = n * up // down + bool((n * up) % down)
        out = _polyphase_core(y, Kt, up=up, down=down, n_out=n_poly, m0=m0, Lpmax=Lpmax, W=W)
        # librosa fixes the polyphase output (ceil(n*up/down) samples) to
        # the target length: crop, or zero-pad the tail if short
        if n_poly > target_length:
            out = out[:, :target_length]
        elif n_poly < target_length:
            out = torch.nn.functional.pad(out, (0, target_length - n_poly))
    else:
        out = _resample_linear_core(y, target_length)
    if scale and target_length != n:
        out = out * ratio

    if input_is_1d:
        out = out[0]
    if axis != -1:
        out = out.movedim(-1, axis)
    return out


#: resampy's published filter designs (num_zeros, rolloff, kaiser beta) for
#: the librosa-familiar kaiser res_types; 'scipy' is resample_poly's default
#: (10*max_rate half-length, cutoff 1/max_rate, beta 5).
_FIR_DESIGNS = {
    "scipy": (None, 1.0, 5.0),
    "kaiser_best": (64, 0.9475937167399596, 14.769656459379492),
    "kaiser_fast": (16, 0.85, 8.555504641634386),
}


def _fir_half_len(up: int, down: int, design: str) -> int:
    max_rate = max(up, down)
    num_zeros, rolloff, _ = _FIR_DESIGNS[design]
    if num_zeros is None:
        return 10 * max_rate
    # sinc zero-crossings sit max_rate/rolloff up-rate samples apart; span
    # num_zeros of them each side like resampy's precomputed table
    return int(math.ceil(num_zeros * max_rate / rolloff))


def _polyphase_geometry(up: int, down: int, design: str = "scipy") -> tuple[int, int, int, int]:
    """Geometry shared by the kernel builder and the core: (Lh, Lpmax, W, m0)."""
    half_len = _fir_half_len(up, down, design)
    n_pre_pad = down - half_len % down
    Lh = n_pre_pad + 2 * half_len + 1
    Lpmax = -(-Lh // up)
    W = down + Lpmax - 1
    m0 = (half_len + n_pre_pad) // down
    return Lh, Lpmax, W, m0


@table_cache("polyphase_kernel", maxsize=32)
def _polyphase_kernel(up: int, down: int, design: str = "scipy") -> np.ndarray:
    """Packed polyphase matrix ``K^T (W, up)`` (host float64).

    The anti-aliasing FIR (kaiser-windowed sinc per ``_FIR_DESIGNS``, gain
    ``up``) split into ``up`` phases: output ``m = up*s + p`` is
    ``sum_t h[up*t + p] * x[s*down + c_p - t]`` with ``c_p = (p*down)//up``,
    so every group of ``up`` consecutive outputs is one row of a
    ``frames @ K^T`` product over hop-``down`` frames of width ``W``.
    """
    from scipy.signal import firwin

    max_rate = max(up, down)
    _, rolloff, beta = _FIR_DESIGNS[design]
    half_len = _fir_half_len(up, down, design)
    n_pre_pad = down - half_len % down
    h = firwin(2 * half_len + 1, rolloff / max_rate, window=("kaiser", beta)) * up
    h_full = np.concatenate([np.zeros(n_pre_pad), h])
    _, Lpmax, W, _ = _polyphase_geometry(up, down, design)
    K = np.zeros((up, W), dtype=np.float64)
    for p in range(up):
        hp = h_full[((p * down) % up) :: up]
        c_p = (p * down) // up
        for t_idx in range(len(hp)):
            K[p, c_p + Lpmax - 1 - t_idx] = hp[t_idx]
    return K.T.copy()


#: upfirdn's signal-extension modes (resample_poly's ``padtype``), handled
#: by :func:`_extend`
_EXTENSION_MODES = (
    "constant", "edge", "wrap", "symmetric", "reflect",
    "smooth", "antisymmetric", "antireflect", "line",
)
_INDEX_MODES = ("edge", "wrap", "symmetric", "reflect")


def _median(y: torch.Tensor) -> torch.Tensor:
    """NumPy's median over the last axis (the mean of the two middle values
    for an even count; ``torch.median`` takes the lower one)."""
    s, n = torch.sort(y, dim=-1).values, y.shape[-1]
    return (s[..., (n - 1) // 2 : (n - 1) // 2 + 1] + s[..., n // 2 : n // 2 + 1]) * 0.5


#: stat padtypes: subtract the statistic, resample with zero extension, add
#: it back (scipy resample_poly's structure)
_STAT_FUNCS = {
    "mean": lambda y: y.mean(-1, keepdim=True),
    "median": _median,
    "maximum": lambda y: y.amax(-1, keepdim=True),
    "minimum": lambda y: y.amin(-1, keepdim=True),
}


def _extend(y: torch.Tensor, left: int, right: int, mode: str, cval) -> torch.Tensor:
    """Extend ``(B, n)`` beyond both edges with upfirdn's boundary semantics
    (scipy ``_upfirdn_apply``). The index modes gather NumPy's own padding
    of the sample indices, so any pad length behaves as ``np.pad``."""
    n = y.shape[-1]
    if mode == "constant":
        return torch.nn.functional.pad(y, (left, right), value=0.0 if cval is None else cval)
    if mode in _INDEX_MODES:
        idx = np.pad(np.arange(n), (left, right), mode=mode)
        return y.index_select(-1, torch.from_numpy(idx).to(y.device))
    if mode in ("smooth", "line"):
        if mode == "line":
            sl = sr = (y[:, -1:] - y[:, :1]) / max(n - 1, 1)
        elif n == 1:
            sl = sr = torch.zeros_like(y[:, :1])  # one sample: slope 0
        else:
            sl = y[:, 1:2] - y[:, :1]
            sr = y[:, -1:] - y[:, -2:-1]
        kl = torch.arange(left, 0, -1, dtype=y.dtype, device=y.device)
        kr = torch.arange(1, right + 1, dtype=y.dtype, device=y.device)
        return torch.cat([y[:, :1] - kl * sl, y, y[:, -1:] + kr * sr], dim=-1)
    if mode in ("antisymmetric", "antireflect"):
        # one mirror period only: beyond it the sign alternates again
        if left >= n or right >= n:
            raise ValueError(
                f"padtype='{mode}' needs the signal longer than the filter "
                f"half-length ({max(left, right)}); got {n} samples"
            )
        ext = _extend(y, left, right, "symmetric" if mode == "antisymmetric" else "reflect", None)
        if mode == "antisymmetric":
            lpad, rpad = -ext[:, :left], -ext[:, left + n :]
        else:
            lpad = 2.0 * y[:, :1] - ext[:, :left]
            rpad = 2.0 * y[:, -1:] - ext[:, left + n :]
        return torch.cat([lpad, y, rpad], dim=-1)
    raise ValueError(f"Unknown padtype '{mode}'")


def _polyphase_core(
    y: torch.Tensor, Kt: torch.Tensor, *, up: int, down: int, n_out: int,
    m0: int, Lpmax: int, W: int, padtype: str = "constant", cval: float | None = None,
) -> torch.Tensor:
    """Polyphase resample: extend, frame with hop ``down``, one FP32 GEMM."""
    B, n = y.shape
    S = -(-(m0 + n_out) // up)
    left = Lpmax - 1
    need = (S - 1) * down + W
    right = max(0, need - left - n)
    frames = frame_signal_batched(_extend(y, left, right, padtype, cval), W, down)[:, :S]
    out = torch.matmul(frames, Kt).reshape(B, S * up)  # (B, S, up) -> (B, S*up)
    return out[:, m0 : m0 + n_out]


@traced("ops.resample_poly")
def resample_poly(
    y: ArrayLike,
    up: int,
    down: int,
    axis: int = -1,
    padtype: str = "constant",
    cval: float | None = None,
) -> torch.Tensor:
    """Polyphase resampling with scipy.signal.resample_poly's semantics, on
    the input's device. Every scipy padtype: the extension modes extend the
    signal before the product; the stat modes ('mean', 'median', 'maximum',
    'minimum') subtract the statistic, resample with zero extension and add
    it back, as scipy does."""
    validate_positive(up, "up")
    validate_positive(down, "down")
    if padtype not in _EXTENSION_MODES and padtype not in _STAT_FUNCS:
        raise ValueError(
            f"padtype='{padtype}' not supported; one of "
            f"{sorted((*_EXTENSION_MODES, *_STAT_FUNCS))}"
        )
    if cval is not None and padtype != "constant":
        raise ValueError("cval has no effect when padtype is not 'constant'")
    y = dispatch.to_tensor(y, REAL_DTYPE)
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return y

    if axis != -1:
        y = y.movedim(axis, -1)
    input_is_1d = y.dim() == 1
    if input_is_1d:
        y = y[None]

    n_in = y.shape[-1]
    n_out = n_in * up
    n_out = n_out // down + bool(n_out % down)

    _, Lpmax, W, m0 = _polyphase_geometry(up, down)
    Kt = _polyphase_kernel(up, down, device=y.device)
    bg = None
    if padtype in _STAT_FUNCS:
        bg = _STAT_FUNCS[padtype](y)
        y = y - bg
    out = _polyphase_core(
        y, Kt, up=up, down=down, n_out=n_out, m0=m0, Lpmax=Lpmax, W=W,
        padtype=padtype if padtype in _EXTENSION_MODES else "constant", cval=cval,
    )
    if bg is not None:
        out = out + bg

    if input_is_1d:
        out = out[0]
    if axis != -1:
        out = out.movedim(-1, axis)
    return out
