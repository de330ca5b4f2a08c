"""K1: the fused filterbank spectrogram, as a CUDA kernel and its plain twin.

Counterpart of `mlx_audio_primitives_tpu/kernels/mel_fused.py`:
``(B, L)`` signal, padded window and a dense ``(n_bins, n_cols)`` matrix W
-> ``|rDFT(window * frame)|^p @ W`` as ``(B, n_cols, F)``, p in {1, 2}.

Source note (`csrc/mel_fused.cu`, ``mel_fused_kernel``). Replaces
``melspectrogram_pallas`` (its ``pallas_call`` in ``_mel_radix_core``).
A persistent grid walks (clip, tile of FT frames) pairs, FT = 16 up to
n_fft 2048. Each tile runs K2's register-resident FFT front end
(`csrc/fft_common.cuh`: the padded segment staged with ``cp.async`` while
the previous tile is contracted, ``first_pass``, ``rexchange_passes``),
then writes each frame's ``|X|^p`` row in natural bin order over the
frame's own spectrum (in rounds of a few frames, through per-thread
scratch slots), split into TF32 hi and lo parts, and contracts the
FT rows with W on the tensor cores: 3xTF32 ``mma.sync`` (lo*hi + hi*lo +
hi*hi in FP32 accumulators), 16 weight columns by 8 frames per product.
A warp owns one 16-column m-tile and a slice of the bins; the number of
m-tiles is ``ceil(n_cols / 16)``, so the cost follows W's columns (a
2-column weight costs one m-tile), and the slices' partial sums meet in
shared memory. Frames, spectra and power rows never reach device memory;
the output is written as ``(B, n_cols, F)`` with no separate transpose.

What bounds it on this card. At the scale configuration (256 x 4 s clips
at 22.05 kHz, n_fft 2048, 128 mels) the three TF32 products are 35 GFLOP
(0.07 ms at the TF32 peak) and the bytes 0.03 ms; W is read from L2 once
per 16-frame tile (1.5 GB there), straight into the tensor-core fragments,
since the frame buffers fill shared memory. The contraction's time grows
with W's columns, that is with this traffic, and it and the front end (no
overlap with the contraction inside a block) are what remain
(measurements in ``PERF.md``).

The fast entry (``mel_fused_fast_kernel``, ``fast_gemm=True``, the default
through ``_config.ANALYSIS_FAST_GEMM``). The same kernel with the
contraction as the JAX kernel's fast mode computes it: both operands split
into bfloat16 ``hi = bf16(x)`` and ``lo = bf16(x - hi)`` (round to nearest
even), and ``lo*hi + hi*lo + hi*hi`` on ``mma.sync`` m16n8k16 in FP32
accumulators, each 16-bin k-step from zero. The power rows hold bf16 parts
(two bins a 32-bit word, a B fragment register); W is passed transposed
with its bins zero-padded to whole 16-bin k-steps (one small copy a call)
and split in registers as it is loaded; inside a k-step the bins are
permuted so that a thread's four are consecutive (one load each). It is
within ~1e-5 of max of an exact product (the JAX package's class, 2.7e-5),
where the dense entry is within ~1e-6;
its plain twin is :func:`melspectrogram_plain` with ``fast_gemm=True``, the
same split in FP32 matmuls (a product of two bf16 values is exact in FP32).
Under either mode the backward is the exact plain composition's.

The TPU kernel's radix decimation, folded filterbank (``fold_filterbank``),
128-lane group layout, VMEM block picker and DMA double buffering have no
counterpart: this kernel emits natural bin order, so W is used as given.

The ACF entry (``mel_fused_acf_kernel``, :func:`acf_fused`). The pitch
ACF's weight, :func:`acf_lag_basis`, is the inverse real DFT at lag 0 and
lags [lo, hi), so K1 with it at power 2 is ``irfft(|rDFT(win * frame)|^2)``
read at those lags. This entry computes that inverse in the kernel: the
forward front end as above, the powers of each bin pair packed straight
into the inverse's input (``irfft_pack``'s algebra for real bins) and its
pass 0 in registers, the inverse's later passes, and the lags read where
the passes leave them.
It reads no weight: at n_fft 4096 with 432 lags the dense contraction read
the 3.5 MB basis from L2 once per 4-frame tile. Its bound is the two FFTs'
FP32 operations.
"""

from __future__ import annotations

import ctypes
from functools import partial

import numpy as np
import torch
import torch.nn.functional as tnf

from .. import _config
from ..ops._frames import windowed_frames
from ..utils.cache import table_cache
from ..utils.dispatch import on_cuda, radix_shape_ok
from ._build import I32, I64, Kernel, P, library, register, require, with_plain_backward
from .dft import rfft_frames, rfft_twiddles

#: the dense and the fast entry's launchers' arguments (the fast one reads W
#: transposed and padded)
_CONTRACT_ARGS = (P, I64, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32)
KERNEL = register(Kernel(
    "mel_fused_kernel", "mel_fused_launch", _CONTRACT_ARGS,
    source="mlx_audio_primitives_tpu_torch/csrc/mel_fused.cu",
    replaces="mlx_audio_primitives_tpu/kernels/mel_fused.py:581",
))
#: K1's fast entry: the same pallas_call with its fast_gemm mode (bf16x3)
KERNEL_FAST = register(Kernel(
    "mel_fused_fast_kernel", "mel_fused_fast_launch", _CONTRACT_ARGS,
    source="mlx_audio_primitives_tpu_torch/csrc/mel_fused.cu",
    replaces="mlx_audio_primitives_tpu/kernels/mel_fused.py:581",
))
#: K1's ACF entry: the same pallas_call at the framewise ACF's geometry
#: (`mlx_audio_primitives_tpu/ops/pitch.py::_framewise_acf_fused`)
KERNEL_ACF = register(Kernel(
    "mel_fused_acf_kernel", "mel_fused_acf_launch",
    (P, I64, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32),
    source="mlx_audio_primitives_tpu_torch/csrc/mel_fused.cu",
    replaces="mlx_audio_primitives_tpu/kernels/mel_fused.py:581",
))

#: pad_mode -> the kernels' padding code (fft_common.cuh::padded_sample)
PAD_CODES = {"constant": 0, "reflect": 1, "edge": 2}


def launch_geometry(n_fft: int, hop_length: int, device: torch.device, *,
                    acf: bool = False, fast: bool = False) -> dict:
    """K1's launch at ``(n_fft, hop_length)`` on a CUDA ``device`` (the ACF
    entry's with ``acf``, the fast entry's with ``fast``): threads per
    block, frames per tile, dynamic shared memory per block (bytes) and
    resident blocks per SM."""
    fn = library().mel_fused_geometry
    fn.argtypes = [I32, I32, I32, I32, P]
    fn.restype = I32
    info = (ctypes.c_int * 4)()
    entry = 1 if acf else 2 if fast else 0
    err = fn(n_fft, hop_length, entry, device.index, ctypes.cast(info, P))
    if err != 0:
        raise RuntimeError(f"mel_fused_geometry failed: CUDA error {err}")
    return dict(threads=info[0], frames_per_tile=info[1], smem_bytes=info[2],
                blocks_per_sm=info[3])


def melspectrogram_plain(
    y: torch.Tensor,  # (B, L)
    win: torch.Tensor,  # (n_fft,) padded window
    fb_t: torch.Tensor,  # (n_bins, n_cols)
    *,
    n_fft: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
    power: float = 2.0,
    basis: torch.Tensor | None = None,
    fast_gemm: bool = False,
) -> torch.Tensor:
    """Plain twin and plain composition: pad, frame, window, rfft (or the
    forward-basis GEMM), ``|X|^power``, ``@ fb_t`` -> ``(B, n_cols, F)``.
    Any power. ``fast_gemm``: the fast entry's twin, the contraction as
    ``hi@hi + hi@lo + lo@hi`` of the bf16 splits, in the JAX ``_group_dot``
    order."""
    frames = windowed_frames(y, win, n_fft, hop_length, center, pad_mode)
    spec = rfft_frames(frames, n_fft, basis)
    p = spec.real**2 + spec.imag**2
    if power == 1.0:
        p = torch.sqrt(p)
    elif power != 2.0:
        p = torch.pow(p, power / 2.0)
    if not fast_gemm:
        return torch.matmul(p, fb_t).transpose(1, 2)
    ph, pl = bf16_split(p)
    wh, wl = bf16_split(fb_t)
    return (torch.matmul(ph, wh) + torch.matmul(ph, wl) + torch.matmul(pl, wh)).transpose(1, 2)


def bf16_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``x`` -> ``(hi, lo)``, each a bfloat16 value held in float32:
    ``hi = bf16(x)``, ``lo = bf16(x - hi)``, rounding to nearest even, so
    ``hi + lo`` keeps ~16 of x's 24 mantissa bits (the JAX
    ``_bf16_split``)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _launch(y, win, fb_t, *, n_fft, hop_length, center, pad_mode, power, fast_gemm=False):
    require(y, "y", torch.float32, 2)
    require(win, "win", torch.float32, 1)
    require(fb_t, "fb_t", torch.float32, 2)
    B, L = y.shape
    n_bins, n_cols = fb_t.shape
    if win.shape[0] != n_fft or n_bins != n_fft // 2 + 1:
        raise ValueError(
            f"mel_fused_kernel needs win ({n_fft},) and fb_t ({n_fft // 2 + 1}, n_cols); "
            f"got {tuple(win.shape)} and {tuple(fb_t.shape)}"
        )
    pad = n_fft // 2 if center else 0
    F = 1 + (L + 2 * pad - n_fft) // hop_length
    tw = rfft_twiddles(n_fft, device=y.device)
    if fast_gemm:
        # the fast entry reads W transposed, its bins zero-padded to whole
        # 16-bin k-steps: a thread's A fragment is then one 16-byte load a
        # column
        w = tnf.pad(fb_t.t(), (0, -n_bins % 16)).contiguous()
    else:
        w = fb_t
    out = torch.empty((B, n_cols, F), dtype=torch.float32, device=y.device)
    (KERNEL_FAST if fast_gemm else KERNEL).launch(
        y.device, y.data_ptr(), L, win.data_ptr(), tw.data_ptr(), w.data_ptr(), out.data_ptr(), B,
        n_fft, hop_length, F, n_cols, pad, PAD_CODES[pad_mode], int(power))
    return out


def melspectrogram_fused(
    y: torch.Tensor,
    win: torch.Tensor,
    fb_t: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
    power: float = 2.0,
    fast_gemm: bool | None = None,
) -> torch.Tensor:
    """``(B, L) -> (B, n_cols, F)`` through ``mel_fused_kernel`` on a CUDA
    tensor, through the plain twin on a CPU tensor.

    Requires the radix shape gate (`utils/dispatch.py::radix_shape_ok`) and
    ``power`` in {1, 2}; any window and any dense ``fb_t`` (the contraction
    walks ``ceil(n_cols / 16)`` column tiles, so shared memory does not grow
    with the columns and time follows them). ``fast_gemm`` (None:
    ``_config.ANALYSIS_FAST_GEMM``, read at call time; True by default)
    takes the fast entry, ``mel_fused_fast_kernel``, and its twin: ~1e-5
    of max of an exact product; False the dense entry, within ~1e-6. Under
    both the backward differentiates the exact plain twin."""
    if not radix_shape_ok(n_fft, hop_length):
        raise ValueError(
            f"fused mel kernel requires pow2 n_fft = C*hop, hop = R2*128, "
            f"C,R2 <= 8; got n_fft={n_fft}, hop={hop_length}"
        )
    if power not in (1.0, 2.0):
        raise ValueError(f"fused mel kernel supports power in {{1, 2}}, got {power}")
    pad_total = n_fft if center else 0
    if y.shape[1] + pad_total < n_fft:
        raise ValueError(
            f"signal length ({y.shape[1]}) must be >= n_fft ({n_fft}) when center=False"
        )
    if fast_gemm is None:
        fast_gemm = _config.ANALYSIS_FAST_GEMM
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode,
              power=float(power))
    cuda = on_cuda(y, win, fb_t)
    if not (cuda or fast_gemm):
        return melspectrogram_plain(y, win, fb_t, **kw)
    forward = partial(_launch if cuda else melspectrogram_plain, fast_gemm=bool(fast_gemm))
    return with_plain_backward(forward, melspectrogram_plain, y, win, fb_t, **kw)


@table_cache("acf_lag_basis", maxsize=8)
def acf_lag_basis(n_fft: int, lo: int, hi: int) -> np.ndarray:
    """``(n_fft//2+1, 1 + hi - lo)`` inverse-rDFT columns for lag 0 (the
    normalizer) and lags [lo, hi): ``r[l] = sum_k c_k P_k cos(2 pi k l/N)``
    with the hermitian weights ``c`` folded in (host float64)."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    lags = np.concatenate([[0], np.arange(lo, hi)]).astype(np.float64)
    C = np.cos(2.0 * np.pi * np.outer(k, lags) / n_fft) / n_fft
    C[1:-1] *= 2.0  # interior rfft bins stand for two full-DFT bins
    return C


def acf_plain(ypad: torch.Tensor, win: torch.Tensor, *, n_fft: int, hop_length: int, lo: int,
              hi: int) -> torch.Tensor:
    """Plain twin of the ACF entry: K1's plain twin with the lag basis as
    its weight, at power 2 without a centre pad -> ``(B, 1 + hi - lo, F)``."""
    return melspectrogram_plain(ypad, win, acf_lag_basis(n_fft, lo, hi, device=ypad.device),
                                n_fft=n_fft, hop_length=hop_length, center=False,
                                pad_mode="constant", power=2.0)


def _launch_acf(ypad, win, *, n_fft, hop_length, lo, hi):
    require(ypad, "ypad", torch.float32, 2)
    require(win, "win", torch.float32, 1)
    if win.shape[0] != n_fft:
        raise ValueError(f"mel_fused_acf_kernel needs win ({n_fft},); got {tuple(win.shape)}")
    B, L = ypad.shape
    F = 1 + (L - n_fft) // hop_length
    tw = rfft_twiddles(n_fft, device=ypad.device)
    out = torch.empty((B, 1 + hi - lo, F), dtype=torch.float32, device=ypad.device)
    KERNEL_ACF.launch(ypad.device, ypad.data_ptr(), L, win.data_ptr(), tw.data_ptr(),
                      out.data_ptr(), B, n_fft, hop_length, F, lo, hi, 0, PAD_CODES["constant"])
    return out


def acf_fused(ypad: torch.Tensor, win: torch.Tensor, *, n_fft: int, hop_length: int, lo: int,
              hi: int) -> torch.Tensor:
    """Lag 0 and lags [lo, hi) of ``irfft(|rDFT(win * frame)|^2)`` of each
    frame of ``ypad`` (B, L), uncentred frames, no pad: ``(B, 1 + hi - lo,
    F)``, what :func:`melspectrogram_fused` gives with the weight
    :func:`acf_lag_basis` at power 2. Through ``mel_fused_acf_kernel`` on a
    CUDA tensor, through the plain twin on a CPU tensor.

    Requires the radix shape gate and ``0 <= lo < hi <= n_fft``. The
    backward differentiates the plain twin."""
    if not radix_shape_ok(n_fft, hop_length):
        raise ValueError(
            f"fused ACF kernel requires pow2 n_fft = C*hop, hop = R2*128, C,R2 <= 8; "
            f"got n_fft={n_fft}, hop={hop_length}"
        )
    if not 0 <= lo < hi <= n_fft:
        raise ValueError(f"fused ACF kernel needs 0 <= lo < hi <= n_fft; got lo={lo}, hi={hi}, "
                         f"n_fft={n_fft}")
    if ypad.shape[1] < n_fft:
        raise ValueError(f"signal length ({ypad.shape[1]}) must be >= n_fft ({n_fft})")
    kw = dict(n_fft=n_fft, hop_length=hop_length, lo=lo, hi=hi)
    if not on_cuda(ypad, win):
        return acf_plain(ypad, win, **kw)
    return with_plain_backward(_launch_acf, acf_plain, ypad, win, **kw)
