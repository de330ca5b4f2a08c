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
through ``_config.ANALYSIS_FAST_GEMM``). The contraction as the JAX kernel's
fast mode computes it: both operands split into bfloat16 ``hi = bf16(x)``
and ``lo = bf16(x - hi)`` (round to nearest even), and ``lo*hi + hi*lo +
hi*hi`` on ``mma.sync`` m16n8k16 in FP32 accumulators, each 16-bin k-step
from zero; within ~1e-5 of max of an exact product (the JAX package's
class, 2.7e-5), where the dense entry is within ~1e-6. It reads W from a
plan (:func:`band_plan_host`): W^T already split, in the order the A
fragments load it, and for each 16-column m-tile the range of k-steps
outside which its columns are zero. A cached table's plan is built once on
the host and kept per device beside the table (:func:`fast_plan`; the ops
pass the table's transpose view, so no call copies or transposes it), and
the kernel contracts only those blocks (73 of 520 at the 128-mel table),
the warps taking equal shares of them; a tile whose powers hold a value
that is not finite takes every k-step, so that ``inf * 0`` gives NaN in
every column, as in the dense product. For a W given per call (a
trainable filterbank, a caller's own weight) :func:`plan_of` first packs a
full-range plan from W on the device (``mel_fused_fast_pack_kernel``); the
plan's layout is `csrc/k1_plan.cuh`'s. The tile is the dense entry's (two
512-thread blocks an SM at n_fft 2048 measured slower). Its plain twin is
:func:`melspectrogram_plain` with ``fast_gemm=True``, the same split in
FP32 matmuls (a product of two bf16 values is exact in FP32). Under either
mode the backward is the exact plain composition's.

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

The mixed-radix entry, K1m (``mel_fused_mixed_kernel``,
`csrc/mel_fused_mixed.cu`). K1 at an n_fft off the radix gate, at any hop
from n_fft / 8 to n_fft (:func:`mixed_shape_ok`; Whisper's 400 at hop 160,
which does not divide it). Tiles of 32 frames read from one staged segment
at offsets of the hop; the real FFT as the complex FFT of n_fft / 2 packed
points in radix-5 and radix-8 passes (:func:`mixed_fft`), FP32, through
shared memory; the power rows as bf16 hi and lo; and the fast entry's
contraction from the same plan (:func:`plan_of`). It has the fast entry's
precision and no exact mode, so K1's gate (:func:`mel_shape_ok`) admits it
only in the fast mode. Its plain twin, :func:`melspectrogram_mixed_plain`,
runs the same passes in torch; the backward is the exact plain
composition's.

:func:`melspectrogram_fused` is the one wrapper of the three filterbank
entries: it takes the dense entry, the fast entry or K1m from the shape and
the mode.
"""

from __future__ import annotations

import ctypes
from functools import partial

import numpy as np
import torch

from .. import _config
from ..ops._frames import windowed_frames
from ..utils.cache import TableCache, table_cache, table_origin
from ..utils.dispatch import on_cuda, radix_shape_ok
from ..utils.profiler import traced
from ._build import I32, I64, Kernel, P, library, register, require, with_plain_backward
from .dft import rfft_frames, rfft_twiddles

KERNEL = register(Kernel(
    "mel_fused_kernel", "mel_fused_launch",
    (P, I64, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32),
    source="mlx_audio_primitives_tpu_torch/csrc/mel_fused.cu",
    replaces="mlx_audio_primitives_tpu/kernels/mel_fused.py:581",
))
#: K1's fast entry: the same pallas_call with its fast_gemm mode (bf16x3),
#: reading its weight from a plan (:func:`plan_of`)
KERNEL_FAST = register(Kernel(
    "mel_fused_fast_kernel", "mel_fused_fast_launch",
    (P, I64, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32, I32),
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

#: K1m: the same pallas_call at an n_fft off the radix gate (the fast
#: entry's contraction from the same plan)
KERNEL_MIXED = register(Kernel(
    "mel_fused_mixed_kernel", "mel_fused_mixed_launch",
    (P, I64, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32),
    source="mlx_audio_primitives_tpu_torch/csrc/mel_fused_mixed.cu",
    replaces="mlx_audio_primitives_tpu/kernels/mel_fused.py:581",
))

#: The full-range plan of a W given per call, packed on its device for the
#: fast entry and K1m (:func:`plan_of`). Not registered: no launch count
#: holds it, as none holds a table's build.
PACK = Kernel(
    "mel_fused_fast_pack_kernel", "mel_fused_pack_launch", (P, I64, I64, I32, I32, P),
    source="mlx_audio_primitives_tpu_torch/csrc/mel_fused.cu",
    replaces="mlx_audio_primitives_tpu/kernels/mel_fused.py:581",
)

#: pad_mode -> the kernels' padding code (fft_common.cuh::padded_sample)
PAD_CODES = {"constant": 0, "reflect": 1, "edge": 2}

#: The n_fft values of K1m (`csrc/mel_fused_mixed.cu`, one instance each):
#: Whisper's 400 = 2^4 * 5^2, off the radix gate
MIXED_N_FFTS = (400,)


def mixed_shape_ok(n_fft: int, hop_length: int) -> bool:
    """K1m's shape gate: an n_fft it is built for, at any hop from
    ``n_fft // 8`` to ``n_fft`` (the hop need not divide it)."""
    return n_fft in MIXED_N_FFTS and n_fft // 8 <= hop_length <= n_fft


def mel_shape_ok(n_fft: int, hop_length: int, fast_gemm: bool | None = None) -> bool:
    """K1's shape gate in :func:`melspectrogram_fused`: the JAX radix gate's
    shapes (`utils/dispatch.py::radix_shape_ok`, the dense and the fast
    entries) and, in the fast mode (``fast_gemm``; None:
    ``_config.ANALYSIS_FAST_GEMM``, read at call time), K1m's
    (:func:`mixed_shape_ok`), which has no exact mode."""
    if fast_gemm is None:
        fast_gemm = _config.ANALYSIS_FAST_GEMM
    return radix_shape_ok(n_fft, hop_length) or (
        bool(fast_gemm) and mixed_shape_ok(n_fft, hop_length))


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
    order. ``fb_t`` may be a view (a cached table's transpose); the product
    takes it contiguous."""
    frames = windowed_frames(y, win, n_fft, hop_length, center, pad_mode)
    return _contract(rfft_frames(frames, n_fft, basis), fb_t, power, fast_gemm)


def _contract(spec: torch.Tensor, fb_t: torch.Tensor, power: float,
              fast_gemm: bool) -> torch.Tensor:
    """``|spec|^power @ fb_t`` -> ``(B, n_cols, F)``: exact, or (``fast_gemm``)
    as ``hi@hi + hi@lo + lo@hi`` of the bf16 splits."""
    fb_t = fb_t.contiguous()
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


#: the fast entry's plan (`csrc/mel_fused.cu`, "The plan"): header words,
#: then the m-tiles' block offsets and first k-steps, then W^T split
PLAN_MAGIC = 0x4B31BA4D
PLAN_HEADER = 8


def plan_w_offset(n_mt: int) -> int:
    """Word offset of the split W^T in a plan of ``n_mt`` m-tiles (16-byte
    aligned)."""
    return (PLAN_HEADER + 2 * n_mt + 1 + 3) & ~3


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits, rounding to nearest even, as
    ``__float2bfloat16_rn`` and ``torch.bfloat16`` round."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def band_plan_host(w_t: np.ndarray, band: bool = True) -> np.ndarray:
    """The fast entry's plan for the float32 weight ``w_t`` = W^T, ``(n_cols,
    n_bins)``, as int32 words (``csrc/mel_fused.cu``, "The plan"): for each
    m-tile of 16 columns the range of 16-bin k-steps outside which its
    columns are exactly zero (at least one k-step; all of them without
    ``band``, as the launch packs for a W given per call), the blocks before
    each m-tile, and W^T split into bf16 ``hi = bf16(x)``, ``lo = bf16(x -
    hi)``, padded with zeros to whole m-tiles and k-steps, 16 words a
    (column, k-step): for q = 0..3 the words hi(4q, 4q+1), hi(4q+2, 4q+3),
    lo(4q, 4q+1), lo(4q+2, 4q+3), each even bin in the low half."""
    w_t = np.asarray(w_t, np.float32)
    n_cols, n_bins = w_t.shape
    n_mt, ksteps = -(-n_cols // 16), -(-n_bins // 16)
    wp = np.zeros((16 * n_mt, 16 * ksteps), np.float32)
    wp[:n_cols, :n_bins] = w_t
    k0 = np.zeros(n_mt, np.int64)
    k1 = np.full(n_mt, ksteps, np.int64)
    if band:
        live = (wp != 0).reshape(n_mt, 16, ksteps, 16).any(axis=(1, 3))
        for mt, row in enumerate(live):
            ks = np.flatnonzero(row)
            k0[mt], k1[mt] = (ks[0], ks[-1] + 1) if ks.size else (0, 1)
    cum = np.concatenate([[0], np.cumsum(k1 - k0)])
    hi = bf16_bits(wp)
    lo = bf16_bits(wp - (hi.astype(np.uint32) << 16).view(np.float32))
    # (column, k-step, q, pair, half): a word's low half is its even bin
    words = [(b.reshape(16 * n_mt, ksteps, 4, 2, 2).astype(np.uint32) << np.array([0, 16],
              np.uint32)).sum(-1, dtype=np.uint32) for b in (hi, lo)]
    off = plan_w_offset(n_mt)
    plan = np.zeros(off + 16 * n_mt * ksteps * 16, np.uint32)
    plan[:5] = (PLAN_MAGIC, n_cols, n_mt, ksteps, cum[-1])
    plan[PLAN_HEADER:PLAN_HEADER + n_mt + 1] = cum
    plan[PLAN_HEADER + n_mt + 1:PLAN_HEADER + 2 * n_mt + 1] = k0
    plan[off:] = np.concatenate(words, axis=-1).reshape(-1)
    return plan.view(np.int32)


def _table_key(fb_t: torch.Tensor) -> tuple | None:
    """``(cache, args, transposed)`` where ``fb_t`` is a table a
    :class:`TableCache` handed out (``transposed``: that table's transpose,
    as ``table.t()`` views it), else None."""
    origin = table_origin(fb_t)
    if origin is not None:
        return (*origin, False)
    base = fb_t._base
    origin = None if base is None else table_origin(base)
    if origin is None or base.data_ptr() != fb_t.data_ptr() or base.dtype != fb_t.dtype:
        return None
    if fb_t.shape == base.shape and fb_t.stride() == base.stride():
        return (*origin, False)
    if fb_t.shape == base.shape[::-1] and fb_t.stride() == base.stride()[::-1]:
        return (*origin, True)
    return None


def _table_w(cache: TableCache, args: tuple, transposed: bool) -> np.ndarray:
    """The float32 W = fb_t of a cached table, as the device tensor holds it."""
    table = np.asarray(cache.host(*args)).astype(cache.dtype).astype(np.float32)
    return table.T if transposed else table


@table_cache("k1_band_plan", maxsize=_config.FILTERBANK_CACHE_SIZE, dtype=np.int32)
def _band_plan(cache: TableCache, args: tuple, transposed: bool) -> np.ndarray:
    """The fast entry's plan of a cached table, built on the host once per
    table and kept per device beside it."""
    return band_plan_host(_table_w(cache, args, transposed).T)


@table_cache("k1_dense_weight", maxsize=_config.FILTERBANK_CACHE_SIZE)
def _dense_weight(cache: TableCache, args: tuple, transposed: bool) -> np.ndarray:
    """The dense entry's W = fb_t of a cached table, ``(n_bins, n_cols)``
    contiguous, made once per table and device."""
    return np.ascontiguousarray(_table_w(cache, args, transposed))


def fast_plan(fb_t: torch.Tensor) -> tuple[torch.Tensor, np.ndarray] | None:
    """The fast entry's plan of ``fb_t`` on its device and the plan's host
    words, where ``fb_t`` is a cached table or its transpose; None for a W
    given per call, whose plan :func:`plan_of` packs on the device."""
    key = _table_key(fb_t)
    if key is None:
        return None
    return _band_plan(*key, device=fb_t.device), _band_plan.host(*key)


def contracted_blocks(fb_t: torch.Tensor) -> tuple[int, int]:
    """The (m-tile, k-step) blocks the fast entry contracts for ``fb_t`` and
    all of them, ``ceil(n_cols / 16) * ceil(n_bins / 16)``."""
    n_bins, n_cols = fb_t.shape
    every = -(-n_cols // 16) * -(-n_bins // 16)
    plan = fast_plan(fb_t)
    return (every if plan is None else int(plan[1][4])), every


def plan_of(fb_t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The plan the fast entry and K1m read for the CUDA weight ``fb_t``, and
    the blocks it holds: a cached table's band plan (:func:`fast_plan`), or
    for a W given per call a full-range plan packed from W at its strides on
    the current stream."""
    n_bins, n_cols = fb_t.shape
    n_mt, ksteps = -(-n_cols // 16), -(-n_bins // 16)
    planned = fast_plan(fb_t)
    if planned is None:
        plan = torch.empty(plan_w_offset(n_mt) + 256 * n_mt * ksteps, dtype=torch.int32,
                           device=fb_t.device)
        PACK.launch(fb_t.device, fb_t.data_ptr(), *fb_t.stride(), n_bins, n_cols,
                    plan.data_ptr())
        return plan, n_mt * ksteps
    plan, host = planned
    if host[:4].tolist() != [PLAN_MAGIC, n_cols, n_mt, ksteps] or plan.numel() != host.size:
        raise ValueError(f"the plan does not fit W {tuple(fb_t.shape)}: header {tuple(host[:5])}")
    return plan, int(host[4])


def _launch(y, win, fb_t, *, n_fft, hop_length, center, pad_mode, power, fast_gemm):
    require(y, "y", torch.float32, 2)
    require(win, "win", torch.float32, 1)
    if fb_t.device != y.device or fb_t.dtype != torch.float32 or fb_t.dim() != 2:
        raise ValueError(f"fb_t must be a 2-D float32 tensor on {y.device}; got "
                         f"{fb_t.dtype} {tuple(fb_t.shape)} on {fb_t.device}")
    B, L = y.shape
    n_bins, n_cols = fb_t.shape
    if win.shape[0] != n_fft or n_bins != n_fft // 2 + 1:
        raise ValueError(
            f"K1 needs win ({n_fft},) and fb_t ({n_fft // 2 + 1}, n_cols); "
            f"got {tuple(win.shape)} and {tuple(fb_t.shape)}"
        )
    pad = n_fft // 2 if center else 0
    F = 1 + (L + 2 * pad - n_fft) // hop_length
    tw = rfft_twiddles(n_fft, device=y.device)
    out = torch.empty((B, n_cols, F), dtype=torch.float32, device=y.device)
    ptrs = (y.data_ptr(), L, win.data_ptr(), tw.data_ptr())
    shape = (B, n_fft, hop_length, F, n_cols, pad, PAD_CODES[pad_mode], int(power))
    if not fast_gemm:
        key = _table_key(fb_t)
        w = fb_t if key is None else _dense_weight(*key, device=y.device)
        require(w, "fb_t", torch.float32, 2)
        KERNEL.launch(y.device, *ptrs, w.data_ptr(), out.data_ptr(), *shape)
        return out
    plan, blocks = plan_of(fb_t)
    if radix_shape_ok(n_fft, hop_length):
        KERNEL_FAST.launch(y.device, *ptrs, plan.data_ptr(), out.data_ptr(), *shape[:5], blocks,
                           *shape[5:])
    else:
        KERNEL_MIXED.launch(y.device, *ptrs, plan.data_ptr(), out.data_ptr(), *shape)
    return out


@traced("kernels.melspectrogram_fused")
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
    """``(B, L) -> (B, n_cols, F)`` through K1 on a CUDA tensor, through the
    chosen entry's plain twin on a CPU tensor.

    Requires K1's gate (:func:`mel_shape_ok`) and ``power`` in {1, 2}; any
    window and any dense ``fb_t`` (the contraction walks ``ceil(n_cols /
    16)`` column tiles, so shared memory does not grow with the columns and
    time follows them). ``fast_gemm`` (None: ``_config.ANALYSIS_FAST_GEMM``,
    read at call time; True by default) takes the fast entry,
    ``mel_fused_fast_kernel``, on the radix gate and K1m,
    ``mel_fused_mixed_kernel``, off it: ~1e-5 of max of an exact product;
    False the dense entry, within ~1e-6. Under both the backward
    differentiates the exact plain twin."""
    if fast_gemm is None:
        fast_gemm = _config.ANALYSIS_FAST_GEMM
    if not mel_shape_ok(n_fft, hop_length, fast_gemm):
        raise ValueError(
            f"fused mel kernel requires pow2 n_fft = C*hop, hop = R2*128, C,R2 <= 8, or in the "
            f"fast mode n_fft in {MIXED_N_FFTS} and n_fft/8 <= hop <= n_fft; got n_fft={n_fft}, "
            f"hop={hop_length}, fast_gemm={bool(fast_gemm)}"
        )
    if power not in (1.0, 2.0):
        raise ValueError(f"fused mel kernel supports power in {{1, 2}}, got {power}")
    pad_total = n_fft if center else 0
    if y.shape[1] + pad_total < n_fft:
        raise ValueError(
            f"signal length ({y.shape[1]}) must be >= n_fft ({n_fft}) when center=False"
        )
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode,
              power=float(power))
    if on_cuda(y, win, fb_t):
        forward = partial(_launch, fast_gemm=bool(fast_gemm))
    elif not radix_shape_ok(n_fft, hop_length):
        forward = melspectrogram_mixed_plain
    elif fast_gemm:
        forward = partial(melspectrogram_plain, fast_gemm=True)
    else:
        return melspectrogram_plain(y, win, fb_t, **kw)
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


@traced("kernels.acf_fused")
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


# ---------------------------------------------------------------------------
# K1m, the mixed-radix entry


def mixed_radices(m: int) -> list[int]:
    """The passes of the complex FFT of ``m = 2^a * 5^b`` points, as
    `csrc/fft_common.cuh::mixed_radix` orders them: the radix-5 passes, then
    the power of two in radix-8 passes, the first taking what is left."""
    fives, rest = 0, m
    while rest % 5 == 0:
        rest //= 5
        fives += 1
    log2 = rest.bit_length() - 1
    if rest != 1 << log2:
        raise ValueError(f"the mixed passes need m = 2^a * 5^b, got {m}")
    n8 = (log2 + 2) // 3
    return [5] * fives + ([1 << (log2 - 3 * (n8 - 1))] if n8 else []) + [8] * max(n8 - 1, 0)


def mixed_positions(m: int) -> np.ndarray:
    """Where bin k of the passes' transform sits after the last pass
    (`fft_common.cuh::mixed_pos`): k's digits q_p (``mixed_radices`` order,
    least significant first) at the passes' strides S_p."""
    pos, k, span = np.zeros(m, np.int64), np.arange(m), m
    for r in mixed_radices(m):
        span //= r
        pos += (k % r) * span
        k //= r
    return pos


def mixed_fft(z: torch.Tensor) -> torch.Tensor:
    """The complex DFT over the last axis of ``z`` (``m = 2^a * 5^b``
    points) as K1m computes it: in-place decimation-in-frequency passes
    (pass p: the radix-R DFT of the points at stride S, output q of offset i
    times W_{RS}^{iq}), then the digit-reversed result read in natural
    order. Tables in float64, rounded once."""
    m, lead = z.shape[-1], z.shape[:-1]
    span = m
    for r in mixed_radices(m):
        s = span // r
        q = np.arange(r)
        dft = torch.from_numpy(np.exp(-2j * np.pi * np.outer(q, q) / r)).to(z)
        tw = torch.from_numpy(np.exp(-2j * np.pi * np.outer(q, np.arange(s)) / (r * s))).to(z)
        x = z.reshape(*lead, m // (r * s), r, s)
        z = (torch.einsum("...rs,rq->...qs", x, dft) * tw).reshape(*lead, m)
        span = s
    return z[..., torch.from_numpy(mixed_positions(m)).to(z.device)]


def melspectrogram_mixed_plain(
    y: torch.Tensor,  # (B, L)
    win: torch.Tensor,  # (n_fft,) padded window
    fb_t: torch.Tensor,  # (n_bins, n_cols)
    *,
    n_fft: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
    power: float = 2.0,
) -> torch.Tensor:
    """Plain twin of K1m: pad, frame, window; the real FFT as K1m takes it
    (the complex FFT of the packed points ``x[2n] + i x[2n+1]`` by
    :func:`mixed_fft`, then ``X[k] = E[k] + W_N^k O[k]`` from ``Z[k]`` and
    ``conj Z[M-k]``); ``|X|^power``; the fast entry's bf16x3 contraction ->
    ``(B, n_cols, F)``."""
    frames = windowed_frames(y, win, n_fft, hop_length, center, pad_mode)
    m = n_fft // 2
    z = mixed_fft(torch.complex(frames[..., 0::2].contiguous(), frames[..., 1::2].contiguous()))
    k = torch.arange(m + 1, device=z.device)
    a, c = z[..., k % m], z[..., (m - k) % m].conj()
    tw = rfft_twiddles(n_fft, device=frames.device)
    w = torch.complex(tw[:, 0], tw[:, 1])
    spec = 0.5 * (a + c) + w * ((a - c) * -0.5j)
    return _contract(spec, fb_t, power, fast_gemm=True)
