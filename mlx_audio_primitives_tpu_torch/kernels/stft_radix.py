"""K2: the fused STFT, and K2m, its magnitude emit, as CUDA kernels and
their plain twins.

Counterpart of `mlx_audio_primitives_tpu/kernels/stft_radix.py` (the module
keeps that name so the two are easy to pair; the port's kernel is a
register-resident FFT, not the TPU's radix-decimated DFT): ``(B, L)``
signal and padded window -> complex64 ``(B, n_bins, F)``.

Source note (`csrc/stft.cu`, ``stft_kernel``). Replaces ``stft_pallas``:
both TPU cores, the grouped emit (``pallas_call`` in ``_stft_radix_core``)
and the transposed emit (``pallas_call`` in ``_stft_radix_core_t``), and
the gathers that naturalize their layouts, become one kernel that writes
natural bin order; each bin goes to the output interleaved (re, im), which
``torch.view_as_real`` of the complex64 output receives. What bounds it on
this card: the output write, 8 bytes per bin per frame, 4x the input it
reads, against 2.5*n_fft*log2(n_fft) flops per frame. The design keeps the
FFT off the critical path of the stores: the register-resident front end
of `csrc/fft_common.cuh` (16 points per thread, in-place radix-8/16
passes, one shared-memory exchange and one barrier of the frame's threads
between passes, per-pass twiddle tables staged once per block from the
float64 host table), 16-frame tiles stored frames fastest, and a
persistent grid whose blocks copy the next tile's signal segment with
``cp.async`` while the current one is stored.
`tests/test_torch_port_stft_plan.py` models the passes' index maps.

K2m (``stft_mag_kernel``, the same source) replaces
``stft_magnitude_pallas``, which reaches the same two TPU cores and
naturalizes magnitudes instead of complex bins. It is K2 with one change at
the end: each bin is written as ``sqrt(re^2 + im^2)`` in float32. Bound by
the same output write, now 4 bytes per bin per frame: at 64 x 30 s clips
(n_fft 2048, hop 512) 169 MB in and 339 MB out, 0.15 ms at 3.35 TB/s,
against ~5 GFLOP of FFT, 0.08 ms at the FP32 peak.

K2s (``stft_stats_kernel``, the same source) is the third emit: one
per-frame statistic of the magnitude, chosen at launch: spectral bandwidth
(p 1 or 2), rolloff or flatness (power 1 or 2), :func:`stft_stats_fused`.
It replaces no TPU kernel: the JAX package computes the three features
with XLA over a magnitude spectrogram, and the port ran K2m and then ~30
PyTorch passes over its 339 MB output at 64 x 30 s. K2s forms the same
float32 magnitudes, reduces each frame on chip and writes one float a
frame. Bound: y read once and 4 bytes a frame written (~0.05 ms at 64 x
30 s), so by the FFT front end it shares with K2 and K2m. The layout of the
reduction is in the source note. Its twin, :func:`stft_stats_plain`, is
K2m's twin and the plain route's per-frame formulas in torch.
"""

from __future__ import annotations

import ctypes

import torch

from .._config import COMPLEX_DTYPE
from ..ops._frames import windowed_frames
from ..utils.dispatch import on_cuda, radix_shape_ok
from ..utils.profiler import traced
from ._build import F32, I32, I64, Kernel, P, library, register, require, with_plain_backward
from .dft import rfft_frames, rfft_twiddles
from .mel_fused import PAD_CODES

KERNEL = register(Kernel(
    "stft_kernel", "stft_launch",
    (P, I64, P, P, P, I32, I32, I32, I32, I32, I32),
    source="mlx_audio_primitives_tpu_torch/csrc/stft.cu",
    # also the transposed-emit core's pallas_call at :390 (see the note above)
    replaces="mlx_audio_primitives_tpu/kernels/stft_radix.py:624",
))

KERNEL_MAG = register(Kernel(
    "stft_mag_kernel", "stft_mag_launch",
    (P, I64, P, P, P, I32, I32, I32, I32, I32, I32),
    source="mlx_audio_primitives_tpu_torch/csrc/stft.cu",
    # stft_magnitude_pallas (:128) reaches the pallas_calls at :624 and :390
    replaces="mlx_audio_primitives_tpu/kernels/stft_radix.py:128",
))

#: K2s: no TPU kernel; the JAX package's XLA bandwidth, rolloff and flatness
KERNEL_STATS = register(Kernel(
    "stft_stats_kernel", "stft_stats_launch",
    (P, I64, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32, F32),
    source="mlx_audio_primitives_tpu_torch/csrc/stft.cu",
    replaces="mlx_audio_primitives_tpu/ops/features.py:160",
))

#: K2s's statistics, by the code its launcher takes
STATS = {"bandwidth": 0, "rolloff": 1, "flatness": 2}


def launch_geometry(n_fft: int, hop_length: int, device: torch.device) -> dict:
    """K2/K2m/K2s's launch at ``(n_fft, hop_length)`` on a CUDA ``device``:
    threads per block, frames per tile, dynamic shared memory per block
    (bytes) and resident blocks per SM of each emit."""
    fn = library().stft_geometry
    fn.argtypes = [I32, I32, I32, P]
    fn.restype = I32
    info = (ctypes.c_int * 6)()
    err = fn(n_fft, hop_length, device.index, ctypes.cast(info, P))
    if err != 0:
        raise RuntimeError(f"stft_geometry failed: CUDA error {err}")
    return dict(threads=info[0], frames_per_tile=info[1], smem_bytes=info[2],
                blocks_per_sm={KERNEL.name: info[3], KERNEL_MAG.name: info[4],
                               KERNEL_STATS.name: info[5]})


def stft_plain(
    y: torch.Tensor,  # (B, L)
    win: torch.Tensor,  # (n_fft,) padded window
    *,
    n_fft: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
    basis: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain twin and plain composition: pad, frame, window, rfft (or the
    forward-basis GEMM) -> complex64 ``(B, n_bins, F)``."""
    frames = windowed_frames(y, win, n_fft, hop_length, center, pad_mode)
    return rfft_frames(frames, n_fft, basis).transpose(1, 2)


def stft_magnitude_plain(
    y: torch.Tensor, win: torch.Tensor, *, n_fft: int, hop_length: int, center: bool,
    pad_mode: str,
) -> torch.Tensor:
    """Plain twin and plain composition of K2m: ``|rfft(window * frames)|``
    -> float32 ``(B, n_bins, F)``."""
    return stft_plain(y, win, n_fft=n_fft, hop_length=hop_length, center=center,
                      pad_mode=pad_mode).abs()


def _launcher(kernel: Kernel, dtype: torch.dtype):
    def launch(y, win, *, n_fft, hop_length, center, pad_mode):
        require(y, "y", torch.float32, 2)
        require(win, "win", torch.float32, 1)
        if win.shape[0] != n_fft:
            raise ValueError(f"{kernel.name} needs a ({n_fft},) window, got {tuple(win.shape)}")
        B, L = y.shape
        pad = n_fft // 2 if center else 0
        F = 1 + (L + 2 * pad - n_fft) // hop_length
        tw = rfft_twiddles(n_fft, device=y.device)
        out = torch.empty((B, n_fft // 2 + 1, F), dtype=dtype, device=y.device)
        kernel.launch(y.device, y.data_ptr(), L, win.data_ptr(), tw.data_ptr(), out.data_ptr(),
                      B, n_fft, hop_length, F, pad, PAD_CODES[pad_mode])
        return out

    return launch


_launch = _launcher(KERNEL, COMPLEX_DTYPE)
_launch_mag = _launcher(KERNEL_MAG, torch.float32)


def _check(y: torch.Tensor, n_fft: int, hop_length: int, center: bool) -> None:
    if not radix_shape_ok(n_fft, hop_length):
        raise ValueError(
            f"fused STFT kernel requires pow2 n_fft = C*hop, hop = R2*128, "
            f"C,R2 <= 8; got n_fft={n_fft}, hop={hop_length}"
        )
    pad_total = n_fft if center else 0
    if y.shape[1] + pad_total < n_fft:
        raise ValueError(
            f"signal length ({y.shape[1]}) must be >= n_fft ({n_fft}) when center=False"
        )


@traced("kernels.stft_fused")
def stft_fused(
    y: torch.Tensor,
    win: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
) -> torch.Tensor:
    """``(B, L) -> complex64 (B, n_bins, F)`` through ``stft_kernel`` on a
    CUDA tensor, through the plain twin on a CPU tensor. The backward
    differentiates the plain twin."""
    _check(y, n_fft, hop_length, center)
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode)
    if not on_cuda(y, win):
        return stft_plain(y, win, **kw)
    return with_plain_backward(_launch, stft_plain, y, win, **kw)


@traced("kernels.stft_magnitude_fused")
def stft_magnitude_fused(
    y: torch.Tensor,
    win: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
    fast_gemm: bool | None = None,
) -> torch.Tensor:
    """``(B, L) -> float32 (B, n_bins, F)`` magnitudes through
    ``stft_mag_kernel`` on a CUDA tensor, through the plain twin on a CPU
    tensor; the counterpart of ``stft_magnitude_pallas``. The kernel
    computes an FP32 FFT with no GEMM, so ``fast_gemm`` (the TPU kernel's
    bf16-split mode for its DFT GEMMs) has nothing to change: it is accepted
    and unused. The backward differentiates the plain twin."""
    del fast_gemm
    _check(y, n_fft, hop_length, center)
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode)
    if not on_cuda(y, win):
        return stft_magnitude_plain(y, win, **kw)
    return with_plain_backward(_launch_mag, stft_magnitude_plain, y, win, **kw)


def stft_stats_plain(
    y: torch.Tensor,
    win: torch.Tensor,
    freq: torch.Tensor | None = None,
    *,
    stat: str,
    n_fft: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
    p: float = 2.0,
    norm: bool = True,
    roll_percent: float = 0.85,
    power: float = 2.0,
    amin: float = 1e-10,
) -> torch.Tensor:
    """Plain twin and plain composition of K2s: K2m's twin, then ``stat``'s
    per-frame formula in the plain route's torch operations -> float32
    ``(B, 1, F)``. ``freq`` holds one value per bin (bandwidth and rolloff;
    flatness reads none)."""
    S = stft_magnitude_plain(y, win, n_fft=n_fft, hop_length=hop_length, center=center,
                             pad_mode=pad_mode)
    if stat == "bandwidth":
        total = torch.sum(S, dim=1, keepdim=True) + 1e-10
        centroid = torch.sum(freq[:, None] * S, dim=1, keepdim=True) / total
        deviation = torch.abs(freq[None, :, None] - centroid)
        weighted = torch.sum(S * torch.pow(deviation, p), dim=1, keepdim=True)
        if norm:
            weighted = weighted / total
        return torch.pow(weighted, 1.0 / p)
    if stat == "rolloff":
        cumsum = torch.cumsum(S, dim=1)
        # argmax returns the first maximum: the first bin at or above threshold
        idx = torch.argmax((cumsum >= roll_percent * cumsum[:, -1:, :]).to(torch.uint8), dim=1)
        return freq[idx][:, None, :]
    if power != 1.0:
        S = torch.pow(S, power)
    S = torch.clamp(S, min=amin)
    gmean = torch.pow(10.0, torch.mean(torch.log10(S), dim=1, keepdim=True))
    return gmean / (torch.mean(S, dim=1, keepdim=True) + 1e-10)


def stats_power_ok(p: float = 2.0, power: float = 2.0, **_) -> bool:
    """Whether K2s takes a statistic's exponents (:func:`stft_stats_fused`'s
    keywords): bandwidth's ``p`` and flatness's ``power`` in {1, 2}."""
    return p in (1.0, 2.0) and power in (1.0, 2.0)


def _launch_stats(y, win, freq=None, *, stat, n_fft, hop_length, center, pad_mode, p=2.0,
                  norm=True, roll_percent=0.85, power=2.0, amin=1e-10):
    require(y, "y", torch.float32, 2)
    require(win, "win", torch.float32, 1)
    if win.shape[0] != n_fft:
        raise ValueError(f"{KERNEL_STATS.name} needs a ({n_fft},) window, got {tuple(win.shape)}")
    if freq is not None:
        require(freq, "freq", torch.float32, 1)
        if freq.shape[0] != n_fft // 2 + 1:
            raise ValueError(f"{KERNEL_STATS.name} needs one freq a bin ({n_fft // 2 + 1}), "
                             f"got {freq.shape[0]}")
    B, L = y.shape
    pad = n_fft // 2 if center else 0
    F = 1 + (L + 2 * pad - n_fft) // hop_length
    exponent, a = {"bandwidth": (p, float(norm)), "rolloff": (1.0, roll_percent),
                   "flatness": (power, amin)}[stat]
    tw = rfft_twiddles(n_fft, device=y.device)
    out = torch.empty((B, 1, F), dtype=torch.float32, device=y.device)
    KERNEL_STATS.launch(y.device, y.data_ptr(), L, win.data_ptr(), tw.data_ptr(),
                        None if freq is None else freq.data_ptr(), out.data_ptr(), B, n_fft,
                        hop_length, F, pad, PAD_CODES[pad_mode], STATS[stat], int(exponent), a)
    return out


@traced("kernels.stft_stats_fused")
def stft_stats_fused(
    y: torch.Tensor,
    win: torch.Tensor,
    freq: torch.Tensor | None = None,
    *,
    stat: str,
    n_fft: int,
    hop_length: int,
    center: bool,
    pad_mode: str,
    p: float = 2.0,
    norm: bool = True,
    roll_percent: float = 0.85,
    power: float = 2.0,
    amin: float = 1e-10,
) -> torch.Tensor:
    """``(B, L) -> float32 (B, 1, F)``: per frame, the magnitude's spectral
    bandwidth (``p`` 1 or 2, ``norm``; ``freq`` one value per bin), rolloff
    (``roll_percent``; ``freq``) or flatness (``power`` 1 or 2, ``amin``),
    through ``stft_stats_kernel`` on a CUDA tensor, through the plain twin
    on a CPU tensor. The backward differentiates the plain twin; rolloff, a
    bin's frequency, passes a gradient to ``freq`` only, as the plain route
    does."""
    if stat not in STATS:
        raise ValueError(f"stat must be one of {sorted(STATS)}, got {stat!r}")
    if (freq is None) != (stat == "flatness"):
        raise ValueError(f"{stat} takes {'no freq' if stat == 'flatness' else 'a freq'}")
    if not stats_power_ok(p, power):
        raise ValueError(f"{KERNEL_STATS.name} takes p and power in {{1, 2}}, got p={p}, "
                         f"power={power}")
    _check(y, n_fft, hop_length, center)
    kw = dict(stat=stat, n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode,
              p=p, norm=norm, roll_percent=roll_percent, power=power, amin=amin)
    tensors = (y, win) if freq is None else (y, win, freq)
    if not on_cuda(*tensors):
        return stft_stats_plain(*tensors, **kw)
    if stat == "rolloff":
        tensors = (y.detach(), win.detach(), freq)
    return with_plain_backward(_launch_stats, stft_stats_plain, *tensors, **kw)
