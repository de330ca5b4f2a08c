"""K3: the fused ISTFT, as a CUDA kernel and its plain twin.

Counterpart of `mlx_audio_primitives_tpu/kernels/istft_fused.py`: complex
``(B, F, n_bins)`` spectrum, padded synthesis window and clamped
squared-window envelope -> ``(B, padded_length)``, the inverse rDFT,
window, overlap-add and envelope divide in one kernel.

Source note (`csrc/istft_fused.cu`, ``istft_kernel``). Replaces
``istft_pallas`` (its ``pallas_call`` in ``_istft_grouped_core``). The JAX
package's transposed and natural intakes (``istft_pallas_t``, its
``pallas_call`` in ``_istft_t_core``, and ``istft_pallas_nat``, in
``_istft_nat_core``) compute the same function from the natural
``(B, n_bins, F)`` spectrum; this kernel reads the spectrum through its
strides, so :func:`istft_fused_t` and :func:`istft_fused_nat` hand it the
``(B, F, n_bins)`` transpose of that spectrum in place: there is no
swapaxes copy and no group-layout gather. Frames that start at or past the
output's end add nothing and are never read, which is what the JAX entries'
frame trim does. The JAX group-layout entry ``istft_pallas_grouped_t``
takes a TPU layout that has no counterpart here. Imaginary parts of the DC
and Nyquist bins are dropped, as irfft does.

The inverse real FFT runs as the forward register-resident FFT of
`csrc/fft_common.cuh` (K2's passes and K2's tile of frames) on
``Y = conj(Z) / M``, the packed spectrum conjugated:
``IFFT_M(Z) = conj(FFT_M(conj Z)) / M``. Its first pass takes the bins
straight from the spectrum into registers, frames fastest across a warp
(16 frames of a bin, one 128-byte line, up to n_fft 2048), one thread
owning the bin pairs ``k``, ``M - k``. A block walks a span of output
hop-rows in tiles of frames: each tile completes the hop-rows its frames
start and carries the partial sums of the ``C - 1`` rows after them to the
next tile, so only a span's first tile recomputes frames (the ``C - 1``
before its first row). The overlap-add reads the transforms in
digit-reversed order, the window from shared memory, and divides by the
envelope in the same pass. :func:`launch_plan` gives the launch geometry
and the recompute share.

What bounds it on this card: its bytes, one read of the spectrum (8 bytes
per bin per frame) and one write of the output; the FFT (~5 GFLOP at
64 x 30 s) has to hide behind them, and does only in part: the spectrum's
loads are not prefetched (PERF.md). Time-domain frames never reach device
memory.
"""

from __future__ import annotations

import ctypes

import torch

from .._config import COMPLEX_DTYPE
from ..utils.dispatch import on_cuda, radix_shape_ok
from ..utils.profiler import traced
from ._build import I32, I64, Kernel, P, library, register, require, with_plain_backward
from .dft import irfft_frames, rfft_twiddles
from .overlap_add import overlap_add_plain

KERNEL = register(Kernel(
    "istft_kernel", "istft_launch",
    (P, I64, I64, I64, P, P, P, I64, P, I32, I32, I32, I32, I64),
    source="mlx_audio_primitives_tpu_torch/csrc/istft_fused.cu",
    replaces="mlx_audio_primitives_tpu/kernels/istft_fused.py:417",
))


def frames_transformed(B: int, rows: int, F: int, C: int, frames_per_tile: int,
                       span: int) -> tuple[int, int]:
    """The frames the kernel reads and the frame slots it transforms for B
    clips of ``rows`` hop-rows and F frames when each block takes ``span``
    global rows: every run of a block's rows within one clip, [r0, r1), is
    walked in tiles of ``frames_per_tile`` frames from frame
    ``max(0, r0 - (C-1))``, and frames at or past ``min(F, r1)`` are not
    read."""
    loaded = slots = 0
    total = B * rows
    for cur in range(0, total, span):
        end = min(total, cur + span)
        while cur < end:
            r0 = cur % rows
            r1 = min(rows, r0 + end - cur)
            cur += r1 - r0
            fa = max(0, r0 - (C - 1))
            tiles = -(-(r1 - fa) // frames_per_tile)
            slots += tiles * frames_per_tile
            loaded += max(0, min(F, r1) - fa)
    return loaded, slots


def launch_plan(n_fft: int, hop_length: int, B: int, F: int, padded_length: int,
                device: torch.device) -> dict:
    """The launch of ``istft_kernel`` for B clips of F frames and
    ``padded_length`` samples on a CUDA ``device``: threads per block,
    frames per tile, dynamic shared memory per block (bytes), resident
    blocks per SM, grid, span (hop-rows a block), and the recompute share:
    frames read beyond the ``B * min(F, rows)`` the output needs, and frame
    slots transformed beyond them, each as a share of that need."""
    fn = library().istft_plan
    fn.argtypes = [I32, I32, I32, I64, I32, P]
    fn.restype = I32
    info = (ctypes.c_longlong * 6)()
    err = fn(n_fft, hop_length, B, padded_length, device.index, ctypes.cast(info, P))
    if err != 0:
        raise RuntimeError(f"istft_plan failed: CUDA error {err}")
    rows = -(-padded_length // hop_length)
    C = n_fft // hop_length
    loaded, slots = frames_transformed(B, rows, F, C, info[1], info[5])
    need = B * min(F, rows)
    return dict(threads=info[0], frames_per_tile=info[1], smem_bytes=info[2],
                blocks_per_sm=info[3], grid=info[4], span=info[5],
                recompute_loaded=loaded / need - 1, recompute_slots=slots / need - 1)


def istft_plain(
    S: torch.Tensor,  # (B, F, n_bins) complex
    win: torch.Tensor,  # (n_fft,) padded synthesis window
    env: torch.Tensor,  # (padded_length,) clamped squared-window envelope
    *,
    n_fft: int,
    hop_length: int,
    padded_length: int,
    basis: torch.Tensor | None = None,
    owned: bool = False,
) -> torch.Tensor:
    """Plain twin and plain composition: irfft (or the inverse-basis GEMM),
    window, overlap-add, envelope divide -> ``(B, padded_length)``.
    ``owned`` as in :func:`.dft.irfft_len`."""
    frames = irfft_frames(S, n_fft, basis, owned=owned) * win
    return overlap_add_plain(frames, env, hop_length=hop_length, output_length=padded_length)


def _launch(S, win, env, *, n_fft, hop_length, padded_length):
    if S.device.type != "cuda" or S.dtype != COMPLEX_DTYPE or S.dim() != 3 or S.is_conj():
        raise ValueError(
            f"istft_kernel needs a (B, F, n_bins) complex64 CUDA tensor without a "
            f"lazy conjugate; got {S.dtype} {tuple(S.shape)} on {S.device}"
        )
    require(win, "win", torch.float32, 1)
    require(env, "env", torch.float32, 1)
    B, F, n_bins = S.shape
    if win.shape[0] != n_fft or n_bins != n_fft // 2 + 1:
        raise ValueError(
            f"istft_kernel needs win ({n_fft},) and {n_fft // 2 + 1} bins; "
            f"got {tuple(win.shape)} and {n_bins}"
        )
    tw = rfft_twiddles(n_fft, device=S.device)
    out = torch.empty((B, padded_length), dtype=torch.float32, device=S.device)
    sb, sf, sk = S.stride()
    KERNEL.launch(S.device, S.data_ptr(), sb, sf, sk, win.data_ptr(), tw.data_ptr(),
                  env.data_ptr(), env.shape[0], out.data_ptr(), B, n_fft, hop_length, F,
                  padded_length)
    return out


@traced("kernels.istft_fused")
def istft_fused(
    S: torch.Tensor,
    win: torch.Tensor,
    env: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    padded_length: int,
) -> torch.Tensor:
    """``(B, F, n_bins) -> (B, padded_length)`` through ``istft_kernel`` on
    a CUDA tensor, through the plain twin on a CPU tensor. ``S`` may have
    any strides. The backward differentiates the plain twin."""
    if not radix_shape_ok(n_fft, hop_length):
        raise ValueError(
            f"fused ISTFT kernel requires pow2 n_fft = C*hop, hop = R2*128, "
            f"C,R2 <= 8; got n_fft={n_fft}, hop={hop_length}"
        )
    if padded_length < 1:
        # degenerate empty output (e.g. istft length=0), as in the JAX kernel
        return torch.zeros((S.shape[0], max(padded_length, 0)), device=S.device)
    kw = dict(n_fft=n_fft, hop_length=hop_length, padded_length=padded_length)
    if not on_cuda(S, win, env):
        return istft_plain(S, win, env, **kw)
    return with_plain_backward(_launch, istft_plain, S, win, env, **kw)


def istft_fused_t(
    S: torch.Tensor,  # (B, n_bins, F) natural spectrum, frames minor
    win: torch.Tensor,
    env: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    padded_length: int,
    fast_gemm: bool = False,
    kara: bool = False,
) -> torch.Tensor:
    """``(B, n_bins, F) -> (B, padded_length)``, the counterpart of
    ``istft_pallas_t``: ``istft_kernel`` on the natural spectrum through its
    strides (no copy). The kernel computes an FP32 inverse FFT with no GEMM,
    so ``fast_gemm`` and ``kara`` (the TPU kernel's modes for its DFT GEMMs:
    bf16 splits, the Karatsuba complex base) have nothing to change: they
    are accepted and unused."""
    del fast_gemm, kara
    return istft_fused(S.transpose(1, 2), win, env, n_fft=n_fft, hop_length=hop_length,
                       padded_length=padded_length)


def istft_fused_nat(
    S: torch.Tensor,  # (B, n_bins, F) natural spectrum, frames minor
    win: torch.Tensor,
    env: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    padded_length: int,
    kara: bool = True,
) -> torch.Tensor:
    """The counterpart of ``istft_pallas_nat``: the same function and the
    same launch as :func:`istft_fused_t`; ``kara`` is accepted and changes
    nothing."""
    return istft_fused_t(S, win, env, n_fft=n_fft, hop_length=hop_length,
                         padded_length=padded_length, kara=kara)
