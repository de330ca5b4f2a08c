"""K3: the fused ISTFT, as a CUDA kernel and its plain twin.

Counterpart of `mlx_audio_primitives_tpu/kernels/istft_fused.py`: complex
``(B, F, n_bins)`` spectrum, padded synthesis window and clamped
squared-window envelope -> ``(B, padded_length)``, the inverse rDFT,
window, overlap-add and envelope divide in one kernel.

Source note (`csrc/istft_fused.cu`, ``istft_kernel``). Replaces
``istft_pallas`` (its ``pallas_call`` in ``_istft_grouped_core``). The JAX
package's transposed and natural intakes (``istft_pallas_t``,
``istft_pallas_nat``) compute the same function from other layouts; this
kernel reads the spectrum through its strides, so it takes the
``(B, F, n_bins)`` transpose of the public ``(B, n_bins, F)`` spectrum in
place: there is no swapaxes copy and no group-layout gather. One block owns
RB output hop-rows of one clip and walks the RB + C - 1 frames that cover
them in batches: inverse FP32 FFT in shared memory (the real-input split of
`csrc/fft_common.cuh` run backwards), synthesis window, then each thread
adds the frames into the output samples it owns in a shared-memory tile,
so there are no atomics. The frames shared by neighbouring blocks are
recomputed, (C-1)/RB extra inverse FFTs (3/8 at n_fft 2048, hop 512).
Imaginary parts of the DC and Nyquist bins are dropped, as irfft does.

What bounds it on this card: the inverse FFT's shared-memory butterflies,
times the (RB + C - 1)/RB recompute; its bytes are one read of the
spectrum (8 bytes per bin per frame) and one write of the output. The
design keeps time-domain frames out of device memory entirely.
"""

from __future__ import annotations

import torch

from .._config import COMPLEX_DTYPE
from ..utils.dispatch import on_cuda, radix_shape_ok
from ._build import I32, I64, MAX_BATCH, Kernel, P, register, require, with_plain_backward
from .dft import irfft_frames, rfft_twiddles
from .overlap_add import overlap_add_plain

KERNEL = register(Kernel(
    "istft_kernel", "istft_launch",
    (P, I64, I64, I64, P, P, P, I64, P, I32, I32, I32, I32, I64),
    source="mlx_audio_primitives_tpu_torch/csrc/istft_fused.cu",
    replaces="mlx_audio_primitives_tpu/kernels/istft_fused.py:417",
))


def istft_plain(
    S: torch.Tensor,  # (B, F, n_bins) complex
    win: torch.Tensor,  # (n_fft,) padded synthesis window
    env: torch.Tensor,  # (padded_length,) clamped squared-window envelope
    *,
    n_fft: int,
    hop_length: int,
    padded_length: int,
    basis: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain twin and plain composition: irfft (or the inverse-basis GEMM),
    window, overlap-add, envelope divide -> ``(B, padded_length)``."""
    frames = irfft_frames(S, n_fft, basis) * win
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
    if B > MAX_BATCH:
        raise ValueError(f"istft_kernel takes at most {MAX_BATCH} clips, got {B}")
    tw = rfft_twiddles(n_fft, device=S.device)
    out = torch.empty((B, padded_length), dtype=torch.float32, device=S.device)
    sb, sf, sk = S.stride()
    KERNEL.launch(S.device, S.data_ptr(), sb, sf, sk, win.data_ptr(), tw.data_ptr(),
                  env.data_ptr(), env.shape[0], out.data_ptr(), B, n_fft, hop_length, F,
                  padded_length)
    return out


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
