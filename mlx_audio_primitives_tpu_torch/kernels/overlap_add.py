"""K4: overlap-add with the envelope divide, as a CUDA kernel and its plain
twin.

Counterpart of `mlx_audio_primitives_tpu/kernels/overlap_add.py`.

Source note (`csrc/overlap_add.cu`, ``overlap_add_kernel``). Replaces
``overlap_add_pallas`` (its ``pallas_call`` in ``_pallas_forward``). On
this card it is bound by device-memory bytes: it reads every frame sample
once and writes every output sample once, about ``4*B*(F*n_fft + T)``
bytes, against at most C = ceil(n_fft/hop) adds per output sample. The
design spends nothing but those bytes: one thread per output sample sums
the frames that cover it (neighbouring threads read neighbouring samples of
one frame, so the reads coalesce) and divides by the envelope; there is no
staging, no atomics and no padded copy of the frames. The TPU kernel's
lane rotations, zero-frame prepad and VMEM block picker have no
counterpart.
"""

from __future__ import annotations

import torch

from ..ops._frames import cdiv, overlap_add
from ..utils.dispatch import on_cuda
from ._build import I32, I64, MAX_BATCH, Kernel, P, register, require, with_plain_backward

# Bound on C = ceil(n_fft/hop), the JAX kernel's gate (there it bounds the
# statically unrolled chunk adds; kept so both packages route alike).
_MAX_CHUNKS = 64

KERNEL = register(Kernel(
    "overlap_add_kernel", "overlap_add_launch",
    (P, P, I64, P, I32, I32, I32, I32, I64),
    source="mlx_audio_primitives_tpu_torch/csrc/overlap_add.cu",
    replaces="mlx_audio_primitives_tpu/kernels/overlap_add.py:187",
))


def ola_supported(n_fft: int, hop_length: int) -> bool:
    """The JAX kernel's gate without its VMEM term: C <= 64 chunks."""
    return hop_length >= 1 and cdiv(n_fft, hop_length) <= _MAX_CHUNKS


def overlap_add_plain(
    fw: torch.Tensor, env: torch.Tensor, *, hop_length: int, output_length: int
) -> torch.Tensor:
    """Plain twin: overlap-add, then divide by ``env`` (1.0 past its end)."""
    y = overlap_add(fw, hop_length, output_length)
    e = env[:output_length]
    if e.shape[0] < output_length:
        e = torch.nn.functional.pad(e, (0, output_length - e.shape[0]), value=1.0)
    return y / e


def _launch(fw: torch.Tensor, env: torch.Tensor, *, hop_length: int,
            output_length: int) -> torch.Tensor:
    require(fw, "fw", torch.float32, 3)
    require(env, "env", torch.float32, 1)
    B, F, n_fft = fw.shape
    if B > MAX_BATCH:
        raise ValueError(f"overlap_add_kernel takes at most {MAX_BATCH} clips, got {B}")
    out = torch.empty((B, output_length), dtype=torch.float32, device=fw.device)
    KERNEL.launch(fw.device, fw.data_ptr(), env.data_ptr(), env.shape[0], out.data_ptr(),
                  B, F, n_fft, hop_length, output_length)
    return out


def overlap_add_fused(
    fw: torch.Tensor,  # (B, F, n_fft) windowed frames
    env: torch.Tensor,  # (>= output_length,) clamped squared-window envelope
    *,
    hop_length: int,
    output_length: int,
) -> torch.Tensor:
    """Overlap-add plus envelope divide: ``(B, F, n_fft) -> (B, output_length)``.

    Runs ``overlap_add_kernel`` on a CUDA tensor and the plain twin on a CPU
    tensor. ``env`` must already be clamped to the NOLA epsilon."""
    if hop_length < 1:
        raise ValueError("hop_length must be positive")
    B, F, n_fft = fw.shape
    if output_length < 1:
        # degenerate empty output (e.g. istft length=0), as in the JAX kernel
        return fw.new_zeros((B, max(output_length, 0)))
    if not ola_supported(n_fft, hop_length):
        raise ValueError(
            f"fused OLA kernel supports C = ceil(n_fft/hop) <= {_MAX_CHUNKS}; "
            f"got n_fft={n_fft}, hop={hop_length} (C={cdiv(n_fft, hop_length)})"
        )
    kw = dict(hop_length=hop_length, output_length=output_length)
    if not on_cuda(fw, env):
        return overlap_add_plain(fw, env, **kw)
    return with_plain_backward(_launch, overlap_add_plain, fw, env, **kw)
