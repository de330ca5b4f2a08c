"""K5: per-row means of the k smallest and k largest values, as a CUDA
kernel and its plain twin.

Counterpart of `mlx_audio_primitives_tpu/kernels/select_extremes.py`:
``spectral_contrast`` needs, per octave band and frame, the mean of the
``k`` smallest and ``k`` largest magnitudes, ``k = max(1, rint(quantile *
band_width))`` (2 to 9 for the default bands at n_fft 2048).

Source note (`csrc/select_extremes.cu`, ``select_extremes_kernel``).
Replaces ``quantile_extreme_means_pallas`` (its ``pallas_call`` in
``_quantile_extreme_means_impl``). The TPU kernel stages row blocks in VMEM
and runs ``k`` argmin/argmax passes; here a thread owns a row and streams
its values once into two sorted register arrays (the ``k`` smallest and the
``k`` largest): by min/max insertion, two instructions a slot, for
``k <= 4``, and for ``k >= 5`` by chunks of ``k'`` values (the power of two
>= ``k``) sorted with a bitonic network and merged into both arrays (one
template instance per ``k``, fully unrolled, so nothing spills). Rows come
through a strided ``(B, R, W)`` view, flattened over ``B*R`` on the grid
with a 64-bit row index, so one launch takes any number of clips and a band
of the natural ``(B, n_bins, F)`` magnitude is read in place with frames
across lanes, coalesced, with no swapaxes and reshape copy, which the JAX
code pays. A NaN changes neither array and is counted, so that the means
come out as the twin's: NaN for the hi mean of a row that holds a NaN, and
for its lo mean where fewer than ``k`` values are not NaN. What bounds it on this
card: the one read of the band, 315 MB over the four default bands at
64 x 30 s clips, 0.094 ms at 3.35 TB/s, and its min/max a value (34 by
insertion at ``k = 9``, ~20 by sort and merge), which issue at half the
FP32 rate.

Sums run in ascending order for the lo mean and descending order for the
hi mean, as the TPU kernel's extraction adds them, so kernel, twin and JAX
kernel agree to rounding. The gradient routes to the first occurrences of
tied values, as the JAX ``custom_vjp`` does (``_extreme_masks_xla``):
``torch.argmin``/``torch.argmax`` return the first occurrence.
"""

from __future__ import annotations

import torch

from ..utils.dispatch import on_cuda
from ..utils.profiler import traced
from ._build import I32, I64, Kernel, P, register

#: Largest k the kernel takes; past it the sort path runs (as in JAX, where
#: beyond this the extraction passes approach the sort's cost).
MAX_K = 16

KERNEL = register(Kernel(
    "select_extremes_kernel", "select_extremes_launch",
    (P, I64, I64, I64, P, P, I32, I32, I32, I32, I32),
    source="mlx_audio_primitives_tpu_torch/csrc/select_extremes.cu",
    replaces="mlx_audio_primitives_tpu/kernels/select_extremes.py:168",
))


def select_supported(width: int, k_lo: int, k_hi: int) -> bool:
    """The JAX gate without its VMEM term: ``1 <= k <= 16`` and ``k <= W``
    (more picks than values would read the padding; the sort path clamps
    its slice instead)."""
    return width >= 1 and 1 <= k_lo <= min(MAX_K, width) and 1 <= k_hi <= min(MAX_K, width)


def _ordered_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, summed left to right and divided as the
    kernel does (a tensor divisor: PyTorch's CUDA division by a scalar
    multiplies by its reciprocal, which can differ by an ulp)."""
    s = v[..., 0]
    for i in range(1, v.shape[-1]):
        s = s + v[..., i]
    return s / torch.full_like(s, v.shape[-1])


def quantile_extreme_means_plain(
    x: torch.Tensor, k_lo: int, k_hi: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: ``topk`` of the smallest (ascending) and the largest
    (descending), summed in that order -> two ``x.shape[:-1]`` tensors.
    ``topk`` ranks a NaN above ``+inf``, so a row that holds a NaN has a NaN
    hi mean, and a NaN lo mean where fewer than ``k_lo`` of its values are
    not NaN (the JAX package's ``jnp.sort`` puts NaN last: the same)."""
    lo = torch.topk(x, k_lo, dim=-1, largest=False, sorted=True).values
    hi = torch.topk(x, k_hi, dim=-1, largest=True, sorted=True).values
    return _ordered_mean(lo), _ordered_mean(hi)


def extreme_masks(x: torch.Tensor, k_lo: int, k_hi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Selection masks of the ``k_lo`` smallest and ``k_hi`` largest values
    along the last axis, ties taken first occurrence first (the JAX
    ``_extreme_masks_xla``)."""
    mask_lo = torch.zeros_like(x)
    mask_hi = torch.zeros_like(x)
    xl, xh = x.clone(), x.clone()
    for _ in range(k_lo):
        idx = torch.argmin(xl, dim=-1, keepdim=True)
        mask_lo.scatter_(-1, idx, 1.0)
        xl.scatter_(-1, idx, float("inf"))
    for _ in range(k_hi):
        idx = torch.argmax(xh, dim=-1, keepdim=True)
        mask_hi.scatter_(-1, idx, 1.0)
        xh.scatter_(-1, idx, float("-inf"))
    return mask_lo, mask_hi


def _launch(x: torch.Tensor, k_lo: int, k_hi: int) -> tuple[torch.Tensor, torch.Tensor]:
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"select_extremes_kernel needs a float32 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    x3 = x.unsqueeze(0) if x.dim() == 2 else x
    B, R, W = x3.shape
    lo = torch.empty((B, R), dtype=torch.float32, device=x.device)
    hi = torch.empty_like(lo)
    if B * R > 0:
        sb, sr, sw = x3.stride()
        KERNEL.launch(x.device, x3.data_ptr(), sb, sr, sw, lo.data_ptr(), hi.data_ptr(),
                      B, R, W, k_lo, k_hi)
    return lo.view(x.shape[:-1]), hi.view(x.shape[:-1])


def _forward(x: torch.Tensor, k_lo: int, k_hi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on a CUDA tensor, the plain twin on a CPU tensor."""
    if on_cuda(x):
        return _launch(x, k_lo, k_hi)
    return quantile_extreme_means_plain(x, k_lo, k_hi)


class _QuantileExtremeMeans(torch.autograd.Function):
    """Kernel (CUDA) or twin (CPU) forward; the backward routes ``g / k`` to
    the selected positions, first occurrence first."""

    @staticmethod
    def forward(ctx, x, k_lo, k_hi):
        ctx.k = (k_lo, k_hi)
        ctx.save_for_backward(x)
        return _forward(x, k_lo, k_hi)

    @staticmethod
    def backward(ctx, g_lo, g_hi):
        (x,) = ctx.saved_tensors
        k_lo, k_hi = ctx.k
        mask_lo, mask_hi = extreme_masks(x.detach(), k_lo, k_hi)
        grad = mask_lo * (g_lo / k_lo).unsqueeze(-1) + mask_hi * (g_hi / k_hi).unsqueeze(-1)
        return grad, None, None


@traced("kernels.quantile_extreme_means_fused")
def quantile_extreme_means_fused(
    x: torch.Tensor, k_lo: int, k_hi: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise means of the ``k_lo`` smallest and ``k_hi`` largest values:
    ``(R, W) -> ((R,), (R,))``, or ``(B, R, W) -> ((B, R), (B, R))`` for a
    strided 3-D view (any strides). Runs ``select_extremes_kernel`` on a
    CUDA tensor and the plain twin on a CPU tensor. Exact (sort-equivalent,
    ties included); differentiable. Without a gradient to record the forward
    runs directly, without the autograd ``Function``'s per-call cost."""
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be (R, W) or (B, R, W), got shape {tuple(x.shape)}")
    if not select_supported(x.shape[-1], k_lo, k_hi):
        raise ValueError(
            f"extraction kernel gate rejects W={x.shape[-1]}, k_lo={k_lo}, k_hi={k_hi}"
        )
    if torch.is_grad_enabled() and x.requires_grad:
        return _QuantileExtremeMeans.apply(x, int(k_lo), int(k_hi))
    return _forward(x, k_lo, k_hi)
