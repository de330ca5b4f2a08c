"""K6: the dB conversion of ``power_to_db`` and ``amplitude_to_db`` as one
CUDA kernel, and its plain twin.

Counterpart of the dB function of `mlx_audio_primitives_tpu/ops/convert.py`
(``_to_db``): the JAX package leaves it to XLA, so there is no
``pallas_call`` to replace. In the port it was four PyTorch passes over the
whole input (clamp, divide, ``log10``, scale) and, with ``top_db``, a global
``max``, a scalar subtraction and a ``maximum`` more, each reading and
writing the whole tensor.

Source note (`csrc/db_fused.cu`, ``db_max_kernel``, ``db_fused_kernel``).
On this card it is bound by device-memory bytes: one read of ``S`` and one
write of the result. The whole grid walks the input together, a float4 a
thread a step; the input is any tensor whose values fill one dense block of
memory (contiguous, transposed or permuted), the result laid out as it.
Without ``top_db`` one launch walks it once. With ``top_db`` two launches on
one stream: the first reduces the maximum of the dB values, one value a
block in a workspace slot; the second reduces the slots in every block and
walks the input again from its end, where what the first read last is the
likeliest still in L2, writing ``maximum(dB, max - top_db)`` with streaming
loads and stores (evict first) that leave the rest in L2 for it. The values
are the plain route's float32 operations in its order (the division by a
scalar ``ref`` as a product with its float32 reciprocal, as PyTorch's CUDA
division by a host scalar computes it; ``log10f`` without fast math), so at
``ref = 1.0`` kernel and twin agree bit for bit. Nothing is copied to the
host.

The per-item form (``per_item=True``, or an affine ``scale`` and ``offset``:
``db_item_launch``, ``db_item_max_kernel`` and ``db_item_kernel``): each
index of the leading dimension is floored at its own maximum less ``top_db``
(Whisper's per-clip floor, so that a clip's values do not depend on its
batch-mates), then ``value * scale + offset``. The input may be a view whose
last dimension has unit stride and whose rows are strided, such as the
``[..., :-1]`` slice of a mel, read in place; the result is dense. The
launches are counted in :data:`KERNEL_ITEM` and, while the port records, in
the counter ``kernels.db_fused.per_item``.
"""

from __future__ import annotations

import ctypes
from collections.abc import Callable

import numpy as np
import torch

from ..utils import profiler
from ..utils.dispatch import on_cuda
from ..utils.profiler import traced
from ._build import F32, I32, I64, Kernel, P, library, register, with_plain_backward

KERNEL = register(Kernel(
    "db_fused_kernel", "db_fused_launch",
    (P, P, I64, F32, F32, F32, I32, F32, P),
    source="mlx_audio_primitives_tpu_torch/csrc/db_fused.cu",
    replaces="mlx_audio_primitives_tpu/ops/convert.py:26",
))

#: K6's per-item form (`csrc/db_fused.cu`, ``db_item_launch``): the same
#: dB conversion with a floor per leading index and an affine epilogue
KERNEL_ITEM = register(Kernel(
    "db_item_kernel", "db_item_launch",
    (P, P, I64, I64, I64, I64, I64, F32, F32, F32, I32, F32, F32, F32, P, I64),
    source="mlx_audio_primitives_tpu_torch/csrc/db_fused.cu",
    replaces="mlx_audio_primitives_tpu/ops/convert.py:26",
))

#: The workspace of ``top_db``'s two launches (a float a block of the largest
#: grid) by (device index, stream): launches on one stream run in order, so
#: they share one.
_workspaces: dict[tuple[int, int], torch.Tensor] = {}


def to_db_plain(
    S: torch.Tensor,
    coefficient: float,
    ref: float | Callable,
    amin: float,
    top_db: float | None,
    *,
    per_item: bool = False,
    scale: float = 1.0,
    offset: float = 0.0,
) -> torch.Tensor:
    """Plain twin: ``coefficient * log10(clamp(S, amin) / max(ref, amin))``,
    floored at its maximum less ``top_db`` unless that is None (with
    ``per_item``, the maximum of each index of the leading dimension), then
    ``* scale + offset`` where those are not 1 and 0. A callable ``ref`` is
    called on ``S``."""
    if callable(ref):
        ref_value = torch.as_tensor(ref(S), dtype=S.dtype, device=S.device)
        ref_clamped = torch.clamp(ref_value, min=amin)
    else:
        # a scalar ref stays on the host: a device tensor made from it costs a
        # blocking host-to-device copy, which stalls the host until the kernel
        # that produced S has finished
        ref_clamped = float(max(np.float32(ref), np.float32(amin)))
    S_db = coefficient * torch.log10(torch.clamp(S, min=amin) / ref_clamped)
    if top_db is not None:
        top = S_db.amax(dim=tuple(range(1, S_db.dim())), keepdim=True) if per_item else S_db.max()
        S_db = torch.maximum(S_db, top - top_db)
    if scale != 1.0 or offset != 0.0:
        S_db = S_db * scale + offset
    return S_db


def _workspace(device: torch.device, at_least: int = 0) -> torch.Tensor:
    """The stream's workspace: ``db_fused_slots()`` floats, or ``at_least``
    where that is more (a per-item launch over more items than slots)."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < at_least:
        fn = library().db_fused_slots
        fn.argtypes = [I32, P]
        fn.restype = I32
        slots = ctypes.c_int()
        err = fn(device.index, ctypes.addressof(slots))
        if err != 0:
            raise RuntimeError(f"db_fused_slots failed: CUDA error {err}")
        ws = _workspaces[key] = torch.empty(max(slots.value, at_least), dtype=torch.float32,
                                            device=device)
    return ws


def fills_one_block(S: torch.Tensor) -> bool:
    """Whether ``S``'s values fill ``S.numel()`` neighbouring elements of
    its storage, one each, in whatever order its dimensions take them."""
    expected = 1
    for size, stride in sorted(((n, st) for n, st in zip(S.shape, S.stride()) if n != 1),
                               key=lambda d: d[1]):
        if stride != expected:
            return False
        expected *= size
    return True


def _rows(S: torch.Tensor, per_item: bool) -> torch.Tensor:
    """``S`` as ``(items, rows, cols)``, a view where its strides allow one
    with unit-stride rows (a ``[..., :-1]`` slice is one), else a copy:
    one item of the whole input, or one an index of its leading dimension."""
    if per_item and S.dim() == 3 and S.stride(2) == 1:
        return S  # (B, n_mels, F) or its [..., :-1] slice: as it is
    items = S.shape[0] if per_item else 1
    cols = S.shape[-1] if S.dim() > int(per_item) else 1
    try:
        S3 = S.view(items, -1, cols)
    except RuntimeError:
        S3 = S.contiguous().view(items, -1, cols)
    return S3 if cols == 1 or S3.stride(2) == 1 else S3.contiguous()


def _inverse(ref: float, amin: float) -> float:
    """The plain route's divisor's reciprocal, as PyTorch's CUDA division by
    a host scalar forms it: in float32, on the host."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float32(1.0) / max(np.float32(ref), np.float32(amin)))


def _launch_items(S: torch.Tensor, *, coefficient: float, ref: float, amin: float,
                  top_db: float | None, per_item: bool, scale: float,
                  offset: float) -> torch.Tensor:
    S3 = _rows(S, per_item)
    items, rows, cols = S3.shape
    out = torch.empty(S3.shape, dtype=S.dtype, device=S.device)
    ws = _workspace(S.device, items)
    profiler.count("kernels.db_fused.per_item")
    KERNEL_ITEM.launch(S.device, S3.data_ptr(), out.data_ptr(), items, rows, cols, S3.stride(0),
                       S3.stride(1), amin, _inverse(ref, amin), coefficient, top_db is not None,
                       0.0 if top_db is None else top_db, scale, offset, ws.data_ptr(), ws.numel(),
                       launches=1 + (top_db is not None))
    return out.view(S.shape)


def _launch(S: torch.Tensor, *, coefficient: float, ref: float, amin: float,
            top_db: float | None, per_item: bool = False, scale: float = 1.0,
            offset: float = 0.0) -> torch.Tensor:
    if S.dtype != torch.float32 or S.numel() == 0:
        raise ValueError(f"db_fused_kernel needs a non-empty float32 tensor, got "
                         f"{S.dtype} of shape {tuple(S.shape)}")
    if per_item or scale != 1.0 or offset != 0.0:
        return _launch_items(S, coefficient=coefficient, ref=ref, amin=amin, top_db=top_db,
                             per_item=per_item, scale=scale, offset=offset)
    # K6 maps the values where they lie: a tensor that fills one dense block
    # (a transpose, a permutation) as it is, a strided view as a copy
    if not (S.is_contiguous() or fills_one_block(S)):
        S = S.contiguous()
    inv = _inverse(ref, amin)
    out = torch.empty_strided(S.shape, S.stride(), dtype=S.dtype, device=S.device)
    if top_db is None:
        KERNEL.launch(S.device, S.data_ptr(), out.data_ptr(), S.numel(), amin, inv,
                      coefficient, False, 0.0, None)
    else:
        KERNEL.launch(S.device, S.data_ptr(), out.data_ptr(), S.numel(), amin, inv,
                      coefficient, True, top_db, _workspace(S.device).data_ptr(), launches=2)
    return out


@traced("kernels.db_fused")
def to_db_fused(
    S: torch.Tensor,
    coefficient: float,
    ref: float,
    amin: float,
    top_db: float | None,
    *,
    per_item: bool = False,
    scale: float = 1.0,
    offset: float = 0.0,
) -> torch.Tensor:
    """``coefficient * log10(clamp(S, amin) / max(ref, amin))``, floored at
    its maximum over the whole input less ``top_db`` unless that is None,
    then ``* scale + offset``. ``per_item``: the floor of each index of the
    leading dimension is its own maximum less ``top_db``. Runs K6 on a CUDA
    tensor (non-empty, a scalar ``ref``): one launch, two with ``top_db``
    (one launcher call; the per-item form where ``per_item`` is set or the
    affine is not the identity, its result dense); the plain twin on a CPU
    tensor. Differentiated as the twin."""
    kw = dict(per_item=per_item, scale=scale, offset=offset)
    if not on_cuda(S):
        return to_db_plain(S, coefficient, ref, amin, top_db, **kw)
    if callable(ref):
        raise ValueError("db_fused_kernel takes a scalar ref; a callable ref takes the plain route")
    return with_plain_backward(_launch, to_db_plain, S, coefficient=coefficient, ref=ref,
                               amin=amin, top_db=top_db, **kw)
