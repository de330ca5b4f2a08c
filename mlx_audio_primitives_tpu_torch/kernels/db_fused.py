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
"""

from __future__ import annotations

import ctypes
from collections.abc import Callable

import numpy as np
import torch

from ..utils.dispatch import on_cuda
from ..utils.profiler import traced
from ._build import F32, I32, I64, Kernel, P, library, register, with_plain_backward

KERNEL = register(Kernel(
    "db_fused_kernel", "db_fused_launch",
    (P, P, I64, F32, F32, F32, I32, F32, P),
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
) -> torch.Tensor:
    """Plain twin: ``coefficient * log10(clamp(S, amin) / max(ref, amin))``,
    floored at its maximum less ``top_db`` unless that is None. A callable
    ``ref`` is called on ``S``."""
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
        S_db = torch.maximum(S_db, S_db.max() - top_db)
    return S_db


def _workspace(device: torch.device) -> torch.Tensor:
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    ws = _workspaces.get(key)
    if ws is None:
        fn = library().db_fused_slots
        fn.argtypes = [I32, P]
        fn.restype = I32
        slots = ctypes.c_int()
        err = fn(device.index, ctypes.addressof(slots))
        if err != 0:
            raise RuntimeError(f"db_fused_slots failed: CUDA error {err}")
        ws = _workspaces[key] = torch.empty(slots.value, dtype=torch.float32, device=device)
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


def _launch(S: torch.Tensor, *, coefficient: float, ref: float, amin: float,
            top_db: float | None) -> torch.Tensor:
    if S.dtype != torch.float32 or S.numel() == 0:
        raise ValueError(f"db_fused_kernel needs a non-empty float32 tensor, got "
                         f"{S.dtype} of shape {tuple(S.shape)}")
    # K6 maps the values where they lie: a tensor that fills one dense block
    # (a transpose, a permutation) as it is, a strided view as a copy
    if not (S.is_contiguous() or fills_one_block(S)):
        S = S.contiguous()
    # the plain route's divisor, and its reciprocal as PyTorch's CUDA division
    # by a host scalar forms it: in float32, on the host
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.float32(1.0) / max(np.float32(ref), np.float32(amin))
    out = torch.empty_strided(S.shape, S.stride(), dtype=S.dtype, device=S.device)
    if top_db is None:
        KERNEL.launch(S.device, S.data_ptr(), out.data_ptr(), S.numel(), amin, float(inv),
                      coefficient, False, 0.0, None)
    else:
        KERNEL.launch(S.device, S.data_ptr(), out.data_ptr(), S.numel(), amin, float(inv),
                      coefficient, True, top_db, _workspace(S.device).data_ptr(), launches=2)
    return out


@traced("kernels.db_fused")
def to_db_fused(
    S: torch.Tensor,
    coefficient: float,
    ref: float,
    amin: float,
    top_db: float | None,
) -> torch.Tensor:
    """``coefficient * log10(clamp(S, amin) / max(ref, amin))``, floored at
    its maximum over the whole input less ``top_db`` unless that is None.
    Runs K6 on a CUDA tensor (non-empty, a scalar ``ref``): one launch, two
    with ``top_db`` (one launcher call); the plain twin on a CPU tensor.
    Differentiated as the twin."""
    if not on_cuda(S):
        return to_db_plain(S, coefficient, ref, amin, top_db)
    if callable(ref):
        raise ValueError("db_fused_kernel takes a scalar ref; a callable ref takes the plain route")
    return with_plain_backward(_launch, to_db_plain, S, coefficient=coefficient, ref=ref,
                               amin=amin, top_db=top_db)
