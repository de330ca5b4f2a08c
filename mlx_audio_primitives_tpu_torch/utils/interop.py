"""Carry the JAX package's host-built tables into the port.

The STFT / ISTFT / mel path has no weights; its state is the tables built
on the host: windows, the mel filterbank and the ISTFT envelope. A caller
that holds them from the JAX package (``np.asarray`` of its
``get_window(...)``, ``mel_filterbank(...)`` or
``_istft_envelope_table.host(...)``) turns them into the port's float32
tensors here, and can pass them on as array windows or as
``filterbank_spectrogram``'s ``fb``. The trainable models of ``models/``
have weights; :func:`params_from_jax` carries the JAX package's parameter
trees across.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._config import REAL_DTYPE
from .tree import tree_map


def tables_from_numpy(
    tables: dict[str, np.ndarray], device: torch.device | str | None = None
) -> dict[str, torch.Tensor]:
    """Each array as a float32 tensor on ``device`` (CPU when None), under
    the same key. Float32 input keeps its bits; float64 input (a host
    builder's table) is rounded once, as the port's own table caches do.
    The tensors are copies: they never alias the caller's buffers."""
    return {
        name: torch.tensor(np.asarray(arr), dtype=REAL_DTYPE, device=device)
        for name, arr in tables.items()
    }


def params_from_jax(tree: Any, device: torch.device | str | None = None) -> Any:
    """The JAX package's parameters (a tree of NumPy arrays, e.g. each leaf
    through ``np.asarray``) as the same tree of float32 tensors on
    ``device`` (CPU when None), for the port's ``models/``. Shapes and
    layouts are kept: conv weights stay OIHW, the pipeline's stacked blocks,
    the MoE classifier's expert stacks and the transformer's stacked blocks
    keep their leading axis, the attention weights stay 4-D (``wq``/``wk``/
    ``wv`` ``(n_blocks, d_model, n_heads, d_head)``, ``wo`` ``(n_blocks,
    n_heads, d_head, d_model)``), the ``pos`` table ``(n_frames, d_model)``.
    The tensors are copies: they never alias the caller's buffers."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=REAL_DTYPE, device=device), tree)
