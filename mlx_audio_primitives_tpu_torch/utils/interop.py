"""Carry the JAX package's host-built tables into the port.

The STFT / ISTFT / mel path has no weights; its state is the tables built
on the host: windows, the mel filterbank and the ISTFT envelope. A caller
that holds them from the JAX package (``np.asarray`` of its
``get_window(...)``, ``mel_filterbank(...)`` or
``_istft_envelope_table.host(...)``) turns them into the port's float32
tensors here, and can pass them on as array windows or as
``filterbank_spectrogram``'s ``fb``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._config import REAL_DTYPE


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
