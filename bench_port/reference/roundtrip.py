"""The analysis-resynthesis round trip: ``stft`` then ``istft(length=L)``."""

from __future__ import annotations

import torch

from . import dsp
from .logmel import blocks


def reference(y: torch.Tensor, cfg: dict, prec: dsp.Prec) -> dict:
    L = y.shape[1]
    F = 1 + (L + (cfg["n_fft"] if cfg["center"] else 0) - cfg["n_fft"]) // cfg["hop_length"]
    spec, audio = [], []
    for s in blocks(y.shape[0], F, cfg["n_fft"]):
        S = dsp.stft(y[s], cfg, prec)
        spec.append(S)
        audio.append(dsp.istft(S, cfg, L, prec))
    return {"spectrum": torch.cat(spec), "audio": torch.cat(audio)}
