"""Tones with noise, made on the device in a few large calls: four partials
(log-uniform 50-4,000 Hz, random amplitudes and phases) and white noise at
-40 dB, one gain a clip, zero past each clip's end."""

from __future__ import annotations

import math

import torch


def make(lengths: list[int], sr: int, gen: torch.Generator, device) -> torch.Tensor:
    B, L = len(lengths), max(lengths)
    kw = dict(generator=gen, device=device)
    f = 50.0 * torch.exp(torch.rand(B, 4, 1, dtype=torch.float64, **kw) * math.log(80.0))
    amp = 0.1 + 0.4 * torch.rand(B, 4, 1, dtype=torch.float64, **kw)
    phi = 2 * math.pi * torch.rand(B, 4, 1, dtype=torch.float64, **kw)
    gain = 0.3 + 0.7 * torch.rand(B, 1, dtype=torch.float64, **kw)
    t = torch.arange(L, dtype=torch.float64, device=device)
    y = torch.zeros(B, L, dtype=torch.float64, device=device)
    for k in range(4):  # one partial at a time keeps the float64 temporaries small
        y += amp[:, k] * torch.sin(torch.remainder(f[:, k] * t / sr, 1.0) * (2 * math.pi)
                                   + phi[:, k])
    y += 0.01 * torch.randn(B, L, dtype=torch.float64, **kw)
    y *= gain / 4.0
    n = torch.as_tensor(lengths, device=device)
    y[t[None, :] >= n[:, None]] = 0.0
    return y.float().contiguous()
