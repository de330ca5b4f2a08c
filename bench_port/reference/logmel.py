"""Log-mel: ``melspectrogram`` then ``power_to_db`` or ``amplitude_to_db``."""

from __future__ import annotations

import torch

from . import dsp


def blocks(B: int, frames_per_clip: int, n_fft: int, budget: int = 2**27) -> list[slice]:
    """Slices of at most ``budget`` frame samples, so that a block fits."""
    step = max(1, budget // max(1, frames_per_clip * n_fft))
    return [slice(i, min(i + step, B)) for i in range(0, B, step)]


def mel(y: torch.Tensor, cfg: dict, prec: dsp.Prec) -> torch.Tensor:
    """``(B, L) -> (B, n_mels, F)``: the filterbank over ``|STFT|^power``."""
    fb = prec.cast(dsp.config_filterbank(cfg)).to(y.device)
    F = 1 + (y.shape[1] + (cfg["n_fft"] if cfg["center"] else 0) - cfg["n_fft"]) // cfg["hop_length"]
    out = []
    for s in blocks(y.shape[0], F, cfg["n_fft"]):
        spec = dsp.stft(y[s], cfg, prec).abs()                     # (b, n_bins, F)
        if cfg["power"] == 2.0:
            spec = spec * spec
        elif cfg["power"] != 1.0:
            raise ValueError("the reference knows power 1 and 2")
        b, n_bins, F = spec.shape
        m = prec.mm(spec.transpose(1, 2).reshape(-1, n_bins), fb.T)
        out.append(m.reshape(b, F, -1).transpose(1, 2))
    return torch.cat(out)


def db(m: torch.Tensor, cfg: dict) -> torch.Tensor:
    d = cfg["db"]
    coefficient = {"power": 10.0, "amplitude": 20.0}[d["kind"]]
    return dsp.to_db(m, coefficient, d["ref"], d["amin"], d["top_db"])


def reference(y: torch.Tensor, cfg: dict, prec: dsp.Prec) -> dict:
    m = mel(y, cfg, prec)
    return {"mel": m, "db": db(m, cfg)}
