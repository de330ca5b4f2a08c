"""Whisper's log-mel front end (openai/whisper, ``whisper/audio.py``:
``pad_or_trim``, ``log_mel_spectrogram``) on ``dsp.py``'s window, real DFT
and Slaney filterbank, computed in blocks of clips: pad with zeros or trim to
``n_samples``, a reflect pad of ``n_fft // 2`` on each side (``dsp.frames``
knows no reflect pad, so it is made here), frames at ``hop_length``, the
power spectrum without its last frame, the filterbank, ``10 log10`` of the
mel clamped at ``amin``, floored ``top_db`` below each clip's maximum, then
``* scale + offset``: Whisper's ``(max(L, L.max() - 8) + 4) / 4`` on ``L =
log10(max(mel, 1e-10))``, the maximum each clip's."""

from __future__ import annotations

import torch

from . import dsp
from .logmel import blocks


def reference(y: torch.Tensor, cfg: dict, prec: dsp.Prec) -> dict:
    w, d = cfg["whisper"], cfg["db"]
    n_fft, hop, n = cfg["n_fft"], cfg["hop_length"], w["n_samples"]
    y = prec.cast(y)
    y = y[:, :n] if y.shape[1] >= n else torch.nn.functional.pad(y, (0, n - y.shape[1]))
    fb = prec.cast(dsp.config_filterbank(cfg)).to(y.device)
    win = prec.cast(dsp.padded_window(cfg)).to(y.device)
    F = 1 + n // hop
    out = []
    for s in blocks(y.shape[0], F, n_fft):
        yp = torch.nn.functional.pad(y[s, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
        spec = dsp.rdft(yp.unfold(-1, n_fft, hop) * win, prec)     # (b, F, n_bins)
        if w["drop_last_frame"]:
            spec = spec[:, :-1]
        power = spec.real * spec.real + spec.imag * spec.imag
        b, frames, n_bins = power.shape
        mel = prec.mm(power.reshape(-1, n_bins), fb.T).reshape(b, frames, -1).transpose(1, 2)
        db = 10.0 * torch.log10(torch.clamp(mel, min=d["amin"]) / max(d["ref"], d["amin"]))
        top = db.amax(dim=(1, 2), keepdim=True)
        out.append(torch.maximum(db, top - d["top_db"]) * w["scale"] + w["offset"])
    return {"features": torch.cat(out)}
