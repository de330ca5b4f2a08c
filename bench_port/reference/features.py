"""The genre-tagging feature set: MFCC 20 with its first and second deltas,
spectral centroid, bandwidth, rolloff, flatness and contrast, zero-crossing
rate and RMS, from librosa's documented definitions."""

from __future__ import annotations

import numpy as np
import torch

from . import dsp
from .logmel import blocks, mel


def contrast_bands(n_bins: int, sr: int, fmin: float, n_bands: int,
                   quantile: float) -> list[tuple[int, int, int]]:
    """librosa ``spectral_contrast``'s bands on the bin grid: octave edges
    ``[0, fmin, 2 fmin, ...]``, the bin below each lower edge added, the last
    band running to Nyquist, the top bin of the others dropped; ``k``, the
    number of bins averaged at each end, counted before that drop."""
    freq = np.linspace(0.0, sr / 2.0, n_bins)
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * 2.0 ** np.arange(n_bands + 1)
    out = []
    for k in range(n_bands + 1):
        band = (freq >= octa[k]) & (freq <= octa[k + 1])
        idx = np.flatnonzero(band)
        if k > 0:
            band[idx[0] - 1] = True
        if k == n_bands:
            band[idx[-1] + 1:] = True
        sel = np.flatnonzero(band)
        stop = sel[-1] + 1 if k == n_bands else sel[-1]
        out.append((int(sel[0]), int(stop), max(int(np.rint(quantile * band.sum())), 1)))
    return out


def _spectral(y: torch.Tensor, cfg: dict, prec: dsp.Prec) -> dict:
    f = cfg["features"]
    mag = dsp.stft(y, cfg, prec).abs()                              # (b, n_bins, F)
    b, n_bins, F = mag.shape
    flat = mag.transpose(1, 2).reshape(-1, n_bins)                  # (b F, n_bins)
    freq = prec.cast(np.linspace(0.0, cfg["sr"] / 2.0, n_bins)).to(y.device)
    ones = torch.ones_like(freq)

    def per_frame(x):
        return x.reshape(b, F)[:, None, :]

    total = prec.mm(flat, ones[:, None])[:, 0]
    centroid = prec.mm(flat, freq[:, None])[:, 0] / (total + 1e-10)
    dev2 = (freq[None, :] - centroid[:, None]) ** 2
    bandwidth = torch.sqrt((prec.mm((flat * dev2).reshape(-1, n_bins), ones[:, None])[:, 0])
                           / (total + 1e-10))
    cum = torch.cumsum(flat, dim=1)
    hit = cum >= f["roll_percent"] * cum[:, -1:]
    rolloff = freq[torch.argmax(hit.to(torch.uint8), dim=1)]
    power = torch.clamp(flat * flat, min=f["flatness_amin"])
    gmean = torch.pow(10.0, torch.log10(power).mean(dim=1))
    flatness = gmean / (prec.mm(power, ones[:, None])[:, 0] / n_bins + 1e-10)
    peaks, valleys = [], []
    for start, stop, k in contrast_bands(n_bins, cfg["sr"], f["contrast_fmin"],
                                         f["contrast_n_bands"], f["contrast_quantile"]):
        srt = torch.sort(mag[:, start:stop, :], dim=1).values
        valleys.append(srt[:, :k].mean(dim=1))
        peaks.append(srt[:, -k:].mean(dim=1))
    valleys = torch.stack(valleys, 1)
    contrast = (10 * torch.log10(torch.clamp(torch.stack(peaks, 1), min=1e-10))
                - 10 * torch.log10(torch.clamp(valleys, min=1e-10)))
    # how far each valley lies under the frame's largest bin: the conditioning
    # of the valley in any float32 spectrum, whose rounding scales with that bin
    valley_share = valleys / torch.clamp(mag.amax(dim=1, keepdim=True), min=1e-30)
    n = f["frame_length"]
    zfr = dsp.frames(y, n, cfg["hop_length"], True, f["zcr_pad_mode"])
    sign = torch.signbit(zfr)
    zcr = (sign[..., 1:] != sign[..., :-1]).sum(-1).to(prec.dtype) / n
    rfr = prec.cast(dsp.frames(y, n, cfg["hop_length"], True, f["rms_pad_mode"]))
    energy = prec.mm((rfr * rfr).reshape(-1, n), torch.ones_like(rfr[0, 0])[:, None])
    rms = torch.sqrt(energy.reshape(b, 1, -1) / n)
    return {"centroid": per_frame(centroid), "bandwidth": per_frame(bandwidth),
            "rolloff": per_frame(rolloff), "flatness": per_frame(flatness),
            "contrast": contrast, "valley_share": valley_share, "zcr": zcr[:, None, :],
            "rms": rms}


def reference(y: torch.Tensor, cfg: dict, prec: dsp.Prec) -> dict:
    f = cfg["features"]
    mel_cfg = dict(cfg, power=2.0)
    m = mel(y, mel_cfg, prec)
    db = dsp.to_db(m, 10.0, 1.0, 1e-10, 80.0)                       # librosa's mfcc dB
    B, n_mels, F = db.shape
    basis = prec.cast(dsp.dct_ortho(f["n_mfcc"], n_mels)).to(y.device)
    mfcc = prec.mm(db.transpose(1, 2).reshape(-1, n_mels), basis.T)
    mfcc = mfcc.reshape(B, F, -1).transpose(1, 2)
    out = {"mfcc": mfcc,
           "delta1": dsp.delta(mfcc, f["delta_width"], 1, prec),
           "delta2": dsp.delta(mfcc, f["delta_width"], 2, prec)}
    parts = [_spectral(y[s], cfg, prec) for s in blocks(B, F, cfg["n_fft"], 2**26)]
    out.update({k: torch.cat([p[k] for p in parts]) for k in parts[0]})
    return out
