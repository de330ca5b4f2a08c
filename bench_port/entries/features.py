"""The genre-tagging feature set: ``mfcc`` (20) with two ``delta`` orders,
``spectral_centroid``, ``spectral_bandwidth``, ``spectral_rolloff``,
``spectral_flatness``, ``spectral_contrast``, ``zero_crossing_rate``, ``rms``."""

from __future__ import annotations

from ._compare import abs_err, mismatch_share, rel_err, rel_err_where

#: The share of the frame's largest bin under which a band's valley is left
#: out of ``contrast_rel_err``. A float32 spectrum's rounding scales with
#: that bin: on the H100 the valley-to-peak ratio's relative error reads
#: about 1.2e-8 over this share, so a valley above 1e-6 of the largest bin
#: is known to about 1%, and one under 1e-8 not at all.
CONTRAST_FLOOR = 1e-6


def ops(cfg: dict) -> list[str]:
    return ["mfcc", "delta", "delta", "spectral_centroid", "spectral_bandwidth",
            "spectral_rolloff", "spectral_flatness", "spectral_contrast",
            "zero_crossing_rate", "rms"]


def program(ap, cfg: dict):
    f = cfg["features"]
    stft_kw = dict(n_fft=cfg["n_fft"], hop_length=cfg["hop_length"], win_length=cfg["win_length"],
                   window=cfg["window"], center=cfg["center"], pad_mode=cfg["pad_mode"])
    kw = dict(sr=cfg["sr"], **stft_kw)
    mel_kw = dict(n_mels=cfg["n_mels"], fmin=cfg["fmin"], fmax=cfg["fmax"], htk=cfg["htk"],
                  mel_norm=cfg["norm"])
    frame_kw = dict(frame_length=f["frame_length"], hop_length=cfg["hop_length"], center=True)

    def call(y):
        m = ap.mfcc(y, n_mfcc=f["n_mfcc"], norm=f["dct_norm"], **kw, **mel_kw)
        return {
            "mfcc": m,
            "delta1": ap.delta(m, width=f["delta_width"], order=1),
            "delta2": ap.delta(m, width=f["delta_width"], order=2),
            "centroid": ap.spectral_centroid(y, **kw),
            "bandwidth": ap.spectral_bandwidth(y, **kw),
            "rolloff": ap.spectral_rolloff(y, roll_percent=f["roll_percent"], **kw),
            "flatness": ap.spectral_flatness(y, amin=f["flatness_amin"], **stft_kw),
            "contrast": ap.spectral_contrast(y, fmin=f["contrast_fmin"],
                                             n_bands=f["contrast_n_bands"],
                                             quantile=f["contrast_quantile"], **kw),
            "zcr": ap.zero_crossing_rate(y, pad_mode=f["zcr_pad_mode"], **frame_kw),
            "rms": ap.rms(y, pad_mode=f["rms_pad_mode"], **frame_kw),
        }

    return call


def compare(out: dict, ref: dict, cfg: dict) -> dict:
    readings = {f"{k}_rel_err": rel_err(out[k], ref[k])
                for k in ("mfcc", "delta1", "delta2", "centroid", "bandwidth", "flatness", "rms")}
    # valley over peak, 10**(-contrast/10): relative to the reference's ratio
    # in every band whose valley lies above float32's rounding, and as an
    # absolute gap in all bands
    r_out, r_ref = 10.0 ** (-out["contrast"].double() / 10), 10.0 ** (-ref["contrast"].double() / 10)
    readings["contrast_rel_err"] = rel_err_where(r_out, r_ref,
                                                 ref["valley_share"] >= CONTRAST_FLOOR)
    readings["contrast_ratio_err"] = abs_err(r_out, r_ref)
    readings["rolloff_bin_mismatch"] = mismatch_share(out["rolloff"], ref["rolloff"],
                                                      cfg["sr"] / cfg["n_fft"])
    readings["zcr_abs_err"] = abs_err(out["zcr"], ref["zcr"])
    return readings
