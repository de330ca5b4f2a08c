"""``stft`` then ``istft(length=L)``: analysis and resynthesis."""

from __future__ import annotations

from ._compare import rel_err

STFT_ARGS = ("n_fft", "hop_length", "win_length", "window", "center", "pad_mode")


def ops(cfg: dict) -> list[str]:
    return ["stft", "istft"]


def program(ap, cfg: dict):
    kw = {k: cfg[k] for k in STFT_ARGS}
    inv = {k: cfg[k] for k in ("n_fft", "hop_length", "win_length", "window", "center")}

    def call(y):
        S = ap.stft(y, **kw)
        return {"spectrum": S, "audio": ap.istft(S, length=y.shape[1], **inv)}

    return call


def compare(out: dict, ref: dict, cfg: dict) -> dict:
    return {"spectrum_rel_err": rel_err(out["spectrum"], ref["spectrum"]),
            "audio_rel_err": rel_err(out["audio"], ref["audio"])}
