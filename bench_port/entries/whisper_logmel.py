"""Whisper large-v3's log-mel front end: the port's ``whisper_v3_logmel()``
(``pad_or_trim``, ``melspectrogram`` at n_fft 400 and hop 160, the last frame
dropped, the floor at each clip's maximum less 80 dB, ``* 0.025 + 1``)."""

from __future__ import annotations

from ._compare import abs_err


def ops(cfg: dict) -> list[str]:
    return ["melspectrogram", "power_to_db"]


def program(ap, cfg: dict):
    from mlx_audio_primitives_tpu_torch.models.presets import whisper_v3_logmel

    front = whisper_v3_logmel()
    w, d = cfg["whisper"], cfg["db"]
    stated = (cfg["sr"], cfg["n_fft"], cfg["hop_length"], cfg["n_mels"], cfg["fmax"],
              w["n_samples"], w["scale"], w["offset"], d["amin"], d["top_db"])
    runs = (front.sr, front.n_fft, front.hop_length, front.n_mels, front.fmax, front.n_samples,
            0.025, 1.0, 1e-10, 80.0)
    if stated != runs:
        raise ValueError(f"the configuration states {stated}; whisper_v3_logmel runs {runs}")

    def call(y):
        return {"features": front(y)}

    return call


def compare(out: dict, ref: dict, cfg: dict) -> dict:
    """The largest gap in Whisper's feature units (a feature is a quarter
    of a decade of mel power)."""
    return {"feat_abs_err": abs_err(out["features"], ref["features"])}
