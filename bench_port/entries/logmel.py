"""``melspectrogram`` then ``power_to_db`` or ``amplitude_to_db``, as the
configuration's ``db`` says."""

from __future__ import annotations

from ._compare import abs_err, rel_err

MEL_ARGS = ("sr", "n_fft", "hop_length", "win_length", "window", "center", "pad_mode",
            "power", "n_mels", "fmin", "fmax", "htk", "norm")


def ops(cfg: dict) -> list[str]:
    return ["melspectrogram", f"{cfg['db']['kind']}_to_db"]


def program(ap, cfg: dict):
    kw = {k: cfg[k] for k in MEL_ARGS}
    d = cfg["db"]
    to_db = {"power": ap.power_to_db, "amplitude": ap.amplitude_to_db}[d["kind"]]

    def call(y):
        m = ap.melspectrogram(y, **kw)
        return {"mel": m, "db": to_db(m, ref=d["ref"], amin=d["amin"], top_db=d["top_db"])}

    return call


def compare(out: dict, ref: dict, cfg: dict) -> dict:
    return {"mel_rel_err": rel_err(out["mel"], ref["mel"]),
            "db_abs_err": abs_err(out["db"], ref["db"])}
