"""Every batch the same: ``batch`` clips of ``seconds`` each."""

from __future__ import annotations


def lengths(clips: dict, cfg: dict, pool: int) -> list[list[int]]:
    n = int(round(clips["seconds"] * cfg["sr"]))
    return [[n] * clips["batch"] for _ in range(pool)]
