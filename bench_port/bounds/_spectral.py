"""A spectral feature of the magnitude: its spectrum, ``per_bin``
operations a bin, one output row (``rows`` for contrast) a frame."""

from . import F32, n_frames, spectrum_flops


def cost(cfg: dict, lengths: list[int], per_bin: float, rows: int = 1,
         power: float = 1.0) -> tuple[float, float]:
    B, L = len(lengths), max(lengths)
    F, bins = n_frames(cfg, L), cfg["n_fft"] // 2 + 1
    return B * F * (spectrum_flops(cfg, power) + per_bin * bins), F32 * (B * L + B * rows * F)
