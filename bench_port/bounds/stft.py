from . import C64, F32, n_frames, rfft_flops


def cost(cfg: dict, lengths: list[int]) -> tuple[float, float]:
    B, L = len(lengths), max(lengths)
    F, n = n_frames(cfg, L), cfg["n_fft"]
    return B * F * (n + rfft_flops(n)), F32 * B * L + C64 * B * (n // 2 + 1) * F
