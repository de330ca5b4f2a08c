from . import C64, F32, n_frames, rfft_flops


def cost(cfg: dict, lengths: list[int]) -> tuple[float, float]:
    """The inverse FFT, the window and the overlap-add of each frame, and
    the division by the envelope of each output sample."""
    B, L = len(lengths), max(lengths)
    F, n = n_frames(cfg, L), cfg["n_fft"]
    return B * F * (rfft_flops(n) + 2 * n) + B * L, C64 * B * (n // 2 + 1) * F + F32 * B * L
