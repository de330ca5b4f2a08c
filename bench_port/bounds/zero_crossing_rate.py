from . import F32, n_frames


def cost(cfg: dict, lengths: list[int]) -> tuple[float, float]:
    """A sign comparison and an add per sample of each frame."""
    B, L = len(lengths), max(lengths)
    n = cfg["features"]["frame_length"]
    F = n_frames(cfg, L, n)
    return 2.0 * B * F * n, F32 * (B * L + B * F)
