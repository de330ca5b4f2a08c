from . import F32, n_frames


def cost(cfg: dict, lengths: list[int]) -> tuple[float, float]:
    """A square and an add per sample of each frame, a root a frame."""
    B, L = len(lengths), max(lengths)
    n = cfg["features"]["frame_length"]
    F = n_frames(cfg, L, n)
    return B * F * (2.0 * n + 1), F32 * (B * L + B * F)
