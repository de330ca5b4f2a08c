from . import F32, n_frames


def cost(cfg: dict, lengths: list[int]) -> tuple[float, float]:
    """A ``delta_width``-tap filter over each MFCC row."""
    n = len(lengths) * cfg["features"]["n_mfcc"] * n_frames(cfg, max(lengths))
    return 2.0 * cfg["features"]["delta_width"] * n, 2.0 * F32 * n
