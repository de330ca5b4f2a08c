from . import F32, n_frames


def cost(cfg: dict, lengths: list[int]) -> tuple[float, float]:
    """clamp, divide, log10, scale, and with ``top_db`` the maximum and the
    floor: six operations a value, read once and written once."""
    n = len(lengths) * cfg["n_mels"] * n_frames(cfg, max(lengths))
    return 6.0 * n, 2.0 * F32 * n
