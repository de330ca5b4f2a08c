from . import _spectral


def cost(cfg: dict, lengths: list[int]) -> tuple[float, float]:
    """Each bin compared once into its band's extremes; two logs a band."""
    return _spectral.cost(cfg, lengths, per_bin=1, rows=cfg["features"]["contrast_n_bands"] + 1)
