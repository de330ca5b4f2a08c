from . import _spectral


def cost(cfg: dict, lengths: list[int]) -> tuple[float, float]:
    return _spectral.cost(cfg, lengths, per_bin=4, power=1.0)
