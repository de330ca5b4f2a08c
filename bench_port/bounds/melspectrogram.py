from . import F32, filterbank_nnz, n_frames, spectrum_flops


def cost(cfg: dict, lengths: list[int]) -> tuple[float, float]:
    B, L = len(lengths), max(lengths)
    F = n_frames(cfg, L)
    flops = B * F * (spectrum_flops(cfg, cfg["power"]) + 2 * filterbank_nnz(cfg))
    return flops, F32 * (B * L + B * cfg["n_mels"] * F)
