from . import F32, filterbank_nnz, n_frames, spectrum_flops


def cost(cfg: dict, lengths: list[int]) -> tuple[float, float]:
    """The power mel spectrogram, its dB (six operations a value) and the
    DCT's first ``n_mfcc`` rows."""
    B, L = len(lengths), max(lengths)
    F, n_mels, n_mfcc = n_frames(cfg, L), cfg["n_mels"], cfg["features"]["n_mfcc"]
    per_frame = (spectrum_flops(cfg, 2.0) + 2 * filterbank_nnz(cfg) + 6 * n_mels
                 + 2 * n_mfcc * n_mels)
    return B * F * per_frame, F32 * (B * L + B * n_mfcc * F)
