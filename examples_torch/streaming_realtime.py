"""Real-time streaming feature service demo, on the PyTorch port.

The port's counterpart of `examples/streaming_realtime.py`: many concurrent
streams push fixed-size chunks and receive log-mel frames + pitch
estimates back, with warm-path latency measured against the real-time
budget (a chunk of ``k`` hops at ``sr`` covers ``k * hop / sr`` seconds of
audio: the push must finish well inside that). On a CUDA card each
log-mel push is one launch of the fused mel kernel K1.

Usage:
    python examples_torch/streaming_realtime.py [--streams 64] [--seconds 2.0] [--device cpu]

Runs on the CUDA card by default (``--device cpu`` for the CPU). Streamed
output equals the offline ops over the concatenated signal (verified at
the end of the run: the streamed log-mel within 2e-2 dB above an -80 dB
floor, the streamed PCEN within 1e-3).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

# runnable in place from a source checkout (`python examples_torch/<name>.py`)
sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main(streams: int = 64, seconds: float = 2.0, sr: int = 16000,
         n_fft: int = 512, hop: int = 128, n_mels: int = 40,
         frames_per_push: int = 8, device: str = "cuda") -> None:
    import torch

    import mlx_audio_primitives_tpu_torch as tap
    from mlx_audio_primitives_tpu_torch.ops.streaming import StreamingLogMel, StreamingPitch

    tap.set_default_device(device)
    chunk = frames_per_push * hop
    budget_ms = 1e3 * chunk / sr
    n_push = max(int(seconds * sr) // chunk, 2)
    print(
        f"{streams} streams x {n_push} pushes of {chunk} samples "
        f"({budget_ms:.1f} ms of audio each) on {device}"
    )

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    logmel = StreamingLogMel(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels, batch=streams)
    pitch = StreamingPitch(sr=sr, frame_length=n_fft, hop_length=hop, batch=streams)

    rng = np.random.default_rng(0)
    t = np.arange(n_push * chunk) / sr
    # each stream: a different tone + noise, so pitch has something to find
    f0s = rng.uniform(100, 400, size=(streams, 1))
    audio = (
        np.sin(2 * np.pi * f0s * t[None]) + 0.05 * rng.standard_normal((streams, t.size))
    ).astype(np.float32)
    audio_dev = torch.from_numpy(audio).to(device)

    # warm up once (tables, the kernels' build), then measure the steady state
    _ = logmel.push(audio_dev[:, :chunk])
    _ = pitch.push(audio_dev[:, :chunk])
    logmel.reset()
    pitch.reset()
    sync()

    mel_frames = []
    lat = []
    for i in range(n_push):
        buf = audio_dev[:, i * chunk:(i + 1) * chunk]
        t0 = time.perf_counter()
        frames = logmel.push(buf)
        f0, voiced = pitch.push(buf)
        sync()
        lat.append(1e3 * (time.perf_counter() - t0))
        mel_frames.append(frames)
    lat = np.asarray(lat)
    med = float(np.median(lat))
    print(
        f"per-push latency: median {med:.2f} ms, p95 "
        f"{float(np.percentile(lat, 95)):.2f} ms  "
        f"(budget {budget_ms:.1f} ms -> {budget_ms / med:.0f}x realtime, "
        f"{streams} streams at once)"
    )
    f0_last = f0.cpu().numpy()
    print(
        f"last-push pitch: median abs err "
        f"{float(np.median(np.abs(f0_last.mean(-1) - f0s[:, 0]))):.1f} Hz"
    )

    # exactness: the streamed log-mel equals the offline op over the whole
    # signal (the stream is silence-primed: its first n_fft/hop - 1 frames
    # cover the zero carry, matching offline center=False on padded audio)
    from mlx_audio_primitives_tpu_torch import melspectrogram, power_to_db

    streamed = torch.cat(mel_frames, dim=1)  # (B, F, n_mels)
    pad = torch.from_numpy(np.pad(audio, ((0, 0), (n_fft - hop, 0)))).to(device)
    mel = melspectrogram(pad, sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels, center=False)
    off = power_to_db(mel, top_db=None).transpose(1, 2)[:, : streamed.shape[1]]
    # the same frames through two transform paths (a chunk's few frames and
    # the whole signal), each f32-exact to ~1e-6 of its frame's peak: a bin
    # 40 dB down may differ by ~1e-2 dB, so compare above a -80 dB floor
    floor = float(off.max()) - 80.0
    err = float((torch.clamp(streamed, min=floor) - torch.clamp(off, min=floor)).abs().max())
    print(f"streamed vs offline log-mel max |diff| (above -80 dB): {err:.2e}")
    assert err < 2e-2, err

    # PCEN frontend variant: causal by construction, so the streamed
    # output equals offline pcen(melspectrogram(center=False))
    from mlx_audio_primitives_tpu_torch import pcen
    from mlx_audio_primitives_tpu_torch.ops.streaming import StreamingPCEN

    sp = StreamingPCEN(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels, batch=streams)
    got = torch.cat([sp.push(audio_dev[:, i * chunk:(i + 1) * chunk]) for i in range(n_push)],
                    dim=1)
    offline_pcen = pcen(mel, sr=sr, hop_length=hop)
    err_p = float((got - offline_pcen.transpose(1, 2)[:, : got.shape[1]]).abs().max())
    print(f"streamed vs offline PCEN max |diff|: {err_p:.2e}")
    # PCEN's root compression keeps the comparison well-conditioned across
    # the two transform paths (no log of noise-floor bins)
    assert err_p < 1e-3, err_p


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    a = ap.parse_args()
    main(streams=a.streams, seconds=a.seconds, device=a.device)
