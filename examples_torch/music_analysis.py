"""Music analysis demo on the PyTorch port: chords, onsets, and melody from
one synthesized clip.

The port's counterpart of `examples/music_analysis.py`.

Synthesizes a short progression (C major -> F major -> G major -> C major,
one strummed chord per beat with a decaying envelope) plus a melody line an
octave up, then runs the full analysis stack:

* `onset_detect` finds the strum times,
* `chroma_cqt` identifies the active pitch classes per beat (chord roots),
* `yin` tracks the fundamental of the melody stem (YIN is a
  monophonic tracker, so it runs on the isolated lead line — the realistic
  setting for f0 tracking).

Everything runs through the port's public API on the CUDA card by default
(``--device cpu`` for the CPU; the onset envelope's mel is one launch of the
fused mel kernel K1 on the card); the script asserts the recovered
structure matches what it synthesized.

Usage:
    python examples_torch/music_analysis.py [--bpm 120] [--sr 22050] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# runnable in place from a source checkout (`python examples_torch/<name>.py`)
sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# pitch classes (base_c ordering used by chroma)
_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]

# (root class, chord tone classes, melody note Hz)
_PROGRESSION = [
    (0, (0, 4, 7), 523.25),   # C: C-E-G, melody C5
    (5, (5, 9, 0), 698.46),   # F: F-A-C, melody F5
    (7, (7, 11, 2), 783.99),  # G: G-B-D, melody G5
    (0, (0, 4, 7), 523.25),   # C again
]


_LEAD = 0.25  # seconds of silence before beat 0: spectral flux needs
              # pre-onset contrast, so an event at t=0 is undetectable


def synthesize(
    bpm: float = 120.0, sr: int = 22050
) -> tuple[np.ndarray, np.ndarray, list[float]]:
    """Returns (mix, melody_stem, onset_times)."""
    beat = 60.0 / bpm
    n_beat = int(beat * sr)
    lead = np.zeros(int(_LEAD * sr))
    mix, stem = [lead], [lead]
    onset_times = []
    for i, (_, tones, melody_hz) in enumerate(_PROGRESSION):
        t = np.arange(n_beat) / sr
        env = np.exp(-t / (0.4 * beat))
        chord = sum(
            np.sin(2 * np.pi * 130.81 * 2.0 ** (c / 12.0) * t) for c in tones
        )
        mel = 0.6 * np.sin(2 * np.pi * melody_hz * t)
        mix.append(env * (chord / 3.0 + mel))
        stem.append(env * mel)
        onset_times.append(_LEAD + i * beat)
    y = np.concatenate(mix).astype(np.float32)
    m = np.concatenate(stem).astype(np.float32)
    peak = np.abs(y).max()
    return y / peak, m / peak, onset_times


def _host(x) -> np.ndarray:
    """A result as a NumPy array (tensors come back from the card)."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def main(bpm: float = 120.0, sr: int = 22050, device: str = "cuda") -> None:
    import mlx_audio_primitives_tpu_torch as ap

    ap.set_default_device(device)
    y, melody_stem, true_onsets = synthesize(bpm, sr)
    hop = 512
    print(f"{len(y)} samples at {sr} Hz on {device}")

    # --- onsets -----------------------------------------------------------
    onsets = _host(ap.onset_detect(y, sr=sr, hop_length=hop, units="time"))
    print(f"onsets (s): {np.round(onsets, 3).tolist()} "
          f"(true: {np.round(true_onsets, 3).tolist()})")
    assert len(onsets) == len(true_onsets), "missed or spurious onsets"
    for got, want in zip(onsets, true_onsets):
        assert abs(got - want) < 0.06, f"onset {got:.3f}s vs {want:.3f}s"

    # --- tempo + beat grid ------------------------------------------------
    # only 4 beats of audio: hand the tracker the known prior via start_bpm
    est_bpm, beats = ap.beat_track(y=y, sr=sr, hop_length=hop,
                                   start_bpm=bpm, units="time")
    beats = _host(beats)
    print(f"tempo: {est_bpm:.1f} BPM (true {bpm:.0f}); "
          f"beats (s): {np.round(beats, 3).tolist()}")
    assert abs(est_bpm - bpm) / bpm < 0.1, f"tempo {est_bpm} vs {bpm}"
    if beats.size >= 2:
        spacing = float(np.median(np.diff(beats)))
        assert abs(spacing - 60.0 / bpm) < 0.08

    # --- chords from chroma ----------------------------------------------
    C = _host(ap.chroma_cqt(y, sr=sr, hop_length=hop))
    beat_frames = int(round(60.0 / bpm * sr / hop))
    lead_frames = int(round(_LEAD * sr / hop))
    for i, (root, tones, _) in enumerate(_PROGRESSION):
        seg = C[:, lead_frames + i * beat_frames
                : lead_frames + (i + 1) * beat_frames]
        profile = np.median(seg, axis=-1)
        # template matching over all 12 major triads: the classic
        # chroma-based chord recognizer
        scores = [
            profile[r] + profile[(r + 4) % 12] + profile[(r + 7) % 12]
            for r in range(12)
        ]
        best = int(np.argmax(scores))
        print(f"beat {i}: detected {_NAMES[best]} major "
              f"(true {_NAMES[root]} major)")
        assert best == root, f"beat {i}: {_NAMES[best]} != {_NAMES[root]}"

    # --- melody from YIN --------------------------------------------------
    # YIN on the monophonic melody stem (f0 of a polyphonic mix is
    # ill-defined; YIN, like librosa's, is a monophonic tracker)
    f0 = _host(ap.yin(melody_stem, fmin=200.0, fmax=1200.0, sr=sr,
                      frame_length=2048, hop_length=hop))
    for i, (_, _, melody_hz) in enumerate(_PROGRESSION):
        # mid-beat frames, away from the onset transient
        lo = lead_frames + i * beat_frames + beat_frames // 4
        hi = lead_frames + (i + 1) * beat_frames - beat_frames // 4
        med = float(np.median(f0[lo:hi]))
        print(f"beat {i}: melody f0 {med:.1f} Hz (true {melody_hz:.1f})")
        assert abs(med - melody_hz) / melody_hz < 0.03

    # --- structure: the repeated C chord links across the clip ------------
    R = _host(ap.recurrence_matrix(C, k=4, width=beat_frames // 2,
                                   metric="cosine"))
    first_c = slice(lead_frames + beat_frames // 4,
                    lead_frames + 3 * beat_frames // 4)
    last_c = slice(lead_frames + 3 * beat_frames + beat_frames // 4,
                   lead_frames + 3 * beat_frames + 3 * beat_frames // 4)
    cross = R[first_c, last_c]
    print(f"structure: first-C x last-C recurrence density "
          f"{float(cross.mean()):.2f}")
    assert cross.mean() > 0.05, "repeated chord sections failed to link"

    print("music analysis OK: onsets, tempo/beats, chords, melody, and "
          "structure all recovered")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--bpm", type=float, default=120.0)
    p.add_argument("--sr", type=int, default=22050)
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    a = p.parse_args()
    main(a.bpm, a.sr, device=a.device)
