"""The one generator of every traffic mix: batch shapes from the mix's data
file and the configuration (``clips/<kind>.py``), waveforms from the run's
seed on the device (``audio/<kind>.py``), and the order and the kept
batches of the window.

Shapes never depend on the seed: every seed gets the same batches, with
other audio in them and in another order, so that runs with different seeds
do the same work. A batch is padded to its longest clip; its audio is the
sum of its clips' own lengths.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import registry


@dataclass
class Batch:
    y: torch.Tensor          # (B, L) float32 on the device, zero past each clip
    lengths: list[int]       # each clip's own length in samples
    audio_s: float           # seconds of audio, padding excluded


def batch_lengths(mix: dict, cfg: dict) -> list[list[int]]:
    """The clip lengths (samples) of every batch of the pool, seed-free."""
    return registry.clips(mix["clips"]["kind"]).lengths(mix["clips"], cfg, mix["pool"])


def make_batch(lengths: list[int], sr: int, gen: torch.Generator, device,
               audio: str = "tones") -> Batch:
    y = registry.audio(audio).make(lengths, sr, gen, device)
    return Batch(y, list(lengths), sum(lengths) / sr)


def make_pool(mix: dict, cfg: dict, seed: int, device) -> list[Batch]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    return [make_batch(lengths, cfg["sr"], gen, device, mix["audio"])
            for lengths in batch_lengths(mix, cfg)]


def schedule(n_pool: int, seed: int) -> list[int]:
    """The order in which the window cycles through the pool: a permutation
    drawn from the seed."""
    return [int(i) for i in np.random.default_rng(seed % 2**63).permutation(n_pool)]


def kept(mix: dict, shapes: list[list[int]], seed: int) -> list[int]:
    """The pool batches whose last outputs the window keeps for the check:
    ``keep`` of them, drawn from the seed, among them the batch with the
    longest clip and the one with the most clips (the first of each)."""
    n = len(shapes)
    longest = max(range(n), key=lambda i: max(shapes[i]))
    widest = max(range(n), key=lambda i: len(shapes[i]))
    picks = [longest] + ([widest] if widest != longest else [])
    for i in np.random.default_rng((seed % 2**63) + 1).permutation(n):
        if len(picks) >= mix["keep"]:
            break
        if int(i) not in picks:
            picks.append(int(i))
    return sorted(picks)
