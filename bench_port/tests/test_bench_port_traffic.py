"""The traffic generator: the audio each batch holds, the LJSpeech buckets,
and inputs that depend on the seed alone."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port import registry, traffic
from bench_port.clips import bucketed

SR = 22050


def shapes(config: str, mix: str):
    return traffic.batch_lengths(registry.traffic(mix), registry.config(config))


@pytest.mark.parametrize("mix", ["logmel", "roundtrip", "features"])
def test_gtzan_batches_hold_64_clips_of_30_s(mix):
    batches = shapes("gtzan_librosa", mix)
    assert len(batches) == registry.traffic(mix)["pool"]
    for lengths in batches:
        assert lengths == [30 * SR] * 64
        assert sum(lengths) / SR == 1920.0


def test_ljspeech_buckets():
    cfg = registry.config("ljspeech_hifigan")
    mix = registry.traffic("logmel_bucketed")
    batches = shapes("ljspeech_hifigan", "logmel_bucketed")
    law = cfg["clip_seconds"]
    edges = bucketed.edges(law, mix["clips"]["buckets"])
    assert len(batches) == mix["pool"] == 20
    assert len({(len(b), max(b)) for b in batches}) == 20
    for j, lengths in enumerate(batches):
        s = np.asarray(lengths) / SR
        bucket = j // mix["clips"]["batches_per_bucket"]
        assert s.min() >= edges[bucket] - 1 / SR and s.max() <= edges[bucket + 1] + 1 / SR
        assert law["min"] - 1 / SR <= s.min() and s.max() <= law["max"] + 1 / SR
        total = s.sum()
        assert 1920.0 - law["max"] < total <= 1920.0 + len(s) / SR


def test_buckets_hold_equal_shares_of_the_corpus_audio():
    """Under the configuration's length law each bucket holds a tenth of the
    audio, so two batches a bucket follow the corpus."""
    law = registry.config("ljspeech_hifigan")["clip_seconds"]
    edges = bucketed.edges(law, 10)
    assert edges[0] == law["min"] and edges[-1] == law["max"] and np.all(np.diff(edges) > 0)
    s = law["min"] + (law["max"] - law["min"]) * np.random.default_rng(0).beta(*law["beta"],
                                                                               size=2_000_000)
    audio = np.histogram(s, bins=edges, weights=s)[0]
    assert audio / audio.sum() == pytest.approx([0.1] * 10, abs=0.002)


def test_length_law_mean_is_ljspeech():
    law = registry.config("ljspeech_hifigan")["clip_seconds"]
    a, b = law["beta"]
    assert law["min"] + (law["max"] - law["min"]) * a / (a + b) == pytest.approx(law["mean"],
                                                                                 abs=0.01)


def test_shapes_do_not_depend_on_the_seed():
    assert shapes("ljspeech_hifigan", "logmel_bucketed") == shapes("ljspeech_hifigan",
                                                                     "logmel_bucketed")


def test_batch_is_seeded_and_zero_past_each_clip():
    lengths = [3000, 5000, 4100]
    a = traffic.make_batch(lengths, SR, torch.Generator().manual_seed(2**31 + 11), "cpu")
    b = traffic.make_batch(lengths, SR, torch.Generator().manual_seed(2**31 + 11), "cpu")
    c = traffic.make_batch(lengths, SR, torch.Generator().manual_seed(2**31 + 12), "cpu")
    assert torch.equal(a.y, b.y) and not torch.equal(a.y, c.y)
    assert a.y.shape == (3, 5000) and a.y.dtype == torch.float32
    assert a.audio_s == sum(lengths) / SR
    for i, n in enumerate(lengths):
        assert torch.all(a.y[i, n:] == 0) and torch.all(a.y[i, n - 10:n] != 0)
    assert 0 < float(a.y.abs().max()) < 1.0


def test_schedule_and_kept_batches():
    mix = registry.traffic("logmel_bucketed")
    sh = shapes("ljspeech_hifigan", "logmel_bucketed")
    order = traffic.schedule(len(sh), 3_000_000_017)
    assert sorted(order) == list(range(len(sh)))
    kept = traffic.kept(mix, sh, 3_000_000_017)
    assert len(kept) == mix["keep"]
    assert int(np.argmax([max(s) for s in sh])) in kept
    assert int(np.argmax([len(s) for s in sh])) in kept
