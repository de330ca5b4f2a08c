"""The bound arithmetic at the four cells' shapes, and the roofline reader."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from bench_port import bounds, registry, traffic

GTZAN = [661500] * 64


def cost(op, config, lengths):
    return registry.bound(op).cost(registry.config(config), lengths)


def test_filterbank_nonzeros():
    assert bounds.filterbank_nnz(registry.config("gtzan_librosa")) == 2018
    assert bounds.filterbank_nnz(registry.config("ljspeech_hifigan")) == 727


def test_logmel_at_64_by_30_s():
    F = 1 + 661500 // 512
    assert F == 1292
    fft = 2.5 * 2048 * 11
    flops, nbytes = cost("melspectrogram", "gtzan_librosa", GTZAN)
    assert flops == 64 * F * (2048 + fft + 3 * 1025 + 2 * 2018)
    assert nbytes == 4 * (64 * 661500 + 64 * 128 * F)
    flops, nbytes = cost("power_to_db", "gtzan_librosa", GTZAN)
    assert (flops, nbytes) == (6 * 64 * 128 * F, 8 * 64 * 128 * F)
    # compute-bound mel (80.8 us) plus memory-bound dB (25.3 us)
    least = sum(bounds.seconds(*cost(op, "gtzan_librosa", GTZAN))
                for op in ("melspectrogram", "power_to_db"))
    assert least == pytest.approx(106.09e-6, rel=1e-4)


def test_roundtrip_is_bound_by_bytes():
    F = 1292
    spectrum = 8 * 64 * 1025 * F
    for op in ("stft", "istft"):
        flops, nbytes = cost(op, "gtzan_librosa", GTZAN)
        assert nbytes == spectrum + 4 * 64 * 661500
        assert nbytes / bounds.HBM_BYTES_PER_S > flops / bounds.FP32_FLOPS
    least = sum(bounds.seconds(*cost(op, "gtzan_librosa", GTZAN)) for op in ("stft", "istft"))
    assert least == pytest.approx(505.9e-6, rel=1e-4)


def test_bucketed_counts_the_padded_batch():
    lengths = traffic.batch_lengths(registry.traffic("logmel_bucketed"),
                                    registry.config("ljspeech_hifigan"))[0]
    B, L = len(lengths), max(lengths)
    F = 1 + L // 256
    flops, nbytes = cost("melspectrogram", "ljspeech_hifigan", lengths)
    assert flops == B * F * (1024 + 2.5 * 1024 * 10 + 4 * 513 + 2 * 727)
    assert nbytes == 4 * (B * L + B * 80 * F)
    assert cost("amplitude_to_db", "ljspeech_hifigan", lengths)[1] == 8 * B * 80 * F


def test_feature_ops_each_read_the_clips():
    cfg = registry.config("gtzan_librosa")
    ops = registry.entry("features").ops(cfg)
    assert len(ops) == 10
    total = sum(bounds.seconds(*registry.bound(op).cost(cfg, GTZAN)) for op in ops)
    assert total == pytest.approx(605.5e-6, rel=1e-3)
    for op in ("spectral_centroid", "zero_crossing_rate", "rms"):
        assert cost(op, "gtzan_librosa", GTZAN)[1] == 4 * (64 * 661500 + 64 * 1292)
    assert math.isclose(cost("spectral_contrast", "gtzan_librosa", GTZAN)[1],
                        4 * (64 * 661500 + 7 * 64 * 1292))


def test_roofline_reader():
    read = registry.metric("roofline_pct.logmel")
    cfg = registry.config("gtzan_librosa")
    least = 106.08623570149254e-6
    run = SimpleNamespace(trace=SimpleNamespace(device_s=10 * 8 * least), entry="logmel",
                          cfg=cfg, ops=["melspectrogram", "power_to_db"], shapes=[GTZAN] * 2,
                          traced=SimpleNamespace(issued=[0, 1] * 4))
    assert read(run) == pytest.approx(10.0, rel=1e-6)
    assert registry.metric("roofline_pct.roundtrip")(run) is None
    run.trace = None
    assert read(run) is None
