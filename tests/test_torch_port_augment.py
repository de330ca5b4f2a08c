"""PyTorch port: SpecAugment masking, noise and gain against the JAX package.

The JAX functions take a ``jax.random`` key; the port's take a
``torch.Generator`` in its place, so the draws cannot match in bits. Each
port function is a draw and an apply: the parity tests draw the widths and
uniforms (or the noise, or the gains) with ``jax.random`` exactly as the
JAX function does, pass them to the port's apply and compare (masks equal,
noise and gain within 1e-6 of max). Separate tests hold the generator
path's properties: widths in ``0..mask_param``, starts in ``0..size-w``,
independent draws per clip, a seed reproduces its draws, and
``add_noise`` reaches its SNR on every clip.
"""

from __future__ import annotations

import importlib

import jax
import numpy as np
import pytest
import torch
from torch_port_util import max_rel, signals, to_np

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu_torch as tap

ja = importlib.import_module("mlx_audio_primitives_tpu.ops.augment")
ta = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.augment")

torch.set_num_threads(1)

FEATS = signals(120, (3, 20, 50)) + 5.0  # no value equals the fill
Y = signals(121, (4, 2000))


def jax_mask_draws(key, batch_shape, n_masks, mask_param):
    """The JAX ``_mask_axis``'s draws (`ops/augment.py:47-52` there)."""
    kw, ks = jax.random.split(key)
    w = jax.random.randint(kw, batch_shape + (n_masks,), 0, mask_param + 1)
    u = jax.random.uniform(ks, batch_shape + (n_masks,))
    return torch.from_numpy(np.asarray(w)), torch.from_numpy(np.asarray(u))


@pytest.mark.parametrize("which", ["time", "freq"])
@pytest.mark.parametrize("kw", [{}, dict(mask_param=7, n_masks=3, mask_value=-1.0),
                                dict(mask_param=100), dict(mask_param=0)],
                         ids=["default", "three", "clipped", "zero"])
@pytest.mark.parametrize("seed", [0, 1])
def test_mask_apply_matches_jax(which, kw, seed):
    key = jax.random.PRNGKey(seed)
    fn = getattr(ja, f"{which}_mask")
    axis = 2 if which == "time" else 1
    mask_param = min(kw.get("mask_param", 20 if which == "time" else 10), FEATS.shape[axis])
    w, u = jax_mask_draws(key, (3,), kw.get("n_masks", 1), mask_param)
    got = ta._mask_apply(torch.from_numpy(FEATS), w, u, axis, kw.get("mask_value", 0.0))
    np.testing.assert_array_equal(to_np(got), np.asarray(fn(FEATS, key, **kw)))


def test_spec_augment_matches_jax():
    key = jax.random.PRNGKey(7)
    kf, kt = jax.random.split(key)
    x = torch.from_numpy(FEATS)
    x = ta._mask_apply(x, *jax_mask_draws(kf, (3,), 2, 10), 1, 0.0)
    x = ta._mask_apply(x, *jax_mask_draws(kt, (3,), 2, 20), 2, 0.0)
    np.testing.assert_array_equal(to_np(x), np.asarray(ja.spec_augment(FEATS, key)))


@pytest.mark.parametrize("snr", [20.0, 0.0, np.array([10.0, 20.0, 30.0, 40.0], np.float32)],
                         ids=["20dB", "0dB", "per-clip"])
def test_noise_apply_matches_jax(snr):
    key = jax.random.PRNGKey(3)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, Y.shape, np.float32)))
    got = ta._noise_apply(torch.from_numpy(Y), noise, snr)
    assert max_rel(got, ja.add_noise(Y, key, snr)) <= 1e-6


@pytest.mark.parametrize("lo,hi", [(-6.0, 6.0), (0.0, 0.0), (-20.0, -3.0)])
def test_gain_apply_matches_jax(lo, hi):
    key = jax.random.PRNGKey(4)
    g = torch.from_numpy(np.asarray(jax.random.uniform(key, (4,), minval=lo, maxval=hi)))
    got = ta._gain_apply(torch.from_numpy(Y), g)
    assert max_rel(got, ja.random_gain(Y, key, lo, hi)) <= 1e-6


def _runs(masked_row: np.ndarray) -> list[tuple[int, int]]:
    """(start, width) of each run of True."""
    e = np.flatnonzero(np.diff(np.concatenate([[0], masked_row.astype(np.int8), [0]])))
    return [(int(a), int(b - a)) for a, b in zip(e[::2], e[1::2])]


@pytest.mark.parametrize("which,param", [("time", 12), ("freq", 6)])
def test_mask_draws_lie_in_range(which, param):
    fn = getattr(tap.augment, f"{which}_mask")
    axis = 2 if which == "time" else 1
    size = FEATS.shape[axis]
    gen = torch.Generator().manual_seed(0)
    widths = []
    for _ in range(50):
        out = to_np(fn(FEATS, gen, mask_param=param, n_masks=1, mask_value=0.0))
        hit = (out == 0.0).all(axis=3 - axis)  # (3, size)
        for b in range(3):
            runs = _runs(hit[b])
            assert len(runs) <= 1
            for t0, w in runs:
                assert 1 <= w <= param and 0 <= t0 <= size - w
                widths.append(w)
    assert len(set(widths)) > param // 2  # widths spread over the range


def test_draws_are_independent_per_clip_and_reproducible():
    x = np.repeat(FEATS[:1], 8, axis=0)
    a = to_np(tap.augment.spec_augment(x, torch.Generator().manual_seed(5)))
    b = to_np(tap.augment.spec_augment(x, torch.Generator().manual_seed(5)))
    np.testing.assert_array_equal(a, b)
    masks = [(a[i] == 0.0) for i in range(8)]
    assert len({m.tobytes() for m in masks}) == 8
    c = to_np(tap.augment.spec_augment(x, torch.Generator().manual_seed(6)))
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("snr", [20.0, -5.0, [5.0, 15.0, 25.0, 35.0]])
def test_add_noise_reaches_its_snr_per_clip(snr):
    y = torch.from_numpy(Y) * torch.tensor([[1.0], [0.1], [3.0], [1e-3]])
    out = tap.augment.add_noise(y, torch.Generator().manual_seed(1), snr)
    noise = (out - y).double()
    got = 10 * torch.log10((y.double() ** 2).mean(-1) / (noise**2).mean(-1))
    want = torch.broadcast_to(torch.as_tensor(snr, dtype=torch.float64), got.shape)
    assert float((got - want).abs().max()) <= 1e-3


def test_random_gain_range_and_seed():
    out = tap.augment.random_gain(Y, torch.Generator().manual_seed(2), -6.0, 6.0)
    g = 20 * np.log10(to_np(out)[:, 0] / Y[:, 0])
    assert np.all((g >= -6.0 - 1e-4) & (g <= 6.0 + 1e-4)) and len(set(np.round(g, 4))) == 4
    np.testing.assert_array_equal(
        to_np(tap.augment.random_gain(Y, torch.Generator().manual_seed(2), -6.0, 6.0)), to_np(out))


def test_errors_match_jax():
    key = jax.random.PRNGKey(0)
    gen = torch.Generator()
    for port, ref in (
        (lambda: tap.augment.time_mask(FEATS, gen, n_masks=0),
         lambda: jap.augment.time_mask(FEATS, key, n_masks=0)),
        (lambda: tap.augment.freq_mask(FEATS, gen, mask_param=-1),
         lambda: jap.augment.freq_mask(FEATS, key, mask_param=-1)),
        (lambda: tap.augment.random_gain(Y, gen, 3.0, 1.0),
         lambda: jap.augment.random_gain(Y, key, 3.0, 1.0)),
    ):
        with pytest.raises(ValueError) as e_port:
            port()
        with pytest.raises(ValueError) as e_jax:
            ref()
        assert str(e_port.value) == str(e_jax.value)
