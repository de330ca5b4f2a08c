"""PyTorch port: the input pipeline (`utils/data.py`, `utils/tree.py`).

``batch_iterator`` yields the JAX package's batches for the same seed;
``prefetch_to_device`` keeps order and values on the CPU and refuses what
it cannot place. The CUDA path (pinned staging, the side stream, the
consumer's stream waiting on the copy) runs in ``chip_smoke.py`` phase 4g,
where the prefetched log-mel is held bit for bit to the synchronous one.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (CPU placement, one thread)

import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu.utils.data import batch_iterator as jax_batches
from mlx_audio_primitives_tpu_torch.utils.data import batch_iterator, prefetch_to_device
from mlx_audio_primitives_tpu_torch.utils.tree import leaves, same_structure, tree_map


def _data(n: int = 11) -> dict:
    rng = np.random.default_rng(3)
    return {"y": rng.standard_normal((n, 5)).astype(np.float32),
            "label": np.arange(n), "meta": [np.arange(n) * 2, (np.ones((n, 2)),)]}


@pytest.mark.parametrize("kw", [
    dict(), dict(seed=5), dict(shuffle=False), dict(drop_remainder=False),
    dict(epochs=3, seed=1), dict(epochs=2, drop_remainder=False, seed=9),
], ids=str)
@pytest.mark.parametrize("batch_size", [1, 3, 4])
def test_batches_equal_jax(kw, batch_size):
    got = list(batch_iterator(_data(), batch_size, **kw))
    ref = list(jax_batches(_data(), batch_size, **kw))
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert same_structure(g, r)
        for a, b in zip(leaves(g), leaves(r)):
            np.testing.assert_array_equal(a, b)


def test_batch_iterator_covers_every_example_once():
    data = {"x": np.arange(10), "y": np.arange(10) * 2}
    seen = []
    for b in batch_iterator(data, 3, shuffle=True, seed=1):
        np.testing.assert_array_equal(b["y"], b["x"] * 2)
        seen.extend(b["x"].tolist())
    assert len(seen) == 9 and len(set(seen)) == 9
    full = [v for b in batch_iterator(data, 3, seed=1, drop_remainder=False) for v in b["x"].tolist()]
    assert sorted(full) == list(range(10))


def test_batch_iterator_transform_and_validation():
    data = np.arange(6, dtype=np.float32)
    out = list(batch_iterator(data, 2, shuffle=False, transform=lambda b: b + 1))
    np.testing.assert_array_equal(out[0], [1, 2])
    with pytest.raises(ValueError, match="batch_size"):
        list(batch_iterator(data, 0))
    with pytest.raises(ValueError, match="example axis"):
        list(batch_iterator({"a": np.zeros(3), "b": np.zeros(4)}, 2))
    with pytest.raises(ValueError, match="no array leaves"):
        list(batch_iterator({"a": None}, 2))


def test_prefetch_preserves_order_and_values():
    batches = [{"x": np.full((2, 3), i, np.float32), "i": np.asarray(i)} for i in range(7)]
    out = list(prefetch_to_device(iter(batches), size=3))
    assert len(out) == 7
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])
        assert int(b["i"]) == i


def test_prefetch_copies_rather_than_aliases():
    x = np.zeros(4, np.float32)
    (out,) = prefetch_to_device(iter([x]))
    x[:] = 1.0
    assert float(out.sum()) == 0.0


def test_prefetch_pulls_at_most_size_ahead():
    pulled = []

    def source():
        for i in range(6):
            pulled.append(i)
            yield np.asarray([i])

    it = prefetch_to_device(source(), size=2)
    first = next(it)
    assert int(first) == 0 and pulled == [0, 1, 2]  # two in flight beyond the one handed out
    assert [int(b) for b in it] == [1, 2, 3, 4, 5]


def test_prefetch_short_iterator_and_validation():
    assert list(prefetch_to_device(iter([]), size=4)) == []
    assert len(list(prefetch_to_device(iter([np.ones(2)]), size=4))) == 1
    with pytest.raises(ValueError, match="size"):
        list(prefetch_to_device(iter([]), size=0))


def test_prefetch_placement_arguments():
    batch = {"a": np.ones(3, np.float32), "b": [np.zeros(2), np.int64(4)]}
    for sharding in (torch.device("cpu"), "cpu", {"a": "cpu", "b": [torch.device("cpu"), "cpu"]}):
        (out,) = prefetch_to_device(iter([batch]), sharding=sharding)
        assert same_structure(out, batch)
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in leaves(out))
    # a pytree that does not match the batch, or a sharding spec, raises
    for bad in ({"a": "cpu"}, ["cpu", "cpu"], object()):
        with pytest.raises(ValueError, match="sharding"):
            list(prefetch_to_device(iter([batch]), sharding=bad))


def test_prefetch_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the raise needs its absence")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(prefetch_to_device(iter([np.ones(2)]), sharding=torch.device("cuda")))
    tap.set_default_device("cuda")  # sharding=None: the default device
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            list(prefetch_to_device(iter([np.ones(2)])))
    finally:
        tap.set_default_device("cpu")


def test_prefetch_composes_with_batch_iterator():
    data = {"x": np.random.default_rng(0).standard_normal((12, 5)).astype(np.float32)}
    got = [b["x"].numpy() for b in prefetch_to_device(batch_iterator(data, 4, seed=2))]
    ref = [b["x"] for b in jax_batches(data, 4, seed=2)]
    assert len(got) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_tree_helpers():
    Pair = collections.namedtuple("Pair", "a b")
    tree = {"z": [1, (2, None)], "a": Pair(3, {"k": 4})}
    assert leaves(tree) == [3, 4, 1, 2]  # sorted keys, None is empty
    doubled = tree_map(lambda v: 2 * v, tree)
    assert doubled == {"z": [2, (4, None)], "a": Pair(6, {"k": 8})}
    assert isinstance(doubled["a"], Pair)
    assert tree_map(lambda u, v: u + v, tree, doubled)["a"].a == 9
    assert same_structure(tree, doubled) and not same_structure(tree, {"z": [1, (2, None)]})
    assert not same_structure([1, 2], (1, 2))
