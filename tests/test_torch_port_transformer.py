"""PyTorch port: the ring-attention transformer and its context-parallel
train step against the JAX package, leaf by leaf.

The port's multi-rank cases run in one spawned world of four gloo ranks
(`torch_port_dist.py`): ``ring_attention`` on ``(1, 2)`` and ``(1, 4)``
meshes with the gradients of a weighted sum of its output, and the cp step
on ``(1, 2)``, ``(2, 2)`` and ``(1, 4)`` with ``fft_mode='matmul'``, on
``(2, 2)`` also with 'pallas' (on the CPU, K1's plain twin) and for five
steps (on ``(1, 2)`` ranks 2 and 3 hold no place and sit the step out).
The JAX package's step runs in this process on meshes of the same shape
over the conftest's virtual CPU devices, with the same initial parameters
(carried across with ``params_from_jax``) and the same batch; the oracle
is the port's own ``single_device_cp_oracle``.

Tolerances are the JAX package's (`tests/test_transformer.py`): ring
against full attention atol 2e-6 / rtol 2e-5, the step's loss rtol 1e-4,
every parameter after it atol 5e-6 / rtol 5e-4; the encoder's logits
against JAX's 1e-5 of their largest.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (non-tensor inputs go to the CPU)
from jax import shard_map
from jax.sharding import PartitionSpec
from torch_port_dist import case_results, run_world

import mlx_audio_primitives_tpu.models as jm
import mlx_audio_primitives_tpu.parallel as jp
import mlx_audio_primitives_tpu_torch.models as tm
import mlx_audio_primitives_tpu_torch.parallel as tp
from mlx_audio_primitives_tpu.models import transformer as jtr
from mlx_audio_primitives_tpu_torch.models import transformer as ttr
from mlx_audio_primitives_tpu_torch.utils.interop import params_from_jax
from mlx_audio_primitives_tpu_torch.utils.tree import same_structure

FE = (22050, 256, 64, 32)  # sr, n_fft, hop, n_mels
SR, N_FFT, HOP, N_MELS = FE
WIDTHS = dict(d_model=16, n_heads=2, d_ff=32, n_blocks=2)
LEAF = dict(atol=5e-6, rtol=5e-4)
RING = dict(atol=2e-6, rtol=2e-5)
N_FRAMES = 32  # rows of the pos table: the longest sequence below
CP_CASES = {"1x2": ((1, 2), "matmul"), "2x2": ((2, 2), "matmul"), "1x4": ((1, 4), "matmul"),
            "2x2-pallas": ((2, 2), "pallas")}
RING_CASES = {"1x2": (1, 2), "1x4": (1, 4)}
RING_SHAPE = (2, 16, 3, 4)  # (B, T, H, dh)


def _data(batch, L, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((batch, L)).astype(np.float32)
    return y, rng.integers(0, 6, size=(batch,)).astype(np.int32)


def cp_data(n_data, n_time):
    """The JAX test's sizes: 2 clips a data rank, 8 tokens a time rank."""
    return _data(2 * n_data, 8 * n_time * HOP, seed=n_data * 10 + n_time)


PARAMS = jax.tree.map(np.asarray, jtr.init_transformer_params(N_MELS, 6, n_frames=N_FRAMES,
                                                              **WIDTHS))
_rng = np.random.default_rng(1)
RING_QKVW = [(_rng.standard_normal(RING_SHAPE) * s).astype(np.float32) for s in (3, 3, 3, 1)]


def flat(tree, prefix: str) -> dict[str, np.ndarray]:
    return {prefix + jax.tree_util.keystr(k, simple=True, separator="."): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _cases() -> list[dict]:
    cases = []
    for name, (dims, mode) in CP_CASES.items():
        y = f"y_{dims[0]}x{dims[1]}"
        cases.append({"id": f"cp-{name}", "job": "cp",
                      "args": dict(mesh=dims, frontend=FE, y=y, labels="l" + y, fft_mode=mode)})
    cases.append({"id": "cp-descends", "job": "cp",
                  "args": dict(mesh=(2, 2), frontend=FE, y="y_2x2", labels="ly_2x2", n_steps=5)})
    cases += [{"id": f"ring-{n}", "job": "ring", "args": dict(mesh=d)} for n, d in RING_CASES.items()]
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = {**flat(PARAMS, "cp_params."),
              **dict(zip(("ring_q", "ring_k", "ring_v", "ring_w"), RING_QKVW))}
    for dims in {d for d, _ in CP_CASES.values()}:
        y, labels = cp_data(*dims)
        inputs[f"y_{dims[0]}x{dims[1]}"], inputs[f"ly_{dims[0]}x{dims[1]}"] = y, labels
    return run_world(tmp_path_factory.mktemp("cp_world"), 4, _cases(), inputs)


def result(world, case: str, rank: int) -> dict:
    got = case_results(world[rank], case)
    assert "error" not in got, got.get("error")
    return got


def assert_leaves(got: dict, want, tol=LEAF) -> None:
    for path, ref in jax.tree_util.tree_leaves_with_path(want):
        key = "p." + jax.tree_util.keystr(path, simple=True, separator=".")
        np.testing.assert_allclose(got[key], np.asarray(ref), **tol, err_msg=key)


def port_oracle(y, labels, lr=1e-2):
    new, loss = ttr.single_device_cp_oracle(params_from_jax(PARAMS), y, labels, sr=SR,
                                            n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS, lr=lr)
    return jax.tree.map(lambda t: t.numpy(), new), float(loss)


def jax_step(n_data, n_time, y, labels, n_steps=1, fft_mode="matmul"):
    mesh = jp.make_mesh(n_data, n_time, devices=jax.devices()[: n_data * n_time])
    step = jax.jit(jm.make_cp_train_step(mesh, sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS,
                                         n_classes=6, fft_mode=fft_mode, **WIDTHS))
    params = jax.tree.map(jax.device_put, PARAMS, jm.transformer_param_sharding(mesh, PARAMS))
    yd = jax.device_put(y, jp.batch_time_sharding(mesh))
    losses = []
    for _ in range(n_steps):
        params, loss = step(params, yd, labels)
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("name", list(CP_CASES))
def test_cp_step_matches_jax_and_the_oracle(world, name):
    (n_data, n_time), mode = CP_CASES[name]
    y, labels = cp_data(n_data, n_time)
    # the JAX package's 'pallas' frontend is its kernel; its 'matmul' is
    # the chain the port's plain twin of K1 follows on the CPU
    want, (loss,) = jax_step(n_data, n_time, y, labels)
    oracle, oracle_loss = port_oracle(y, labels)
    for rank in range(4):
        got = result(world, f"cp-{name}", rank)
        if rank >= n_data * n_time:
            assert bool(got["outside"])
            continue
        np.testing.assert_allclose(got["loss"][0], loss, rtol=1e-4)
        np.testing.assert_allclose(got["loss"][0], oracle_loss, rtol=1e-4)
        assert_leaves(got, want)
        assert_leaves(got, oracle)


def test_cp_training_descends_as_jax(world):
    y, labels = cp_data(2, 2)
    _, losses = jax_step(2, 2, y, labels, n_steps=5)
    got = result(world, "cp-descends", 3)
    assert np.isfinite(got["loss"]).all() and got["loss"][-1] < got["loss"][0]
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-4)


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_attention_matches_full_attention_and_jax(world, name):
    n_data, n_time = RING_CASES[name]
    q, k, v, w = (torch.from_numpy(a).requires_grad_(i < 3) for i, a in enumerate(RING_QKVW))
    full = ttr._full_attention(q, k, v)
    grads = torch.autograd.grad((full * w).sum(), (q, k, v))
    mesh = jp.make_mesh(n_data, n_time, devices=jax.devices()[:n_time])
    spec = PartitionSpec(None, "time")
    jring = shard_map(lambda a, b, c: jtr.ring_attention(a, b, c, "time"), mesh=mesh,
                      in_specs=(spec, spec, spec), out_specs=spec)(*RING_QKVW[:3])
    for rank in range(4):
        got = result(world, f"ring-{name}", rank)
        if rank >= n_time:
            assert bool(got["outside"])
            continue
        np.testing.assert_allclose(got["out"], full.detach().numpy(), **RING)
        np.testing.assert_allclose(got["out"], np.asarray(jring), **RING)
        for n, g in zip("qkv", grads):
            np.testing.assert_allclose(got[f"grad_{n}"], g.numpy(), **RING, err_msg=n)


def test_ring_attention_at_one_rank_is_full_attention():
    m = tp.make_mesh(1, 1)
    q, k, v = (torch.from_numpy(a) for a in RING_QKVW[:3])
    np.testing.assert_allclose(tm.ring_attention(q, k, v, m[tp.TIME_AXIS]).numpy(),
                               ttr._full_attention(q, k, v).numpy(), **RING)


def test_cp_step_at_one_rank_on_the_kernel_route_matches_jax():
    y, labels = cp_data(1, 1)
    want, (loss,) = jax_step(1, 1, y, labels)
    step = tm.make_cp_train_step(tp.make_mesh(1, 1), sr=SR, n_fft=N_FFT, hop_length=HOP,
                                 n_mels=N_MELS, n_classes=6, fft_mode="pallas", **WIDTHS)
    new, got = step(params_from_jax(PARAMS), y, labels)
    np.testing.assert_allclose(float(got), loss, rtol=1e-4)
    assert_leaves(flat(jax.tree.map(lambda t: t.full_tensor().numpy(), new), "p."), want)


def test_oracle_matches_jax():
    y, labels = cp_data(2, 2)
    want, loss = jtr.single_device_cp_oracle(PARAMS, y, labels, sr=SR, n_fft=N_FFT,
                                             hop_length=HOP, n_mels=N_MELS)
    got, got_loss = port_oracle(y, labels)
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    assert_leaves(flat(got, "p."), want)


def test_apply_and_logits_match_jax():
    feats = np.random.default_rng(0).standard_normal((3, N_MELS, 32)).astype(np.float32)
    want = np.asarray(jm.transformer_apply(PARAMS, feats))
    got = tm.transformer_apply(params_from_jax(PARAMS), feats).numpy()
    assert got.shape == (3, 6)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    tokens = feats.transpose(0, 2, 1)[:, :20]
    np.testing.assert_allclose(ttr.transformer_logits(params_from_jax(PARAMS),
                                                      torch.from_numpy(tokens)).numpy(),
                               np.asarray(jtr.transformer_logits(PARAMS, tokens)),
                               rtol=1e-5, atol=1e-6)


def test_blocks_match_jax():
    x = np.random.default_rng(2).standard_normal((2, 5, 16)).astype(np.float32)
    blk = jax.tree.map(lambda a: a[0], PARAMS["blocks"])
    tblk = params_from_jax(blk)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(ttr._layernorm(tx, tblk["ln1"]["g"] * 1.5, tblk["ln1"]["b"] + 0.1)
                               .numpy(), np.asarray(jtr._layernorm(x, blk["ln1"]["g"] * 1.5,
                                                                    blk["ln1"]["b"] + 0.1)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ttr._mlp(tblk["mlp"], tx).numpy(),
                               np.asarray(jtr._mlp(blk["mlp"], x)), rtol=1e-5, atol=1e-6)
    for a, b in zip(ttr._qkv(tblk["attn"], tx), jtr._qkv(blk["attn"], x)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    toks = x[..., :N_MELS // 2]
    np.testing.assert_allclose(ttr._standardize_tokens(torch.from_numpy(toks)).numpy(),
                               np.asarray(jtr._standardize_tokens(toks)), rtol=1e-5, atol=1e-6)


def test_init_positions_and_specs_match_jax():
    for seed in (0, 4):
        want = jtr.init_transformer_params(N_MELS, 5, 12, d_model=8, n_heads=4, d_ff=8,
                                           n_blocks=3, seed=seed)
        got = ttr.init_transformer_params(N_MELS, 5, 12, d_model=8, n_heads=4, d_ff=8,
                                          n_blocks=3, seed=seed)
        for path, a in jax.tree_util.tree_leaves_with_path(want):
            b = got
            for k in path:
                b = b[k.key]
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=jax.tree_util.keystr(path))
    np.testing.assert_array_equal(tm.transformer.sinusoidal_positions(16, 8),
                                  jtr.sinusoidal_positions(16, 8))
    specs = tm.transformer_param_specs()
    assert same_structure(jax.tree.map(lambda _: 0, specs),
                          jax.tree.map(lambda _: 0, params_from_jax(PARAMS)))
    assert all(tuple(s) == () for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, tp.mesh.PartitionSpec)))
    s = tm.transformer_param_sharding(tp.make_mesh(1, 1), params_from_jax(PARAMS))
    assert repr(s["blocks"]["attn"]["wq"].placements) == "(Replicate(), Replicate())"


def test_errors_match_jax():
    with pytest.raises(ValueError) as ref:
        jm.init_transformer_params(8, 2, 4, d_model=10, n_heads=4)
    with pytest.raises(ValueError) as got:
        tm.init_transformer_params(8, 2, 4, d_model=10, n_heads=4)
    assert str(got.value) == str(ref.value)
    step = tm.make_cp_train_step(tp.make_mesh(1, 1), sr=SR, n_fft=N_FFT, hop_length=HOP,
                                 n_mels=N_MELS, n_classes=6, **WIDTHS)
    y, labels = cp_data(1, 1)
    # a waveform off the frame grid: the time-sharded frontend's error
    with pytest.raises(ValueError) as ref:
        jm.make_cp_train_step(jp.make_mesh(1, 1, devices=jax.devices()[:1]), sr=SR, n_fft=N_FFT,
                              hop_length=HOP, n_mels=N_MELS, n_classes=6,
                              **WIDTHS)(PARAMS, y[:, :-3], labels)
    with pytest.raises(ValueError) as got:
        step(params_from_jax(PARAMS), y[:, :-3], labels)
    assert str(got.value) == str(ref.value)
    # a pos table shorter than the sequence
    short = dict(params_from_jax(PARAMS), pos=torch.zeros((4, 16)))
    with pytest.raises(ValueError, match="pos table has 4 rows"):
        step(short, y, labels)
