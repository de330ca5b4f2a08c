"""PyTorch port: the tensor- and pipeline-parallel train steps against the
JAX package, leaf by leaf.

The port's steps run in one spawned world of four gloo ranks
(`torch_port_dist.py`); the JAX package's run in this process on meshes of
the same shape over four of the conftest's virtual CPU devices, with the
same initial parameters (carried across with ``params_from_jax``) and the
same batch. Tensor parallelism runs on ``(2, 2)`` and ``(1, 4)`` meshes
(one odd-depth stack, which ends channel-sharded and gathers); the pipeline
at 2 and 4 stages, with one, two and four microbatches. On a 2-stage mesh
in a world of four, ranks 2 and 3 hold no stage and sit the step out.
Tolerances are the JAX package's (`tests/test_tensor_parallel.py`,
`tests/test_pipeline_parallel.py`): loss rtol 1e-5, every parameter after
the step rtol 2e-4 / atol 2e-6.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch_port_util  # noqa: F401  (non-tensor inputs go to the CPU)
from torch_port_dist import case_results, run_world

import mlx_audio_primitives_tpu.models as jm
import mlx_audio_primitives_tpu.parallel as jp
import mlx_audio_primitives_tpu_torch.models as tm
import mlx_audio_primitives_tpu_torch.parallel as tp
from mlx_audio_primitives_tpu.models import tensor_parallel as jtp
from mlx_audio_primitives_tpu_torch.models import tensor_parallel as ttp
from mlx_audio_primitives_tpu_torch.utils.tree import same_structure

FE = (22050, 256, 64, 32)
LEAF = dict(rtol=2e-4, atol=2e-6)
TP_CASES = {"2x2": ((2, 2), (8, 16)), "1x4": ((1, 4), (8, 16)), "2x2-odd": ((2, 2), (8,))}
PP_CASES = {"S2-b4-m2": (2, 4, 2), "S4-b4-m2": (4, 4, 2), "S2-b2-m4": (2, 2, 4),
            "S4-b8-m1": (4, 8, 1)}


def jfront():
    return jm.TrainableLogMelFrontend(sr=FE[0], n_fft=FE[1], hop_length=FE[2], n_mels=FE[3])


def _data(batch, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((batch, 2048)).astype(np.float32)
    return y, rng.integers(0, 8, size=(batch,)).astype(np.int32)


Y, LABELS = _data(4, 0)
Y8, LABELS8 = _data(8, 3)


def tp_params(channels):
    return jm.init_audio_classifier_params(jfront(), 8, channels=channels)


def pp_params(n_blocks):
    return jm.init_deep_classifier_params(jfront(), 8, n_blocks=n_blocks, width=8)


def flat(tree, prefix: str) -> dict[str, np.ndarray]:
    return {prefix + jax.tree_util.keystr(k, simple=True, separator="."): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _cases() -> list[dict]:
    cases = [{"id": f"tp-{name}", "job": "tp",
              "args": dict(mesh=dims, frontend=FE, n_classes=8, channels=ch)}
             for name, (dims, ch) in TP_CASES.items()]
    cases.append({"id": "tp-descends", "job": "tp",
                  "args": dict(mesh=(2, 2), frontend=FE, n_classes=8, channels=(8, 16), y="y8",
                               labels="labels8", n_steps=4)})
    cases += [{"id": f"pp-{name}", "job": "pp",
               "args": dict(mesh=[S], frontend=FE, n_classes=8, n_blocks=b, n_micro=m, width=8)}
              for name, (S, b, m) in PP_CASES.items()]
    cases.append({"id": "pp-descends", "job": "pp",
                  "args": dict(mesh=[4], frontend=FE, n_classes=8, n_blocks=4, n_micro=4,
                               width=8, y="y8", labels="labels8", n_steps=4)})
    cases.append({"id": "pp-indivisible", "job": "pp",
                  "args": dict(mesh=[4], frontend=FE, n_classes=8, n_blocks=6, n_micro=2,
                               width=8)})
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = {"y_train": Y, "labels": LABELS, "y8": Y8, "labels8": LABELS8}
    for ch in ((8, 16), (8,)):
        inputs.update(flat(tp_params(ch), f"tp_params_{len(ch)}."))
    for b in (2, 4, 8):
        inputs.update(flat(pp_params(b), f"pp_params_{b}."))
    return run_world(tmp_path_factory.mktemp("tp_pp_world"), 4, _cases(), inputs)


def result(world, case: str, rank: int) -> dict:
    got = case_results(world[rank], case)
    assert "error" not in got, got.get("error")
    return got


def assert_leaves(got: dict, want) -> None:
    for path, ref in jax.tree_util.tree_leaves_with_path(want):
        key = "p." + jax.tree_util.keystr(path, simple=True, separator=".")
        np.testing.assert_allclose(got[key], np.asarray(ref), **LEAF, err_msg=key)


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_step_matches_jax(world, name):
    (n_data, n_model), channels = TP_CASES[name]
    mesh = jp.make_tp_mesh(n_data, n_model, devices=jax.devices()[:4])
    step = jax.jit(jm.make_tp_train_step(mesh, jfront(), n_classes=8, channels=channels,
                                         use_pallas=False))
    want, loss = step(tp_params(channels), Y, LABELS)
    for rank in range(4):
        got = result(world, f"tp-{name}", rank)
        np.testing.assert_allclose(got["loss"][0], float(loss), rtol=1e-5)
        # the head's columns stay sharded over 'model'
        assert tuple(got["local_head_w"]) == (channels[-1], 8 // n_model)
        assert_leaves(got, want)


def test_tp_training_on_placed_params_descends_as_jax(world):
    mesh = jp.make_tp_mesh(2, 2, devices=jax.devices()[:4])
    params = jax.tree.map(jax.device_put, tp_params((8, 16)), jm.tp_param_sharding(mesh, (8, 16)))
    step = jax.jit(jm.make_tp_train_step(mesh, jfront(), n_classes=8, channels=(8, 16),
                                         use_pallas=False))
    losses = []
    for _ in range(4):
        params, loss = step(params, Y8, LABELS8)
        losses.append(float(loss))
    got = result(world, "tp-descends", 0)
    # the trajectory, as the JAX package's own multi-step test checks it
    # (the one-step tests above hold every leaf)
    assert got["loss"][-1] < got["loss"][0]
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)


@pytest.mark.parametrize("name", list(PP_CASES))
def test_pp_step_matches_jax(world, name):
    S, n_blocks, n_micro = PP_CASES[name]
    mesh = jp.make_pp_mesh(S, devices=jax.devices()[:S])
    step = jax.jit(jm.make_pp_train_step(mesh, jfront(), n_classes=8, n_blocks=n_blocks,
                                         width=8, n_microbatches=n_micro, use_pallas=False))
    want, loss = step(pp_params(n_blocks), Y, LABELS)
    for rank in range(4):
        got = result(world, f"pp-{name}", rank)
        if rank >= S:
            assert bool(got["outside"])
            continue
        np.testing.assert_allclose(got["loss"][0], float(loss), rtol=1e-5)
        # each stage holds its n_blocks / S slice of the stacked blocks
        assert tuple(got["local_blocks"]) == (n_blocks // S, 8, 8, 3, 3)
        assert_leaves(got, want)


def test_pp_training_descends_as_jax(world):
    mesh = jp.make_pp_mesh(4, devices=jax.devices()[:4])
    params = jax.tree.map(jax.device_put, pp_params(4), jm.pp_param_sharding(mesh))
    step = jax.jit(jm.make_pp_train_step(mesh, jfront(), n_classes=8, n_blocks=4, width=8,
                                         n_microbatches=4, use_pallas=False))
    losses = []
    for _ in range(4):
        params, loss = step(params, Y8, LABELS8)
        losses.append(float(loss))
    got = result(world, "pp-descends", 3)
    assert got["loss"][-1] < got["loss"][0]
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)


def test_pp_indivisible_stack_is_refused_as_in_jax(world):
    with pytest.raises(ValueError) as ref:
        jm.make_pp_train_step(jp.make_pp_mesh(4, devices=jax.devices()[:4]), jfront(),
                              n_blocks=6)
    assert str(case_results(world[0], "pp-indivisible")["error"]) == f"ValueError: {ref.value}"


def test_tp_shape_validation_matches_jax():
    for args in [(4, (6, 16), 8), (4, (8, 16), 10), (0, (8,), 8)]:
        with pytest.raises(ValueError) as ref:
            jtp.validate_tp_shapes(*args)
        with pytest.raises(ValueError, match=ref.value.args[0].replace("(", r"\(")
                           .replace(")", r"\)").replace("[", r"\[").replace("]", r"\]")):
            ttp.validate_tp_shapes(*args)
    ttp.validate_tp_shapes(2, (8, 16), 10)


@pytest.mark.parametrize("channels", [(8,), (8, 16), (4, 8, 12)])
def test_param_specs_match_jax(channels):
    got, ref = tm.tp_param_specs(channels), jm.tp_param_specs(channels)
    params = tm.init_audio_classifier_params(
        tm.TrainableLogMelFrontend(*FE), 12, channels=channels)
    assert same_structure(jax.tree.map(lambda _: 0, got), jax.tree.map(lambda _: 0, params))
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    for path, spec in flat_ref.items():
        node = got
        for k in path:
            node = node[k.key]
        assert tuple(node) == tuple(spec), jax.tree_util.keystr(path)
    pp, pref = tm.pp_param_specs(), jm.pp_param_specs()
    assert {g: {k: tuple(v) for k, v in d.items()} for g, d in pp.items()} == \
        {g: {k: tuple(v) for k, v in d.items()} for g, d in pref.items()}


def test_placements_at_one_rank():
    # the sharding trees carry one placement per mesh dimension
    m = tp.make_tp_mesh(1, 1)
    s = tm.tp_param_sharding(m, (8, 16))
    assert repr(s["net"]["conv0"]["w"].placements) == "(Replicate(), Shard(dim=0))"
    assert repr(s["net"]["conv1"]["w"].placements) == "(Replicate(), Shard(dim=1))"
    assert repr(s["net"]["conv1"]["b"].placements) == "(Replicate(), Replicate())"
    assert repr(s["net"]["head"]["w"].placements) == "(Replicate(), Shard(dim=1))"
    p = tm.pp_param_sharding(tp.make_pp_mesh(1))
    assert repr(p["blocks"]["w"].placements) == "(Shard(dim=0),)"
    assert repr(p["stem"]["w"].placements) == "(Replicate(),)"
