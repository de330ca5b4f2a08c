"""PyTorch port: the expert-parallel (Switch MoE) trainers against the JAX
package, leaf by leaf, and the ``all_to_all`` that carries their tokens.

The port's steps run in one spawned world of four gloo ranks
(`torch_port_dist.py`): the ep step on ``(1, 2)`` and ``(2, 2)`` meshes
(on ``(1, 2)`` ranks 2 and 3 hold no place and sit the step out), the
dp x ep x tp step on ``(1, 2, 2)`` and ``(2, 1, 2)``, four ep steps on
``(2, 2)``, and ``_comm.all_to_all`` over an expert axis of 4 and of 2.
The JAX package's steps run in this process on meshes of the same shape
over the conftest's virtual CPU devices, with the same initial parameters
(carried across with ``params_from_jax``) and the same batch; the dense
oracle is the port's own ``moe_classifier_apply`` with one routing group a
rank that holds tokens. Routing runs in this process in both packages.

Tolerances are the JAX package's (`tests/test_expert_parallel.py`): loss
rtol 1e-5, every parameter after the step rtol 2e-4 / atol 2e-6. The
dispatch tensors and the dropped tokens are compared exactly, and the
``all_to_all`` exactly too (a permutation moves values without rounding).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (non-tensor inputs go to the CPU)
from torch_port_dist import case_results, run_world

import mlx_audio_primitives_tpu.models as jm
import mlx_audio_primitives_tpu.parallel as jp
import mlx_audio_primitives_tpu_torch.models as tm
import mlx_audio_primitives_tpu_torch.parallel as tp
from mlx_audio_primitives_tpu.models import expert_parallel as jep
from mlx_audio_primitives_tpu_torch.models import expert_parallel as tep
from mlx_audio_primitives_tpu_torch.models.convnet import _local_grads
from mlx_audio_primitives_tpu_torch.models.pipelines import _nll_loss
from mlx_audio_primitives_tpu_torch.utils.interop import params_from_jax
from mlx_audio_primitives_tpu_torch.utils.tree import same_structure

FE = (22050, 256, 64, 32)  # sr, n_fft, hop, n_mels
N_EXPERTS, D_HIDDEN, CF, AUX = 4, 48, 1.25, 0.01
LEAF = dict(rtol=2e-4, atol=2e-6)
EP_CASES = {"1x2": (1, 2), "2x2": (2, 2)}
EP_TP_CASES = {"1x2x2": (1, 2, 2), "2x1x2": (2, 1, 2)}
A2A_CASES = {"e4-0-1": ((1, 4), 0, 1), "e4-1-0": ((1, 4), 1, 0), "e2-2-0": ((2, 2), 2, 0),
             "e4-1-1": ((1, 4), 1, 1)}
A2A_SHAPE = (8, 4, 12)


def jfront():
    return jm.TrainableLogMelFrontend(sr=FE[0], n_fft=FE[1], hop_length=FE[2], n_mels=FE[3])


def tfront():
    return tm.TrainableLogMelFrontend(sr=FE[0], n_fft=FE[1], hop_length=FE[2], n_mels=FE[3])


def _data(batch, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((batch, 2048)).astype(np.float32)
    return y, rng.integers(0, 8, size=(batch,)).astype(np.int32)


Y, LABELS = _data(8, 0)
Y16, LABELS16 = _data(16, 3)
PARAMS = jax.tree.map(np.asarray, jep.init_moe_classifier_params(
    jfront(), 8, n_experts=N_EXPERTS, d_hidden=D_HIDDEN))
A2A_X = np.random.default_rng(7).standard_normal((4, *A2A_SHAPE)).astype(np.float32)


def flat(tree, prefix: str) -> dict[str, np.ndarray]:
    return {prefix + jax.tree_util.keystr(k, simple=True, separator="."): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _cases() -> list[dict]:
    fe = dict(frontend=FE, n_experts=N_EXPERTS, d_hidden=D_HIDDEN)
    cases = [{"id": f"ep-{n}", "job": "ep", "args": dict(mesh=d, **fe)} for n, d in EP_CASES.items()]
    cases += [{"id": f"eptp-{n}", "job": "ep", "args": dict(mesh=d, tp=True, **fe)}
              for n, d in EP_TP_CASES.items()]
    cases.append({"id": "ep-descends", "job": "ep",
                  "args": dict(mesh=(2, 2), y="y16", labels="labels16", n_steps=4, **fe)})
    cases.append({"id": "ep-errors", "job": "ep_errors"})
    cases += [{"id": f"a2a-{n}", "job": "all_to_all",
               "args": dict(mesh=d, split_dim=s, concat_dim=c)}
              for n, (d, s, c) in A2A_CASES.items()]
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = {"y_train": Y, "labels": LABELS, "y16": Y16, "labels16": LABELS16, "a2a_x": A2A_X,
              **flat(PARAMS, "moe_params.")}
    return run_world(tmp_path_factory.mktemp("ep_world"), 4, _cases(), inputs)


def result(world, case: str, rank: int) -> dict:
    got = case_results(world[rank], case)
    assert "error" not in got, got.get("error")
    return got


def assert_leaves(got: dict, want) -> None:
    for path, ref in jax.tree_util.tree_leaves_with_path(want):
        key = "p." + jax.tree_util.keystr(path, simple=True, separator=".")
        np.testing.assert_allclose(got[key], np.asarray(ref), **LEAF, err_msg=key)


def dense_step(n_groups: int, lr: float = 1e-2):
    """The port's dense full-batch SGD step with ``n_groups`` routing groups."""
    fe = tfront()

    def loss_fn(p):
        logits, aux = tm.moe_classifier_apply(fe, p, Y, N_EXPERTS, capacity_factor=CF,
                                              n_groups=n_groups, use_pallas=False)
        return _nll_loss(logits, torch.from_numpy(LABELS)) + AUX * aux

    params = params_from_jax(PARAMS)
    loss, grads = _local_grads(loss_fn, params)
    return jax.tree.map(lambda p, g: (p - lr * g).numpy(), params, grads), float(loss)


def jax_step(make, mesh, **kw):
    step = jax.jit(make(mesh, jfront(), n_classes=8, n_experts=N_EXPERTS, d_hidden=D_HIDDEN,
                        capacity_factor=CF, aux_coef=AUX, use_pallas=False, **kw))
    return step(jax.tree.map(jnp.asarray, PARAMS), Y, LABELS)


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_step_matches_jax_and_the_dense_step(world, name):
    n_data, n_expert = EP_CASES[name]
    n_dev = n_data * n_expert
    want, loss = jax_step(jm.make_ep_train_step,
                          jp.make_ep_mesh(n_data, n_expert, devices=jax.devices()[:n_dev]))
    dense, dense_loss = dense_step(n_groups=n_dev)
    for rank in range(4):
        got = result(world, f"ep-{name}", rank)
        if rank >= n_dev:
            assert bool(got["outside"])
            continue
        np.testing.assert_allclose(got["loss"][0], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["loss"][0], dense_loss, rtol=1e-5)
        # each rank holds its n_experts / n_expert slice of the stack
        assert tuple(got["local_w1"]) == (N_EXPERTS // n_expert, FE[3], D_HIDDEN)
        assert_leaves(got, want)
        assert_leaves(got, dense)


@pytest.mark.parametrize("name", list(EP_TP_CASES))
def test_ep_tp_step_matches_jax_and_the_dense_step(world, name):
    n_data, n_expert, n_model = EP_TP_CASES[name]
    want, loss = jax_step(jm.make_ep_tp_train_step,
                          jp.make_moe_mesh(n_data, n_expert, n_model, devices=jax.devices()[:4]))
    # the 'model' axis never splits tokens: routing groups = data x expert
    dense, dense_loss = dense_step(n_groups=n_data * n_expert)
    for rank in range(4):
        got = result(world, f"eptp-{name}", rank)
        np.testing.assert_allclose(got["loss"][0], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["loss"][0], dense_loss, rtol=1e-5)
        # w1 column-parallel: its hidden dim sharded over 'model'
        assert tuple(got["local_w1"]) == (N_EXPERTS // n_expert, FE[3], D_HIDDEN // n_model)
        assert_leaves(got, want)
        assert_leaves(got, dense)


def test_ep_training_on_placed_params_descends_as_jax(world):
    mesh = jp.make_ep_mesh(2, 2, devices=jax.devices()[:4])
    params = jax.tree.map(jax.device_put, PARAMS, jm.moe_param_sharding(mesh))
    step = jax.jit(jm.make_ep_train_step(mesh, jfront(), n_classes=8, n_experts=N_EXPERTS,
                                         d_hidden=D_HIDDEN, use_pallas=False))
    y = jax.device_put(Y16, jm.ep_batch_sharding(mesh))
    losses = []
    for _ in range(4):
        params, loss = step(params, y, LABELS16)
        losses.append(float(loss))
    got = result(world, "ep-descends", 0)
    assert got["loss"][-1] < got["loss"][0]
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)


@pytest.mark.parametrize("n_groups", [1, 2, 4])
def test_routing_drops_the_tokens_jax_drops(n_groups):
    """Each package's frontend, tokens and router on the same batch: the
    dispatch tensors equal, so the same tokens go to the same slots and the
    same tokens are dropped."""
    B, bg = Y.shape[0], Y.shape[0] // n_groups
    jtok = jep._tokens_from_feats(jfront().apply(PARAMS["frontend"], Y, use_pallas=False))
    ttok = tep._tokens_from_feats(tfront().apply(params_from_jax(PARAMS["frontend"]), Y,
                                                 use_pallas=False))
    F = jtok.shape[1]
    capacity = jep.moe_capacity(bg * F, N_EXPERTS, CF)
    jgroups = jtok.reshape(n_groups, bg * F, -1)
    jd, jc, jaux = jax.vmap(lambda x: jep._route_tokens(x, PARAMS["router"], N_EXPERTS,
                                                         capacity))(jgroups)
    td, tc, taux = tep._route_tokens(ttok.reshape(n_groups, bg * F, -1),
                                     params_from_jax(PARAMS["router"]), N_EXPERTS, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    dropped = np.asarray(jd).sum(axis=(-2, -1)) == 0
    np.testing.assert_array_equal(td.numpy().sum(axis=(-2, -1)) == 0, dropped)
    assert dropped.any() and not dropped.all() and B == bg * n_groups
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=1e-5)


def test_tight_capacity_drops_tokens_and_changes_the_output():
    fe, params = tfront(), params_from_jax(PARAMS)
    tight, _ = tm.moe_classifier_apply(fe, params, Y[:4], N_EXPERTS, capacity_factor=0.05,
                                       use_pallas=False)
    roomy, _ = tm.moe_classifier_apply(fe, params, Y[:4], N_EXPERTS, capacity_factor=4.0,
                                       use_pallas=False)
    ref, _ = jm.moe_classifier_apply(jfront(), PARAMS, Y[:4], N_EXPERTS, capacity_factor=0.05,
                                     use_pallas=False)
    assert torch.isfinite(tight).all() and torch.isfinite(roomy).all()
    assert not np.allclose(tight.numpy(), roomy.numpy())
    np.testing.assert_allclose(tight.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_ep_step_at_one_rank_on_the_kernel_route_matches_jax():
    # on the CPU the kernel route is K1's plain twin, on the same path
    want, loss = jax_step(jm.make_ep_train_step, jp.make_ep_mesh(1, 1, devices=jax.devices()[:1]))
    step = tm.make_ep_train_step(tp.make_ep_mesh(1, 1), tfront(), n_classes=8,
                                 n_experts=N_EXPERTS, d_hidden=D_HIDDEN, use_pallas=True)
    new, got = step(params_from_jax(PARAMS), Y, LABELS)
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    assert_leaves(flat(jax.tree.map(lambda t: t.full_tensor().numpy(), new), "p."), want)


@pytest.mark.parametrize("name", list(A2A_CASES))
def test_all_to_all_and_its_gradient_against_gather_and_slice(world, name):
    (n_data, n_expert), s, c = A2A_CASES[name]
    x = torch.from_numpy(A2A_X).requires_grad_(True)
    # the reference: rank r of an expert row gathers every member's x and
    # keeps chunk r of its split dim, the members' chunks side by side on
    # the concatenated dim
    outs = []
    for rank in range(4):
        row = [rank // n_expert * n_expert + j for j in range(n_expert)]
        e = rank % n_expert
        outs.append(torch.cat([x[j].chunk(n_expert, dim=s)[e] for j in row], dim=c))
    ws = [torch.from_numpy(np.random.default_rng(100 + r).standard_normal(o.shape)
                           .astype(np.float32)) for r, o in enumerate(outs)]
    (grad,) = torch.autograd.grad(sum((o * w).sum() for o, w in zip(outs, ws)), (x,))
    for rank in range(4):
        got = result(world, f"a2a-{name}", rank)
        np.testing.assert_array_equal(got["out"], outs[rank].detach().numpy())
        np.testing.assert_allclose(got["grad"], grad[rank].numpy(), rtol=1e-6, atol=1e-6)


def test_all_to_all_of_one_rank_is_the_identity():
    m = tp.make_ep_mesh(1, 1)
    x = torch.arange(6.0).reshape(2, 3)
    assert tp._comm.all_to_all(x, m, tp.EXPERT_AXIS, split_dim=0, concat_dim=1) is x


def test_capacity_formula_matches_jax():
    for args in [(100, 4, 1.0), (100, 4, 1.25), (3, 8, 1.0), (504, 4, 1.25), (4032, 4, 1.25)]:
        assert tm.expert_parallel.moe_capacity(*args) == jep.moe_capacity(*args)


def test_init_matches_jax():
    for seed in (0, 3):
        want = jep.init_moe_classifier_params(jfront(), 8, n_experts=6, d_hidden=20, seed=seed)
        got = tep.init_moe_classifier_params(tfront(), 8, n_experts=6, d_hidden=20, seed=seed)
        for path, a in jax.tree_util.tree_leaves_with_path(want):
            b = got
            for k in path:
                b = b[k.key]
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("which", ["ep", "ep_tp"])
def test_spec_trees_match_jax_and_the_params(which):
    got = tm.moe_param_specs() if which == "ep" else tm.moe_tp_param_specs()
    ref = jm.moe_param_specs() if which == "ep" else jm.moe_tp_param_specs()
    params = tm.init_moe_classifier_params(tfront(), 8)
    assert same_structure(jax.tree.map(lambda _: 0, got), jax.tree.map(lambda _: 0, params))
    for path, spec in jax.tree_util.tree_leaves_with_path(
            ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
        node = got
        for k in path:
            node = node[k.key]
        assert tuple(node) == tuple(spec), jax.tree_util.keystr(path)


def test_placements_at_one_rank():
    s = tm.moe_param_sharding(tp.make_ep_mesh(1, 1))
    assert repr(s["experts"]["w1"].placements) == "(Replicate(), Shard(dim=0))"
    assert repr(s["router"]["w"].placements) == "(Replicate(), Replicate())"
    m = tp.make_moe_mesh(1, 1, 1)
    t = tm.moe_tp_param_sharding(m)
    assert repr(t["experts"]["w1"].placements) == "(Replicate(), Shard(dim=0), Shard(dim=2))"
    assert repr(t["experts"]["w2"].placements) == "(Replicate(), Shard(dim=0), Shard(dim=1))"
    assert repr(t["experts"]["b2"].placements) == "(Replicate(), Shard(dim=0), Replicate())"
    for fn in (tm.ep_batch_sharding, tm.moe_batch_sharding):
        assert repr(fn(m).placements) == "(Shard(dim=0), Shard(dim=0), Replicate())"


def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_validation_errors_match_jax():
    for args in [(4, 6, 8, 8), (2, 4, 6, 4), (0, 4, 8, 4)]:
        assert _message(lambda: tep.validate_ep_shapes(*args)) == \
            _message(lambda: jep.validate_ep_shapes(*args))
    tep.validate_ep_shapes(2, 4, 8, 4)
    params = tm.init_moe_classifier_params(tfront(), 8)
    assert _message(lambda: tm.moe_classifier_apply(tfront(), params, Y[:3], 4, n_groups=2)) == \
        _message(lambda: jm.moe_classifier_apply(jfront(), PARAMS, Y[:3], 4, n_groups=2))


def test_trainer_shape_errors_on_four_ranks_match_jax(world):
    ep = jp.make_ep_mesh(1, 4, devices=jax.devices()[:4])
    moe = jp.make_moe_mesh(1, 2, 2, devices=jax.devices()[:4])
    fe = jfront()
    want = {
        "ep_experts": _message(lambda: jm.make_ep_train_step(ep, fe, n_experts=6)),
        "ep_tp_experts": _message(lambda: jm.make_ep_tp_train_step(moe, fe, n_experts=3)),
        "ep_tp_hidden": _message(lambda: jm.make_ep_tp_train_step(moe, fe, n_experts=4,
                                                                  d_hidden=33)),
        "ep_batch": _message(lambda: jm.make_ep_train_step(ep, fe, n_classes=8)(
            PARAMS, Y[:6], LABELS[:6])),
    }
    for rank in range(4):
        got = result(world, "ep-errors", rank)
        assert {k: str(v) for k, v in got.items()} == want
