"""PyTorch port: ``models/`` frontends, presets, the conv classifier, the
deep classifier's serial forward, the data- and sequence-parallel train
steps, checkpoints and ``params_from_jax``,
against the JAX package.

Most cases run in this process at one rank: the same seeded NumPy inputs
and the JAX package's own initial parameters (carried across with
``params_from_jax``) go through both packages. The train steps on a
``(2, 2)`` mesh, and a checkpoint of DTensors saved from four ranks, run in
one spawned world of four gloo ranks (`torch_port_dist.py`), against the
JAX package on four of the conftest's virtual CPU devices.

Tolerances are the JAX package's own (`tests/test_parallel.py`,
`tests/test_convnet.py`, `tests/test_models.py`): train-step losses rtol
1e-5, parameters after a step rtol 2e-4 / atol 2e-6, log-mel features 2e-3
dB, the trainable frontend's kernel and plain routes 2e-4 dB; MFCC 1e-4 of
the maximum (`tests/test_torch_port_mfcc_framing.py`). A gradient is held
to 2e-4 of its largest entry, the parameter tolerance taken relative to the
gradient's scale (dB features differentiate through ``log10``, so entries
span orders of magnitude). Checkpoints are bit-equal.
"""

from __future__ import annotations

import collections
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_dist import case_results, run_world
from torch_port_util import max_rel, signals, to_np

import mlx_audio_primitives_tpu.models as jm
import mlx_audio_primitives_tpu.parallel as jp
import mlx_audio_primitives_tpu_torch.models as tm
import mlx_audio_primitives_tpu_torch.parallel as tp
from mlx_audio_primitives_tpu_torch.utils.interop import params_from_jax

jax_ck = importlib.import_module("mlx_audio_primitives_tpu.models.checkpoint")
tap_ck = importlib.import_module("mlx_audio_primitives_tpu_torch.models.checkpoint")

FE = (22050, 256, 64, 32)  # sr, n_fft, hop, n_mels of the trainers' frontend
CHANNELS = (8, 16)
N_CLASSES = 8
LEAF = dict(rtol=2e-4, atol=2e-6)
GRAD_TOL = 2e-4  # of the gradient's largest entry


def jfront(sr=FE[0], n_fft=FE[1], hop=FE[2], n_mels=FE[3]):
    return jm.TrainableLogMelFrontend(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels)


def tfront(sr=FE[0], n_fft=FE[1], hop=FE[2], n_mels=FE[3]):
    return tm.TrainableLogMelFrontend(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels)


def host(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix: str) -> dict[str, np.ndarray]:
    return {prefix + jax.tree_util.keystr(k, simple=True, separator="."): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_same_tree(got, ref):
    """Port tree (tensors or DTensors) against a JAX tree, leaf by leaf."""
    for path, a in jax.tree_util.tree_leaves_with_path(ref):
        b = got
        for k in path:
            b = b[k.key]
        if hasattr(b, "full_tensor"):
            b = b.full_tensor()
        np.testing.assert_allclose(to_np(b), np.asarray(a), **LEAF,
                                   err_msg=jax.tree_util.keystr(path))


def jax_step_ref(apply, params, y, labels, lr):
    """The single-device SGD step: the JAX package's own oracle."""
    def loss_fn(p):
        logp = jax.nn.log_softmax(apply(p, y), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=-1))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return jax.tree.map(lambda p, g: p - lr * g, params, grads), float(loss)


Y_TRAIN = signals(3, (8, 2048))
LABELS = np.random.default_rng(3).integers(0, N_CLASSES, 8).astype(np.int32)
LABELS5 = np.random.default_rng(4).integers(0, 5, 4).astype(np.int32)
Y_SEQ = signals(0, (4, 8192))


# ---------------------------------------------------------------------------
# Frontends and presets (one process)


@pytest.mark.parametrize("name", ["whisper", "vggish", "kaldi", "music"])
def test_presets_match_jax(name):
    sr = 22050 if name == "music" else 16000
    y = signals(11, (2, sr))
    got, ref = tm.PRESETS[name](), jm.PRESETS[name]()
    assert vars(got) == vars(ref)
    np.testing.assert_allclose(to_np(got(y)), np.asarray(ref(y)), atol=2e-3)


def test_logmel_frontend_and_mfcc_pipeline_match_jax():
    y = signals(12, (2, 22050))
    np.testing.assert_allclose(to_np(tm.LogMelFrontend(top_db=80.0)(y)),
                               np.asarray(jm.LogMelFrontend(top_db=80.0)(y)), atol=2e-3)
    assert max_rel(tm.MFCCPipeline(lifter=22)(y), jm.MFCCPipeline(lifter=22)(y)) <= 1e-4


@pytest.mark.parametrize("use_pallas", [False, True])
def test_trainable_frontend_forward_matches_jax(use_pallas):
    jf, tf = jfront(22050, 1024, 256, 32), tfront(22050, 1024, 256, 32)
    params = jf.init_params()
    y = signals(0, (2, 8192))
    got = tf.apply(params_from_jax(host(params)), y, use_pallas=use_pallas)
    np.testing.assert_allclose(to_np(got), np.asarray(jf.apply(params, y, use_pallas=False)),
                               atol=2e-4)
    # a 1-D clip, and int16 PCM cast to float32 as in the JAX package
    pcm = (signals(1, (8192,)) * 8192).astype(np.int16)
    np.testing.assert_allclose(to_np(tf.apply(params_from_jax(host(params)), pcm)),
                               np.asarray(jf.apply(params, pcm)), atol=2e-4)
    with pytest.raises(ValueError):
        tf.apply(params_from_jax(host(params)), np.zeros((2, 2, 8192), np.float32))


def test_init_params_are_fresh_copies():
    tf = tfront()
    a, b = tf.init_params(), tf.init_params()
    a["fb_t"].add_(1.0)
    np.testing.assert_allclose(to_np(b["fb_t"]), np.asarray(jfront().init_params()["fb_t"]),
                               atol=1e-7)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_trainable_frontend_gradients_match_jax(use_pallas):
    # d/d(fb_t) and d/dy of mean(dB^2), through K1's wrapper (its plain twin
    # on the CPU) and its plain-composition backward
    jf, tf = jfront(22050, 1024, 256, 32), tfront(22050, 1024, 256, 32)
    params = jf.init_params()
    y = signals(5, (2, 8192))
    g_fb, g_y = jax.jit(jax.grad(lambda p, x: jnp.mean(jf.apply(p, x, use_pallas=False) ** 2),
                                 argnums=(0, 1)))(params, jnp.asarray(y))
    p = params_from_jax(host(params))
    p["fb_t"].requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    torch.mean(tf.apply(p, yt, use_pallas=use_pallas) ** 2).backward()
    assert max_rel(p["fb_t"].grad, g_fb["fb_t"]) <= GRAD_TOL
    assert max_rel(yt.grad, g_y) <= GRAD_TOL


def test_pcen_frontend_forward_and_gradients_match_jax():
    jf = jm.pipelines.TrainablePCENFrontend(sr=16000, n_fft=512, hop_length=128, n_mels=40)
    tf = tm.pipelines.TrainablePCENFrontend(sr=16000, n_fft=512, hop_length=128, n_mels=40)
    params = jf.init_params()
    tparams = params_from_jax(host(params))
    assert sorted(tparams) == sorted(tf.init_params())
    for k, v in tf.init_params().items():
        np.testing.assert_allclose(to_np(v), np.asarray(params[k]), atol=1e-7, err_msg=k)
    y = signals(6, (2, 16000))
    ref = jax.jit(lambda p: jf.apply(p, y, use_pallas=False))(params)
    assert max_rel(tf.apply(tparams, y), ref) <= 1e-4
    grads = jax.jit(jax.grad(lambda p: jnp.mean(jf.apply(p, y, use_pallas=False))))(params)
    for v in tparams.values():
        v.requires_grad_(True)
    torch.mean(tf.apply(tparams, y)).backward()
    for k in params:
        assert max_rel(tparams[k].grad, grads[k]) <= GRAD_TOL, k


@pytest.mark.parametrize("shape", [(2, 32, 33), (2, 31, 37), (3, 40, 1)])
def test_convnet_apply_matches_jax_on_odd_frame_counts(shape):
    # XLA's SAME padding at stride 2 puts the odd sample on the high side
    params = jm.init_convnet_params(5, channels=(4, 8, 6), seed=2)
    feats = signals(7, shape) * 10.0
    got = tm.convnet_apply(params_from_jax(host(params)), torch.from_numpy(feats))
    np.testing.assert_allclose(to_np(got), np.asarray(jm.convnet_apply(params, feats)),
                               rtol=1e-5, atol=1e-5)


def test_init_functions_match_jax():
    jf, tf = jfront(), tfront()
    for got, ref in [
        (tm.init_audio_classifier_params(tf, 4, channels=(4, 8), seed=3),
         jm.init_audio_classifier_params(jf, 4, channels=(4, 8), seed=3)),
        (tm.init_deep_classifier_params(tf, 4, n_blocks=2, width=4, seed=1),
         jm.init_deep_classifier_params(jf, 4, n_blocks=2, width=4, seed=1)),
        (tm.init_classifier_params(32, 5, seed=9), jm.init_classifier_params(32, 5, seed=9)),
    ]:
        for path, a in jax.tree_util.tree_leaves_with_path(ref):
            b = got
            for k in path:
                b = b[k.key]
            assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
            np.testing.assert_allclose(to_np(b), np.asarray(a), atol=1e-7)


@pytest.mark.parametrize("use_pallas", [None, False])
def test_deep_classifier_apply_matches_jax(use_pallas):
    # the pipeline's serial forward at a small width, the JAX parameters
    # carried across; 1e-5 of the largest logit, as the pipeline step's
    params = jm.init_deep_classifier_params(jfront(), N_CLASSES, n_blocks=3, width=8, seed=4)
    y = signals(8, (3, 4096))
    got = tm.deep_classifier_apply(tfront(), params_from_jax(host(params)), y,
                                   use_pallas=use_pallas)
    ref = np.asarray(jm.deep_classifier_apply(jfront(), params, y, use_pallas=use_pallas))
    assert tuple(got.shape) == ref.shape == (3, N_CLASSES)
    assert np.abs(to_np(got) - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_convnet_step_at_one_rank_matches_jax(use_pallas):
    jf, tf = jfront(), tfront()
    params = jm.init_audio_classifier_params(jf, N_CLASSES, channels=CHANNELS)
    lr = 1e-2
    want, loss_ref = jax_step_ref(lambda p, y: jm.audio_classifier_apply(jf, p, y, False),
                                  params, jnp.asarray(Y_TRAIN), LABELS, lr)
    step = tm.make_convnet_train_step(tp.make_mesh(1, 1), tf, n_classes=N_CLASSES,
                                      channels=CHANNELS, lr=lr, use_pallas=use_pallas)
    new, loss = step(params_from_jax(host(params)), Y_TRAIN, LABELS)
    np.testing.assert_allclose(float(loss), loss_ref, rtol=1e-5)
    assert_same_tree(new, want)


def test_convnet_training_descends():
    tf = tfront()
    step = tm.make_convnet_train_step(tp.make_mesh(1, 1), tf, n_classes=N_CLASSES,
                                      channels=CHANNELS, lr=5e-2)
    params = tm.init_audio_classifier_params(tf, N_CLASSES, channels=CHANNELS)
    losses = []
    for _ in range(4):
        params, loss = step(params, Y_TRAIN, LABELS)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_model_batch_sharding_flattens_the_mesh():
    m = tp.make_mesh(1, 1)
    assert repr(tm.batch_sharding(m).placements) == "(Shard(dim=0), Shard(dim=0))"


# ---------------------------------------------------------------------------
# Checkpoints and params_from_jax (one process)


TREES = {
    "nested-dict": {"params": {"w": 1.0, "b": 2.0}, "step": 3},
    "list-tuple-none": [1.0, (2.0, None), {}],
    "one-tuple": (1.0,),
    "empty": (),
    "int-keys": {1: 2.0, 0: 3.0},
    "leaf": 5.0,
    "none": None,
    "namedtuple": collections.namedtuple("P", "a b")(1.0, {"z": 2.0}),
}


@pytest.mark.parametrize("name", list(TREES))
def test_treedef_string_is_jaxs(name):
    assert tap_ck._structure(TREES[name]) == str(jax.tree.structure(TREES[name]))


def _state(seed=7):
    params = jm.init_audio_classifier_params(jfront(), N_CLASSES, channels=CHANNELS, seed=seed)
    return {"params": params, "step": np.int32(42), "tag": None}


def test_port_checkpoint_restores_in_jax(tmp_path):
    state = _state()
    tstate = {"params": params_from_jax(host(state["params"])), "step": torch.tensor(42, dtype=torch.int32),
              "tag": None}
    written = tm.save_checkpoint(str(tmp_path / "ckpt"), tstate)
    assert written.endswith(".npz")
    back = jax_ck.restore_checkpoint(written, target=state)
    assert int(back["step"]) == 42
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back["params"]),
                                 jax.tree_util.tree_leaves_with_path(state["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))


def test_jax_checkpoint_restores_in_port(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_ck, "HAS_ORBAX", False)
    state = _state(seed=8)
    written = jax_ck.save_checkpoint(str(tmp_path / "jax_ckpt"), state)
    target = {"params": params_from_jax(host(state["params"])), "step": torch.tensor(0),
              "tag": None}
    back = tm.restore_checkpoint(written, target=target)
    assert int(back["step"]) == 42 and back["tag"] is None
    for path, a in jax.tree_util.tree_leaves_with_path(state["params"]):
        b = back["params"]
        for k in path:
            b = b[k.key]
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(to_np(b), np.asarray(a))


def test_checkpoint_roundtrip_and_errors(tmp_path):
    tf = tfront()
    state = {"params": tm.init_audio_classifier_params(tf, 4, channels=(4,)), "step": 3}
    path = str(tmp_path / "roundtrip")
    tm.save_checkpoint(path, state)
    back = tm.restore_checkpoint(path, target=state)
    assert int(back["step"]) == 3
    for k in ("conv0", "head"):
        for w in ("w", "b"):
            assert torch.equal(back["params"]["net"][k][w], state["params"]["net"][k][w])
    with pytest.raises(FileExistsError):
        tm.save_checkpoint(path, state, overwrite=False)
    with pytest.raises(ValueError, match="need `target`"):
        tm.restore_checkpoint(path)
    # same leaf count, another structure: rejected, not misassigned
    bad = {"params": state["params"], "steps": 3}
    with pytest.raises(ValueError, match="structure"):
        tm.restore_checkpoint(path, target=bad)
    assert tm.HAS_ORBAX is False


def test_orbax_directory_is_refused(tmp_path):
    if not jax_ck.HAS_ORBAX:
        pytest.skip("orbax is not installed")
    path = str(tmp_path / "orbax")
    jax_ck.save_checkpoint(path, {"x": jnp.ones(3)})
    with pytest.raises(ValueError, match="Orbax"):
        tm.restore_checkpoint(path, target={"x": torch.ones(3)})


def test_params_from_jax_copies_as_float32():
    params = host(jm.init_deep_classifier_params(jfront(), 4, n_blocks=4, width=8))
    got = params_from_jax(params)
    assert tuple(got["blocks"]["w"].shape) == (4, 8, 8, 3, 3)  # stacked OIHW blocks
    assert tuple(got["stem"]["w"].shape) == (8, 1, 3, 3)
    got["stem"]["w"].add_(1.0)  # no aliasing of the caller's arrays
    assert np.array_equal(params["stem"]["w"], np.asarray(
        jm.init_deep_classifier_params(jfront(), 4, n_blocks=4, width=8)["stem"]["w"]))
    f64 = params_from_jax({"a": np.arange(3, dtype=np.float64), "b": [np.ones(2)]})
    assert f64["a"].dtype == torch.float32 and f64["b"][0].dtype == torch.float32
    # the MoE tree's expert stacks and the transformer's 4-D attention
    # weights and position table keep their shapes and bits
    moe = host(jm.init_moe_classifier_params(jfront(), 4, n_experts=6, d_hidden=20))
    tr = host(jm.init_transformer_params(32, 4, n_frames=24, d_model=16, n_heads=2, d_ff=32,
                                         n_blocks=3))
    for tree in (moe, tr):
        got = params_from_jax(tree)
        for path, a in jax.tree_util.tree_leaves_with_path(tree):
            b = got
            for k in path:
                b = b[k.key]
            assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
            np.testing.assert_array_equal(b.numpy(), a, err_msg=jax.tree_util.keystr(path))
    got = params_from_jax(tr)
    assert tuple(got["blocks"]["attn"]["wq"].shape) == (3, 16, 2, 8)
    assert tuple(got["blocks"]["attn"]["wo"].shape) == (3, 2, 8, 16)
    assert tuple(got["pos"].shape) == (24, 16)
    assert tuple(params_from_jax(moe)["experts"]["w2"].shape) == (6, 20, 32)


def test_conv_same_turns_tf32_off_only_inside_its_calls(monkeypatch):
    """cuDNN runs float32 convolutions in TF32 while ``allow_tf32`` is True
    (PyTorch's default): ``_conv_same`` turns it off around its forward and
    both backward convolutions and gives the caller's value back. On the
    CPU the flag changes no number; the card check is `chip_smoke.py`'s."""
    from mlx_audio_primitives_tpu_torch.models import convnet

    seen = []

    def spy(fn):
        def wrapped(*args, **kw):
            seen.append((fn.__name__, torch.backends.cudnn.allow_tf32))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(convnet.tnf, "conv2d", spy(torch.nn.functional.conv2d))
    monkeypatch.setattr(torch.nn.grad, "conv2d_input", spy(torch.nn.grad.conv2d_input))
    monkeypatch.setattr(torch.nn.grad, "conv2d_weight", spy(torch.nn.grad.conv2d_weight))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x = torch.randn(2, 1, 9, 13, requires_grad=True)
    w = torch.randn(4, 1, 3, 3, requires_grad=True)
    out = convnet._conv_same(x, w, 2)
    assert torch.backends.cudnn.allow_tf32 is True
    out.sum().backward()
    assert torch.backends.cudnn.allow_tf32 is True
    assert seen == [("conv2d", False), ("conv2d_input", False), ("conv2d_weight", False)]
    # the same numbers as the plain convolution on the same padding
    ref = torch.nn.functional.conv2d(torch.nn.functional.pad(x, [1, 1, 1, 1]), w, stride=2)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The train steps and a checkpoint across four ranks


def _world_cases(ckpt: str) -> list[dict]:
    cases = [
        {"id": f"convnet-{name}", "job": "convnet",
         "args": dict(mesh=dims, frontend=FE, n_classes=N_CLASSES, channels=CHANNELS, lr=1e-2,
                      use_pallas=use_pallas)}
        for name, dims, use_pallas in [("2x2", (2, 2), False), ("2x2-kernel", (2, 2), True),
                                       ("4x1", (4, 1), False)]
    ]
    cases += [{"id": f"sharded-{mode}", "job": "sharded",
               "args": dict(mesh=(2, 2), fft_mode=mode, y="y_seq", n_fft=256, hop_length=64,
                            n_mels=32, n_classes=5, lr=0.05)}
              for mode in ("matmul", "fft", "pallas")]
    cases.append({"id": "checkpoint", "job": "checkpoint", "args": dict(path=ckpt)})
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("models_world")
    inputs = {
        **flat(host(jm.init_audio_classifier_params(jfront(), N_CLASSES, channels=CHANNELS)),
               "conv_params."),
        **flat(host(jm.init_classifier_params(32, 5)), "lin_params."),
        "y_train": Y_TRAIN, "y_seq": Y_SEQ, "labels": LABELS, "labels5": LABELS5,
    }
    return run_world(d, 4, _world_cases(str(d / "dtensor_ckpt")), inputs), d


def result(world, case: str, rank: int = 0) -> dict:
    got = case_results(world[0][rank], case)
    assert "error" not in got, got.get("error")
    return got


def _unflat(got: dict, like) -> dict:
    return jax.tree_util.tree_map_with_path(
        lambda path, _: got["p." + jax.tree_util.keystr(path, simple=True, separator=".")], like)


@pytest.mark.parametrize("name", ["2x2", "2x2-kernel", "4x1"])
def test_convnet_step_on_four_ranks_matches_jax(world, name):
    n_data, n_time = {"2x2": (2, 2), "2x2-kernel": (2, 2), "4x1": (4, 1)}[name]
    jf = jfront()
    params = jm.init_audio_classifier_params(jf, N_CLASSES, channels=CHANNELS)
    mesh = jp.make_mesh(n_data, n_time, devices=jax.devices()[:4])
    step = jax.jit(jm.make_convnet_train_step(mesh, jf, n_classes=N_CLASSES, channels=CHANNELS,
                                              lr=1e-2, use_pallas=False))
    want, loss_ref = step(params, Y_TRAIN, LABELS)
    for rank in range(4):
        got = result(world, f"convnet-{name}", rank)
        np.testing.assert_allclose(got["loss"][0], float(loss_ref), rtol=1e-5)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **LEAF),
                     _unflat(got, want), want)


@pytest.mark.parametrize("mode", ["matmul", "fft", "pallas"])
def test_sequence_parallel_step_on_four_ranks_matches_jax(world, mode):
    mesh = jp.make_mesh(2, 2, devices=jax.devices()[:4])
    params = jm.init_classifier_params(32, 5)
    step = jax.jit(jm.make_sharded_train_step(mesh, n_fft=256, hop_length=64, n_mels=32,
                                              n_classes=5, lr=0.05, fft_mode=mode))
    want, loss_ref = step(params, Y_SEQ, LABELS5)
    got = result(world, f"sharded-{mode}")
    np.testing.assert_allclose(got["loss"][0], float(loss_ref), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(got[f"p.{k}"], np.asarray(want[k]), **LEAF, err_msg=k)


def test_dtensor_checkpoint_from_four_ranks(world):
    written = None
    for rank in range(4):
        got = result(world, "checkpoint", rank)
        assert bool(got["same"]) and int(got["step"]) == 1
        written = str(got["written"])
    # the file holds the global tensors, readable by the JAX package
    jparams = jm.init_audio_classifier_params(jfront(), N_CLASSES, channels=CHANNELS)
    back = jax_ck.restore_checkpoint(written, target={"params": jparams, "step": 0})
    got = result(world, "checkpoint")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 back["params"], _unflat(got, jparams))
