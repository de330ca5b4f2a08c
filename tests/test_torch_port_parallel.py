"""PyTorch port: ``parallel/`` (meshes, batch sharding, and the time-sharded
STFT, ISTFT and log-mel) against the JAX package on meshes of the same
shape.

The port runs in one spawned world of four gloo ranks on the CPU
(`torch_port_dist.py`), the JAX package in this process on four of the
conftest's eight virtual CPU devices. Both meshes are ``(2, 2)`` or
``(1, 4)``: the second has two middle shards, which receive a halo and
pass one on. The time-sharded ops run their three per-shard transforms
('matmul', 'fft', 'pallas': the kernels' plain twins on the port's CPU
tensors, interpret-mode Pallas in the JAX package), uncentred on a
shardable length, centred on a prime length (no divisibility at all), and
centred at a radix-gate shape (n_fft 1024, hop 256), where 'pallas' takes
the kernel wrappers (elsewhere it turns into 'fft' in both packages).
Tolerances are the JAX package's own (`tests/test_parallel.py`): STFT
2e-4, log-mel 2e-3 dB, ISTFT 1e-4, data-parallel ``melspectrogram`` rtol
1e-5, and Griffin-Lim 1e-4 of the signal's maximum
(`tests/test_torch_port_griffinlim.py`). ``shard_batch`` gives the same
global value and batch sharding as the JAX function, and the axis names
are the JAX strings.
"""

from __future__ import annotations

import functools
import re
import warnings

import jax
import numpy as np
import pytest
import torch
from torch_port_dist import case_results, run_world
from torch_port_util import signals

import mlx_audio_primitives_tpu as jap
import mlx_audio_primitives_tpu.parallel as jp
import mlx_audio_primitives_tpu_torch as tap
import mlx_audio_primitives_tpu_torch.parallel as tp

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
MODES = ("matmul", "fft", "pallas")
#: (input, n_fft, hop, center, extra kwargs) of each time-sharded layout
LAYOUTS = {
    "uncentred": ("y_unc", 256, 64, False, {}),
    "prime-length": ("y_prime", 256, 64, True, {}),
    "radix": ("y_radix", 1024, 256, True, {}),
}
LENGTHS = {"uncentred": None, "prime-length": 10007, "radix": 9001}
N_MELS = 32

INPUTS = {
    "y_unc": signals(0, (4, 4 * 8 * 256)),
    "y_prime": signals(7, (4, 10007)),
    "y_radix": signals(21, (2, 9001)),
    "y_win": signals(8, (2, 6000)),
    "y_small": signals(9, (2, 4096)),
    "y_dp": signals(1, (8, 2048)),
}


@functools.lru_cache(maxsize=None)
def jax_mesh(name: str):
    n_data, n_time = MESHES[name]
    return jp.make_mesh(n_data, n_time, devices=jax.devices()[: n_data * n_time])


def jax_sharded(fn, mesh: str, x: np.ndarray, **kw) -> np.ndarray:
    return np.asarray(jax.jit(functools.partial(fn, mesh=jax_mesh(mesh), **kw))(x))


def _spectrum(layout: str, mesh: str, mode: str) -> np.ndarray:
    """The frames-major spectrum the ISTFT cases invert: the JAX package's
    ``stft_time_sharded`` of the layout's signal."""
    y, n_fft, hop, center, _ = LAYOUTS[layout]
    return jax_sharded(jp.stft_time_sharded, mesh, INPUTS[y], n_fft=n_fft, hop_length=hop,
                       center=center, fft_mode=mode)


def _cases() -> list[dict]:
    cases = [{"id": "meshes", "job": "meshes"}, {"id": "errors", "job": "errors"}]
    for mesh, dims in MESHES.items():
        for layout, (y, n_fft, hop, center, extra) in LAYOUTS.items():
            for mode in MODES:
                kw = dict(n_fft=n_fft, hop_length=hop, center=center, fft_mode=mode, **extra)
                cases.append({"id": f"stft-{mesh}-{layout}-{mode}", "job": "stft",
                              "args": dict(mesh=dims, y=y, **kw)})
                cases.append({"id": f"logmel-{mesh}-{layout}-{mode}", "job": "logmel",
                              "args": dict(mesh=dims, y=y, n_mels=N_MELS, **kw)})
                cases.append({"id": f"istft-{mesh}-{layout}-{mode}", "job": "istft",
                              "args": dict(mesh=dims, S=f"S:{mesh}:{layout}:{mode}",
                                           length=LENGTHS[layout], **kw)})
        cases.append({"id": f"stft-{mesh}-win160-reflect", "job": "stft",
                      "args": dict(mesh=dims, y="y_win", n_fft=256, hop_length=64,
                                   win_length=160, pad_mode="reflect", center=True)})
        for length in (6000, 9000):
            cases.append({"id": f"istft-{mesh}-uncentred-length{length}", "job": "istft",
                          "args": dict(mesh=dims, S=f"S:{mesh}:uncentred:fft", n_fft=256,
                                       hop_length=64, length=length, fft_mode="fft")})
        cases.append({"id": f"roundtrip-{mesh}", "job": "roundtrip",
                      "args": dict(mesh=dims, y="y_radix", n_fft=1024, hop_length=256,
                                   center=True, fft_mode="pallas", length=9001)})
    cases += [
        {"id": "dp-mel-4x1", "job": "data_parallel",
         "args": dict(op="melspectrogram", x="y_dp", mesh=(4, 1), n_fft=256, hop_length=64,
                      n_mels=16)},
        {"id": "dp-mel-2x2", "job": "data_parallel",
         "args": dict(op="melspectrogram", x="y_dp", mesh=(2, 2), n_fft=1024, hop_length=256,
                      n_mels=32, use_pallas=True)},
        {"id": "shard-batch-2x2", "job": "shard_batch", "args": dict(x="y_dp", mesh=(2, 2))},
        {"id": "dp-griffinlim-4x1", "job": "data_parallel",
         "args": dict(op="griffinlim", x="S_gl", mesh=(4, 1), n_iter=2, hop_length=256,
                      init="zeros")},
    ]
    return cases


CASES = _cases()
CASE = {c["id"]: c for c in CASES}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = dict(INPUTS)
    for c in CASES:
        if c["job"] == "istft" and c["args"]["S"] not in inputs:
            _, mesh, layout, mode = c["args"]["S"].split(":")
            inputs[c["args"]["S"]] = _spectrum(layout, mesh, mode)
    inputs["S_gl"] = np.abs(np.asarray(jap.stft(INPUTS["y_dp"], n_fft=1024, hop_length=256)))
    outs = run_world(tmp_path_factory.mktemp("parallel_world"), 4, CASES, inputs)
    return inputs, outs


def result(world, case: str, rank: int = 0) -> dict:
    got = case_results(world[1][rank], case)
    assert "error" not in got, got.get("error")
    return got


def _stft_like(case: str) -> tuple:
    kind, mesh, rest = case.split("-", 2)
    return kind, mesh, CASE[case]["args"]


TIME_SHARDED = [c for c in CASE if c.split("-")[0] in ("stft", "logmel", "istft")]


@pytest.mark.parametrize("case", TIME_SHARDED)
def test_time_sharded_matches_jax(world, case):
    kind, mesh, args = _stft_like(case)
    kw = {k: v for k, v in args.items() if k not in ("mesh", "y", "S")}
    if kind == "stft":
        ref = jax_sharded(jp.stft_time_sharded, mesh, INPUTS[args["y"]], **kw)
        tol = 2e-4
    elif kind == "logmel":
        ref = jax_sharded(jp.logmel_time_sharded, mesh, INPUTS[args["y"]], **kw)
        tol = 2e-3
    else:
        ref = jax_sharded(jp.istft_time_sharded, mesh, world[0][args["S"]], **kw)
        tol = 1e-4
    outs = [result(world, case, r)["out"] for r in range(4)]
    assert outs[0].shape == ref.shape and outs[0].dtype == ref.dtype
    assert np.isfinite(outs[0]).all()
    inner = slice(None)
    if kind == "istft" and not args.get("center", False):
        # uncentred, the first and last n_fft - hop samples lack window
        # coverage and amplify rounding; compare inside them, as the JAX
        # package's own round trip does
        n_fft = args["n_fft"]
        inner = slice(n_fft, min(ref.shape[1], INPUTS["y_unc"].shape[1]) - n_fft)
    np.testing.assert_allclose(outs[0][:, inner], ref[:, inner], atol=tol)
    # every rank gathers the same global array
    for other in outs[1:]:
        np.testing.assert_array_equal(other, outs[0])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_frames_stay_sharded_over_time(world, mesh):
    # uncentred: every rank holds its (B / n_data, F / n_time, bins) block
    n_data, n_time = MESHES[mesh]
    got = result(world, f"stft-{mesh}-uncentred-fft")
    assert tuple(got["local_shape"]) == (4 // n_data, 8192 // 64 // n_time, 129)
    # centred: the kept frames split by torch.chunk's rule
    got = result(world, f"stft-{mesh}-prime-length-fft", rank=n_time - 1)
    F = 1 + 10007 // 64
    assert tuple(got["local_shape"]) == (4 // n_data, F - (n_time - 1) * -(-F // n_time), 129)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_stft_istft_roundtrip_on_dtensors(world, mesh):
    got = result(world, f"roundtrip-{mesh}")["out"]
    np.testing.assert_allclose(got, INPUTS["y_radix"], atol=1e-4)


def test_uncentred_matches_the_single_device_op(world):
    # the uncentred grid is the single-device centre=False STFT of the
    # signal zero-padded by the halo (the JAX package's own check)
    got = result(world, "stft-1x4-uncentred-matmul")["out"]
    ypad = np.pad(INPUTS["y_unc"], ((0, 0), (0, 256 - 64)))
    ref = np.asarray(tap.stft(torch.from_numpy(ypad), n_fft=256, hop_length=64,
                              center=False)).swapaxes(1, 2)
    np.testing.assert_allclose(got, ref[:, : got.shape[1]], atol=2e-4)


MESH_OK = {
    "mesh_default": ((4, 1), ("data", "time")),
    "mesh_2x2": ((2, 2), ("data", "time")),
    "mesh_time4": ((1, 4), ("data", "time")),
    "tp_2x2": ((2, 2), ("data", "model")),
    "ep_2x2": ((2, 2), ("data", "expert")),
    "moe_1x2x2": ((1, 2, 2), ("data", "expert", "model")),
    "pp_4": ((4,), ("stage",)),
    "mesh_devices": ((1, 2), ("data", "time")),
}
JAX_MESH = {
    "mesh_default": lambda d: jp.make_mesh(devices=d),
    "mesh_2x2": lambda d: jp.make_mesh(2, 2, devices=d),
    "mesh_time4": lambda d: jp.make_mesh(n_time=4, devices=d),
    "tp_2x2": lambda d: jp.make_tp_mesh(n_model=2, devices=d),
    "ep_2x2": lambda d: jp.make_ep_mesh(n_expert=2, devices=d),
    "moe_1x2x2": lambda d: jp.make_moe_mesh(1, 2, 2, devices=d),
    "pp_4": lambda d: jp.make_pp_mesh(4, devices=d),
    "mesh_devices": lambda d: jp.make_mesh(1, 2, devices=d[2:]),
}


@pytest.mark.parametrize("name", list(MESH_OK))
def test_mesh_constructors_match_jax(world, name):
    got = result(world, "meshes")
    shape, names = MESH_OK[name]
    ref = JAX_MESH[name](jax.devices()[:4])
    assert tuple(ref.shape.values()) == shape and tuple(ref.axis_names) == names
    assert tuple(got[f"{name}.shape"]) == shape
    assert str(got[f"{name}.names"]).split(",") == list(names)
    want_ranks = [2, 3] if name == "mesh_devices" else list(range(int(np.prod(shape))))
    assert got[f"{name}.ranks"].tolist() == want_ranks
    assert str(got[f"{name}.warned"]) == ""
    if names[:2] == ("data", "time"):
        assert str(got[f"{name}.batch_sharding"]) == "(Shard(dim=0), Replicate())"
        assert str(got[f"{name}.batch_time_sharding"]) == "(Shard(dim=0), Shard(dim=1))"
    assert str(got[f"{name}.replicated"]) == repr(("Replicate()",) * len(shape)).replace("'", "")


MESH_ERRORS = {
    "err_time3": lambda d: jp.make_mesh(n_time=3, devices=d),
    "err_data0": lambda d: jp.make_mesh(0, 1, devices=d),
    "err_time0": lambda d: jp.make_mesh(n_time=0, devices=d),
    "err_too_big": lambda d: jp.make_mesh(2, 4, devices=d),
    "err_model0": lambda d: jp.make_tp_mesh(n_model=0, devices=d),
    "err_model3": lambda d: jp.make_tp_mesh(n_model=3, devices=d),
    "err_pp5": lambda d: jp.make_pp_mesh(5, devices=d),
    "err_pp0": lambda d: jp.make_pp_mesh(0, devices=d),
    "err_moe": lambda d: jp.make_moe_mesh(2, 2, 2, devices=d),
}


@pytest.mark.parametrize("name", list(MESH_ERRORS))
def test_mesh_errors_match_jax(world, name):
    with pytest.raises(ValueError) as ref:
        MESH_ERRORS[name](jax.devices()[:4])
    assert str(result(world, "meshes")[name]) == str(ref.value)


def test_mesh_on_fewer_ranks_warns():
    # a world of one in this process: a (1, 1) mesh takes every rank; the
    # JAX package warns when a mesh leaves devices idle, and so does the port
    m = tp.make_mesh(1, 1)
    assert m.mesh_dim_names == ("data", "time") and tuple(m.mesh.shape) == (1, 1)
    with pytest.warns(UserWarning, match="uses 1 of 4 devices"):
        jp.make_mesh(1, 1, devices=jax.devices()[:4])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tp.make_mesh(1, 1, devices=[0])


ERRORS = ["not_divisible", "hop_not_dividing", "halo_too_big", "centered_halo",
          "bad_fft_mode", "bad_pad_mode", "frames_not_dividing", "istft_halo"]
JAX_ERRORS = {
    "not_divisible": lambda m, y: jp.stft_time_sharded(y[:, :1000], m, n_fft=256),
    "hop_not_dividing": lambda m, y: jp.stft_time_sharded(y[:, :4000], m, n_fft=256,
                                                          hop_length=64),
    "halo_too_big": lambda m, y: jp.logmel_time_sharded(y[:, :1024], m, n_fft=512,
                                                        hop_length=128),
    "centered_halo": lambda m, y: jp.stft_time_sharded(y[:, :300], m, n_fft=1024,
                                                       hop_length=256, center=True),
    "bad_fft_mode": lambda m, y: jp.stft_time_sharded(y, m, n_fft=1024, hop_length=256,
                                                      center=True, fft_mode="bogus"),
    "bad_pad_mode": lambda m, y: jp.stft_time_sharded(y, m, n_fft=256, pad_mode="wrap"),
    "frames_not_dividing": lambda m, y: jp.istft_time_sharded(
        np.zeros((2, 10, 129), np.complex64), m, n_fft=256),
    "istft_halo": lambda m, y: jp.istft_time_sharded(
        np.zeros((2, 8, 513), np.complex64), m, n_fft=1024),
}


@pytest.mark.parametrize("name", ERRORS)
def test_validation_errors_match_jax(world, name):
    with pytest.raises(ValueError) as ref:
        JAX_ERRORS[name](jax_mesh("1x4"), INPUTS["y_small"])
    assert str(result(world, "errors")[name]) == str(ref.value)


def test_data_parallel_melspectrogram_matches_jax(world):
    got = result(world, "dp-mel-4x1")
    fn = jp.data_parallel(lambda y: jap.melspectrogram(y, n_fft=256, hop_length=64, n_mels=16),
                          jp.make_mesh(4, 1, devices=jax.devices()[:4]))
    ref = np.asarray(fn(INPUTS["y_dp"]))
    assert int(got["local_rows"]) == 2
    np.testing.assert_allclose(got["out"], ref, rtol=1e-5)


def test_data_parallel_kernel_route_replicates_over_time(world):
    # batch over 'data' only: the two time ranks of a data shard compute the
    # same rows (the wrapper on the CPU runs K1's plain twin)
    got = result(world, "dp-mel-2x2")
    fn = jp.data_parallel(
        lambda y: jap.melspectrogram(y, n_fft=1024, hop_length=256, n_mels=32, use_pallas=False),
        jp.make_mesh(2, 2, devices=jax.devices()[:4]))
    ref = np.asarray(fn(INPUTS["y_dp"]))
    assert int(got["local_rows"]) == 4
    np.testing.assert_allclose(got["out"], ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_data_parallel_griffinlim_matches_jax(world):
    got = result(world, "dp-griffinlim-4x1")["out"]
    fn = jp.data_parallel(
        lambda s: jap.griffinlim(s, n_iter=2, hop_length=256, init="zeros", use_pallas=False),
        jp.make_mesh(4, 1, devices=jax.devices()[:4]))
    ref = np.asarray(fn(world[0]["S_gl"]))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("name", ["DATA_AXIS", "TIME_AXIS", "MODEL_AXIS", "STAGE_AXIS",
                                  "EXPERT_AXIS"])
def test_axis_names_are_the_jax_strings(name):
    assert getattr(tp, name) == getattr(jp, name) and isinstance(getattr(tp, name), str)


def test_shard_batch_matches_jax(world):
    # the global value is the input, its batch axis sharded over 'data'
    # and replicated over 'time', as the JAX array's
    ref = jp.shard_batch(INPUTS["y_dp"], jax_mesh("2x2"))
    assert tuple(ref.sharding.spec)[0] == jp.DATA_AXIS
    local = {tuple(s.data.shape) for s in ref.addressable_shards}
    for rank in range(4):
        got = result(world, "shard-batch-2x2", rank)
        assert np.array_equal(got["out"], np.asarray(ref))
        assert np.array_equal(got["out"], INPUTS["y_dp"])
        assert str(got["placements"]) == "(Shard(dim=0), Replicate())"
        assert {tuple(got["local_shape"])} == local == {(4, 2048)}


def test_data_parallel_rejects_batched_kwarg():
    m = tp.make_mesh(1, 1)
    fn = tp.data_parallel(lambda y, gain=None: y * gain, m)
    y = np.ones((8, 4), np.float32)
    with pytest.raises(TypeError, match="looks batched"):
        fn(y, gain=np.arange(8, dtype=np.float32).reshape(8, 1))
    with pytest.raises(TypeError, match=re.escape("positional array argument 1")):
        fn(y, np.ones(3, np.float32))
    # non-batched keyword arrays are fine (every rank passes them whole)
    assert float(fn(y, gain=np.float32(2.0)).full_tensor().max()) == 2.0
