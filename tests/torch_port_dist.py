"""Spawned gloo worlds for the PyTorch port's multi-rank tests.

A test module's module-scoped fixture calls :func:`run_world` once: it
writes the module's inputs (``inputs.npz``) and its list of cases
(``cases.json``) into a temporary directory, starts ``n_ranks`` processes
of this file, one per rank, which meet through a ``FileStore`` in that
directory (no TCP port, so parallel test workers cannot collide), run every
case on the CPU over gloo, and write each rank's results to
``out<rank>.npz`` under ``<case>/<name>`` keys. A case that raises records
its message under ``<case>/error``. The ranks import the port and never
JAX: each asserts at exit that neither ``jax`` nor the JAX package is in
``sys.modules``. Each collective gives up after ``COLLECTIVE_TIMEOUT_S`` and
the world after ``WORLD_TIMEOUT_S``, so a hung collective fails the tests
instead of stalling the suite.

The jobs below run the port's multi-rank entry points and return the
global results (DTensors gathered with ``full_tensor``), which the tests
hold against the JAX package on a mesh of the same shape.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import traceback
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
COLLECTIVE_TIMEOUT_S = 60
WORLD_TIMEOUT_S = 300


def run_world(workdir: Path, n_ranks: int, cases: list[dict],
              inputs: dict[str, np.ndarray]) -> list[dict[str, np.ndarray]]:
    """Run ``cases`` in a world of ``n_ranks`` spawned ranks; return each
    rank's results. Raises with the ranks' output if any rank fails."""
    workdir = Path(workdir)
    np.savez(workdir / "inputs.npz", **inputs)
    (workdir / "cases.json").write_text(json.dumps(cases))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, __file__, str(workdir), str(r), str(n_ranks)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT)
             for r in range(n_ranks)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} failed:\n" + "\n".join(
            f"--- rank {r} ---\n{logs[r][-4000:]}" for r in failed))
    return [dict(np.load(workdir / f"out{r}.npz")) for r in range(n_ranks)]


def case_results(out: dict[str, np.ndarray], case: str) -> dict[str, np.ndarray]:
    """One case's results from one rank's ``out`` (``error`` if it raised)."""
    prefix = case + "/"
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# Jobs, run inside the ranks (port only)


def _np(x):
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        if torch.is_complex(x.to_local()):
            local = torch.view_as_real(x.to_local())
            x = DTensor.from_local(local, x.device_mesh, x.placements, run_check=False,
                                   shape=(*x.shape, 2),
                                   stride=torch.empty((*x.shape, 2), device="meta").stride())
            return torch.view_as_complex(x.full_tensor()).numpy()
        x = x.full_tensor()
    return x.detach().cpu().numpy()


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: _np(tree)}


def _mesh(kind: str, dims: list[int]):
    from mlx_audio_primitives_tpu_torch import parallel as tp

    make = {"mesh": tp.make_mesh, "tp": tp.make_tp_mesh, "pp": tp.make_pp_mesh,
            "ep": tp.make_ep_mesh, "moe": tp.make_moe_mesh}[kind]
    return make(*dims)


def job_meshes(inputs):
    """Every constructor's shape, names and this rank's coordinate, and the
    messages of the ones that raise, in a world of 4."""
    from mlx_audio_primitives_tpu_torch import parallel as tp

    good = {
        "mesh_default": lambda: tp.make_mesh(),
        "mesh_2x2": lambda: tp.make_mesh(2, 2),
        "mesh_time4": lambda: tp.make_mesh(n_time=4),
        "tp_2x2": lambda: tp.make_tp_mesh(n_model=2),
        "ep_2x2": lambda: tp.make_ep_mesh(n_expert=2),
        "moe_1x2x2": lambda: tp.make_moe_mesh(1, 2, 2),
        "pp_4": lambda: tp.make_pp_mesh(4),
        "mesh_devices": lambda: tp.make_mesh(1, 2, devices=[2, 3]),
    }
    bad = {
        "err_time3": lambda: tp.make_mesh(n_time=3),
        "err_data0": lambda: tp.make_mesh(0, 1),
        "err_time0": lambda: tp.make_mesh(n_time=0),
        "err_too_big": lambda: tp.make_mesh(2, 4),
        "err_model0": lambda: tp.make_tp_mesh(n_model=0),
        "err_model3": lambda: tp.make_tp_mesh(n_model=3),
        "err_pp5": lambda: tp.make_pp_mesh(5),
        "err_pp0": lambda: tp.make_pp_mesh(0),
        "err_moe": lambda: tp.make_moe_mesh(2, 2, 2),
    }
    out = {}
    for name, fn in good.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            m = fn()
        out[f"{name}.shape"] = np.array(m.mesh.shape)
        out[f"{name}.names"] = np.array(",".join(m.mesh_dim_names))
        out[f"{name}.ranks"] = m.mesh.flatten().numpy()
        out[f"{name}.warned"] = np.array(" | ".join(str(w.message) for w in caught))
        for fn_name in ("batch_sharding", "batch_time_sharding", "replicated"):
            try:
                s = getattr(tp, fn_name)(m)
                out[f"{name}.{fn_name}"] = np.array(repr(tuple(s.placements)))
            except ValueError as e:
                out[f"{name}.{fn_name}"] = np.array(f"ValueError: {e}")
    for name, fn in bad.items():
        try:
            fn()
            out[name] = np.array("no error")
        except ValueError as e:
            out[name] = np.array(str(e))
    return out


def job_stft(inputs, mesh, y, **kw):
    from mlx_audio_primitives_tpu_torch.parallel import stft_time_sharded

    out = stft_time_sharded(inputs[y], _mesh("mesh", mesh), **kw)
    return {"out": _np(out), "local_shape": np.array(out.to_local().shape)}


def job_istft(inputs, mesh, S, **kw):
    from mlx_audio_primitives_tpu_torch.parallel import istft_time_sharded

    return {"out": _np(istft_time_sharded(inputs[S], _mesh("mesh", mesh), **kw))}


def job_logmel(inputs, mesh, y, **kw):
    from mlx_audio_primitives_tpu_torch.parallel import logmel_time_sharded

    return {"out": _np(logmel_time_sharded(inputs[y], _mesh("mesh", mesh), **kw))}


def job_roundtrip(inputs, mesh, y, length=None, **kw):
    """``stft_time_sharded`` -> ``istft_time_sharded`` on DTensors."""
    from mlx_audio_primitives_tpu_torch.parallel import istft_time_sharded, stft_time_sharded

    m = _mesh("mesh", mesh)
    S = stft_time_sharded(inputs[y], m, **kw)
    kw.pop("pad_mode", None)
    return {"out": _np(istft_time_sharded(S, m, length=length, **kw))}


def job_errors(inputs):
    """The validation errors of the time-sharded ops on a (1, 4) mesh."""
    import torch

    from mlx_audio_primitives_tpu_torch import parallel as tp

    m = tp.make_mesh(1, 4)
    y = inputs["y_small"]
    calls = {
        "not_divisible": lambda: tp.stft_time_sharded(y[:, :1000], m, n_fft=256),
        "hop_not_dividing": lambda: tp.stft_time_sharded(y[:, :4000], m, n_fft=256, hop_length=64),
        "halo_too_big": lambda: tp.logmel_time_sharded(y[:, :1024], m, n_fft=512, hop_length=128),
        "centered_halo": lambda: tp.stft_time_sharded(y[:, :300], m, n_fft=1024, hop_length=256,
                                                      center=True),
        "bad_fft_mode": lambda: tp.stft_time_sharded(y, m, n_fft=1024, hop_length=256,
                                                     center=True, fft_mode="bogus"),
        "bad_pad_mode": lambda: tp.stft_time_sharded(y, m, n_fft=256, pad_mode="wrap"),
        "frames_not_dividing": lambda: tp.istft_time_sharded(
            torch.zeros((2, 10, 129), dtype=torch.complex64), m, n_fft=256),
        "istft_halo": lambda: tp.istft_time_sharded(
            torch.zeros((2, 8, 513), dtype=torch.complex64), m, n_fft=1024),
    }
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            out[name] = np.array("no error")
        except ValueError as e:
            out[name] = np.array(str(e))
    return out


def job_data_parallel(inputs, op, x, mesh, **kw):
    import mlx_audio_primitives_tpu_torch as tap
    from mlx_audio_primitives_tpu_torch.parallel import data_parallel

    fn = data_parallel(lambda a: getattr(tap, op)(a, **kw), _mesh("mesh", mesh))
    out = fn(inputs[x])
    return {"out": _np(out), "local_rows": np.array(out.to_local().shape[0])}


def job_shard_batch(inputs, x, mesh):
    from mlx_audio_primitives_tpu_torch.parallel import shard_batch

    out = shard_batch(inputs[x], _mesh("mesh", mesh))
    return {"out": _np(out), "placements": np.array(repr(tuple(out.placements))),
            "local_shape": np.array(out.to_local().shape)}


def _frontend(sr, n_fft, hop, n_mels):
    from mlx_audio_primitives_tpu_torch.models import TrainableLogMelFrontend

    return TrainableLogMelFrontend(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels)


def _params(inputs, prefix):
    """The tree stored flat under ``prefix.a.b`` keys, as float32 tensors."""
    from mlx_audio_primitives_tpu_torch.utils.interop import params_from_jax

    tree: dict = {}
    for key, arr in inputs.items():
        if key.startswith(prefix + "."):
            node = tree
            *path, leaf = key[len(prefix) + 1:].split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = arr
    return params_from_jax(tree)


def _steps(step, params, y, labels, n_steps):
    losses = []
    for _ in range(n_steps):
        params, loss = step(params, y, labels)
        losses.append(float(loss))
    return params, losses


def job_convnet(inputs, mesh, frontend, n_classes, channels, lr, use_pallas=None):
    from mlx_audio_primitives_tpu_torch.models import make_convnet_train_step

    step = make_convnet_train_step(_mesh("mesh", mesh), _frontend(*frontend), n_classes=n_classes,
                                   channels=tuple(channels), lr=lr, use_pallas=use_pallas)
    new, losses = _steps(step, _params(inputs, "conv_params"), inputs["y_train"],
                         inputs["labels"], 1)
    return {"loss": np.array(losses), **_flat(new, "p.")}


def job_sharded(inputs, mesh, fft_mode, y, **kw):
    from mlx_audio_primitives_tpu_torch.models import make_sharded_train_step

    step = make_sharded_train_step(_mesh("mesh", mesh), fft_mode=fft_mode, **kw)
    new, losses = _steps(step, _params(inputs, "lin_params"), inputs[y], inputs["labels5"], 1)
    return {"loss": np.array(losses), **_flat(new, "p.")}


def job_checkpoint(inputs, path):
    """Save a DTensor state from every rank, restore it onto the same
    target, and report whether each rank's shards came back bit-equal."""
    from mlx_audio_primitives_tpu_torch.models import (
        make_tp_train_step,
        restore_checkpoint,
        save_checkpoint,
    )

    m = _mesh("tp", [2, 2])
    step = make_tp_train_step(m, _frontend(22050, 256, 64, 32), n_classes=8, channels=(8, 16))
    params, _ = _steps(step, _params(inputs, "conv_params"), inputs["y_train"],
                       inputs["labels"], 1)
    state = {"params": params, "step": 1}
    written = save_checkpoint(path, state)
    back = restore_checkpoint(path, target=state)
    return {"written": np.array(written), "same": np.array(_same_locals(back["params"], params)),
            "step": back["step"].numpy(), **_flat(params, "p.")}


def _same_locals(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return all(_same_locals(a[k], b[k]) for k in b)
    return a.placements == b.placements and torch.equal(a.to_local(), b.to_local())


def job_tp(inputs, mesh, frontend, n_classes, channels, lr=1e-2, y="y_train", labels="labels",
           n_steps=1):
    from mlx_audio_primitives_tpu_torch.models import make_tp_train_step, tp_param_sharding
    from mlx_audio_primitives_tpu_torch.parallel.sharding import distribute
    from mlx_audio_primitives_tpu_torch.utils.tree import tree_map

    m = _mesh("tp", mesh)
    # placed with their tp shardings, as a deployment would
    params = tree_map(distribute, _params(inputs, f"tp_params_{len(channels)}"),
                      tp_param_sharding(m, tuple(channels)))
    step = make_tp_train_step(m, _frontend(*frontend), n_classes=n_classes,
                              channels=tuple(channels), lr=lr, use_pallas=False)
    new, losses = _steps(step, params, inputs[y], inputs[labels], n_steps)
    return {"loss": np.array(losses), "local_head_w": np.array(
        new["net"]["head"]["w"].to_local().shape), **_flat(new, "p.")}


def job_pp(inputs, mesh, frontend, n_classes, n_blocks, n_micro, width, y="y_train",
           labels="labels", n_steps=1):
    from mlx_audio_primitives_tpu_torch.models import make_pp_train_step

    m = _mesh("pp", mesh)
    step = make_pp_train_step(m, _frontend(*frontend), n_classes=n_classes, n_blocks=n_blocks,
                              width=width, n_microbatches=n_micro, use_pallas=False)
    if m.get_coordinate() is None:
        return {"outside": np.array(True)}
    new, losses = _steps(step, _params(inputs, f"pp_params_{n_blocks}"), inputs[y],
                         inputs[labels], n_steps)
    return {"loss": np.array(losses), "local_blocks": np.array(
        new["blocks"]["w"].to_local().shape), **_flat(new, "p.")}


def job_ep(inputs, mesh, frontend, n_experts, d_hidden, tp=False, y="y_train",
           labels="labels", n_steps=1):
    """The ep step (on a ``(data, expert)`` mesh) or the ep x tp step (on a
    ``(data, expert, model)`` mesh), its params placed as a deployment
    would place them."""
    from mlx_audio_primitives_tpu_torch import models as tm
    from mlx_audio_primitives_tpu_torch.parallel.sharding import distribute
    from mlx_audio_primitives_tpu_torch.utils.tree import tree_map

    m = _mesh("moe" if tp else "ep", mesh)
    if m.get_coordinate() is None:
        return {"outside": np.array(True)}
    make = tm.make_ep_tp_train_step if tp else tm.make_ep_train_step
    shardings = (tm.moe_tp_param_sharding if tp else tm.moe_param_sharding)(m)
    params = tree_map(distribute, _params(inputs, "moe_params"), shardings)
    step = make(m, _frontend(*frontend), n_classes=8, n_experts=n_experts, d_hidden=d_hidden,
                use_pallas=False)
    new, losses = _steps(step, params, inputs[y], inputs[labels], n_steps)
    return {"loss": np.array(losses), "local_w1": np.array(
        new["experts"]["w1"].to_local().shape), **_flat(new, "p.")}


def job_ep_errors(inputs):
    """The messages of the ep trainers' shape errors on meshes of four ranks."""
    from mlx_audio_primitives_tpu_torch import models as tm
    from mlx_audio_primitives_tpu_torch import parallel as tp

    fe = _frontend(22050, 256, 64, 32)
    ep, moe = tp.make_ep_mesh(1, 4), tp.make_moe_mesh(1, 2, 2)
    calls = {
        "ep_experts": lambda: tm.make_ep_train_step(ep, fe, n_experts=6),
        "ep_tp_experts": lambda: tm.make_ep_tp_train_step(moe, fe, n_experts=3),
        "ep_tp_hidden": lambda: tm.make_ep_tp_train_step(moe, fe, n_experts=4, d_hidden=33),
        "ep_batch": lambda: tm.make_ep_train_step(ep, fe, n_classes=8)(
            tm.init_moe_classifier_params(fe, 8), inputs["y_train"][:6], inputs["labels"][:6]),
    }
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            out[name] = np.array("no error")
        except ValueError as e:
            out[name] = np.array(str(e))
    return out


def job_cp(inputs, mesh, frontend, y, labels, n_steps=1, fft_mode="matmul"):
    from mlx_audio_primitives_tpu_torch.models import make_cp_train_step

    m = _mesh("mesh", mesh)
    if m.get_coordinate() is None:
        return {"outside": np.array(True)}
    sr, n_fft, hop, n_mels = frontend
    step = make_cp_train_step(m, sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels, n_classes=6,
                              d_model=16, n_heads=2, d_ff=32, n_blocks=2, fft_mode=fft_mode)
    new, losses = _steps(step, _params(inputs, "cp_params"), inputs[y], inputs[labels], n_steps)
    return {"loss": np.array(losses), **_flat(new, "p.")}


def job_ring(inputs, mesh):
    """``ring_attention`` on this rank's blocks of q/k/v sharded over
    'time', and the gradients of a rank-weighted sum of its output."""
    import torch

    from mlx_audio_primitives_tpu_torch.models import ring_attention
    from mlx_audio_primitives_tpu_torch.parallel import TIME_AXIS
    from mlx_audio_primitives_tpu_torch.parallel.mesh import placements, P
    from mlx_audio_primitives_tpu_torch.parallel.sharding import from_local, local_shard

    m = _mesh("mesh", mesh)
    if m.get_coordinate() is None:
        return {"outside": np.array(True)}
    place = placements(m, P(None, TIME_AXIS))
    q, k, v, w = (local_shard(torch.from_numpy(inputs[n]), m, place).requires_grad_(n != "ring_w")
                  for n in ("ring_q", "ring_k", "ring_v", "ring_w"))
    out = ring_attention(q, k, v, m[TIME_AXIS])
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    return {"out": _np(from_local(out.detach(), m, place)),
            **{f"grad_{n}": _np(from_local(g, m, place)) for n, g in zip("qkv", grads)}}


def job_all_to_all(inputs, mesh, split_dim, concat_dim):
    """``_comm.all_to_all`` over 'expert' of this rank's ``a2a_x[rank]``:
    the output, and the gradient of ``sum(out * w)`` with ``w`` drawn from
    ``default_rng(100 + rank)`` in the output's shape."""
    import torch
    import torch.distributed as dist

    from mlx_audio_primitives_tpu_torch.parallel import EXPERT_AXIS, _comm

    m = _mesh("ep", mesh)
    r = dist.get_rank()
    x = torch.from_numpy(inputs["a2a_x"][r]).requires_grad_(True)
    out = _comm.all_to_all(x, m, EXPERT_AXIS, split_dim=split_dim, concat_dim=concat_dim)
    w = torch.from_numpy(np.random.default_rng(100 + r).standard_normal(out.shape)
                         .astype(np.float32))
    (grad,) = torch.autograd.grad((out * w).sum(), (x,))
    return {"out": out.detach().numpy(), "grad": grad.numpy()}


def job_tour(inputs, steps):
    """``examples_torch/multichip_parallelism.run_tour`` in this world."""
    import importlib

    tour = importlib.import_module("examples_torch.multichip_parallelism")
    return {k: np.array(v) for k, v in tour.run_tour(steps=steps, device="cpu").items()}


JOBS = {name[4:]: fn for name, fn in dict(globals()).items() if name.startswith("job_")}


def _worker(workdir: Path, rank: int, n_ranks: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    import mlx_audio_primitives_tpu_torch as tap

    tap.set_default_device("cpu")
    store = dist.FileStore(str(workdir / "store"), n_ranks)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n_ranks,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    inputs = dict(np.load(workdir / "inputs.npz"))
    results: dict[str, np.ndarray] = {}
    for case in json.loads((workdir / "cases.json").read_text()):
        try:
            out = JOBS[case["job"]](inputs, **case.get("args", {}))
        except Exception as e:  # recorded, and held by the tests
            traceback.print_exc()
            out = {"error": np.array(f"{type(e).__name__}: {e}")}
        results.update({f"{case['id']}/{k}": v for k, v in out.items()})
    dist.barrier()
    dist.destroy_process_group()
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "mlx_audio_primitives_tpu"))
    assert not leaked, f"a rank imported JAX or the JAX package: {leaked[:5]}"
    np.savez(workdir / f"out{rank}.npz", **results)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
