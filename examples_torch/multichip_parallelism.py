"""Tour of the six parallelism axes on a device mesh, on the PyTorch port.

The port's counterpart of `examples/multichip_parallelism.py`. Each section
builds the relevant ``DeviceMesh``, places data and parameters as DTensors
(the port's ``NamedSharding`` trees), and runs a few training steps whose
collectives (``all_reduce`` / ``all_gather`` / ``all_to_all`` / ring
shifts, over NCCL between cards or gloo on the CPU) cross the world:

  dp      data parallelism            batch over 'data'
  sp      sequence (signal) sharding  samples over 'time', halo ring shift
  tp      tensor parallelism          Megatron col/row-parallel convs
  pp      pipeline parallelism        GPipe fill-drain over a (stage,) mesh
  ep      expert parallelism          Switch MoE, all_to_all token routing
  cp      context parallelism         ring attention over frame tokens

Usage:
    # one card per rank:
    torchrun --nproc-per-node 4 examples_torch/multichip_parallelism.py
    # four CPU ranks over gloo:
    torchrun --nproc-per-node 4 examples_torch/multichip_parallelism.py --device cpu
    # a world of one (every mesh 1x1):
    python examples_torch/multichip_parallelism.py
"""

from __future__ import annotations

import argparse
import os
import sys

# runnable in place from a source checkout (`python examples_torch/<name>.py`)
sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def run_tour(steps: int = 4, device: str = "cuda") -> dict[str, list[float]]:
    """Run every section for ``steps`` steps in the current world (a world
    of one when none is set up); returns each section's losses."""
    import numpy as np
    import torch.distributed as dist

    import mlx_audio_primitives_tpu_torch as tap
    from mlx_audio_primitives_tpu_torch import models, parallel
    from mlx_audio_primitives_tpu_torch.parallel.sharding import distribute
    from mlx_audio_primitives_tpu_torch.utils.tree import tree_map

    tap.set_default_device(device)
    # the launcher's world, or the world of one the first mesh starts
    n = dist.get_world_size() if dist.is_initialized() else 1
    rng = np.random.default_rng(0)
    sr, n_fft, hop, n_mels, n_cls = 22050, 256, 64, 32, 6
    out: dict[str, list[float]] = {}

    def place(tree, shardings):
        return tree_map(distribute, tree, shardings)

    def tour_section(name, m, step, params, y, labels, extra=""):
        losses = []
        for _ in range(steps):
            params, loss = step(params, y, labels)
            losses.append(float(loss))
        shape = dict(zip(m.mesh_dim_names, m.shape))
        print(f"{name:<9} {shape}{extra}: losses {['%.3f' % v for v in losses]}")
        out[name] = losses

    # --- dp x sp: linear classifier over the time-sharded log-mel frontend
    n_time = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    mesh = parallel.make_mesh(n_data=n // n_time, n_time=n_time)
    n_data = n // n_time
    B, L = 2 * n_data, n_time * 8 * n_fft
    y = distribute(rng.standard_normal((B, L)).astype(np.float32),
                   parallel.batch_time_sharding(mesh))
    labels = rng.integers(0, n_cls, (B,)).astype(np.int32)
    params = models.init_classifier_params(n_mels, n_cls)
    step = models.make_sharded_train_step(mesh, sr=sr, n_fft=n_fft, hop_length=hop,
                                          n_mels=n_mels, n_classes=n_cls)
    tour_section("dp x sp", mesh, step, params, y, labels)

    # --- tp: Megatron-sharded conv classifier
    n_model = 2 if n % 2 == 0 else 1
    tp_mesh = parallel.make_tp_mesh(n // n_model, n_model)
    frontend = models.TrainableLogMelFrontend(sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels)
    tp_params = place(models.init_audio_classifier_params(frontend, 8, channels=(8, 16)),
                      models.tp_param_sharding(tp_mesh, (8, 16)))
    Bt = 2 * (n // n_model)
    yt_host = rng.standard_normal((Bt, 8 * n_fft)).astype(np.float32)
    yt = distribute(yt_host, parallel.batch_sharding(tp_mesh))
    lt = rng.integers(0, 8, (Bt,)).astype(np.int32)
    tp_step = models.make_tp_train_step(tp_mesh, frontend, n_classes=8, channels=(8, 16))
    tour_section("tp", tp_mesh, tp_step, tp_params, yt, lt)

    # --- pp: GPipe fill-drain (ranks past the stages sit it out)
    n_stage = min(4, n)
    pp_mesh = parallel.make_pp_mesh(n_stage)
    pp_params = models.init_deep_classifier_params(frontend, 8, n_blocks=n_stage * 2, width=8)
    pp_step = models.make_pp_train_step(pp_mesh, frontend, n_classes=8, n_blocks=n_stage * 2,
                                        width=8, n_microbatches=2)
    if pp_mesh.get_coordinate() is not None:
        pp_params = place(pp_params, models.pp_param_sharding(pp_mesh))
        tour_section("pp", pp_mesh, pp_step, pp_params, yt_host, lt)

    # --- ep: Switch MoE with all_to_all routing
    n_exp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    ep_mesh = parallel.make_ep_mesh(n // n_exp, n_exp)
    n_experts = 2 * max(n_exp, 2)
    ep_params = place(models.init_moe_classifier_params(frontend, 8, n_experts=n_experts,
                                                        d_hidden=32),
                      models.moe_param_sharding(ep_mesh))
    Be = 2 * n
    ye = distribute(rng.standard_normal((Be, 8 * n_fft)).astype(np.float32),
                    models.ep_batch_sharding(ep_mesh))
    le = rng.integers(0, 8, (Be,)).astype(np.int32)
    ep_step = models.make_ep_train_step(ep_mesh, frontend, n_classes=8, n_experts=n_experts,
                                        d_hidden=32, lr=3e-2)
    tour_section("ep", ep_mesh, ep_step, ep_params, ye, le, f" E={n_experts}")

    # --- cp: ring-attention transformer on the (data, time) mesh
    F_tok = n_time * 8
    yc = distribute(rng.standard_normal((B, F_tok * hop)).astype(np.float32),
                    parallel.batch_time_sharding(mesh))
    cp_params = models.init_transformer_params(n_mels, n_cls, n_frames=F_tok, d_model=16,
                                               n_heads=2, d_ff=32, n_blocks=2)
    cp_params = place(cp_params, models.transformer_param_sharding(mesh, cp_params))
    cp_step = models.make_cp_train_step(mesh, sr=sr, n_fft=n_fft, hop_length=hop, n_mels=n_mels,
                                        n_classes=n_cls, d_model=16, n_heads=2, d_ff=32,
                                        n_blocks=2, lr=3e-2)
    tour_section("cp (ring)", mesh, cp_step, cp_params, yc, labels)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    a = ap.parse_args()
    if "WORLD_SIZE" not in os.environ:
        sys.stderr.write(
            "note: no launcher world: every mesh is 1x1; run under torchrun "
            "--nproc-per-node N to see real sharding\n"
        )
    run_tour(steps=a.steps, device=a.device)
