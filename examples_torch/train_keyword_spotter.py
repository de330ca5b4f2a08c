"""End-to-end keyword-spotter training on synthetic audio, on the PyTorch port.

The port's counterpart of `examples/train_keyword_spotter.py`: a synthetic
keyword dataset (each "word" is a band-limited chirp family + noise), the
learnable log-mel frontend (`TrainableLogMelFrontend`: its forward is the
fused mel kernel K1 on a CUDA tensor, its backward the plain composition),
the conv classifier, data-parallel training over every rank of the world,
and an npz checkpoint round trip.

Usage:
    python examples_torch/train_keyword_spotter.py [--steps 60] [--batch 32] [--device cpu]
    torchrun --nproc-per-node 4 examples_torch/train_keyword_spotter.py

Runs on the CUDA card by default (``--device cpu`` for the CPU), in the
world the launcher gives it or a world of one. Deterministic; reaches >90%
accuracy on held-out clips of the 4-class problem within the default 60
steps.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

# runnable in place from a source checkout (`python examples_torch/<name>.py`)
sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

SR = 16000
CLIP = SR  # 1-second clips
N_CLASSES = 4


def make_clips(batch: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic keywords: class k = chirp sweeping inside band k + noise.

    (A stand-in for real speech commands with the same tensor shapes;
    deterministic per seed so train/eval splits are reproducible.)
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, N_CLASSES, size=batch)
    t = np.arange(CLIP, dtype=np.float64) / SR
    bands = [(300, 700), (900, 1500), (1800, 2600), (3000, 4200)]
    clips = np.empty((batch, CLIP), np.float32)
    for i, k in enumerate(labels):
        lo, hi = bands[k]
        f0 = rng.uniform(lo, 0.5 * (lo + hi))
        f1 = rng.uniform(0.5 * (lo + hi), hi)
        phase = 2 * np.pi * (f0 * t + 0.5 * (f1 - f0) / t[-1] * t**2)
        tone = np.sin(phase + rng.uniform(0, 2 * np.pi))
        envelope = np.hanning(CLIP)
        noise = 0.3 * rng.standard_normal(CLIP)
        clips[i] = (tone * envelope + noise).astype(np.float32)
    return clips, labels.astype(np.int32)


def main(steps: int = 60, batch: int = 32, lr: float = 3e-2,
         checkpoint_dir: str | None = None,
         frontend_kind: str = "logmel", device: str = "cuda") -> float:
    import torch

    import mlx_audio_primitives_tpu_torch as tap
    from mlx_audio_primitives_tpu_torch.models import (
        TrainableLogMelFrontend,
        audio_classifier_apply,
        init_audio_classifier_params,
        make_convnet_train_step,
        restore_checkpoint,
        save_checkpoint,
    )
    from mlx_audio_primitives_tpu_torch.models.convnet import batch_sharding
    from mlx_audio_primitives_tpu_torch.parallel import make_mesh
    from mlx_audio_primitives_tpu_torch.parallel.sharding import distribute
    from mlx_audio_primitives_tpu_torch.utils.tree import tree_map

    tap.set_default_device(device)
    mesh = make_mesh(n_time=1)  # every rank of the world on 'data'
    n_dev = mesh.size()
    print(f"devices: {n_dev} ({device}), mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    if frontend_kind == "pcen":
        # the Wang et al. trainable frontend: per-channel PCEN
        # (gain/bias/power/smoother all learned) over the learnable
        # filterbank, the production far-field/KWS configuration
        from mlx_audio_primitives_tpu_torch.models.pipelines import TrainablePCENFrontend

        frontend = TrainablePCENFrontend(sr=SR, n_fft=512, hop_length=128, n_mels=40)
    else:
        frontend = TrainableLogMelFrontend(sr=SR, n_fft=512, hop_length=128, n_mels=40)
    channels = (16, 32)
    params = init_audio_classifier_params(frontend, N_CLASSES, channels=channels)
    step = make_convnet_train_step(mesh, frontend, n_classes=N_CLASSES, channels=channels, lr=lr)

    # batch must divide over the device count
    batch = max(batch // n_dev, 1) * n_dev
    for i in range(steps):
        y, labels = make_clips(batch, seed=i)
        yd = distribute(y, batch_sharding(mesh))
        params, loss = step(params, yd, labels)
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i:3d}  loss {float(loss):.4f}")

    # checkpoint -> restore round-trip, then evaluate on held-out clips
    ckpt_dir = checkpoint_dir or tempfile.mkdtemp(prefix="kws_ckpt_")
    ckpt = os.path.join(ckpt_dir, f"step_{steps}")
    written = save_checkpoint(ckpt, {"params": params, "step": steps})
    params = restore_checkpoint(ckpt, target={"params": params, "step": steps})["params"]

    y_eval, labels_eval = make_clips(256, seed=10_000)
    with torch.no_grad():
        logits = audio_classifier_apply(frontend, tree_map(lambda t: t.full_tensor(), params),
                                        y_eval)
    acc = float((logits.argmax(-1).cpu() == torch.from_numpy(labels_eval)).double().mean())
    print(f"eval accuracy: {acc:.3f}  (checkpoint at {written})")
    return acc


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--frontend", choices=["logmel", "pcen"], default="logmel")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    a = ap.parse_args()
    main(steps=a.steps, batch=a.batch, lr=a.lr, checkpoint_dir=a.checkpoint_dir,
         frontend_kind=a.frontend, device=a.device)
