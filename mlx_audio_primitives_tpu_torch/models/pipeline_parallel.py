"""Pipeline-parallel (GPipe-style) training for a deep conv audio classifier.

Counterpart of `mlx_audio_primitives_tpu/models/pipeline_parallel.py`: a
pipeline over a ``(stage,)`` mesh (`parallel.mesh.make_pp_mesh`).

The pipelined region is a stack of ``n_blocks`` IDENTICAL residual conv
blocks whose parameters stack on a leading ``(n_blocks, ...)`` axis sharded
over 'stage': each rank holds its ``(n_blocks / S, ...)`` slice. The
schedule is the classic fill-drain loop: the batch splits into M
microbatches; at step ``t`` stage ``s`` processes microbatch ``t - s``,
then hands its activations to stage ``s + 1`` with a ring shift
(``batch_isend_irecv``). After ``M + S - 1`` steps every microbatch has
crossed every stage; the last stage's collected outputs are completed with
a SUM ``all_reduce`` (every other stage contributes zeros), and the small
replicated stem and head run redundantly on every rank.

Gradients follow JAX's: the ring shift's backward shifts the other way,
the fill/drain selections route exactly one copy of every cotangent
(``torch.where`` keeps every rank's graph the same shape, so every rank
runs the same backward shifts in the same order), the final sum's output is
replicated, so its backward is the identity, and the replicated stem output
entering the stage-varying schedule sums its cotangent over 'stage' (only
stage 0 reads it). Each leaf's gradient is the true batch-mean gradient.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..parallel import _comm
from ..parallel.mesh import STAGE_AXIS, P, axis_index, axis_size, placements
from ..parallel.sharding import from_local, local_shard, sharding_tree
from ..utils import dispatch
from ..utils.tree import tree_map
from .convnet import _conv_same, _local_grads, make_sgd_step, standardize_features
from .pipelines import TrainableLogMelFrontend, _nll_loss

ArrayLike = Any


def init_deep_classifier_params(
    frontend: TrainableLogMelFrontend,
    n_classes: int,
    n_blocks: int = 4,
    width: int = 16,
    seed: int = 0,
) -> dict[str, Any]:
    """Parameters for the deep residual classifier, on the default device.

    ``stem`` lifts ``(B, 1, n_mels, F)`` to ``width`` channels at stride 2;
    ``blocks`` is the pipelined stack (every leaf has a leading
    ``n_blocks`` axis); ``head`` maps pooled channels to logits.
    """
    rng = np.random.default_rng(seed)
    dev = dispatch.default_device()

    def conv_w(shape, fan_in):
        return torch.tensor(
            (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32), device=dev
        )

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return {
        "frontend": frontend.init_params(),
        "stem": {"w": conv_w((width, 1, 3, 3), 9), "b": zeros(width)},
        "blocks": {
            "w": conv_w((n_blocks, width, width, 3, 3), width * 9),
            "b": zeros(n_blocks, width),
        },
        "head": {
            "w": torch.tensor(
                (rng.standard_normal((width, n_classes)) / np.sqrt(width)).astype(np.float32),
                device=dev,
            ),
            "b": zeros(n_classes),
        },
    }


def pp_param_specs() -> dict[str, Any]:
    """PartitionSpec tree: the block stack shards its layer axis over
    'stage'; everything else replicates."""
    return {
        "frontend": {"fb_t": P()},
        "stem": {"w": P(), "b": P()},
        "blocks": {"w": P(STAGE_AXIS), "b": P(STAGE_AXIS)},
        "head": {"w": P(), "b": P()},
    }


def pp_param_sharding(mesh: DeviceMesh) -> dict[str, Any]:
    """``NamedSharding`` tree (mesh + DTensor placements) for placing the
    global params on a pp mesh."""
    return sharding_tree(mesh, pp_param_specs())


def _stem_apply(stem: dict, feats: torch.Tensor) -> torch.Tensor:
    """dB features -> ``(B, width, H, W)`` activations (standardise + conv)."""
    x = standardize_features(feats)[:, None, :, :]
    return torch.relu(_conv_same(x, stem["w"], 2) + stem["b"][None, :, None, None])


def _block_apply(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One shape-preserving residual block: ``x + relu(conv(x))``."""
    return x + torch.relu(_conv_same(x, w, 1) + b[None, :, None, None])


def _blocks_apply(blocks: dict, x: torch.Tensor) -> torch.Tensor:
    """Apply a stacked ``(K, ...)`` block sub-stack in order."""
    for w, b in zip(blocks["w"], blocks["b"]):
        x = _block_apply(w, b, x)
    return x


def _head_apply(head: dict, x: torch.Tensor) -> torch.Tensor:
    pooled = torch.mean(x, dim=(-2, -1))
    return torch.matmul(pooled, head["w"]) + head["b"]


def deep_classifier_apply(
    frontend: TrainableLogMelFrontend,
    params: dict,
    y: ArrayLike,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """Serial (single-device) forward: the pipeline's reference semantics."""
    feats = frontend.apply(params["frontend"], y, use_pallas=use_pallas)
    x = _stem_apply(params["stem"], feats)
    x = _blocks_apply(params["blocks"], x)
    return _head_apply(params["head"], x)


def make_pp_train_step(
    mesh: DeviceMesh,
    frontend: TrainableLogMelFrontend,
    n_classes: int = 10,
    n_blocks: int = 4,
    width: int = 16,
    n_microbatches: int = 2,
    lr: float = 1e-2,
    use_pallas: bool | None = None,
):
    """SGD step of the deep classifier with the block stack pipelined.

    ``mesh`` is a ``(stage,)`` mesh from :func:`~..parallel.mesh.make_pp_mesh`;
    ``n_blocks`` must divide evenly into ``S`` stages and the batch into
    ``n_microbatches`` microbatches. Returns
    ``step(params, y, labels) -> (new_params, loss)`` over global params
    (DTensors placed by :func:`pp_param_sharding`, or global tensors); the
    new params are DTensors placed so.
    """
    S = axis_size(mesh, STAGE_AXIS)
    M = n_microbatches
    if n_blocks % S != 0:
        raise ValueError(f"n_blocks={n_blocks} must divide over {S} pipeline stages")
    if M < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {M}")
    shardings = pp_param_sharding(mesh)
    rep = placements(mesh, P())

    def body(params, y, labels):
        y_rep = local_shard(y, mesh, rep)
        lab = local_shard(labels, mesh, rep).to(y_rep.device)
        local = tree_map(lambda t, s: local_shard(t, mesh, s.placements), params, shardings)
        stage = axis_index(mesh, STAGE_AXIS)

        def loss_fn(p):
            feats = frontend.apply(p["frontend"], y_rep, use_pallas=use_pallas)
            x = _stem_apply(p["stem"], feats)  # (B, C, H, W), replicated
            B = x.shape[0]
            if B % M != 0:
                raise ValueError(f"batch ({B}) must divide into {M} microbatches")
            # the replicated stem output enters the stage-varying schedule
            mbs = _comm.to_varying(x, mesh, STAGE_AXIS).reshape(M, B // M, *x.shape[1:])
            first = torch.tensor(stage == 0, device=x.device)
            last = torch.tensor(stage == S - 1, device=x.device)
            state = torch.zeros_like(mbs[0])
            outs = [torch.zeros_like(mbs[0]) for _ in range(M)]
            for t in range(M + S - 1):
                # fill: stage 0 picks up microbatch t (clamped past the end:
                # its drain-phase work never reaches the last stage in time)
                state = torch.where(first, mbs[min(t, M - 1)], state)
                state = _blocks_apply(p["blocks"], state)
                # drain: the last stage banks microbatch t - (S - 1); every
                # stage selects, so every stage's schedule reaches the loss
                # and runs the backward shifts its neighbours wait for
                oi = min(max(t - (S - 1), 0), M - 1)
                if t >= S - 1:
                    outs[oi] = torch.where(last, state, outs[oi])
                # hand activations to the next stage over the ring
                state = _comm.ppermute(state, mesh, STAGE_AXIS, shift=1, tag=t)
            # only the last stage wrote outputs; the sum completes them everywhere
            out = _comm.psum(torch.stack(outs), mesh, STAGE_AXIS).reshape(B, *x.shape[1:])
            return _nll_loss(_head_apply(p["head"], out), lab)

        loss, grads = _local_grads(loss_fn, local)
        grads = tree_map(lambda g, s: from_local(g.contiguous(), mesh, s.placements),
                         grads, shardings)
        return loss, grads

    return make_sgd_step(body, lr)
