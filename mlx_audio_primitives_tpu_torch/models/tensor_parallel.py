"""Tensor-parallel (Megatron-style) training for the conv audio classifier.

Counterpart of `mlx_audio_primitives_tpu/models/tensor_parallel.py`:
sharding the MODEL over a ``(data, model)`` mesh
(`parallel.mesh.make_tp_mesh`):

* even conv layers are **column-parallel**: output channels sharded over
  'model', each rank convolving its channel slice, activations left
  channel-sharded with no communication;
* odd conv layers are **row-parallel**: input channels sharded to match,
  partial outputs summed with an ``all_reduce``, bias added once after the
  sum;
* the linear head is **column-parallel**: logit columns sharded, completed
  with a tiled ``all_gather`` so the softmax sees every class.

Gradients. The JAX step leaves each cotangent's collective to
``shard_map``'s tracking of values that vary over 'model', which returns
every leaf's gradient summed over the mesh, and divides by its size. Here
each collective is an autograd function with Megatron's conjugate pair
(`parallel/_comm.py`): the row-parallel sum's backward is the identity; a
replicated activation entering a column-parallel layer (or the head) sums
its cotangent over 'model' in the backward; the head's gather keeps this
rank's slice. So each rank's gradients are already the true gradients of
its local batch, sharded as its parameters are, and replicated leaves
agree over 'model'; one mean over 'data' gives the data-parallel step.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..parallel import _comm
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, P, axis_size, placements
from ..parallel.sharding import from_local, local_shard, sharding_tree
from ..utils.tree import tree_map
from .convnet import _conv_same, _local_grads, make_sgd_step, standardize_features
from .pipelines import TrainableLogMelFrontend, _nll_loss


def _is_col_parallel(i: int) -> bool:
    """Conv layer i's parallel style: even = column (out-ch sharded), odd =
    row (in-ch sharded). Alternating keeps activations local between a
    col->row pair: the Megatron MLP block pattern."""
    return i % 2 == 0


def validate_tp_shapes(
    n_model: int, channels: tuple[int, ...], n_classes: int
) -> None:
    """Every sharded dimension must divide evenly over the model axis."""
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    for i, c in enumerate(channels):
        if c % n_model != 0:
            raise ValueError(
                f"channels[{i}]={c} not divisible by n_model={n_model}"
            )
    if n_classes % n_model != 0:
        raise ValueError(
            f"n_classes={n_classes} not divisible by n_model={n_model}; "
            "pad the class count or lower n_model"
        )


def tp_param_specs(channels: tuple[int, ...]) -> dict[str, Any]:
    """PartitionSpec tree matching ``init_audio_classifier_params`` output.

    Col-parallel convs shard w's OUT-channel dim (OIHW dim 0) and their
    bias; row-parallel convs shard w's IN-channel dim (dim 1) with a
    replicated bias (added once, after the sum); the head shards logit
    columns. The frontend filterbank stays replicated.
    """
    net: dict[str, Any] = {}
    for i in range(len(channels)):
        if _is_col_parallel(i):
            net[f"conv{i}"] = {"w": P(MODEL_AXIS), "b": P(MODEL_AXIS)}
        else:
            net[f"conv{i}"] = {"w": P(None, MODEL_AXIS), "b": P()}
    net["head"] = {"w": P(None, MODEL_AXIS), "b": P(MODEL_AXIS)}
    return {"frontend": {"fb_t": P()}, "net": net}


def tp_param_sharding(
    mesh: DeviceMesh, channels: tuple[int, ...]
) -> dict[str, Any]:
    """``NamedSharding`` tree (mesh + DTensor placements) for placing the
    global params on a tp mesh."""
    return sharding_tree(mesh, tp_param_specs(channels))


def _tp_convnet_apply(
    net: dict, feats: torch.Tensor, n_layers: int, mesh: DeviceMesh
) -> torch.Tensor:
    """Rank-local classifier body: feats ``(B_l, n_mels, F)`` -> logits
    ``(B_l, n_classes)`` (full, after the head's gather); ``net`` leaves are
    this rank's slices."""
    x = standardize_features(feats)[:, None, :, :]
    sharded = False  # are activations currently channel-sharded?
    for i in range(n_layers):
        layer = net[f"conv{i}"]
        if _is_col_parallel(i):
            x = _comm.to_varying(x, mesh, MODEL_AXIS)
            x = torch.relu(_conv_same(x, layer["w"], 2) + layer["b"][None, :, None, None])
            sharded = True
        else:
            # complete the row-parallel contraction
            x = _comm.psum(_conv_same(x, layer["w"], 2), mesh, MODEL_AXIS)
            x = torch.relu(x + layer["b"][None, :, None, None])
            sharded = False
    if sharded:
        # odd-depth stack ends channel-sharded: gather channels for the pool
        x = _comm.all_gather(x, mesh, MODEL_AXIS, dim=1)
    pooled = _comm.to_varying(torch.mean(x, dim=(-2, -1)), mesh, MODEL_AXIS)  # (B_l, C)
    head = net["head"]
    logits_local = torch.matmul(pooled, head["w"]) + head["b"]
    return _comm.all_gather(logits_local, mesh, MODEL_AXIS, dim=1)


def make_tp_train_step(
    mesh: DeviceMesh,
    frontend: TrainableLogMelFrontend,
    n_classes: int = 10,
    channels: tuple[int, ...] = (16, 32),
    lr: float = 1e-2,
    use_pallas: bool | None = None,
):
    """SGD step of the end-to-end audio classifier, dp x tp sharded.

    ``mesh`` is a ``(data, model)`` mesh from
    :func:`~..parallel.mesh.make_tp_mesh`. The batch shards over 'data';
    parameters shard over 'model' per :func:`tp_param_specs`; the frontend
    replicates over 'model' (its tables are small: sharding the mel GEMM
    would shard a spatial dim of the conv input). Returns
    ``step(params, y, labels) -> (new_params, loss)`` over global params
    (DTensors placed by :func:`tp_param_sharding`, or global tensors); the
    new params are DTensors placed so.
    """
    n_model = axis_size(mesh, MODEL_AXIS)
    n_layers = len(channels)
    validate_tp_shapes(n_model, channels, n_classes)
    shardings = tp_param_sharding(mesh, channels)
    batch = placements(mesh, P(DATA_AXIS))

    def body(params, y, labels):
        y_local = local_shard(y, mesh, batch)
        lab = local_shard(labels, mesh, batch).to(y_local.device)
        local = tree_map(lambda t, s: local_shard(t, mesh, s.placements), params, shardings)

        def loss_fn(p):
            feats = frontend.apply(p["frontend"], y_local, use_pallas=use_pallas)
            return _nll_loss(_tp_convnet_apply(p["net"], feats, n_layers, mesh), lab)

        loss, grads = _local_grads(loss_fn, local)
        grads = tree_map(
            lambda g, s: from_local(_comm.pmean_(g, mesh, (DATA_AXIS,)), mesh, s.placements),
            grads, shardings,
        )
        # every model rank holds the same loss (after the gather)
        return _comm.pmean_(loss, mesh, (DATA_AXIS,)), grads

    return make_sgd_step(body, lr)
