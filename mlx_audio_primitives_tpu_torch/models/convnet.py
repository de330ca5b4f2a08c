"""Compact convolutional audio classifier over the log-mel frontend.

Counterpart of `mlx_audio_primitives_tpu/models/convnet.py`: a
keyword-spotting-shaped conv net whose input features come from
``TrainableLogMelFrontend``, making the whole stack (learnable mel
filterbank through K1 and its plain-composition backward, conv stack,
pooled linear head) differentiable end to end, and giving
``models/checkpoint.py`` a realistic training state to persist.

Design notes:

* Convolutions are ``torch.nn.functional.conv2d`` in NCHW/OIHW, the JAX
  package's layout, in float32. JAX pads ``"SAME"`` asymmetrically at
  stride 2 (low side ``total // 2``, high side the rest), which PyTorch's
  ``padding='same'`` refuses, so :func:`_conv_same` pads explicitly. cuDNN
  runs a float32 convolution in TF32 while
  ``torch.backends.cudnn.allow_tf32`` is True, PyTorch's default, so
  :func:`_conv_same` turns the flag off around its forward and backward
  convolutions and restores the caller's value after each: FP32, the
  counterpart of the JAX package's HIGHEST precision, whatever the
  caller's setting. The head's ``torch.matmul`` follows PyTorch's float32
  matmul precision, FP32 by default.
* The training step shards the batch over EVERY mesh axis (the dp x sp
  meshes used elsewhere flatten into one data axis here: convs over the
  frame axis would couple time shards, so the conv model is data-parallel
  by design).
* Parameters stay replicated; each rank's gradients are averaged over the
  flattened batch axis with one SUM ``all_reduce`` per mesh axis.
"""

from __future__ import annotations

from typing import Any

from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as tnf
from torch.distributed.device_mesh import DeviceMesh

from .._config import REAL_DTYPE
from ..parallel import _comm
from ..parallel.mesh import NamedSharding, P, placements
from ..parallel.sharding import from_local, local_shard
from ..utils import dispatch
from ..utils.tree import leaves, tree_map
from .pipelines import TrainableLogMelFrontend, _nll_loss

ArrayLike = Any


@contextmanager
def _fp32_cudnn():
    """cuDNN's float32 convolutions in FP32 (no TF32) for the block, the
    caller's ``torch.backends.cudnn.allow_tf32`` restored after it."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class _Conv2dFP32(torch.autograd.Function):
    """``conv2d`` without padding, its forward and both of its backward
    convolutions in FP32 (the backward runs after the forward's call has
    returned, so it sets the flag again)."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _fp32_cudnn():
            return tnf.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        gx = gw = None
        with _fp32_cudnn():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(x.shape, w, grad, stride=ctx.stride)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, grad, stride=ctx.stride)
        return gx, gw, None


def _conv_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, (stride, stride), "SAME")`` in
    NCHW/OIHW at FP32: XLA's SAME padding (``ceil(n / stride)`` outputs;
    the low side gets ``total // 2`` of the padding, the high side the
    rest)."""
    pads = []
    for n, k in ((x.shape[3], w.shape[3]), (x.shape[2], w.shape[2])):
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return _Conv2dFP32.apply(tnf.pad(x, pads), w, stride)


def standardize_features(feats: torch.Tensor) -> torch.Tensor:
    """Per-sample standardisation over the (n_mels, frames) axes.

    The shared first stage of every classifier body in ``models/`` (dp, tp
    and pp variants all normalise features identically)."""
    x = feats.to(torch.float32)
    mean = torch.mean(x, dim=(-2, -1), keepdim=True)
    std = torch.std(x, dim=(-2, -1), keepdim=True, correction=0)
    return (x - mean) / (std + 1e-5)


def make_sgd_step(sharded_body, lr: float, validate=None):
    """Close a ``(params, y, labels) -> (loss, grads)`` sharded body into the
    SGD update shared by every ``make_*_train_step`` factory. The body's
    gradients are DTensors; each new parameter is this rank's local
    ``p - lr * g`` on the gradient's mesh and placements, returned as a
    DTensor (``params`` may be DTensors or global tensors). ``validate``
    (optional) gets the global batch before the step, for clear shape
    errors."""

    def update(p, g):
        with torch.no_grad():
            local = local_shard(p, g.device_mesh, g.placements)
            return from_local(local - lr * g.to_local(), g.device_mesh, g.placements)

    def step(params, y, labels):
        if validate is not None:
            validate(y)
        loss, grads = sharded_body(params, y, labels)
        return tree_map(update, params, grads), loss

    return step


def init_convnet_params(
    n_classes: int,
    channels: tuple[int, ...] = (16, 32),
    seed: int = 0,
) -> dict[str, torch.Tensor]:
    """He-initialised parameters for :func:`convnet_apply`, on the default
    device.

    Returns ``{"conv0": {"w","b"}, "conv1": {...}, ..., "head": {"w","b"}}``
    with 3x3 kernels; ``head.w`` maps the channel-pooled features to logits.
    """
    rng = np.random.default_rng(seed)
    dev = dispatch.default_device()

    def tensor(a):
        return torch.tensor(a.astype(np.float32), device=dev)

    params: dict[str, Any] = {}
    in_c = 1
    for i, out_c in enumerate(channels):
        fan_in = in_c * 9
        params[f"conv{i}"] = {
            "w": tensor(rng.standard_normal((out_c, in_c, 3, 3)) * np.sqrt(2.0 / fan_in)),
            "b": torch.zeros((out_c,), dtype=REAL_DTYPE, device=dev),
        }
        in_c = out_c
    params["head"] = {
        "w": tensor(rng.standard_normal((in_c, n_classes)) / np.sqrt(in_c)),
        "b": torch.zeros((n_classes,), dtype=REAL_DTYPE, device=dev),
    }
    return params


def convnet_apply(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """``(B, n_mels, n_frames)`` dB features -> ``(B, n_classes)`` logits.

    Per-sample standardisation -> [3x3 conv stride 2, ReLU] per conv layer
    -> global average pool -> linear head.
    """
    x = standardize_features(feats)[:, None, :, :]  # (B, 1, n_mels, F)
    i = 0
    while f"conv{i}" in params:
        layer = params[f"conv{i}"]
        x = torch.relu(_conv_same(x, layer["w"], 2) + layer["b"][None, :, None, None])
        i += 1
    pooled = torch.mean(x, dim=(-2, -1))  # (B, C)
    head = params["head"]
    return torch.matmul(pooled, head["w"]) + head["b"]


def init_audio_classifier_params(
    frontend: TrainableLogMelFrontend,
    n_classes: int,
    channels: tuple[int, ...] = (16, 32),
    seed: int = 0,
) -> dict[str, Any]:
    """Full end-to-end state: learnable filterbank + conv net."""
    return {
        "frontend": frontend.init_params(),
        "net": init_convnet_params(n_classes, channels=channels, seed=seed),
    }


def audio_classifier_apply(
    frontend: TrainableLogMelFrontend,
    params: dict,
    y: ArrayLike,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """``(B, samples)`` waveforms -> ``(B, n_classes)`` logits, end to end."""
    feats = frontend.apply(params["frontend"], y, use_pallas=use_pallas)
    return convnet_apply(params["net"], feats)


def batch_sharding(mesh: DeviceMesh) -> NamedSharding:
    """Batch sharded over ALL mesh axes (flattened data parallelism):
    ``Shard(0)`` on every mesh dimension, data-major."""
    return NamedSharding(mesh, placements(mesh, P(tuple(mesh.mesh_dim_names))))


def _local_grads(loss_fn, params: Any) -> tuple[torch.Tensor, Any]:
    """``jax.value_and_grad`` on this rank's local parameter tensors:
    ``(loss, grads)`` with ``grads`` a tree like ``params``. ``params`` is a
    tree of local tensors; each becomes a fresh leaf that requires grad."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = loss_fn(p)
    flat = leaves(p)
    by_leaf = {id(t): g for t, g in zip(flat, torch.autograd.grad(loss, flat))}
    return loss.detach(), tree_map(lambda t: by_leaf[id(t)], p)


def make_convnet_train_step(
    mesh: DeviceMesh,
    frontend: TrainableLogMelFrontend,
    n_classes: int = 10,
    channels: tuple[int, ...] = (16, 32),
    lr: float = 1e-2,
    use_pallas: bool | None = None,
):
    """SGD step for the end-to-end audio classifier, data-parallel.

    The batch is sharded over the FLATTENED mesh (every axis acts as data
    parallelism: :func:`batch_sharding`), parameters are replicated, and
    loss and gradients are averaged over all axes. The frontend runs on each
    rank's shard, so K1 is one device-local launch per card.

    Returns ``step(params, y, labels) -> (new_params, loss)``.
    """
    axes = tuple(mesh.mesh_dim_names)
    batch = batch_sharding(mesh).placements
    rep = placements(mesh, P())

    def body(params, y, labels):
        y_local = local_shard(y, mesh, batch)
        lab = local_shard(labels, mesh, batch).to(y_local.device)
        local = tree_map(lambda t: local_shard(t, mesh, rep), params)

        def loss_fn(p):
            logits = audio_classifier_apply(frontend, p, y_local, use_pallas=use_pallas)
            return _nll_loss(logits, lab)

        loss, grads = _local_grads(loss_fn, local)
        grads = tree_map(lambda g: from_local(_comm.pmean_(g, mesh, axes), mesh, rep), grads)
        return _comm.pmean_(loss, mesh, axes), grads

    return make_sgd_step(body, lr)
