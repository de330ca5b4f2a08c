"""Expert-parallel (MoE) training for an audio frame classifier.

Counterpart of `mlx_audio_primitives_tpu/models/expert_parallel.py`, with
its names, signatures, defaults and errors: a Switch-style
mixture-of-experts layer sharded over a ``(data, expert)`` mesh
(`parallel.mesh.make_ep_mesh`):

* the log-mel frontend (K1 on a CUDA tensor) turns waveforms into
  per-frame tokens (``d = n_mels``); a learned router picks ONE expert per
  token (Switch top-1) with a static capacity ``C`` per expert per shard;
* each rank holds ``n_experts / n_expert_shards`` expert FFNs; tokens reach
  their expert's rank through :func:`~..parallel._comm.all_to_all` over the
  'expert' axis (``dist.all_to_all_single``) and return the same way;
* dispatch and combine are ``(T, E, C)`` one-hot einsums, as in the JAX
  package: tokens past an expert's capacity are dropped (the residual
  carries them), and the combine tensor carries the router probability so
  the router learns through the scaled expert output. Each holds about
  ``1.25 T^2`` floats at the default capacity factor;
* a Switch load-balance auxiliary loss (``E * sum_e f_e * P_e``).

Gradients. Each rank differentiates its LOCAL batch-mean loss; the
``all_to_all``'s backward (the swapped exchange) returns each expert
slice's cotangents from every rank of its expert row, so a local expert
gradient already sums that row's tokens, as in the JAX step. In the dp x
ep x tp step the Megatron pair (``_comm.to_varying`` before the
column-parallel ``w1``, ``_comm.psum`` after the row-parallel ``w2``)
gives every model rank the gradient of ONE copy of the loss, so the JAX
step's ``/ n_tp`` has no counterpart here. Both steps then sum expert
leaves over 'data' and the other leaves over 'data' and 'expert', and
divide by the number of ranks that hold distinct tokens.

The products (router, dispatch, experts, combine, head) are
``torch.matmul`` / ``torch.einsum`` at PyTorch's float32 matmul precision:
FP32, the JAX package's HIGHEST, unless a caller lowers it (e.g.
``torch.set_float32_matmul_precision("high")`` turns on TF32);
`chip_smoke.py` runs them at the default and prints it.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from .._config import REAL_DTYPE
from ..parallel import _comm
from ..parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    NamedSharding,
    P,
    axis_size,
    placements,
)
from ..parallel.sharding import from_local, local_shard, sharding_tree
from ..utils import dispatch as _dispatch
from ..utils.tree import tree_map
from .convnet import _local_grads, make_sgd_step, standardize_features
from .pipelines import TrainableLogMelFrontend, _nll_loss

ArrayLike = Any


def validate_ep_shapes(n_expert_shards: int, n_experts: int, batch: int,
                       n_devices: int) -> None:
    """Every sharded dimension must divide evenly over the expert mesh."""
    if n_expert_shards < 1:
        raise ValueError(f"n_expert_shards must be >= 1, got {n_expert_shards}")
    if n_experts % n_expert_shards != 0:
        raise ValueError(
            f"n_experts={n_experts} not divisible by "
            f"n_expert_shards={n_expert_shards}"
        )
    if batch % n_devices != 0:
        raise ValueError(
            f"batch={batch} not divisible by the {n_devices}-device mesh "
            "(the batch shards over BOTH mesh axes)"
        )


def init_moe_classifier_params(
    frontend: TrainableLogMelFrontend,
    n_classes: int,
    n_experts: int = 4,
    d_hidden: int = 64,
    seed: int = 0,
) -> dict[str, Any]:
    """Learnable filterbank + router + expert FFN stack + linear head, on
    the default device, drawn as the JAX package draws them.

    Expert weights are stacked on a leading ``n_experts`` dim, the dim the
    'expert' mesh axis shards (`moe_param_specs`).
    """
    d = frontend.n_mels
    rng = np.random.default_rng(seed)
    dev = _dispatch.default_device()

    def normal(shape, scale):
        return torch.tensor((rng.standard_normal(shape) * scale).astype(np.float32), device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=REAL_DTYPE, device=dev)

    return {
        "frontend": frontend.init_params(),
        "router": {"w": normal((d, n_experts), 0.02), "b": zeros(n_experts)},
        "experts": {
            "w1": normal((n_experts, d, d_hidden), math.sqrt(2.0 / d)),
            "b1": zeros(n_experts, d_hidden),
            "w2": normal((n_experts, d_hidden, d), math.sqrt(2.0 / d_hidden)),
            "b2": zeros(n_experts, d),
        },
        "head": {"w": normal((d, n_classes), 1.0 / math.sqrt(d)), "b": zeros(n_classes)},
    }


def moe_param_specs() -> dict[str, Any]:
    """PartitionSpec tree: expert stack sharded over 'expert', rest replicated."""
    return {
        "frontend": {"fb_t": P()},
        "router": {"w": P(), "b": P()},
        "experts": {
            "w1": P(EXPERT_AXIS),
            "b1": P(EXPERT_AXIS),
            "w2": P(EXPERT_AXIS),
            "b2": P(EXPERT_AXIS),
        },
        "head": {"w": P(), "b": P()},
    }


def moe_param_sharding(mesh: DeviceMesh) -> dict[str, Any]:
    """``NamedSharding`` tree for placing the global params on an ep mesh."""
    return sharding_tree(mesh, moe_param_specs())


def moe_capacity(
    tokens_per_group: int, n_experts: int, capacity_factor: float
) -> int:
    """Static per-expert token capacity for one routing group."""
    return max(1, math.ceil(tokens_per_group * capacity_factor / n_experts))


def _tokens_from_feats(feats: torch.Tensor) -> torch.Tensor:
    """``(B, n_mels, F)`` dB features -> standardized ``(B, F, d)`` tokens."""
    return standardize_features(feats).transpose(-2, -1)


def _route_tokens(
    x: torch.Tensor, router: dict, n_experts: int, capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Switch top-1 routing over token groups.

    ``x`` is ``(..., T, d)``: one group of ``T`` tokens per leading index
    (JAX's ``vmap`` over groups). Returns ``(dispatch, combine, aux)``
    where ``dispatch``/``combine`` are ``(..., T, E, C)`` one-hot /
    gate-weighted dispatch tensors and ``aux`` is each group's Switch
    load-balance loss. Tokens past an expert's capacity get an all-zero
    dispatch row (dropped: the MoE layer's residual carries them). The
    queue positions are float32 cumulative sums, exact below 2**24 tokens;
    ``argmax`` takes the first maximum, as ``jnp.argmax`` does.
    """
    logits = torch.matmul(x, router["w"]) + router["b"]  # (..., T, E)
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)  # (..., T)
    gate = torch.gather(probs, -1, expert_idx[..., None])[..., 0]
    mask = (expert_idx[..., None] == torch.arange(n_experts, device=x.device)).to(x.dtype)
    # position of each token in its expert's queue (0-based, arrival order)
    pos = torch.cumsum(mask, dim=-2) * mask - mask
    keep = mask * (pos < capacity)
    slots = torch.arange(capacity, device=x.device)
    dispatch = keep[..., None] * (pos.long()[..., None] == slots).to(x.dtype)  # (..., T, E, C)
    combine = dispatch * gate[..., None, None]
    # Switch aux loss: E * sum_e (fraction routed to e) * (mean prob of e);
    # minimized (=1) by a uniform router
    frac = torch.mean(mask, dim=-2)
    mean_prob = torch.mean(probs, dim=-2)
    aux = n_experts * torch.sum(frac * mean_prob, dim=-1)
    return dispatch, combine, aux


def _expert_ffn(inp: torch.Tensor, experts: dict) -> torch.Tensor:
    """Per-expert 2-layer FFN over stacked token buffers.

    ``inp`` is ``(..., E_local, buf, d)``; weights carry matching
    ``E_local`` leading dims. Both contractions are batched products."""
    h = torch.relu(torch.einsum("...ecd,edh->...ech", inp, experts["w1"])
                   + experts["b1"][:, None, :])
    return torch.einsum("...ech,ehd->...ecd", h, experts["w2"]) + experts["b2"][:, None, :]


def _moe_sharded_loss(
    p: dict,
    y_local: torch.Tensor,
    labels_local: torch.Tensor,
    *,
    mesh: DeviceMesh,
    frontend: TrainableLogMelFrontend,
    n_experts: int,
    capacity_factor: float,
    aux_coef: float,
    use_pallas: bool | None,
    expert_fn,
) -> torch.Tensor:
    """Rank-local MoE classifier loss (the body of a ``shard_map``).

    The body shared by :func:`make_ep_train_step` and
    :func:`make_ep_tp_train_step`: frontend -> tokens -> Switch routing ->
    dispatch einsum -> ``all_to_all`` to the experts' ranks ->
    ``expert_fn(expert_in, p['experts'])`` -> ``all_to_all`` home -> combine
    -> residual -> pooled head -> batch-mean NLL + aux.
    """
    feats = frontend.apply(p["frontend"], y_local, use_pallas=use_pallas)
    x = _tokens_from_feats(feats)  # (B_l, F, d)
    Bl, F, d = x.shape
    x = x.reshape(Bl * F, d)
    capacity = moe_capacity(Bl * F, n_experts, capacity_factor)
    dispatch, combine, aux = _route_tokens(x, p["router"], n_experts, capacity)
    expert_in = torch.einsum("tec,td->ecd", dispatch, x)  # (E, C, d)
    # tokens -> their experts' ranks: (E, C, d) -> (E/n_ep, n_ep*C, d)
    expert_in = _comm.all_to_all(expert_in, mesh, EXPERT_AXIS, split_dim=0, concat_dim=1)
    expert_out = expert_fn(expert_in, p["experts"])
    # processed tokens -> home ranks: back to (E, C, d)
    expert_out = _comm.all_to_all(expert_out, mesh, EXPERT_AXIS, split_dim=1, concat_dim=0)
    moe_out = torch.einsum("tec,ecd->td", combine, expert_out)
    tokens = (x + moe_out).reshape(Bl, F, d)
    pooled = torch.mean(tokens, dim=1)
    logits = torch.matmul(pooled, p["head"]["w"]) + p["head"]["b"]
    return _nll_loss(logits, labels_local) + aux_coef * aux


def _moe_layer_dense_group(
    x: torch.Tensor, params: dict, n_experts: int, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Routing groups of the MoE layer with the FULL expert stack: ``x`` is
    ``(..., T, d)``, one group of ``T`` tokens per leading index.

    The oracle for the sharded path: the all_to_all there is a pure
    permutation of token buffers and the FFN couples no tokens, so routing +
    dispatch + FFN + combine per group computes exactly these numbers.
    """
    dispatch, combine, aux = _route_tokens(x, params["router"], n_experts, capacity)
    expert_in = torch.einsum("...tec,...td->...ecd", dispatch, x)
    expert_out = _expert_ffn(expert_in, params["experts"])
    y = torch.einsum("...tec,...ecd->...td", combine, expert_out)
    return x + y, aux


def moe_classifier_apply(
    frontend: TrainableLogMelFrontend,
    params: dict,
    y: ArrayLike,
    n_experts: int,
    capacity_factor: float = 1.25,
    n_groups: int = 1,
    use_pallas: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (single-device) forward: ``(B, samples) -> (B, n_classes)``.

    ``n_groups`` emulates the sharded run's routing groups: the batch is
    split into ``n_groups`` contiguous chunks (the ep mesh's rank order
    for a ``P(('data','expert'))`` batch) and each routes independently with
    the same per-group capacity, so dense and sharded drop IDENTICAL
    tokens. Returns ``(logits, aux_loss)``.
    """
    feats = frontend.apply(params["frontend"], y, use_pallas=use_pallas)
    tokens = _tokens_from_feats(feats)  # (B, F, d)
    B, F, d = tokens.shape
    if B % n_groups != 0:
        raise ValueError(f"batch {B} not divisible by n_groups={n_groups}")
    bg = B // n_groups
    capacity = moe_capacity(bg * F, n_experts, capacity_factor)
    out, aux = _moe_layer_dense_group(tokens.reshape(n_groups, bg * F, d), params,
                                      n_experts, capacity)
    tokens = out.reshape(B, F, d)
    pooled = torch.mean(tokens, dim=1)  # (B, d)
    logits = torch.matmul(pooled, params["head"]["w"]) + params["head"]["b"]
    return logits, torch.mean(aux)


def _make_moe_step(mesh, specs, n_tok_dev, validate, lr, loss_kw):
    """The SGD step shared by the ep and ep x tp trainers: each rank's
    local loss and gradients, then expert leaves summed over 'data' and the
    others over 'data' and 'expert', all divided by ``n_tok_dev``."""
    shardings = sharding_tree(mesh, specs)
    batch = placements(mesh, P((DATA_AXIS, EXPERT_AXIS)))

    def body(params, y, labels):
        y_local = local_shard(y, mesh, batch)
        lab = local_shard(labels, mesh, batch).to(y_local.device)
        local = tree_map(lambda t, s: local_shard(t, mesh, s.placements), params, shardings)
        loss, grads = _local_grads(
            lambda p: _moe_sharded_loss(p, y_local, lab, mesh=mesh, **loss_kw), local)

        def finish(g, spec, sharding):
            axes = (DATA_AXIS,) if spec.parts[:1] == (EXPERT_AXIS,) else (DATA_AXIS, EXPERT_AXIS)
            g = _comm.psum_(g.contiguous(), mesh, axes).div_(n_tok_dev)
            return from_local(g, mesh, sharding.placements)

        grads = tree_map(finish, grads, specs, shardings)
        # every model rank holds the same loss
        return _comm.pmean_(loss, mesh, (DATA_AXIS, EXPERT_AXIS)), grads

    return make_sgd_step(body, lr, validate=validate)


def make_ep_train_step(
    mesh: DeviceMesh,
    frontend: TrainableLogMelFrontend,
    n_classes: int = 10,
    n_experts: int = 4,
    d_hidden: int = 64,
    capacity_factor: float = 1.25,
    aux_coef: float = 0.01,
    lr: float = 1e-2,
    use_pallas: bool | None = None,
):
    """SGD step of the MoE audio classifier, dp x ep sharded.

    ``mesh`` is a ``(data, expert)`` mesh from
    :func:`~..parallel.mesh.make_ep_mesh`. The batch shards over BOTH axes
    (every rank routes its own token group); expert FFNs shard over
    'expert' per :func:`moe_param_specs`; tokens cross the expert axis by
    two ``all_to_all`` exchanges. Returns
    ``step(params, y, labels) -> (new_params, loss)`` over global params
    (DTensors placed by :func:`moe_param_sharding`, or global tensors); the
    new params are DTensors placed so.
    """
    n_ep = axis_size(mesh, EXPERT_AXIS)
    n_dev = n_ep * axis_size(mesh, DATA_AXIS)
    if n_experts % n_ep != 0:
        raise ValueError(
            f"n_experts={n_experts} not divisible by the expert axis ({n_ep})"
        )
    return _make_moe_step(
        mesh, moe_param_specs(), n_dev,
        lambda y: validate_ep_shapes(n_ep, n_experts, y.shape[0], n_dev), lr,
        dict(frontend=frontend, n_experts=n_experts, capacity_factor=capacity_factor,
             aux_coef=aux_coef, use_pallas=use_pallas, expert_fn=_expert_ffn),
    )


def ep_batch_sharding(mesh: DeviceMesh) -> NamedSharding:
    """Sharding for ``(batch, ...)`` arrays: batch over BOTH ep mesh axes."""
    return NamedSharding(mesh, placements(mesh, P((DATA_AXIS, EXPERT_AXIS))))


# ---------------------------------------------------------------------------
# dp x ep x tp: Megatron-sharded experts on a (data, expert, model) mesh


def moe_tp_param_specs() -> dict[str, Any]:
    """PartitionSpec tree for the 3-axis mesh: expert stacks shard over
    'expert' AND each expert FFN shards over 'model': ``w1`` column-parallel
    (hidden dim), ``w2`` row-parallel (hidden dim), ``b2`` replicated over
    'model' (added once, after the sum)."""
    return {
        "frontend": {"fb_t": P()},
        "router": {"w": P(), "b": P()},
        "experts": {
            "w1": P(EXPERT_AXIS, None, MODEL_AXIS),
            "b1": P(EXPERT_AXIS, MODEL_AXIS),
            "w2": P(EXPERT_AXIS, MODEL_AXIS, None),
            "b2": P(EXPERT_AXIS),
        },
        "head": {"w": P(), "b": P()},
    }


def moe_tp_param_sharding(mesh: DeviceMesh) -> dict[str, Any]:
    return sharding_tree(mesh, moe_tp_param_specs())


def moe_batch_sharding(mesh: DeviceMesh) -> NamedSharding:
    """Batch over ('data','expert'); replicated over 'model' (each model
    shard sees the same tokens: Megatron activations)."""
    return NamedSharding(mesh, placements(mesh, P((DATA_AXIS, EXPERT_AXIS))))


def make_ep_tp_train_step(
    mesh: DeviceMesh,
    frontend: TrainableLogMelFrontend,
    n_classes: int = 10,
    n_experts: int = 4,
    d_hidden: int = 64,
    capacity_factor: float = 1.25,
    aux_coef: float = 0.01,
    lr: float = 1e-2,
    use_pallas: bool | None = None,
):
    """SGD step of the MoE classifier on a ``(data, expert, model)`` mesh.

    Tokens shard over ('data','expert') and replicate over 'model'; routing,
    dispatch and ``all_to_all`` work exactly as in
    :func:`make_ep_train_step`; INSIDE each expert the FFN is
    Megatron-sharded: ``w1`` column-parallel (each model rank computes a
    hidden slice), ``w2`` row-parallel with a sum over 'model' completing
    the contraction, ``b2`` added once after the sum.
    """
    n_ep = axis_size(mesh, EXPERT_AXIS)
    n_tp = axis_size(mesh, MODEL_AXIS)
    n_tok_dev = n_ep * axis_size(mesh, DATA_AXIS)  # ranks holding distinct tokens
    if n_experts % n_ep != 0:
        raise ValueError(
            f"n_experts={n_experts} not divisible by the expert axis ({n_ep})"
        )
    if d_hidden % n_tp != 0:
        raise ValueError(
            f"d_hidden={d_hidden} not divisible by the model axis ({n_tp})"
        )

    def _tp_expert_ffn(expert_in, e):
        # the replicated tokens enter the column-parallel w1: their
        # cotangent is the sum of the model ranks' parts
        h = torch.relu(torch.einsum("ecd,edh->ech", _comm.to_varying(expert_in, mesh, MODEL_AXIS),
                                    e["w1"]) + e["b1"][:, None, :])
        out_partial = torch.einsum("ech,ehd->ecd", h, e["w2"])
        return _comm.psum(out_partial, mesh, MODEL_AXIS) + e["b2"][:, None, :]

    return _make_moe_step(
        mesh, moe_tp_param_specs(), n_tok_dev,
        lambda y: validate_ep_shapes(n_ep, n_experts, y.shape[0], n_tok_dev), lr,
        dict(frontend=frontend, n_experts=n_experts, capacity_factor=capacity_factor,
             aux_coef=aux_coef, use_pallas=use_pallas, expert_fn=_tp_expert_ffn),
    )
