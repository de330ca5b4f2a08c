"""Transformer audio classifier with ring-attention context parallelism.

Counterpart of `mlx_audio_primitives_tpu/models/transformer.py`, with its
names, signatures and defaults: an AST-style transformer encoder over
log-mel *frame tokens* whose attention runs as a **ring** over the same
``(data, time)`` mesh the DSP layer shards waveforms on.

The waveform is sharded over 'time', `logmel_time_sharded` turns each
shard's samples into its own frame tokens (one ring shift of ``n_fft -
hop`` halo samples; K1 once a rank under ``fft_mode='pallas'``), and the
encoder attends across shards by rotating K/V blocks around the ring with
``_comm.ppermute`` while accumulating the softmax online (running max,
normalizer and rescaled accumulator, as flash attention does): no rank
holds the whole ``(T, T)`` score matrix or the gathered sequence.

* Attention is einsums with an explicit online softmax, as in the JAX
  package, which has no attention kernel: the full attention
  (:func:`_full_attention`) is the single-device oracle.
* The stacked ``(n_blocks, ...)`` block leaves stay stacked; the JAX
  package's ``lax.scan`` over them is a loop over the stack's index.
* Every product is ``torch.einsum`` / ``torch.matmul`` at PyTorch's float32
  matmul precision: FP32, the JAX package's HIGHEST, unless a caller lowers
  it (``torch.set_float32_matmul_precision("high")`` turns on TF32);
  `chip_smoke.py` runs them at the default and prints it.

Gradients. Each rank differentiates its own copy of the loss. The pooled
tokens are summed over 'time' by ``_comm.psum``, whose backward is the
identity, so each rank starts from the true cotangent of its own tokens;
the ring's shifts carry K/V cotangents back to their ranks. A parameter
used on the tokens (``embed``, ``pos`` through its rank's rows, every
block, ``ln_f``) then holds this rank's part of the gradient, summed over
'time'; the ``head``, used after the sum, holds the whole gradient on
every rank. Last, a mean over 'data'. The log-mel features take no
gradient, so the standardisation's sums need no backward of their own.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as tnf
from torch.distributed.device_mesh import DeviceMesh

from ..parallel import _comm
from ..parallel.mesh import DATA_AXIS, TIME_AXIS, P, axis_index, axis_size, placements
from ..parallel.sharding import from_local, local_shard, sharding_tree
from ..parallel.time_shard import logmel_time_sharded
from ..utils import dispatch
from ..utils.tree import tree_map
from .convnet import _local_grads, make_sgd_step
from .pipelines import _nll_loss

ArrayLike = Any


# ---------------------------------------------------------------------------
# Parameters


def sinusoidal_positions(n_positions: int, d_model: int) -> np.ndarray:
    """Standard sin/cos position table ``(n_positions, d_model)`` in f32.

    Used as the *initialization* of a trainable position embedding (learned
    positions starting at the sinusoid: deterministic, no RNG)."""
    pos = np.arange(n_positions, dtype=np.float64)[:, None]
    dim = np.arange(d_model, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (dim // 2) / d_model)
    table = np.where(dim % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


def _host_params(n_mels, n_classes, n_frames, d_model, n_heads, d_ff, n_blocks, seed):
    """The parameter tree as float32 NumPy arrays, drawn as the JAX package
    draws them."""
    if d_model % n_heads != 0:
        raise ValueError(
            f"d_model={d_model} not divisible by n_heads={n_heads}"
        )
    d_head = d_model // n_heads
    rng = np.random.default_rng(seed)

    def dense(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    nb = n_blocks
    return {
        "embed": {"w": dense((n_mels, d_model), n_mels), "b": zeros(d_model)},
        "pos": sinusoidal_positions(n_frames, d_model),
        "blocks": {
            "ln1": {"g": ones(nb, d_model), "b": zeros(nb, d_model)},
            "attn": {
                "wq": dense((nb, d_model, n_heads, d_head), d_model),
                "wk": dense((nb, d_model, n_heads, d_head), d_model),
                "wv": dense((nb, d_model, n_heads, d_head), d_model),
                "wo": dense((nb, n_heads, d_head, d_model), d_model),
            },
            "ln2": {"g": ones(nb, d_model), "b": zeros(nb, d_model)},
            "mlp": {
                "w1": dense((nb, d_model, d_ff), d_model),
                "b1": zeros(nb, d_ff),
                "w2": dense((nb, d_ff, d_model), d_ff),
                "b2": zeros(nb, d_model),
            },
        },
        "ln_f": {"g": ones(d_model), "b": zeros(d_model)},
        "head": {"w": dense((d_model, n_classes), d_model), "b": zeros(n_classes)},
    }


def init_transformer_params(
    n_mels: int,
    n_classes: int,
    n_frames: int,
    d_model: int = 64,
    n_heads: int = 4,
    d_ff: int = 128,
    n_blocks: int = 2,
    seed: int = 0,
) -> dict[str, Any]:
    """He/Xavier-initialized encoder parameters, on the default device.

    Block leaves carry a leading ``(n_blocks,)`` stack axis (looped over in
    :func:`transformer_apply`). Head dims: ``d_model = n_heads * d_head``.
    """
    host = _host_params(n_mels, n_classes, n_frames, d_model, n_heads, d_ff, n_blocks, seed)
    dev = dispatch.default_device()
    return tree_map(lambda a: torch.tensor(a, device=dev), host)


def transformer_param_specs() -> dict[str, Any]:
    """PartitionSpec tree for the (data, time) CP mesh: every parameter is
    replicated: context parallelism shards the *tokens*, not the weights."""
    return tree_map(lambda _: P(), _host_params(8, 2, 4, 8, 2, 8, 2, 0))


# ---------------------------------------------------------------------------
# Encoder body (shared between the single-device and ring paths)


def _layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * g + b


def _mlp(blk: dict, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    h = tnf.gelu(torch.einsum("btd,df->btf", x, blk["w1"]) + blk["b1"], approximate="tanh")
    return torch.einsum("btf,fd->btd", h, blk["w2"]) + blk["b2"]


def _qkv(attn: dict, x: torch.Tensor):
    q = torch.einsum("btd,dhk->bthk", x, attn["wq"])
    k = torch.einsum("btd,dhk->bthk", x, attn["wk"])
    v = torch.einsum("btd,dhk->bthk", x, attn["wv"])
    return q, k, v


def _full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Reference bidirectional attention: ``(B, T, H, dh)`` q/k/v -> context.

    The single-device oracle the ring path must match."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = torch.einsum("bthk,bshk->bhts", q, k) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshk->bthk", p, v)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: DeviceMesh,
) -> torch.Tensor:
    """Context-parallel bidirectional attention over a ring.

    ``q``/``k``/``v`` are this rank's ``(B_l, T_l, H, dh)`` blocks of a
    sequence sharded over a mesh axis. ``axis_name`` is that axis as a
    one-dimensional mesh, ``mesh[TIME_AXIS]`` (the port has no ambient
    ``shard_map`` mesh in which a name alone would find it). Each of the
    ``n`` steps contracts the local queries against the K/V block held and
    folds the result into an online softmax (running per-row max ``m``,
    normalizer ``l``, rescaled accumulator), then rotates K and V one hop
    around the ring (``_comm.ppermute``, a tag of their own at each step):
    O(T_l) memory, full-sequence attention.

    Returns the local context block ``(B_l, T_l, H, dh)``, equal to
    :func:`_full_attention` on the gathered sequence to f32 accumulation
    error (~1e-6).
    """
    mesh, axis = axis_name, axis_name.mesh_dim_names[0]
    n = mesh.size()
    scale = 1.0 / np.sqrt(q.shape[-1])

    m = torch.full(q.shape[:3], float("-inf"), dtype=q.dtype, device=q.device)  # running max
    l = torch.zeros(q.shape[:3], dtype=q.dtype, device=q.device)  # running normalizer
    acc = torch.zeros_like(q)  # running context numerator
    for i in range(n):
        s = torch.einsum("bthk,bshk->bths", q, k) * scale  # (B, T_l, H, S_l)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # scores are finite, so m_new > -inf after the first block and the
        # correction exp(m - m_new) is well-defined (exp(-inf) = 0 on step 0)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bths,bshk->bthk", p, v)
        m = m_new
        if i < n - 1:
            k = _comm.ppermute(k, mesh, axis, shift=1, tag=2 * i)
            v = _comm.ppermute(v, mesh, axis, shift=1, tag=2 * i + 1)
    return acc / l[..., None]


def _encoder_tokens(
    params: dict,
    tokens: torch.Tensor,
    pos: torch.Tensor,
    attention,
) -> torch.Tensor:
    """Shared encoder trunk: ``(B, T, n_mels)`` standardized tokens ->
    ``(B, T, d_model)`` encoded tokens. ``attention(q, k, v)`` is either the
    full single-device contraction or the ring schedule."""
    x = torch.einsum("btm,md->btd", tokens, params["embed"]["w"]) + params["embed"]["b"] + pos
    blocks = params["blocks"]
    for i in range(blocks["ln1"]["g"].shape[0]):
        blk = tree_map(lambda a: a[i], blocks)
        h = _layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"])
        q, k, v = _qkv(blk["attn"], h)
        x = x + torch.einsum("bthk,hkd->btd", attention(q, k, v), blk["attn"]["wo"])
        h = _layernorm(x, blk["ln2"]["g"], blk["ln2"]["b"])
        x = x + _mlp(blk["mlp"], h)
    return _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])


def _standardize_tokens(tokens: torch.Tensor) -> torch.Tensor:
    """Per-sample standardization over (tokens, features): the token-layout
    twin of `convnet.standardize_features` (same statistics, transposed)."""
    mean = torch.mean(tokens, dim=(-2, -1), keepdim=True)
    std = torch.std(tokens, dim=(-2, -1), keepdim=True, correction=0)
    return (tokens - mean) / (std + 1e-5)


def transformer_logits(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """``(B, T, n_mels)`` raw dB tokens -> ``(B, n_classes)`` logits.

    Single-device reference path: standardize -> encoder (full attention) ->
    mean-pool over tokens -> linear head. The CP step computes exactly this
    with the sequence axis sharded."""
    tokens = _standardize_tokens(tokens)
    F = tokens.shape[1]
    pos = params["pos"][:F][None]
    x = _encoder_tokens(params, tokens, pos, _full_attention)
    pooled = torch.mean(x, dim=1)
    return torch.matmul(pooled, params["head"]["w"]) + params["head"]["b"]


def transformer_apply(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """``(B, n_mels, F)`` dB features (the library's standard feature
    layout) -> ``(B, n_classes)`` logits."""
    return transformer_logits(params, dispatch.to_tensor(feats).transpose(-1, -2))


# ---------------------------------------------------------------------------
# Context-parallel training step over the (data, time) mesh


def transformer_param_sharding(mesh: DeviceMesh, params: dict) -> dict:
    """``NamedSharding`` tree (all replicated) matching ``params``' structure."""
    return sharding_tree(mesh, tree_map(lambda _: P(), params))


def make_cp_train_step(
    mesh: DeviceMesh,
    sr: int = 22050,
    n_fft: int = 512,
    hop_length: int | None = None,
    n_mels: int = 64,
    n_classes: int = 10,
    d_model: int = 64,
    n_heads: int = 4,
    d_ff: int = 128,
    n_blocks: int = 2,
    lr: float = 1e-2,
    fft_mode: str = "matmul",
):
    """SGD step of the transformer classifier, dp x cp sharded end to end.

    ``mesh`` is the library's ``(data, time)`` mesh (`make_mesh`): the batch
    shards over 'data', and the SEQUENCE (raw samples into
    `logmel_time_sharded`, frame tokens through the encoder) shards over
    'time'. The frontend exchanges sample halos, attention rotates K/V
    blocks around the ring (:func:`ring_attention`), token pooling finishes
    with one sum over 'time'. ``fft_mode='pallas'`` runs the frontend on K1.

    Waveforms must satisfy ``(t_size * hop) | L`` (the center=False frame
    grid, `time_shard.py`); tokens per shard = ``L / (t_size * hop)``, and
    the ``pos`` table needs a row for each of the ``L / hop`` tokens.
    Parameters are replicated (global tensors, or DTensors placed by
    :func:`transformer_param_sharding`). Returns
    ``step(params, y, labels) -> (new_params, loss)``; the new params are
    replicated DTensors.
    """
    if hop_length is None:
        hop_length = n_fft // 4
    n_time = axis_size(mesh, TIME_AXIS)
    rep = placements(mesh, P())
    batch = placements(mesh, P(DATA_AXIS))
    ring = mesh[TIME_AXIS]

    def body(params, feats, labels):
        toks = feats.to_local()  # (B_l, F_l, n_mels): this rank's frame tokens
        lab = local_shard(labels, mesh, batch).to(toks.device)
        local = tree_map(lambda t: local_shard(t, mesh, rep), params)
        F_l = toks.shape[1]
        if local["pos"].shape[0] < F_l * n_time:
            raise ValueError(f"the pos table has {local['pos'].shape[0]} rows, fewer than "
                             f"the {F_l * n_time} frame tokens")
        # global per-sample standardization: two-pass moments (mean, then
        # squared deviations: E[x^2]-E[x]^2 cancels badly in f32 for dB
        # features), each summed over 'time'
        n_tok = F_l * n_time * toks.shape[2]
        mean = (_comm.psum(toks.sum(dim=(1, 2)), mesh, TIME_AXIS) / n_tok)[:, None, None]
        s2 = _comm.psum(((toks - mean) ** 2).sum(dim=(1, 2)), mesh, TIME_AXIS)
        std = torch.sqrt(s2 / n_tok)[:, None, None]
        toks = (toks - mean) / (std + 1e-5)
        t_idx = axis_index(mesh, TIME_AXIS)

        def loss_fn(p):
            pos = p["pos"][t_idx * F_l:(t_idx + 1) * F_l][None]
            x = _encoder_tokens(p, toks, pos, lambda q, k, v: ring_attention(q, k, v, ring))
            pooled = _comm.psum(x.sum(dim=1), mesh, TIME_AXIS) / (F_l * n_time)
            return _nll_loss(torch.matmul(pooled, p["head"]["w"]) + p["head"]["b"], lab)

        loss, grads = _local_grads(loss_fn, local)
        # the head sits after the sum over 'time', so every time rank holds
        # its whole gradient; every other leaf's parts are summed over 'time'
        for name, sub in grads.items():
            if name != "head":
                tree_map(lambda g: _comm.psum_(g, mesh, (TIME_AXIS,)), sub)
        grads = tree_map(lambda g: from_local(_comm.pmean_(g, mesh, (DATA_AXIS,)), mesh, rep),
                         grads)
        # the loss is the same on every time rank (the pools sum over 'time')
        return _comm.pmean_(loss, mesh, (DATA_AXIS,)), grads

    inner = make_sgd_step(body, lr)

    def step(params, y, labels):
        feats = logmel_time_sharded(
            y, mesh, sr=sr, n_fft=n_fft, hop_length=hop_length,
            n_mels=n_mels, center=False, fft_mode=fft_mode,
        )  # (B, F, n_mels) sharded (data, time, -)
        return inner(params, feats, labels)

    return step


def single_device_cp_oracle(
    params: dict,
    y: ArrayLike,
    labels: ArrayLike,
    sr: int = 22050,
    n_fft: int = 512,
    hop_length: int | None = None,
    n_mels: int = 64,
    lr: float = 1e-2,
):
    """The unsharded twin of :func:`make_cp_train_step` (same math on one
    device: center=False log-mel over the full frame grid -> transformer ->
    NLL -> SGD), used by the equality checks. Returns ``(new_params, loss)``
    with ``params`` a tree of tensors.

    The sharded frontend computes the FULL ``L/hop`` frame grid (trailing
    frames read zeros past the signal end: `time_shard.py` center=False
    semantics) by the frame -> window -> DFT-GEMM -> mel-GEMM chain, so the
    oracle zero-pads ``n_fft - hop`` samples and runs the SAME chain.
    """
    from ..kernels.dft import forward_basis
    from ..ops._frames import frame_signal_batched
    from ..ops.convert import power_to_db
    from ..ops.mel import mel_filterbank
    from ..ops.stft import _get_padded_window

    if hop_length is None:
        hop_length = n_fft // 4
    y = tnf.pad(dispatch.to_tensor(y, torch.float32), (0, n_fft - hop_length))
    dev = y.device
    win = _get_padded_window("hann", n_fft, n_fft, dev)
    basis = forward_basis(n_fft, device=dev)
    fb_t = mel_filterbank(sr, n_fft, n_mels=n_mels, device=dev).t()
    n_bins = n_fft // 2 + 1
    lab = dispatch.to_tensor(labels).to(dev)
    frames = frame_signal_batched(y, n_fft, hop_length) * win
    ri = torch.matmul(frames, basis)
    pow2 = ri[..., :n_bins] ** 2 + ri[..., n_bins:] ** 2
    tokens = power_to_db(torch.matmul(pow2, fb_t), top_db=None)  # (B, F, n_mels)

    loss, grads = _local_grads(lambda p: _nll_loss(transformer_logits(p, tokens), lab), params)
    with torch.no_grad():
        new_params = tree_map(lambda p_, g: p_ - lr * g, params, grads)
    return new_params, loss
