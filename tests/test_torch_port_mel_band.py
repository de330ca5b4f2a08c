"""PyTorch port: K1's fast entry over the weight's nonzero band, on the CPU.

`csrc/mel_fused.cu`'s fast entry (``mel_fused_fast_kernel``) reads its
weight from a plan (`kernels/mel_fused.py::band_plan_host`, built once per
cached table and device; ``plan_of`` packs a full-range one from a W given
per call, for the fast entry and K1m; its layout is `csrc/k1_plan.cuh`'s):
W^T split into bf16 hi/lo in the order the A fragments load it, each
16-column m-tile's range of 16-bin k-steps outside which its columns
are zero, and the blocks before each m-tile. The warps take equal shares of
the (m-tile, k-step) blocks; a tile whose power rows hold a value that is
not finite takes every k-step. A CUDA kernel cannot run here, so this file
checks the plan and repeats the kernel's work split in NumPy:

- the ranges cover every nonzero of every cached table the public paths
  pass (mel over its parameters, the keyword spotter's, chroma, the
  centroid's moments), an all-zero m-tile keeps one k-step, a dense W
  takes every k-step, and the 128-mel table's plan is 73 of 520 blocks;
- the packed words are ``_bf16_split`` of W^T bit for bit (JAX's and the
  port's), in the A fragments' k-step permutation, and the pack kernel's
  thread map gives ``band_plan_host(band=False)`` word for word, at K1m's
  n_bins too; the layout's constants and the bf16 helpers are defined in
  `csrc/k1_plan.cuh` alone;
- the banded, balanced contraction (shares, segments, the parts held and
  stored, their sum in warp order; the parts' words, past what the
  contraction reads) covers each block once: exact on small
  integers for every warp count, within 1e-6 of max of the dense twin on
  noise, NaN in every column of a frame with a value that is not finite,
  as the twin and the JAX fast path give;
- a cached table's plan is found through its transpose view, built once
  (``cache_stats`` hits), and a copy or a slice has none.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_mel_fast import bf16_bits, bf16_value, k_bin, row_offset_fast, split
from test_torch_port_mel_plan import geometry, scale_tile
from test_torch_port_stft_plan import LOG_MS
from torch_port_util import signals

from mlx_audio_primitives_tpu.kernels import mel_fused as jax_k1
from mlx_audio_primitives_tpu.ops.stft import _get_padded_window as jax_window
from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
from mlx_audio_primitives_tpu_torch.ops.chroma import _chroma_filterbank_table, chroma_filterbank
from mlx_audio_primitives_tpu_torch.ops.features import _moments_weight
from mlx_audio_primitives_tpu_torch.ops.mel import _mel_filterbank_table, mel_filterbank
from mlx_audio_primitives_tpu_torch.utils.cache import cache_stats

torch.set_num_threads(2)

HEADER = k1.PLAN_HEADER


def decode(plan: np.ndarray) -> dict:
    """A plan's header, ranges and split W^T (natural bin order, float32)."""
    n_cols, n_mt, ksteps, blocks = (int(v) for v in plan[1:5])
    off = k1.plan_w_offset(n_mt)
    words = plan[off:].view(np.uint32).reshape(16 * n_mt, ksteps, 4, 4)
    halves = [np.stack([words[..., i] & 0xFFFF, words[..., i] >> 16], -1) for i in range(4)]
    # (column, k-step, q, pair, half) -> bin 16 kk + 4q + 2 pair + half
    hi = np.stack(halves[:2], -2).reshape(16 * n_mt, 16 * ksteps).astype(np.uint16)
    lo = np.stack(halves[2:], -2).reshape(16 * n_mt, 16 * ksteps).astype(np.uint16)
    return dict(magic=int(plan[0]), n_cols=n_cols, n_mt=n_mt, ksteps=ksteps, blocks=blocks,
                cum=plan[HEADER:HEADER + n_mt + 1].astype(np.int64),
                k0=plan[HEADER + n_mt + 1:HEADER + 2 * n_mt + 1].astype(np.int64),
                hi=bf16_value(hi), lo=bf16_value(lo), words=words)


def mel_table(*args) -> np.ndarray:
    return _mel_filterbank_table.host(*args).astype(np.float32)


MEL_TABLES = [  # (sr, n_fft, n_mels, fmin, fmax, htk, norm)
    (22050, 2048, 128, 0.0, 11025.0, False, "slaney"),
    (22050, 2048, 128, 0.0, 11025.0, True, "slaney"),
    (22050, 2048, 64, 0.0, 11025.0, False, None),
    (22050, 1024, 40, 300.0, 8000.0, False, "slaney"),
    (16000, 512, 40, 0.0, 8000.0, False, "slaney"),  # the keyword spotter's
    (44100, 4096, 256, 20.0, 20000.0, True, None),
    (8000, 256, 20, 0.0, 4000.0, False, "slaney"),
]


def tables() -> list[tuple[str, np.ndarray]]:
    out = [(f"mel{args}", mel_table(*args)) for args in MEL_TABLES]
    out.append(("chroma", _chroma_filterbank_table.host(22050, 2048, 12, 0.0, 5.0, 2.0, 2.0,
                                                        True).astype(np.float32)))
    out.append(("moments", np.ascontiguousarray(_moments_weight.host(22050, 2048).T)
                .astype(np.float32)))
    return out


# -- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("name, w_t", tables(), ids=[n for n, _ in tables()])
def test_ranges_cover_every_nonzero(name, w_t):
    """Every nonzero of W^T lies in its m-tile's range; every m-tile has at
    least one k-step; the blocks before each m-tile add up; the header
    names the plan's shape."""
    plan = decode(k1.band_plan_host(w_t))
    n_cols, n_bins = w_t.shape
    assert plan["magic"] == k1.PLAN_MAGIC and plan["n_cols"] == n_cols
    assert plan["n_mt"] == -(-n_cols // 16) and plan["ksteps"] == -(-n_bins // 16)
    widths = np.diff(plan["cum"])
    assert plan["cum"][0] == 0 and plan["blocks"] == plan["cum"][-1] and (widths >= 1).all()
    assert (plan["k0"] + widths <= plan["ksteps"]).all()
    cols, bins = np.nonzero(w_t)
    mt, kk = cols // 16, bins // 16
    assert (kk >= plan["k0"][mt]).all() and (kk < plan["k0"][mt] + widths[mt]).all()
    if name in ("chroma", "moments"):  # dense: every k-step
        assert plan["blocks"] == plan["n_mt"] * plan["ksteps"]


def test_the_scale_table_is_73_of_520_blocks():
    """The scale configuration's 128-mel Slaney table contracts 73 of its 520
    blocks (14%); the htk table 72; the keyword spotter's 18 of 51; a dense
    W all of them."""
    for args, blocks, every in ((MEL_TABLES[0], 73, 520), (MEL_TABLES[1], 72, 520),
                                (MEL_TABLES[4], 18, 51)):
        plan = decode(k1.band_plan_host(mel_table(*args)))
        assert (plan["blocks"], plan["n_mt"] * plan["ksteps"]) == (blocks, every)
    dense = decode(k1.band_plan_host(np.ones((128, 1025), np.float32)))
    assert dense["blocks"] == 520 and (dense["k0"] == 0).all()


def test_an_all_zero_m_tile_keeps_one_k_step():
    w_t = mel_table(*MEL_TABLES[3])
    w_t = np.concatenate([w_t[:16], np.zeros((16, w_t.shape[1]), np.float32), w_t[16:]])
    plan = decode(k1.band_plan_host(w_t))
    assert np.diff(plan["cum"])[1] == 1
    assert (plan["hi"][16:32] == 0).all() and (plan["lo"][16:32] == 0).all()


def test_band_off_gives_every_k_step():
    w_t = mel_table(*MEL_TABLES[0])
    full = decode(k1.band_plan_host(w_t, band=False))
    band = decode(k1.band_plan_host(w_t))
    assert full["blocks"] == 520 and (full["k0"] == 0).all()
    assert np.array_equal(full["words"], band["words"])


@pytest.mark.parametrize("name, w_t", tables()[:5] + tables()[-2:],
                         ids=[n for n, _ in tables()[:5] + tables()[-2:]])
def test_words_are_the_bf16_split_bit_for_bit(name, w_t):
    """hi and lo, decoded, equal the port's and JAX's ``_bf16_split`` of
    W^T bit for bit, zero past n_cols and n_bins; and thread q's 16-byte
    load at (column, k-step) holds its A registers: x, y the hi words of
    bins (4q, 4q+1) and (4q+2, 4q+3), z, w the lo words, the fragment
    columns 2q + h and 2q + 8 + h of ``k_bin``'s permutation."""
    plan = decode(k1.band_plan_host(w_t))
    n_cols, n_bins = w_t.shape
    th, tl = k1.bf16_split(torch.from_numpy(w_t))
    jh, jl = jax_k1._bf16_split(jnp.asarray(w_t))
    for got, want in ((plan["hi"], th.numpy()), (plan["lo"], tl.numpy()),
                      (plan["hi"], np.asarray(jh, np.float32)),
                      (plan["lo"], np.asarray(jl, np.float32))):
        assert np.array_equal(got[:n_cols, :n_bins].view(np.uint32), want.view(np.uint32))
    assert not plan["hi"][n_cols:].any() and not plan["hi"][:, n_bins:].any()
    hi_bits, lo_bits = bf16_bits(plan["hi"]), bf16_bits(plan["lo"])
    q = np.arange(4)
    for kk in (0, plan["ksteps"] // 2, plan["ksteps"] - 1):
        words = plan["words"][:, kk]  # (column, q, 4)
        for reg, (bits, j0) in enumerate(((hi_bits, 0), (hi_bits, 8), (lo_bits, 0), (lo_bits, 8))):
            b_lo = 16 * kk + k_bin(q, 2 * q + j0)
            b_hi = 16 * kk + k_bin(q, 2 * q + j0 + 1)
            assert np.array_equal(words[:, :, reg] & 0xFFFF, bits[:, b_lo])
            assert np.array_equal(words[:, :, reg] >> 16, bits[:, b_hi])


def pack_model(W: np.ndarray) -> np.ndarray:
    """``mel_fused_fast_pack_kernel``'s thread map: thread i < plan_w_offset
    writes header word i (the full ranges), thread i < 64 n_mt ksteps the
    uint4 i, ``q = i & 3``, ``kk = (i >> 2) % ksteps``, ``c = (i >> 2) //
    ksteps``, from W (n_bins, n_cols) at bins 16 kk + 4q .. +3 of column c,
    zero past n_bins or n_cols."""
    n_bins, n_cols = W.shape
    n_mt, ksteps = -(-n_cols // 16), -(-n_bins // 16)
    off = k1.plan_w_offset(n_mt)
    plan = np.zeros(off + 256 * n_mt * ksteps, np.uint32)
    i = np.arange(off)
    mt = i - HEADER
    head = np.where(mt >= 0, np.where(mt <= n_mt, mt * ksteps, 0), 0)
    head[:5] = (k1.PLAN_MAGIC, n_cols, n_mt, ksteps, n_mt * ksteps)
    plan[:off] = head
    i = np.arange(64 * n_mt * ksteps)
    q, kk, c = i & 3, (i >> 2) % ksteps, (i >> 2) // ksteps
    x = np.zeros((i.size, 4), np.float32)
    for r in range(4):
        k = 16 * kk + 4 * q + r
        ok = (k < n_bins) & (c < n_cols)
        x[:, r] = np.where(ok, W[np.minimum(k, n_bins - 1), np.minimum(c, n_cols - 1)], 0)
    hi, lo = split(x)
    h, lb = bf16_bits(hi).astype(np.uint32), bf16_bits(lo).astype(np.uint32)
    quad = np.stack([h[:, 0] | h[:, 1] << 16, h[:, 2] | h[:, 3] << 16,
                     lb[:, 0] | lb[:, 1] << 16, lb[:, 2] | lb[:, 3] << 16], 1)
    plan[off:] = quad.reshape(-1)
    return plan.view(np.int32)


@pytest.mark.parametrize("n_bins, n_cols", [(1025, 128), (257, 40), (65, 2), (129, 17), (1025, 12),
                                             (201, 128), (201, 80), (201, 12), (201, 1)])
def test_the_pack_kernel_gives_the_full_range_plan(n_bins, n_cols):
    """The one writer of a per-call plan, for the fast entry's n_bins and
    K1m's (201 at n_fft 400)."""
    W = (signals(n_bins + n_cols, (n_bins, n_cols)) ** 2).astype(np.float32)
    assert np.array_equal(pack_model(W), k1.band_plan_host(np.ascontiguousarray(W.T), band=False))


def test_the_plan_layout_has_one_home():
    """The plan's constants and the bf16 contraction's helpers are defined
    in `csrc/k1_plan.cuh` and in no other CUDA source; the Python words agree
    with its constants."""
    csrc = Path(k1.__file__).resolve().parent.parent / "csrc"
    names = ("kPlanMagic", "kPlanHeader", "plan_w_offset", "mma_bf16", "split_bf16x2")
    homes = {n: sorted(src.name for src in csrc.glob("*.cu*")
                       if re.search(rf"\b(?:int|void) {n} ?[=(]", src.read_text())) for n in names}
    assert homes == {n: ["k1_plan.cuh"] for n in names}
    text = (csrc / "k1_plan.cuh").read_text()
    assert int(re.search(r"kPlanMagic = (0x[0-9A-F]+);", text).group(1), 16) == k1.PLAN_MAGIC
    assert f"kPlanHeader = {k1.PLAN_HEADER};" in text
    for src in ("mel_fused.cu", "mel_fused_mixed.cu"):
        assert '#include "k1_plan.cuh"' in (csrc / src).read_text()


# -- the banded, balanced contraction ---------------------------------------

def band_contract(P: np.ndarray, plan_words: np.ndarray, n_warps: int) -> np.ndarray:
    """The fast entry's contraction of one tile, ``(ft, n_bins)`` power rows
    -> ``(n_cols, ft)``, in the kernel's order: the power rows split (zero
    past n_bins), the tile full-range if a hi part is not finite; warp w
    takes blocks [w tot / NW, (w + 1) tot / NW) as one segment an m-tile,
    each k-step lo*hi, then + hi*lo, then + hi*hi from zero (an mma's sum
    modelled as a float64 sum rounded to float32), added to the segment's
    sum in float32; a segment that ends its m-tile is stored (whole, or
    the last warp's part), one that goes on past the warp's share is held
    in slot w; then each shared m-tile's slots wf .. wl-1 are added in warp
    order and that sum to the last warp's part (`tail_part`)."""
    plan = decode(plan_words)
    n_cols, n_mt, ksteps = plan["n_cols"], plan["n_mt"], plan["ksteps"]
    ft, n_bins = P.shape
    Pp = np.zeros((ft, 16 * ksteps), np.float32)
    Pp[:, :n_bins] = P
    with np.errstate(invalid="ignore"):
        Phi, Plo = split(Pp)
    cum, k0, tot = plan["cum"], plan["k0"], plan["blocks"]
    if not np.isfinite(Phi).all():
        cum, k0, tot = np.arange(n_mt + 1) * ksteps, np.zeros(n_mt, np.int64), n_mt * ksteps
    hi, lo = plan["hi"].astype(np.float64), plan["lo"].astype(np.float64)
    out = np.full((16 * n_mt, ft), np.nan, np.float32)
    slots, done = {}, np.zeros(16 * ksteps * n_mt, int).reshape(n_mt, -1)
    with np.errstate(invalid="ignore", over="ignore"):
        for w in range(n_warps):
            b0, b1 = w * tot // n_warps, (w + 1) * tot // n_warps
            mt, bb = 0, b0
            while b0 < b1 and cum[mt + 1] <= b0:
                mt += 1
            while bb < b1:
                c0, c1 = cum[mt], cum[mt + 1]
                e = min(c1, b1)
                acc = np.zeros((16, ft), np.float32)
                rows = slice(16 * mt, 16 * mt + 16)
                for kk in range(k0[mt] + bb - c0, k0[mt] + e - c0):
                    done[mt, kk] += 1
                    ks = slice(16 * kk, 16 * kk + 16)
                    d = (lo[rows, ks] @ Phi[:, ks].T.astype(np.float64)).astype(np.float32)
                    d = (d + hi[rows, ks] @ Plo[:, ks].T.astype(np.float64)).astype(np.float32)
                    d = (d + hi[rows, ks] @ Phi[:, ks].T.astype(np.float64)).astype(np.float32)
                    acc = (acc + d).astype(np.float32)
                if e < c1:
                    slots[w] = acc
                else:
                    out[rows] = acc
                bb, mt = e, mt + 1
        for mt in range(n_mt):
            c0, c1 = cum[mt], cum[mt + 1]
            wf, wl = ((c0 + 1) * n_warps - 1) // tot, (c1 * n_warps - 1) // tot
            if wf == wl:
                continue
            s = slots.pop(wf)
            for w in range(wf + 1, wl):
                if w * tot // n_warps < (w + 1) * tot // n_warps:
                    s = (s + slots.pop(w)).astype(np.float32)
            rows = slice(16 * mt, 16 * mt + 16)
            out[rows] = (out[rows] + s).astype(np.float32)
    assert not slots, "a held part was not added"
    width = np.diff(cum)
    for mt in range(n_mt):  # each block of the range once, none outside it
        assert (done[mt, k0[mt]:k0[mt] + width[mt]] == 1).all() and done[mt].sum() == width[mt]
    return out[:n_cols]


def part_words(log_m: int) -> tuple[np.ndarray, np.ndarray]:
    """`mel_fused.cu::part_word`: the shared words of every (slot, column,
    frame) of the parts stored at once (past the rows, in the frame
    buffers' tails) and of those held to the end of the contraction (at
    the buffers' starts), NW slots each, column cl in buffer cl mod FT."""
    g = geometry(log_m)
    m, ft, nw, fsw = g["m"], g["ft"], g["nw"], g["fsw"]
    fp = 8 * -(-ft // 8)
    s, cl, fl = np.meshgrid(np.arange(nw), np.arange(16), np.arange(fp), indexing="ij")
    at = (cl % ft) * fsw + ((cl // ft) * nw + s) * fp + fl
    return (at + m + 40).reshape(-1), at.reshape(-1)


@pytest.mark.parametrize("log_m", LOG_MS)
def test_parts_lie_where_the_contraction_reads_nothing(log_m):
    """The tail slots are distinct words inside their frame buffers, past
    every word a row's B loads reach (its shift, then M + 10 words), so a
    warp writes its part while the others still read the rows; the held
    slots are distinct, apart from the tail slots, and inside the frame
    buffers, which they take over after the contraction's barrier. The
    reduction's 32 lanes (16 columns by 2 frames of a slot) hit 32 banks
    where a tile has 16 frames."""
    g = geometry(log_m)
    m, ft, fsw = g["m"], g["ft"], g["fsw"]
    tail, held = part_words(log_m)
    assert np.unique(tail).size == tail.size and np.unique(held).size == held.size
    assert not set(tail) & set(held)
    for words in (tail, held):
        assert (words // fsw < ft).all()
    buf, at = tail // fsw, tail % fsw
    reach = row_offset_fast(log_m, buf) - buf * fsw + m + 10
    assert (at >= reach).all() and (at < fsw).all()
    if ft == 16:
        cl, fl = np.arange(32) % 16, np.arange(32) // 16
        assert np.unique((cl * fsw + fl) % 32).size == 32


def banded_ints(n_bins: int, n_cols: int, seed: int) -> np.ndarray:
    """A small-integer W (n_bins, n_cols), each column nonzero on a band of
    bins (bf16-exact: lo = 0), some columns empty."""
    rng = np.random.default_rng(seed)
    W = np.zeros((n_bins, n_cols), np.float32)
    for c in range(n_cols):
        if c % 7 == 3:
            continue
        a, width = int(rng.integers(0, n_bins)), int(rng.integers(1, 40))
        seg = W[a:a + width, c]
        seg[:] = rng.integers(1, 8, seg.size)
    return W


@pytest.mark.parametrize("n_warps", [1, 2, 3, 8, 16, 32, 64])
@pytest.mark.parametrize("n_bins, n_cols", [(129, 40), (257, 128), (1025, 12), (65, 2), (513, 200)])
def test_band_contract_covers_each_block_once(n_bins, n_cols, n_warps):
    """Small integers: every product and float32 sum is exact, so a block
    missed, counted twice or a part left out shows as a difference, for
    shares that cut m-tiles anywhere (more warps than blocks included)."""
    rng = np.random.default_rng(n_bins + n_cols)
    P = rng.integers(0, 8, (8, n_bins)).astype(np.float32)
    W = banded_ints(n_bins, n_cols, n_warps)
    exact = (P.astype(np.float64) @ W).T.astype(np.float32)
    plan = k1.band_plan_host(np.ascontiguousarray(W.T))
    assert np.array_equal(band_contract(P, plan, n_warps), exact)
    assert np.array_equal(band_contract(P, k1.band_plan_host(np.ascontiguousarray(W.T), band=False),
                                       n_warps), exact)


@pytest.mark.parametrize("n_warps", [16, 32])
def test_band_contract_matches_the_dense_twin(n_warps):
    """At the scale configuration's widths (8 frames of noise, 1,025 bins x
    128 mels) the banded, balanced contraction is within 1e-6 of max of the
    fast twin's dense FP32 products of the same splits."""
    P, W, ref = scale_tile(8)
    got = band_contract(P, k1.band_plan_host(np.ascontiguousarray(W.T)), n_warps)
    ph, pl = k1.bf16_split(torch.from_numpy(P))
    wh, wl = k1.bf16_split(torch.from_numpy(W))
    twin = (ph @ wh + ph @ wl + pl @ wh).T.numpy()
    assert np.abs(got - twin).max() / np.abs(ref).max() <= 1e-6


def test_a_frame_that_is_not_finite_is_nan_in_every_column():
    """A power row with an inf (its lo is NaN): the tile takes every k-step,
    so that frame is NaN in every column, as in the twin's dense product;
    the other frames stay finite and within 1e-6 of the twin."""
    P, W, ref = scale_tile(8)
    P = P.copy()
    P[2, 700] = np.inf
    got = band_contract(P, k1.band_plan_host(np.ascontiguousarray(W.T)), 16)
    with np.errstate(invalid="ignore"):
        ph, pl = k1.bf16_split(torch.from_numpy(P))
        wh, wl = k1.bf16_split(torch.from_numpy(W))
        twin = (ph @ wh + ph @ wl + pl @ wh).T.numpy()
    assert np.isnan(got[:, 2]).all() and np.isnan(twin[:, 2]).all()
    keep = np.arange(8) != 2
    assert np.isfinite(got[:, keep]).all()
    assert np.abs(got[:, keep] - twin[:, keep]).max() / np.abs(ref).max() <= 1e-6


def test_inf_sample_gives_nan_columns_in_twin_and_jax():
    """A clip with an inf sample: the fast twin (the wrapper on a CPU
    tensor) and the JAX fast path (interpret mode) give NaN in every column
    of each frame the sample reaches, and agree elsewhere at JAX's limits."""
    n_fft, hop = 512, 128
    y = signals(31, (2, 6000))
    y[1, 3000] = np.inf
    win = np.array(jax_window("hann", n_fft, n_fft))
    W = np.ascontiguousarray(mel_table(16000, n_fft, 40, 0.0, 8000.0, False, "slaney").T)
    kw = dict(n_fft=n_fft, hop_length=hop, center=True, pad_mode="constant", power=2.0)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (y, win, W)]
    port = k1.melspectrogram_fused(*t, fast_gemm=True, **kw).numpy()
    ref = np.asarray(jax_k1.melspectrogram_pallas(jnp.asarray(y), jnp.asarray(win), jnp.asarray(W),
                                                  fast_gemm=True, **kw))
    frames = np.isnan(ref[1]).any(0)
    assert 1 <= frames.sum() <= n_fft // hop + 1
    for out in (port, ref):
        assert np.isnan(out[1][:, frames]).all() and np.isfinite(out[1][:, ~frames]).all()
        assert np.isfinite(out[0]).all()
    scale = np.abs(ref[0]).max()
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-4, atol=1e-4 * scale)


# -- the plan's cache ---------------------------------------------------------

def test_a_cached_tables_plan_is_built_once():
    """The 128-mel table's plan is found through its transpose view (how the
    ops pass it) and the chroma and moments tables' as they are passed; a
    second lookup hits the plan cache; a copy and a slice have no plan
    (``plan_of`` packs theirs), and ``plan_of`` hands out the cached plan
    with its blocks."""
    fb = mel_filterbank(22050, 2048, 128, device="cpu")
    before = cache_stats()["k1_band_plan"]
    plan, host = k1.fast_plan(fb.t())
    again, _ = k1.fast_plan(fb.t())
    after = cache_stats()["k1_band_plan"]
    assert again is plan and after["hits"] >= before["hits"] + 1
    assert plan.dtype == torch.int32 and np.array_equal(plan.numpy(), host)
    assert np.array_equal(host, k1.band_plan_host(fb.numpy()))
    assert k1.contracted_blocks(fb.t()) == (73, 520)
    got, blocks = k1.plan_of(fb.t())
    assert got is plan and blocks == 73
    assert k1.fast_plan(fb.t().contiguous()) is None and k1.fast_plan(fb.t()[:, :64]) is None
    assert k1.contracted_blocks(fb.t().contiguous()) == (520, 520)
    chroma = chroma_filterbank(22050, 2048, device="cpu")
    assert k1.contracted_blocks(chroma.t()) == (65, 65)
    moments = _moments_weight(22050, 2048, device="cpu")
    _, host = k1.fast_plan(moments)
    assert np.array_equal(host, k1.band_plan_host(moments.numpy().T))
