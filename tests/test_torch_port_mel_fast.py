"""PyTorch port: K1's fast entry, the bf16x3 contraction, on the CPU.

`csrc/mel_fused.cu`'s fast entry (``mel_fused_fast_kernel``) is K1 with its
filterbank contraction as the JAX kernel's fast mode computes it
(``mel_fused.py::_bf16_split``, ``_group_dot``): each operand split into
bfloat16 ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, and ``lo*hi + hi*lo +
hi*hi`` on ``mma.sync`` m16n8k16 in FP32, each 16-bin k-step from zero. A
CUDA kernel cannot run here, so this file repeats its arithmetic and maps in
NumPy (as `test_torch_port_mel_plan.py` does for the 3xTF32 entry):

- the split on the float32 bits, round to nearest even, bit for bit against
  ``torch.bfloat16`` and the JAX split;
- the power rows' bf16 layout (``put_split``, ``row_offset``): hi at bf16
  [0, M], lo at [M+4, 2M+4], bin M as a whole word with bin M+1 zero, and
  the B fragment's 8-byte loads (words 8 kk + 2q, +1) free of bank
  conflicts;
- the m16n8k16 A/B/C fragment maps with the k-step's bins permuted so that
  a thread's four are consecutive (``load_a16`` from W transposed and
  zero-padded, the B loads, the accumulator store) and the three products,
  against float64 ``P @ W`` for the 128-mel and the 12-column chroma
  weight: within 3e-5 of max, where plain TF32 is not.

Then the fast twin (``melspectrogram_plain(fast_gemm=True)``, what the
wrapper runs on a CPU tensor) against the JAX package's
``melspectrogram_pallas(fast_gemm=True)`` in interpret mode at JAX's own
limits (``rtol=1e-4, atol=1e-4*scale``), both within 3e-5 of max of float64;
``fast_gemm=None`` following ``ANALYSIS_FAST_GEMM``; the gradient under the
fast mode equal to the exact plain backward's.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_mel_plan import contract as contract_tf32
from test_torch_port_mel_plan import geometry, scale_tile, tile_plan
from test_torch_port_stft_plan import LOG_MS
from torch_port_util import signals

from mlx_audio_primitives_tpu.kernels import mel_fused as jax_k1
from mlx_audio_primitives_tpu.ops.mel import mel_filterbank as jax_mel_filterbank
from mlx_audio_primitives_tpu.ops.stft import _get_padded_window as jax_window
from mlx_audio_primitives_tpu_torch import _config as tap_config
from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
from mlx_audio_primitives_tpu_torch.ops.chroma import _chroma_filterbank_table
from mlx_audio_primitives_tpu_torch.ops.mel import filterbank_spectrogram

FAST_CLASS = 3e-5  # of max, against float64: the JAX fast mode's class (2.7e-5)


# -- the split --------------------------------------------------------------

def bf16_bits(x: np.ndarray) -> np.ndarray:
    """``__float2bfloat16_rn`` on the float32 bits: keep the top 16, round
    to nearest with ties to even (add 0x7FFF plus the kept part's lowest
    bit, then truncate)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``split_bf16x2`` / ``put_split``: hi = bf16(x), lo = bf16(x - hi)
    (x - hi is exact in float32)."""
    x = np.asarray(x, np.float32)
    hi = bf16_value(bf16_bits(x))
    return hi, bf16_value(bf16_bits(x - hi))


def test_bf16_rounding_matches_torch_and_jax():
    """Random float32 bit patterns (finite, subnormals included), values a
    tie away from two bf16 neighbours, and the largest floats, whose
    rounding carries into the exponent (to inf): the model's bits equal
    ``torch.bfloat16``'s and JAX's ``astype(bfloat16)``'s."""
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    ties = (rng.integers(0, 2**16, 5000).astype(np.uint32) << 16) | 0x8000
    big = np.array([np.finfo(np.float32).max, -np.finfo(np.float32).max, 3.3e38], np.float32)
    x = np.concatenate([u.view(np.float32), ties.view(np.float32), big])
    x = x[np.isfinite(x)]
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(bf16_bits(x), want)
    jax_bits = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    assert np.array_equal(bf16_bits(x), jax_bits)


def test_split_matches_the_twin_and_jax():
    """hi and lo of the NumPy model equal the port's ``bf16_split`` and the
    JAX ``_bf16_split`` bit for bit; hi + lo keeps x to 2^-16 of it."""
    x = np.concatenate([signals(1, (4096,)) ** 2, np.abs(signals(2, (4096,))) * 1e3])
    hi, lo = split(x)
    th, tl = k1.bf16_split(torch.from_numpy(x))
    jh, jl = jax_k1._bf16_split(jnp.asarray(x))
    for a, b in ((hi, th.numpy()), (lo, tl.numpy()), (hi, np.asarray(jh, np.float32)),
                 (lo, np.asarray(jl, np.float32))):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    err = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)
    assert err.max() <= 2.0**-16


# -- the power rows' bf16 layout ------------------------------------------

def row_offset_fast(log_m: int, f: np.ndarray) -> np.ndarray:
    """`mel_fused.cu::row_offset<LOG_M, true>`: float (word) offset of frame
    f's row of M+4 words, even, starting on bank 8f; the shift fits every
    frame buffer."""
    g = geometry(log_m)
    fsw, m = g["fsw"], g["m"]
    assert fsw - (m + 4) >= 31 and fsw % 2 == 0
    return f * fsw + ((8 * f - f * fsw) & 31)


def fast_rows(log_m: int, P: np.ndarray) -> np.ndarray:
    """The frame buffers' words (uint32) after ``write_pairs`` of the tile's
    power rows ``P`` (ft, M+1): ``r16[k] = hi``, ``r16[M+4+k] = lo`` for
    bins k < M, and bin M as whole words (``r32[M/2]``, ``r32[M+2]``) whose
    high halves, bin M+1, are zero. Everything else holds NaN bits, so a
    load outside the rows shows."""
    g = geometry(log_m)
    m, ft, fsw = g["m"], g["ft"], g["fsw"]
    words = np.full(ft * fsw, 0x7FC07FC0, np.uint32)
    for f in range(ft):
        hi, lo = split(P[f])
        h, lo_bits = bf16_bits(hi), bf16_bits(lo)
        base = row_offset_fast(log_m, f)
        r16 = words[base : base + m + 4].view(np.uint16)  # a view into the words
        r16[:m] = h[:m]
        r16[m + 4 : 2 * m + 4] = lo_bits[:m]
        words[base + m // 2] = h[m]
        words[base + m + 2] = lo_bits[m]
    return words


def unpack(word: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A 32-bit fragment register -> its (low, high) bf16 halves as floats."""
    w = np.asarray(word, np.uint32)
    return bf16_value((w & 0xFFFF).astype(np.uint16)), bf16_value((w >> 16).astype(np.uint16))


@pytest.mark.parametrize("log_m", LOG_MS)
def test_fast_rows_fit_and_hold_every_bin(log_m):
    """Each row lies inside its frame's buffer, even, and holds hi and lo of
    bins 0..M; the last k-step's B load (word M/2) reads bin M and a zero
    for bin M+1; a row is M+4 floats, about half of the 3xTF32 row's 2M+2.
    The B loads' words past the row (to M+9, masked) stay in the buffer."""
    g = geometry(log_m)
    m, ft, fsw = g["m"], g["ft"], g["fsw"]
    P = (signals(10 + log_m, (ft, m + 1)) ** 2).astype(np.float32)
    words = fast_rows(log_m, P)
    for f in range(ft):
        base = row_offset_fast(log_m, f)
        assert f * fsw <= base and base % 2 == 0 and base + m + 10 <= (f + 1) * fsw
        h0, h1 = unpack(words[base : base + m // 2 + 1])
        l0, l1 = unpack(words[base + m // 2 + 2 : base + m + 3])
        hi = np.stack([h0, h1], 1).reshape(-1)
        lo = np.stack([l0, l1], 1).reshape(-1)
        want_hi, want_lo = split(P[f])
        assert np.array_equal(hi[: m + 1], want_hi) and np.array_equal(lo[: m + 1], want_lo)
        assert hi[m + 1] == 0.0 and lo[m + 1] == 0.0
        assert hi.size == m + 2 and m + 4 <= (2 * m + 2) // 2 + 3


@pytest.mark.parametrize("log_m", LOG_MS)
def test_fast_b_fragment_loads_free_of_bank_conflicts(log_m):
    """A warp's B load reads the word pair 8 kk + 2q, +1 of frame 8j + g in
    the hi and the lo row (8 bytes a lane, served a half-warp at a time):
    with rows starting on banks 8 apart, each half-warp's 32 words hit 32
    banks for every k-step, the last included."""
    g = geometry(log_m)
    m = g["m"]
    for half in (0, 1):
        lane = np.arange(16 * half, 16 * half + 16)
        gg, q = lane >> 2, lane & 3
        for j in range(-(-g["ft"] // 8)):
            fr = 8 * j + gg
            live = fr < g["ft"]
            for kk in (0, 1, 7, m // 16):
                for extra in (0, m // 2 + 2):
                    w = row_offset_fast(log_m, fr) + extra + 8 * kk + 2 * q
                    banks = np.concatenate([w[live], w[live] + 1]) % 32
                    assert np.unique(banks).size == 2 * live.sum()


# -- the m16n8k16 contraction ------------------------------------------------

def mma16(c: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One mma.sync m16n8k16 (bf16 in, FP32 accumulate) over a warp's
    fragments (PTX's layouts), elements per lane: A[g + 8 ((i >> 1) & 1)]
    [2q + (i & 1) + 8 (i >> 2)] = a_i (i < 8, register i // 2, a_{2r} in its
    low half); B[2q + (i & 1) + 8 (i >> 1)][g] = b_i (i < 4); C[g][2q + i] =
    c_i, C[g+8][2q + i] = c_{2+i}. Products of two bf16 values are exact;
    the sum is modelled as one float64 sum rounded to float32."""
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    A = np.zeros((16, 16))
    for i in range(8):
        A[g + 8 * ((i >> 1) & 1), 2 * q + (i & 1) + 8 * (i >> 2)] = a[:, i]
    B = np.zeros((16, 8))
    for i in range(4):
        B[2 * q + (i & 1) + 8 * (i >> 1), g] = b[:, i]
    C = np.zeros((16, 8))
    C[g, 2 * q], C[g, 2 * q + 1], C[g + 8, 2 * q], C[g + 8, 2 * q + 1] = c.T
    D = (C + A @ B).astype(np.float32)
    return np.stack([D[g, 2 * q], D[g, 2 * q + 1], D[g + 8, 2 * q], D[g + 8, 2 * q + 1]], 1)


def k_bin(q: np.ndarray, j: np.ndarray) -> np.ndarray:
    """The bin (inside its k-step) of fragment column j of thread q: the
    columns 2q + h and 2q + 8 + h, h in {0, 1}, are the consecutive bins
    4q + h and 4q + 2 + h."""
    return 4 * q + 2 * (j >= 8) + (j & 1)


def contract_fast(P: np.ndarray, W: np.ndarray, n_warps: int, log_m: int | None = None
                  ) -> np.ndarray:
    """K1's fast contraction of a tile, ``(ft, n_bins) x (n_bins, n_cols)
    -> (n_cols, ft)``, through the kernel's maps and order: a warp owns an
    (m-tile, k-slice) unit and walks k-steps ks, ks + KS, ... of 16 bins;
    ``load_a16`` reads Wt (W transposed, bins zero-padded to whole k-steps)
    at column c0 + g and c0 + g + 8, bins 16 kk + 4q .. +3, one float4 a
    column (``k_bin``'s permutation), split in registers; the B registers
    are the row words 8 kk + 2q and +1 (``fast_rows`` with ``log_m``,
    n_bins = M + 1; without it, the rows' values split directly, masked
    past n_bins); per k-step and n-tile lo*hi, hi*lo, hi*hi from zero,
    added in FP32."""
    ft, n_bins = P.shape
    n_cols = W.shape[1]
    n_mt, n_ks = tile_plan(n_cols, n_warps)
    ksteps = -(-n_bins // 16)
    n_tiles = -(-ft // 8)
    Wt = np.zeros((n_cols, 16 * ksteps), np.float32)
    Wt[:, :n_bins] = W.T
    Whi, Wlo = split(Wt)
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    if log_m is not None:
        assert n_bins == (1 << log_m) + 1 and ft == geometry(log_m)["ft"]
        words = fast_rows(log_m, P)
        half = (1 << log_m) // 2
    else:
        Phi, Plo = split(P)

    def load_b(fr, w, lo_row):
        # the B register at row word w of frame fr: (low, high) = bins 2w, 2w+1
        if log_m is not None:
            ok = (w <= half) & (fr < ft)
            at = row_offset_fast(log_m, np.minimum(fr, ft - 1)) + w + (half + 2 if lo_row else 0)
            return unpack(np.where(ok, words[at], 0))
        Px = Plo if lo_row else Phi

        def at(kb):
            ok = (kb < n_bins) & (fr < ft)
            return np.where(ok, Px[np.minimum(fr, ft - 1), np.minimum(kb, n_bins - 1)], 0)
        return at(2 * w), at(2 * w + 1)

    def load_a(Wx, kk, ca):
        # a_i = A[g + 8 ((i >> 1) & 1)][j], j = 2q + (i & 1) + 8 (i >> 2):
        # Wt[ca + 8 ((i >> 1) & 1)][16 kk + k_bin(q, j)]
        cols = []
        for i in range(8):
            j = 2 * q + (i & 1) + 8 * (i >> 2)
            c = ca + 8 * ((i >> 1) & 1)
            ok = (c < n_cols) & (kk < ksteps)
            cols.append(np.where(ok, Wx[np.minimum(c, n_cols - 1),
                                        np.minimum(16 * kk + k_bin(q, j), 16 * ksteps - 1)], 0))
        return np.stack(cols, 1)

    parts = np.zeros((n_ks, n_mt * 16, n_tiles * 8), np.float32)
    for mt in range(n_mt):
        ca = 16 * mt + g
        for ks in range(n_ks):
            acc = np.zeros((n_tiles, 32, 4), np.float32)
            for kk in range(ks, ksteps, n_ks):
                a_hi, a_lo = load_a(Whi, kk, ca), load_a(Wlo, kk, ca)
                w = 8 * kk + 2 * q
                for j in range(n_tiles):
                    fr = 8 * j + g
                    b_hi = np.stack([*load_b(fr, w, False), *load_b(fr, w + 1, False)], 1)
                    b_lo = np.stack([*load_b(fr, w, True), *load_b(fr, w + 1, True)], 1)
                    d = np.zeros((32, 4), np.float32)
                    for a, b in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                        d = mma16(d, a, b)
                    acc[j] = acc[j] + d
            for j in range(n_tiles):
                for i in range(4):
                    parts[ks, 16 * mt + g + 8 * (i >> 1), 8 * j + 2 * q + (i & 1)] = acc[j, :, i]
    out = parts[0]
    for ks in range(1, n_ks):
        out = (out + parts[ks]).astype(np.float32)
    return out[:n_cols, :ft]


def test_k_step_permutation_is_a_bijection():
    """Inside a k-step, the 16 fragment columns map one to one onto the 16
    bins, the same way for A (``load_a16``) and B (the row words), and
    thread q's four bins are consecutive: one 16-byte load of Wt a column,
    one 8-byte load of a row."""
    q = np.arange(4)[:, None]
    j = np.concatenate([2 * q + h for h in (0, 1)] + [2 * q + 8 + h for h in (0, 1)], 1)
    bins = k_bin(q, j)
    assert np.array_equal(np.sort(bins.reshape(-1)), np.arange(16))
    assert np.array_equal(np.sort(bins, 1), 4 * q + np.arange(4))
    # B registers 0 and 1 (rows 2q, 2q+1 and 2q+8, 2q+9) are words 8 kk + 2q, +1
    assert np.array_equal(bins[:, :2] // 2, np.repeat(2 * q, 2, 1))
    assert np.array_equal(bins[:, 2:] // 2, np.repeat(2 * q + 1, 2, 1))


def test_fast_fragment_maps_and_slices():
    """The m16n8k16 maps, the k-slices and the partial sums reproduce an
    exact product: small integers are bf16-exact (lo = 0), so every product
    and FP32 sum is exact and an index slip shows; ragged columns (40), a
    ragged last k-step (n_bins 129: bin 128 alone in it) and a 4-frame tile
    are masked. The rows' layout is read as the kernel reads it (M = 128,
    16 frames)."""
    rng = np.random.default_rng(3)
    P = rng.integers(0, 8, (16, 129)).astype(np.float32)
    W = rng.integers(0, 8, (129, 40)).astype(np.float32)
    exact = (P.astype(np.float64) @ W).T.astype(np.float32)
    for n_warps in (4, 16, 32):
        assert np.array_equal(contract_fast(P, W, n_warps), exact)
    assert np.array_equal(contract_fast(P, W, 4, log_m=7), exact)
    got = contract_fast(P[:4], W, 16)  # a 4-frame tile (n_fft 4096): one padded n-tile
    assert np.array_equal(got, (P[:4].astype(np.float64) @ W).T.astype(np.float32))


def chroma_tile(n_frames: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`scale_tile`'s power rows with the 12-column chroma weight at
    22,050 Hz, n_fft 2048 (``chroma_stft``'s defaults), float32, and their
    float64 product."""
    P, _, _ = scale_tile(n_frames)
    W = _chroma_filterbank_table.host(22050, 2048, 12, 0.0, 5.0, 2.0, 2.0, True)
    W = np.ascontiguousarray(W.T).astype(np.float32)
    return P, W, (P.astype(np.float64) @ W.astype(np.float64)).T


@pytest.mark.parametrize("tile", [scale_tile, chroma_tile], ids=["mel128", "chroma12"])
def test_bf16x3_meets_the_fast_class_and_tf32_does_not(tile):
    """At n_fft 2048 with the 128-mel and the 12-column chroma weight (one
    16-frame tile, 32 warps, the rows read through their bf16 layout),
    bf16x3 lands within 3e-5 of max |P @ W| (float64): hi + lo keeps each
    operand to 2^-16, lo*lo is dropped (2^-18 of a product). Plain TF32
    (hi*hi only, 10-bit mantissas) does not."""
    P, W, ref = tile(16)
    got = contract_fast(P, W, 32, log_m=10).astype(np.float64)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= FAST_CLASS
    plain = contract_tf32(P, W, 32, products=1).astype(np.float64)
    assert np.abs(plain - ref).max() / np.abs(ref).max() > FAST_CLASS


def test_the_model_is_the_twin():
    """The fragment model and the fast twin (FP32 matmuls of the same
    splits) agree to float32 rounding: the same products, summed in
    another order."""
    P, W, ref = scale_tile(16)
    model = contract_fast(P, W, 32, log_m=10)
    ph, pl = k1.bf16_split(torch.from_numpy(P))
    wh, wl = k1.bf16_split(torch.from_numpy(W))
    twin = (ph @ wh + ph @ wl + pl @ wh).T.numpy()
    assert np.abs(model - twin).max() / np.abs(ref).max() <= 1e-6


# -- the wrapper on the CPU, against the JAX package ------------------------

CONFIGS = [  # (n_fft, hop, n_cols weight, power, center, signal shape)
    (1024, 256, "mel40", 2.0, True, (2, 8000)),
    (2048, 512, "mel128", 2.0, True, (2, 22050)),
    (2048, 512, "chroma12", 1.0, True, (2, 22050)),
    (512, 128, "mel40", 2.0, False, (3, 6000)),
]


def _weight(name: str, n_fft: int) -> np.ndarray:
    """``(n_bins, n_cols)`` float32 weight: a Slaney mel filterbank (JAX's
    table) or the chroma weight."""
    if name.startswith("mel"):
        return np.ascontiguousarray(np.asarray(jax_mel_filterbank(22050, n_fft, n_mels=int(name[3:]))).T)
    W = _chroma_filterbank_table.host(22050, n_fft, 12, 0.0, 5.0, 2.0, 2.0, True)
    return np.ascontiguousarray(W.T).astype(np.float32)


def _oracle(y, win, W, n_fft, hop, center, power):
    y64 = np.pad(y.astype(np.float64), ((0, 0), (n_fft // 2, n_fft // 2))) if center else y
    frames = np.lib.stride_tricks.sliding_window_view(y64, n_fft, axis=-1)[:, ::hop]
    p = np.abs(np.fft.rfft(frames * win.astype(np.float64), axis=-1)) ** power
    return (p @ W.astype(np.float64)).transpose(0, 2, 1)


@pytest.mark.parametrize("n_fft,hop,weight,power,center,shape", CONFIGS)
def test_fast_twin_matches_jax_fast_kernel(n_fft, hop, weight, power, center, shape):
    """The wrapper on CPU tensors with ``fast_gemm=True`` (the fast twin)
    against the JAX kernel with ``fast_gemm=True`` (interpret mode) at
    JAX's own limits (``test_fast_vs_exact_gemm_modes``: rtol 1e-4, atol
    1e-4 of max), and each within 3e-5 of max of float64; the exact mode
    within 1e-6 of it."""
    y = signals(n_fft + hop, shape)
    win = np.array(jax_window("hann", n_fft, n_fft))
    W = _weight(weight, n_fft)
    kw = dict(n_fft=n_fft, hop_length=hop, center=center, pad_mode="constant", power=power)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (y, win, W)]
    fast = k1.melspectrogram_fused(*t, fast_gemm=True, **kw).numpy()
    exact = k1.melspectrogram_fused(*t, fast_gemm=False, **kw).numpy()
    ref_jax = np.asarray(jax_k1.melspectrogram_pallas(jnp.asarray(y), jnp.asarray(win),
                                                      jnp.asarray(W), fast_gemm=True, **kw))
    ref = _oracle(y, win, W, n_fft, hop, center, power)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(fast, ref_jax, rtol=1e-4, atol=1e-4 * scale)
    assert np.abs(fast - ref).max() / scale <= FAST_CLASS
    assert np.abs(ref_jax - ref).max() / scale <= FAST_CLASS
    assert np.abs(exact - ref).max() / scale <= 1e-6


@pytest.mark.parametrize("mode", [True, False])
def test_fast_gemm_none_follows_the_config(mode, monkeypatch):
    """``fast_gemm=None`` reads ``_config.ANALYSIS_FAST_GEMM`` at call time
    (True by default, as in the JAX package)."""
    assert tap_config.ANALYSIS_FAST_GEMM is True
    monkeypatch.setattr(tap_config, "ANALYSIS_FAST_GEMM", mode)
    y, win, W = (torch.from_numpy(signals(5, (2, 6000))), torch.hann_window(512),
                 torch.from_numpy(_weight("mel40", 512)))
    kw = dict(n_fft=512, hop_length=128, center=True, pad_mode="constant")
    auto = k1.melspectrogram_fused(y, win, W, **kw)
    assert torch.equal(auto, k1.melspectrogram_fused(y, win, W, fast_gemm=mode, **kw))
    assert not torch.equal(auto, k1.melspectrogram_fused(y, win, W, fast_gemm=not mode, **kw))


@pytest.mark.parametrize("power", [2.0, 1.0])
def test_fast_mode_gradient_is_the_exact_backward(power):
    """Under both modes the backward differentiates the exact plain
    composition (JAX's ``bwd`` runs ``melspectrogram_xla``): the gradients
    of the signal, the window and the weight are equal bit for bit."""
    y0, W0 = signals(6, (2, 6000)), _weight("mel40", 512)
    kw = dict(n_fft=512, hop_length=128, center=True, pad_mode="reflect", power=power)
    cot = torch.from_numpy(signals(7, (2, 40, 47)))
    grads = []
    for run in (lambda *a: k1.melspectrogram_fused(*a, fast_gemm=True, **kw),
                lambda *a: k1.melspectrogram_plain(*a, **kw)):
        t = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
             for a in (y0, np.hanning(512).astype(np.float32), W0)]
        (run(*t) * cot).sum().backward()
        grads.append([x.grad for x in t])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_cpu_route_stays_exact():
    """With ``use_pallas=None`` the public ops take the exact plain
    composition on the CPU, whatever the mode (JAX's XLA route ignores
    ``fast_gemm`` the same way)."""
    y, W = signals(8, (2, 22050)), _weight("mel128", 2048)
    win = np.array(jax_window("hann", 2048, 2048))
    kw = dict(n_fft=2048, hop_length=512, center=True, pad_mode="constant", power=2.0)
    got = filterbank_spectrogram(torch.from_numpy(y), win, W.T, **kw)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (y, win, W)]
    assert torch.equal(got, k1.melspectrogram_plain(*t, **kw))
