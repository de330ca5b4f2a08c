"""PyTorch port: a NumPy model of K1's power rows and 3xTF32 contraction.

`csrc/mel_fused.cu` (K1) runs the register-resident FFT front end of K2
(modelled in `test_torch_port_stft_plan.py`), then writes each frame's power
row over the frame's own spectrum and contracts the rows with W on the
tensor cores. A CUDA kernel cannot run here, so this file repeats its
integer maps and its arithmetic in NumPy:

- the in-place power rows, in rounds of a few of the tile's frames: which
  shared-memory words each thread reads (``power_pairs``) and writes
  (``write_pairs``, ``row_offset``), its private scratch slots in the
  segment buffer, that every bin 0..M is written once inside the frame's
  own buffer, that the writes land on words other threads read (so the
  barrier between the two is needed), that no round reads what an earlier
  one wrote, and that the rows equal ``|rfft|^p``;
- the 3xTF32 contraction: TF32 ``rna`` rounding on the float32 bits, the
  hi/lo split, the mma.sync m16n8k8 fragment maps (``load_a``, the B loads,
  the accumulator store), the warps' k-slices and their partial sums, and
  FP32 accumulation, against a float64 ``P @ W``;
- the column tiling: ``ceil(n_cols / 16)`` m-tiles, the k-slices that fill
  the warps, and the bank-conflict-free B fragment loads.
"""

from __future__ import annotations

import numpy as np
import pytest
from test_torch_port_stft_plan import (
    LOG_MS, MAX_THREADS, REG_BITS, model_passes, rdigit_rev, rframe_stride, rpidx,
)
from torch_port_util import signals

from mlx_audio_primitives_tpu_torch.ops.mel import _mel_filterbank_table
from mlx_audio_primitives_tpu_torch.ops.windows import window_host

ROUNDS = 4  # mel_fused.cu: kRounds


def geometry(log_m: int) -> dict:
    """`fft_common.cuh::Geometry`: threads per frame, frames per tile,
    threads and warps per block, floats per frame buffer."""
    m = 1 << log_m
    t = m >> REG_BITS
    max_nt = MAX_THREADS // 2 if log_m >= 11 else MAX_THREADS
    ft = min(16, max_nt // t)
    return dict(m=m, t=t, ft=ft, nt=ft * t, nw=ft * t // 32, fsw=2 * rframe_stride(m))


def row_offset(log_m: int, f: np.ndarray) -> np.ndarray:
    """`mel_fused.cu::row_offset`: float offset of frame f's power row."""
    g = geometry(log_m)
    fsw, m = g["fsw"], g["m"]
    if fsw - 2 * (m + 1) >= 31:
        return f * fsw + ((4 * f - f * fsw) & 31)
    return f * fsw


def tile_plan(n_cols: int, n_warps: int) -> tuple[int, int]:
    """The m-tiles of 16 columns and the k-slices per m-tile."""
    n_mt = -(-n_cols // 16)
    return n_mt, max(1, n_warps // n_mt)


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` on the float32 bits: keep 10 mantissa bits,
    round to nearest with ties away from zero (sign and magnitude are apart
    in the bits, so adding half of the dropped range and truncating does
    it)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = tf32_rna(x)
    return hi, tf32_rna((x - hi).astype(np.float32))


def power_plan(log_m: int) -> dict:
    """`mel_fused.cu`'s power-row rounds: R rounds of FR frames, TP threads
    per frame, bin pairs J = 0 .. M/(2 TP), scratch slots per thread."""
    g = geometry(log_m)
    rounds = min(ROUNDS, g["ft"])
    fr_count = g["ft"] // rounds
    tp = g["nt"] // fr_count
    return dict(rounds=rounds, fr=fr_count, tp=tp, pairs=g["m"] // 2 // tp + 1,
                slots=2 * (g["m"] // 2 // tp) + 1)


def power_rows(log_m: int, frames: np.ndarray, win: np.ndarray, power: int):
    """K1's power rows of one tile, through the kernel's maps: R rounds
    (``power_round``) of FR frames, each a read phase (``power_pairs``) that
    puts every value in the thread's own scratch slot at once, a barrier,
    and a write phase (``write_pairs``) from the scratch into the rows.
    Returns the shared words after the writes and, per round and thread,
    the words it read and wrote, its scratch slots and its frame."""
    g = geometry(log_m)
    m, ft, nt, fsw = g["m"], g["ft"], g["nt"], g["fsw"]
    plan = power_plan(log_m)
    fr_count, tp = plan["fr"], plan["tp"]
    buf, tw = model_passes(frames, win)
    words = np.zeros(ft * fsw, np.float32)
    words.reshape(ft, fsw)[:, : 2 * buf.shape[1]] = buf.view(np.float32)
    scratch = np.full(plan["slots"] * nt, np.nan, np.float32)
    tid = np.arange(nt)
    k0 = tid // fr_count
    lo1 = rdigit_rev(log_m, k0)
    lo2 = np.where(k0 > 0, rdigit_rev(log_m, tp - k0), 0)
    half = np.float32(0.5)
    rounds = []
    for r in range(plan["rounds"]):
        f = r * fr_count + (tid & (fr_count - 1))
        reads, writes, slots = [[] for _ in tid], [[] for _ in tid], [[] for _ in tid]
        for j in range(plan["pairs"]):
            k = k0 + j * tp
            live = k <= m // 2
            h1 = rdigit_rev(log_m, np.array(j * tp))
            h2_0 = rdigit_rev(log_m, np.array((m - j * tp) & (m - 1)))
            h2 = rdigit_rev(log_m, np.array((m - (j + 1) * tp) & (m - 1)))
            pa = f * fsw + 2 * rpidx(lo1 + h1)
            pc = f * fsw + 2 * rpidx(lo2 + np.where(k0 > 0, h2, h2_0))
            a = words[pa] + np.complex64(1j) * words[pa + 1]
            c = words[pc] + np.complex64(1j) * words[pc + 1]
            er, ei = half * (a.real + c.real), half * (a.imag - c.imag)
            dr, di = half * (a.real - c.real), half * (a.imag + c.imag)
            o = tw[np.minimum(k, m)] * (di - np.complex64(1j) * dr)
            pk = (er + o.real) ** 2 + (ei + o.imag) ** 2
            pmk = (er - o.real) ** 2 + (o.imag - ei) ** 2
            if power == 1:
                pk, pmk = np.sqrt(pk), np.sqrt(pmk)
            for i in np.flatnonzero(live):
                reads[i] += [pa[i], pa[i] + 1, pc[i], pc[i] + 1]
                scratch[2 * j * nt + i] = pk[i]
                slots[i].append(2 * j * nt + i)
                if j * tp < m // 2:
                    scratch[(2 * j + 1) * nt + i] = pmk[i]
                    slots[i].append((2 * j + 1) * nt + i)
        # the round's barrier, then its writes from the scratch
        for i in tid:
            for j in range(plan["pairs"]):
                k = k0[i] + j * tp
                if k > m // 2:
                    continue
                bins = [(k, 2 * j)] + ([(m - k, 2 * j + 1)] if j * tp < m // 2 else [])
                for kb, slot in bins:
                    p = scratch[slot * nt + i]
                    hi = tf32_rna(np.float32(p))
                    lo = tf32_rna(np.float32(p) - hi)
                    at = row_offset(log_m, f[i]) + kb
                    words[at], words[at + m + 1] = hi, lo
                    writes[i] += [at, at + m + 1]
        rounds.append((reads, writes, slots, f))
    return words, rounds


@pytest.mark.parametrize("power", [2, 1])
@pytest.mark.parametrize("log_m", LOG_MS)
def test_power_rows_in_place(log_m, power):
    """In each round, each bin 0..M of the round's frames is written once
    (hi and lo) inside the frame's own buffer, and every word a thread reads
    lies in its frame's buffer; some writes land on words that other threads
    of the round read, so the reads must end at a barrier before the first
    write, as in the kernel; a round reads no word that an earlier round
    wrote, so it needs no barrier before its reads; a thread's scratch slots
    are its own and fit in the segment buffer at the least hop the radix
    gate admits. The rows (hi + lo) equal ``|rfft(window * frame)|^p`` to
    1e-5 of max (a float32 FFT, ~1e-6; the split is exact to ~2^-22)."""
    g = geometry(log_m)
    m, ft, nt, fsw = g["m"], g["ft"], g["nt"], g["fsw"]
    plan = power_plan(log_m)
    hop_min = max(128, m // 4)
    assert plan["slots"] * nt <= (ft - 1) * hop_min + 2 * m
    n_fft = 2 * m
    frames = signals(80 + log_m, (ft, n_fft))
    win = window_host("hann", n_fft).astype(np.float32)
    words, rounds = power_rows(log_m, frames, win, power)
    written = set()
    for reads, writes, slots, f in rounds:
        all_slots = [s for ss in slots for s in ss]
        assert len(all_slots) == len(set(all_slots)) and max(all_slots) < plan["slots"] * nt
        assert all(s % nt == i for i, ss in enumerate(slots) for s in ss)
        read_by = {}
        for i, rs in enumerate(reads):
            assert all(f[i] * fsw <= w < (f[i] + 1) * fsw for w in rs)
            assert not written & set(rs)
            for w in rs:
                read_by.setdefault(w, set()).add(i)
        for fr in np.unique(f):
            ws = np.concatenate([writes[i] for i in np.flatnonzero(f == fr)]).astype(int)
            base = row_offset(log_m, fr)
            assert np.array_equal(np.sort(ws), base + np.arange(2 * (m + 1)))
            assert base >= fr * fsw and base + 2 * (m + 1) <= (fr + 1) * fsw
        clobbers = sum(bool(read_by.get(w, set()) - {i}) for i, ws in enumerate(writes) for w in ws)
        assert clobbers > 0
        written |= {w for ws in writes for w in ws}
    assert sorted(np.unique(np.concatenate([f for *_, f in rounds]))) == list(range(ft))
    rows = np.stack([words[row_offset(log_m, fr) + np.arange(2 * (m + 1))] for fr in range(ft)])
    hi, lo = rows[:, : m + 1], rows[:, m + 1 :]
    assert np.array_equal(tf32_rna(hi), hi) and np.array_equal(tf32_rna(lo), lo)
    ref = np.abs(np.fft.rfft(win.astype(np.float64) * frames.astype(np.float64), axis=-1))
    ref = ref**power
    got = hi.astype(np.float64) + lo.astype(np.float64)
    assert np.abs(got - ref).max() / ref.max() <= 1e-5


def contract(P: np.ndarray, W: np.ndarray, n_warps: int, products: int = 3) -> np.ndarray:
    """K1's contraction of a tile, ``(ft, n_bins) x (n_bins, n_cols) ->
    (n_cols, ft)``, through the kernel's fragment maps and order. A warp
    owns an (m-tile, k-slice) unit and walks k-steps ks, ks + KS, ... of 8
    bins; per k-step and n-tile of 8 frames it runs lo*hi, hi*lo, hi*hi
    (``products`` 1: hi*hi only, plain TF32) from a zero accumulator and
    adds the result to the warp's sum in FP32. An mma adds 8 exact TF32 x
    TF32 products to its FP32 accumulator, modelled as one float64 sum
    rounded to nearest float32 (the card's tensor cores truncate instead,
    which is why each k-step starts from zero: the truncation then costs a
    fraction of an ulp of the k-step's sum, not of the running total). The
    k-slices' partial sums add in slice order in float32."""
    ft, n_bins = P.shape
    n_cols = W.shape[1]
    n_mt, n_ks = tile_plan(n_cols, n_warps)
    ksteps = -(-n_bins // 8)
    n_tiles = -(-ft // 8)
    Whi, Wlo = split(W)
    Phi, Plo = split(P)
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    parts = np.zeros((n_ks, n_mt * 16, n_tiles * 8), np.float32)
    for mt in range(n_mt):
        ca = 16 * mt + g
        for ks in range(n_ks):
            acc = np.zeros((n_tiles, 32, 4), np.float32)
            for kk in range(ks, ksteps, n_ks):
                k = 8 * kk + q

                def load_a(Wx):
                    # mel_fused.cu::load_a; zero past n_bins or n_cols
                    def at(kr, c):
                        ok = (kr < n_bins) & (c < n_cols)
                        return np.where(ok, Wx[np.minimum(kr, n_bins - 1), np.minimum(c, n_cols - 1)], 0)
                    return np.stack([at(k, ca), at(k, ca + 8), at(k + 4, ca), at(k + 4, ca + 8)], 1)

                a_hi, a_lo = load_a(Whi), load_a(Wlo)
                for j in range(n_tiles):
                    fr = 8 * j + g

                    def load_b(Px):
                        def at(kr):
                            ok = (kr < n_bins) & (fr < ft)
                            return np.where(ok, Px[np.minimum(fr, ft - 1), np.minimum(kr, n_bins - 1)], 0)
                        return np.stack([at(k), at(k + 4)], 1)

                    b_hi, b_lo = load_b(Phi), load_b(Plo)
                    pairs = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][3 - products:]
                    d = np.zeros((32, 4), np.float32)
                    for a, b in pairs:
                        d = mma(d, a, b)
                    acc[j] = acc[j] + d
            # the accumulators' rows and columns: c_i at column g + 8*(i >> 1)
            # of the m-tile, frame 2q + (i & 1) of the n-tile
            for j in range(n_tiles):
                for i in range(4):
                    parts[ks, 16 * mt + g + 8 * (i >> 1), 8 * j + 2 * q + (i & 1)] = acc[j, :, i]
    out = parts[0]
    for ks in range(1, n_ks):
        out = (out + parts[ks]).astype(np.float32)
    return out[:n_cols, :ft]


def mma(c: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One mma.sync m16n8k8 TF32 over a warp's fragments (PTX's layouts):
    A[g][q] = a0, A[g+8][q] = a1, A[g][q+4] = a2, A[g+8][q+4] = a3;
    B[q][g] = b0, B[q+4][g] = b1; C[g][2q+i] = c_i, C[g+8][2q+i] = c_{2+i}."""
    lane = np.arange(32)
    g, q = lane >> 2, lane & 3
    A = np.zeros((16, 8))
    A[g, q], A[g + 8, q], A[g, q + 4], A[g + 8, q + 4] = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    B = np.zeros((8, 8))
    B[q, g], B[q + 4, g] = b[:, 0], b[:, 1]
    C = np.zeros((16, 8))
    C[g, 2 * q], C[g, 2 * q + 1], C[g + 8, 2 * q], C[g + 8, 2 * q + 1] = c.T
    D = (C + A @ B).astype(np.float32)
    return np.stack([D[g, 2 * q], D[g, 2 * q + 1], D[g + 8, 2 * q], D[g + 8, 2 * q + 1]], 1)


def scale_tile(n_frames: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Power rows of ``n_frames`` frames of noise (n_fft 2048, Hann, float32)
    and the scale configuration's weight, the 128-band Slaney mel
    filterbank at 22,050 Hz, as ``(n_bins, 128)`` float32; and their float64
    product."""
    frames = signals(7, (n_frames, 2048)).astype(np.float64)
    win = window_host("hann", 2048)
    P = (np.abs(np.fft.rfft(win * frames, axis=-1)) ** 2).astype(np.float32)
    W = _mel_filterbank_table.host(22050, 2048, 128, 0.0, 11025.0, False, "slaney")
    W = np.ascontiguousarray(W.T).astype(np.float32)
    return P, W, (P.astype(np.float64) @ W.astype(np.float64)).T


def test_fragment_maps_and_slices():
    """The fragment maps, the k-slices and the partial sums reproduce an
    exact product: on small integers every TF32 product and FP32 sum is
    exact, so any index slip shows as a difference; ragged columns (40) and
    a ragged last k-step (n_bins 129) are masked."""
    rng = np.random.default_rng(3)
    P = rng.integers(0, 8, (16, 129)).astype(np.float32)
    W = rng.integers(0, 8, (129, 40)).astype(np.float32)
    for n_warps in (2, 16, 32):
        got = contract(P, W, n_warps)
        assert np.array_equal(got, (P.astype(np.float64) @ W).T.astype(np.float32))
    got = contract(P[:4], W, 16)  # a 4-frame tile (n_fft 4096): one padded n-tile
    assert np.array_equal(got, (P[:4].astype(np.float64) @ W).T.astype(np.float32))


def test_3xtf32_meets_fp32_limit_and_tf32_does_not():
    """At the scale configuration's widths (1,025 bins x 128 mels, one
    16-frame tile, 32 warps) 3xTF32 stays within 5e-7 of max |P @ W|
    (float64) and within 1e-6 of each output: it drops lo*lo and rounds lo,
    each at most 2^-22 of a product, and every term is positive, so nothing
    cancels and the sum's error is at most ~2^-21 (4.8e-7) of it, plus the
    FP32 accumulation's few 2^-24. Plain TF32 (hi*hi, 10-bit mantissas,
    up to 2^-11 per operand) misses the 1e-5 limit that K1 is held to on the
    card, which is why three products are needed."""
    P, W, ref = scale_tile(16)
    got = contract(P, W, 32).astype(np.float64)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 5e-7
    assert (np.abs(got - ref) / np.abs(ref)).max() <= 1e-6
    plain = contract(P, W, 32, products=1).astype(np.float64)
    assert np.abs(plain - ref).max() / np.abs(ref).max() > 1e-5


@pytest.mark.parametrize("n_cols, n_mt", [(1, 1), (2, 1), (16, 1), (17, 2), (128, 8), (129, 9)])
@pytest.mark.parametrize("log_m", LOG_MS)
def test_column_tiles(log_m, n_cols, n_mt):
    """The contraction walks ceil(n_cols / 16) m-tiles, so its tensor-core
    work follows the columns (a 2-column weight costs one m-tile of 8 at 128
    columns); the k-slices fill the warps without exceeding them, each
    m-tile's k-steps are covered once, and the partial sums fit in the frame
    buffers they reuse."""
    g = geometry(log_m)
    got_mt, n_ks = tile_plan(n_cols, g["nw"])
    assert got_mt == n_mt
    ksteps = -(-(g["m"] + 1) // 8)
    covered = np.sort(np.concatenate([np.arange(ks, ksteps, n_ks) for ks in range(n_ks)]))
    assert np.array_equal(covered, np.arange(ksteps))
    if n_ks > 1:
        assert n_mt * n_ks <= g["nw"]
        assert n_mt * n_ks * 256 <= g["ft"] * g["fsw"]
    n_tiles = -(-g["ft"] // 8)
    mmas = 3 * n_mt * ksteps * n_tiles
    assert mmas == 3 * -(-n_cols // 16) * ksteps * n_tiles


@pytest.mark.parametrize("log_m", [lm for lm in LOG_MS if lm >= 8])
def test_b_fragment_loads_free_of_bank_conflicts(log_m):
    """A warp's B fragment load reads bin k0 + q of frame 8j + g: with rows
    shifted to start on banks 4 apart, its 32 words hit 32 banks (hi and lo
    rows alike) for every k-step."""
    g = geometry(log_m)
    lane = np.arange(32)
    gg, q = lane >> 2, lane & 3
    for j in range(-(-g["ft"] // 8)):
        fr = 8 * j + gg
        live = fr < g["ft"]
        for k0 in (0, 4, 8 * 37, 8 * 37 + 4):
            for extra in (0, g["m"] + 1):
                banks = (row_offset(log_m, fr) + extra + k0 + q)[live] % 32
                assert np.unique(banks).size == live.sum()
