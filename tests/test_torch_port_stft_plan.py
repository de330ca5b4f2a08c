"""PyTorch port: a NumPy model of K2's register-resident FFT plan.

`csrc/stft.cu` (K2, K2m) runs the complex FFT of M = n_fft/2 packed points
as in-place decimation-in-frequency passes (`csrc/fft_common.cuh`, the
register-resident front end). A CUDA kernel cannot run here, so this file
repeats its integer index maps in NumPy: the pass plan (`plan_bits`), each
thread's butterfly positions (`rpass_pos`), the twiddle exponents and the
half-circle sign rule (`w_m_from_host`), the padded frame layout (`rpidx`), the
in-register radix network (`dft_regs`), the order of the exchanges, and
the emit's digit-reversed read (`rdigit_rev`) with the real-input split.
The model runs in complex64, as the kernel runs in FP32, and is held
against ``numpy.fft.rfft`` of the windowed frames in float64 for every
log2(M) from 6 to 12, every size the radix gate admits (n_fft 128-8192).

Tolerance: 1e-5 of max |X|. A float32 FFT of N points rounds at each of
its log2(N) stages, ~6e-8 of max each, so ~1e-6 at N = 8192 in the worst
case; an index or twiddle bug gives errors of order 1.
"""

from __future__ import annotations

import numpy as np
import pytest
from torch_port_util import signals

from mlx_audio_primitives_tpu_torch.kernels.dft import rfft_twiddles
from mlx_audio_primitives_tpu_torch.ops.windows import window_host

REG_BITS = 4  # fft_common.cuh: kRegBits
REG_POINTS = 1 << REG_BITS
MAX_THREADS = 1024  # stft.cu: kMaxThreads
SMEM_LIMIT = 227 * 1024  # stft.cu: kSmemLimit
LOG_MS = range(6, 13)


def plan_passes(log_m: int) -> int:
    return -(-log_m // REG_BITS)


def plan_bits(log_m: int, p: int) -> int:
    n = plan_passes(log_m)
    return log_m // n + (1 if p >= n - log_m % n else 0)


def plan_shift(log_m: int, p: int) -> int:
    return sum(plan_bits(log_m, q) for q in range(p + 1))


def brev_bits(x: np.ndarray, bits: int) -> np.ndarray:
    r = np.zeros_like(x)
    for i in range(bits):
        r |= ((x >> i) & 1) << (bits - 1 - i)
    return r


def rpidx(p: np.ndarray) -> np.ndarray:
    return p + (p >> 4)


def rframe_stride(m: int) -> int:
    return m + (m >> 4) + 1


def rpass_pos(log_m: int, p: int) -> np.ndarray:
    """Positions ``(T, C, R)`` that thread t's butterfly c reads and writes
    in pass p: butterfly u = t + c*T, block u >> log S, offset u & (S-1)."""
    log_s = log_m - plan_shift(log_m, p)
    b = plan_bits(log_m, p)
    t_count = (1 << log_m) >> REG_BITS
    t = np.arange(t_count)[:, None, None]
    c = np.arange(REG_POINTS >> b)[None, :, None]
    r = np.arange(1 << b)[None, None, :]
    u = t + c * t_count
    return ((u >> log_s) << (log_s + b)) + (u & ((1 << log_s) - 1)) + (r << log_s)


W16 = np.exp(-2j * np.pi * np.arange(8) / 16).astype(np.complex64)


def dft_regs(v: np.ndarray, b: int) -> np.ndarray:
    """The in-register radix-2 DIF network over the last axis (2^b points),
    then the bit-reversal that the kernel does by register renaming."""
    v = v.copy()
    r_count = 1 << b
    for st in range(b):
        h = r_count >> (st + 1)
        for x in range(r_count // 2):
            j = x & (h - 1)
            lo = 2 * (x - j) + j
            a, c = v[..., lo].copy(), v[..., lo + h].copy()
            d = a - c
            e = j * (8 >> (b - 1 - st))
            v[..., lo] = a + c
            v[..., lo + h] = d if e == 0 else (d * np.complex64(-1j) if e == 4 else d * W16[e])
    return v[..., brev_bits(np.arange(r_count), b)]


def w_m_from_host(tw: np.ndarray, j: np.ndarray, m: int) -> np.ndarray:
    """W_M^j from the table tw[e] = W_N^e (e <= M): W_N^{2j}, negated past
    the half circle; the kernel stages these for j < M."""
    e = 2 * j
    return np.where(e <= m, tw[np.minimum(e, m)], -tw[np.clip(e - m, 0, m)])


def rdigit_rev(log_m: int, k: np.ndarray) -> np.ndarray:
    p = np.zeros_like(k)
    for j in range(plan_passes(log_m)):
        b = plan_bits(log_m, j)
        p += (k & ((1 << b) - 1)) << (log_m - plan_shift(log_m, j))
        k = k >> b
    return p


def model_passes(frames: np.ndarray, win: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The frame buffers after the last pass, ``(nf, rframe_stride(M))``
    complex64 in the kernels' padded layout (digit-reversed order), and the
    float32 host twiddles ``tw[k] = W_N^k``, k <= M, of ``(nf, N)`` float32
    frames and window ``(N,)``: the passes of K1 and K2 in their order."""
    nf, n_fft = frames.shape
    m = n_fft // 2
    log_m = m.bit_length() - 1
    t_count = m >> REG_BITS
    t6 = rfft_twiddles.host(n_fft)
    tw = (t6[:, 0].astype(np.float32) + 1j * t6[:, 1].astype(np.float32)).astype(np.complex64)
    xw = (win[None, :] * frames).astype(np.float32)
    z = (xw[:, 0::2] + np.complex64(1j) * xw[:, 1::2]).astype(np.complex64)
    buf = np.zeros((nf, rframe_stride(m)), np.complex64)
    for p in range(plan_passes(log_m)):
        b = plan_bits(log_m, p)
        r_count, s = 1 << b, m >> plan_shift(log_m, p)
        pos = rpass_pos(log_m, p)
        # pass 0 reads the segment; later passes read what the last wrote
        v = z[:, pos] if p == 0 else buf[:, rpidx(pos)]
        v = dft_regs(v, b)
        if s > 1:
            # stage_twiddles: table[(q-1)*S + i] = W_M^{i*q*M/(R*S)}
            x = np.arange((r_count - 1) * s)
            table = w_m_from_host(tw, (x % s) * (x // s + 1) * (m // (r_count * s)), m)
            t = np.arange(t_count)[:, None]
            c = np.arange(REG_POINTS >> b)[None, :]
            i = (t + c * t_count) & (s - 1)
            q = np.arange(1, r_count)
            v[..., 1:] = v[..., 1:] * table[(q - 1) * s + i[..., None]][None]
        buf[:, rpidx(pos)] = v
    return buf, tw


def model_rfft(frames: np.ndarray, win: np.ndarray) -> np.ndarray:
    """K2's bins of ``(nf, N)`` float32 frames, window ``(N,)``: ``(nf, M+1)``
    complex64, through the kernel's passes in its order."""
    nf, n_fft = frames.shape
    m = n_fft // 2
    log_m = m.bit_length() - 1
    t_count = m >> REG_BITS
    buf, tw = model_passes(frames, win)
    # the emit (emit_pairs): thread k0 < T owns bins k = k0 + J*T <= M/2 and
    # finds Z[k], Z[M-k] through the bit-disjoint split of the digit
    # reversal; X[k] = E + W_N^k O and X[M-k] = conj(E - W_N^k O)
    k0 = np.arange(t_count)
    lo1 = rdigit_rev(log_m, k0)
    lo2 = np.where(k0 > 0, rdigit_rev(log_m, (t_count - k0) % t_count), 0)
    ks, p1, p2 = [], [], []
    for j in range(m // 2 // t_count + 1):
        h1 = rdigit_rev(log_m, np.array(j * t_count))
        h2_0 = rdigit_rev(log_m, np.array((m - j * t_count) & (m - 1)))
        h2 = rdigit_rev(log_m, np.array((m - (j + 1) * t_count) & (m - 1)))
        kj = k0 + j * t_count
        keep = kj <= m // 2
        ks.append(kj[keep])
        p1.append((lo1 + h1)[keep])
        p2.append((lo2 + np.where(k0 > 0, h2, h2_0))[keep])
    k, p1, p2 = np.concatenate(ks), np.concatenate(p1), np.concatenate(p2)
    assert np.array_equal(np.sort(k), np.arange(m // 2 + 1))
    assert np.array_equal(p1, rdigit_rev(log_m, k))
    assert np.array_equal(p2, rdigit_rev(log_m, (m - k) & (m - 1)))
    a = buf[:, rpidx(p1)]
    c = buf[:, rpidx(p2)]
    half = np.float32(0.5)
    er, ei = half * (a.real + c.real), half * (a.imag - c.imag)
    dr, di = half * (a.real - c.real), half * (a.imag + c.imag)
    o = tw[k] * (di - np.complex64(1j) * dr)
    out = np.zeros((nf, m + 1), np.complex64)
    out[:, m - k] = (er - o.real) + np.complex64(1j) * (o.imag - ei)
    out[:, k] = (er + o.real) + np.complex64(1j) * (ei + o.imag)
    return out


@pytest.mark.parametrize("log_m", LOG_MS)
def test_plan_matches_rfft(log_m):
    n_fft = 2 << log_m
    frames = signals(60 + log_m, (3, n_fft))
    win = window_host("hann", n_fft).astype(np.float32)
    got = model_rfft(frames, win)
    ref = np.fft.rfft(win.astype(np.float64) * frames.astype(np.float64), axis=-1)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("log_m", LOG_MS)
def test_plan_index_maps(log_m):
    """Every pass touches each point once, in place, with at most 16 points
    per thread; the emit's read map is a permutation; at n_fft 2048 the plan
    has three passes (three exchanges, four barriers per tile)."""
    m = 1 << log_m
    assert plan_shift(log_m, plan_passes(log_m) - 1) == log_m
    for p in range(plan_passes(log_m)):
        assert plan_bits(log_m, p) <= REG_BITS
        pos = rpass_pos(log_m, p)
        assert pos.shape[0] * pos.shape[1] * pos.shape[2] == m
        assert np.array_equal(np.sort(pos.ravel()), np.arange(m))
    assert np.array_equal(np.sort(rdigit_rev(log_m, np.arange(m))), np.arange(m))
    assert np.unique(rpidx(np.arange(m))).size == m and rpidx(np.arange(m)).max() < rframe_stride(m)
    if log_m == 10:
        assert [plan_bits(10, p) for p in range(plan_passes(10))] == [3, 3, 4]


@pytest.mark.parametrize("log_m", LOG_MS)
def test_plan_geometry_fits(log_m):
    """The launch geometry of stft.cu (`Geometry`) fits the card for every
    hop the radix gate admits: at most 1024 threads (512 from n_fft 4096 on)
    and 227 KB of shared memory per block, tiles of 16 frames up to n_fft
    2048."""
    m = 1 << log_m
    t_count = m >> REG_BITS
    max_nt = MAX_THREADS // 2 if log_m >= 11 else MAX_THREADS
    ft = min(16, max_nt // t_count)
    assert ft >= 2 and ft * t_count <= max_nt
    if log_m <= 10:
        assert ft == 16
    tw_off = ft * rframe_stride(m)
    seg_off_bytes = 8 * ((tw_off + m + 1) & ~1)
    assert seg_off_bytes % 16 == 0
    for hop in (128 * r for r in range(1, 9)):
        if hop > 2 * m or (2 * m) % hop or (2 * m) // hop > 8:
            continue
        seg_cap = ((ft - 1) * hop + 2 * m + 3 + 3) & ~3
        assert seg_off_bytes + 4 * seg_cap <= SMEM_LIMIT, (log_m, hop)


# --- K2s: the per-frame statistics emit -----------------------------------


def emit_bins(log_m: int) -> tuple[np.ndarray, ...]:
    """The emit's lanes' bins: for each (k0, J) with k = k0 + J*T <= M/2,
    the lane k0, the bins k and M - k (-1 where the lane stores no mirror:
    k = M/2) and the Z slots pa, pc they are read from (emit_pairs)."""
    m = 1 << log_m
    t_count = m >> REG_BITS
    k0 = np.arange(t_count)
    lo1 = rdigit_rev(log_m, k0)
    lo2 = np.where(k0 > 0, rdigit_rev(log_m, (t_count - k0) % t_count), 0)
    out = []
    for j in range(m // 2 // t_count + 1):
        h1 = rdigit_rev(log_m, np.array(j * t_count))
        h2_0 = rdigit_rev(log_m, np.array((m - j * t_count) & (m - 1)))
        h2 = rdigit_rev(log_m, np.array((m - (j + 1) * t_count) & (m - 1)))
        k = k0 + j * t_count
        keep = k <= m // 2
        mirror = np.where(k == 0, m, np.where(k < m // 2, m - k, -1))
        out.append(np.stack([k0, k, mirror, lo1 + h1, lo2 + np.where(k0 > 0, h2, h2_0)])[:, keep])
    return tuple(np.concatenate(out, axis=1))


@pytest.mark.parametrize("log_m", LOG_MS)
def test_k2s_stash_and_walk_maps(log_m):
    """K2s keeps each magnitude in the Z slot its lane has just read: each
    slot is read by one lane only (so no barrier is needed before the
    write), and bins 0..M land on distinct floats, bin k < M at the .x of
    rpidx(rdigit_rev(k)) and bin M at the .y of slot 0. The rolloff's walk
    finds bin 16t + i at rdigit_rev(16t) + rdigit_rev(i). The padding
    slots hold a float2 a warp of the block (the emit's sums) and of the
    frame (the rolloff's scan), apart from every Z slot and the last slot."""
    m = 1 << log_m
    t_count = m >> REG_BITS
    lane, k, mirror, pa, pc = emit_bins(log_m)
    readers = np.concatenate([pa, pc[pc != pa]])
    assert np.array_equal(np.sort(readers), np.arange(m))  # each slot read once
    assert np.array_equal(pa, rdigit_rev(log_m, k))
    has = mirror >= 0
    # where each bin is kept, as a float index of the frame buffer
    kept = {int(b): 2 * int(rpidx(p)) for b, p in zip(k, pa)}
    for b, p, q in zip(mirror[has], pc[has], pa[has]):
        kept[int(b)] = 2 * int(rpidx(q)) + 1 if b == m else 2 * int(rpidx(p))
    assert sorted(kept) == list(range(m + 1)) and len(set(kept.values())) == m + 1
    for b in range(m):
        assert kept[b] == 2 * rpidx(rdigit_rev(log_m, np.array(b)))
    t = np.arange(t_count)[:, None]
    i = np.arange(REG_POINTS)[None, :]
    assert np.array_equal(rdigit_rev(log_m, 16 * t) + rdigit_rev(log_m, i),
                          rdigit_rev(log_m, 16 * t + i))
    fs = rframe_stride(m)
    pads = 17 * np.arange(m // 16) + 16
    assert pads.max() < fs - 1
    assert not np.isin(pads, rpidx(np.arange(m))).any() and fs - 1 not in rpidx(np.arange(m))
    max_nt = MAX_THREADS // 2 if log_m >= 11 else MAX_THREADS
    ft = min(16, max_nt // t_count)
    assert ft * t_count // 32 <= m // 16 and max(t_count // 32, 1) <= m // 16


def model_k2s(frames: np.ndarray, win: np.ndarray, freq: np.ndarray, roll_percent: float):
    """K2s's bandwidth (p = 2), flatness (power 2) and rolloff of ``(nf, N)``
    frames in the kernel's order of float32 operations: each emit lane's
    sums over its bins (emit_pairs' order), the frame's lanes combined by
    the xor shuffles and then warp by warp; the rolloff's in-order chunks
    of 16 bins, a Hillis-Steele scan a warp, the warps' totals in order."""
    nf, n_fft = frames.shape
    m = n_fft // 2
    log_m = m.bit_length() - 1
    t_count = m >> REG_BITS
    S = np.abs(model_rfft(frames, win)).astype(np.float32)  # (nf, M+1)
    lane, k, mirror, _, _ = emit_bins(log_m)
    f32 = np.float32

    def lane_sums(fn):
        """Each lane's sum of fn(S, bin) over its bins in its order, then
        the sum over lanes in the kernel's combination order."""
        acc = np.zeros((nf, t_count), np.float32)
        for ln, b, mb in zip(lane, k, mirror):
            acc[:, ln] += fn(S[:, b], b)
            if mb >= 0:
                acc[:, ln] += fn(S[:, mb], mb)
        max_nt = MAX_THREADS // 2 if log_m >= 11 else MAX_THREADS
        ft = min(16, max_nt // t_count)
        per_warp = 32 // ft  # lanes of one frame in a warp: k0 = per_warp*w .. +per_warp-1
        acc = acc.reshape(nf, t_count // per_warp, per_warp)
        d = 1
        while d < acc.shape[-1]:  # xor butterfly: the same sums in every lane
            acc = acc + acc[..., np.arange(acc.shape[-1]) ^ d]
            d <<= 1
        tot = np.zeros(nf, np.float32)
        for w in range(acc.shape[1]):
            tot += acc[:, w, 0]
        return tot

    fq = freq.astype(np.float32)
    s0 = lane_sums(lambda s, b: s)
    s1 = lane_sums(lambda s, b: fq[b] * s)
    c = s1 / (s0 + f32(1e-10))
    dev = lane_sums(lambda s, b: s * (np.abs(fq[b] - c) ** 2).astype(np.float32))
    bandwidth = np.sqrt(dev / (s0 + f32(1e-10)))
    x = np.maximum(S * S, f32(1e-10))
    lsum = lane_sums(lambda s, b: np.log2(np.maximum(s * s, f32(1e-10))))
    xsum = lane_sums(lambda s, b: np.maximum(s * s, f32(1e-10)))
    n = f32(m + 1)
    flatness = (f32(2) ** (lsum / n)) / (xsum / n + f32(1e-10))
    assert x.shape == S.shape

    # rolloff: chunks of 16 bins in order, thread T-1 also bin M
    chunks = S[:, :m].reshape(nf, t_count, REG_POINTS)
    csum = np.zeros((nf, t_count), np.float32)
    for i in range(REG_POINTS):
        csum += chunks[:, :, i]
    csum[:, -1] += S[:, m]
    w = min(t_count, 32)
    inc = csum.reshape(nf, -1, w).copy()
    d = 1
    while d < w:
        shifted = np.zeros_like(inc)
        shifted[..., d:] = inc[..., :-d]
        inc = inc + np.where(np.arange(w) >= d, shifted, f32(0))
        d <<= 1
    before = np.zeros_like(inc)
    before[..., 1:] = inc[..., :-1]
    warp_tot = np.zeros((nf, inc.shape[1]), np.float32)
    for q in range(1, inc.shape[1]):
        warp_tot[:, q] = warp_tot[:, q - 1] + inc[:, q - 1, -1]
    before = (warp_tot[..., None] + before).reshape(nf, t_count)
    run = before.copy()
    runs = np.zeros((nf, t_count, REG_POINTS), np.float32)
    for i in range(REG_POINTS):
        run += chunks[:, :, i]
        runs[:, :, i] = run
    last = run[:, -1] + S[:, m]
    thr = f32(roll_percent) * last
    hit = np.concatenate([runs.reshape(nf, m), last[:, None]], axis=1) >= thr[:, None]
    idx = np.where(hit.any(1), np.argmax(hit, axis=1), 0)
    return bandwidth, flatness, fq[idx]


@pytest.mark.parametrize("log_m", LOG_MS)
def test_k2s_model_matches_float64(log_m):
    """The model of K2s's sums, scan and threshold, on the model of its
    FFT, against the statistics of ``numpy.fft.rfft`` in float64: bandwidth
    and flatness within 1e-5 of max, rolloff within one bin."""
    n_fft = 2 << log_m
    frames = signals(80 + log_m, (6, n_fft))
    win = window_host("hann", n_fft).astype(np.float32)
    freq = np.linspace(0, 11025.0, n_fft // 2 + 1)
    bw, flat, roll = model_k2s(frames, win, freq, 0.85)
    S = np.abs(np.fft.rfft(win.astype(np.float64) * frames.astype(np.float64), axis=-1))
    total = S.sum(1) + 1e-10
    c = (freq * S).sum(1) / total
    bw64 = np.sqrt((S * (freq - c[:, None]) ** 2).sum(1) / total)
    x = np.maximum(S**2, 1e-10)
    flat64 = np.exp(np.log(x).mean(1)) / (x.mean(1) + 1e-10)
    cs = np.cumsum(S, 1)
    roll64 = freq[np.argmax(cs >= 0.85 * cs[:, -1:], 1)]
    assert np.abs(bw - bw64).max() <= 1e-5 * bw64.max()
    assert np.abs(flat - flat64).max() <= 1e-5 * flat64.max()
    assert np.abs(np.rint((roll - roll64) / (11025.0 / (n_fft // 2)))).max() <= 1
