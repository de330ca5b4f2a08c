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
