"""PyTorch port: a NumPy model of K3's plan.

`csrc/istft_fused.cu` (K3) computes the inverse real FFT of each frame as
the forward register-resident FFT of `csrc/fft_common.cuh` (K2's passes) on
``Y = conj(Z) / M``, the packed spectrum conjugated and scaled
(``irfft_pack``), since ``IFFT_M(Z) = conj(FFT_M(conj Z)) / M``. A CUDA
kernel cannot run here, so this file repeats its integer maps in NumPy and
runs them in complex64, as the kernel runs in FP32:

- pass 0 reads the bins straight from the spectrum, threads frames fastest
  (slot ``i = tid % FT``, thread ``t = tid // FT``), thread t owning the
  butterflies ``t`` and ``S0 - t`` whose points pair up as ``k``, ``M - k``
  (thread 0: ``0`` and ``T``), so each bin is read once where pass 0 has
  radix 8 (radix 16: once by each of the two threads that need it);
- the later passes are K2's (`test_torch_port_stft_plan.py` models them);
- the overlap-add reads point ``c*H + p`` of a frame at
  ``rpidx(rdigit_rev(c*H)) + rpidx(rdigit_rev(p))``, takes the samples
  ``(Re, -Im)`` of the conjugate, and thread (row i, t) adds into its row
  and carries the rows past the tile in ``C - 1`` slots of shared memory;
- a block takes a span of global hop-rows, walks each run of them within a
  clip in tiles of FT frames from ``C - 1`` frames before the run, and
  writes only the run's rows.

The model is held against ``numpy.fft.irfft`` + window + overlap-add +
envelope divide in float64 for every log2(M) from 6 to 12 and every
``C = n_fft / hop`` the radix gate admits, with spans that cut clips at
their first and last rows and cross from one clip into the next. Tolerance:
1e-5 of max |output|; a float32 FFT rounds ~1e-6 of max at n_fft 8192, an
index or sign error gives errors of order one.
"""

from __future__ import annotations

import numpy as np
import pytest
from test_torch_port_stft_plan import (
    REG_BITS,
    REG_POINTS,
    W16,
    dft_regs,
    plan_bits,
    plan_passes,
    plan_shift,
    rdigit_rev,
    rframe_stride,
    rpass_pos,
    rpidx,
    w_m_from_host,
)
from torch_port_util import signals

from mlx_audio_primitives_tpu_torch.kernels.dft import rfft_twiddles
from mlx_audio_primitives_tpu_torch.kernels.istft_fused import frames_transformed
from mlx_audio_primitives_tpu_torch.ops.windows import window_host

SMEM_LIMIT = 227 * 1024  # fft_common.cuh: kSmemLimit
F32 = np.float32
#: (log2 M, C = n_fft / hop) for every shape the radix gate admits
SHAPES = [(lm, c) for lm in range(6, 13) for c in (1, 2, 4, 8)
          if 128 <= (2 << lm) // c <= 1024]


class Geometry:
    """`IGeometry<LOG_M, C>`: K2's tile (`mapt::Geometry`) and the
    overlap-add's rows, carried rows and shared memory."""

    def __init__(self, log_m: int, C: int):
        self.log_m, self.C = log_m, C
        self.M = 1 << log_m
        self.T = self.M >> REG_BITS
        self.max_threads = 512 if log_m >= 11 else 1024
        self.FT = min(16, self.max_threads // self.T)
        self.NT = self.FT * self.T
        gt = self.T if self.T > min(self.NT, 128) else min(self.NT, 128)
        self.GT = 0 if gt == self.NT else gt
        self.FS = rframe_stride(self.M)
        self.H = self.M // C
        self.K = 1 + (C - 1 + self.FT - 1) // self.FT
        self.CS = self.H + 1
        self.R0 = 1 << plan_bits(log_m, 0)
        self.S0 = self.M // self.R0
        # the overlap-add's lanes: RL rows by 32 / RL pairs
        near = int(rpidx(rdigit_rev(log_m, np.array(1)))) % 16 == 8
        self.RL = 8 if self.FT >= 8 and near else self.FT
        # frame buffers, twiddle tables, carried rows, the window where it fits
        base = 8 * (self.FT * self.FS + self.M + (C - 1) * self.CS)
        self.win_staged = base + 8 * self.M <= SMEM_LIMIT
        self.smem = base + 8 * self.M * self.win_staged


def host_twiddles(n_fft: int) -> np.ndarray:
    t6 = rfft_twiddles.host(n_fft)
    return (t6[:, 0].astype(F32) + 1j * t6[:, 1].astype(F32)).astype(np.complex64)


def irfft_pack(x: np.ndarray, y: np.ndarray, w: np.ndarray, scale: float):
    """``mapt::irfft_pack`` in float32: (Y[k], Y[M-k]) from X[k], X[M-k]."""
    s = F32(scale)
    er, ei = (x.real + y.real) * s, (x.imag - y.imag) * s
    dr, di = (x.real - y.real) * s, (x.imag + y.imag) * s
    orr, oi = dr * w.real + di * w.imag, di * w.real - dr * w.imag
    yk = (er - oi) + np.complex64(1j) * (-ei - orr)
    ymk = (er + oi) + np.complex64(1j) * (ei - orr)
    return yk.astype(np.complex64), ymk.astype(np.complex64)


def pass0_loads(g: Geometry) -> tuple[np.ndarray, np.ndarray]:
    """For each thread t of a frame: the bins pass 0 reads, ``(T, n)``, in
    the order of its loads, and the points it owns, ``(T, 16)`` (the bin
    whose Y fills v[q]: butterfly 0 in v[0..R0), butterfly 1 after)."""
    M, R0, S0, T = g.M, g.R0, g.S0, g.T
    t = np.arange(T)[:, None]
    r = np.arange(R0)[None, :]
    if R0 == 8:
        loads = np.concatenate([t + r * S0, M - t - r * S0], axis=1)
        # thread 0: butterfly 0's bins, X[M], butterfly T's bins
        loads[0] = np.concatenate([r[0] * S0, T + r[0] * S0])
        loads = [list(row) for row in loads]
        loads[0].append(M)
        u1 = np.where(t[:, 0] > 0, S0 - t[:, 0], T)
        points = np.concatenate([t + r * S0, u1[:, None] + r * S0], axis=1)
    else:
        loads = [list(row) for row in np.concatenate([t + r * S0, M - t - r * S0], axis=1)]
        points = t + r * S0
    return loads, points


def first_pass(g: Geometry, X: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """Pass 0 of the tile's frames ``X`` (FT, M+1) complex64 (zeros for a
    frame that adds nothing): frame buffers (FT, FS) after its stores."""
    M, R0, S0, T, FT = g.M, g.R0, g.S0, g.T, g.FT
    scale = 0.5 / M
    b0 = plan_bits(g.log_m, 0)
    Xr = X.copy()
    Xr[:, 0] = Xr[:, 0].real
    Xr[:, M] = Xr[:, M].real
    t = np.arange(T)
    r = np.arange(R0)
    v = np.zeros((FT, T, 2 * R0 if R0 == 8 else R0), np.complex64)
    if R0 == 8:
        # W_N^{t + r*S0} = W_N^t W_16^r: one twiddle load a thread
        w16 = np.where(r == 0, np.complex64(1), W16[np.minimum(r, 7)]).astype(np.complex64)
        k = t[:, None] + r[None, :] * S0  # (T, R0)
        wk = np.where(r[None, :] == 0, tw[t][:, None], tw[t][:, None] * w16[None, :])
        yk, ymk = irfft_pack(Xr[:, k], Xr[:, M - k], wk, scale)
        v[:, :, :R0] = yk
        v[:, :, R0:] = ymk[:, :, ::-1]  # point 7 - r of butterfly S0 - t
        # thread 0: butterflies 0 and T, each its own partner
        k0 = r * S0
        v[:, 0, :R0] = irfft_pack(Xr[:, k0], Xr[:, M - k0], w16, scale)[0]
        kT = T + r * S0
        wT = np.where(r == 0, tw[T], tw[T] * w16)
        v[:, 0, R0:] = irfft_pack(Xr[:, kT], Xr[:, M - kT], wT, scale)[0]
        us = [t, np.where(t > 0, S0 - t, T)]
    else:
        k = t[:, None] + r[None, :] * S0
        v[:] = irfft_pack(Xr[:, k], Xr[:, M - k], tw[k], scale)[0]
        us = [t]
    x = np.arange((R0 - 1) * S0)
    table = w_m_from_host(tw, (x % S0) * (x // S0 + 1) * (M // (R0 * S0)), M)
    buf = np.zeros((FT, g.FS), np.complex64)
    for c, u in enumerate(us):
        vc = dft_regs(v[:, :, c * R0:(c + 1) * R0], b0)
        vc[..., 1:] = vc[..., 1:] * table[(np.arange(1, R0) - 1)[None, :] * S0 + u[:, None]][None]
        buf[:, rpidx(u[:, None] + r[None, :] * S0)] = vc
    return buf


def later_passes(g: Geometry, buf: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """Passes 1.. of K2's plan on the frame buffers, in place."""
    log_m, M, T = g.log_m, g.M, g.T
    for p in range(1, plan_passes(log_m)):
        b = plan_bits(log_m, p)
        r_count, s = 1 << b, M >> plan_shift(log_m, p)
        pos = rpass_pos(log_m, p)
        v = dft_regs(buf[:, rpidx(pos)], b)
        if s > 1:
            x = np.arange((r_count - 1) * s)
            table = w_m_from_host(tw, (x % s) * (x // s + 1) * (M // (r_count * s)), M)
            t = np.arange(T)[:, None]
            c = np.arange(REG_POINTS >> b)[None, :]
            i = (t + c * T) & (s - 1)
            q = np.arange(1, r_count)
            v[..., 1:] = v[..., 1:] * table[(q - 1) * s + i[..., None]][None]
        buf[:, rpidx(pos)] = v
    return buf


def overlap_add_tile(g: Geometry, buf, carry, win, env, out, g0, r0, r1, first):
    """The tile's overlap-add for threads (row i, t), all at once: reads
    every carried slot before it writes one (a thread owns the slots of
    its row modulo FT). Writes rows g0+i in [r0, r1) of ``out`` (T,)."""
    FT, H, K, C, T_len = g.FT, g.H, g.K, g.C, out.shape[0]
    i = np.arange(FT)[:, None, None]
    t = np.arange(g.T)[None, :, None]
    n = np.arange(16 // C)[None, None, :]
    p = t + n * g.T
    lo = rpidx(rdigit_rev(g.log_m, t)) + rpidx(rdigit_rev(g.log_m, n * g.T))
    acc = np.zeros((K,) + np.broadcast_shapes(i.shape, p.shape), np.complex64)
    for k in range(K):
        q = i + FT * k
        ok = (q < C - 1) & (not first)
        acc[k] = np.where(ok, carry[np.minimum(q, max(C - 2, 0)), p] if C > 1 else 0, 0)
    for c in range(C):
        j = (i - c) & (FT - 1)
        kc = (j + c - i) >> (FT.bit_length() - 1)
        pos = lo + rpidx(rdigit_rev(g.log_m, c * H))
        assert np.array_equal(pos, np.broadcast_to(rpidx(rdigit_rev(g.log_m, c * H + p)), pos.shape))
        z = buf[j, pos]
        w0, w1 = win[2 * (c * H + p)], win[2 * (c * H + p) + 1]
        term = (w0 * z.real) + np.complex64(1j) * (-w1 * z.imag)
        for k in range(K):
            acc[k] = acc[k] + np.where(kc == k, term, 0)
    for k in range(1, K):
        q = np.broadcast_to(i + FT * (k - 1), acc[k].shape)
        sel = q < C - 1
        carry[q[sel], np.broadcast_to(p, sel.shape)[sel]] = acc[k][sel]
    row = np.broadcast_to(g0 + i, acc[0].shape)
    s = row * 2 * H + 2 * np.broadcast_to(p, row.shape)
    keep = (row >= r0) & (row < r1)
    for half, part in ((0, acc[0].real), (1, acc[0].imag)):
        si = s + half
        ok = keep & (si < T_len)
        e = np.where(si < env.shape[0], env[np.minimum(si, env.shape[0] - 1)], F32(1))
        out[si[ok]] = (part / e)[ok]


def model_istft(X: np.ndarray, win: np.ndarray, env: np.ndarray, log_m: int, C: int,
                T_len: int, span: int) -> tuple[np.ndarray, int]:
    """K3 on ``X`` (B, F, M+1): the output (B, T_len) and the frame slots
    transformed, each block taking ``span`` global hop-rows."""
    g = Geometry(log_m, C)
    B, F, _ = X.shape
    tw = host_twiddles(2 * g.M)
    hop = 2 * g.H
    rows = -(-T_len // hop)
    out = np.full((B, T_len), np.nan, F32)
    slots = 0
    total = B * rows
    for block in range(-(-total // span)):
        cur, end = block * span, min(total, (block + 1) * span)
        while cur < end:
            b, r0 = divmod(cur, rows)
            r1 = min(rows, r0 + end - cur)
            cur += r1 - r0
            f_end = min(F, r1)
            carry = np.full((max(C - 1, 1), g.CS), np.nan, np.complex64)
            first = True
            for g0 in range(max(0, r0 - (C - 1)), r1, g.FT):
                f = g0 + np.arange(g.FT)
                Xt = np.where((f < f_end)[:, None], X[b, np.minimum(f, F - 1)], 0).astype(np.complex64)
                buf = later_passes(g, first_pass(g, Xt, tw), tw)
                overlap_add_tile(g, buf, carry, win, env, out[b], g0, r0, r1, first)
                first = False
                slots += g.FT
    return out, slots


def reference(X: np.ndarray, win: np.ndarray, env: np.ndarray, n_fft: int, hop: int,
              T_len: int) -> np.ndarray:
    """float64 irfft (imaginary parts of DC and Nyquist dropped), window,
    overlap-add of the frames that start before T_len, envelope divide."""
    X = X.astype(np.complex128)
    X[..., 0] = X[..., 0].real
    X[..., -1] = X[..., -1].real
    frames = np.fft.irfft(X, n=n_fft, axis=-1) * win.astype(np.float64)
    B, F, _ = frames.shape
    out = np.zeros((B, max(T_len, (F - 1) * hop + n_fft)))
    for f in range(F):
        out[:, f * hop:f * hop + n_fft] += frames[:, f]
    out = out[:, :T_len]
    e = np.ones(T_len)
    e[:min(T_len, env.shape[0])] = env[:T_len]
    return out / e


def spans(g: Geometry, total: int, rows: int) -> list[int]:
    """The launcher's span for a small and for a large resident grid, and
    spans that cut clips at their first and last rows."""
    least = max(1, g.FT - (g.C - 1))
    return sorted({max(-(-total // slots), least) for slots in (3, 1000)}
                  | {rows - 1, rows + 1, 2})


@pytest.mark.parametrize("log_m,C", SHAPES)
def test_plan_matches_irfft_overlap_add(log_m, C):
    n_fft = 2 << log_m
    hop = n_fft // C
    g = Geometry(log_m, C)
    rng = np.random.default_rng(100 * log_m + C)
    F = 3 + C + (9 if log_m <= 9 else 2)
    B = 2
    X = (signals(log_m + 7 * C, (B, F, g.M + 1))
         + 1j * signals(log_m + 7 * C + 1, (B, F, g.M + 1))).astype(np.complex64)
    win = window_host("hann", n_fft).astype(F32)
    natural = n_fft + (F - 1) * hop
    # the natural length, one the frames overrun (odd), one past the last frame
    for T_len in (natural, natural - hop - 1, natural + hop + 64):
        env = (0.5 + rng.random(T_len - (hop // 2 if T_len > natural else 0))).astype(F32)
        ref = reference(X, win, env, n_fft, hop, T_len)
        rows = -(-T_len // hop)
        for span in spans(g, B * rows, rows):
            got, slots = model_istft(X, win, env, log_m, C, T_len, span)
            assert not np.isnan(got).any(), (T_len, span)  # every sample written
            err = np.abs(got - ref).max() / np.abs(ref).max()
            assert err <= 1e-5, (T_len, span, err)
            _, slots_k = frames_transformed(B, rows, F, C, g.FT, span)
            assert slots == slots_k


@pytest.mark.parametrize("log_m,C", SHAPES)
def test_plan_pack_is_the_conjugate_inverse(log_m, C):
    """Y = irfft_pack(X[k], X[M-k]) = conj(Z) / M, and conj(FFT_M(Y)) is the
    frame's packed points x[2n] + i x[2n+1]."""
    g = Geometry(log_m, C)
    M = g.M
    X = (signals(3 + log_m, (M + 1,)) + 1j * signals(4 + log_m, (M + 1,))).astype(np.complex64)
    X[0], X[M] = X[0].real, X[M].real
    k = np.arange(M)
    tw = host_twiddles(2 * M)
    yk, ymk = irfft_pack(X[k], X[M - k], tw[k], 0.5 / M)
    assert np.allclose(ymk[1:], yk[::-1][:-1], rtol=0, atol=1e-6 * np.abs(yk).max())
    x = np.fft.irfft(X.astype(np.complex128), n=2 * M)
    z = np.conj(np.fft.fft(yk.astype(np.complex128)))
    err = max(np.abs(z.real - x[0::2]).max(), np.abs(z.imag - x[1::2]).max())
    assert err <= 1e-6 * np.abs(x).max(), err


@pytest.mark.parametrize("log_m", range(6, 13))
def test_plan_pass0_reads_each_bin_once(log_m):
    """Pass 0's loads: every bin of a frame read once where pass 0 has radix
    8, at most twice where it has radix 16; every point owned once; and on
    the natural layout (frames contiguous) the FT lanes of a warp that share
    a load read FT consecutive frames of one bin."""
    g = Geometry(log_m, 1 if log_m <= 9 else 8)
    loads, points = pass0_loads(g)
    counts = np.bincount(np.concatenate([np.asarray(x) for x in loads]), minlength=g.M + 1)
    assert counts.shape[0] == g.M + 1 and counts.min() == 1
    assert counts.max() == (1 if g.R0 == 8 else 2)
    assert np.array_equal(np.sort(points.ravel()), np.arange(g.M))
    F = 1000
    tid = np.arange(min(32, g.NT))
    slot, t = tid % g.FT, tid // g.FT
    for r in range(len(loads[1])):
        addr = slot + np.array([loads[x][r] for x in t]) * F  # sf = 1, sk = F
        for lanes in addr.reshape(-1, g.FT):
            assert np.array_equal(np.diff(lanes), np.ones(g.FT - 1, int))


@pytest.mark.parametrize("log_m,C", SHAPES)
def test_plan_geometry_fits(log_m, C):
    """At most 1024 threads (512 from n_fft 4096 on) and 227 KB of shared
    memory a block, at most 8 barrier groups; up to n_fft 2048 tiles of 16
    frames and the window in shared memory; the overlap-add's reads of a
    half-warp fall on 16 different bank pairs where FT = 16 (lanes: RL rows
    by 32 / RL pairs), and so do pass 0's stores; at n_fft 2048 a warp
    stores 32 consecutive bytes of each of 8 rows."""
    g = Geometry(log_m, C)
    assert g.NT <= g.max_threads and g.smem <= SMEM_LIMIT
    assert g.GT == 0 or (g.NT // g.GT <= 8 and g.GT % 32 == 0)
    if log_m <= 10:
        assert g.FT == 16 and g.win_staged
    if log_m == 10:
        assert g.RL == 8
    if g.FT == 16:
        lane = np.arange(16)
        i, t = lane % g.RL, lane // g.RL
        for c in range(C):
            for n in range(16 // C):
                j = (i - c) & (g.FT - 1)
                addr = j * g.FS + rpidx(rdigit_rev(log_m, c * g.H + t + n * g.T))
                assert np.unique(addr % 16).size == 16, (c, n)
    if g.FT == 16:
        loads, points = pass0_loads(g)
        lane = np.arange(16)
        for q in range(points.shape[1]):
            addr = lane * g.FS + rpidx(points[0, q])  # t = 0 in every lane
            assert np.unique(addr % 16).size == 16


def test_plan_recompute_at_64_clips_of_30_s():
    """The launcher's span for 64 clips of 30 s at n_fft 2048, hop 512, on
    132 SMs with one resident block: at most 10% of the frames recomputed
    (read or transformed) beyond the 82,688 the output needs; one clip puts
    one tile on each of 100 blocks."""
    g = Geometry(10, 4)
    F, T_len = 1292, 30 * 22050 + 2048
    rows = -(-T_len // 512)
    for B, most in ((64, 0.10), (1, 1.0)):
        span = max(-(-B * rows // 132), g.FT - 3)
        loaded, slots = frames_transformed(B, rows, F, 4, g.FT, span)
        need = B * min(F, rows)
        assert loaded / need - 1 <= most and slots / need - 1 <= most, (B, loaded, slots)
    assert -(-rows // max(-(-rows // 132), g.FT - 3)) == 100
