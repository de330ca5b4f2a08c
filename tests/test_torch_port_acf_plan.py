"""PyTorch port: a NumPy model of K1's ACF entry.

`csrc/mel_fused.cu` (``mel_fused_acf_kernel``) computes what K1 gives with
the pitch ACF's lag basis as its weight at power 2, ``irfft(|rDFT(win *
frame)|^2)`` at lag 0 and lags [lo, hi), as that inverse real FFT. A CUDA
kernel cannot run here, so this file repeats its maps and its arithmetic in
NumPy, in complex64 as the kernel runs in FP32:

- the forward passes of K2's front end (`test_torch_port_stft_plan.py`);
- the pack: thread t of a frame reads Z[k] and Z[M-k] at their
  digit-reversed positions for the points of its own butterflies of the
  inverse's pass 0 (K3's map: ``t`` and ``S0 - t`` where pass 0 has radix
  8, thread 0 ``0`` and ``T``; ``t`` alone where it has radix 16), splits
  the real FFT into X[k] and X[M-k], and packs their powers as real bins
  into Y[k] = (s + a, -b) and Y[M-k] = (s - a, -b) (``irfft_pack``'s
  algebra for real bins, held as three floats a pair);
- the inverse's pass 0 on those registers, its later passes (K3's,
  `test_torch_port_istft_plan.py`), and the read-out: lag 2m and 2m+1 are
  (Re, -Im) of point m at ``rpidx(rdigit_rev(m))``.

The model is held against the entry's plain twin (K1's plain twin with the
lag basis) for every log2(M) from 6 to 12 and lag windows with odd and even
ends (a lag pair split across complex points), ``lo = 1`` and ``hi - 1 =
frame_length``. Tolerance: 1e-6 of each frame's lag 0 (its largest value);
two float32 FFTs round ~1e-7 of it, an index or sign error gives errors of
order one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_port_istft_plan import Geometry, later_passes
from test_torch_port_stft_plan import (
    W16,
    dft_regs,
    model_passes,
    plan_bits,
    rdigit_rev,
    rpidx,
    w_m_from_host,
)
from torch_port_util import signals

from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
from mlx_audio_primitives_tpu_torch.ops import pitch as tap_pitch

F32 = np.float32
LOG_MS = range(6, 13)
SMEM_LIMIT = 227 * 1024  # fft_common.cuh: kSmemLimit
SM_SMEM = 228 * 1024  # shared memory of an H100 SM
BLOCK_RESERVED = 1024  # shared memory the card reserves for each block


def lag_windows(m: int) -> dict[str, tuple[int, int]]:
    """(lo, hi) at frame_length W = M (n_fft = 2M): the ends' parities, the
    window's edges, and the defaults' lags 11..441 cut to the frame."""
    return {
        "lo=1,hi-1=W": (1, m + 1),
        "even,odd": (2, m // 2 + 1),
        "odd,even": (3, m // 2 + 2),
        "even,even": (10, m - 6),
        "defaults": (11, min(442, m + 1)),
    }


def acf_pair(a: np.ndarray, c: np.ndarray, w: np.ndarray, m: int):
    """``mel_fused.cu::acf_pair`` and ``y_k`` / ``y_mk``: (Y[k], Y[M-k])
    from a = Z[k], c = Z[M-k] and w = W_N^k, through (s, a, b)."""
    half, scale = F32(0.5), F32(0.5 / m)
    er, ei = half * (a.real + c.real), half * (a.imag - c.imag)
    dr, di = half * (a.real - c.real), half * (a.imag + c.imag)
    o = (w * (di - np.complex64(1j) * dr)).astype(np.complex64)
    xr, xi = er + o.real, ei + o.imag
    yr, yi = er - o.real, o.imag - ei
    pk, pmk = xr * xr + xi * xi, yr * yr + yi * yi
    s, d = (pk + pmk) * scale, (pk - pmk) * scale
    pa, pb = d * w.imag, d * w.real
    j = np.complex64(1j)
    return (s + pa - j * pb).astype(np.complex64), (s - pa - j * pb).astype(np.complex64)


def pack_plan(log_m: int):
    """Per thread t of a frame: the (Z[k], Z[M-k]) positions it reads, the
    twiddle W_N^k of each pair, and the register slots that take Y[k] and
    Y[M-k] (-1: dropped). Returns ``(reads_a, reads_c, tw_index, w16_index,
    slot_k, slot_mk)``, each ``(T, pairs)``; a pair's twiddle is
    ``tw[tw_index] * W16[w16_index]`` (``w16_index`` 0: the table alone)."""
    m = 1 << log_m
    t_count = m >> 4
    r0 = 1 << plan_bits(log_m, 0)
    s0 = m // r0
    rows = []
    for t in range(t_count):
        row = []
        if r0 == 8 and t:
            lo1, lo2 = rdigit_rev(log_m, np.array(t)), rdigit_rev(log_m, np.array(s0 - t))
            for r in range(8):
                row.append((rpidx(lo1 + rdigit_rev(log_m, np.array(r * s0))),
                            rpidx(lo2 + rdigit_rev(log_m, np.array((7 - r) * s0))),
                            t, r, r, 15 - r))
        elif r0 == 8:
            # butterfly T's pairs (r, 7 - r), butterfly 0's (r, 8 - r), then
            # Y[0] and Y[M/2], each its own partner
            for r in range(4):
                row.append((rpidx(rdigit_rev(log_m, np.array(t_count + r * s0))),
                            rpidx(rdigit_rev(log_m, np.array(t_count + (7 - r) * s0))),
                            t_count, r, 8 + r, 15 - r))
            for r in range(1, 4):
                row.append((rpidx(rdigit_rev(log_m, np.array(r * s0))),
                            rpidx(rdigit_rev(log_m, np.array((8 - r) * s0))),
                            0, r, r, 8 - r))
            for r in (0, 4):
                at = rpidx(rdigit_rev(log_m, np.array(r * s0)))
                row.append((at, at, 0, r, r, -1))
        else:
            lo1 = rdigit_rev(log_m, np.array(t))
            for r in range(16):
                part = (rdigit_rev(log_m, np.array(s0 - t)) + rdigit_rev(log_m, np.array((15 - r) * s0))
                        if t else rdigit_rev(log_m, np.array(((16 - r) & 15) * s0)))
                row.append((rpidx(lo1 + rdigit_rev(log_m, np.array(r * s0))), rpidx(part),
                            t + r * s0, 0, r, -1))
        rows.append(row)
    # thread 0 of radix 8 has one pair more; pad the others with a copy of
    # their last pair, dropped (slots -1)
    n = max(len(r) for r in rows)
    for row in rows:
        row += [row[-1][:4] + (-1, -1)] * (n - len(row))
    arr = np.array([[tuple(int(x) for x in p) for p in row] for row in rows])
    return tuple(arr[..., i] for i in range(6))


def butterflies_of(log_m: int) -> list[np.ndarray]:
    """The inverse's pass-0 butterflies of each thread, one array a slot
    group of R0 registers: ``t`` (and ``S0 - t``, ``T`` for thread 0, where
    pass 0 has radix 8)."""
    m = 1 << log_m
    t_count = m >> 4
    t = np.arange(t_count)
    if plan_bits(log_m, 0) == 3:
        return [t, np.where(t > 0, m // 8 - t, t_count)]
    return [t]


def model_acf(frames: np.ndarray, win: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """The entry on ``(nf, N)`` float32 frames and window ``(N,)``:
    ``(nf, 1 + hi - lo)``, lag 0 then lags [lo, hi)."""
    nf, n_fft = frames.shape
    m = n_fft // 2
    log_m = m.bit_length() - 1
    g = Geometry(log_m, 1)
    buf, tw = model_passes(frames, win)  # the forward spectra, digit-reversed
    ra, rc, ti, wi, sk, smk = pack_plan(log_m)
    w = np.where(wi > 0, tw[ti] * W16[wi], tw[ti]).astype(np.complex64)
    yk, ymk = acf_pair(buf[:, ra], buf[:, rc], w[None], m)
    r0 = 1 << plan_bits(log_m, 0)
    v = np.full((nf, g.T, 16), np.nan, np.complex64)
    t = np.arange(g.T)[:, None].repeat(ra.shape[1], 1)
    for slots, vals in ((sk, yk), (smk, ymk)):
        keep = slots >= 0
        v[:, t[keep], slots[keep]] = vals[:, keep]
    # the barrier; pass 0 in registers, then over the spectrum
    s0 = m // r0
    x = np.arange((r0 - 1) * s0)
    table = w_m_from_host(tw, (x % s0) * (x // s0 + 1) * (m // (r0 * s0)), m)
    r = np.arange(r0)
    for c, u in enumerate(butterflies_of(log_m)):
        vc = dft_regs(v[:, :, c * r0:(c + 1) * r0], plan_bits(log_m, 0))
        vc[..., 1:] = vc[..., 1:] * table[(r[1:] - 1)[None, :] * s0 + u[:, None]][None]
        buf[:, rpidx(u[:, None] + r[None, :] * s0)] = vc
    buf = later_passes(g, buf, tw)
    lags = np.concatenate([[0], np.arange(lo, hi)])
    z = buf[:, rpidx(rdigit_rev(log_m, lags >> 1))]
    return np.where(lags & 1, -z.imag, z.real).astype(F32)


def acf_inputs(log_m: int, seed: int, B: int = 2, F: int = 5):
    """``ypad`` (B, L) of F frames at a hop the radix gate admits, the
    boxcar over half the transform, and the frames as the kernel reads them."""
    n_fft = 2 << log_m
    hop = max(128, n_fft // 4)
    ypad = signals(seed, (B, n_fft + (F - 1) * hop))
    win = np.zeros(n_fft, F32)
    win[: n_fft // 2] = 1.0
    frames = np.lib.stride_tricks.sliding_window_view(ypad, n_fft, axis=-1)[:, ::hop]
    return ypad, win, frames.reshape(-1, n_fft), hop


@pytest.mark.parametrize("case", list(lag_windows(64)))
@pytest.mark.parametrize("log_m", LOG_MS)
def test_plan_matches_the_twin(log_m, case):
    m = 1 << log_m
    lo, hi = lag_windows(m)[case]
    ypad, win, frames, hop = acf_inputs(log_m, 90 + log_m)
    got = model_acf(frames, win, lo, hi)  # (B*F, 1 + hi - lo)
    ref = k1.acf_plain(torch.from_numpy(ypad), torch.from_numpy(win), n_fft=2 * m,
                       hop_length=hop, lo=lo, hi=hi).numpy()  # (B, 1 + hi - lo, F)
    ref = ref.transpose(0, 2, 1).reshape(got.shape)
    assert (ref[:, 0] > 0).all()
    err = (np.abs(got - ref) / ref[:, :1]).max()
    assert err <= 1e-6, err


@pytest.mark.parametrize("log_m", LOG_MS)
def test_plan_reads_and_points(log_m):
    """The pack gives every point of the inverse's pass 0 once; each thread
    reads positions inside the frame; where pass 0 has radix 8 every
    position is read once (Z[0] and Z[M/2], each its own partner, twice by
    thread 0), where it has radix 16 each position is read by two threads;
    and the stores over the spectrum land on positions that other threads
    read, so the barrier between the reads and the stores is needed."""
    m = 1 << log_m
    ra, rc, ti, wi, sk, smk = pack_plan(log_m)
    r0 = 1 << plan_bits(log_m, 0)
    s0 = m // r0
    t_count = m >> 4
    points = []
    for c, u in enumerate(butterflies_of(log_m)):
        points.append(u[:, None] + np.arange(r0)[None, :] * s0)
    points = np.concatenate(points, axis=1)  # (T, 16 or R0): the point in each slot
    assert np.array_equal(np.sort(points.ravel()), np.arange(m))
    # each slot filled once, with the Y of the point it holds
    filled = np.zeros(points.shape, int)
    t = np.arange(t_count)[:, None].repeat(ra.shape[1], 1)
    for slots in (sk, smk):
        keep = slots >= 0
        np.add.at(filled, (t[keep], slots[keep]), 1)
    assert (filled == 1).all()
    k_of_pair = ti + (wi * s0 if r0 == 8 else 0)
    keep = sk >= 0
    assert np.array_equal(points[t[keep], sk[keep]], k_of_pair[keep])
    assert (ra < rpidx(np.array(m))).all() and (rc < rpidx(np.array(m))).all()
    counts = np.bincount(np.concatenate([ra[keep], rc[keep]]), minlength=rpidx(np.array(m)))
    if r0 == 8:
        twice = rpidx(rdigit_rev(log_m, np.array([0, m // 2])))
        assert (counts[twice] == 2).all() and np.delete(counts, twice).max() == 1
    else:
        assert counts.max() == 2
    writes = rpidx(points)
    own = [set(ra[i]) | set(rc[i]) for i in range(t_count)]
    assert any(not set(writes[i]) <= own[i] for i in range(t_count))


@pytest.mark.parametrize("log_m", LOG_MS)
def test_plan_geometry_fits(log_m):
    """K1's tile (`mapt::Geometry`) with the frame buffers, the twiddle
    tables and the segment only: at most 227 KB a block at every hop the
    radix gate admits, and at n_fft 4096, hop 512 two blocks an SM."""
    g = Geometry(log_m, 1)
    n_fft = 2 * g.M
    seg_off = 8 * ((g.FT * g.FS + g.M + 1) & ~1)
    for hop in (128 * r for r in range(1, 9)):
        if hop > n_fft or n_fft % hop or n_fft // hop > 8:
            continue
        smem = seg_off + 4 * (((g.FT - 1) * hop + n_fft + 3 + 3) & ~3)
        assert smem <= SMEM_LIMIT, (hop, smem)
        if (log_m, hop) == (11, 512):
            assert smem == 108592 and SM_SMEM // (smem + BLOCK_RESERVED) == 2


DEGENERATE = {
    "silence": lambda t: np.zeros_like(t),
    "onset": lambda t: np.where(t < t[len(t) // 2], 0.0, np.sin(2 * np.pi * 220 * t)),
    "constant": lambda t: np.full_like(t, 0.9),
    "piecewise": lambda t: np.where(t < t[len(t) // 2], 0.9, -0.9),
    "dc-offset": lambda t: 0.9 + 0.001 * np.sin(2 * np.pi * 330 * t),
    "large-dc-offset": lambda t: 100.0 + 0.1 * np.sin(2 * np.pi * 330 * t),
}


@pytest.mark.parametrize("case", list(DEGENERATE))
def test_plan_keeps_the_noise_gate(case):
    """Lag 0 from the inverse FFT moves no degenerate frame's mask: the
    model's uncentred ACF through the centering algebra gives the masks
    and the normalized ACF of the twin's, at the defaults (frame 2048, hop
    512, lags 11..441, a centre pad of zeros)."""
    W, hop, lo, hi = 2048, 512, 11, 442
    t = np.arange(22050) / 22050
    y = torch.from_numpy(np.pad(DEGENERATE[case](t), (W // 2, W // 2)).astype(F32))[None]
    yc, ypad = tap_pitch._acf_prep(y, frame_length=W, hop_length=hop)
    win = np.zeros(2 * W, F32)
    win[:W] = 1.0
    frames = np.lib.stride_tricks.sliding_window_view(ypad[0].numpy(), 2 * W)[::hop]
    got = torch.from_numpy(model_acf(np.ascontiguousarray(frames), win, lo, hi).T[None].copy())
    ref = k1.acf_plain(ypad, torch.from_numpy(win), n_fft=2 * W, hop_length=hop, lo=lo, hi=hi)
    kw = dict(frame_length=W, hop_length=hop, lo=lo, hi=hi)
    s_m, v_m = tap_pitch._acf_center_correct(yc, ypad, got, **kw)
    s_t, v_t = tap_pitch._acf_center_correct(yc, ypad, ref, **kw)
    assert torch.equal(v_m, v_t)
    assert float((s_m - s_t).abs().max()) <= 1e-4
