#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card of compute capability 9.0 and nvcc (CUDA_HOME or
/usr/local/cuda). Phases, in order; any failure raises and exits non-zero:

1. environment: the card, its power limit, TF32 off;
2. build: nvcc compiles the four kernels from ``csrc/`` (timed);
3. each kernel against its plain PyTorch twin on the card, at the main
   path's shapes, with its launch counter checked;
4. the public main path on CUDA tensors, with every launch counter reset
   just before and read just after: log-mel (``power_to_db(melspectrogram)``)
   at the headline (64 x 1 s) and scale (256 x 4 s) configurations against
   a float64 CPU oracle, the 30 s ``stft`` -> ``istft`` round trip, an
   ``istft`` at hop 441 (the overlap-add tier), and one gradient;
5. CUDA-event times of the kernel path and the plain path.

The last two lines of standard output are the card's name and power limit
(as ``nvidia-smi`` prints them) and ``{"ok": true, "device": {...}}``; the
line before them is a JSON object with one entry per kernel.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SR = 22050
N_FFT = 2048
HOP = 512
N_MELS = 128
HEADLINE = (64, SR)  # 64 clips of 1 s
SCALE = (256, 4 * SR)  # 256 clips of 4 s
LONG = 30 * SR  # the 30 s round-trip clip
OLA_HOP = 441  # a hop outside the radix gate: istft takes the overlap-add tier


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def _host64(a: torch.Tensor) -> torch.Tensor:
    a = a.detach().cpu()
    return a.to(torch.complex128) if a.is_complex() else a.double()


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, complex-aware."""
    a, b = _host64(a), _host64(b)
    return float((a - b).abs().max() / b.abs().max())


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((_host64(a) - _host64(b)).abs().max())


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def environment() -> str:
    phase("1. environment")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs the port on an H100")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"need compute capability (9, 0), got {cap}")
    if os.environ.get("MLX_AUDIO_TPU_DISABLE_PALLAS"):
        raise RuntimeError("MLX_AUDIO_TPU_DISABLE_PALLAS is set: the kernels would not run")
    line = gpu_line()
    print("card:", line)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "python", sys.version.split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul", torch.backends.cuda.matmul.allow_tf32,
          "cudnn", torch.backends.cudnn.allow_tf32)
    return line


def build() -> None:
    phase("2. build")
    from mlx_audio_primitives_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_info['seconds']:.2f} s) "
          f"in {_build.build_info['dir']}")
    for ln in _build.build_info.get("log", "").splitlines():
        if re.search(r"Function properties|registers|spill", ln):
            print("  ptxas:", ln.strip())


def kernels_vs_plain(gen: torch.Generator) -> dict:
    """Phase 3: each kernel against its plain twin; returns max errors."""
    phase("3. kernels against their plain twins")
    from mlx_audio_primitives_tpu_torch.kernels import istft_fused as k3
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.kernels import overlap_add as k4
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
    from mlx_audio_primitives_tpu_torch.ops.mel import mel_filterbank
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window, _istft_envelope_table

    dev = torch.device("cuda", 0)
    win = _get_padded_window("hann", N_FFT, N_FFT, dev)
    fb_t = mel_filterbank(SR, N_FFT, N_MELS, device=dev).t().contiguous()
    kw = dict(n_fft=N_FFT, hop_length=HOP, center=True, pad_mode="constant")
    errs: dict[str, float] = {}

    def run(kernel, fn, *args, **kwargs):
        before = kernel.launches
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1, f"{kernel.name}: launch counter did not rise")
        return out

    # K1: headline at power 2 and 1, scale at power 2; <= 1e-5 of max
    for shape, power in ((HEADLINE, 2.0), (HEADLINE, 1.0), (SCALE, 2.0)):
        y = torch.randn(shape, generator=gen, device=dev)
        got = run(k1.KERNEL, k1.melspectrogram_fused, y, win, fb_t, power=power, **kw)
        ref = k1.melspectrogram_plain(y, win, fb_t, power=power, **kw)
        e = rel_err(got, ref)
        print(f"K1 mel_fused {shape} power={power}: rel err {e:.3e} (limit 1e-5)")
        check(got.shape == ref.shape and e <= 1e-5, "K1 disagrees with its plain twin")
        errs[k1.KERNEL.name] = max(errs.get(k1.KERNEL.name, 0.0), abs_err(got, ref))

    # K2: one 30 s clip and the headline batch; <= 1e-5 of max |S|
    for shape in ((1, LONG), HEADLINE):
        y = torch.randn(shape, generator=gen, device=dev)
        got = run(k2.KERNEL, k2.stft_fused, y, win, **kw)
        ref = k2.stft_plain(y, win, **kw)
        e = rel_err(got, ref)
        print(f"K2 stft {shape}: rel err {e:.3e} (limit 1e-5)")
        check(got.shape == ref.shape and e <= 1e-5, "K2 disagrees with its plain twin")
        errs[k2.KERNEL.name] = max(errs.get(k2.KERNEL.name, 0.0), abs_err(got, ref))

    # K3: on K2's 30 s output; <= 1e-5 abs over the samples istft returns.
    # The centre pad it trims holds the first and last half frames, where the
    # envelope is clamped to 1e-8 and rounding is amplified up to 1e8-fold.
    y = torch.randn((1, LONG), generator=gen, device=dev)
    S = k2.stft_fused(y, win, **kw).transpose(1, 2)
    T = LONG + N_FFT
    env = _istft_envelope_table(("hann", None), N_FFT, N_FFT, S.shape[1], HOP, T, device=dev)
    kw3 = dict(n_fft=N_FFT, hop_length=HOP, padded_length=T)
    got = run(k3.KERNEL, k3.istft_fused, S, win, env, **kw3)
    ref = k3.istft_plain(S, win, env, **kw3)
    keep = slice(N_FFT // 2, N_FFT // 2 + LONG)
    e = abs_err(got[:, keep], ref[:, keep])
    print(f"K3 istft_fused 30 s: abs err {e:.3e} on the kept samples (limit 1e-5), "
          f"{rel_err(got, ref):.3e} of max over the whole padded output")
    check(got.shape == ref.shape and e <= 1e-5, "K3 disagrees with its plain twin")
    errs[k3.KERNEL.name] = e

    # K4: n_fft 2048, hop 441 on windowed frames of a 30 s clip; <= 1e-6 abs
    frames = torch.fft.irfft(k2.stft_plain(y, win, n_fft=N_FFT, hop_length=OLA_HOP, center=True,
                                           pad_mode="constant").transpose(1, 2), n=N_FFT) * win
    frames = frames.contiguous()
    T = LONG + N_FFT
    env = _istft_envelope_table(("hann", None), N_FFT, N_FFT, frames.shape[1], OLA_HOP, T,
                                device=dev)
    kw4 = dict(hop_length=OLA_HOP, output_length=T)
    got = run(k4.KERNEL, k4.overlap_add_fused, frames, env, **kw4)
    ref = k4.overlap_add_plain(frames, env, **kw4)
    e = abs_err(got, ref)
    print(f"K4 overlap_add hop {OLA_HOP}: abs err {e:.3e} (limit 1e-6)")
    check(got.shape == ref.shape and e <= 1e-6, "K4 disagrees with its plain twin")
    errs[k4.KERNEL.name] = e

    # K1-K3 across the rest of the radix gate: other sizes, pad modes,
    # center=False, a clip shorter than the reflect pad, and column counts
    # that are not whole 128-column tiles; same limits
    for n_fft, hop, pad_mode, center, shape, n_cols in (
        (256, 128, "constant", True, (3, 5000), 40),
        (512, 128, "reflect", True, (2, 20000), 200),
        (1024, 256, "edge", True, (2, 20000), 1),
        (1024, 512, "constant", False, (2, 20000), 128),
        (2048, 512, "reflect", True, (2, 1000), 128),
        (4096, 1024, "reflect", True, (2, 50000), 128),
        (8192, 1024, "constant", True, (2, 50000), 96),
    ):
        y = torch.randn(shape, generator=gen, device=dev)
        w = _get_padded_window("hann", n_fft, n_fft, dev)
        fbt = torch.rand((n_fft // 2 + 1, n_cols), generator=gen, device=dev)
        kwx = dict(n_fft=n_fft, hop_length=hop, center=center, pad_mode=pad_mode)
        got = run(k1.KERNEL, k1.melspectrogram_fused, y, w, fbt, **kwx)
        e1 = rel_err(got, k1.melspectrogram_plain(y, w, fbt, **kwx))
        Sx = run(k2.KERNEL, k2.stft_fused, y, w, **kwx)
        e2 = rel_err(Sx, k2.stft_plain(y, w, **kwx))
        Sx = Sx.transpose(1, 2)
        T = n_fft + (Sx.shape[1] - 1) * hop
        env = _istft_envelope_table(("hann", None), n_fft, n_fft, Sx.shape[1], hop, T, device=dev)
        kw3 = dict(n_fft=n_fft, hop_length=hop, padded_length=T)
        got = run(k3.KERNEL, k3.istft_fused, Sx, w, env, **kw3)
        keep = slice(n_fft // 2, T - n_fft // 2)
        e3 = abs_err(got[:, keep], k3.istft_plain(Sx, w, env, **kw3)[:, keep])
        print(f"n_fft {n_fft} hop {hop} {pad_mode} center={center} {shape} cols {n_cols}: "
              f"K1 rel {e1:.3e}, K2 rel {e2:.3e}, K3 abs {e3:.3e}")
        check(e1 <= 1e-5 and e2 <= 1e-5 and e3 <= 1e-5, "a kernel disagrees with its plain twin")
    return errs


def mel_oracle(y: torch.Tensor) -> torch.Tensor:
    """float64 CPU mel spectrogram: constant centre pad, periodic Hann,
    rfft, |X|^2, Slaney mel filterbank (host float64 tables)."""
    from mlx_audio_primitives_tpu_torch.ops.mel import _mel_filterbank_table
    from mlx_audio_primitives_tpu_torch.ops.windows import window_host

    y64 = torch.nn.functional.pad(y.double().cpu(), (N_FFT // 2, N_FFT // 2))
    frames = y64.unfold(-1, N_FFT, HOP) * torch.from_numpy(window_host("hann", N_FFT))
    p = torch.fft.rfft(frames).abs() ** 2
    fb = torch.from_numpy(_mel_filterbank_table.host(SR, N_FFT, N_MELS, 0.0, SR / 2.0, False, "slaney"))
    return torch.matmul(p, fb.T).transpose(1, 2)


def main_path(gen: torch.Generator) -> dict:
    """Phase 4: the public entry points on CUDA tensors."""
    phase("4. public main path on cuda tensors")
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    inputs = {name: torch.randn(shape, generator=gen, device=dev)
              for name, shape in (("headline", HEADLINE), ("scale", SCALE))}
    y_long = torch.randn(LONG, generator=gen, device=dev)
    y_grad = torch.randn((2, SR), generator=gen, device=dev)
    for k in _build.KERNELS:
        k.launches = 0

    results = {}
    for name, y in inputs.items():
        mel = ap.melspectrogram(y, sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS)
        db = ap.power_to_db(mel)
        torch.cuda.synchronize()
        results[name] = (y, mel, db)
    S = ap.stft(y_long, n_fft=N_FFT, hop_length=HOP)
    rec = ap.istft(S, hop_length=HOP, length=LONG)
    S441 = ap.stft(y_long, n_fft=N_FFT, hop_length=OLA_HOP)
    rec441 = ap.istft(S441, hop_length=OLA_HOP, length=LONG)
    yg = y_grad.clone().requires_grad_(True)
    ap.melspectrogram(yg, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS).sum().backward()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _build.KERNELS}
    print("launches on the main path:", launches)
    for name, n in launches.items():
        check(n >= 1, f"{name} was not launched on the main path")

    for name, (y, mel, db) in results.items():
        check(mel.shape == (y.shape[0], N_MELS, 1 + y.shape[1] // HOP), f"{name}: mel shape {tuple(mel.shape)}")
        check(bool(torch.isfinite(db).all()), f"{name}: non-finite dB")
        ref = mel_oracle(y)
        e_mel = rel_err(mel, ref)
        mel64 = mel.double().cpu()
        db_ref = 10.0 * torch.log10(torch.clamp(mel64, min=1e-10))
        db_ref = torch.maximum(db_ref, db_ref.max() - 80.0)
        e_db = abs_err(db, db_ref)
        print(f"{name} {tuple(y.shape)}: mel rel err vs f64 oracle {e_mel:.3e} (limit 1e-4), "
              f"dB abs err vs f64 {e_db:.3e} dB (limit 2e-5)")
        check(e_mel <= 1e-4, f"{name}: mel misses its contract")
        check(e_db <= 2e-5, f"{name}: dB misses its contract")

    e_rt = abs_err(rec, y_long)
    e_441 = abs_err(rec441, y_long)
    print(f"30 s stft -> istft round trip: max abs err {e_rt:.3e} (limit 1e-5)")
    print(f"30 s round trip at hop {OLA_HOP} (overlap-add tier): max abs err {e_441:.3e} (limit 1e-5)")
    check(rec.shape == y_long.shape and e_rt <= 1e-5, "round trip misses 1e-5")
    check(rec441.shape == y_long.shape and e_441 <= 1e-5, "hop-441 round trip misses 1e-5")

    yp = y_grad.clone().requires_grad_(True)
    ap.melspectrogram(yp, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS, use_pallas=False).sum().backward()
    e_g = rel_err(yg.grad, yp.grad)
    print(f"gradient (2, {SR}): kernel path vs plain path rel err {e_g:.3e} (limit 1e-4)")
    check(e_g <= 1e-4, "gradient disagrees")
    return launches


def times(gen: torch.Generator, card: str) -> dict:
    """Phase 5: CUDA-event medians, kernel path against plain path."""
    phase(f"5. times (CUDA-event medians after warm-up, ms) on {card}")
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch.kernels import istft_fused as k3
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.kernels import overlap_add as k4
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
    from mlx_audio_primitives_tpu_torch.ops.mel import mel_filterbank
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window, _istft_envelope_table

    dev = torch.device("cuda", 0)
    y_head = torch.randn(HEADLINE, generator=gen, device=dev)
    y_scale = torch.randn(SCALE, generator=gen, device=dev)
    y_long = torch.randn((1, LONG), generator=gen, device=dev)
    mel_kw = dict(sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS)
    S = ap.stft(y_long, n_fft=N_FFT, hop_length=HOP)
    out = {}
    for label, fn in (
        ("headline mel+dB", lambda up: ap.power_to_db(ap.melspectrogram(y_head, use_pallas=up, **mel_kw))),
        ("scale mel+dB", lambda up: ap.power_to_db(ap.melspectrogram(y_scale, use_pallas=up, **mel_kw))),
        ("30 s stft", lambda up: ap.stft(y_long, n_fft=N_FFT, hop_length=HOP, use_pallas=up)),
        ("30 s istft", lambda up: ap.istft(S, hop_length=HOP, length=LONG, use_pallas=up)),
    ):
        plain_a = cuda_ms(lambda: fn(False))
        kern_a = cuda_ms(lambda: fn(None))
        kern_b = cuda_ms(lambda: fn(None))
        plain_b = cuda_ms(lambda: fn(False))
        print(f"{label}: kernel path {kern_a:.4f} / {kern_b:.4f}, plain path {plain_a:.4f} / {plain_b:.4f}")

    # each kernel alone against its plain twin, at the main path's shapes
    win = _get_padded_window("hann", N_FFT, N_FFT, dev)
    fb_t = mel_filterbank(SR, N_FFT, N_MELS, device=dev).t().contiguous()
    kw = dict(n_fft=N_FFT, hop_length=HOP, center=True, pad_mode="constant")
    St = S.transpose(1, 2)
    T = LONG + N_FFT
    env = _istft_envelope_table(("hann", None), N_FFT, N_FFT, St.shape[1], HOP, T, device=dev)
    frames = (torch.fft.irfft(ap.stft(y_long, n_fft=N_FFT, hop_length=OLA_HOP).transpose(1, 2), n=N_FFT)
              * win).contiguous()
    env441 = _istft_envelope_table(("hann", None), N_FFT, N_FFT, frames.shape[1], OLA_HOP, T, device=dev)
    cases = (
        (k1, "scale (256, 88200)", lambda: k1.melspectrogram_fused(y_scale, win, fb_t, **kw),
         lambda: k1.melspectrogram_plain(y_scale, win, fb_t, **kw)),
        (k2, "30 s clip", lambda: k2.stft_fused(y_long, win, **kw), lambda: k2.stft_plain(y_long, win, **kw)),
        (k3, "30 s clip", lambda: k3.istft_fused(St, win, env, n_fft=N_FFT, hop_length=HOP, padded_length=T),
         lambda: k3.istft_plain(St, win, env, n_fft=N_FFT, hop_length=HOP, padded_length=T)),
        (k4, f"30 s clip, hop {OLA_HOP}", lambda: k4.overlap_add_fused(frames, env441, hop_length=OLA_HOP, output_length=T),
         lambda: k4.overlap_add_plain(frames, env441, hop_length=OLA_HOP, output_length=T)),
    )
    for mod, shape, kern, plain in cases:
        p_a, k_a, k_b, p_b = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        print(f"{mod.KERNEL.name} at {shape}: kernel {k_a:.4f} / {k_b:.4f}, plain {p_a:.4f} / {p_b:.4f}")
        out[mod.KERNEL.name] = (statistics.median([k_a, k_b]), statistics.median([p_a, p_b]))
    return out


def main() -> None:
    card = environment()
    build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = kernels_vs_plain(gen)
    launches = main_path(gen)
    timing = times(gen, card)

    from mlx_audio_primitives_tpu_torch.kernels import _build

    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": launches[k.name], "max_abs_err": errs[k.name],
         "ms": timing[k.name][0], "plain_ms": timing[k.name][1]}
        for k in _build.KERNELS
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
