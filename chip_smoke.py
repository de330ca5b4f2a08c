#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
``python3 chip_smoke.py --host-path DIR`` prints only the STFT wrapper's host
time per call for the port package under DIR (an unpacked earlier commit,
say), for comparing two wrappers on one card; ``--k1-split DIR`` likewise
prints only phase 5's device times of K1 and K2m, ``--k3-split DIR`` those
of K3, ``--k345-split DIR`` those of K3, K4 and K5 and the feature path's
time, ``--istft-ola DIR`` the public ``istft``'s times at hop 441, and
``--k1-ablations``, ``--k1-fast-ablations`` and ``--k3-ablations`` those
of K1's dense or fast entry or K3 with parts of their work left out, one at
a time; ``--acf-split DIR`` K1's ACF
entry's device time at the ACF shape with its registers and blocks an SM,
``--acf-ablations`` the same for variants of its source, and
``--pitch-split DIR`` ``pitch_detect_acf``'s kernel device time and route
times at 64 x 30 s.
It needs one CUDA card of compute capability 9.0 and nvcc (CUDA_HOME or
/usr/local/cuda). Phases, in order; any failure raises and exits non-zero:

1. environment: the card, its power limit, TF32 off;
2. build: nvcc compiles kernels K1-K6 from ``csrc/``, one process per
   source, all at once (timed, and each source's process); K1's
   mixed-radix entry's (K1m's) registers and spill bytes (a spill fails
   the run); each K2s instance's (the STFT kernel's statistics emit, one
   per FFT size, statistic and power: a spill fails the run); for each
   K1/K2/K2m instance, each instance of K1's fast and ACF entries and each K3
   instance (one per shape of the radix gate), ptxas's registers and spill
   bytes (a spill fails the run; for K3 also a stack frame), its threads,
   frames per tile, shared memory per block and resident blocks and warps
   per SM; for
   each K5 instance (k slots), its
   registers, stack frame and spill bytes (either fails the run); then the
   host table library and WAV codec from ``csrc/*.cpp`` with one g++ call
   (timed; the run fails unless it loads: a silent NumPy fallback would
   leave phase 4g's native path unexercised);
3. each kernel against its plain PyTorch twin on the card, at the main
   paths' shapes (K1 also at the feature path's 64 x 30 s), with its launch
   counter checked (K1 at each of its shapes through its dense entry,
   ``fast_gemm=False``, and its fast entry, bf16x3, each against its own
   twin, the fast one also within 3e-5 of max of float64, on the cached
   tables' transpose views, whose band plans the fast entry reads; the fast
   entry also on clips with inf and NaN samples (NaN in every column of
   each frame they reach, as the twin), on a cached table with an all-zero
   m-tile and on a W given per call, whose plan ``plan_of`` packs, and the
   128-mel plan's 73 of 520 blocks; K3 also through
   its natural-spectrum entries
   ``istft_fused_t`` / ``istft_fused_nat``; K2s's bandwidth, rolloff and
   flatness at 64 x 30 s against its twin and against float64 of K2m's
   magnitude; K1/K2/K2m also at the smallest
   n_fft, at frame counts that are not whole tiles and at odd clip
   lengths, K1 at column counts around its 16-column tiles; K3 on every
   shape of the radix gate, on both spectrum layouts; K5 on the default
   contrast bands and over k = 1..16 on random, tie-heavy and +-inf/NaN
   rows, held to its unmodified twin, NaN matching NaN; K6, the dB
   conversion, bit for bit at the log-mel cells' shapes, at a ``ref`` whose
   reciprocal rounds, on NaN, +inf and zeros, on an unaligned input and on a
   transposed mel; at Whisper large-v3's batch (64 x 30 s at 16 kHz, n_fft
   400, hop 160, 128 mels), K1m within 2e-5 of max of its twin (also with
   a W given per call) and K6's
   per-item form (a floor per clip, ``/ 40 + 1``) on the mel's
   ``[..., :-1]`` view bit for bit its twin, also with NaN and +inf;
   ``spectral_contrast`` on frames that hold NaN, card against CPU; K7,
   the frame statistics, at 64 x 30 s (frame 2048, hop 512), ZCR bit for
   bit its twin and RMS within 1e-6 of max, both pad modes and no centre
   pad, on clips with zeros, -0.0, NaN and +-inf, and at frame 400, hop
   160 on clips whose starts are not 16-byte aligned; K3, K4
   and K5 at 65,537 clips; K1 at the pitch ACF's shapes, n_fft 4096, hop
   512, no centre pad, the boxcar window, 432 and 331 lag-basis columns,
   64 x 30 s, through the dense entry and through the ACF entry (the
   inverse FFT in the kernel, no weight), each against its twin; the
   framewise ACF's K1 route (the ACF entry) against its plain route, on
   pitched clips and, through ``pitch_detect_acf``, on degenerate frames
   (silence, onset, constant, piecewise constant, DC offsets: masks and f0
   equal on the card's two routes and the CPU); one Griffin-Lim iteration,
   K3 -> K2 -> projection -> K3, against the twins; K1 with the 12-column
   chroma weight at 64 x 30 s, power 2 and power 1 with a detuned weight;
   K2 with the reassignment windows ``dh`` and ``th`` at 64 x 30 s, K3 on a
   phase-vocoded spectrum at rate 0.8 (1,615 frames, DC and Nyquist bins
   not real), K1 and K2 without a centre pad on one streaming push of 43
   frames at batch 64 and at batch 1; K1 on one pipeline batch of 16 x
   30 s and K1, K2 and K3 on warmup's 1 s clip);
4. the public main paths on CUDA tensors, each with every launch counter
   reset just before and read just after:
   a. log-mel (``power_to_db(melspectrogram)``, K1 then K6) at the headline (64 x 1 s)
      and scale (256 x 4 s) configurations against a float64 CPU oracle,
      under ``ANALYSIS_FAST_GEMM``'s default (K1's fast entry, as on every
      public path) and set to False (its dense entry),
      the 30 s ``stft`` -> ``istft`` round trip, an ``istft`` at hop 441
      (the overlap-add tier), and one gradient; then Whisper large-v3's
      front end (``whisper_v3_logmel()``) on 64 x 30 s at 16 kHz (K1m once,
      K6's per-item form twice) against a float64 oracle of Whisper's
      ``log_mel_spectrogram``;
   b. the spectral-feature path of a genre-tagging front end on 64 clips of
      30 s at 22,050 Hz (n_fft 2048, hop 512): MFCC (20) with deltas of
      order 1 and 2, centroid, bandwidth, rolloff, flatness, contrast,
      zero-crossing rate and RMS, the first 4 clips against a float64 CPU
      oracle, with its launches counted (K1 2, K2m 1, K2s 3, K5 4, K6 2,
      K7 2);
   c. ``istft`` and ``spectral_contrast`` on 65,537 small clips, past
      grid y's 65,535, with K3's and K5's launches counted;
   d. ``griffinlim`` at 64 x 30 s (32 iterations: K2 32 and K3 33
      launches) against the plain route, with its spectral convergence;
      ``griffinlim`` at hop 441 (K4 33 times); ``istft`` at hop 441 of a
      spectrum whose DC and Nyquist bins are not real, K4 tier and plain
      route against the CPU; ``mel_to_audio`` on 16 x 4 s
      (K2 32, K3 33); ``pitch_detect_acf`` and ``periodicity`` at 64 x 30 s
      (K1's ACF entry once each, dense K1 never) against a float64 oracle
      of the centered frame ACF;
      ``yin`` (no kernel) against a float64 YIN; ``piptrack`` (K2m once)
      against the CPU; ``resample`` kaiser_best on 64 x 1 s (44.1 -> 16
      kHz) and 64 x 30 s (22.05 -> 16 kHz) against scipy in float64 with
      the same FIR, and ``resample`` fft on 64 x 1 s (44.1 -> 16 kHz)
      against scipy's ``resample`` in float64;
   e. the rhythm-and-harmony path on 64 clips of 30 s made on the card
      (click tracks at tempi in 90-150 BPM over three-note chords and
      noise): ``onset_strength`` (K1 once) against a float64 envelope,
      ``chroma_stft`` (K1 once, 12 columns) against a float64 chromagram,
      ``cqt`` and ``chroma_cqt`` (no kernel) against a float64 CQT on the
      card, ``tempo`` of the envelopes against a float64 tempogram (and the
      click tempi), ``pcen`` of the mel (K1 once) against scipy's
      ``lfilter`` in float64, and ``beat_track`` on 4 clips (K1 once each)
      index-equal to a float64 Ellis DP;
   f. the effects, decomposition and streaming path on 64 clips of 30 s
      made on the card (steady harmonic tones, 1% noise, impulse clicks,
      two gaps of exact silence; ``EFFECTS_LAUNCHES``): ``harmonic`` +
      ``percussive`` (K2 and K3 once each) against the input, the median
      filter against a float64 median, ``time_stretch`` at 0.8 and 1.25
      against a float64 per-frame vocoder recurrence and ISTFT on the
      port's spectrum and at 1.0 against the input, ``pitch_shift`` by +-2
      steps against its plain route, ``reassigned_spectrogram`` (K2 three
      times) on the tones and clicks, ``pyin`` against a float64 run of the
      same algorithm on 4 clips, ``lpc`` against a float64 Burg, ``trim``
      and ``split`` against a float64 rms + dB, ``recurrence_matrix`` (a
      valid k-nearest selection of the float64 distances), ``nn_filter``
      and NMF on one clip (objective monotone), and every ``Streaming*``
      class at batch 64 in 30 pushes of 1 s against its offline op (K2 or
      K1 once a push);
   g. the utilities path: 64 stereo WAV files of 30 s at 44.1 kHz written
      with ``write_wav`` (16-bit PCM, one in eight 24-bit, one in eight
      float32) and read back with the native and the NumPy codec (bit-equal
      to each other and to the samples written); ``load`` of each at
      22,050 Hz (mono, kaiser_best on the card, no kernel) against scipy's
      ``resample_poly`` in float64 with the same FIR; ``batch_iterator`` ->
      ``prefetch_to_device`` -> ``power_to_db(melspectrogram)`` in batches
      of 16 (K1 once a batch), bit-equal to the same batches copied
      synchronously and against the float64 mel/dB oracle; ``warmup`` of
      the six ops at (1 s, 30 s) x (1, 64) (K1 24, K2 12, K3 6), twice;
      ``profile_section`` against ``cuda_ms``, the tracked transfers'
      bytes, a ``start_device_trace`` trace that names K1, and
      ``profile_memory`` of a 64 x 30 s mel beside
      ``estimate_operation_memory``; a ``table_cache(dtype=np.float64)``
      of the mel filterbank on the card (float64, bit-equal to its host
      table) and the op's own default cache (float32, the host table
      rounded once);
   h. ``parallel/`` and the conv trainers of ``models/`` at one rank: a
      world of one over NCCL (a ``FileStore`` in a temporary directory) and
      a ``(1, 1)`` mesh; ``logmel_time_sharded`` at 64 x 30 s with
      'pallas' (K1 once) against ``power_to_db(melspectrogram)`` and
      against 'matmul', ``stft_time_sharded`` -> ``istft_time_sharded``
      (K2 and K3 once each) against the input; the keyword spotter of
      ``examples/train_keyword_spotter.py`` (``TrainableLogMelFrontend``
      at 16 kHz, n_fft 512, hop 128, 40 mels; convs (16, 32), 4 classes)
      on 32 x 1 s: its mel and the first step's gradient, kernel route
      against plain route, leaf by leaf at the same activations (the net is
      ReLU: a rounding-sized change of its input can flip a unit and move
      the gradient of the layers below it past 1e-4), then 10 steps (K1
      once a step, the
      loss falls),
      and the same with ``TrainablePCENFrontend``;
      ``make_sharded_train_step`` at its defaults on 64 x 3.99 s with
      'pallas' (5 steps); ``make_tp_train_step`` on a (1, 1) mesh and
      ``make_pp_train_step`` on one stage (5 steps each) against
      ``make_convnet_train_step`` and ``deep_classifier_apply``; a
      checkpoint of the trained state, restored bit-equal; then (5h) the
      keyword-spotter step's CUDA-event times at batch 32 and 256 and the
      sharded log-mel's, kernel route against plain route, and (6f) one
      step at batch 256 under ``torch.profiler``; the process group is
      destroyed before phase 5;
   i. the expert-parallel and context-parallel trainers of ``models/`` at
      one rank, in a world of one over NCCL of their own: the Switch-MoE
      classifier at the JAX package's defaults (4 experts, 64 hidden,
      capacity factor 1.25) over the keyword spotter's frontend on 32 x
      1 s, 10 steps of ``make_ep_train_step`` (K1 once a step, the loss
      falls) against ``moe_classifier_apply`` on the same parameters, its
      first gradient kernel route against plain route at the same
      activations, 5 steps of ``make_ep_tp_train_step`` against the ep
      step; the transformer at ``make_cp_train_step``'s defaults on 32
      clips of 1,722 tokens with ``fft_mode='pallas'`` (10 steps, K1 once
      a step, the loss falls), its first step against
      ``single_device_cp_oracle`` and 'matmul' leaf by leaf, and
      ``ring_attention`` against ``_full_attention`` at
      ``(32, 1722, 4, 16)``; the convnet's forward with
      ``cudnn.allow_tf32`` at PyTorch's default (True) against float64 on
      the CPU; ``examples_torch/train_keyword_spotter.py`` at its
      defaults (K1 61, accuracy > 0.9); then (5i) the MoE step's
      CUDA-event times and peak memory at batch 32 and 256 and the cp
      step's, kernel route against plain route, and (6i) one cp step under
      ``torch.profiler``; the process group is destroyed before phase 5;
5. CUDA-event times of each path (kernels and plain), of the centroid
   against the route it does not take (K2m's magnitude and two
   reductions), of the bandwidth, rolloff and flatness against theirs
   (K2m's magnitude and the plain passes K2s replaces), of the ZCR and
   RMS against theirs (the plain passes K7 replaces), and of
   each kernel alone against its plain twin and, where one PyTorch call
   computes the same function, that call (K2 also at 64 x 30 s, against
   ``torch.stft``); each kernel's bound from the bytes and operations of
   its shapes (K1's contraction as three TF32 or bf16 tensor-core
   products of the dense weight: both entries' times at scale, 64 x 30 s
   and 12 columns, and the blocks the fast entry's plan contracts; K1m's
   and K6's per-item form's at Whisper's batch, K1m's device time too), timed
   plain, library, kernel, kernel, library, plain; the STFT wrapper's host
   time per call; device times of K2 and of ``torch.stft`` on one 30 s
   clip and at 64 x 30 s, of K2m, of K1 beside K2m on the same clips
   at the scale configuration and at 64 x 30 s, of K3 and K4 and of
   ``torch.istft`` and ``fold`` on one 30 s clip and at 64 x 30 s (with
   K3's launch plan and recompute share), and of K5 on each default
   contrast band; K3 and K4 are also timed at 64 x 30 s against their
   twins, library calls and bounds; the slice's paths: ``resample``
   kaiser_best 64 x 1 s (bench config 4), ``griffinlim`` 32 iterations plus
   ``yin`` on one 1 s clip (bench config 5), ``griffinlim`` and
   ``pitch_detect_acf`` at 64 x 30 s, kernel route against plain route,
   ``yin`` at 64 x 30 s, and at the ACF shape the device and CUDA-event
   times of K1's ACF entry beside the dense entry with the lag basis and
   the twin, with both bounds; the rhythm-and-harmony slice at 64 x 30 s: ``onset_strength``
   and ``chroma_stft`` (kernel route against plain route), ``tempo``,
   ``pcen`` and its scan, ``cqt`` and ``chroma_cqt`` with the CQT's peak
   memory, ``beat_track`` of one clip and its DP's host time, and K1's
   device time at the chroma shape with its bound; the effects slice at 64
   x 30 s: ``harmonic``, ``percussive``, ``time_stretch``, ``pitch_shift``
   and ``reassigned_spectrogram`` (kernel route against plain route),
   ``hpss``, ``pyin``, ``lpc``, ``trim``, ``split``, NMF, the recurrence
   and ``nn_filter`` on one clip, the peak memory of ``hpss``, ``pyin`` and
   ``nn_filter``, pYIN's CMND, observations, Viterbi and host backtrace,
   and ``StreamingLogMel.push``'s latency at batch 1 and 64; the
   utilities: one 30 s stereo file's decode and encode (native against
   NumPy), ``load`` per file, the prefetched and the synchronous
   pipelines in turns (wall and CUDA events), and ``warmup``'s first and
   second calls in this process and in a fresh one;
6. ``torch.profiler`` over the spectral-feature path, over
   ``griffinlim`` and over the rhythm-and-harmony path (onset, tempo, both
   chromagrams, PCEN of the mel) at 64 x 30 s (kernels and plain), over
   ``pcen`` alone, over ``harmonic``, ``time_stretch`` and ``pyin`` at
   64 x 30 s, and over the prefetched and the synchronous pipelines of
   phase 4g: device time by kernel, busy time and idle share.

The last two lines of standard output are the card's name and power limit
(as ``nvidia-smi`` prints them) and ``{"ok": true, "device": {...}}``; the
line before them is a JSON object with one entry per kernel.
"""

from __future__ import annotations

import importlib
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
FEATURES = (64, LONG)  # the spectral-feature path: 64 clips of 30 s
N_ORACLE = 4  # clips of the feature path held against the float64 oracle
BIG = 65537  # clips of the batch-size checks: past grid y's 65,535
SMALL = (256, 128)  # their n_fft and hop: 4 frames a clip of 384 samples
GL_ITERS = 32  # Griffin-Lim iterations (librosa's default)
MEL_AUDIO = (16, 4 * SR)  # mel_to_audio: 16 clips of 4 s
RESAMPLE_1S = (64, 44100)  # bench config 4: 64 clips of 1 s at 44.1 kHz -> 16 kHz
RHYTHM_BPM = (90.0, 150.0)  # the click tempi of phase 4e's clips, drawn per clip
#: the ACF's lag windows at sr 22,050, frame 2048: the defaults (fmin 50,
#: fmax 2000: lags 11..441, 432 weight columns) and YIN's band (fmin 65,
#: fmax 2093: lags 10..339, 331 columns)
ACF_BANDS = ((50.0, 2000.0), (65.0, 2093.0))

# Published H100 SXM peaks (NVIDIA data sheet) for each kernel's bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # dense, tensor cores

PEAK_BF16_FLOPS = 989e12  # dense, tensor cores

#: K1's entry on the public paths: the fast entry (bf16x3), which
#: ANALYSIS_FAST_GEMM selects by default; phase 4a also runs log-mel with it
#: set to False, on the dense entry (3xTF32)
K1_MAIN = "mel_fused_fast_kernel"
K1_EXACT = "mel_fused_kernel"
#: K6, the dB conversion: once a power_to_db / amplitude_to_db call on a
#: non-empty CUDA tensor with a scalar ref, twice with top_db (the maximum,
#: then the floor)
K6 = "db_fused_kernel"
#: Whisper large-v3's front end (``models/presets.py::whisper_v3_logmel``):
#: a batch of 64 windows of 30 s at 16 kHz, n_fft 400 at hop 160, 128 Slaney
#: mels to 8 kHz; K1's mixed-radix entry (K1m) once, K6's per-item form
#: twice (each clip's maximum, then the floor and ``/ 40 + 1``)
K1M = "mel_fused_mixed_kernel"
K6_ITEM = "db_item_kernel"
WHISPER = (64, 480_000)
WHISPER_SR = 16000
WHISPER_KW = dict(n_fft=400, hop_length=160, center=True, pad_mode="reflect", power=2.0)
WHISPER_LAUNCHES = {K1M: 1, K6_ITEM: 2}
#: the kernels each public path must launch
LOG_MEL_PATH = (K1_MAIN, K1_EXACT, K6, "stft_kernel", "istft_kernel", "overlap_add_kernel")
#: K7, the frame statistics: once a zero_crossing_rate / rms call on a
#: non-empty CUDA signal
K7 = "frame_stats_kernel"
FEATURE_PATH = (K1_MAIN, K6, "stft_mag_kernel", "stft_stats_kernel", "select_extremes_kernel", K7)
#: the feature path's launches: K1 for MFCC's mel and the centroid's
#: moments, K6 twice for MFCC's dB (top_db 80), K2m for contrast, K2s for
#: bandwidth, rolloff and flatness, K5 for the four contrast bands that
#: take it, K7 for ZCR and RMS
FEATURE_LAUNCHES = {K1_MAIN: 2, K6: 2, "stft_mag_kernel": 1, "stft_stats_kernel": 3,
                    "select_extremes_kernel": 4, K7: 2}
#: the rhythm-and-harmony path's launches per public call (phase 4e): K1
#: and K6 once for onset_strength's mel and its dB (so once for beat_track
#: of a signal),
#: once for chroma_stft's chroma weight and once for the mel PCEN takes;
#: none for the CQT family, whose n_fft 16384 is outside the radix gate,
#: or for tempo of an envelope
RHYTHM_LAUNCHES = {"onset_strength": {K1_MAIN: 1, K6: 1}, "chroma_stft": {K1_MAIN: 1},
                   "pcen": {K1_MAIN: 1}, "beat_track": {K1_MAIN: 1, K6: 1},
                   "cqt": {}, "chroma_cqt": {}, "tempo": {}}
#: the effects, decomposition and streaming path's launches per public call
#: (phase 4f; per push for the streams): K2 and K3 once each for the
#: STFT -> op -> ISTFT effects, K2 three times for the reassignment's
#: three windows, K2 once a push of the STFT stream and K1 once a push of
#: the mel and chroma streams (K6 too for the log-mel and MFCC streams' dB),
#: K7 and K6 once for trim's and split's frame RMS and its dB; none for the
#: rest, which run plain torch in either package
_K2_K3 = {"stft_kernel": 1, "istft_kernel": 1}
EFFECTS_LAUNCHES = {"harmonic": _K2_K3, "percussive": _K2_K3, "time_stretch": _K2_K3,
                    "pitch_shift": _K2_K3, "reassigned_spectrogram": {"stft_kernel": 3},
                    "StreamingSTFT": {"stft_kernel": 1}, "StreamingLogMel": {K1_MAIN: 1, K6: 1},
                    "StreamingMFCC": {K1_MAIN: 1, K6: 1}, "StreamingChroma": {K1_MAIN: 1},
                    "StreamingPCEN": {K1_MAIN: 1}, "StreamingISTFT": {}, "StreamingPitch": {},
                    "StreamingResample": {}, "pyin": {}, "lpc": {}, "trim": {K6: 1, K7: 1},
                    "split": {K6: 1, K7: 1},
                    "recurrence_matrix": {}, "nn_filter": {}, "decompose": {}}
#: the streams of phase 4f: 30 pushes of 1 s (43 hops) at batch 64
STREAM_CHUNK = 43 * HOP
STREAM_PUSHES = 30
#: phase 4g's loader: 64 stereo WAV files of 30 s at 44.1 kHz, loaded at
#: 22,050 Hz and fed to log-mel in batches of 16
LOADER_FILES = 64
LOADER_SR = 44100
LOADER_SECONDS = 30
PIPE_BATCH = 16
#: warmup's call in phase 4g: (1 s, 30 s) x batch (1, 64), all six ops
WARMUP_SHAPES = ((SR, LONG), (1, 64))
WARMUP_OPS = ("stft", "istft", "melspectrogram", "mfcc", "chroma_stft", "pcen")
#: warmup's launches per layout over the six ops: K2 for stft and for
#: istft's spectrum, K3 for istft, K1 for melspectrogram, mfcc, chroma_stft
#: and pcen's mel, K6 twice for mfcc's dB (top_db 80)
WARMUP_LAUNCHES = {K1_MAIN: 4, K6: 2, "stft_kernel": 2, "istft_kernel": 1}
#: phase 4h, parallel and training at one rank: the keyword spotter of
#: examples/train_keyword_spotter.py (16 kHz, n_fft 512, hop 128, 40 mels,
#: convs (16, 32), 4 classes) on 1 s clips, its steps timed at batch 32 and
#: 256; the sequence-parallel trainer at its defaults on 64 clips of 172
#: hops (3.99 s: its frames are uncentred, so a clip is whole hops); the
#: sequence-parallel frontend at the feature path's 64 x 30 s
KWS_FRONTEND = dict(sr=16000, n_fft=512, hop_length=128, n_mels=40)
KWS_NET = dict(n_classes=4, channels=(16, 32), lr=3e-2)
KWS_BATCH = (32, 256)
KWS_STEPS = 10
SP_TRAIN = (64, 172 * HOP)
SP_STEPS = 5
SP_LR = 1e-2
#: phase 4i, the expert-parallel and context-parallel trainers at one rank:
#: the Switch MoE classifier at the JAX package's defaults (4 experts, 64
#: hidden, capacity factor 1.25) over the keyword spotter's frontend, on
#: its 1 s clips at batch 32 (steps) and 32 and 256 (times); the
#: transformer at make_cp_train_step's defaults (22,050 Hz, n_fft 512, hop
#: 128, 64 mels, d_model 64, 4 heads, d_ff 128, 2 blocks, 10 classes) on 32
#: clips of 1,722 tokens (220,416 samples, ~10 s)
MOE = dict(n_experts=4, d_hidden=64, capacity_factor=1.25)
MOE_STEPS = 10
MOE_TP_STEPS = 5
CP = dict(sr=22050, n_fft=512, hop_length=128, n_mels=64)
CP_NET = dict(n_classes=10, d_model=64, n_heads=4, d_ff=128, n_blocks=2)
CP_TRAIN = (32, 1722 * 128)
CP_STEPS = 10
#: the keyword-spotter example at its documented defaults: 60 steps of
#: batch 32, then one evaluation batch (K1 and K6 once each)
KWS_EXAMPLE_LAUNCHES = {K1_MAIN: 61, K6: 61}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def _as64(a: torch.Tensor, device: torch.device) -> torch.Tensor:
    a = a.detach().to(device)
    return a.to(torch.complex128) if a.is_complex() else a.double()


def _pair64(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both in float64 (complex128), on the card when both lie there."""
    dev = a.device if a.device == b.device else torch.device("cpu")
    return _as64(a, dev), _as64(b, dev)


def exact_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| of two float32 tensors over the elements whose bits
    differ, NaN matching NaN; an infinity or a NaN against anything else
    counts as inf. 0.0 where the two agree bit for bit."""
    same = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
    d = torch.nan_to_num((a.double() - b.double()).abs(), nan=float("inf"))
    d = torch.where(same, torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, complex-aware."""
    a, b = _pair64(a, b)
    return float((a - b).abs().max() / b.abs().max())


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = _pair64(a, b)
    return float((a - b).abs().max())


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


def host_us(fn, calls: int = 1000, runs: int = 5) -> float:
    """Host microseconds per call of ``fn()``: the median over ``runs`` runs
    of ``calls`` calls that are not synchronised (the enqueue cost), each
    run after a synchronised warm-up. The host's cores are shared, so single
    runs vary by tens of percent."""
    per_run = []
    for _ in range(runs):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_run.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return statistics.median(per_run)


def kernel_device_ms(fn, kernel: str | None, calls: int = 20) -> float:
    """Device time (ms) per call of ``fn()`` over ``calls`` calls, from
    ``torch.profiler``: the mean of the launches of ``kernel`` it records
    (each call launches it once; the profiler now and then misses a few of
    them, which is reported, and once saw none of a window's 20, so a
    window that records none is profiled once more, and reported), or of
    every device operation the call runs when ``kernel`` is None (a library
    call). The host path, which the CUDA-event time of one small call
    includes, is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and (kernel is None or re.search(rf"::{kernel}[<(]", e.name))]
        if kernel is None or us:
            break
        print(f"(the profiler recorded none of the {calls} launches of {kernel}"
              f"{'; profiling the window once more' if attempt == 0 else ''})")
    if kernel is None:
        return sum(us) / 1e3 / calls
    check(0 < len(us) <= calls, f"the profiler saw {len(us)} launches of {kernel} in {calls} calls")
    if len(us) < calls:
        print(f"(the profiler recorded {len(us)} of the {calls} launches of {kernel}; "
              f"the mean is over those)")
    return sum(us) / 1e3 / len(us)


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
    by_source = _build.build_info.get("seconds_by_source", {})
    print("nvcc seconds by source:", ", ".join(f"{k} {v:.2f}" for k, v in by_source.items()))
    log = _build.build_info.get("log", "")
    summed = False  # K5's 16 and K2s's 35 instances are summed up below
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            summed = "select_extremes_kernel" in ln or "stft_stats_kernel" in ln
        if not summed and re.search(r"Function properties|registers|spill", ln):
            print("  ptxas:", ln.strip())
    fft_occupancy(log)
    k2s_instances(log)
    k1m_instance(log)
    k5_instances(log)
    k5_sass()
    # the host table library and WAV codec: one g++ call, or a silent
    # NumPy fallback, which would leave phase 4g's native path unexercised
    from mlx_audio_primitives_tpu_torch import _native

    t0 = time.perf_counter()
    ok = _native.HAS_NATIVE and _native.has_native_wav()
    print(f"native table library and WAV codec: {time.perf_counter() - t0:.2f} s "
          f"(g++ {_native.build_info.get('seconds', 0.0):.2f} s) at {_native.build_info.get('path')}")
    check(ok, f"the native library did not load: {_native.build_info.get('error')}")


def k1m_instance(log: str) -> None:
    """K1m's instance (n_fft 400): ptxas's registers and spill bytes. Fails
    on a spill."""
    regs = spill = None
    entry = False
    for ln in log.splitlines():
        if "Function properties for" in ln:
            entry = f"{K1M}ILi400E" in ln
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and entry:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            regs, entry = int(m.group(1)), False
    check(regs is not None and spill is not None, f"ptxas reported no {K1M} instance at n_fft 400")
    print(f"  {K1M} n_fft 400: {regs} registers, {spill} bytes spilled")
    check(spill == 0, f"{K1M} spills at n_fft 400")


K2S_STATS = {0: "bandwidth", 1: "rolloff", 2: "flatness"}


def k2s_instances(log: str) -> None:
    """K2s per instance (FFT size, statistic, power: bandwidth and flatness
    at 1 and 2, rolloff one): ptxas's registers and spill bytes, and per FFT
    size its threads and resident warps per SM at the hop the sizes run
    with here. Fails on a spill."""
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2

    rows, entry, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?stft_stats_kernelILi(\d+)ELi(\d)ELi(\d)E", ln)
        if m:
            entry = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and entry:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            rows[entry] = (int(m.group(1)), spill)
            entry, spill = None, 0
    check(len(rows) == 35, f"ptxas reported {len(rows)} K2s instances, expected 35")
    dev = torch.device("cuda", 0)
    for n_fft in (128, 256, 512, 1024, 2048, 4096, 8192):
        hop = HOP if n_fft == N_FFT else min(1024, max(128, n_fft // 4))
        g = k2.launch_geometry(n_fft, hop, dev)
        per_sm = g["blocks_per_sm"][k2.KERNEL_STATS.name]
        print(f"  {k2.KERNEL_STATS.name} n_fft {n_fft} hop {hop}: "
              + ", ".join(f"{K2S_STATS[st]}{'' if st == 1 else f' p{pw}'} {r} registers {sp} B "
                          f"spilled" for (lm, st, pw), (r, sp) in sorted(rows.items())
                          if lm == n_fft.bit_length() - 2)
              + f"; {g['threads']} threads, {per_sm * g['threads'] // 32} warps per SM")
    spilled = sorted(k for k, (_, sp) in rows.items() if sp)
    check(not spilled, f"K2s spills in the instances (log2 M, statistic, power) {spilled}")


def k5_instances(log: str) -> None:
    """K5 per instance (k slots): ptxas's registers, stack frame and spill
    bytes. Fails on a spill, or on a stack frame, which means
    a register array was left in local memory."""
    rows, entry, frame = {}, None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?select_extremes_kernelILi(\d+)E", ln)
        if m:
            entry = int(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and entry:
            frame = (int(m.group(1)), int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            rows[entry] = (int(m.group(1)), *frame)
            entry, frame = None, (0, 0)
    check(len(rows) == 16, f"ptxas reported {len(rows)} K5 instances, expected 16")
    print("  select_extremes_kernel k = 1..16: registers "
          + " ".join(str(rows[k][0]) for k in range(1, 17))
          + f"; stack frame max {max(r[1] for r in rows.values())} B, "
          f"spill max {max(r[2] for r in rows.values())} B")
    check(all(r[1] == 0 and r[2] == 0 for r in rows.values()),
          "a K5 instance has a stack frame or spills")


def ptxas_rows(log: str) -> dict:
    """ptxas's registers, spill bytes and stack frame bytes of each K1, K2,
    K2m and K3 instance, keyed by (kernel name, log2 of the complex FFT
    size), and for K3 also by n_fft / hop."""
    names = {"mel_fused_kernelI": "mel_fused_kernel", "mel_fused_acf_kernelI": "mel_fused_acf_kernel",
             "mel_fused_fast_kernelI": "mel_fused_fast_kernel",
             "stft_kernelI6float2": "stft_kernel", "stft_kernelIf": "stft_mag_kernel",
             "istft_kernelI": "istft_kernel"}
    rows, entry, spill, frame = {}, None, 0, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(mel_fused_kernelI|mel_fused_acf_kernelI|"
                      r"mel_fused_fast_kernelI|"
                      r"stft_kernelI6float2|stft_kernelIf|istft_kernelI)Li(\d+)E(?:Li(\d+)E)?", ln)
        if m:
            entry = (names[m.group(1)], int(m.group(2))) + ((int(m.group(3)),) if m.group(3) else ())
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and entry:
            frame, spill = int(m.group(1)), int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            rows[entry] = (int(m.group(1)), spill, frame)
            entry, spill, frame = None, 0, 0
    return rows


def fft_occupancy(log: str) -> None:
    """K1, K2 and K2m per FFT size, and K3 per FFT size and hop: registers
    and spill bytes (ptxas; K3 also its stack frame), threads, frames per
    tile, shared memory per block and resident warps per SM at the hop the
    sizes run with here. Fails on any spill (and on a K3 stack frame)."""
    from mlx_audio_primitives_tpu_torch.kernels import istft_fused as k3
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2

    rows = ptxas_rows(log)
    check(len(rows) == 35 + len(RADIX_GATE),
          f"ptxas reported {len(rows)} K1/K2/K2m/K3 instances, expected {35 + len(RADIX_GATE)}")
    dev = torch.device("cuda", 0)
    for n_fft in (128, 256, 512, 1024, 2048, 4096, 8192):
        hop = HOP if n_fft == N_FFT else min(1024, max(128, n_fft // 4))
        g2 = k2.launch_geometry(n_fft, hop, dev)
        g1 = k1.launch_geometry(n_fft, hop, dev)
        g1f = k1.launch_geometry(n_fft, hop, dev, fast=True)
        for name, g, per_sm in ((k1.KERNEL.name, g1, g1["blocks_per_sm"]),
                                (k1.KERNEL_FAST.name, g1f, g1f["blocks_per_sm"]),
                                (k2.KERNEL.name, g2, g2["blocks_per_sm"][k2.KERNEL.name]),
                                (k2.KERNEL_MAG.name, g2, g2["blocks_per_sm"][k2.KERNEL_MAG.name])):
            regs, spill, _ = rows[(name, n_fft.bit_length() - 2)]
            print(f"  {name} n_fft {n_fft} hop {hop}: {regs} registers, {spill} bytes spilled, "
                  f"{g['threads']} threads x {g['frames_per_tile']} frames per tile, "
                  f"{g['smem_bytes']} B shared per block, {per_sm} blocks and "
                  f"{per_sm * g['threads'] // 32} warps per SM")
            check(spill == 0, f"{name} spills at n_fft {n_fft}")
    # K1 at the pitch ACF's shape: the n_fft 4096 instance (above) at hop 512,
    # and the ACF entry's instances (at hop 512 where n_fft is 4096)
    g = k1.launch_geometry(4096, HOP, dev)
    print(f"  {k1.KERNEL.name} n_fft 4096 hop {HOP} (the pitch ACF): the instance above, "
          f"{g['threads']} threads x {g['frames_per_tile']} frames per tile, {g['smem_bytes']} B "
          f"shared per block, {g['blocks_per_sm'] * g['threads'] // 32} warps per SM")
    for n_fft in (128, 256, 512, 1024, 2048, 4096, 8192):
        hop = HOP if n_fft == 4096 else min(1024, max(128, n_fft // 4))
        g = k1.launch_geometry(n_fft, hop, dev, acf=True)
        regs, spill, _ = rows[(k1.KERNEL_ACF.name, n_fft.bit_length() - 2)]
        print(f"  {k1.KERNEL_ACF.name} n_fft {n_fft} hop {hop}: {regs} registers, {spill} bytes "
              f"spilled, {g['threads']} threads x {g['frames_per_tile']} frames per tile, "
              f"{g['smem_bytes']} B shared per block, {g['blocks_per_sm'] * g['threads'] // 32} "
              f"warps per SM")
        check(spill == 0, f"{k1.KERNEL_ACF.name} spills at n_fft {n_fft}")
    # K3: one instance per (n_fft, hop); its launch for one clip of 64 frames
    spilled = []
    for n_fft, hop in RADIX_GATE:
        regs, spill, frame = rows[(k3.KERNEL.name, n_fft.bit_length() - 2, n_fft // hop)]
        g = k3.launch_plan(n_fft, hop, 1, 64, n_fft + 63 * hop, dev)
        print(f"  {k3.KERNEL.name} n_fft {n_fft} hop {hop}: {regs} registers, {spill} bytes "
              f"spilled, {frame} B stack frame, {g['threads']} threads x {g['frames_per_tile']} "
              f"frames per tile, {g['smem_bytes']} B shared per block, "
              f"{g['blocks_per_sm'] * g['threads'] // 32} warps per SM")
        spilled.extend([(n_fft, hop)] if spill or frame else [])
    check(not spilled, f"K3 spills or has a stack frame at (n_fft, hop) {spilled}")


def k5_sass(ks: tuple[int, ...] = (4, 9)) -> None:
    """K5's instances for each k in ``ks`` in the built library's SASS
    (``cuobjdump``): static instruction counts by kind. At k <= 4 every
    value is inserted, so min/max per load is the insertion's cost a value;
    at k >= 5 the count also holds the insertion a chunk with a NaN takes
    and the tail's."""
    from mlx_audio_primitives_tpu_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    kinds = {"min/max": ("FMNMX",), "select": ("FSEL", "SEL"), "compare": ("FSETP", "ISETP"),
             "load": ("LDG",)}
    name, counts = None, {}
    for ln in out.splitlines():
        if "Function :" in ln:
            m = re.search(r"select_extremes_kernelILi(\d+)E", ln)
            name = int(m.group(1)) if m else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if name and m:
            c = counts.setdefault(name, dict.fromkeys(("all", *kinds), 0))
            c["all"] += 1
            op = m.group(1).split(".")[0]
            for kind, ops in kinds.items():
                c[kind] += op in ops
    for k, c in sorted(counts.items()):
        if k in ks:
            print(f"  K5 SASS k={k}: {c['all']} instructions, {c['load']} loads, "
                  f"{c['min/max']} min/max ({c['min/max'] / max(c['load'], 1):.1f} a load), "
                  f"{c['select']} select, {c['compare']} compare")


def default_bands() -> list[tuple[int, int, int]]:
    """The bands of ``spectral_contrast``'s defaults at n_fft 2048 that take
    the extraction kernel (k > 1): (start, stop, k)."""
    return [b for b in default_bands_all() if b is not None and b[2] > 1]


def k5_rows(gen: torch.Generator, kind: str, shape: tuple[int, int]) -> torch.Tensor:
    """Rows for K5 on the card: ``random`` (standard normal), ``ties``
    (integers -3..3, every extreme tied many times) or ``inf/nan`` (normal,
    with 5% +inf, 5% -inf and 10% NaN), on the generator's device."""
    dev = gen.device
    if kind == "ties":
        return torch.randint(-3, 4, shape, generator=gen, device=dev).float()
    x = torch.randn(shape, generator=gen, device=dev)
    if kind == "inf/nan":
        u = torch.rand(shape, generator=gen, device=dev)
        x[u < 0.05] = float("inf")
        x[(u >= 0.05) & (u < 0.1)] = float("-inf")
        x[u >= 0.9] = float("nan")
    return x


def k5_reference(x: torch.Tensor, k_lo: int, k_hi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's plain twin on the rows as they are: ``topk`` ranks a NaN above
    +inf, so a row that holds a NaN has a NaN hi mean, and a NaN lo mean
    where fewer than ``k_lo`` values are not NaN."""
    from mlx_audio_primitives_tpu_torch.kernels.select_extremes import (
        quantile_extreme_means_plain,
    )

    return quantile_extreme_means_plain(x, k_lo, k_hi)


def moments_weight(dev: torch.device) -> torch.Tensor:
    """The ``(n_bins, 2)`` weight ``[1, f]`` whose contraction with ``|X|``
    gives a centroid's two moments ``(sum S, sum f*S)``."""
    from mlx_audio_primitives_tpu_torch.ops.features import _get_frequencies

    freq = _get_frequencies(SR, N_FFT, device=dev)
    return torch.stack([torch.ones_like(freq), freq], dim=1)


def kernels_vs_plain(gen: torch.Generator) -> dict:
    """Phase 3: each kernel against its plain twin; returns max errors."""
    phase("3. kernels against their plain twins")
    from mlx_audio_primitives_tpu_torch.kernels import istft_fused as k3
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.kernels import overlap_add as k4
    from mlx_audio_primitives_tpu_torch.kernels import select_extremes as k5
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
    from mlx_audio_primitives_tpu_torch.ops.mel import mel_filterbank
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window, _istft_envelope_table

    dev = torch.device("cuda", 0)
    win = _get_padded_window("hann", N_FFT, N_FFT, dev)
    fb_t = k1_weight(mel_filterbank(SR, N_FFT, N_MELS, device=dev))
    kw = dict(n_fft=N_FFT, hop_length=HOP, center=True, pad_mode="constant")
    errs: dict[str, float] = {}

    def run(kernel, fn, *args, n_launches=1, **kwargs):
        before = kernel.launches
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        check(kernel.launches == before + n_launches,
              f"{kernel.name}: launch counter rose by {kernel.launches - before}, expected "
              f"{n_launches}")
        return out

    # K1, both entries: headline at power 2 and 1, scale at power 2, and the
    # feature path's 64 x 30 s with MFCC's mel weight; <= 1e-5 of max of
    # their twins, the fast entry <= 3e-5 of max of float64
    for shape, power in ((HEADLINE, 2.0), (HEADLINE, 1.0), (SCALE, 2.0), (FEATURES, 2.0)):
        y = torch.randn(shape, generator=gen, device=dev)
        k1_entries(run, errs, f"{shape} power={power}", y, win, fb_t, power=power, **kw)
    k1_fast_cases(gen, run, errs)

    # K2: one 30 s clip and the headline batch; <= 1e-5 of max |S|
    for shape in ((1, LONG), HEADLINE):
        y = torch.randn(shape, generator=gen, device=dev)
        got = run(k2.KERNEL, k2.stft_fused, y, win, **kw)
        ref = k2.stft_plain(y, win, **kw)
        e = rel_err(got, ref)
        print(f"K2 stft {shape}: rel err {e:.3e} (limit 1e-5)")
        check(got.shape == ref.shape and e <= 1e-5, "K2 disagrees with its plain twin")
        errs[k2.KERNEL.name] = max(errs.get(k2.KERNEL.name, 0.0), abs_err(got, ref))

    # K2m: one 30 s clip and the feature path's 64 x 30 s; <= 1e-5 of max
    for shape in ((1, LONG), FEATURES):
        y = torch.randn(shape, generator=gen, device=dev)
        mag = run(k2.KERNEL_MAG, k2.stft_magnitude_fused, y, win, **kw)
        ref = k2.stft_magnitude_plain(y, win, **kw)
        e = rel_err(mag, ref)
        print(f"K2m stft magnitude {shape}: rel err {e:.3e} (limit 1e-5)")
        check(mag.shape == ref.shape and e <= 1e-5, "K2m disagrees with its plain twin")
        errs[k2.KERNEL_MAG.name] = max(errs.get(k2.KERNEL_MAG.name, 0.0), abs_err(mag, ref))
        del ref

    k2s_vs_plain(gen, run, errs, win, kw)
    k5_vs_plain(gen, mag, run, errs)
    del mag
    contrast_nan_vs_cpu(gen)

    # K3: on K2's 30 s output; <= 1e-5 abs over the samples istft returns.
    # The centre pad it trims holds the first and last half frames, where the
    # envelope is clamped to 1e-8 and rounding is amplified up to 1e8-fold.
    y = torch.randn((1, LONG), generator=gen, device=dev)
    S_nat = k2.stft_fused(y, win, **kw)
    S = S_nat.transpose(1, 2)
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

    # K3 through the natural-spectrum entries (the JAX istft_pallas_t and
    # istft_pallas_nat), on the whole clip and on an output that the
    # spectrum's frames overrun by half; same limit, K3's counter rising
    T_half = LONG // 2
    env_half = _istft_envelope_table(("hann", None), N_FFT, N_FFT, S.shape[1], HOP, T_half,
                                     device=dev)
    ref_half = k3.istft_plain(S, win, env_half, n_fft=N_FFT, hop_length=HOP, padded_length=T_half)
    keep_half = slice(N_FFT // 2, T_half - N_FFT // 2)
    for entry, fn in (("istft_fused_t", k3.istft_fused_t), ("istft_fused_nat", k3.istft_fused_nat)):
        got = run(k3.KERNEL, fn, S_nat, win, env, **kw3)
        got_half = run(k3.KERNEL, fn, S_nat, win, env_half, n_fft=N_FFT, hop_length=HOP,
                       padded_length=T_half)
        e = max(abs_err(got[:, keep], ref[:, keep]),
                abs_err(got_half[:, keep_half], ref_half[:, keep_half]))
        print(f"K3 via {entry} 30 s and 15 s of it: abs err {e:.3e} on the kept samples "
              f"(limit 1e-5)")
        check(got.shape == ref.shape and got_half.shape == ref_half.shape and e <= 1e-5,
              f"K3 via {entry} disagrees with K3's plain twin")
        errs[f"{k3.KERNEL.name}[{entry}]"] = e

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

    k6_vs_plain(gen, run, errs)
    k7_vs_plain(gen, run, errs)
    whisper_kernels_vs_plain(gen, run, errs)
    big_batch_vs_plain(gen, run, errs)
    k3_gate_sweep(gen, run, errs)
    slice_kernels_vs_plain(gen, run, errs)
    rhythm_kernels_vs_plain(gen, run, errs)
    effects_kernels_vs_plain(gen, run, errs)
    utils_kernels_vs_plain(gen, run, errs)

    # K1-K3 across the rest of the radix gate: other sizes, pad modes,
    # center=False, a clip shorter than the reflect pad, and column counts
    # that are not whole 16-column m-tiles; same limits
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
        k1_entries(run, errs, f"n_fft {n_fft} hop {hop} {pad_mode} center={center} {shape} "
                   f"cols {n_cols}", y, w, fbt, **kwx)
        Sx = run(k2.KERNEL, k2.stft_fused, y, w, **kwx)
        e2 = rel_err(Sx, k2.stft_plain(y, w, **kwx))
        Mx = run(k2.KERNEL_MAG, k2.stft_magnitude_fused, y, w, **kwx)
        e2m = rel_err(Mx, k2.stft_magnitude_plain(y, w, **kwx))
        Sx = Sx.transpose(1, 2)
        T = n_fft + (Sx.shape[1] - 1) * hop
        env = _istft_envelope_table(("hann", None), n_fft, n_fft, Sx.shape[1], hop, T, device=dev)
        kw3 = dict(n_fft=n_fft, hop_length=hop, padded_length=T)
        got = run(k3.KERNEL, k3.istft_fused, Sx, w, env, **kw3)
        keep = slice(n_fft // 2, T - n_fft // 2)
        e3 = abs_err(got[:, keep], k3.istft_plain(Sx, w, env, **kw3)[:, keep])
        print(f"n_fft {n_fft} hop {hop} {pad_mode} center={center} {shape}: "
              f"K2 rel {e2:.3e}, K2m rel {e2m:.3e}, K3 abs {e3:.3e}")
        check(e2 <= 1e-5 and e2m <= 1e-5 and e3 <= 1e-5,
              "a kernel disagrees with its plain twin")

    # K1, K2 and K2m at the edges of their tiling: the smallest size the
    # gate admits, frame counts that are not whole 16-frame tiles, and odd
    # clip lengths, whose clip starts are not 16-byte aligned; K1 with
    # column counts around its 16-column m-tiles (2, the moments weight's;
    # 17 and 129, one past an m-tile and past 128); same limits
    for n_fft, hop, pad_mode, center, shape, n_cols in (
        (128, 128, "constant", True, (3, 5001), 2),
        (2048, 512, "reflect", True, (3, 33333), 17),
        (1024, 256, "edge", True, (5, 44101), 129),
        (4096, 1024, "constant", False, (3, 77777), 2),
    ):
        y = torch.randn(shape, generator=gen, device=dev)
        w = _get_padded_window("hann", n_fft, n_fft, dev)
        fbt = torch.rand((n_fft // 2 + 1, n_cols), generator=gen, device=dev)
        kwx = dict(n_fft=n_fft, hop_length=hop, center=center, pad_mode=pad_mode)
        k1_entries(run, errs, f"n_fft {n_fft} hop {hop} {pad_mode} center={center} {shape} "
                   f"cols {n_cols}", y, w, fbt, **kwx)
        Sx = run(k2.KERNEL, k2.stft_fused, y, w, **kwx)
        e2 = rel_err(Sx, k2.stft_plain(y, w, **kwx))
        Mx = run(k2.KERNEL_MAG, k2.stft_magnitude_fused, y, w, **kwx)
        e2m = rel_err(Mx, k2.stft_magnitude_plain(y, w, **kwx))
        print(f"n_fft {n_fft} hop {hop} {pad_mode} center={center} {shape}, {Sx.shape[-1]} frames: "
              f"K2 rel {e2:.3e}, K2m rel {e2m:.3e}")
        check(e2 <= 1e-5 and e2m <= 1e-5, "K2/K2m disagree with their plain twins")
    return errs


def mel_powers(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    """Mel-like powers over 14 decades (1e-12 to 1e2), made on the card."""
    return 10.0 ** (torch.rand(shape, generator=gen, device=gen.device) * 14.0 - 12.0)


def k6_vs_plain(gen: torch.Generator, run, errs: dict) -> None:
    """Phase 3's K6 checks: the dB conversion against its twin, bit for bit
    (expected error 0.0, NaN matching NaN): the log-mel cell's 64 x 30 s x
    128 mels with top_db 80, the bucketed cell's largest batch (508 clips of
    4.75 s, 80 mels, 20 log10) without, a ref whose reciprocal rounds, a
    streaming push's few frames, NaN, +inf and zeros, an input that is not
    16-byte aligned (K6's single-float path) and a transposed mel (mapped
    where its values lie)."""
    from mlx_audio_primitives_tpu_torch.kernels import db_fused as k6

    for shape, coef, amin, top_db, ref, special in (
        ((64, 128, 1292), 10.0, 1e-10, 80.0, 1.0, None),
        ((508, 80, 410), 20.0, 1e-5, None, 1.0, None),
        ((64, 128, 1292), 10.0, 1e-10, 80.0, 2.5, None),
        ((1, 128, 4), 20.0, 1e-5, None, 2.5, None),
        ((8, 128, 300), 10.0, 1e-10, 80.0, 1.0, float("inf")),
        ((8, 128, 300), 10.0, 1e-10, None, 1.0, float("nan")),
        ((8, 128, 300), 10.0, 1e-10, 80.0, 1.0, 0.0),
        ((4 * 128 * 97 + 1,), 10.0, 1e-10, 80.0, 1.0, "unaligned"),
        ((64, 1292, 128), 10.0, 1e-10, 80.0, 1.0, "transposed"),
    ):
        S = mel_powers(gen, shape)
        if special == "unaligned":
            S = S[1:]
        elif special == "transposed":
            S = S.transpose(1, 2)
        elif special is not None:
            S.view(-1)[[17, S.numel() // 2, S.numel() - 1]] = special
        got = run(k6.KERNEL, k6.to_db_fused, S, coef, ref, amin, top_db,
                  n_launches=1 + (top_db is not None))
        e = exact_err(got, k6.to_db_plain(S, coef, ref, amin, top_db))
        print(f"K6 {tuple(S.shape)} coef {coef} amin {amin} top_db {top_db} ref {ref}"
              f"{'' if special is None else f' ({special})'}: err {e:.3e} (limit 0, bit-equal)")
        check(e == 0.0, "K6 disagrees with its plain twin")
        errs[k6.KERNEL.name] = max(errs.get(k6.KERNEL.name, 0.0), e)


def k7_vs_plain(gen: torch.Generator, run, errs: dict) -> None:
    """Phase 3's K7 checks: the frame statistics against their twin at the
    feature path's 64 x 30 s (frame 2048, hop 512: the 16-byte path), each
    statistic with the feature cell's pad mode, the other one and no centre
    pad, on clips with runs of zeros and -0.0, a NaN in each and +-inf in
    two; then at frame 400, hop 160 on clips of an odd length (their starts
    are not 16-byte aligned: the scalar path). ZCR bit for bit (expected
    error 0.0), RMS within 1e-6 of max, NaN where the twin's is."""
    from mlx_audio_primitives_tpu_torch.kernels import frame_stats as k7

    dev = torch.device("cuda", 0)
    y = torch.randn(FEATURES, generator=gen, device=dev)
    y[:, 100:180] = 0.0
    y[:, 200:230] = -0.0
    y[:, 181::97] = -0.0
    y[:, 777] = float("nan")
    y[0, 1500], y[-1, 2500] = float("inf"), float("-inf")
    y_odd = torch.randn((64, 44_101), generator=gen, device=dev)
    for clips, n, hop in ((y, N_FFT, HOP), (y_odd, 400, 160)):
        for stat, center, pad_mode in itertools.product(("zero_crossing_rate", "rms"), (True, False),
                                                        ("edge", "constant")):
            if not center and pad_mode == "edge":
                continue
            kw = dict(stat=stat, frame_length=n, hop_length=hop, center=center, pad_mode=pad_mode)
            got = run(k7.KERNEL, k7.frame_stats_fused, clips, **kw)
            want = k7.frame_stats_plain(clips, **kw)
            # RMS: the frames that hold an infinity or a NaN bit for bit, the
            # others within 1e-6 of max
            fin = torch.isfinite(want) if stat == "rms" else torch.ones_like(want, dtype=torch.bool)
            odd_ok = exact_err(got[~fin], want[~fin]) == 0.0
            e = exact_err(got, want) if stat == "zero_crossing_rate" else rel_err(got[fin], want[fin])
            lim = 0.0 if stat == "zero_crossing_rate" else 1e-6
            print(f"K7 {stat} {tuple(clips.shape)} frame {n} hop {hop} center={center} "
                  f"{pad_mode}: err {e:.3e} (limit {lim:g}), {int((~fin).sum())} frames "
                  f"that are not finite matched: {odd_ok}")
            check(odd_ok and e <= lim, f"K7's {stat} disagrees with its twin")
            # the kernels line: the ZCR under the kernel's own name
            name = k7.KERNEL.name if stat == "zero_crossing_rate" else f"{k7.KERNEL.name}[rms]"
            errs[name] = max(errs.get(name, 0.0), e)


def whisper_kernels_vs_plain(gen: torch.Generator, run, errs: dict) -> None:
    """Phase 3's checks at Whisper large-v3's batch (``WHISPER``, n_fft 400,
    hop 160, reflect pad, the 128-mel Slaney table to 8 kHz): K1m within
    2e-5 of max of its twin (the fast entry's class: the twin's passes round
    in another order, and a power's bf16 split can move by one step), also
    on four clips with a W given per call (``plan_of`` packs its plan), then
    K6's per-item form on the mel's ``[..., :-1]`` view, as the front end
    calls it (top_db 80, ``/ 40 + 1``), bit for bit its twin, also with NaN
    and +inf in three clips."""
    from mlx_audio_primitives_tpu_torch.kernels import db_fused as k6
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.ops.mel import mel_filterbank

    dev = torch.device("cuda", 0)
    y = torch.randn(WHISPER, generator=gen, device=dev)
    win = torch.hann_window(WHISPER_KW["n_fft"], periodic=True, device=dev)
    fb_t = mel_filterbank(WHISPER_SR, WHISPER_KW["n_fft"], N_MELS, 0.0, 8000.0, device=dev).t()
    mel = run(k1.KERNEL_MIXED, k1.melspectrogram_fused, y, win, fb_t, **WHISPER_KW)
    ref = k1.melspectrogram_mixed_plain(y, win, fb_t, **WHISPER_KW)
    e = rel_err(mel, ref)
    print(f"K1m {tuple(y.shape)} n_fft 400 hop 160 reflect -> {tuple(mel.shape)}: rel err "
          f"{e:.3e} (limit 2e-5)")
    check(mel.shape == ref.shape == (WHISPER[0], N_MELS, 1 + WHISPER[1] // 160) and e <= 2e-5,
          "K1m disagrees with its plain twin")
    errs[K1M] = abs_err(mel, ref)
    del ref
    # a W given per call (trainable): plan_of packs its full-range plan
    w = (fb_t * (1.0 + 0.1 * torch.rand(fb_t.shape, generator=gen, device=dev))).contiguous()
    y4 = y[:4].contiguous()
    got = run(k1.KERNEL_MIXED, k1.melspectrogram_fused, y4, win, w, **WHISPER_KW)
    e = rel_err(got, k1.melspectrogram_mixed_plain(y4, win, w, **WHISPER_KW))
    print(f"K1m, a W given per call {tuple(w.shape)}, {k1.plan_of(w)[1]} blocks: rel err {e:.3e} "
          f"(limit 2e-5)")
    check(e <= 2e-5, "K1m disagrees with its plain twin on a W given per call")
    special = mel.clone()
    special[3, 5, 7], special[9, 100, mel.shape[-1] // 2], special[-1, -1, -2] = (
        float("nan"), float("inf"), float("inf"))
    kw = dict(per_item=True, scale=1.0 / 40.0, offset=1.0)
    for label, S in (("the mel's [..., :-1]", mel[..., :-1]),
                     ("with NaN and +inf", special[..., :-1])):
        got = run(k6.KERNEL_ITEM, k6.to_db_fused, S, 10.0, 1.0, 1e-10, 80.0, n_launches=2, **kw)
        e = exact_err(got, k6.to_db_plain(S, 10.0, 1.0, 1e-10, 80.0, **kw))
        print(f"K6 per item {tuple(S.shape)}, {label}, top_db 80, / 40 + 1: err {e:.3e} "
              f"(limit 0, bit-equal)")
        check(e == 0.0 and got.is_contiguous(), "K6's per-item form disagrees with its plain twin")
        errs[K6_ITEM] = max(errs.get(K6_ITEM, 0.0), e)


def k2s_vs_plain(gen: torch.Generator, run, errs: dict, win: torch.Tensor, kw: dict) -> None:
    """K2s at the feature path's 64 x 30 s, each statistic at the feature
    defaults (p 2, roll_percent 0.85, power 2), against its twin (bandwidth
    within 2e-5 of max, flatness 3e-4: the twin's cuFFT and K2 round a bin
    near zero differently, which flatness's mean log carries; rolloff one
    bin in at most 0.5% of frames) and against the statistic in float64 of
    K2m's magnitude, the same float32 spectrum (5e-6 of max; rolloff the
    same rule)."""
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
    from mlx_audio_primitives_tpu_torch.ops.features import _get_frequencies

    y = torch.randn(FEATURES, generator=gen, device=win.device)
    freq = _get_frequencies(SR, N_FFT, device=win.device)
    S = k2.stft_magnitude_fused(y, win, **kw).double()
    f = freq.double()[None, :, None]
    total = S.sum(1, keepdim=True) + 1e-10
    c = (f * S).sum(1, keepdim=True) / total
    ref64 = {"bandwidth": torch.sqrt((S * (f - c) ** 2).sum(1, keepdim=True) / total)}
    cs = S.cumsum(1)
    first = torch.argmax((cs >= 0.85 * cs[:, -1:]).to(torch.uint8), 1)
    ref64["rolloff"] = freq.double()[first][:, None]
    del cs
    x = torch.clamp(S * S, min=1e-10)
    ref64["flatness"] = (torch.exp(torch.log(x).mean(1, keepdim=True))
                         / (x.mean(1, keepdim=True) + 1e-10))
    del S, x
    step = SR / N_FFT
    for stat, lim64, lim in (("bandwidth", 5e-6, 2e-5), ("rolloff", None, None),
                             ("flatness", 5e-6, 3e-4)):
        fq = None if stat == "flatness" else freq
        got = run(k2.KERNEL_STATS, k2.stft_stats_fused, y, win, fq, stat=stat, **kw)
        twin = k2.stft_stats_plain(y, win, fq, stat=stat, **kw)
        if stat == "rolloff":
            d = [torch.round(got.double() / step) - torch.round(r.double() / step)
                 for r in (twin, ref64[stat])]
            shares = [float((x != 0).double().mean()) for x in d]
            most = max(float(x.abs().max()) for x in d)
            print(f"K2s rolloff {FEATURES}: {shares[0]:.3e} of frames off the twin's bin, "
                  f"{shares[1]:.3e} off float64 of K2m's magnitude, at most {most:.0f} bin "
                  f"(limits 5e-3 and 1)")
            check(max(shares) <= 5e-3 and most <= 1, "K2s's rolloff misses its twin")
        else:
            e, e64 = rel_err(got, twin), rel_err(got, ref64[stat])
            print(f"K2s {stat} {FEATURES}: rel err {e:.3e} against its twin (limit {lim:g}), "
                  f"{e64:.3e} against float64 of K2m's magnitude (limit {lim64:g})")
            check(got.shape == twin.shape and e <= lim and e64 <= lim64,
                  f"K2s's {stat} disagrees with its twin")
        # the kernels line keys the bandwidth by the kernel's name
        errs[k2.KERNEL_STATS.name if stat == "bandwidth" else f"{k2.KERNEL_STATS.name}[{stat}]"] = (
            abs_err(got, twin))


def k5_vs_plain(gen: torch.Generator, mag: torch.Tensor, run, errs: dict) -> None:
    """Phase 3's K5 checks on the magnitude ``mag`` (B, n_bins, F); ``run``
    launches through a wrapper and checks its counter."""
    from mlx_audio_primitives_tpu_torch.kernels import select_extremes as k5

    dev = mag.device
    # K5: the default contrast bands of that 64 x 30 s magnitude, read in
    # place through the natural layout's strides (rows = frames); a wide
    # random case at k = 16;
    # rows full of ties; then k = 1..16 on random, tie-heavy and +-inf/NaN
    # rows. Exact, so the error is expected to be 0.0; limit 1e-6 absolute.
    def k5_case(x, k_lo, k_hi):
        lo, hi = run(k5.KERNEL, k5.quantile_extreme_means_fused, x, k_lo, k_hi)
        rlo, rhi = k5_reference(x, k_lo, k_hi)
        e = max(exact_err(lo, rlo), exact_err(hi, rhi))
        check(lo.shape == rlo.shape and e <= 1e-6,
              f"K5 disagrees with its plain twin: {tuple(x.shape)} k=({k_lo}, {k_hi})")
        errs[k5.KERNEL.name] = max(errs.get(k5.KERNEL.name, 0.0), e)
        return e

    for a, b, k in default_bands():
        x = mag[:, a:b, :].transpose(1, 2)
        e = k5_case(x, k, k)
        print(f"K5 select_extremes band {a}:{b} {tuple(x.shape)} k={k}: abs err {e:.3e} "
              f"(limit 1e-6)")
    for label, x, k_lo, k_hi in (
        ("random (10000, 4097)", torch.randn((10000, 4097), generator=gen, device=dev), 16, 16),
        ("ties (4096, 300)", k5_rows(gen, "ties", (4096, 300)), 9, 5),
    ):
        e = k5_case(x, k_lo, k_hi)
        print(f"K5 select_extremes {label} k=({k_lo}, {k_hi}): abs err {e:.3e} (limit 1e-6)")
    worst, n = 0.0, 0
    for k in range(1, 17):
        for W in sorted({k, 17, 431, 1000}):
            for kind in ("random", "ties", "inf/nan"):
                x = k5_rows(gen, kind, (3000, W))
                worst = max(worst, k5_case(x, k, k), k5_case(x, k, max(1, k // 2)))
                n += 2
    print(f"K5 sweep k = 1..16 at W = k, 17, 431, 1000 on random, tie-heavy and +-inf/NaN rows "
          f"(3000 rows, k_hi = k and k // 2, {n} launches): max abs err {worst:.3e} (limit 1e-6)")


def contrast_nan_vs_cpu(gen: torch.Generator) -> None:
    """Phase 3: ``spectral_contrast`` on the card (K5 on the bands with
    k > 1) against the same call on the CPU (the plain route), on a
    magnitude with NaN in a few frames of every band and one band of one
    frame all NaN: NaN at the same (clip, band, frame) positions, and
    within 1e-4 of max elsewhere (the contrast contract)."""
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch.kernels import _build

    S = torch.randn((2, N_FFT // 2 + 1, 60), generator=gen, device=gen.device).abs()
    bands = [b for b in default_bands_all() if b is not None]
    for n, (start, stop, _) in enumerate(bands):
        S[n % 2, start + (7 * n) % (stop - start), 2 + n] = float("nan")
        S[(n + 1) % 2, start + (3 * n + 1) % (stop - start), 9 + n] = float("nan")
    start, stop, _ = bands[-1]
    S[0, start:stop, 14] = float("nan")
    k5 = next(k for k in _build.KERNELS if k.name == "select_extremes_kernel")
    before = k5.launches
    got = ap.spectral_contrast(S=S, sr=SR, n_fft=N_FFT, hop_length=HOP).cpu()
    check(k5.launches == before + len(default_bands()), "K5 did not run on the card's contrast")
    ref = ap.spectral_contrast(S=S.cpu(), sr=SR, n_fft=N_FFT, hop_length=HOP)
    nan = torch.isnan(ref)
    same = bool(torch.equal(torch.isnan(got), nan))
    e = rel_err(got[~nan], ref[~nan])
    print(f"spectral_contrast with NaN frames {tuple(S.shape)}: {int(nan.sum())} NaN of "
          f"{nan.numel()} on the CPU, the same positions on the card: {same}; elsewhere rel err "
          f"{e:.3e} (limit 1e-4)")
    check(same and int(nan.sum()) >= 2 * len(bands) and e <= 1e-4,
          "spectral_contrast on the card disagrees with the CPU on NaN frames")


def default_bands_all() -> list:
    """All bands of ``spectral_contrast``'s defaults at n_fft 2048."""
    from mlx_audio_primitives_tpu_torch.ops.features import contrast_bands

    return contrast_bands(np.linspace(0, SR / 2, N_FFT // 2 + 1), 200.0, 6, 0.02)


#: every (n_fft, hop) of the radix gate: one K3 instance each
RADIX_GATE = tuple((n, h) for n in (128, 256, 512, 1024, 2048, 4096, 8192)
                   for h in (128, 256, 512, 1024) if h <= n and n // h <= 8)


def k3_gate_sweep(gen: torch.Generator, run, errs: dict) -> None:
    """Phase 3's K3 sweep: every shape of the radix gate, on the natural
    spectrum (frames contiguous, as ``istft`` passes it) and on a
    contiguous ``(B, F, n_bins)`` copy, at the natural padded length and at
    one that the frames overrun by an odd count; 3 clips, so spans cross
    clips; the Hann window, or at hop = n_fft the rectangular one. <= 1e-5
    abs on the samples ``istft`` keeps."""
    from mlx_audio_primitives_tpu_torch.kernels import istft_fused as k3
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window, _istft_envelope_table

    dev = gen.device
    worst = 0.0
    for n_fft, hop in RADIX_GATE:
        # at hop = n_fft a Hann window's squared envelope falls to its 1e-8
        # clamp between frames, where no float32 result is defined: there
        # the rectangular window, whose envelope is 1
        name = "hann" if hop < n_fft else "rectangular"
        w = _get_padded_window(name, n_fft, n_fft, dev)
        y = torch.randn((3, 37 * hop + 5), generator=gen, device=dev)
        S_nat = k2.stft_fused(y, w, n_fft=n_fft, hop_length=hop, center=True, pad_mode="reflect")
        F = S_nat.shape[-1]
        for S in (S_nat.transpose(1, 2), S_nat.transpose(1, 2).contiguous()):
            for T in (n_fft + (F - 1) * hop, n_fft + (F - 3) * hop - 7):
                env = _istft_envelope_table((name, None), n_fft, n_fft, F, hop, T, device=dev)
                kw3 = dict(n_fft=n_fft, hop_length=hop, padded_length=T)
                got = run(k3.KERNEL, k3.istft_fused, S, w, env, **kw3)
                keep = slice(n_fft // 2, T - n_fft // 2)
                e = abs_err(got[:, keep], k3.istft_plain(S, w, env, **kw3)[:, keep])
                check(got.shape == (3, T) and e <= 1e-5,
                      f"K3 disagrees with its plain twin at n_fft {n_fft} hop {hop} T {T} "
                      f"strides {S.stride()}: {e:.3e}")
                worst = max(worst, e)
    print(f"K3 over the radix gate ({len(RADIX_GATE)} shapes x natural and (B, F, n_bins) "
          f"strides x 2 lengths, 3 clips): max abs err {worst:.3e} on the kept samples "
          f"(limit 1e-5)")
    errs[k3.KERNEL.name] = max(errs[k3.KERNEL.name], worst)


def big_batch_vs_plain(gen: torch.Generator, run, errs: dict) -> None:
    """Phase 3's checks of K3, K4 and K5 at 65,537 clips."""
    from mlx_audio_primitives_tpu_torch.kernels import istft_fused as k3
    from mlx_audio_primitives_tpu_torch.kernels import overlap_add as k4
    from mlx_audio_primitives_tpu_torch.kernels import select_extremes as k5
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window, _istft_envelope_table

    dev = gen.device
    # K3, K4 and K5 at 65,537 clips, past grid y's 65,535: small clips
    # (n_fft 256, hop 128, 4 frames a clip), K5 on (65537, 8, 16); same limits
    n_s, h_s = SMALL
    w_s = _get_padded_window("hann", n_s, n_s, dev)
    kws = dict(n_fft=n_s, hop_length=h_s, center=True, pad_mode="constant")
    S = k2.stft_fused(torch.randn((BIG, 3 * h_s), generator=gen, device=dev), w_s,
                      **kws).transpose(1, 2)
    T = n_s + (S.shape[1] - 1) * h_s
    env = _istft_envelope_table(("hann", None), n_s, n_s, S.shape[1], h_s, T, device=dev)
    kw3 = dict(n_fft=n_s, hop_length=h_s, padded_length=T)
    got = run(k3.KERNEL, k3.istft_fused, S, w_s, env, **kw3)
    keep = slice(n_s // 2, T - n_s // 2)
    e3 = abs_err(got[:, keep], k3.istft_plain(S, w_s, env, **kw3)[:, keep])
    frames = (torch.fft.irfft(S, n=n_s) * w_s).contiguous()
    kw4 = dict(hop_length=h_s, output_length=T)
    got = run(k4.KERNEL, k4.overlap_add_fused, frames, env, **kw4)
    e4 = abs_err(got, k4.overlap_add_plain(frames, env, **kw4))
    x = torch.randn((BIG, 8, 16), generator=gen, device=dev)
    lo, hi = run(k5.KERNEL, k5.quantile_extreme_means_fused, x, 3, 5)
    rlo, rhi = k5.quantile_extreme_means_plain(x, 3, 5)
    e5 = max(exact_err(lo, rlo), exact_err(hi, rhi))
    print(f"{BIG} clips: K3 {tuple(S.shape)} abs err {e3:.3e} on the kept samples (limit 1e-5), "
          f"K4 {tuple(frames.shape)} {e4:.3e} (limit 1e-6), K5 {tuple(x.shape)} k=(3, 5) {e5:.3e} "
          f"(limit 1e-6)")
    check(got.shape == (BIG, T) and lo.shape == (BIG, 8) and e3 <= 1e-5 and e4 <= 1e-6
          and e5 <= 1e-6, f"K3, K4 or K5 disagrees with its plain twin at {BIG} clips")
    errs[k3.KERNEL.name] = max(errs[k3.KERNEL.name], e3)
    errs[k4.KERNEL.name] = max(errs[k4.KERNEL.name], e4)
    errs[k5.KERNEL.name] = max(errs[k5.KERNEL.name], e5)


def power_oracle(y: torch.Tensor) -> torch.Tensor:
    """float64 CPU power spectrum ``(B, F, n_bins)``: constant centre pad,
    periodic Hann (host float64 table), rfft, |X|^2."""
    from mlx_audio_primitives_tpu_torch.ops.windows import window_host

    y64 = torch.nn.functional.pad(y.double().cpu(), (N_FFT // 2, N_FFT // 2))
    frames = y64.unfold(-1, N_FFT, HOP) * torch.from_numpy(window_host("hann", N_FFT))
    return torch.fft.rfft(frames).abs() ** 2


def mel_oracle(y: torch.Tensor) -> torch.Tensor:
    """float64 CPU mel spectrogram: :func:`power_oracle` through the Slaney
    mel filterbank (host float64 table)."""
    from mlx_audio_primitives_tpu_torch.ops.mel import _mel_filterbank_table

    fb = torch.from_numpy(_mel_filterbank_table.host(SR, N_FFT, N_MELS, 0.0, SR / 2.0, False, "slaney"))
    return torch.matmul(power_oracle(y), fb.T).transpose(1, 2)


def k1_weight(fb: torch.Tensor) -> torch.Tensor:
    """K1's ``(n_bins, n_cols)`` weight from a cached ``(n_cols, n_bins)``
    table as the public paths pass it: the table's transpose view, whose
    fast-entry plan is cached beside the table (the package under test has
    ``fast_plan``); a contiguous copy for a package without (an earlier
    commit, in ``--k1-split``), whose entries read W contiguous."""
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1

    return fb.t() if hasattr(k1, "fast_plan") else fb.t().contiguous()


def k1_oracle(y: torch.Tensor, win: torch.Tensor, fb_t: torch.Tensor, *, n_fft: int,
              hop_length: int, center: bool, pad_mode: str, power: float = 2.0) -> torch.Tensor:
    """K1's function in float64 on the inputs' device: ``|rfft(win *
    frame)|^power @ fb_t`` -> ``(B, n_cols, F)``, the float32 inputs
    widened."""
    from mlx_audio_primitives_tpu_torch.ops._frames import windowed_frames

    frames = windowed_frames(y.double(), win.double(), n_fft, hop_length, center, pad_mode)
    p = torch.fft.rfft(frames).abs() ** power
    return torch.matmul(p, fb_t.double()).transpose(1, 2)


def k1_entries(run, errs: dict, label: str, y: torch.Tensor, win: torch.Tensor,
               fb_t: torch.Tensor, **kw) -> torch.Tensor:
    """Phase 3: K1's dense entry (``fast_gemm=False``, 3xTF32) and its fast
    entry (bf16x3) on the same inputs, each against its own twin, <= 1e-5 of
    max; the fast entry also within 3e-5 of max of :func:`k1_oracle` (the
    JAX fast mode's class). ``run`` launches through a wrapper and checks
    that entry's counter. Returns the dense entry's output."""
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1

    out = None
    for kernel, fast in ((k1.KERNEL, False), (k1.KERNEL_FAST, True)):
        got = run(kernel, k1.melspectrogram_fused, y, win, fb_t, fast_gemm=fast, **kw)
        ref = k1.melspectrogram_plain(y, win, fb_t, fast_gemm=fast, **kw)
        e = rel_err(got, ref)
        entry = "fast" if fast else "dense"
        line = f"K1 {entry} entry {label} -> {tuple(got.shape)}: rel err {e:.3e} (limit 1e-5)"
        ok = got.shape == ref.shape and e <= 1e-5
        if fast:
            e64 = rel_err(got, k1_oracle(y, win, fb_t, **kw))
            line += f", against float64 {e64:.3e} (limit 3e-5)"
            ok = ok and e64 <= 3e-5
        print(line)
        check(ok, f"K1's {entry} entry disagrees ({label})")
        errs[kernel.name] = max(errs.get(kernel.name, 0.0), abs_err(got, ref))
        out = got if not fast else out
    return out


#: a cached table with an all-zero m-tile: the 40-band mel filterbank at
#: n_fft 2048 with 16 empty columns after its first 16
ZERO_TILE_TABLE = None


def zero_tile_table(dev: torch.device) -> torch.Tensor:
    global ZERO_TILE_TABLE
    from mlx_audio_primitives_tpu_torch.ops.mel import _mel_filterbank_table
    from mlx_audio_primitives_tpu_torch.utils.cache import TableCache

    if ZERO_TILE_TABLE is None:
        def build():
            fb = _mel_filterbank_table.host(SR, N_FFT, 40, 0.0, SR / 2.0, False, "slaney")
            return np.concatenate([fb[:16], np.zeros((16, fb.shape[1])), fb[16:]])
        ZERO_TILE_TABLE = TableCache("chip_smoke_zero_tile", build)
    return ZERO_TILE_TABLE(device=dev)


def k1_fast_cases(gen: torch.Generator, run, errs: dict) -> None:
    """Phase 3: K1's fast entry on the cases its band plan adds, each
    against its twin (<= 1e-5 of max) and float64 (3e-5): frames that hold
    an inf and a NaN sample (NaN in every column of every such frame, as
    the twin gives: the tile takes every k-step), a cached table with an
    all-zero m-tile (one k-step for it), and a W given per call (the
    trainable frontends'), whose full-range plan ``plan_of`` packs; and the
    blocks each plan contracts."""
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.ops.mel import mel_filterbank
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window

    dev = gen.device
    win = _get_padded_window("hann", N_FFT, N_FFT, dev)
    kw = dict(n_fft=N_FFT, hop_length=HOP, center=True, pad_mode="constant")
    fb_t = mel_filterbank(SR, N_FFT, N_MELS, device=dev).t()
    y = torch.randn(HEADLINE, generator=gen, device=dev)
    y[3, 5000] = float("inf")
    y[40, 9000] = float("nan")
    got = run(k1.KERNEL_FAST, k1.melspectrogram_fused, y, win, fb_t, fast_gemm=True, **kw)
    ref = k1.melspectrogram_plain(y, win, fb_t, fast_gemm=True, **kw)
    bad = ~torch.isfinite(ref).all(1)  # (B, F): the frames the two samples reach
    nan_ok = bool(torch.equal(torch.isnan(got), torch.isnan(ref)))
    every_col = bool(torch.isnan(got).all(1)[bad].all())
    fin = torch.isfinite(ref)
    e = rel_err(got[fin], ref[fin])
    print(f"K1 fast entry, frames with inf and NaN samples {tuple(got.shape)}: {int(bad.sum())} "
          f"frames NaN in every column: {every_col}, NaN where the twin's: {nan_ok}; the finite "
          f"values rel err {e:.3e} (limit 1e-5)")
    check(nan_ok and every_col and int(bad.sum()) > 0 and e <= 1e-5,
          "K1's fast entry on non-finite frames disagrees with its twin")
    y = torch.randn(HEADLINE, generator=gen, device=dev)
    for label, w in (("a cached table with an all-zero m-tile", zero_tile_table(dev).t()),
                     ("a W given per call (trainable)",
                      (fb_t * (1.0 + 0.1 * torch.rand(fb_t.shape, generator=gen, device=dev)))
                      .contiguous())):
        got = run(k1.KERNEL_FAST, k1.melspectrogram_fused, y, win, w, fast_gemm=True, **kw)
        ref = k1.melspectrogram_plain(y, win, w, fast_gemm=True, **kw)
        e, e64 = rel_err(got, ref), rel_err(got, k1_oracle(y, win, w, **kw))
        used, every = k1.contracted_blocks(w)
        print(f"K1 fast entry, {label} {tuple(w.shape)}: {used} of {every} blocks; rel err {e:.3e} "
              f"(limit 1e-5), against float64 {e64:.3e} (limit 3e-5)")
        check(got.shape == ref.shape and e <= 1e-5 and e64 <= 3e-5,
              f"K1's fast entry disagrees on {label}")
        errs[k1.KERNEL_FAST.name] = max(errs[k1.KERNEL_FAST.name], abs_err(got, ref))
    used, every = k1.contracted_blocks(fb_t)
    print(f"K1 fast entry plans: the 128-mel table contracts {used} of {every} blocks, a dense W "
          f"{every} of {every}")
    check((used, every) == (73, 520), "the 128-mel table's plan is not 73 of 520 blocks")


def reset_counts() -> None:
    from mlx_audio_primitives_tpu_torch.kernels import _build

    for k in _build.KERNELS:
        k.launches = 0


def read_counts(path: str, required: tuple[str, ...]) -> dict:
    from mlx_audio_primitives_tpu_torch.kernels import _build

    launches = {k.name: k.launches for k in _build.KERNELS}
    print(f"launches on the {path} path:", launches)
    for name in required:
        check(launches[name] >= 1, f"{name} was not launched on the {path} path")
    return launches


def counted_call(label: str, expect: dict, fn, total: dict):
    """``fn()`` with every launch counter reset just before and read just
    after; fails unless each kernel launched exactly ``expect[name]`` times
    (0 when absent). Adds the launches to ``total``; returns ``fn()``."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = read_counts(label, tuple(k for k, n in expect.items() if n))
    for name, n in launches.items():
        check(n == expect.get(name, 0), f"{label}: {name} launched {n} times, expected "
              f"{expect.get(name, 0)}")
        total[name] += n
    return out


def route_times(label: str, fn, reps: int) -> None:
    """CUDA-event medians of ``fn()`` on the kernel route and on the plain
    route (every kernel off), in turns: plain, kernel, kernel, plain."""
    from mlx_audio_primitives_tpu_torch.utils import dispatch

    def run(enabled):
        dispatch.KERNELS_ENABLED = enabled
        try:
            return fn()
        finally:
            dispatch.KERNELS_ENABLED = True
    p_a = cuda_ms(lambda: run(False), 1, reps)
    k_a, k_b = cuda_ms(lambda: run(True), 1, reps), cuda_ms(lambda: run(True), 1, reps)
    p_b = cuda_ms(lambda: run(False), 1, reps)
    print(f"{label}: kernel route {k_a:.4f} / {k_b:.4f}, plain route {p_a:.4f} / {p_b:.4f}")


def main_path(gen: torch.Generator) -> dict:
    """Phase 4a: the log-mel / STFT / ISTFT entry points on CUDA tensors."""
    phase("4a. public log-mel / STFT / ISTFT path on cuda tensors")
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch import _config

    dev = torch.device("cuda", 0)
    inputs = {name: torch.randn(shape, generator=gen, device=dev)
              for name, shape in (("headline", HEADLINE), ("scale", SCALE))}
    y_long = torch.randn(LONG, generator=gen, device=dev)
    y_grad = torch.randn((2, SR), generator=gen, device=dev)
    reset_counts()

    # log-mel under ANALYSIS_FAST_GEMM's default (K1's fast entry) and with
    # it set to False, as a caller pins the exact mode (the dense entry)
    results = {}
    for fast in (True, False):
        _config.ANALYSIS_FAST_GEMM = fast
        try:
            for name, y in inputs.items():
                mel = ap.melspectrogram(y, sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS)
                db = ap.power_to_db(mel)
                torch.cuda.synchronize()
                results[f"{name}, {'fast' if fast else 'exact'} mode"] = (y, mel, db)
        finally:
            _config.ANALYSIS_FAST_GEMM = True
    S = ap.stft(y_long, n_fft=N_FFT, hop_length=HOP)
    rec = ap.istft(S, hop_length=HOP, length=LONG)
    S441 = ap.stft(y_long, n_fft=N_FFT, hop_length=OLA_HOP)
    rec441 = ap.istft(S441, hop_length=OLA_HOP, length=LONG)
    yg = y_grad.clone().requires_grad_(True)
    ap.melspectrogram(yg, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS).sum().backward()
    torch.cuda.synchronize()
    launches = read_counts("log-mel", LOG_MEL_PATH)

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

    # Whisper large-v3's front end, counters reset just before its call
    from mlx_audio_primitives_tpu_torch.models.presets import whisper_v3_logmel

    yw = torch.randn(WHISPER, generator=gen, device=dev)
    front = whisper_v3_logmel()
    feats = counted_call("whisper_v3_logmel", WHISPER_LAUNCHES, lambda: front(yw), launches)
    e_w = abs_err(feats, whisper_oracle(yw))
    print(f"whisper_v3_logmel {tuple(yw.shape)} -> {tuple(feats.shape)}: abs err vs f64 oracle "
          f"{e_w:.3e} in Whisper's units (limit 2e-4)")
    check(feats.shape == (WHISPER[0], N_MELS, 3000) and e_w <= 2e-4,
          "whisper_v3_logmel misses its contract")
    return launches


def whisper_oracle(y: torch.Tensor) -> torch.Tensor:
    """Whisper's ``log_mel_spectrogram`` in float64 on ``y``'s device:
    ``torch.stft`` with a periodic Hann window, centred with a reflect pad;
    ``|X|^2`` without the last frame; the 128-mel Slaney table to 8 kHz
    (host float64); ``log10(max(mel, 1e-10))`` floored 8 below each clip's
    maximum; ``(x + 4) / 4``."""
    from mlx_audio_primitives_tpu_torch.ops.mel import _mel_filterbank_table

    n_fft, hop = WHISPER_KW["n_fft"], WHISPER_KW["hop_length"]
    win = torch.hann_window(n_fft, periodic=True, dtype=torch.float64, device=y.device)
    X = torch.stft(y.double(), n_fft, hop, window=win, center=True, pad_mode="reflect",
                   return_complex=True)
    p = X[..., :-1].abs() ** 2
    del X
    fb = torch.from_numpy(_mel_filterbank_table.host(WHISPER_SR, n_fft, N_MELS, 0.0, 8000.0, False,
                                                     "slaney")).to(y.device)
    L = torch.log10(torch.clamp(torch.matmul(fb, p), min=1e-10))
    L = torch.maximum(L, L.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (L + 4.0) / 4.0


def feature_set(ap, y: torch.Tensor) -> dict:
    """A genre-tagging front end's per-frame features of ``y`` (B, L)."""
    kw = dict(sr=SR, n_fft=N_FFT, hop_length=HOP)
    m = ap.mfcc(y, n_mfcc=20, **kw)
    return {
        "mfcc": m, "delta1": ap.delta(m), "delta2": ap.delta(m, order=2),
        "centroid": ap.spectral_centroid(y, **kw),
        "bandwidth": ap.spectral_bandwidth(y, **kw),
        "rolloff": ap.spectral_rolloff(y, **kw),
        "flatness": ap.spectral_flatness(y, n_fft=N_FFT, hop_length=HOP),
        "contrast": ap.spectral_contrast(y, **kw),
        "zcr": ap.zero_crossing_rate(y),
        "rms": ap.rms(y),
    }


def feature_oracle(y: torch.Tensor, mag32: torch.Tensor) -> dict:
    """The same features in float64 on the CPU, from the float32 clips:
    float64 ``|rfft|`` of the Hann-windowed frames, the feature formulas,
    scipy's Savitzky-Golay filter for the deltas. The contrast starts from
    ``mag32``, the port's float32 magnitude of the same clips, as the JAX
    package's contrast test does: a band's valley may be ~1e-4 of its peak,
    where float32 rounding of the spectrum (~3e-7 of the peak) moves the dB
    contrast by up to ~2e-4 of its max whatever computes it. That magnitude
    is itself held against the float64 one (key ``magnitude``). The host
    tables (mel filterbank, DCT basis, contrast band table) are the port's
    float64 builders, which the CPU tests hold bit-equal to the JAX
    package's."""
    from scipy.signal import savgol_filter

    from mlx_audio_primitives_tpu_torch.ops.mel import _mel_filterbank_table
    from mlx_audio_primitives_tpu_torch.ops.mfcc import _dct_basis_t
    from mlx_audio_primitives_tpu_torch.ops.windows import window_host

    y32 = y.cpu().numpy()
    y64 = torch.from_numpy(y32).double()
    frames = torch.nn.functional.pad(y64, (N_FFT // 2, N_FFT // 2)).unfold(-1, N_FFT, HOP)
    mag = torch.fft.rfft(frames * torch.from_numpy(window_host("hann", N_FFT))).abs()
    mag = mag.transpose(1, 2).numpy()  # (B, n_bins, F)
    freq = np.linspace(0, SR / 2, N_FFT // 2 + 1)[:, None]
    total = mag.sum(1, keepdims=True)
    centroid = (freq * mag).sum(1, keepdims=True) / (total + 1e-10)
    bandwidth = np.sqrt((mag * (freq - centroid) ** 2).sum(1, keepdims=True) / (total + 1e-10))
    cs = np.cumsum(mag, axis=1)
    rolloff = freq[np.argmax(cs >= 0.85 * cs[:, -1:], axis=1), 0][:, None, :]
    power = np.maximum(mag**2, 1e-10)
    flatness = np.exp(np.log(power).mean(1, keepdims=True)) / (power.mean(1, keepdims=True) + 1e-10)
    from mlx_audio_primitives_tpu_torch.ops.features import contrast_bands

    def contrast(m: np.ndarray) -> np.ndarray:
        valleys, peaks = [], []
        for start, stop, k in contrast_bands(freq[:, 0], 200.0, 6, 0.02):
            srt = np.sort(m[:, start:stop, :], axis=1)
            valleys.append(srt[:, :k].mean(1))
            peaks.append(srt[:, -k:].mean(1))
        return (10 * np.log10(np.maximum(np.stack(peaks, 1), 1e-10))
                - 10 * np.log10(np.maximum(np.stack(valleys, 1), 1e-10)))

    fb = _mel_filterbank_table.host(SR, N_FFT, N_MELS, 0.0, SR / 2.0, False, "slaney")
    db = 10 * np.log10(np.maximum(np.einsum("mk,bkf->bmf", fb, mag**2), 1e-10))
    floor = db.max() - 80.0
    print(f"oracle: {np.mean(db < floor):.2e} of the dB values under the 80 dB floor")
    db = np.maximum(db, floor)
    mfcc = np.einsum("bmf,mc->bcf", db, _dct_basis_t.host(20, N_MELS, "ortho"))
    fr32 = np.lib.stride_tricks.sliding_window_view(
        np.pad(y32, ((0, 0), (N_FFT // 2, N_FFT // 2)), mode="edge"), N_FFT, axis=-1)[:, ::HOP]
    sb = np.signbit(fr32)
    zcr = (sb[..., 1:] != sb[..., :-1]).sum(-1)[:, None, :] / N_FFT
    rms = np.sqrt((frames.numpy() ** 2).mean(-1))[:, None, :]
    return {
        "mfcc": mfcc,
        "delta1": savgol_filter(mfcc, 9, 1, deriv=1, axis=-1, mode="interp"),
        "delta2": savgol_filter(mfcc, 9, 2, deriv=2, axis=-1, mode="interp"),
        "centroid": centroid, "bandwidth": bandwidth, "rolloff": rolloff,
        "flatness": flatness, "contrast": contrast(mag32.double().cpu().numpy()),
        "zcr": zcr, "rms": rms, "magnitude": mag, "contrast_of_f64_magnitude": contrast(mag),
    }


def feature_path(gen: torch.Generator) -> dict:
    """Phase 4b: the spectral-feature entry points on CUDA tensors."""
    phase(f"4b. public spectral-feature path on cuda tensors, {FEATURES[0]} clips of 30 s")
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch.ops.stft import magnitude_spectrogram

    y = torch.randn(FEATURES, generator=gen, device=torch.device("cuda", 0))
    reset_counts()
    out = feature_set(ap, y)
    torch.cuda.synchronize()
    launches = read_counts("spectral-feature", FEATURE_PATH)
    for name, n in FEATURE_LAUNCHES.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times on the feature "
              f"path, expected {n}")

    n_frames = 1 + LONG // HOP
    out["magnitude"] = magnitude_spectrogram(y, n_fft=N_FFT, hop_length=HOP)
    ref = feature_oracle(y[:N_ORACLE], out["magnitude"][:N_ORACLE])
    for name, got in out.items():
        check(got.shape[0] == FEATURES[0] and got.shape[-1] == n_frames,
              f"{name}: shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
        g = got[:N_ORACLE].double().cpu().numpy()
        r = ref[name]
        check(g.shape == r.shape, f"{name}: shape {g.shape} against the oracle's {r.shape}")
        if name == "rolloff":
            # a discrete bin: rounding may move the threshold across one bin
            d = np.rint(g / (SR / N_FFT)) - np.rint(r / (SR / N_FFT))
            share = np.count_nonzero(d) / d.size
            print(f"rolloff: {share:.3e} of frames one bin off the f64 oracle, at most "
                  f"{int(np.abs(d).max())} bin (limits 5e-3 and 1)")
            check(np.abs(d).max() <= 1 and share <= 5e-3, "rolloff misses its contract")
        elif name == "zcr":
            e = float(np.abs(g - r).max())
            print(f"zcr: abs err vs f64 oracle {e:.3e} (limit 0, exact)")
            check(e == 0.0, "zcr is not exact")
        else:
            e = float(np.abs(g - r).max() / np.abs(r).max())
            source = " on the port's f32 magnitude" if name == "contrast" else ""
            print(f"{name} {tuple(got.shape)}: rel err vs f64 oracle{source} {e:.3e} (limit 1e-4)")
            check(e <= 1e-4, f"{name} misses its contract")
    r = ref["contrast_of_f64_magnitude"]
    e = float(np.abs(out["contrast"][:N_ORACLE].double().cpu().numpy() - r).max() / np.abs(r).max())
    print(f"contrast against the oracle's own f64 magnitude, not held to a limit: rel err {e:.3e}")
    return launches


def large_batch(gen: torch.Generator) -> None:
    """Phase 4c: the public ``istft`` and ``spectral_contrast`` on 65,537
    small clips on CUDA tensors, each with every launch counter reset just
    before and read just after."""
    phase(f"4c. public istft and spectral_contrast on {BIG} clips on cuda tensors")
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch.utils import dispatch

    n_s, h_s = SMALL
    y = torch.randn((BIG, 3 * h_s), generator=gen, device=gen.device)
    S = ap.stft(y, n_fft=n_s, hop_length=h_s)
    mag = S.abs()
    reset_counts()
    rec = ap.istft(S, hop_length=h_s, length=y.shape[1])
    torch.cuda.synchronize()
    read_counts(f"{BIG}-clip istft", ("istft_kernel",))
    e = abs_err(rec, y)
    print(f"istft {tuple(S.shape)} -> {tuple(rec.shape)}: round trip max abs err {e:.3e} "
          f"(limit 1e-5)")
    check(rec.shape == y.shape and e <= 1e-5, f"the {BIG}-clip round trip misses 1e-5")

    # quantile 0.1 gives the top three bands k = 2, 4 and 6: K5 launches
    kw = dict(S=mag, sr=SR, n_fft=n_s, hop_length=h_s, quantile=0.1)
    reset_counts()
    got = ap.spectral_contrast(**kw)
    torch.cuda.synchronize()
    launches = read_counts(f"{BIG}-clip spectral_contrast", ("select_extremes_kernel",))
    check(launches["select_extremes_kernel"] == 3,
          f"select_extremes_kernel launched {launches['select_extremes_kernel']} times, expected 3")
    dispatch.KERNELS_ENABLED = False
    try:
        ref = ap.spectral_contrast(**kw)
    finally:
        dispatch.KERNELS_ENABLED = True
    e = rel_err(got, ref)
    print(f"spectral_contrast {tuple(mag.shape)} -> {tuple(got.shape)}: rel err against the plain "
          f"path {e:.3e} (limit 1e-5)")
    check(got.shape == (BIG, 7, mag.shape[-1]) and bool(torch.isfinite(got).all()) and e <= 1e-5,
          f"the {BIG}-clip contrast disagrees with the plain path")


def pitch_clips(gen: torch.Generator, shape: tuple[int, int]) -> torch.Tensor:
    """Pitched test audio made on the generator's device: per clip a
    harmonic tone (5 partials at 1/k) whose f0 glides log-linearly between
    two draws in [80, 800] Hz, silent for 0.1 s every 2 s, plus white noise
    at 3% of the peak; float32 ``(B, L)``."""
    B, L = shape
    dev = gen.device
    t = torch.arange(L, device=dev, dtype=torch.float64) / SR
    ends = 80.0 * 10.0 ** torch.rand((B, 2), generator=gen, device=dev, dtype=torch.float64)
    f = ends[:, :1] * (ends[:, 1:] / ends[:, :1]) ** (t / t[-1])
    ph = 2 * np.pi * torch.cumsum(f, dim=1) / SR
    y = sum(torch.sin(k * ph) / k for k in range(1, 6))
    y = y * (torch.remainder(t, 2.0) >= 0.1)
    y = y / y.abs().amax(1, keepdim=True)
    return (y + 0.03 * torch.randn((B, L), generator=gen, device=dev, dtype=torch.float64)).float()


def degenerate_clips(dev: torch.device) -> dict[str, torch.Tensor]:
    """One 1 s clip of each degenerate kind of frame the ACF's noise gates
    decide: silence, silence -> onset, constant, piecewise constant with a
    zero mean, and a tone on a DC offset (small and large)."""
    n, half = SR, SR // 2
    t = np.arange(n) / SR
    clips = {
        "silence": np.zeros(n),
        "onset": np.concatenate([np.zeros(half), np.sin(2 * np.pi * 220 * t[: n - half])]),
        "constant": np.full(n, 0.9),
        "piecewise": np.concatenate([np.full(half, 0.9), np.full(n - half, -0.9)]),
        "dc-offset": 0.9 + 0.001 * np.sin(2 * np.pi * 330 * t),
        "large-dc-offset": 100.0 + 0.1 * np.sin(2 * np.pi * 330 * t),
    }
    return {k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in clips.items()}


def slice_kernels_vs_plain(gen: torch.Generator, run, errs: dict) -> None:
    """Phase 3's checks of the resampling / Griffin-Lim / pitch slice's new
    kernel call sites: K1 at the ACF shapes; the framewise ACF's K1 route
    against its plain route, on pitched clips and on degenerate frames;
    one Griffin-Lim iteration through K3 -> K2 -> projection against the
    same iteration through the twins."""
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch.kernels import istft_fused as k3
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
    from mlx_audio_primitives_tpu_torch.ops import pitch as P
    from mlx_audio_primitives_tpu_torch.ops.griffinlim import _project
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window, _istft_envelope_table
    from mlx_audio_primitives_tpu_torch.utils import dispatch

    dev = gen.device
    W, n_fft = 2048, 4096
    # K1 with the boxcar window over half the transform and the lag basis
    # at 432 and 331 columns (27 and 20.7 m-tiles), power 2, no centre pad,
    # on pitch_detect_acf's padded input at 64 x 30 s; <= 1e-5 of max
    yp = torch.nn.functional.pad(pitch_clips(gen, FEATURES), (W // 2, W // 2))
    win = P._acf_window_table(W, n_fft, device=dev)
    _, ypad = P._acf_prep(yp, frame_length=W, hop_length=HOP)
    kw1 = dict(n_fft=n_fft, hop_length=HOP, center=False, pad_mode="constant", power=2.0)
    for fmin, fmax in ACF_BANDS:
        lo, hi = P._lag_bounds(SR, fmin, fmax)
        hi = min(hi + 1, n_fft)
        C = P._acf_lag_basis(n_fft, lo, hi, device=dev)
        got = run(k1.KERNEL, k1.melspectrogram_fused, ypad, win, C, fast_gemm=False, **kw1)
        ref = k1.melspectrogram_plain(ypad, win, C, **kw1)
        e = rel_err(got, ref)
        print(f"K1 at the ACF shape (fmin {fmin:g}, fmax {fmax:g}): n_fft {n_fft} hop {HOP} "
              f"{tuple(ypad.shape)} -> {tuple(got.shape)} ({C.shape[1]} columns): rel err "
              f"{e:.3e} (limit 1e-5)")
        check(got.shape == ref.shape and e <= 1e-5, "K1 disagrees with its twin at the ACF shape")
        errs[k1.KERNEL.name] = max(errs.get(k1.KERNEL.name, 0.0), abs_err(got, ref))
        # K1's ACF entry, the public path's: the inverse FFT of the powers
        # in the kernel, against its twin (the dense twin with the same
        # basis) and against the dense entry; <= 1e-5 of max
        kwa = dict(n_fft=n_fft, hop_length=HOP, lo=lo, hi=hi)
        got_a = run(k1.KERNEL_ACF, k1.acf_fused, ypad, win, **kwa)
        ref_a = k1.acf_plain(ypad, win, **kwa)
        e_a, e_d = rel_err(got_a, ref_a), rel_err(got_a, got)
        # and each against float64 on the first 2 clips
        lags = torch.cat([torch.zeros(1, dtype=torch.long), torch.arange(lo, hi)]).to(dev)
        fr = ypad[:2].double().unfold(-1, n_fft, HOP) * win.double()
        r64 = torch.fft.irfft(torch.fft.rfft(fr).abs() ** 2, n=n_fft)[..., lags].transpose(1, 2)
        print(f"  K1's ACF entry: rel err {e_a:.3e} against its twin (limit 1e-5), {e_d:.3e} "
              f"against the dense entry; against float64 (2 clips) the entry "
              f"{rel_err(got_a[:2], r64):.3e}, the twin {rel_err(ref_a[:2], r64):.3e}, the dense "
              f"entry {rel_err(got[:2], r64):.3e}")
        del fr, r64
        check(got_a.shape == ref_a.shape and e_a <= 1e-5,
              "K1's ACF entry disagrees with its twin at the ACF shape")
        errs[k1.KERNEL_ACF.name] = max(errs.get(k1.KERNEL_ACF.name, 0.0), abs_err(got_a, ref_a))
        del got_a, ref_a
        # the framewise ACF, K1 route (the ACF entry, then the centering
        # algebra) against the plain route (FP32 rfft and GEMM), same clips:
        # the normalized ACF within 1e-4 (the JAX package's own limit
        # between its two routes) and the noise gate's masks equal
        sk, vk = run(k1.KERNEL_ACF, P._framewise_acf_fused, yp, frame_length=W, hop_length=HOP,
                     lo=lo, hi=hi)
        sp, vp = P._framewise_acf_plain(yp, C, frame_length=W, hop_length=HOP, lo=lo, hi=hi)
        e = abs_err(sk, sp)
        same = bool(torch.equal(vk, vp))
        print(f"  framewise ACF, K1 route against the plain route: abs err {e:.3e} (limit 1e-4), "
              f"masks equal: {same} ({int(vk.sum())} of {vk.numel()} frames valid)")
        check(e <= 1e-4 and same, "the framewise ACF's K1 route disagrees with its plain route")
        del got, ref, sk, sp

    # degenerate frames through the public pitch_detect_acf at the
    # defaults: the card's K1 route, the card's plain route and the CPU
    # give equal voicing masks and equal f0 where voiced
    worst = 0.0
    for name, clip in degenerate_clips(dev).items():
        f0_k, v_k = run(k1.KERNEL_ACF, ap.pitch_detect_acf, clip, sr=SR)
        dispatch.KERNELS_ENABLED = False
        try:
            f0_p, v_p = ap.pitch_detect_acf(clip, sr=SR)
        finally:
            dispatch.KERNELS_ENABLED = True
        f0_c, v_c = ap.pitch_detect_acf(clip.cpu(), sr=SR)
        same = (torch.equal(v_k, v_p) and torch.equal(v_k.cpu(), v_c))
        e = max(abs_err(f0_k[v_k], f0_p[v_k]) if v_k.any() else 0.0,
                abs_err(f0_k[v_k].cpu(), f0_c[v_k.cpu()]) if v_k.any() else 0.0)
        worst = max(worst, e)
        print(f"  degenerate frames, {name}: {int(v_k.sum())} of {v_k.numel()} voiced on K1, "
              f"{int(v_p.sum())} plain, {int(v_c.sum())} CPU; masks equal: {same}; f0 where voiced "
              f"max abs diff {e:.3e} Hz")
        check(same and e == 0.0, f"pitch_detect_acf on {name} frames: K1 route, plain route and "
              f"CPU disagree")

    # one Griffin-Lim iteration on 4 clips of 30 s: K3 on the random-phase
    # spectrum (the transposed view of its natural layout), K2 on that
    # signal, the projection; then K3 again. Each step against the twins'
    # step on the same input; the projection on cells with |X| >= 1e-3 of
    # max (below that a phase is set by rounding)
    wn = _get_padded_window("hann", N_FFT, N_FFT, dev)
    kw = dict(n_fft=N_FFT, hop_length=HOP, center=True, pad_mode="constant")
    S = k2.stft_magnitude_plain(pitch_clips(gen, (4, LONG)), wn, **kw)
    ang = (torch.rand(S.shape, generator=gen, device=dev) * 2 - 1) * np.pi
    rebuilt = torch.polar(S, ang)
    T = LONG + N_FFT
    env = _istft_envelope_table(("hann", None), N_FFT, N_FFT, S.shape[-1], HOP, T, device=dev)
    kw3 = dict(n_fft=N_FFT, hop_length=HOP, padded_length=T)
    keep = slice(N_FFT // 2, N_FFT // 2 + LONG)
    y_k = run(k3.KERNEL, k3.istft_fused, rebuilt.transpose(1, 2), wn, env, **kw3)[:, keep]
    y_p = k3.istft_plain(rebuilt.transpose(1, 2), wn, env, **kw3)[:, keep]
    e_y = abs_err(y_k, y_p)
    # the random phases leave the DC and Nyquist bins complex: the twin's
    # cuFFT irfft must drop their imaginary parts as the CPU's does
    y_c = k3.istft_plain(rebuilt[:1].cpu().transpose(1, 2), wn.cpu(), env.cpu(), **kw3)[:, keep]
    e_c = abs_err(y_p[:1], y_c)
    X_k = run(k2.KERNEL, k2.stft_fused, y_p.contiguous(), wn, **kw)
    X_p = k2.stft_plain(y_p.contiguous(), wn, **kw)
    e_x = rel_err(X_k, X_p)
    new_k, new_p = _project(S, X_k), _project(S, X_p)
    strong = X_p.abs() >= 1e-3 * X_p.abs().max()
    e_new = float((new_k - new_p).abs()[strong].max() / S.max())
    y2_k = run(k3.KERNEL, k3.istft_fused, new_k.transpose(1, 2), wn, env, **kw3)[:, keep]
    y2_p = k3.istft_plain(new_p.transpose(1, 2), wn, env, **kw3)[:, keep]
    e_y2 = rel_err(y2_k, y2_p)
    print(f"Griffin-Lim iteration (4, {LONG}): K3 abs err {e_y:.3e} (limit 1e-5; the twin on "
          f"the card against the CPU's {e_c:.3e}, limit 1e-5), K2 rel err "
          f"{e_x:.3e} (limit 1e-5), projection on {float(strong.float().mean()):.6f} of the cells "
          f"{e_new:.3e} of max S (limit 1e-4), the next K3 output {e_y2:.3e} of max (limit 1e-4)")
    check(e_y <= 1e-5 and e_c <= 1e-5 and e_x <= 1e-5 and e_new <= 1e-4 and e_y2 <= 1e-4,
          "a Griffin-Lim iteration through the kernels disagrees with the twins'")
    errs[k3.KERNEL.name] = max(errs.get(k3.KERNEL.name, 0.0), e_y)
    errs[k2.KERNEL.name] = max(errs.get(k2.KERNEL.name, 0.0), abs_err(X_k, X_p))


def acf_oracle(y: torch.Tensor, fmin: float, fmax: float, threshold: float = 0.1):
    """float64 CPU oracle of ``pitch_detect_acf`` and ``periodicity`` at the
    defaults (frame 2048, hop 512, centre pad of zeros): each frame's
    mean-centered linear ACF from a float64 ``rfft`` at 4096 points,
    normalized at lag 0, then the first local peak above ``threshold`` in
    the lag window, else the global maximum if above it."""
    W = 2048
    y64 = torch.nn.functional.pad(y.double().cpu(), (W // 2, W // 2))
    fr = y64.unfold(-1, W, HOP)
    fr = fr - fr.mean(-1, keepdim=True)
    r = torch.fft.irfft(torch.fft.rfft(fr, n=2 * W).abs() ** 2, n=2 * W)
    lo, hi = max(1, int(SR / fmax)), int(SR / fmin) + 1
    rn = r[..., lo:hi] / r[..., :1]
    mid = rn[..., 1:-1]
    peak = (mid > rn[..., :-2]) & (mid > rn[..., 2:]) & (mid > threshold)
    has = peak.any(-1)
    idx = torch.where(has, peak.to(torch.uint8).argmax(-1) + 1, rn.argmax(-1))
    voiced = has | (rn.amax(-1) > threshold)
    f0 = torch.where(voiced, (SR / (lo + idx)).float(), 0.0)
    return f0, voiced, rn.amax(-1)[:, None, :]


def yin_oracle(y: torch.Tensor, fmin: float, fmax: float, threshold: float = 0.1) -> torch.Tensor:
    """float64 YIN on the card at the defaults (frame 2048, window 1024, hop
    512, centre pad of zeros): the difference function summed lag by lag,
    the cumulative mean normalization, the first trough below
    ``threshold`` (else the minimum), parabolic refinement."""
    W, L = 1024, 2048
    min_p, max_p = max(int(np.floor(SR / fmax)), 1), min(int(np.ceil(SR / fmin)), L - W - 1)
    fr = torch.nn.functional.pad(y.double(), (L // 2, L // 2)).unfold(-1, L, HOP)
    head = fr[..., :W]
    d = torch.stack([((head - fr[..., tau : tau + W]) ** 2).sum(-1) for tau in range(max_p + 1)], -1)
    tau = torch.arange(1, max_p + 1, dtype=torch.float64, device=y.device)
    cmnd = torch.cat([torch.ones_like(d[..., :1]),
                      d[..., 1:] * tau / torch.cumsum(d[..., 1:], -1).clamp_min(1e-300)], -1)
    band = cmnd[..., min_p : max_p + 1]
    inf = torch.full_like(band[..., :1], float("inf"))
    left, right = torch.cat([inf, band[..., :-1]], -1), torch.cat([band[..., 1:], inf], -1)
    below = (band < left) & (band <= right) & (band < threshold)
    idx = torch.where(below.any(-1), below.to(torch.uint8).argmax(-1), band.argmin(-1))
    n = band.shape[-1]
    g = lambda i: band.gather(-1, i[..., None])[..., 0]  # noqa: E731
    c, lft, rgt = g(idx), g((idx - 1).clamp_min(0)), g((idx + 1).clamp_max(n - 1))
    den = lft + rgt - 2 * c
    shift = torch.where(den.abs() > 1e-12, 0.5 * (lft - rgt) / torch.where(den == 0, 1.0, den), 0.0)
    shift = torch.where((idx > 0) & (idx < n - 1), shift.clamp(-0.5, 0.5), 0.0)
    return SR / (min_p + idx + shift)


def _fir(up: int, down: int, design: str) -> np.ndarray:
    """The polyphase FIR scipy would use for ``design`` (the port's table's
    source), for the scipy oracle."""
    from scipy.signal import firwin

    from mlx_audio_primitives_tpu_torch.ops.resample import _FIR_DESIGNS, _fir_half_len

    _, rolloff, beta = _FIR_DESIGNS[design]
    return firwin(2 * _fir_half_len(up, down, design) + 1, rolloff / max(up, down),
                  window=("kaiser", beta))


def slice_paths(gen: torch.Generator) -> dict:
    """Phase 4d: the resampling, Griffin-Lim, mel inversion and pitch entry
    points on CUDA tensors, each with every launch counter reset just before
    and read just after; returns the launches summed over these calls."""
    phase("4d. public resampling / Griffin-Lim / mel inversion / pitch paths on cuda tensors")
    from scipy.signal import resample, resample_poly

    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch.kernels import _build
    from mlx_audio_primitives_tpu_torch.utils import dispatch

    dev = gen.device
    total = {k.name: 0 for k in _build.KERNELS}

    def counted(label, expect, fn):
        return counted_call(label, expect, fn, total)

    def plain(fn):
        dispatch.KERNELS_ENABLED = False
        try:
            return fn()
        finally:
            dispatch.KERNELS_ENABLED = True

    def convergence(y, S, hop):
        """Spectral convergence ||STFT(y)| - S| / |S| (plain STFT)."""
        got = ap.stft(y, n_fft=N_FFT, hop_length=hop, use_pallas=False).abs()
        return float(torch.linalg.vector_norm(got - S) / torch.linalg.vector_norm(S))

    def l2_rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    # Griffin-Lim's iterations do not contract differences sample by sample
    # (momentum 0.99, phases of weak cells set by rounding): the JAX package
    # and the port differ by 2.5e-3 of max, 3.4e-4 in L2, on 2 x 30 s on the
    # CPU, with equal spectral convergence. So a Griffin-Lim result is held
    # to its plain route in L2 (1e-2) and by its spectral convergence
    # (within 1e-3 of the plain route's); the largest sample difference is
    # printed, not held.

    # Griffin-Lim at 64 x 30 s: K3 -> K2 -> projection, 32 times, then K3
    y = pitch_clips(gen, FEATURES)
    S = ap.stft(y, n_fft=N_FFT, hop_length=HOP).abs()
    kw = dict(n_iter=GL_ITERS, hop_length=HOP, random_state=0, length=LONG)
    gl = counted(f"griffinlim {FEATURES}", {"stft_kernel": GL_ITERS, "istft_kernel": GL_ITERS + 1},
                 lambda: ap.griffinlim(S, **kw))
    gl_p = ap.griffinlim(S, use_pallas=False, **kw)
    e, e2 = rel_err(gl, gl_p), l2_rel(gl, gl_p)
    sc, sc_p = convergence(gl, S, HOP), convergence(gl_p, S, HOP)
    print(f"griffinlim {tuple(S.shape)} x {GL_ITERS} iterations -> {tuple(gl.shape)}: against the "
          f"plain route {e2:.3e} in L2 (limit 1e-2), {e:.3e} of max (not held); spectral "
          f"convergence {sc:.6f} (plain {sc_p:.6f}, limit: within 1e-3 of it)")
    check(gl.shape == y.shape and bool(torch.isfinite(gl).all()) and e2 <= 1e-2
          and abs(sc - sc_p) <= 1e-3 * sc_p, "griffinlim at 64 x 30 s misses its limits")
    del gl, gl_p, S

    # Griffin-Lim on one clip at hop 441: the overlap-add tier (K4)
    S441 = ap.stft(y[0], n_fft=N_FFT, hop_length=OLA_HOP).abs()
    kw = dict(n_iter=GL_ITERS, hop_length=OLA_HOP, random_state=0, length=LONG)
    gl = counted("griffinlim at hop 441", {"overlap_add_kernel": GL_ITERS + 1},
                 lambda: ap.griffinlim(S441, **kw))
    gl_p = ap.griffinlim(S441, use_pallas=False, **kw)
    e, e2 = rel_err(gl, gl_p), l2_rel(gl, gl_p)
    sc, sc_p = convergence(gl, S441, OLA_HOP), convergence(gl_p, S441, OLA_HOP)
    print(f"griffinlim {tuple(S441.shape)} at hop {OLA_HOP}: against the plain route {e2:.3e} in L2 "
          f"(limit 1e-2), {e:.3e} of max (not held); spectral convergence {sc:.6f} (plain "
          f"{sc_p:.6f}, limit: within 1e-3 of it)")
    check(gl.shape == (LONG,) and e2 <= 1e-2 and abs(sc - sc_p) <= 1e-3 * sc_p,
          "griffinlim at hop 441 disagrees with the plain route")

    # istft at hop 441 (the K4 tier) and through the plain route of a
    # spectrum whose DC and Nyquist bins are not real, as a caller may pass
    # one: the card against the CPU, whose irfft drops those imaginary
    # parts as K3's and the JAX package's do (cuFFT's keeps them)
    Sx = torch.randn((2, N_FFT // 2 + 1, 200), dtype=torch.complex64, generator=gen, device=dev)
    yk = counted("istft of a non-Hermitian spectrum at hop 441", {"overlap_add_kernel": 1},
                 lambda: ap.istft(Sx, hop_length=OLA_HOP))
    yp = ap.istft(Sx, hop_length=OLA_HOP, use_pallas=False)
    yc = ap.istft(Sx.cpu(), hop_length=OLA_HOP)
    e_k, e_p = rel_err(yk, yc), rel_err(yp, yc)
    print(f"istft {tuple(Sx.shape)} at hop {OLA_HOP}, DC and Nyquist not real: against the CPU "
          f"K4 tier {e_k:.3e}, plain route {e_p:.3e} of max (limit 1e-5)")
    check(e_k <= 1e-5 and e_p <= 1e-5, "istft of a non-Hermitian spectrum differs from the CPU")

    # mel_to_audio on 16 x 4 s, 128 mels: NNLS, then Griffin-Lim on K2/K3
    y16 = pitch_clips(gen, MEL_AUDIO)
    M = ap.melspectrogram(y16, sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS)
    kw = dict(sr=SR, n_fft=N_FFT, hop_length=HOP, n_iter=GL_ITERS, random_state=0,
              length=MEL_AUDIO[1])
    rec = counted(f"mel_to_audio {MEL_AUDIO}", {"stft_kernel": GL_ITERS,
                                                "istft_kernel": GL_ITERS + 1},
                  lambda: ap.mel_to_audio(M, **kw))
    rec_p = plain(lambda: ap.mel_to_audio(M, **kw))
    e, e2 = rel_err(rec, rec_p), l2_rel(rec, rec_p)
    mel = lambda r: ap.melspectrogram(r, sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS)  # noqa: E731
    e_mel, e_mel_p = l2_rel(mel(rec), M), l2_rel(mel(rec_p), M)
    print(f"mel_to_audio {tuple(M.shape)} -> {tuple(rec.shape)}: against the plain route {e2:.3e} "
          f"in L2 (limit 1e-2), {e:.3e} of max (not held); the result's mel within {e_mel:.6f} of "
          f"M in L2 (plain route {e_mel_p:.6f}, limit: within 1e-3 of it)")
    check(rec.shape == y16.shape and e2 <= 1e-2 and abs(e_mel - e_mel_p) <= 1e-3 * e_mel_p,
          "mel_to_audio disagrees with the plain route")

    # pitch_detect_acf and periodicity at 64 x 30 s (defaults): K1's ACF
    # entry once each, the dense entry never; the first clips against the
    # float64 oracle
    f0, voiced = counted(f"pitch_detect_acf {FEATURES}", {"mel_fused_acf_kernel": 1},
                         lambda: ap.pitch_detect_acf(y, sr=SR))
    per = counted(f"periodicity {FEATURES}", {"mel_fused_acf_kernel": 1},
                  lambda: ap.periodicity(y, sr=SR))
    f0_o, v_o, per_o = acf_oracle(y[:N_ORACLE], 50.0, 2000.0)
    f0c, vc = f0[:N_ORACLE].cpu(), voiced[:N_ORACLE].cpu()
    e_per = abs_err(per[:N_ORACLE], per_o)
    v_share = float((vc == v_o).float().mean())
    both = vc & v_o
    f0_share = float((f0c[both] == f0_o[both]).float().mean())
    print(f"pitch_detect_acf {tuple(y.shape)} -> {tuple(f0.shape)}: first {N_ORACLE} clips against "
          f"the f64 oracle: voicing equal on {v_share:.5f} of frames, f0 equal on {f0_share:.5f} of "
          f"the frames both voice (limits 0.999); periodicity abs err {e_per:.3e} (limit 1e-4)")
    check(v_share >= 0.999 and f0_share >= 0.999 and e_per <= 1e-4,
          "pitch_detect_acf / periodicity miss the float64 oracle")

    # YIN at 64 x 30 s over fmin 65 .. fmax 2093: no kernel of the port
    f0y = counted(f"yin {FEATURES}", {}, lambda: ap.yin(y, 65.0, 2093.0, sr=SR))
    ref = yin_oracle(y[:2], 65.0, 2093.0)
    rel = ((f0y[:2].double() - ref).abs() / ref)
    share = float((rel <= 5e-3).double().mean())
    print(f"yin {tuple(y.shape)} -> {tuple(f0y.shape)}: first 2 clips against the f64 oracle: "
          f"{share:.5f} of frames within 5e-3 relative (limit 0.999), max {float(rel.max()):.3e}")
    check(bool(torch.isfinite(f0y).all()) and share >= 0.999, "yin misses the float64 oracle")

    # piptrack at 64 x 30 s: K2m once; the first clips against the CPU run
    pit, mag = counted(f"piptrack {FEATURES}", {"stft_mag_kernel": 1},
                       lambda: ap.piptrack(y=y, sr=SR))
    pit_c, mag_c = ap.piptrack(y=y[:N_ORACLE].cpu(), sr=SR)
    pk, mk = pit[:N_ORACLE].cpu(), mag[:N_ORACLE].cpu()
    peaks = (pk > 0) == (pit_c > 0)
    both = (pk > 0) & (pit_c > 0)
    e_p = float(((pk - pit_c).abs()[both]).max() / pit_c.max())
    e_m = float(((mk - mag_c).abs()[both]).max() / mag_c.max())
    print(f"piptrack {tuple(y.shape)} -> {tuple(pit.shape)}: first {N_ORACLE} clips against the CPU: "
          f"peak cells equal on {float(peaks.float().mean()):.7f} of cells (limit 0.9999), where both "
          f"peak pitches {e_p:.3e} and mags {e_m:.3e} of max (limit 1e-4)")
    check(float(peaks.float().mean()) >= 0.9999 and e_p <= 1e-4 and e_m <= 1e-4,
          "piptrack on the card disagrees with the CPU")

    # resample with kaiser_best: 64 x 1 s 44.1 -> 16 kHz (bench config 4)
    # and 64 x 30 s 22.05 -> 16 kHz; scipy in float64 with the same FIR
    for label, (B, L), (orig, target), n_ref in (
        ("64 x 1 s", RESAMPLE_1S, (44100, 16000), 8),
        ("64 x 30 s", FEATURES, (SR, 16000), 2),
    ):
        x = torch.randn((B, L), generator=gen, device=dev)
        out = counted(f"resample kaiser_best {label}", {},
                      lambda: ap.resample(x, orig, target, res_type="kaiser_best"))
        g = int(np.gcd(orig, target))
        up, down = target // g, orig // g
        ref = resample_poly(x[:n_ref].double().cpu().numpy(), up, down, axis=-1,
                            window=_fir(up, down, "kaiser_best"))[:, : out.shape[1]]
        e = float(np.abs(out[:n_ref].double().cpu().numpy() - ref).max())
        print(f"resample kaiser_best {label} {orig} -> {target}: {tuple(out.shape)}, first {n_ref} "
              f"clips against scipy (f64, same FIR) abs err {e:.3e} (limit 2e-5)")
        check(out.shape == (B, int(round(L * target / orig))) and e <= 2e-5,
              f"resample {label} misses 2e-5")

    # resample with res_type='fft' (the default): 64 x 1 s 44.1 -> 16 kHz.
    # The even output length's Nyquist bin folds in an interior bin of the
    # input, a complex one: cuFFT's irfft would keep its imaginary part,
    # scipy's (and the port's) drop it. scipy's resample in float64
    B, L = RESAMPLE_1S
    x = torch.randn((B, L), generator=gen, device=dev)
    out = counted("resample fft 64 x 1 s", {}, lambda: ap.resample(x, 44100, 16000))
    ref = resample(x.double().cpu().numpy(), out.shape[1], axis=-1)
    e = float(np.abs(out.double().cpu().numpy() - ref).max())
    print(f"resample fft 64 x 1 s 44100 -> 16000: {tuple(out.shape)}, against scipy.signal.resample "
          f"(f64) abs err {e:.3e} (limit 2e-4)")
    check(out.shape == (B, 16000) and e <= 2e-4, "resample fft misses 2e-4")
    return total


def slice_times(gen: torch.Generator) -> dict:
    """Phase 5's times of the slice: CUDA-event medians of the public paths
    (kernel route against plain route, in turns), and at the ACF shape K1's
    ACF entry beside the dense entry and the twin, with both bounds.
    Returns the ACF entry's row of the kernels line (times and bound)."""
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.ops import pitch as P

    dev = gen.device
    x44 = torch.randn(RESAMPLE_1S, generator=gen, device=dev)
    t = [cuda_ms(lambda: ap.resample(x44, 44100, 16000, res_type="kaiser_best"), 2, 20)
         for _ in range(2)]
    print(f"bench config 4, resample kaiser_best 64 x 1 s 44.1 -> 16 kHz (no kernel; one FP32 "
          f"GEMM): {t[0]:.4f} / {t[1]:.4f}")

    y1 = pitch_clips(gen, (1, SR))
    S1 = ap.stft(y1, n_fft=N_FFT, hop_length=HOP).abs()
    route_times("bench config 5, griffinlim 32 iterations + yin (65-2093 Hz) on one 1 s clip",
           lambda: (ap.griffinlim(S1, n_iter=GL_ITERS, hop_length=HOP, random_state=0, length=SR),
                    ap.yin(y1, 65.0, 2093.0, sr=SR)), 10)
    route_times("  of which griffinlim alone",
           lambda: ap.griffinlim(S1, n_iter=GL_ITERS, hop_length=HOP, random_state=0, length=SR),
           10)
    t = [cuda_ms(lambda: ap.yin(y1, 65.0, 2093.0, sr=SR), 2, 10) for _ in range(2)]
    print(f"  and yin alone: {t[0]:.4f} / {t[1]:.4f}")
    y = pitch_clips(gen, FEATURES)
    S = ap.stft(y, n_fft=N_FFT, hop_length=HOP).abs()
    route_times("griffinlim 64 x 30 s, 32 iterations",
           lambda: ap.griffinlim(S, n_iter=GL_ITERS, hop_length=HOP, random_state=0, length=LONG), 3)
    # its host-side phase initialisation, the JAX package's draw
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        ang = np.random.default_rng(0).uniform(-np.pi, np.pi, (S.shape[0], S.shape[2], S.shape[1]))
        ang = torch.from_numpy(ang.astype(np.float32)).to(dev)
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
    print(f"  of which the initial phases drawn on the host and copied to the card "
          f"({ang.numel()} values): {host[0]:.1f} / {host[1]:.1f} / {host[2]:.1f}")
    del S, ang
    route_times("pitch_detect_acf 64 x 30 s (defaults)", lambda: ap.pitch_detect_acf(y, sr=SR), 5)
    t = [cuda_ms(lambda: ap.yin(y, 65.0, 2093.0, sr=SR), 1, 3) for _ in range(2)]
    print(f"yin 64 x 30 s (65-2093 Hz, no kernel): {t[0]:.4f} / {t[1]:.4f}")

    # K1 at the ACF shape: 64 x 30 s, n_fft 4096, hop 512, 432 columns. The
    # ACF entry (the public path's) beside the dense entry with the lag
    # basis and the twin, in turns; the bounds of both formulations: the
    # ACF entry's two real FFTs in FP32 and no weight, the dense entry's
    # FFT and its contraction as three TF32 products
    W, n_fft = 2048, 4096
    yp = torch.nn.functional.pad(y, (W // 2, W // 2))
    _, ypad = P._acf_prep(yp, frame_length=W, hop_length=HOP)
    lo, hi = P._lag_bounds(SR, 50.0, 2000.0)
    C = P._acf_lag_basis(n_fft, lo, hi + 1, device=dev)
    win = P._acf_window_table(W, n_fft, device=dev)
    kw1 = dict(n_fft=n_fft, hop_length=HOP, center=False, pad_mode="constant", power=2.0)
    kwa = dict(n_fft=n_fft, hop_length=HOP, lo=lo, hi=hi + 1)
    acf = lambda: k1.acf_fused(ypad, win, **kwa)  # noqa: E731
    dense = lambda: k1.melspectrogram_fused(ypad, win, C, fast_gemm=False, **kw1)  # noqa: E731
    plain = lambda: k1.acf_plain(ypad, win, **kwa)  # noqa: E731
    acf_dev = kernel_device_ms(acf, k1.KERNEL_ACF.name, 5)
    dense_dev = kernel_device_ms(dense, k1.KERNEL.name, 5)
    p_a, a_a, d_a = cuda_ms(plain, 1, 5), cuda_ms(acf, 1, 5), cuda_ms(dense, 1, 5)
    d_b, a_b, p_b = cuda_ms(dense, 1, 5), cuda_ms(acf, 1, 5), cuda_ms(plain, 1, 5)
    B, Lp = ypad.shape
    F, n_bins, n_cols = 1 + (Lp - n_fft) // HOP, n_fft // 2 + 1, C.shape[1]
    io_bytes = 4 * (B * Lp + n_fft + B * n_cols * F)
    fft_fp32 = B * F * (n_fft + _rfft_flops(n_fft) + 3 * n_bins)  # window, transform, powers
    dense_ms, dense_by = _bound(io_bytes + 4 * n_bins * n_cols, fft_fp32, 3 * B * F * 2 * n_bins * n_cols)
    acf_ms, acf_by = _bound(io_bytes, fft_fp32 + B * F * _rfft_flops(n_fft))
    print(f"K1 at the ACF shape ({B}, {Lp}), n_fft {n_fft} hop {HOP}, {n_cols} lags, {F} frames: "
          f"ACF entry device {acf_dev:.4f} ms, dense entry device {dense_dev:.4f} ms "
          f"(torch.profiler, 5 calls); events ACF entry {a_a:.4f} / {a_b:.4f}, dense entry "
          f"{d_a:.4f} / {d_b:.4f}, plain {p_a:.4f} / {p_b:.4f}; bound of the ACF entry's "
          f"formulation {acf_ms:.4f} ({acf_by}: {(fft_fp32 + B * F * _rfft_flops(n_fft)) / 1e9:.1f} "
          f"GFLOP FP32, {io_bytes / 1e6:.1f} MB), of the dense one {dense_ms:.4f} ({dense_by}: "
          f"{3 * B * F * 2 * n_bins * n_cols / 1e9:.1f} GFLOP of TF32 products)")
    bound_ms, bound_by = min((acf_ms, acf_by), (dense_ms, dense_by))
    return {k1.KERNEL_ACF.name: dict(ms=statistics.median([a_a, a_b]),
                                     plain_ms=statistics.median([p_a, p_b]), library_ms=None,
                                     bound_ms=bound_ms, bound_by=bound_by)}


def rhythm_clips(gen: torch.Generator, shape: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Music-like test audio made on the generator's device, float32
    ``(B, L)``, and each clip's tempo: a click track (librosa's click, a
    1 kHz burst decaying with a 10 ms time constant, cut at 0.1 s) at a
    tempo drawn in ``RHYTHM_BPM`` from a start drawn in the first beat, over
    a sustained chord of three notes drawn in MIDI 48-72 (three partials at
    1/k, 0.1 each), plus white noise at 1%."""
    B, L = shape
    dev = gen.device
    f64 = dict(device=dev, dtype=torch.float64)
    t = torch.arange(L, **f64) / SR
    lo, hi = RHYTHM_BPM
    bpm = lo + (hi - lo) * torch.rand((B, 1), generator=gen, **f64)
    period = 60.0 / bpm
    start = period * torch.rand((B, 1), generator=gen, **f64)
    tau = torch.remainder(t - start, period)
    y = torch.sin(2 * np.pi * 1000.0 * tau) * torch.exp(-tau / 0.01) * ((tau < 0.1) & (t >= start))
    notes = 48 + torch.randint(0, 25, (B, 3), generator=gen, device=dev)
    f0 = 440.0 * 2.0 ** ((notes.double() - 69.0) / 12.0)
    for j in range(3):
        for k in range(1, 4):
            y = y + 0.1 / k * torch.sin(2 * np.pi * k * f0[:, j : j + 1] * t)
    y = y + 0.01 * torch.randn((B, L), generator=gen, **f64)
    return y.float(), bpm[:, 0]


def rhythm_kernels_vs_plain(gen: torch.Generator, run, errs: dict) -> None:
    """Phase 3's check of the rhythm-and-harmony slice's new K1 call site:
    K1 with the ``(n_bins, 12)`` chroma weight (one 16-column m-tile, four
    columns of it empty) on 64 x 30 s, power 2 with the default weight and
    power 1 with a detuned one, against its twin; <= 1e-5 of max."""
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.ops.chroma import chroma_filterbank
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window

    dev = gen.device
    y, _ = rhythm_clips(gen, FEATURES)
    win = _get_padded_window("hann", N_FFT, N_FFT, dev)
    kw = dict(n_fft=N_FFT, hop_length=HOP, center=True, pad_mode="constant")
    for power, tuning in ((2.0, 0.0), (1.0, 0.3)):
        fb_t = k1_weight(chroma_filterbank(SR, N_FFT, tuning=tuning, device=dev))
        got = k1_entries(run, errs, f"at the chroma shape {FEATURES} power={power} "
                         f"tuning={tuning}, {tuple(fb_t.shape)} weight", y, win, fb_t,
                         power=power, **kw)
        check(got.shape == (FEATURES[0], 12, 1 + LONG // HOP), "K1's shape at the chroma shape")


def onset_oracle(mel64: torch.Tensor) -> torch.Tensor:
    """float64 onset envelope of a float64 mel ``(B, n_mels, F)``: dB with
    an 80 dB floor under each clip's max, the rectified first difference
    averaged over the mels, one lag frame and the centre's two frames
    padded at the start, cut to F."""
    db = 10.0 * torch.log10(torch.clamp(mel64, min=1e-10))
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
    env = torch.clamp(db[..., 1:] - db[..., :-1], min=0.0).mean(dim=1)
    return torch.nn.functional.pad(env, (1 + N_FFT // (2 * HOP), 0))[..., : mel64.shape[-1]]


def inf_norm_frames(C: torch.Tensor) -> torch.Tensor:
    """Each frame (last axis) over its largest class (axis -2)."""
    return C / C.abs().amax(dim=-2, keepdim=True)


def cqt_oracle(y: torch.Tensor) -> torch.Tensor:
    """float64 CQT at the defaults (fmin C1, 84 bins, n_fft 16384, hop
    512) on ``y``'s device: constant centre pad, rectangular frames, rfft,
    the product with the float64 wavelet table."""
    from mlx_audio_primitives_tpu_torch.ops.cqt import _cqt_fft_basis, _cqt_setup

    fmin, n_fft = _cqt_setup(SR, 84, None, 12, 1.0, 0.0)
    tab = torch.from_numpy(_cqt_fft_basis.host(SR, n_fft, 84, fmin, 12, 1.0)).to(y.device)
    frames = torch.nn.functional.pad(y.double(), (n_fft // 2, n_fft // 2)).unfold(-1, n_fft, HOP)
    return torch.matmul(torch.fft.rfft(frames), torch.complex(tab[0], tab[1]).T).transpose(1, 2)


def tempo_lag_oracle(env: np.ndarray) -> np.ndarray:
    """float64 best tempo lag (frames) of each envelope row at the
    defaults: the 8 s tempogram (linear-ramp pad, np.hanning frames,
    autocorrelation by FFT, inf-norm per frame), its mean over frames,
    the log-normal prior at 120 BPM (1 octave), nothing at or above 320
    BPM."""
    from numpy.lib.stride_tricks import sliding_window_view

    win = int(8.0 * SR // HOP)
    e = np.pad(env.astype(np.float64), ((0, 0), (win // 2, win - 1 - win // 2)),
               mode="linear_ramp", end_values=0.0)
    frames = sliding_window_view(e, win, axis=-1) * np.hanning(win)
    n = 1 << (2 * win - 2).bit_length()
    ac = np.fft.irfft(np.abs(np.fft.rfft(frames, n)) ** 2, n)[..., :win]
    ac = ac / np.maximum(np.abs(ac).max(-1, keepdims=True), np.finfo(np.float64).tiny)
    with np.errstate(divide="ignore"):
        bpms = 60.0 * SR / (HOP * np.arange(win))
        prior = -0.5 * (np.log2(bpms) - np.log2(120.0)) ** 2
    prior[(bpms >= 320.0) | (np.arange(win) == 0)] = -np.inf
    return np.argmax(np.log1p(1e6 * np.maximum(ac.mean(1), 0.0)) + prior, axis=-1)


def beat_oracle(env: np.ndarray, bpm: float) -> np.ndarray:
    """float64 Ellis beat tracker on one envelope at a given tempo (librosa
    `beat_track`'s algorithm, transliterated): the period-matched Gaussian
    smoothing of the std-normalized envelope, the DP (tightness 100, the
    first-beat rule), the last local max at or above half the median local
    max, the backtrace, and the trim at half the RMS of the hann(5)
    smoothed beat strengths."""
    period = max(int(round(60.0 * SR / (bpm * HOP))), 1)
    oe = env.astype(np.float64)
    oe = oe / oe.std(ddof=1)
    t = np.arange(-period, period + 1)
    score = np.convolve(oe, np.exp(-0.5 * (t * 32.0 / period) ** 2), "same")
    F, lo, hi = len(score), 2 * period, max(int(round(period / 2.0)), 1)
    txwt = -100.0 * np.log(np.arange(lo, hi - 1, -1) / period) ** 2
    cum, link, first = np.zeros(lo + F), np.zeros(F, np.int64), True
    for i in range(F):
        cand = txwt + cum[i : i + lo - hi + 1]
        best = int(np.argmax(cand))
        cum[lo + i] = score[i] + cand[best]
        if first and score[i] < 0.01 * score.max():
            link[i] = -1
        else:
            link[i], first = i - lo + best, False
    cum = cum[lo:]
    lm = np.concatenate(([False], (cum[1:-1] > cum[:-2]) & (cum[1:-1] >= cum[2:]),
                         [cum[-1] > cum[-2]]))
    good = np.flatnonzero(lm & (cum >= 0.5 * np.median(cum[lm])))
    beats = [int(good[-1]) if good.size else F - 1]
    while link[beats[-1]] >= 0:
        beats.append(int(link[beats[-1]]))
    beats = np.asarray(beats[::-1])
    boe = np.convolve(score[beats], np.hanning(5), "same")
    keep = np.flatnonzero(boe > 0.5 * np.sqrt(np.mean(boe**2)))
    return beats[keep[0] : keep[-1] + 1] if keep.size else beats[:0]


def pcen_oracle(S: np.ndarray) -> np.ndarray:
    """float64 PCEN at librosa's defaults: scipy's lfilter from lfilter_zi's
    steady state, then the log1p/expm1 compression."""
    from scipy.signal import lfilter, lfilter_zi

    tf = 0.4 * SR / HOP
    b = (np.sqrt(1.0 + 4.0 * tf**2) - 1.0) / (2.0 * tf**2)
    zi = lfilter_zi([b], [1.0, b - 1.0])[0] * S[..., :1]
    M, _ = lfilter([b], [1.0, b - 1.0], S, axis=-1, zi=zi)
    return 2.0**0.5 * np.expm1(0.5 * np.log1p(S * (1e-6 + M) ** -0.98 / 2.0))


def within(got: torch.Tensor, ref, abs_tol: float, rel_tol: float) -> float:
    """The largest ``|got - ref| / (abs_tol + rel_tol |ref|)``: <= 1 holds
    the contract ``|got - ref| <= abs_tol + rel_tol |ref|`` elementwise."""
    g = got.detach().cpu().numpy().astype(np.complex128 if got.is_complex() else np.float64)
    r = ref.detach().cpu().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    return float((np.abs(g - r) / (abs_tol + rel_tol * np.abs(r))).max())


def rhythm_paths(gen: torch.Generator) -> dict:
    """Phase 4e: the rhythm-and-harmony entry points on 64 x 30 s clips made
    on the card, each with every launch counter reset just before and read
    just after; the first clips against float64 oracles. Returns the
    launches summed over these calls."""
    phase(f"4e. public onset / tempo / beat / chroma / CQT / PCEN path on cuda tensors, "
          f"{FEATURES[0]} clips of 30 s")
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch.kernels import _build
    from mlx_audio_primitives_tpu_torch.ops.chroma import _chroma_filterbank_table, _cq_to_chroma_table
    from mlx_audio_primitives_tpu_torch.ops.cqt import _C1

    total = {k.name: 0 for k in _build.KERNELS}
    y, bpm_true = rhythm_clips(gen, FEATURES)
    n_frames = 1 + LONG // HOP

    def call(name, fn, label=""):
        return counted_call(f"{name}{label} {FEATURES}", RHYTHM_LAUNCHES[name], fn, total)

    env = call("onset_strength", lambda: ap.onset_strength(y, sr=SR))
    mel64 = mel_oracle(y[:N_ORACLE])
    e = rel_err(env[:N_ORACLE], onset_oracle(mel64))
    print(f"onset_strength {tuple(y.shape)} -> {tuple(env.shape)}: first {N_ORACLE} clips against "
          f"the f64 oracle {e:.3e} of max (limit 1e-4, the mel contract)")
    check(env.shape == (FEATURES[0], n_frames) and bool(torch.isfinite(env).all()) and e <= 1e-4,
          "onset_strength misses the float64 oracle")

    chroma = call("chroma_stft", lambda: ap.chroma_stft(y=y, sr=SR))
    fbc = torch.from_numpy(_chroma_filterbank_table.host(SR, N_FFT, 12, 0.0, 5.0, 2.0, 2.0, True))
    ref = inf_norm_frames(torch.matmul(power_oracle(y[:N_ORACLE]), fbc.T).transpose(1, 2))
    e = abs_err(chroma[:N_ORACLE], ref)
    print(f"chroma_stft {tuple(y.shape)} -> {tuple(chroma.shape)}: first {N_ORACLE} clips against "
          f"the f64 oracle abs err {e:.3e} (limit 5e-5, the end-to-end chromagram contract)")
    check(chroma.shape == (FEATURES[0], 12, n_frames) and e <= 5e-5,
          "chroma_stft misses the float64 oracle")
    del chroma

    C = call("cqt", lambda: ap.cqt(y, sr=SR))
    C64 = cqt_oracle(y[:2])
    r_c = within(C[:2], C64, 3e-5, 2e-4)
    cc = call("chroma_cqt", lambda: ap.chroma_cqt(y, sr=SR))
    fold = torch.from_numpy(_cq_to_chroma_table.host(84, 12, 12, _C1, True)).to(y.device)
    r_cc = within(cc[:2], inf_norm_frames(torch.matmul(fold, C64.abs())), 3e-5, 2e-4)
    print(f"cqt {tuple(y.shape)} -> {tuple(C.shape)} {C.dtype}, chroma_cqt -> {tuple(cc.shape)}: "
          f"first 2 clips against the f64 oracle at {r_c:.3e} and {r_cc:.3e} of the contract "
          f"|d| <= 3e-5 + 2e-4 |ref| (limit 1)")
    check(C.shape == (FEATURES[0], 84, n_frames) and cc.shape == (FEATURES[0], 12, n_frames)
          and r_c <= 1.0 and r_cc <= 1.0, "cqt / chroma_cqt miss the float64 oracle")
    del C, C64, cc

    tempo = call("tempo", lambda: ap.tempo(onset_envelope=env, sr=SR), " of the envelopes")
    lag = np.rint(60.0 * SR / (HOP * tempo[:, 0])).astype(np.int64)
    lag_o = tempo_lag_oracle(env[:8].cpu().numpy())
    truth = 60.0 * SR / (HOP * bpm_true.cpu().numpy())
    near = np.abs(lag - truth) <= 1.0
    print(f"tempo {tuple(env.shape)} -> {tuple(tempo.shape)}: first 8 clips' lags {lag[:8].tolist()} "
          f"against the f64 oracle's {lag_o.tolist()} (limit: within one lag bin); "
          f"{int(near.sum())} of {len(near)} clips within one lag bin of the click tempo "
          f"(limit 0.9 of them)")
    check(np.abs(lag[:8] - lag_o).max() <= 1 and near.mean() >= 0.9,
          "tempo misses the float64 oracle or the click tempi")

    def mel_pcen():
        M = ap.melspectrogram(y, sr=SR)
        return ap.pcen(M), M

    P, M = call("pcen", mel_pcen, " of the mel")
    r_p = within(P[:N_ORACLE], pcen_oracle(M[:N_ORACLE].double().cpu().numpy()), 3e-5, 2e-4)
    print(f"pcen of the mel {tuple(M.shape)}: first {N_ORACLE} clips against scipy's lfilter "
          f"(f64) at {r_p:.3e} of the contract |d| <= 3e-5 + 2e-4 |ref| (limit 1)")
    check(P.shape == M.shape and r_p <= 1.0, "pcen misses the float64 oracle")
    del P, M

    for i in range(N_ORACLE):
        bpm, beats = call("beat_track", lambda i=i: ap.beat_track(y=y[i], sr=SR), f" of clip {i}")
        ref = beat_oracle(env[i].cpu().numpy(), bpm)
        period = 60.0 * SR / (HOP * float(bpm_true[i]))
        print(f"beat_track clip {i}: {bpm:.2f} BPM (clicks {float(bpm_true[i]):.2f}), "
              f"{len(beats)} beats, index-equal to the f64 oracle: "
              f"{len(beats) == len(ref) and bool(np.all(beats == ref))}; steps "
              f"{np.unique(np.diff(beats)).tolist()} frames (click period {period:.2f})")
        check(len(beats) >= 10 and len(beats) == len(ref) and bool(np.all(beats == ref)),
              f"beat_track on clip {i} misses the float64 oracle")
    return total


def rhythm_times(gen: torch.Generator) -> None:
    """Phase 5's times of the rhythm-and-harmony slice at 64 x 30 s:
    CUDA-event medians of the public paths (kernel route against plain
    route, in turns, where a kernel runs), the CQT's peak memory, the
    host's DP of ``beat_track`` on one clip, and K1's two entries' times at
    the chroma shape with their bounds."""
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch.ops import beat as beat_ops
    from mlx_audio_primitives_tpu_torch.ops.chroma import chroma_filterbank
    from mlx_audio_primitives_tpu_torch.ops.pcen import pcen_smoother
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window

    dev = gen.device
    y, _ = rhythm_clips(gen, FEATURES)
    route_times("onset_strength 64 x 30 s", lambda: ap.onset_strength(y, sr=SR), 5)
    route_times("chroma_stft 64 x 30 s", lambda: ap.chroma_stft(y=y, sr=SR), 5)
    env = ap.onset_strength(y, sr=SR)
    M = ap.melspectrogram(y, sr=SR)
    tf = 0.4 * SR / HOP
    b = torch.full((), (np.sqrt(1.0 + 4.0 * tf**2) - 1.0) / (2.0 * tf**2), device=dev)
    for label, fn, reps in (
        ("tempo 64 x 30 s from the envelope (no kernel; the prior and argmax on the host)",
         lambda: ap.tempo(onset_envelope=env, sr=SR), 5),
        (f"pcen of the 64 x 30 s mel {tuple(M.shape)} (no kernel)", lambda: ap.pcen(M), 5),
        ("  of which the blocked scan (pcen_smoother)", lambda: pcen_smoother(M, b), 5),
        ("cqt 64 x 30 s (no kernel: n_fft 16384 is outside the radix gate)",
         lambda: ap.cqt(y, sr=SR), 3),
        ("chroma_cqt 64 x 30 s (no kernel)", lambda: ap.chroma_cqt(y, sr=SR), 3),
    ):
        t = [cuda_ms(fn, 1, reps) for _ in range(2)]
        print(f"{label}: {t[0]:.4f} / {t[1]:.4f}")
    del M
    route_times("beat_track one 30 s clip (y route: K1, tempo, the local score, the DP on the host)",
                lambda: ap.beat_track(y=y[0], sr=SR), 5)
    # the CQT's peak device memory above what was allocated before the call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    C = ap.cqt(y, sr=SR)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"cqt 64 x 30 s peak device memory: {peak / 2**30:.3f} GiB above the {base / 2**30:.3f} "
          f"GiB held before (output {C.numel() * 8 / 2**30:.3f} GiB)")
    del C
    # beat_track's forward DP on the host, one clip at its tempo
    bpm = float(ap.tempo(onset_envelope=env[0], sr=SR)[0])
    period = max(int(round(60.0 * SR / (bpm * HOP))), 1)
    score = beat_ops._local_score(env[0], period=period).cpu().numpy()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        beat_ops._beat_dp(score, period=period, tightness=100.0)
        host.append(1e3 * (time.perf_counter() - t0))
    print(f"beat_track's DP on the host, one clip ({score.shape[0]} frames, period {period}): "
          f"median {statistics.median(host):.3f} ms of 5 ({min(host):.3f} - {max(host):.3f})")

    # K1's two entries at the chroma shape: 64 x 30 s, n_fft 2048, hop 512,
    # 12 columns
    win = _get_padded_window("hann", N_FFT, N_FFT, dev)
    fb_t = k1_weight(chroma_filterbank(SR, N_FFT, device=dev))
    k1_times(f"the chroma shape {tuple(y.shape)}", y, win, fb_t, 20)


def effects_clips(gen: torch.Generator, shape: tuple[int, int]) -> tuple[torch.Tensor, list]:
    """Test audio of the effects slice, made on the generator's device,
    float32 ``(B, L)``, and each clip's layout: a steady harmonic tone (f0
    drawn in 110-440 Hz, partials 1-3 at 0.3/k), white noise at 1% so that
    every bin carries energy, impulse clicks of amplitude 4 every ~1.5 s,
    and two gaps of exact silence (1-2 s each, drawn in 5-10 s and 18-24 s).
    The layout lists, per clip, ``(f0, clicks, gaps)``: the click samples
    at least 0.1 s from a gap, and the gaps as (start, end) samples."""
    B, L = shape
    dev = gen.device
    f64 = dict(device=dev, dtype=torch.float64)
    t = torch.arange(L, **f64) / SR
    f0 = 110.0 * 2.0 ** (2.0 * torch.rand((B, 1), generator=gen, **f64))
    y = torch.zeros((B, L), **f64)
    for k in (1, 2, 3):
        ph = 2 * np.pi * torch.rand((B, 1), generator=gen, **f64)
        y += 0.3 / k * torch.sin(2 * np.pi * k * f0 * t + ph)
    y += 0.01 * torch.randn((B, L), generator=gen, **f64)
    starts = torch.rand((B, 2), generator=gen, **f64) * torch.tensor([5.0, 6.0], **f64)
    starts += torch.tensor([5.0, 18.0], **f64)
    lengths = 1.0 + torch.rand((B, 2), generator=gen, **f64)
    jitter = (0.2 * SR * torch.rand((B, 20), generator=gen, **f64)).long().cpu().numpy()
    layout = []
    for b in range(B):
        gaps = [(int(s * SR), int((s + d) * SR)) for s, d in zip(starts[b].tolist(), lengths[b].tolist())]
        clicks = []
        for j in range(20):
            p = int(0.5 * SR + 1.5 * SR * j) + int(jitter[b, j])
            if p < L - SR // 2:
                y[b, p] += 4.0
                if all(p < g0 - SR // 10 or p > g1 + SR // 10 for g0, g1 in gaps):
                    clicks.append(p)
        for g0, g1 in gaps:
            y[b, g0:g1] = 0.0
        layout.append((float(f0[b, 0]), clicks, gaps))
    return y.float(), layout


def effects_kernels_vs_plain(gen: torch.Generator, run, errs: dict) -> None:
    """Phase 3's checks of the effects slice's kernel call sites, each
    against its twin within 1e-5 of max: K2 with the reassignment windows
    ``dh`` (negative taps) and ``th`` (up to +-n_fft/2 times ``h``) at 64 x
    30 s; K3 on a phase-vocoded spectrum at rate 0.8 (1,615 frames, DC and
    Nyquist bins not real); K1 and K2 without a centre pad on one streaming
    push (the carry plus 1 s, 43 frames) at batch 64 and at batch 1."""
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch.kernels import istft_fused as k3
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
    from mlx_audio_primitives_tpu_torch.ops.mel import mel_filterbank
    from mlx_audio_primitives_tpu_torch.ops.reassign import _reassign_windows
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window, _istft_envelope_table

    dev = gen.device
    y, _ = effects_clips(gen, FEATURES)
    kw = dict(n_fft=N_FFT, hop_length=HOP, center=True, pad_mode="constant")
    for name, w in zip(("h", "dh", "th"), _reassign_windows("hann", N_FFT, N_FFT)):
        w = torch.from_numpy(w).to(dev)
        got = run(k2.KERNEL, k2.stft_fused, y, w, **kw)
        e = rel_err(got, k2.stft_plain(y, w, **kw))
        print(f"K2 with the reassignment window {name} (taps {float(w.min()):.4g} .. "
              f"{float(w.max()):.4g}) {FEATURES}: rel err {e:.3e} (limit 1e-5)")
        check(e <= 1e-5, f"K2 disagrees with its twin on the window {name}")
        errs[k2.KERNEL.name] = max(errs.get(k2.KERNEL.name, 0.0), abs_err(got, k2.stft_plain(y, w, **kw)))
        del got

    win = _get_padded_window("hann", N_FFT, N_FFT, dev)
    D = k2.stft_fused(y, win, **kw)
    Sv = ap.phase_vocoder(D, 0.8, hop_length=HOP)
    del D
    F = Sv.shape[-1]
    dc_imag = float(torch.maximum(Sv[:, 0].imag.abs().max(), Sv[:, -1].imag.abs().max()))
    T = N_FFT + (F - 1) * HOP
    env = _istft_envelope_table(("hann", None), N_FFT, N_FFT, F, HOP, T, device=dev)
    S = Sv.transpose(1, 2)
    kw3 = dict(n_fft=N_FFT, hop_length=HOP, padded_length=T)
    got = run(k3.KERNEL, k3.istft_fused, S, win, env, **kw3)
    ref = k3.istft_plain(S, win, env, **kw3)
    keep = slice(N_FFT // 2, T - N_FFT // 2)
    e = rel_err(got[:, keep], ref[:, keep])
    print(f"K3 on the rate-0.8 vocoded spectrum {tuple(Sv.shape)} ({F} frames; DC/Nyquist "
          f"imaginary parts up to {dc_imag:.3e}): rel err {e:.3e} over the kept samples (limit 1e-5)")
    check(F == 1615 and dc_imag > 0 and e <= 1e-5, "K3 disagrees with its twin on the vocoded spectrum")
    errs[k3.KERNEL.name] = max(errs.get(k3.KERNEL.name, 0.0), abs_err(got[:, keep], ref[:, keep]))
    del Sv, S, got, ref

    fb_t = k1_weight(mel_filterbank(SR, N_FFT, N_MELS, device=dev))
    kwp = dict(n_fft=N_FFT, hop_length=HOP, center=False, pad_mode="constant")
    push = N_FFT - HOP + STREAM_CHUNK
    for batch in (FEATURES[0], 1):
        ext = y[:batch, :push].contiguous()
        Sx = run(k2.KERNEL, k2.stft_fused, ext, win, **kwp)
        e2 = rel_err(Sx, k2.stft_plain(ext, win, **kwp))
        M = k1_entries(run, errs, f"on one streaming push ({batch}, {push}), no centre pad",
                       ext, win, fb_t, **kwp)
        print(f"one streaming push ({batch}, {push}), no centre pad, {Sx.shape[-1]} frames: K2 rel "
              f"{e2:.3e} (limit 1e-5)")
        check(Sx.shape[-1] == M.shape[-1] == STREAM_CHUNK // HOP and e2 <= 1e-5,
              "K2 disagrees with its twin on a streaming push")


def median_oracle(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """float64 median filter of ``x`` along ``dim`` with scipy.ndimage's
    'reflect' boundary, by its own construction: the edge samples repeat
    (flipped slices), the middle value of each sorted odd window."""
    x = x.double().movedim(dim, -1).contiguous()
    h = size // 2
    xp = torch.cat([x[..., :h].flip(-1), x, x[..., -h:].flip(-1)], dim=-1)
    out = torch.empty_like(x)
    rows = xp.reshape(-1, xp.shape[-1])
    o = out.view(-1, x.shape[-1])
    for r0 in range(0, rows.shape[0], 256):
        o[r0 : r0 + 256] = rows[r0 : r0 + 256].unfold(-1, size, 1).sort(-1).values[..., h]
    return out.movedim(-1, dim)


def pv_oracle(D: torch.Tensor, rate: float) -> torch.Tensor:
    """librosa's phase vocoder as its per-frame recurrence, in complex128 on
    ``D``'s device: magnitudes interpolated, the phase advanced frame by
    frame by the expected rotation plus the wrapped deviation."""
    D = D.to(torch.complex128)
    n_bins, F = D.shape[-2:]
    Dp = torch.nn.functional.pad(D, (0, 2))
    phi = torch.linspace(0, np.pi * HOP, n_bins, dtype=torch.float64, device=D.device)
    acc = torch.angle(Dp[..., 0])
    steps = np.arange(0, F, rate)
    out = torch.empty(D.shape[:-1] + (len(steps),), dtype=torch.complex128, device=D.device)
    for t, step in enumerate(steps):
        i, a = int(step), float(step - int(step))
        c0, c1 = Dp[..., i], Dp[..., i + 1]
        out[..., t] = torch.polar((1 - a) * c0.abs() + a * c1.abs(), acc)
        dp = torch.angle(c1) - torch.angle(c0) - phi
        acc = acc + phi + dp - 2 * np.pi * torch.round(dp / (2 * np.pi))
    return out


def istft_oracle(S: torch.Tensor, length: int) -> torch.Tensor:
    """float64 ISTFT (centre trimmed, cut to ``length``) of ``(B, n_bins,
    F)`` on its device: the DC and Nyquist imaginary parts dropped, irfft,
    the float64 Hann, overlap-add, the squared-window envelope."""
    from mlx_audio_primitives_tpu_torch.ops.windows import window_host

    S = S.to(torch.complex128).clone()
    S[:, 0].imag = 0.0
    S[:, -1].imag = 0.0
    w = torch.from_numpy(window_host("hann", N_FFT)).to(S.device)
    frames = torch.fft.irfft(S.transpose(1, 2), n=N_FFT) * w
    F = frames.shape[1]
    total = N_FFT + (F - 1) * HOP
    fold = dict(output_size=(1, total), kernel_size=(1, N_FFT), stride=(1, HOP))
    y = torch.nn.functional.fold(frames.transpose(1, 2), **fold).reshape(frames.shape[0], total)
    env = torch.nn.functional.fold((w * w).expand(1, F, N_FFT).transpose(1, 2), **fold).reshape(total)
    y = y / torch.clamp(env, min=1e-8)
    y = y[:, N_FFT // 2 : N_FFT // 2 + length]
    return torch.nn.functional.pad(y, (0, length - y.shape[1]))


def burg_oracle(y: torch.Tensor, order: int) -> torch.Tensor:
    """Burg's method in float64 (librosa's loop, vectorized over clips),
    with the prediction errors shrinking by a sample a step."""
    y = y.double()
    B = y.shape[0]
    ar = torch.zeros((B, order + 1), dtype=torch.float64, device=y.device)
    ar[:, 0] = 1.0
    fwd, bwd = y[:, 1:], y[:, :-1]
    den = (fwd * fwd).sum(-1) + (bwd * bwd).sum(-1)
    for i in range(order):
        r = -2.0 * (bwd * fwd).sum(-1) / den
        prev = ar.clone()
        ar[:, 1 : i + 2] = prev[:, 1 : i + 2] + r[:, None] * prev[:, : i + 1].flip(-1)
        fwd_new, bwd_new = fwd + r[:, None] * bwd, bwd + r[:, None] * fwd
        den = (1.0 - r * r) * den - fwd_new[:, 0] ** 2 - bwd_new[:, -1] ** 2
        fwd, bwd = fwd_new[:, 1:], bwd_new[:, :-1]
    return ar


def nonsilent_oracle(y: torch.Tensor, top_db: float = 60.0) -> np.ndarray:
    """float64 frame mask of ``trim``/``split``: the mean square of each
    centred 2048-sample frame (hop 512) in dB under the batch's loudest
    frame, above ``-top_db``, any clip."""
    yp = torch.nn.functional.pad(y.double(), (1024, 1024))
    mse = (yp.unfold(-1, 2048, 512) ** 2).mean(-1)
    db = 10.0 * torch.log10(torch.clamp(mse, min=1e-10) / torch.clamp(mse.max(), min=1e-10))
    return (db.amax(0) > -top_db).cpu().numpy()


def intervals(mask: np.ndarray, n: int) -> np.ndarray:
    edges = np.flatnonzero(np.diff(np.concatenate([[0], mask.astype(np.int8), [0]])))
    return np.minimum(edges * 512, n).reshape(-1, 2)


def pyin_oracle(y: torch.Tensor, fmin: float, fmax: float):
    """pYIN as the port runs it, in float64 on the card: the CMND, the
    threshold integration, the observation, the Viterbi over the float32
    transition tables widened to float64, the backtrace."""
    from mlx_audio_primitives_tpu_torch.ops import pitch as P
    Y = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.pyin")

    fl, wl, hop = 2048, 1024, 512
    min_p, max_p = max(int(np.floor(SR / fmax)), 1), min(int(np.ceil(SR / fmin)), fl - wl - 1)
    yp = torch.nn.functional.pad(y.double(), (fl // 2, fl // 2))
    band = P._yin_cmnd(yp, frame_length=fl, win_length=wl, hop_length=hop, min_period=min_p,
                       max_period=max_p)
    n_bins = int(np.ceil(120.0 * np.log2(fmax / fmin))) + 1
    beta = torch.from_numpy(Y._beta_threshold_prior(100, 2.0, 18.0)).to(y.device)
    obs, vp = Y._pyin_observations(band, beta, boltzmann_parameter=2.0, no_trough_prob=0.01,
                                   n_bins=n_bins, bins_per_semitone=10, min_period=min_p, sr=SR,
                                   fmin=fmin)
    width = 2 * max(int(round(35.92 * 120 / (SR / hop))), 1) + 1
    ll, ls = (torch.from_numpy(a).double().to(y.device)
              for a in Y._transition_tables(n_bins, min(width, 2 * n_bins - 1), 0.01))
    last, bps = Y._pyin_viterbi(obs, vp, ll, ls, n_bins=n_bins)
    f0, voiced = Y._decode(last, bps, n_bins=n_bins, fmin=fmin, bins_per_semitone=10,
                           fill_na=np.nan)
    return f0, voiced, vp.cpu().numpy()


def knn_bad_rows(keep: torch.Tensor, X: torch.Tensor, k: int, tol: float = 1e-3) -> int:
    """Rows of a recurrence matrix (width 1) whose kept pairs are not a k
    nearest selection of the float64 distances between the frames of ``X``
    ``(d, t)`` up to ``tol``: a kept pair farther than the row's k-th
    distance + ``tol``, a dropped one nearer than it - ``tol``, or fewer
    than ``k`` kept. The float32 product ``|x|^2 + |y|^2 - 2 x.y`` leaves
    up to ~7e-4 of rounding in a distance near 0 (chroma frames of a
    steady tone are near duplicates), which reorders such neighbours."""
    Xt = X.double().t().contiguous()
    D = torch.cdist(Xt, Xt, compute_mode="donot_use_mm_for_euclid_dist")
    Dm = D.fill_diagonal_(float("inf"))
    kth = Dm.kthvalue(k, dim=1).values[:, None]
    keep = keep.to(Dm.device)
    bad = (keep & (Dm > kth + tol)) | (~keep & torch.isfinite(Dm) & (Dm < kth - tol))
    return int((bad.any(1) | (keep.sum(1) < k)).sum())


def effects_paths(gen: torch.Generator) -> dict:
    """Phase 4f: the effects, decomposition and streaming entry points on 64
    x 30 s clips made on the card (:func:`effects_clips`), each with every
    launch counter reset just before and read just after; against float64
    oracles on the card where one exists. Returns the launches summed over
    these calls."""
    phase(f"4f. public effects / decomposition / pyin / streaming paths on cuda tensors, "
          f"{FEATURES[0]} clips of 30 s")
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch.kernels import _build
    from mlx_audio_primitives_tpu_torch.ops.decompose import median_filter_1d
    from mlx_audio_primitives_tpu_torch.ops.pitch import pitch_detect_acf
    from mlx_audio_primitives_tpu_torch.utils import dispatch

    dev = gen.device
    total = {k.name: 0 for k in _build.KERNELS}
    y, layout = effects_clips(gen, FEATURES)
    B, L = y.shape

    def call(name, fn, label="", times=1):
        expect = {k: n * times for k, n in EFFECTS_LAUNCHES[name].items()}
        return counted_call(f"{name}{label} {tuple(y.shape)}", expect, fn, total)

    # HPSS: harmonic + percussive add up to the input; the median filters
    # equal a float64 median of the same float32 values
    H = call("harmonic", lambda: ap.harmonic(y))
    P = call("percussive", lambda: ap.percussive(y))
    e = rel_err(H + P, y)
    print(f"harmonic + percussive {tuple(y.shape)}: against the input {e:.3e} of max (limit 1e-4)")
    check(H.shape == P.shape == y.shape and e <= 1e-4, "harmonic + percussive miss the input")
    del H, P
    mag = ap.stft(y[:N_ORACLE]).abs()
    for size, dim in ((31, -1), (31, -2)):
        got = median_filter_1d(mag, size, axis=dim)
        ok = torch.equal(got.double(), median_oracle(mag, size, dim))
        print(f"median filter size {size} along {'time' if dim == -1 else 'frequency'} on "
              f"{tuple(mag.shape)}: equal to the float64 median: {ok}")
        check(ok, "the median filter differs from the float64 median")
    del mag, got

    # time stretch: the vocoder against its float64 recurrence on the same
    # spectrum (K2's), the waveform against a float64 ISTFT of that
    D = ap.stft(y[:2])
    for rate in (0.8, 1.25):
        ys = call("time_stretch", lambda rate=rate: ap.time_stretch(y, rate), f" rate {rate}")
        ref_S = pv_oracle(D, rate)
        e_mag = rel_err(ap.phase_vocoder(D, rate).abs(), ref_S.abs())
        ref = istft_oracle(ref_S, int(round(L / rate)))
        e_y = rel_err(ys[:2], ref)
        l2 = float(torch.linalg.vector_norm(ys[:2].double() - ref) / torch.linalg.vector_norm(ref))
        print(f"time_stretch rate {rate} {tuple(y.shape)} -> {tuple(ys.shape)}: vocoded magnitude "
              f"{e_mag:.3e} of max (limit 2e-5), waveform {e_y:.3e} of max (limit 1e-2), "
              f"{l2:.3e} in L2 (limit 2e-3) against the float64 recurrence on 2 clips")
        check(ys.shape == (B, int(round(L / rate))) and e_mag <= 2e-5 and e_y <= 1e-2 and l2 <= 2e-3,
              f"time_stretch at rate {rate} misses the float64 recurrence")
        del ys, ref_S, ref
    del D
    y1 = call("time_stretch", lambda: ap.time_stretch(y, 1.0), " rate 1.0")
    e = rel_err(y1, y)
    print(f"time_stretch rate 1.0: against the input {e:.3e} of max (limit 1e-3, the float32 "
          f"phase sum over 1,292 frames)")
    check(y1.shape == y.shape and e <= 1e-3, "time_stretch at rate 1.0 misses the input")
    del y1

    for steps in (2, -2):
        got = call("pitch_shift", lambda steps=steps: ap.pitch_shift(y, SR, steps), f" {steps:+d}")
        dispatch.KERNELS_ENABLED = False
        try:
            ref = ap.pitch_shift(y, SR, steps)
        finally:
            dispatch.KERNELS_ENABLED = True
        e = rel_err(got, ref)
        l2 = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
        print(f"pitch_shift {steps:+d} steps {tuple(y.shape)}: kernel route against the plain route "
              f"{e:.3e} of max (limit 1e-2), {l2:.3e} in L2 (limit 1e-3)")
        check(got.shape == y.shape and e <= 1e-2 and l2 <= 1e-3, "pitch_shift routes disagree")
        del got, ref

    # reassignment: tones to their partials, clicks to their instants
    fr, tr, mr = call("reassigned_spectrogram", lambda: ap.reassigned_spectrogram(y, sr=SR))
    check(fr.shape == tr.shape == mr.shape == (B, N_FFT // 2 + 1, 1 + L // HOP),
          "reassigned_spectrogram's shapes")
    fr, tr = fr[:N_ORACLE].cpu().numpy(), tr[:N_ORACLE].cpu().numpy()
    f_err, t_err = 0.0, 0.0
    frame_t = np.arange(fr.shape[-1]) * HOP
    for b in range(N_ORACLE):
        f0, clicks, gaps = layout[b]
        far = np.ones(fr.shape[-1], bool)
        for p in clicks:
            far &= np.abs(frame_t - p) > N_FFT
        for g0, g1 in gaps:
            far &= (frame_t < g0 - N_FFT) | (frame_t > g1 + N_FFT)
        for k in (1, 2, 3):
            kk = int(round(k * f0 / (SR / N_FFT)))
            est = np.nanmedian(fr[b, kk, far])
            f_err = max(f_err, abs(est - k * f0))
        for p in clicks:
            for f in np.flatnonzero(np.abs(frame_t - p) <= N_FFT // 4):
                est = np.nanmedian(tr[b, 300:900, f])
                t_err = max(t_err, abs(est - p / SR))
    print(f"reassigned_spectrogram {tuple(y.shape)} -> {tuple(fr.shape)}: first {N_ORACLE} clips' "
          f"partials at {f_err:.3e} Hz (limit 0.05 Hz), clicks at {t_err:.3e} s (limit 2e-3 s)")
    check(f_err <= 0.05 and t_err <= 2e-3, "reassigned_spectrogram misses the tones or the clicks")
    del fr, tr, mr

    f0, voiced, vp = call("pyin", lambda: ap.pyin(y, fmin=65.0, fmax=2093.0, sr=SR))
    of0, ov, ovp = pyin_oracle(y[:N_ORACLE], 65.0, 2093.0)
    v_eq = float((voiced[:N_ORACLE] == ov).mean())
    both = voiced[:N_ORACLE] & ov
    bins = np.abs(np.round(120 * np.log2(f0[:N_ORACLE][both] / of0[both])))
    e_vp = float(np.abs(vp[:N_ORACLE] - ovp).max())
    print(f"pyin 65-2093 Hz {tuple(y.shape)} -> {f0.shape}, {float(voiced.mean()):.3f} voiced: first "
          f"{N_ORACLE} clips against the float64 run: voicing equal on {v_eq:.4f} of frames (limit "
          f"0.9), f0 bins equal on {float((bins == 0).mean()):.4f} of the frames both voice (median "
          f"difference {float(np.median(bins)):.0f}, limit 0), voiced_prob {e_vp:.3e} (limit 5e-3)")
    check(v_eq >= 0.9 and np.median(bins) == 0 and e_vp <= 5e-3, "pyin misses the float64 run")

    A = call("lpc", lambda: ap.lpc(y, 16))
    e = abs_err(A[:N_ORACLE], burg_oracle(y[:N_ORACLE], 16))
    print(f"lpc order 16 {tuple(y.shape)} -> {tuple(A.shape)}: first {N_ORACLE} clips against a "
          f"float64 Burg {e:.3e} (limit 5e-4)")
    check(A.shape == (B, 17) and e <= 5e-4, "lpc misses the float64 Burg")

    _, iv = call("trim", lambda: ap.trim(y))
    sp = call("split", lambda: ap.split(y))
    ref = intervals(nonsilent_oracle(y), L)
    ok = list(iv) == [ref[0, 0], ref[-1, 1]] and np.array_equal(sp, ref)
    for b in range(N_ORACLE):
        ok &= np.array_equal(ap.split(y[b]), intervals(nonsilent_oracle(y[b : b + 1]), L))
    print(f"trim / split {tuple(y.shape)}: [{iv[0]}, {iv[1]}], {len(sp)} intervals on the batch; "
          f"index-equal to the float64 rms + dB on the batch and on the first {N_ORACLE} clips: {ok}")
    check(ok, "trim / split differ from the float64 rms + dB")

    chroma = ap.chroma_stft(y=y[0], sr=SR)
    R = call("recurrence_matrix", lambda: ap.recurrence_matrix(chroma, mode="affinity"))
    # the k-NN selection itself, on the connectivity matrix (an affinity
    # exp(-D / bandwidth) may underflow to 0 for a kept pair)
    C = call("recurrence_matrix", lambda: ap.recurrence_matrix(chroma), " connectivity")
    C_cpu = ap.recurrence_matrix(chroma.cpu())
    flips = int(((C.cpu() > 0) != (C_cpu > 0)).sum())
    k_nn = min(int(2 * np.ceil(np.sqrt(chroma.shape[1] - 1))), chroma.shape[1] - 1)
    bad_card, bad_cpu = knn_bad_rows(C > 0, chroma, k_nn), knn_bad_rows(C_cpu > 0, chroma, k_nn)
    sm = call("nn_filter", lambda: ap.nn_filter(chroma, rec=R, aggregate="median"))
    e_nn = abs_err(sm, ap.nn_filter(chroma.cpu(), rec=R.cpu(), aggregate="median"))
    mag0 = ap.stft(y[0]).abs()
    objs = []
    for n_iter in (25, 50, 100, 200):
        W, Hc = call("decompose", lambda n=n_iter: ap.decompose(mag0, n_components=8, n_iter=n),
                     f" n_iter {n_iter}")
        objs.append(float(torch.linalg.matrix_norm(mag0.double() - W.double() @ Hc.double())))
    W_cpu, H_cpu = ap.decompose(mag0.cpu(), n_components=8, n_iter=200)
    o_cpu = float(torch.linalg.matrix_norm(mag0.cpu().double() - W_cpu.double() @ H_cpu.double()))
    print(f"recurrence_matrix on one clip's chromagram {tuple(chroma.shape)}: {int((C > 0).sum())} "
          f"pairs ({flips} differ from the CPU's); rows that are not a {k_nn}-nearest selection of "
          f"the float64 distances within 1e-3: card {bad_card}, CPU {bad_cpu} (limit 0); "
          f"nn_filter median against "
          f"the CPU {e_nn:.3e} (limit 1e-6); decompose of |S| {tuple(mag0.shape)}, 8 components: "
          f"objective {', '.join(f'{o:.6g}' for o in objs)} after 25/50/100/200 updates "
          f"(monotone), the CPU's {o_cpu:.6g} (limit 1e-3 apart)")
    check(bad_card == 0 and bad_cpu == 0 and e_nn <= 1e-6
          and all(b <= a for a, b in zip(objs, objs[1:])) and abs(objs[-1] - o_cpu) <= 1e-3 * o_cpu,
          "recurrence_matrix / nn_filter / decompose miss their checks")

    stream_checks(ap, y, call, pitch_detect_acf)
    return total


def stream_checks(ap, y: torch.Tensor, call, pitch_detect_acf) -> None:
    """Phase 4f's streams at batch 64, in 1 s chunks (43 hops), against
    their offline counterparts on the card; each push of the STFT stream
    launches K2 and each push of the mel and chroma streams K1."""
    from mlx_audio_primitives_tpu_torch.utils import dispatch

    B = y.shape[0]
    n = STREAM_PUSHES * STREAM_CHUNK
    x = y[:, :n]
    pad = N_FFT - HOP
    xp = torch.nn.functional.pad(x, (pad, 0))
    St = ap.streaming
    make = {
        "StreamingSTFT": lambda: St.StreamingSTFT(N_FFT, HOP, batch=B),
        "StreamingLogMel": lambda: St.StreamingLogMel(SR, N_FFT, HOP, batch=B),
        "StreamingMFCC": lambda: St.StreamingMFCC(SR, N_FFT, HOP, batch=B),
        "StreamingChroma": lambda: St.StreamingChroma(SR, N_FFT, HOP, batch=B),
        "StreamingPCEN": lambda: St.StreamingPCEN(SR, N_FFT, HOP, batch=B),
        "StreamingPitch": lambda: St.StreamingPitch(SR, frame_length=N_FFT, hop_length=HOP, batch=B),
    }

    def run_stream(name, chunk, src):
        s = make[name]()
        return call(name, lambda: [s.push(src[..., i : i + chunk]) for i in range(0, src.shape[-1], chunk)],
                    f" {STREAM_PUSHES} pushes", STREAM_PUSHES), s

    lim = dict(StreamingSTFT=1e-5, StreamingLogMel=1e-5, StreamingMFCC=1e-5, StreamingPCEN=1e-5)
    mel = ap.melspectrogram(xp, sr=SR, center=False)
    offline = {
        "StreamingSTFT": ap.stft(xp, center=False).transpose(1, 2),
        "StreamingLogMel": ap.power_to_db(mel, top_db=None).transpose(1, 2),
        "StreamingMFCC": ap.mfcc(S=ap.power_to_db(mel, top_db=None)).transpose(1, 2),
        "StreamingPCEN": ap.pcen(mel, sr=SR, hop_length=HOP).transpose(1, 2),
    }
    for name, ref in offline.items():
        got = torch.cat(run_stream(name, STREAM_CHUNK, x)[0], dim=1)
        e = rel_err(got, ref)
        print(f"{name} batch {B}, {STREAM_PUSHES} pushes of {STREAM_CHUNK}: {tuple(got.shape)} against "
              f"offline {e:.3e} of max (limit {lim[name]:g})")
        check(got.shape == ref.shape and e <= lim[name], f"{name} misses its offline counterpart")
    del offline, mel
    got = torch.cat(run_stream("StreamingChroma", STREAM_CHUNK, x)[0], dim=1)
    ref = ap.chroma_stft(y=xp, sr=SR, center=False).transpose(1, 2)
    e = abs_err(got, ref)
    print(f"StreamingChroma batch {B}: against offline chroma_stft {e:.3e} (limit 1e-6)")
    check(got.shape == ref.shape and e <= 1e-6, "StreamingChroma misses chroma_stft")

    outs = run_stream("StreamingPitch", STREAM_CHUNK, x)[0]
    f0, voiced = torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1)
    for label, enabled in (("K1 route", True), ("plain route", False)):
        dispatch.KERNELS_ENABLED = enabled
        try:
            rf0, rv = pitch_detect_acf(xp, sr=SR, center=False)
        finally:
            dispatch.KERNELS_ENABLED = True
        same = float(((voiced == rv) & ((f0 == rf0) | ~rv)).float().mean())
        print(f"StreamingPitch batch {B}: voicing and f0 equal to offline pitch_detect_acf ({label}) "
              f"on {same:.5f} of frames (limit 0.999)")
        check(f0.shape == rf0.shape and same >= 0.999, f"StreamingPitch misses pitch_detect_acf ({label})")

    S = ap.stft(x, center=False)
    inv = St.StreamingISTFT(N_FFT, HOP, batch=B)
    per = STREAM_CHUNK // HOP
    parts = call("StreamingISTFT", lambda: [inv.push(S[:, :, i : i + per].transpose(1, 2))
                                            for i in range(0, S.shape[-1], per)],
                 f" {-(-S.shape[-1] // per)} pushes", -(-S.shape[-1] // per))
    got = torch.cat(parts + [inv.flush()], dim=1)
    ref = ap.istft(S, center=False)
    w2 = ap.get_window("hann", N_FFT).double() ** 2
    env = torch.nn.functional.fold(w2.expand(1, S.shape[-1], N_FFT).transpose(1, 2),
                                   output_size=(1, ref.shape[-1]), kernel_size=(1, N_FFT),
                                   stride=(1, HOP)).reshape(-1)
    ok = env >= 1e-3
    e = rel_err(got[:, ok], ref[:, ok])
    print(f"StreamingISTFT batch {B}: pushes + flush {tuple(got.shape)} against offline istft "
          f"{e:.3e} of max where the envelope is >= 1e-3 (limit 1e-5)")
    check(got.shape == ref.shape and e <= 1e-5, "StreamingISTFT misses istft")
    del S, parts, got, ref

    xr = y[:, : STREAM_PUSHES * SR]
    r = St.StreamingResample(320, 441, batch=B)
    parts = call("StreamingResample", lambda: [r.push(xr[:, i : i + SR]) for i in range(0, xr.shape[1], SR)],
                 f" {STREAM_PUSHES} pushes", STREAM_PUSHES)
    got = torch.cat(parts + [r.flush()], dim=1)
    ref = ap.resample_poly(xr, 320, 441)
    d = (got.double() - ref.double()).abs() / (2e-6 + 1e-5 * ref.double().abs())
    print(f"StreamingResample 22050 -> 16000 Hz batch {B}: {tuple(got.shape)} against resample_poly "
          f"at {float(d.max()):.3e} of the bound 2e-6 + 1e-5 |ref| (limit 1)")
    check(got.shape == ref.shape and float(d.max()) <= 1.0, "StreamingResample misses resample_poly")


def peak_gib(fn) -> tuple[float, float]:
    """(peak device memory above what was held before, held before), GiB,
    over one call of ``fn``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / 2**30, base / 2**30


def effects_times(gen: torch.Generator) -> None:
    """Phase 5's times of the effects slice at 64 x 30 s: CUDA-event medians
    of the public paths (kernel route against plain route, in turns, where a
    kernel runs), the peak memory of ``hpss`` and ``pyin``, pYIN's Viterbi
    on the device and its backtrace on the host, and the per-push latency
    of ``StreamingLogMel`` at batch 1 and 64."""
    import mlx_audio_primitives_tpu_torch as ap
    Y = importlib.import_module("mlx_audio_primitives_tpu_torch.ops.pyin")
    from mlx_audio_primitives_tpu_torch.ops.pitch import _yin_cmnd

    y, _ = effects_clips(gen, FEATURES)
    for label, fn, reps in (
        ("harmonic 64 x 30 s (K2, hpss, K3)", lambda: ap.harmonic(y), 3),
        ("percussive 64 x 30 s", lambda: ap.percussive(y), 3),
        ("time_stretch 0.8 64 x 30 s (K2, vocoder, K3)", lambda: ap.time_stretch(y, 0.8), 3),
        ("time_stretch 1.25 64 x 30 s", lambda: ap.time_stretch(y, 1.25), 3),
        ("pitch_shift +2 64 x 30 s (K2, vocoder, K3, resample fft)", lambda: ap.pitch_shift(y, SR, 2), 3),
        ("reassigned_spectrogram 64 x 30 s (K2 x 3)", lambda: ap.reassigned_spectrogram(y, sr=SR), 3),
    ):
        route_times(label, fn, reps)
    S = ap.stft(y)
    mag0 = S[0].abs()
    chroma = ap.chroma_stft(y=y[0], sr=SR)
    R = ap.recurrence_matrix(chroma, mode="affinity")
    for label, fn, reps in (
        ("hpss of the 64 x 30 s spectrum (no kernel: two median filters, the masks)",
         lambda: ap.hpss(S), 3),
        ("pyin 65-2093 Hz 64 x 30 s (no kernel)", lambda: ap.pyin(y, fmin=65.0, fmax=2093.0, sr=SR), 2),
        ("lpc order 16 64 x 30 s (no kernel)", lambda: ap.lpc(y, 16), 5),
        ("trim 64 x 30 s (rms on the device, the mask on the host)", lambda: ap.trim(y), 5),
        ("split 64 x 30 s", lambda: ap.split(y), 5),
        ("decompose |S| of one clip, 8 components, 200 updates", lambda: ap.decompose(mag0), 3),
        ("recurrence_matrix of one clip's chromagram (affinity)",
         lambda: ap.recurrence_matrix(chroma, mode="affinity"), 5),
        ("nn_filter median of one clip's |S| over its recurrence",
         lambda: ap.nn_filter(mag0, rec=R, aggregate="median"), 1),
    ):
        t = [cuda_ms(fn, 1, reps) for _ in range(2)]
        print(f"{label}: {t[0]:.4f} / {t[1]:.4f}")
    for label, fn in (("hpss", lambda: ap.hpss(S)),
                      ("pyin", lambda: ap.pyin(y, fmin=65.0, fmax=2093.0, sr=SR)),
                      ("nn_filter median of one clip's |S|", lambda: ap.nn_filter(mag0, rec=R,
                                                                                 aggregate="median"))):
        peak, base = peak_gib(fn)
        print(f"{label} 64 x 30 s peak device memory: {peak:.3f} GiB above the {base:.3f} GiB held "
              f"before (the spectrum {S.numel() * 8 / 2**30:.3f} GiB)")
    del S

    # pYIN's parts: the CMND and observations, the Viterbi on the device,
    # the backtrace on the host
    fl, wl, hop, fmin, fmax = 2048, 1024, 512, 65.0, 2093.0
    min_p, max_p = max(int(np.floor(SR / fmax)), 1), min(int(np.ceil(SR / fmin)), fl - wl - 1)
    n_bins = int(np.ceil(120.0 * np.log2(fmax / fmin))) + 1
    yp = torch.nn.functional.pad(y, (fl // 2, fl // 2))
    beta = torch.from_numpy(Y._beta_threshold_prior(100, 2.0, 18.0).astype(np.float32)).to(y.device)
    width = 2 * max(int(round(35.92 * 120 / (SR / hop))), 1) + 1
    ll, ls = (torch.from_numpy(a).to(y.device)
              for a in Y._transition_tables(n_bins, min(width, 2 * n_bins - 1), 0.01))
    band = _yin_cmnd(yp, frame_length=fl, win_length=wl, hop_length=hop, min_period=min_p,
                     max_period=max_p)
    kwo = dict(boltzmann_parameter=2.0, no_trough_prob=0.01, n_bins=n_bins, bins_per_semitone=10,
               min_period=min_p, sr=SR, fmin=fmin)
    obs, vp = Y._pyin_observations(band, beta, **kwo)
    last, bps = Y._pyin_viterbi(obs, vp, ll, ls, n_bins=n_bins)
    t_cmnd = cuda_ms(lambda: _yin_cmnd(yp, frame_length=fl, win_length=wl, hop_length=hop,
                                       min_period=min_p, max_period=max_p), 1, 2)
    t_obs = cuda_ms(lambda: Y._pyin_observations(band, beta, **kwo), 1, 2)
    t_vit = cuda_ms(lambda: Y._pyin_viterbi(obs, vp, ll, ls, n_bins=n_bins), 1, 2)
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Y._decode(last, bps, n_bins=n_bins, fmin=fmin, bins_per_semitone=10, fill_na=np.nan)
        host.append(1e3 * (time.perf_counter() - t0))
    print(f"pyin's parts at 64 x 30 s ({obs.shape[1]} frames, {2 * n_bins} states): CMND "
          f"{t_cmnd:.4f} ms, observations {t_obs:.4f} ms, Viterbi on the device {t_vit:.4f} ms "
          f"({obs.shape[1] - 1} steps), backtrace on the host (the backpointers' copy included) "
          f"median {statistics.median(host):.3f} ms of 3")
    del band, obs, bps

    # per-push latency of the streaming log-mel (K1 once a push), kernel
    # route against plain route, at batch 1 and 64
    for batch in (1, FEATURES[0]):
        s = ap.streaming.StreamingLogMel(SR, N_FFT, HOP, batch=batch)
        chunk = y[:batch, :STREAM_CHUNK].contiguous()
        s.push(chunk)
        route_times(f"StreamingLogMel.push, batch {batch}, 1 s chunk ({STREAM_CHUNK // HOP} frames)",
                    lambda s=s, chunk=chunk: s.push(chunk), 20)


def profile_effects(gen: torch.Generator, card: str) -> None:
    """Phase 6d: where ``harmonic``, ``time_stretch`` and ``pyin`` spend
    their time at 64 x 30 s (:func:`profile_path`)."""
    phase(f"6d. where the effects paths' time goes at 64 x 30 s (torch.profiler, ms per call) on "
          f"{card}")
    import mlx_audio_primitives_tpu_torch as ap

    y, _ = effects_clips(gen, FEATURES)
    print("harmonic:")
    profile_path(lambda: ap.harmonic(y), 2, order=True)
    print("time_stretch rate 0.8:")
    profile_path(lambda: ap.time_stretch(y, 0.8), 2, order=True)
    print("pyin 65-2093 Hz:")
    profile_path(lambda: ap.pyin(y, fmin=65.0, fmax=2093.0, sr=SR), 1, order=False, plain=False)


def loader_clips(gen: torch.Generator, n: int) -> np.ndarray:
    """Phase 4g's files: ``n`` stereo clips of 30 s at 44.1 kHz, float32
    ``(n, 2, L)`` on the host, made on the generator's device: a harmonic
    tone per clip (f0 drawn in 110-440 Hz, partials 1-3 at 0.2/k, each
    channel its own phases and gain), white noise at 1% and clicks of 0.3
    every ~1.5 s: the GTZAN-style tones, noise and clicks of the other
    phases, within [-1, 1]."""
    L = LOADER_SECONDS * LOADER_SR
    dev = gen.device
    f64 = dict(device=dev, dtype=torch.float64)
    t = torch.arange(L, **f64) / LOADER_SR
    f0 = 110.0 * 2.0 ** (2.0 * torch.rand((n, 1, 1), generator=gen, **f64))
    gain = 0.7 + 0.3 * torch.rand((n, 2, 1), generator=gen, **f64)
    y = torch.zeros((n, 2, L), **f64)
    for k in (1, 2, 3):
        ph = 2 * np.pi * torch.rand((n, 2, 1), generator=gen, **f64)
        y += 0.2 / k * torch.sin(2 * np.pi * k * f0 * t + ph)
    y = gain * y + 0.01 * torch.randn((n, 2, L), generator=gen, **f64)
    m = (LOADER_SECONDS - 1) * 2 // 3  # clicks a clip, the last before L - 0.8 s
    clicks = (LOADER_SR // 2 + (1.5 * LOADER_SR * torch.arange(m, device=dev)).long()
              + (0.2 * LOADER_SR * torch.rand((n, m), generator=gen, device=dev)).long())
    y.scatter_add_(2, clicks[:, None, :].expand(n, 2, m), torch.full((n, 2, m), 0.3, **f64))
    return y.clamp(-1.0, 1.0).float().cpu().numpy()


def decoded(x: np.ndarray, bits: int) -> np.ndarray:
    """What a WAV file of float32 ``x`` at ``bits`` decodes to: PCM rounds
    ``x * (2^(bits-1) - 1)`` to an integer and reads it back over
    ``2^(bits-1)``; float32 keeps ``x``."""
    if bits == 32:
        return x
    full = float(2 ** (bits - 1))
    q = np.round(x.astype(np.float64) * (full - 1.0))
    return (q.astype(np.int32).astype(np.float32) / np.float32(full)).astype(np.float32)


def file_bits(i: int) -> int:
    """The bit depth of phase 4g's file ``i``: 16-bit PCM for most, 24-bit
    PCM for one in eight, IEEE float32 for another."""
    return {6: 24, 7: 32}.get(i % 8, 16)


def log_mel_batches(ap, batches) -> list[torch.Tensor]:
    """The pipeline's consumer: ``power_to_db(melspectrogram)`` of each
    batch's clips (K1 once a batch)."""
    return [ap.power_to_db(ap.melspectrogram(b["y"], sr=SR, n_fft=N_FFT, hop_length=HOP,
                                             n_mels=N_MELS)) for b in batches]


def prefetched_log_mel(ap, clips: np.ndarray) -> list[torch.Tensor]:
    """The utilities path: ``batch_iterator`` -> ``prefetch_to_device`` ->
    log-mel."""
    from mlx_audio_primitives_tpu_torch.utils import batch_iterator, prefetch_to_device

    return log_mel_batches(ap, prefetch_to_device(
        batch_iterator({"y": clips}, PIPE_BATCH, seed=0), size=2))


def synchronous_log_mel(ap, clips: np.ndarray) -> list[torch.Tensor]:
    """The same batches, each copied to the default device (the card)
    synchronously (pageable memory, the current stream) before its
    log-mel."""
    from mlx_audio_primitives_tpu_torch.utils import batch_iterator
    from mlx_audio_primitives_tpu_torch.utils.dispatch import default_device

    dev = default_device()
    return log_mel_batches(ap, ({"y": torch.from_numpy(b["y"]).to(dev)}
                                for b in batch_iterator({"y": clips}, PIPE_BATCH, seed=0)))


def loop_ms(fn) -> tuple[float, float]:
    """(wall ms, CUDA-event ms) of one ``fn()``, the device synchronised
    before and after."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return 1e3 * (time.perf_counter() - t0), start.elapsed_time(end)


def utils_kernels_vs_plain(gen: torch.Generator, run, errs: dict) -> None:
    """Phase 3's checks at the utilities path's shapes: K1 with the 128-mel
    weight on one pipeline batch (16 x 30 s), and K1, K2 and K3 on
    warmup's one 1 s clip; limits as elsewhere (1e-5)."""
    from mlx_audio_primitives_tpu_torch.kernels import istft_fused as k3
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
    from mlx_audio_primitives_tpu_torch.ops.mel import mel_filterbank
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window, _istft_envelope_table

    dev = gen.device
    win = _get_padded_window("hann", N_FFT, N_FFT, dev)
    fb_t = k1_weight(mel_filterbank(SR, N_FFT, N_MELS, device=dev))
    kw = dict(n_fft=N_FFT, hop_length=HOP, center=True, pad_mode="constant")
    for shape in ((PIPE_BATCH, LONG), (1, SR)):
        y = torch.randn(shape, generator=gen, device=dev)
        k1_entries(run, errs, f"{shape} (utilities path)", y, win, fb_t, **kw)
    # y is warmup's 1 s clip
    S = run(k2.KERNEL, k2.stft_fused, y, win, **kw)
    ref = k2.stft_plain(y, win, **kw)
    e2 = rel_err(S, ref)
    errs[k2.KERNEL.name] = max(errs[k2.KERNEL.name], abs_err(S, ref))
    S = S.transpose(1, 2)
    T = SR + N_FFT
    env = _istft_envelope_table(("hann", None), N_FFT, N_FFT, S.shape[1], HOP, T, device=dev)
    kw3 = dict(n_fft=N_FFT, hop_length=HOP, padded_length=T)
    got = run(k3.KERNEL, k3.istft_fused, S, win, env, **kw3)
    keep = slice(N_FFT // 2, N_FFT // 2 + SR)
    e3 = abs_err(got[:, keep], k3.istft_plain(S, win, env, **kw3)[:, keep])
    errs[k3.KERNEL.name] = max(errs[k3.KERNEL.name], e3)
    print(f"K2 stft (1, {SR}) (warmup's clip): rel err {e2:.3e}; K3 istft of it: abs err {e3:.3e} "
          f"on the kept samples (limits 1e-5)")
    check(e2 <= 1e-5 and e3 <= 1e-5, "K2 / K3 disagree with their plain twins at warmup's clip")


def utils_paths(gen: torch.Generator, wav_dir: str) -> tuple[dict, dict]:
    """Phase 4g: the utilities path at full width. 64 stereo WAV files of
    30 s at 44.1 kHz written with ``write_wav`` (16-bit PCM, one in eight
    24-bit, one in eight float32), read back with the native codec and the
    NumPy one (bit-equal to each other and to the samples written);
    ``load`` of each at 22,050 Hz (mono, kaiser_best on the card) against
    scipy in float64 with the same FIR; ``batch_iterator`` ->
    ``prefetch_to_device`` -> log-mel (K1 once a batch), bit-equal to the
    same batches copied synchronously and against the float64 mel/dB
    oracle; ``warmup`` of the six ops at (1 s, 30 s) x (1, 64); the
    profilers; a float64 and the default float32 table cache of the mel
    filterbank on the card, each against its host table. Returns the
    launches of the counted calls and what phases 5 and 6e reuse."""
    phase(f"4g. public utilities path: WAV I/O, load, batching and prefetch, log-mel, warmup, "
          f"profilers; {LOADER_FILES} files of 30 s")
    from scipy.signal import resample_poly

    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch import _native
    from mlx_audio_primitives_tpu_torch import utils as U
    from mlx_audio_primitives_tpu_torch.kernels import _build

    total = {k.name: 0 for k in _build.KERNELS}
    check(_native.HAS_NATIVE and _native.has_native_wav(), "the native codec is not loaded")
    x = loader_clips(gen, LOADER_FILES)
    paths = [os.path.join(wav_dir, f"clip{i:02d}.wav") for i in range(LOADER_FILES)]
    t0 = time.perf_counter()
    for i, p in enumerate(paths):
        U.write_wav(p, x[i], LOADER_SR, bits=file_bits(i))
    write_s = time.perf_counter() - t0
    size = sum(os.path.getsize(p) for p in paths)
    print(f"write_wav (native): {LOADER_FILES} files, {size / 1e6:.1f} MB in {write_s:.2f} s")

    # both codecs bit-equal to each other and to what was written
    bad = []
    for i, p in enumerate(paths):
        yn, srn = U.read_wav(p, use_native=True)
        yf, srf = U.read_wav(p, use_native=False)
        want = decoded(x[i], file_bits(i))
        info = U.wav_info(p)
        ok = (srn == srf == LOADER_SR and yn.shape == yf.shape == want.shape
              and np.array_equal(yn.view(np.uint32), yf.view(np.uint32))
              and np.array_equal(yn.view(np.uint32), want.view(np.uint32))
              and info["bits"] == file_bits(i) and info["frames"] == want.shape[1])
        if not ok:
            bad.append(i)
    print(f"read_wav native and NumPy codecs: bit-equal to each other and to the samples written "
          f"on {LOADER_FILES - len(bad)} of {LOADER_FILES} files (16/24/32-bit; limit all)")
    check(not bad, f"read_wav disagrees on files {bad}")

    # load: mono mixdown and kaiser_best to 22,050 Hz on the card; no kernel
    loaded = counted_call(f"load x {LOADER_FILES}", {},
                          lambda: [U.load(p, sr=SR) for p in paths], total)
    check(all(sr == SR and y.dtype == np.float32 and y.shape == (LONG,) and np.isfinite(y).all()
              for y, sr in loaded), "load returned a wrong shape, rate or values")
    g = int(np.gcd(LOADER_SR, SR))
    up, down = SR // g, LOADER_SR // g
    e_load = 0.0
    for i in range(N_ORACLE):
        mono = decoded(x[i], file_bits(i)).astype(np.float64).mean(axis=0)
        ref = resample_poly(mono, up, down, window=_fir(up, down, "kaiser_best"))[:LONG]
        e_load = max(e_load, float(np.abs(loaded[i][0].astype(np.float64) - ref).max()))
    print(f"load(sr={SR}) of each file: ({LONG},) float32; the first {N_ORACLE} against scipy's "
          f"resample_poly of the float64 mono mix (same FIR) abs err {e_load:.3e} (limit 2e-5)")
    check(e_load <= 2e-5, "load misses the resampling contract")
    clips = np.stack([y for y, _ in loaded])
    del loaded

    # the pipeline: prefetched against synchronous, bit for bit
    n_batches = LOADER_FILES // PIPE_BATCH
    t0 = time.perf_counter()
    pre = counted_call(f"batch_iterator -> prefetch_to_device -> log-mel, {n_batches} x "
                       f"({PIPE_BATCH}, {LONG})", {K1_MAIN: n_batches, K6: 2 * n_batches},
                       lambda: prefetched_log_mel(ap, clips), total)
    wall_p = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    syn = counted_call("the same batches copied synchronously",
                       {K1_MAIN: n_batches, K6: 2 * n_batches},
                       lambda: synchronous_log_mel(ap, clips), {k: 0 for k in total})
    wall_s = 1e3 * (time.perf_counter() - t0)
    e_pipe = max(exact_err(a, b) for a, b in zip(pre, syn))
    print(f"prefetched log-mel {tuple(pre[0].shape)} x {len(pre)}: against the synchronous copies "
          f"max |diff| {e_pipe:.3e} (limit 0, bit-equal); first wall times (ms): prefetched "
          f"{wall_p:.1f}, synchronous {wall_s:.1f}")
    check(len(pre) == len(syn) == n_batches and e_pipe == 0.0,
          "the prefetched pipeline disagrees with the synchronous one")
    from mlx_audio_primitives_tpu_torch.utils import batch_iterator

    # the first batch: its mel's first clips against the float64 oracle,
    # its dB against float64 dB of its mel (top_db holds over the batch)
    y0 = torch.from_numpy(next(iter(batch_iterator({"y": clips}, PIPE_BATCH, seed=0)))["y"]).cuda()
    mel0 = ap.melspectrogram(y0, sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS)
    e_mel = rel_err(mel0[:N_ORACLE], mel_oracle(y0[:N_ORACLE]))
    db_ref = 10.0 * torch.log10(torch.clamp(mel0.double().cpu(), min=1e-10))
    e_db = abs_err(pre[0], torch.maximum(db_ref, db_ref.max() - 80.0))
    print(f"the first batch: its first {N_ORACLE} clips' mel rel err vs f64 oracle {e_mel:.3e} "
          f"(limit 1e-4), its dB abs err vs f64 {e_db:.3e} dB (limit 2e-5)")
    check(e_mel <= 1e-4 and e_db <= 2e-5, "the pipeline's log-mel misses its contract")
    del pre, syn

    # warmup of the six ops at (1 s, 30 s) x (1, 64): K1 4, K2 2 and K3 1 a
    # layout, two layouts at batch 1
    lengths, batch_sizes = WARMUP_SHAPES
    layouts = len(lengths) * sum(2 if b == 1 else 1 for b in batch_sizes)
    expect = {k: n * layouts for k, n in WARMUP_LAUNCHES.items()}
    first_call = counted_call(f"warmup {WARMUP_SHAPES}", expect,
                              lambda: U.warmup(*WARMUP_SHAPES, ops=WARMUP_OPS), total)
    second_call = counted_call("warmup, second call", expect,
                               lambda: U.warmup(*WARMUP_SHAPES, ops=WARMUP_OPS),
                               {k: 0 for k in total})
    check(list(first_call) == list(second_call) == [
        f"{op} b={b} len={n}" for b in batch_sizes for n in lengths for op in WARMUP_OPS],
        "warmup's keys")
    print("warmup seconds, first / second call: " + "; ".join(
        f"{k} {first_call[k]:.4f} / {second_call[k]:.4f}" for k in first_call))
    print(f"warmup total: first call {sum(first_call.values()):.3f} s, second "
          f"{sum(second_call.values()):.3f} s; launches as expected: {expect}")

    # the profilers
    y_head = torch.randn(HEADLINE, generator=gen, device=gen.device)
    y_scale = torch.randn(SCALE, generator=gen, device=gen.device)
    for label, y in (("headline", y_head), ("scale", y_scale)):
        fn = lambda y=y: ap.power_to_db(ap.melspectrogram(y, sr=SR, n_fft=N_FFT, hop_length=HOP,
                                                          n_mels=N_MELS))
        ev_a = cuda_ms(fn)
        U.clear_profiling()
        U.enable_profiling()
        try:
            for _ in range(20):
                with U.profile_section(label):
                    fn()
        finally:
            U.disable_profiling()
        ev_b = cuda_ms(fn)
        sec = 1e3 * statistics.median(U.get_profiling_data()["timings"][label])
        ev = (ev_a + ev_b) / 2
        print(f"profile_section around the {label} log-mel {tuple(y.shape)}: median {sec:.4f} ms "
              f"against cuda_ms {ev_a:.4f} / {ev_b:.4f} (limit 0.05 ms + 25%)")
        check(abs(sec - ev) <= 0.05 + 0.25 * ev, f"profile_section disagrees with cuda_ms ({label})")
    U.clear_profiling()
    U.enable_profiling()
    try:
        host = clips[:PIPE_BATCH]
        on_card = U.tracked_to_device(host, "batch")
        back = U.tracked_to_host(ap.melspectrogram(on_card, sr=SR, n_fft=N_FFT, hop_length=HOP,
                                                   n_mels=N_MELS), "mel")
    finally:
        U.disable_profiling()
    transfers = U.get_profiling_data()["transfers"]
    want = [{"direction": "h2d", "context": "batch", "bytes": host.nbytes},
            {"direction": "d2h", "context": "mel", "bytes": back.nbytes}]
    print(f"tracked_to_device / tracked_to_host logged {transfers} (expected {want})")
    check(on_card.device.type == "cuda" and transfers == want
          and back.nbytes == PIPE_BATCH * N_MELS * (1 + LONG // HOP) * 4, "tracked transfers")
    trace_dir = os.path.join(wav_dir, "trace")
    batch = next(iter(U.prefetch_to_device(batch_iterator({"y": clips}, PIPE_BATCH, seed=0))))
    U.start_device_trace(trace_dir)
    log_mel_batches(ap, [batch])
    U.stop_device_trace()
    traces = [os.path.join(r, f) for r, _, fs in os.walk(trace_dir) for f in fs
              if f.endswith(".pt.trace.json")]
    named = sum(K1_MAIN in Path(p).read_text() for p in traces)
    print(f"start/stop_device_trace around one pipeline batch: {len(traces)} trace file(s), "
          f"{named} naming K1's kernel symbol (limit 1)")
    check(len(traces) == 1 and named == 1, "the device trace does not name K1")
    # the table caches' dtype on the card: the mel filterbank's host builder
    # behind a float64 cache is its host table bit for bit; the op's own
    # cache (the default dtype) is that table rounded once to float32
    from mlx_audio_primitives_tpu_torch.ops.mel import _mel_filterbank_table

    fb_args = (SR, N_FFT, N_MELS, 0.0, SR / 2.0, False, "slaney")
    fb_host = _mel_filterbank_table.host(*fb_args)
    fb64_cache = U.table_cache("chip_smoke_mel_f64", dtype=np.float64)(_mel_filterbank_table.host)
    fb64 = fb64_cache(*fb_args, device="cuda")
    fb32 = _mel_filterbank_table(*fb_args, device="cuda")
    ok64 = (fb64.dtype == torch.float64 and fb64.is_cuda and fb64_cache.dtype is np.float64
            and np.array_equal(fb64.cpu().numpy(), fb_host))
    ok32 = (fb32.dtype == torch.float32 and fb32.is_cuda
            and np.array_equal(fb32.cpu().numpy(), fb_host.astype(np.float32)))
    print(f"table_cache(dtype=np.float64) of the mel filterbank {tuple(fb64.shape)} on the card: "
          f"{fb64.dtype} on {fb64.device}, bit-equal to the host table {ok64}; the default cache: "
          f"{fb32.dtype} on {fb32.device}, bit-equal to the host table rounded to float32 {ok32} "
          f"(limit both)")
    check(ok64 and ok32, "a table cache's dtype on the card")
    y64 = torch.from_numpy(clips).cuda()
    out, prof = U.profile_memory(lambda: ap.melspectrogram(y64, sr=SR, n_fft=N_FFT, hop_length=HOP,
                                                           n_mels=N_MELS))
    est = U.estimate_operation_memory("mel", LONG, LOADER_FILES)
    want_bytes = LOADER_FILES * N_MELS * (1 + LONG // HOP) * 4
    print(f"profile_memory(melspectrogram {tuple(y64.shape)}): output_bytes {prof.output_bytes} "
          f"(expected {want_bytes}), peak {prof.peak_mb:.1f} MB of which "
          f"{(prof.peak - prof.active_before) / 1e6:.1f} MB above the {prof.active_before / 1e6:.1f} "
          f"held before, efficiency {prof.efficiency:.3f}; estimate_operation_memory('mel', {LONG}, "
          f"{LOADER_FILES}): {', '.join(f'{k} {v:.1f}' for k, v in est.items())}")
    check(prof.output_bytes == want_bytes == out.numel() * 4, "profile_memory's output bytes")
    del out, y64
    return total, {"paths": paths, "clips": clips, "warmup": (first_call, second_call)}


def utils_times(state: dict) -> None:
    """Phase 5's times of the utilities path: decoding one 30 s stereo file
    (native against NumPy, host ms), ``load`` per file (host ms, and its
    resampling's CUDA-event ms), the prefetched and the synchronous
    pipelines in turns (wall and CUDA-event ms), warmup's calls in this
    process and, in a fresh process, its first and second calls."""
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch import utils as U

    p = state["paths"][0]

    def host_ms(fn, n=5):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(out)

    nat = host_ms(lambda: U.read_wav(p, use_native=True))
    npy = host_ms(lambda: U.read_wav(p, use_native=False))
    y, _ = U.read_wav(p)
    w_nat = host_ms(lambda: U.write_wav(p + ".n.wav", y, LOADER_SR, use_native=True))
    w_npy = host_ms(lambda: U.write_wav(p + ".f.wav", y, LOADER_SR, use_native=False))
    print(f"read_wav of one 30 s stereo 16-bit file ({os.path.getsize(p) / 1e6:.2f} MB), host ms "
          f"(median of 5): native {nat:.2f}, NumPy {npy:.2f}; write_wav native {w_nat:.2f}, "
          f"NumPy {w_npy:.2f}")
    per_file = [host_ms(lambda q=q: U.load(q, sr=SR), 1) for q in state["paths"][:8]]
    mono = torch.from_numpy(U.to_mono(y)).cuda()
    rs = cuda_ms(lambda: ap.resample(mono, LOADER_SR, SR, res_type="kaiser_best"))
    print(f"load(sr={SR}) per file, host ms over 8 files: median {statistics.median(per_file):.2f} "
          f"(min {min(per_file):.2f}, max {max(per_file):.2f}); its resampling on the card "
          f"{rs:.4f} ms (CUDA events)")
    clips = state["clips"]
    runs = {"synchronous": [], "prefetched": []}
    for label in ("synchronous", "prefetched", "prefetched", "synchronous"):
        fn = synchronous_log_mel if label == "synchronous" else prefetched_log_mel
        runs[label].append(loop_ms(lambda fn=fn: fn(ap, clips)))
    for label, rr in runs.items():
        print(f"{label} pipeline, {LOADER_FILES // PIPE_BATCH} batches of ({PIPE_BATCH}, {LONG}): "
              f"wall {rr[0][0]:.2f} / {rr[1][0]:.2f} ms, CUDA events {rr[0][1]:.2f} / "
              f"{rr[1][1]:.2f} ms")
    first, second = state["warmup"]
    print(f"warmup {WARMUP_SHAPES} in this process (kernels built, tables cached): first call "
          f"{sum(first.values()):.3f} s, second {sum(second.values()):.3f} s")
    code = (
        "import json, time; t0 = time.perf_counter(); "
        "import mlx_audio_primitives_tpu_torch.utils as U; t1 = time.perf_counter(); "
        f"a = U.warmup(*{WARMUP_SHAPES!r}, ops={WARMUP_OPS!r}); "
        f"b = U.warmup(*{WARMUP_SHAPES!r}, ops={WARMUP_OPS!r}); "
        "print(json.dumps([t1 - t0, sum(a.values()), sum(b.values()), a]))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(out.returncode == 0, f"warmup in a fresh process failed: {out.stderr[-2000:]}")
    imp, a, b, keys = json.loads(out.stdout.strip().splitlines()[-1])
    slowest = sorted(keys.items(), key=lambda kv: -kv[1])[:3]
    print(f"warmup {WARMUP_SHAPES} in a fresh process (the kernel library on disk): import "
          f"{imp:.3f} s, first call {a:.3f} s (slowest: "
          f"{', '.join(f'{k} {v:.3f}' for k, v in slowest)}), second call {b:.3f} s")


def profile_utils(state: dict, card: str) -> None:
    """Phase 6e: the device's busy time and idle share over the prefetched
    and the synchronous pipelines (:func:`profile_path`)."""
    phase(f"6e. where the utilities pipeline's time goes (torch.profiler, ms per loop of "
          f"{LOADER_FILES // PIPE_BATCH} batches) on {card}")
    import mlx_audio_primitives_tpu_torch as ap

    clips = state["clips"]
    print("prefetched (batch_iterator -> prefetch_to_device -> log-mel):")
    profile_path(lambda: prefetched_log_mel(ap, clips), 1, order=False, plain=False)
    print("synchronous copies:")
    profile_path(lambda: synchronous_log_mel(ap, clips), 1, order=False, plain=False)


def kws_batch(gen: torch.Generator, batch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``batch`` clips of 1 s at 16 kHz for the keyword spotter, made on the
    card: class k is a tone at 200 * 2**k Hz plus 10% noise (the JAX
    package's convnet test task), the labels drawn from ``gen``."""
    dev = torch.device("cuda", 0)
    sr = KWS_FRONTEND["sr"]
    labels = torch.randint(0, KWS_NET["n_classes"], (batch,), generator=gen, device=dev)
    t = torch.arange(sr, device=dev, dtype=torch.float64) / sr
    y = torch.sin(2 * np.pi * (200.0 * 2.0 ** labels.double())[:, None] * t)
    noise = torch.randn((batch, sr), generator=gen, device=dev, dtype=torch.float64)
    return (y + 0.1 * noise).float(), labels


def sp_batch(gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """The sequence-parallel trainer's 64 clips of 172 hops (3.99 s) at
    22,050 Hz, made on the card: class k of 10 is a tone at 110 * 2**(k/2) Hz
    plus 10% noise."""
    dev = torch.device("cuda", 0)
    B, L = SP_TRAIN
    labels = torch.randint(0, 10, (B,), generator=gen, device=dev)
    t = torch.arange(L, device=dev, dtype=torch.float64) / SR
    y = torch.sin(2 * np.pi * (110.0 * 2.0 ** (labels.double() / 2))[:, None] * t)
    noise = torch.randn((B, L), generator=gen, device=dev, dtype=torch.float64)
    return (y + 0.1 * noise).float(), labels


def leaf_errs(got, ref) -> dict[str, float]:
    """max |got - ref| / max |ref| per leaf of two trees of tensors."""
    from mlx_audio_primitives_tpu_torch.utils.tree import leaves

    names = [".".join(p) for p in tree_paths(ref)]
    return {n: rel_err(a, b) for n, a, b in zip(names, leaves(got), leaves(ref))}


def tree_paths(tree, prefix=()) -> list[tuple]:
    """The key paths of a tree of dicts, in ``jax.tree`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k], prefix + (k,))]
    return [prefix]


def local(tree):
    """Each DTensor leaf's local tensor (the whole tensor at one rank)."""
    from mlx_audio_primitives_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: t.to_local() if hasattr(t, "to_local") else t, tree)


def train(step, params, y, labels, n: int) -> tuple[object, list[float], list]:
    """``n`` steps; the losses and the parameters before each step."""
    losses, before = [], []
    for _ in range(n):
        before.append(params)
        params, loss = step(params, y, labels)
        losses.append(float(loss))
    return params, losses, before


class _PinValue(torch.autograd.Function):
    """``value`` forward, the gradient handed to ``x``: a network fed
    through it sees the same activations whichever route computed ``x``."""

    @staticmethod
    def forward(ctx, x, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def parallel_paths(gen: torch.Generator, card: str) -> dict:
    """Phase 4h: ``parallel/`` and the conv trainers of ``models/`` at one
    rank, on a world of one over NCCL (a ``FileStore`` in a temporary
    directory) and a ``(1, 1)`` mesh on the card; then their times (5h) and
    a profile of one training step (6f). The process group is destroyed
    before the phases that follow. Returns the launches of the counted
    calls."""
    phase("4h. parallel and training at one rank: time-sharded log-mel / STFT / ISTFT at "
          f"{FEATURES[0]} x 30 s, the keyword-spotter, sequence-, tensor- and pipeline-parallel "
          "trainers, checkpoint")
    import torch.distributed as dist

    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch import models as M
    from mlx_audio_primitives_tpu_torch import parallel as PP
    from mlx_audio_primitives_tpu_torch.kernels import _build
    from mlx_audio_primitives_tpu_torch.models.convnet import _local_grads
    from mlx_audio_primitives_tpu_torch.models.pipelines import _nll_loss
    from mlx_audio_primitives_tpu_torch.utils.tree import leaves

    total = {k.name: 0 for k in _build.KERNELS}
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = PP.make_mesh(n_data=1, n_time=1)
        check(mesh.device_type == "cuda" and dist.get_backend() == "nccl",
              f"mesh on {mesh.device_type} over {dist.get_backend()}")
        print(f"world of {dist.get_world_size()} over {dist.get_backend()}, mesh {mesh}")

        # the sequence-parallel frontend at the feature path's size
        y = torch.randn(FEATURES, generator=gen, device=dev)
        kw = dict(sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS, center=True)
        lm = counted_call("logmel_time_sharded", {K1_MAIN: 1, K6: 1},
                          lambda: PP.logmel_time_sharded(y, mesh, fft_mode="pallas", **kw), total)
        got = lm.to_local()
        check(tuple(got.shape) == (FEATURES[0], 1 + LONG // HOP, N_MELS), f"shape {got.shape}")
        check(bool(torch.isfinite(got).all()), "non-finite sharded log-mel")
        ref = ap.power_to_db(ap.melspectrogram(y, sr=SR, n_fft=N_FFT, hop_length=HOP,
                                               n_mels=N_MELS), top_db=None).transpose(1, 2)
        e_ref = abs_err(got, ref)
        e_mm = abs_err(got, PP.logmel_time_sharded(y, mesh, fft_mode="matmul", **kw).to_local())
        print(f"logmel_time_sharded {tuple(y.shape)} 'pallas' -> {tuple(got.shape)}: against "
              f"power_to_db(melspectrogram) {e_ref:.3e} dB (limit 2e-5), against 'matmul' "
              f"{e_mm:.3e} dB (limit 2e-3)")
        check(e_ref <= 2e-5 and e_mm <= 2e-3, "sharded log-mel misses its limits")
        del lm, got, ref

        def roundtrip():
            S = PP.stft_time_sharded(y, mesh, n_fft=N_FFT, hop_length=HOP, center=True,
                                     fft_mode="pallas")
            return PP.istft_time_sharded(S, mesh, n_fft=N_FFT, hop_length=HOP, center=True,
                                         length=LONG, fft_mode="pallas")

        rec = counted_call("stft_time_sharded -> istft_time_sharded",
                           {"stft_kernel": 1, "istft_kernel": 1}, roundtrip, total).to_local()
        e_rt = abs_err(rec, y)
        print(f"stft_time_sharded -> istft_time_sharded 'pallas' {tuple(y.shape)}: round trip "
              f"max abs err {e_rt:.3e} (limit 1e-5)")
        check(rec.shape == y.shape and e_rt <= 1e-5, "sharded round trip misses 1e-5")
        del y, rec

        # the keyword spotter: data-parallel convnet over the trainable frontend
        fe = M.TrainableLogMelFrontend(**KWS_FRONTEND)
        net = dict(n_classes=KWS_NET["n_classes"], channels=KWS_NET["channels"])
        params = M.init_audio_classifier_params(fe, seed=0, **net)
        yk, lk = kws_batch(gen, KWS_BATCH[0])

        # the first step's gradient on the two routes. The net is ReLU, so
        # the routes' ~1e-7 difference in the features can flip a unit and
        # move the gradient of the layers below it past 1e-4: the routes'
        # gradients are held at the same activations (the plain route's
        # features on both, each route's own backward through _PinValue),
        # the free comparison printed unheld, and the routes' mel power
        # apart, to the mel contract (1e-4 of max: tones over 10% noise span
        # ~60 dB, so dB near the noise floor carries the FFTs' rounding)
        feats_p = fe.apply(params["frontend"], yk, use_pallas=False)
        e_feat = rel_err(fe.apply(params["frontend"], yk, db=False),
                         fe.apply(params["frontend"], yk, use_pallas=False, db=False))

        def grads(use_pallas, pin):
            def loss(p):
                f = fe.apply(p["frontend"], yk, use_pallas=use_pallas)
                return _nll_loss(M.convnet_apply(p["net"], _PinValue.apply(f, feats_p)
                                                 if pin else f), lk)
            return _local_grads(loss, params)[1]

        errs = leaf_errs(grads(None, True), grads(False, True))
        free = leaf_errs(grads(None, False), grads(False, False))
        print(f"keyword-spotter mel {tuple(feats_p.shape)}, kernel route against plain "
              f"route: rel err {e_feat:.3e} (limit 1e-4)")
        print("first step's gradient at the same activations, kernel route against plain "
              "route, rel err by leaf: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + " (limit 1e-4); each route on its own features, not held (ReLU kinks): "
              + ", ".join(f"{k} {v:.2e}" for k, v in free.items()))
        check(e_feat <= 1e-4, "the kernel route's mel disagrees")
        check(max(errs.values()) <= 1e-4, "the kernel route's gradient disagrees")
        step = M.make_convnet_train_step(mesh, fe, lr=KWS_NET["lr"], **net)
        trained, losses, _ = counted_call(
            f"keyword spotter, {KWS_STEPS} steps", {K1_MAIN: KWS_STEPS, K6: KWS_STEPS},
            lambda: train(step, params, yk, lk, KWS_STEPS), total)
        print(f"keyword spotter {tuple(yk.shape)} x {KWS_STEPS} steps: losses "
              + ", ".join(f"{v:.4f}" for v in losses))
        check(np.isfinite(losses).all() and losses[-1] < losses[0], "keyword-spotter loss")

        pcen = M.pipelines.TrainablePCENFrontend(**KWS_FRONTEND)
        pstep = M.make_convnet_train_step(mesh, pcen, lr=KWS_NET["lr"], **net)
        _, plosses, _ = counted_call(
            f"PCEN keyword spotter, {KWS_STEPS} steps", {K1_MAIN: KWS_STEPS},
            lambda: train(pstep, M.init_audio_classifier_params(pcen, seed=0, **net), yk, lk,
                          KWS_STEPS), total)
        print("PCEN frontend: losses " + ", ".join(f"{v:.4f}" for v in plosses))
        check(np.isfinite(plosses).all() and plosses[-1] < plosses[0], "PCEN-frontend loss")

        # the sequence-parallel trainer at its defaults
        ys, ls = sp_batch(gen)
        sstep = M.make_sharded_train_step(mesh, lr=SP_LR, fft_mode="pallas")
        _, slosses, _ = counted_call(
            f"sequence-parallel trainer, {SP_STEPS} steps", {K1_MAIN: SP_STEPS, K6: SP_STEPS},
            lambda: train(sstep, M.init_classifier_params(N_MELS, 10), ys, ls, SP_STEPS), total)
        print(f"make_sharded_train_step {tuple(ys.shape)} (n_fft {N_FFT}, hop {HOP}, {N_MELS} "
              f"mels, 10 classes, lr {SP_LR}) x {SP_STEPS}: losses "
              + ", ".join(f"{v:.4f}" for v in slosses))
        check(np.isfinite(slosses).all() and slosses[-1] < slosses[0], "sequence-parallel loss")
        del ys, ls

        # tensor and pipeline parallelism at one rank, against the plain models
        tstep = M.make_tp_train_step(PP.make_tp_mesh(1, 1), fe, lr=KWS_NET["lr"], **net)
        _, tlosses, seen = counted_call(
            "tensor-parallel trainer, 5 steps", {K1_MAIN: 5, K6: 5},
            lambda: train(tstep, params, yk, lk, 5), total)
        # the data-parallel step's loss on the same parameters, step by step
        dense = [float(step(p, yk, lk)[1]) for p in seen]
        e_tp = max(abs(a - b) / abs(b) for a, b in zip(tlosses, dense))
        print("make_tp_train_step (1, 1): losses " + ", ".join(f"{v:.4f}" for v in tlosses)
              + f"; against make_convnet_train_step's on the same parameters, rel {e_tp:.2e} "
              "(limit 1e-5)")
        check(tlosses[-1] < tlosses[0] and e_tp <= 1e-5, "tensor-parallel trainer")
        deep = M.init_deep_classifier_params(fe, KWS_NET["n_classes"], n_blocks=4, width=16)
        pps = M.make_pp_train_step(PP.make_pp_mesh(1), fe, n_classes=KWS_NET["n_classes"],
                                   n_blocks=4, width=16, n_microbatches=2, lr=KWS_NET["lr"])
        _, plosses2, seen = counted_call(
            "pipeline-parallel trainer, 5 steps", {K1_MAIN: 5, K6: 5},
            lambda: train(pps, deep, yk, lk, 5), total)
        serial = [float(_nll_loss(M.deep_classifier_apply(fe, local(p), yk), lk)) for p in seen]
        e_pp = max(abs(a - b) / abs(b) for a, b in zip(plosses2, serial))
        print("make_pp_train_step (1 stage, 2 microbatches): losses "
              + ", ".join(f"{v:.4f}" for v in plosses2)
              + f"; against deep_classifier_apply's rel {e_pp:.2e} (limit 1e-5)")
        check(plosses2[-1] < plosses2[0] and e_pp <= 1e-5, "pipeline-parallel trainer")

        # checkpoint of the trained keyword spotter
        state = {"params": trained, "step": KWS_STEPS}
        path = M.save_checkpoint(os.path.join(tmp, "kws"), state)
        back = M.restore_checkpoint(path, target=state)
        same = all(torch.equal(a, b) for a, b in zip(leaves(local(back["params"])),
                                                      leaves(local(trained))))
        print(f"checkpoint {os.path.getsize(path)} bytes: restored bit-equal {same}, "
              f"step {int(back['step'])}")
        check(same and int(back["step"]) == KWS_STEPS, "checkpoint did not come back bit-equal")

        parallel_times(gen, mesh, fe, net)
        profile_training(gen, mesh, fe, net, card)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return total


def parallel_times(gen: torch.Generator, mesh, fe, net: dict) -> None:
    """Phase 5h: CUDA-event ms of one keyword-spotter step at batch 32 and
    256 and of the sequence-parallel frontend at 64 x 30 s, kernel route
    against plain route (:func:`route_times`)."""
    phase("5h. parallel and training times at one rank (CUDA events, ms)")
    from mlx_audio_primitives_tpu_torch import models as M
    from mlx_audio_primitives_tpu_torch import parallel as PP

    step = M.make_convnet_train_step(mesh, fe, lr=KWS_NET["lr"], **net)
    params = M.init_audio_classifier_params(fe, seed=0, **net)
    for b in KWS_BATCH:
        yk, lk = kws_batch(gen, b)
        route_times(f"keyword-spotter step ({b}, {KWS_FRONTEND['sr']})",
                    lambda: step(params, yk, lk), 10)
    y = torch.randn(FEATURES, generator=gen, device=torch.device("cuda", 0))
    route_times(f"logmel_time_sharded {FEATURES} 'pallas'",
                lambda: PP.logmel_time_sharded(y, mesh, sr=SR, n_fft=N_FFT, hop_length=HOP,
                                               n_mels=N_MELS, center=True, fft_mode="pallas"), 10)


def profile_training(gen: torch.Generator, mesh, fe, net: dict, card: str) -> None:
    """Phase 6f: one keyword-spotter step at batch 256 under
    ``torch.profiler`` (:func:`profile_path`): device time by kernel, busy
    time and idle share, kernel and plain routes."""
    phase(f"6f. where a keyword-spotter training step's time goes at batch {KWS_BATCH[-1]} "
          f"(torch.profiler, ms per step) on {card}")
    from mlx_audio_primitives_tpu_torch import models as M

    step = M.make_convnet_train_step(mesh, fe, lr=KWS_NET["lr"], **net)
    params = M.init_audio_classifier_params(fe, seed=0, **net)
    yk, lk = kws_batch(gen, KWS_BATCH[-1])
    profile_path(lambda: step(params, yk, lk), 3, order=True)


def cp_batch(gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """The transformer's 32 clips of 1,722 hops (~10 s) at 22,050 Hz, made
    on the card: class k of 10 is a tone at 110 * 2**(k/2) Hz plus 10%
    noise."""
    dev = torch.device("cuda", 0)
    B, L = CP_TRAIN
    labels = torch.randint(0, CP_NET["n_classes"], (B,), generator=gen, device=dev)
    t = torch.arange(L, device=dev, dtype=torch.float64) / CP["sr"]
    y = torch.sin(2 * np.pi * (110.0 * 2.0 ** (labels.double() / 2))[:, None] * t)
    noise = torch.randn((B, L), generator=gen, device=dev, dtype=torch.float64)
    return (y + 0.1 * noise).float(), labels


class _PinnedFrontend:
    """A frontend whose features are ``value`` whatever it computes, with
    the gradient handed to its own features (:class:`_PinValue`)."""

    def __init__(self, fe, value: torch.Tensor):
        self.fe, self.value, self.n_mels = fe, value, fe.n_mels

    def apply(self, params, y, use_pallas=None):
        return _PinValue.apply(self.fe.apply(params, y, use_pallas=use_pallas), self.value)


#: the JAX package's leaf tolerance for the cp step against its oracle
#: (`tests/test_transformer.py`): |new - ref| <= CP_ATOL + CP_RTOL |ref|
CP_ATOL, CP_RTOL = 5e-6, 5e-4


def step_errs(new, ref) -> dict[str, float]:
    """Per leaf of two parameter trees after a step, the largest
    |new - ref| / (CP_ATOL + CP_RTOL |ref|): at most 1 where the leaf is
    within the JAX package's tolerance."""
    from mlx_audio_primitives_tpu_torch.utils.tree import leaves

    names = [".".join(p) for p in tree_paths(ref)]
    return {n: float(((a.double() - b.double()).abs() / (CP_ATOL + CP_RTOL * b.double().abs())).max())
            for n, a, b in zip(names, leaves(local(new)), leaves(local(ref)))}


def convnet_oracle(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """``convnet_apply`` in float64 on the CPU."""
    from mlx_audio_primitives_tpu_torch.models.convnet import _conv_same

    x = feats.double().cpu()
    x = (x - x.mean(dim=(-2, -1), keepdim=True)) / (
        x.std(dim=(-2, -1), keepdim=True, correction=0) + 1e-5)
    x = x[:, None]
    p = {k: {n: t.double().cpu() for n, t in v.items()} for k, v in params.items()}
    i = 0
    while f"conv{i}" in p:
        x = torch.relu(_conv_same(x, p[f"conv{i}"]["w"], 2) + p[f"conv{i}"]["b"][None, :, None, None])
        i += 1
    return x.mean(dim=(-2, -1)) @ p["head"]["w"] + p["head"]["b"]


def conv_tf32_check(gen: torch.Generator) -> None:
    """The convnet's forward at the keyword spotter's size with cuDNN's TF32
    flag at PyTorch's default (True), against float64 on the CPU: the
    convolutions set the flag off for themselves (`convnet._fp32_cudnn`).
    The same forward with that pin taken out is printed beside it: what a
    caller got before."""
    from contextlib import nullcontext

    from mlx_audio_primitives_tpu_torch import models as M
    from mlx_audio_primitives_tpu_torch.models import convnet

    fe = M.TrainableLogMelFrontend(**KWS_FRONTEND)
    params = M.init_convnet_params(KWS_NET["n_classes"], channels=KWS_NET["channels"], seed=0)
    yk, _ = kws_batch(gen, KWS_BATCH[0])
    feats = fe.apply(fe.init_params(), yk)
    ref = convnet_oracle(params, feats)
    before, pin = torch.backends.cudnn.allow_tf32, convnet._fp32_cudnn
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = M.convnet_apply(params, feats)
        convnet._fp32_cudnn = nullcontext
        unpinned = M.convnet_apply(params, feats)
        torch.cuda.synchronize()
        flags = (f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32 "
                 f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul precision "
                 f"{torch.get_float32_matmul_precision()!r}")
    finally:
        torch.backends.cudnn.allow_tf32, convnet._fp32_cudnn = before, pin
    e, e_raw = rel_err(got, ref), rel_err(unpinned, ref)
    print(f"convnet_apply {tuple(feats.shape)} with {flags}: against float64 on the CPU rel err "
          f"{e:.3e} (limit 1e-5); with the FP32 pin taken out {e_raw:.3e}")
    check(e <= 1e-5, "the convnet's convolutions are not FP32 under cuDNN's TF32 default")


def models_paths(gen: torch.Generator, card: str) -> dict:
    """Phase 4i: the expert-parallel and context-parallel trainers of
    ``models/`` at one rank, in a world of one over NCCL of its own (phase
    4h destroyed its group), the convnet's FP32 check and the
    keyword-spotter example; then their times (5i) and a profile of one cp
    step (6i). Returns the launches of the counted calls."""
    phase("4i. the expert-parallel (Switch MoE) and context-parallel (ring attention) trainers "
          "at one rank, the convnet under cuDNN's TF32 default, examples_torch's keyword spotter")
    import importlib

    import torch.distributed as dist

    from mlx_audio_primitives_tpu_torch import models as M
    from mlx_audio_primitives_tpu_torch import parallel as PP
    from mlx_audio_primitives_tpu_torch.kernels import _build
    from mlx_audio_primitives_tpu_torch.models import transformer as TR
    from mlx_audio_primitives_tpu_torch.models.convnet import _local_grads
    from mlx_audio_primitives_tpu_torch.models.pipelines import _nll_loss

    total = {k.name: 0 for k in _build.KERNELS}
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_models_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                            world_size=1)
    try:
        print(f"world of {dist.get_world_size()} over {dist.get_backend()}; float32 matmul "
              f"precision {torch.get_float32_matmul_precision()!r}, cuda.matmul.allow_tf32 "
              f"{torch.backends.cuda.matmul.allow_tf32}")
        check(torch.get_float32_matmul_precision() == "highest"
              and not torch.backends.cuda.matmul.allow_tf32, "the products would run in TF32")

        # the Switch MoE classifier over the keyword spotter's frontend
        fe = M.TrainableLogMelFrontend(**KWS_FRONTEND)
        n_cls, lr = KWS_NET["n_classes"], KWS_NET["lr"]
        params = M.init_moe_classifier_params(fe, n_cls, n_experts=MOE["n_experts"],
                                              d_hidden=MOE["d_hidden"], seed=0)
        yk, lk = kws_batch(gen, KWS_BATCH[0])
        ep_mesh = PP.make_ep_mesh(1, 1)
        step = M.make_ep_train_step(ep_mesh, fe, n_classes=n_cls, lr=lr, **MOE)
        _, losses, seen = counted_call(
            f"ep trainer, {MOE_STEPS} steps", {K1_MAIN: MOE_STEPS, K6: MOE_STEPS},
            lambda: train(step, params, yk, lk, MOE_STEPS), total)

        def dense_loss(p, frontend=fe, use_pallas=None):
            logits, aux = M.moe_classifier_apply(frontend, p, yk, MOE["n_experts"],
                                                 MOE["capacity_factor"], use_pallas=use_pallas)
            return _nll_loss(logits, lk) + 0.01 * aux

        dense = [float(dense_loss(local(p))) for p in seen]
        e_dense = max(abs(a - b) / abs(b) for a, b in zip(losses, dense))
        print(f"make_ep_train_step (1, 1) {tuple(yk.shape)}: losses "
              + ", ".join(f"{v:.4f}" for v in losses)
              + f"; against moe_classifier_apply's on the same parameters, rel {e_dense:.2e} "
              "(limit 1e-5)")
        check(np.isfinite(losses).all() and losses[-1] < losses[0] and e_dense <= 1e-5,
              "the ep trainer")

        # the first step's gradient, kernel route against plain route at the
        # same activations (routing is an argmax: a rounding-sized change
        # of the tokens can send one to another expert)
        feats_p = fe.apply(params["frontend"], yk, use_pallas=False)
        pinned = _PinnedFrontend(fe, feats_p)
        errs = leaf_errs(_local_grads(lambda p: dense_loss(p, pinned), params)[1],
                         _local_grads(lambda p: dense_loss(p, pinned, False), params)[1])
        print("MoE first step's gradient at the same activations, kernel route against plain "
              "route, rel err by leaf: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + " (limit 1e-4)")
        check(max(errs.values()) <= 1e-4, "the MoE kernel route's gradient disagrees")

        tp_step = M.make_ep_tp_train_step(PP.make_moe_mesh(1, 1, 1), fe, n_classes=n_cls, lr=lr,
                                          **MOE)
        _, tlosses, seen = counted_call(
            f"ep x tp trainer, {MOE_TP_STEPS} steps", {K1_MAIN: MOE_TP_STEPS, K6: MOE_TP_STEPS},
            lambda: train(tp_step, params, yk, lk, MOE_TP_STEPS), total)
        ep_losses = [float(step(p, yk, lk)[1]) for p in seen]
        e_tp = max(abs(a - b) / abs(b) for a, b in zip(tlosses, ep_losses))
        print("make_ep_tp_train_step (1, 1, 1): losses " + ", ".join(f"{v:.4f}" for v in tlosses)
              + f"; against make_ep_train_step's on the same parameters, rel {e_tp:.2e} "
              "(limit 1e-5)")
        check(tlosses[-1] < tlosses[0] and e_tp <= 1e-5, "the ep x tp trainer")
        del seen

        # the ring-attention transformer at its defaults
        mesh = PP.make_mesh(1, 1)
        yc, lc = cp_batch(gen)
        cparams = M.init_transformer_params(CP["n_mels"], n_frames=CP_TRAIN[1] // CP["hop_length"],
                                            seed=0, **CP_NET)
        cstep = M.make_cp_train_step(mesh, fft_mode="pallas", **CP, **CP_NET)
        new1, closses, _ = counted_call(
            f"cp trainer, {CP_STEPS} steps", {K1_MAIN: CP_STEPS, K6: CP_STEPS},
            lambda: train(cstep, cparams, yc, lc, CP_STEPS), total)
        print(f"make_cp_train_step (1, 1) {tuple(yc.shape)} 'pallas' ({CP_TRAIN[1] // CP['hop_length']}"
              " tokens): losses " + ", ".join(f"{v:.4f}" for v in closses))
        check(np.isfinite(closses).all() and closses[-1] < closses[0], "the cp trainer's loss")
        del new1
        first, loss1 = cstep(cparams, yc, lc)
        oracle, oracle_loss = TR.single_device_cp_oracle(cparams, yc, lc, **CP)
        mm, mm_loss = M.make_cp_train_step(mesh, fft_mode="matmul", **CP, **CP_NET)(cparams, yc, lc)
        e_o, e_m = step_errs(first, oracle), step_errs(first, mm)
        l_o = abs(float(loss1) - float(oracle_loss)) / abs(float(oracle_loss))
        l_m = abs(float(loss1) - float(mm_loss)) / abs(float(mm_loss))
        for label, lo, e in (("single_device_cp_oracle", l_o, e_o), ("fft_mode='matmul'", l_m, e_m)):
            print(f"the first cp step, 'pallas' against {label}: loss rel {lo:.2e} (limit 1e-4); "
                  f"new parameters, |diff| / ({CP_ATOL:g} + {CP_RTOL:g} |ref|) by leaf, at most "
                  + ", ".join(f"{k} {v:.2e}" for k, v in e.items()) + " (limit 1)")
        check(l_o <= 1e-4 and l_m <= 1e-4 and max(e_o.values()) <= 1 and max(e_m.values()) <= 1,
              "the cp step disagrees with its oracle")
        del first, oracle, mm

        q, k, v = (torch.randn((CP_TRAIN[0], CP_TRAIN[1] // CP["hop_length"], CP_NET["n_heads"],
                                CP_NET["d_model"] // CP_NET["n_heads"]), generator=gen, device=dev)
                   for _ in range(3))
        e_ring = rel_err(M.ring_attention(q, k, v, mesh[PP.TIME_AXIS]), TR._full_attention(q, k, v))
        print(f"ring_attention at one rank {tuple(q.shape)} against _full_attention: rel err "
              f"{e_ring:.3e} (limit 1e-5)")
        check(e_ring <= 1e-5, "ring attention disagrees with full attention")
        del q, k, v

        conv_tf32_check(gen)

        # examples_torch's keyword spotter at its documented defaults
        kws = importlib.import_module("examples_torch.train_keyword_spotter")
        acc = counted_call("examples_torch/train_keyword_spotter.py (60 steps of 32)",
                           KWS_EXAMPLE_LAUNCHES, lambda: kws.main(checkpoint_dir=tmp), total)
        print(f"keyword-spotter example: accuracy on 256 held-out clips {acc:.3f} (limit > 0.9)")
        check(acc > 0.9, "the keyword-spotter example misses its documented accuracy")

        models_times(gen, fe, params, mesh, cparams)
        profile_cp(cstep, cparams, yc, lc, card)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return total


def models_times(gen: torch.Generator, fe, params: dict, mesh, cparams: dict) -> None:
    """Phase 5i: CUDA-event ms of one MoE step at batch 32 and 256 with its
    peak memory, and of one cp step at 32 x 1,722 tokens, kernel route
    against plain route (:func:`route_times`)."""
    phase("5i. MoE and cp step times at one rank (CUDA events, ms) and peak memory")
    from mlx_audio_primitives_tpu_torch import models as M
    from mlx_audio_primitives_tpu_torch import parallel as PP

    step = M.make_ep_train_step(PP.make_ep_mesh(1, 1), fe, n_classes=KWS_NET["n_classes"],
                                lr=KWS_NET["lr"], **MOE)
    for b in KWS_BATCH:
        yk, lk = kws_batch(gen, b)
        T = b * (1 + KWS_FRONTEND["sr"] // KWS_FRONTEND["hop_length"])
        C = M.expert_parallel.moe_capacity(T, MOE["n_experts"], MOE["capacity_factor"])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(params, yk, lk)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"MoE step ({b}, {KWS_FRONTEND['sr']}): {T} tokens, capacity {C}, dispatch "
              f"({T}, {MOE['n_experts']}, {C}) {4 * T * MOE['n_experts'] * C / 2**30:.3f} GiB; "
              f"peak memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} above the "
              f"{base / 2**30:.3f} GiB held before)")
        route_times(f"MoE step ({b}, {KWS_FRONTEND['sr']})", lambda: step(params, yk, lk), 5)
    del yk, lk
    yc, lc = cp_batch(gen)
    cstep = M.make_cp_train_step(mesh, fft_mode="pallas", **CP, **CP_NET)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cstep(cparams, yc, lc)
    torch.cuda.synchronize()
    print(f"cp step {tuple(yc.shape)}: peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          "GiB")
    route_times(f"cp step {tuple(yc.shape)} 'pallas'", lambda: cstep(cparams, yc, lc), 5)


def profile_cp(cstep, cparams: dict, yc: torch.Tensor, lc: torch.Tensor, card: str) -> None:
    """Phase 6i: one cp step under ``torch.profiler`` (:func:`profile_path`):
    device time by kernel, busy time and idle share, kernel and plain
    routes."""
    phase(f"6i. where a cp training step's time goes at {tuple(yc.shape)} (torch.profiler, ms "
          f"per step) on {card}")
    profile_path(lambda: cstep(cparams, yc, lc), 2, order=True)


def _bound(nbytes: float, ops: float, tf32_ops: float = 0.0,
           bf16_ops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) the card could take: the largest of the bytes over
    the memory rate, the FP32 operations over the FP32 peak and the TF32 and
    bf16 tensor-core operations over their peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max(ops / PEAK_FP32_FLOPS, tf32_ops / PEAK_TF32_FLOPS, bf16_ops / PEAK_BF16_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _rfft_flops(n: int) -> float:
    """A real FFT of n points: 2.5 n log2 n (half a complex FFT's 5 n log2 n)."""
    return 2.5 * n * np.log2(n)


def k1_split(y_scale: torch.Tensor, y_feat: torch.Tensor, win: torch.Tensor,
             fb_t: torch.Tensor, kw: dict, fb_c: torch.Tensor | None = None) -> None:
    """K1's device time (torch.profiler) and CUDA-event median at the scale
    configuration and at 64 x 30 s, beside K2m's device time on the same
    clips: K2m runs the same FFT front end, so the difference is roughly
    K1's power rows and contraction; with ``fb_c`` also at 64 x 30 s with
    that weight (the 12-column chroma table). Both entries where the package
    has the fast one (dense entry as ``fast_gemm=False``), and a digest of
    the dense entry's output bits, to hold two trees' dense entries bit for
    bit."""
    import hashlib

    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2

    fast = hasattr(k1, "KERNEL_FAST")
    entries = [(k1.KERNEL.name, dict(fast_gemm=False) if fast else {})]
    entries += [(k1.KERNEL_FAST.name, dict(fast_gemm=True))] if fast else []
    cases = [("scale (256, 88200)", y_scale, fb_t, 20), ("64 x 30 s", y_feat, fb_t, 5)]
    cases += [("64 x 30 s", y_feat, fb_c, 5)] if fb_c is not None else []
    for label, y, w, calls in cases:
        t2m = kernel_device_ms(lambda: k2.stft_magnitude_fused(y, win, **kw), "stft_kernel", calls)
        for name, mode in entries:
            def call():
                return k1.melspectrogram_fused(y, win, w, **mode, **kw)
            t1 = kernel_device_ms(call, name, calls)
            ev = cuda_ms(call)
            print(f"device time per call, {label} (torch.profiler, {calls} calls): {name} "
                  f"({w.shape[1]} cols) {t1:.4f} ms, K2m {t2m:.4f} ms, difference "
                  f"{t1 - t2m:.4f} ms; CUDA events {ev:.4f} ms")
        if w is fb_t:
            bits = k1.melspectrogram_fused(y, win, w, **entries[0][1], **kw).cpu().numpy().tobytes()
            print(f"{k1.KERNEL.name} output at {label}: sha256 "
                  f"{hashlib.sha256(bits).hexdigest()[:24]}")
    if hasattr(k1, "contracted_blocks"):
        for name, w in (("the 128-mel table", fb_t), ("the chroma table", fb_c)):
            if w is not None:
                used, every = k1.contracted_blocks(w)
                print(f"{k1.KERNEL_FAST.name} contracts {used} of {every} blocks of {name}")


def k1_times(label: str, y: torch.Tensor, win: torch.Tensor, fb_t: torch.Tensor,
             calls: int) -> dict:
    """Phase 5: K1's two entries on ``y`` with the weight ``fb_t`` (N_FFT,
    HOP, centred, power 2): each one's device time per call (torch.profiler)
    and CUDA-event medians in turns (dense twin, fast twin, dense entry,
    fast entry, fast entry, dense entry, fast twin, dense twin), beside its
    bound: the bytes, or the FP32 front end and the three products of the
    contraction at the TF32 (dense) or bf16 (fast) tensor-core peak.
    Returns the kernels-line numbers of each entry."""
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1

    kw = dict(n_fft=N_FFT, hop_length=HOP, center=True, pad_mode="constant")
    B, L = y.shape
    F, n_bins, n_cols = 1 + L // HOP, N_FFT // 2 + 1, fb_t.shape[1]
    nbytes = 4 * (B * L + N_FFT + n_bins * n_cols + B * n_cols * F)
    fp32 = B * F * (N_FFT + _rfft_flops(N_FFT) + 3 * n_bins)  # window, transform, powers
    products = 3 * B * F * 2 * n_bins * n_cols
    entries = {k1.KERNEL.name: (False, _bound(nbytes, fp32, tf32_ops=products), "TF32"),
               k1.KERNEL_FAST.name: (True, _bound(nbytes, fp32, bf16_ops=products), "bf16")}

    def kern(fast):
        return lambda: k1.melspectrogram_fused(y, win, fb_t, fast_gemm=fast, **kw)

    def twin(fast):
        return lambda: k1.melspectrogram_plain(y, win, fb_t, fast_gemm=fast, **kw)

    dev = {name: kernel_device_ms(kern(fast), name, calls) for name, (fast, _, _) in entries.items()}
    order = [twin(False), twin(True), kern(False), kern(True)]
    ev = [cuda_ms(fn) for fn in order + order[::-1]]
    out = {}
    for i, (name, (fast, (bound_ms, bound_by), peak)) in enumerate(entries.items()):
        k_ms, p_ms = (ev[2 + i], ev[5 - i]), (ev[i], ev[7 - i])
        print(f"{name} at {label}, {n_cols} columns, {F} frames: device {dev[name]:.4f} ms "
              f"(torch.profiler, {calls} calls); events kernel {k_ms[0]:.4f} / {k_ms[1]:.4f}, "
              f"twin {p_ms[0]:.4f} / {p_ms[1]:.4f}; bound {bound_ms:.4f} ({bound_by}: "
              f"{nbytes / 1e6:.1f} MB, {fp32 / 1e9:.2f} GFLOP FP32, {products / 1e9:.2f} GFLOP of "
              f"{peak} products)")
        out[name] = dict(ms=statistics.median(k_ms), plain_ms=statistics.median(p_ms),
                         library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
    used, every = k1.contracted_blocks(fb_t)
    print(f"{k1.KERNEL_FAST.name} at {label} contracts {used} of {every} (m-tile, k-step) blocks "
          f"(the bound counts the dense product's)")
    return out


def k3_split(gen: torch.Generator) -> None:
    """Device times (torch.profiler) of K3 and of ``torch.istft`` on one 30 s
    clip and at 64 x 30 s (K3 also on a contiguous ``(B, F, n_bins)``
    spectrum), the public ``istft``'s CUDA-event time on the clip, and K3's
    launch plan, for the port package that is imported."""
    from mlx_audio_primitives_tpu_torch.kernels import istft_fused as k3
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window, _istft_envelope_table

    import mlx_audio_primitives_tpu_torch as ap

    dev = torch.device("cuda", 0)
    win = _get_padded_window("hann", N_FFT, N_FFT, dev)
    kw = dict(n_fft=N_FFT, hop_length=HOP, center=True, pad_mode="constant")
    T = LONG + N_FFT
    for label, B, calls in (("one 30 s clip", 1, 20), ("64 x 30 s", FEATURES[0], 5)):
        S = k2.stft_fused(torch.randn((B, LONG), generator=gen, device=dev), win, **kw)
        St = S.transpose(1, 2)
        env = _istft_envelope_table(("hann", None), N_FFT, N_FFT, St.shape[1], HOP, T, device=dev)
        t3 = kernel_device_ms(lambda: k3.istft_fused(St, win, env, n_fft=N_FFT, hop_length=HOP,
                                                     padded_length=T), "istft_kernel", calls)
        t3_lib = kernel_device_ms(lambda: torch.istft(S, N_FFT, HOP, window=win, center=True,
                                                      length=LONG), None, calls)
        print(f"device time per call, {label} (torch.profiler, {calls} calls): K3 {t3:.4f} ms; "
              f"torch.istft {t3_lib:.4f} ms (all its device operations)")
        if B == 1:  # the public istft on that clip, host path included
            ev = [cuda_ms(lambda: ap.istft(S, hop_length=HOP, length=LONG)) for _ in range(2)]
            print(f"public istft, {label}: CUDA events {ev[0]:.4f} / {ev[1]:.4f} ms")
        if B > 1:  # the (B, F, n_bins) layout, bins contiguous
            Sc = St.contiguous()
            t3c = kernel_device_ms(lambda: k3.istft_fused(Sc, win, env, n_fft=N_FFT, hop_length=HOP,
                                                          padded_length=T), "istft_kernel", calls)
            del Sc
            print(f"device time per call, {label}, K3 on a contiguous (B, F, n_bins) spectrum: "
                  f"{t3c:.4f} ms")
        if hasattr(k3, "launch_plan"):  # an earlier package under --k345-split has none
            g = k3.launch_plan(N_FFT, HOP, B, St.shape[1], T, dev)
            print(f"K3 launch, {label}: grid {g['grid']} x {g['threads']} threads, "
                  f"{g['frames_per_tile']} frames a tile, span {g['span']} hop-rows a block, "
                  f"{g['blocks_per_sm']} blocks per SM; recompute {100 * g['recompute_loaded']:.2f}% "
                  f"of the frames read, {100 * g['recompute_slots']:.2f}% of the frame slots "
                  f"transformed")


def k345_split(gen: torch.Generator) -> None:
    """Device times (torch.profiler) of K3 (``k3_split``) and K4 (hop 441,
    and of ``fold``) on one 30 s clip and at 64 x 30 s, and of K5 on each
    default contrast band of 64 x 30 s and on all four, for the port
    package that is imported."""
    from mlx_audio_primitives_tpu_torch.kernels import overlap_add as k4
    from mlx_audio_primitives_tpu_torch.kernels import select_extremes as k5
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window, _istft_envelope_table

    k3_split(gen)
    dev = torch.device("cuda", 0)
    win = _get_padded_window("hann", N_FFT, N_FFT, dev)
    kw = dict(n_fft=N_FFT, hop_length=HOP, center=True, pad_mode="constant")
    for label, B, calls in (("one 30 s clip", 1, 20), ("64 x 30 s", FEATURES[0], 5)):
        y = torch.randn((B, LONG), generator=gen, device=dev)
        # hop 441 lies outside K2's radix gate: the plain STFT
        S = k2.stft_plain(y, win, n_fft=N_FFT, hop_length=OLA_HOP, center=True, pad_mode="constant")
        frames = (torch.fft.irfft(S.transpose(1, 2), n=N_FFT) * win).contiguous()
        del S
        T = N_FFT + (frames.shape[1] - 1) * OLA_HOP
        env = _istft_envelope_table(("hann", None), N_FFT, N_FFT, frames.shape[1], OLA_HOP, T,
                                    device=dev)
        t4 = kernel_device_ms(lambda: k4.overlap_add_fused(frames, env, hop_length=OLA_HOP,
                                                           output_length=T),
                              "overlap_add_kernel", calls)
        t4_lib = kernel_device_ms(lambda: torch.nn.functional.fold(
            frames.transpose(1, 2), output_size=(1, T), kernel_size=(1, N_FFT),
            stride=(1, OLA_HOP)), None, calls)
        del frames
        print(f"device time per call, {label} (torch.profiler, {calls} calls): K4 (hop "
              f"{OLA_HOP}) {t4:.4f} ms; fold {t4_lib:.4f} ms (all its device operations)")
    mag = k2.stft_magnitude_fused(y, win, **kw)
    per_band = []
    for a, b, k in default_bands():
        x = mag[:, a:b, :].transpose(1, 2)
        per_band.append((b - a, k, kernel_device_ms(
            lambda: k5.quantile_extreme_means_fused(x, k, k), "select_extremes_kernel", 20)))
    print("K5 device time per call, the default contrast bands of 64 x 30 s (torch.profiler, 20 "
          "calls each): " + ", ".join(f"W {w} k {k} {t:.4f}" for w, k, t in per_band)
          + f"; all four {sum(t for _, _, t in per_band):.4f} ms")


def times(gen: torch.Generator, card: str) -> dict:
    """Phase 5: CUDA-event medians, kernel path against plain path, and each
    kernel against its twin, its library call and its bound."""
    phase(f"5. times (CUDA-event medians after warm-up, ms) on {card}")
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch.kernels import db_fused as k6
    from mlx_audio_primitives_tpu_torch.kernels import frame_stats as k7
    from mlx_audio_primitives_tpu_torch.kernels import istft_fused as k3
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.kernels import overlap_add as k4
    from mlx_audio_primitives_tpu_torch.kernels import select_extremes as k5
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
    from mlx_audio_primitives_tpu_torch.ops.features import _get_frequencies
    from mlx_audio_primitives_tpu_torch.ops.mel import mel_filterbank
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window, _istft_envelope_table
    from mlx_audio_primitives_tpu_torch.utils import dispatch

    dev = torch.device("cuda", 0)
    y_head = torch.randn(HEADLINE, generator=gen, device=dev)
    y_scale = torch.randn(SCALE, generator=gen, device=dev)
    y_long = torch.randn((1, LONG), generator=gen, device=dev)
    y_feat = torch.randn(FEATURES, generator=gen, device=dev)
    mel_kw = dict(sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=N_MELS)
    S = ap.stft(y_long, n_fft=N_FFT, hop_length=HOP)

    def features(up):
        # the feature ops take no use_pallas: the kill switch turns every
        # kernel off for the plain path
        dispatch.KERNELS_ENABLED = up is not False
        try:
            return feature_set(ap, y_feat)
        finally:
            dispatch.KERNELS_ENABLED = True

    for label, fn, reps in (
        ("headline mel+dB", lambda up: ap.power_to_db(ap.melspectrogram(y_head, use_pallas=up, **mel_kw)), 20),
        ("scale mel+dB", lambda up: ap.power_to_db(ap.melspectrogram(y_scale, use_pallas=up, **mel_kw)), 20),
        ("30 s stft", lambda up: ap.stft(y_long, n_fft=N_FFT, hop_length=HOP, use_pallas=up), 20),
        ("30 s istft", lambda up: ap.istft(S, hop_length=HOP, length=LONG, use_pallas=up), 20),
        ("features 64 x 30 s", features, 5),
    ):
        plain_a = cuda_ms(lambda: fn(False), 2, reps)
        kern_a = cuda_ms(lambda: fn(None), 2, reps)
        kern_b = cuda_ms(lambda: fn(None), 2, reps)
        plain_b = cuda_ms(lambda: fn(False), 2, reps)
        print(f"{label}: kernel path {kern_a:.4f} / {kern_b:.4f}, plain path {plain_a:.4f} / {plain_b:.4f}")

    # the centroid of 64 x 30 s: spectral_centroid takes its two moments out
    # of K1 with the weight [1, f], as the JAX package does; against the
    # route it left, sum(f*S)/sum(S) over K2m's magnitude
    from mlx_audio_primitives_tpu_torch.ops.stft import magnitude_spectrogram

    win = _get_padded_window("hann", N_FFT, N_FFT, dev)
    kw = dict(n_fft=N_FFT, hop_length=HOP, center=True, pad_mode="constant")

    def centroid_k1():
        return ap.spectral_centroid(y_feat, sr=SR, n_fft=N_FFT, hop_length=HOP)

    def centroid_k2m():
        S = magnitude_spectrogram(y_feat, n_fft=N_FFT, hop_length=HOP)
        return ap.spectral_centroid(S=S, sr=SR, n_fft=N_FFT, hop_length=HOP)

    e = rel_err(centroid_k1(), centroid_k2m())
    check(e <= 1e-5, f"the centroid's two routes disagree: {e:.3e}")
    k1_a, m_a, m_b, k1_b = (cuda_ms(centroid_k1), cuda_ms(centroid_k2m), cuda_ms(centroid_k2m),
                            cuda_ms(centroid_k1))
    print(f"centroid 64 x 30 s: spectral_centroid (K1 moments route) {k1_a:.4f} / {k1_b:.4f}, "
          f"K2m and two reductions {m_a:.4f} / {m_b:.4f} (routes agree to {e:.3e} of max)")

    # bandwidth, rolloff and flatness of 64 x 30 s: each through K2s, against
    # the route it left, K2m's magnitude and the plain passes over it
    for op in ("spectral_bandwidth", "spectral_rolloff", "spectral_flatness"):
        kwo = dict(n_fft=N_FFT, hop_length=HOP, **({} if op == "spectral_flatness" else dict(sr=SR)))
        fn = getattr(ap, op)

        def via_k2s():
            return fn(y_feat, **kwo)

        def via_k2m():
            return fn(S=magnitude_spectrogram(y_feat, n_fft=N_FFT, hop_length=HOP), **kwo)

        s_a, m_a, m_b, s_b = (cuda_ms(via_k2s, 2, 10), cuda_ms(via_k2m, 2, 10),
                              cuda_ms(via_k2m, 2, 10), cuda_ms(via_k2s, 2, 10))
        print(f"{op} 64 x 30 s: through K2s {s_a:.4f} / {s_b:.4f}, K2m and the plain passes "
              f"{m_a:.4f} / {m_b:.4f}")

    # the zero-crossing rate and RMS of 64 x 30 s at the feature cell's pad
    # modes: each through K7, against the plain passes it replaced
    for op, pad_mode in (("zero_crossing_rate", "edge"), ("rms", "constant")):
        fn = getattr(ap, op)
        route_times(f"{op} 64 x 30 s ({pad_mode} pad), K7 against the plain passes",
                    lambda fn=fn, pad_mode=pad_mode: fn(y_feat, pad_mode=pad_mode), 10)

    # each kernel alone against its plain twin and its library call, at the
    # main paths' shapes, with its bound at that shape
    fb_t = k1_weight(mel_filterbank(SR, N_FFT, N_MELS, device=dev))
    n_bins = N_FFT // 2 + 1
    St = S.transpose(1, 2)
    T = LONG + N_FFT
    env = _istft_envelope_table(("hann", None), N_FFT, N_FFT, St.shape[1], HOP, T, device=dev)
    frames = (torch.fft.irfft(ap.stft(y_long, n_fft=N_FFT, hop_length=OLA_HOP).transpose(1, 2), n=N_FFT)
              * win).contiguous()
    T441 = N_FFT + (frames.shape[1] - 1) * OLA_HOP
    env441 = _istft_envelope_table(("hann", None), N_FFT, N_FFT, frames.shape[1], OLA_HOP, T441,
                                   device=dev)
    mag = k2.stft_magnitude_fused(y_feat, win, **kw)
    bands = [(mag[:, a:b, :].transpose(1, 2), k) for a, b, k in default_bands()]
    freq_feat = _get_frequencies(SR, N_FFT, device=dev)
    # K2s's three statistics in the kernels line: the bandwidth under the
    # kernel's own name
    k2s_name = {stat: k2.KERNEL_STATS.name if stat == "bandwidth" else
                f"{k2.KERNEL_STATS.name}[{stat}]" for stat in ("bandwidth", "rolloff", "flatness")}
    # K7's two statistics at the feature cell's pad modes: the ZCR under the
    # kernel's own name
    k7_kw = {"zero_crossing_rate": dict(stat="zero_crossing_rate", frame_length=N_FFT, hop_length=HOP, center=True,
                         pad_mode="edge"),
             "rms": dict(stat="rms", frame_length=N_FFT, hop_length=HOP, center=True,
                         pad_mode="constant")}
    k7_name = {"zero_crossing_rate": k7.KERNEL.name, "rms": f"{k7.KERNEL.name}[rms]"}
    kw3 = dict(n_fft=N_FFT, hop_length=HOP, padded_length=T)
    # K3 and K4 at 64 x 30 s: the spectrum of the feature path's clips, and
    # their windowed frames at hop 441
    S64 = k2.stft_fused(y_feat, win, **kw)
    frames64 = (torch.fft.irfft(k2.stft_plain(y_feat, win, n_fft=N_FFT, hop_length=OLA_HOP,
                                               center=True, pad_mode="constant").transpose(1, 2),
                                n=N_FFT) * win).contiguous()

    # bytes (each input read once, each output written once) and FP32
    # operations of each kernel's function at its shape
    F30 = S.shape[-1]
    Bf, Lf = FEATURES
    Bw, Lw = WHISPER
    Fw = 1 + Lw // WHISPER_KW["hop_length"]
    y_wh = torch.randn(WHISPER, generator=gen, device=dev)
    win_wh = torch.hann_window(400, periodic=True, device=dev)
    fb_wh = mel_filterbank(WHISPER_SR, 400, N_MELS, 0.0, 8000.0, device=dev).t()
    R = 1 + Lf // HOP
    F441 = frames.shape[1]
    fft_frame = N_FFT + _rfft_flops(N_FFT)  # window, then the transform
    work = {
        k2.KERNEL.name: (4 * (LONG + N_FFT) + 8 * n_bins * F30, F30 * fft_frame),
        f"{k2.KERNEL.name}[64 x 30 s]": (4 * (Bf * Lf + N_FFT) + 8 * Bf * n_bins * R,
                                         Bf * R * fft_frame),
        k2.KERNEL_MAG.name: (4 * (Bf * Lf + N_FFT + Bf * n_bins * R),
                             Bf * R * (fft_frame + 4 * n_bins)),
        # K2s: the clips, window and freq table read once, a float a frame
        # written; the magnitude and then the statistic's operations a bin
        # (bench_port/bounds/spectral_*.py's counts: 8, 2, 4)
        **{name: (4 * (Bf * Lf + N_FFT + n_bins + Bf * R),
                  Bf * R * (fft_frame + (4 + per_bin) * n_bins))
           for name, per_bin in ((k2s_name["bandwidth"], 8), (k2s_name["rolloff"], 2),
                                 (k2s_name["flatness"], 4))},
        k3.KERNEL.name: (8 * n_bins * F30 + 4 * (N_FFT + 2 * T),
                         F30 * (_rfft_flops(N_FFT) + 2 * N_FFT) + T),
        # the envelope is read once a launch, whatever the batch
        f"{k3.KERNEL.name}[64 x 30 s]": (8 * Bf * n_bins * R + 4 * (N_FFT + T + Bf * T),
                                         Bf * (R * (_rfft_flops(N_FFT) + 2 * N_FFT) + T)),
        k4.KERNEL.name: (4 * (F441 * N_FFT + 2 * T441), F441 * N_FFT + T441),
        f"{k4.KERNEL.name}[64 x 30 s]": (4 * (Bf * F441 * N_FFT + T441 + Bf * T441),
                                         Bf * (F441 * N_FFT + T441)),
        # a selection reads each value once and compares it at least once
        # for the lo and once for the hi end
        k5.KERNEL.name: (sum(4 * Bf * R * (v.shape[-1] + 2) for v, _ in bands),
                         sum(2 * Bf * R * v.shape[-1] for v, _ in bands)),
        # the dB conversion reads each power once and writes each dB value
        # once; clamp, divide, log10, scale, max and floor a value
        k6.KERNEL.name: (8 * Bf * N_MELS * R, 6 * Bf * N_MELS * R),
        # K1m: the audio, window, weight and mel once; the window, the real
        # FFT and the powers in FP32 (its three bf16 products: k1m_products)
        K1M: (4 * (Bw * Lw + 400 + 201 * N_MELS + Bw * N_MELS * Fw),
              Bw * Fw * (400 + _rfft_flops(400) + 3 * 201)),
        # K6's per-item form as the front end calls it, on the mel less its
        # last frame: the same operations and the affine's two a value
        K6_ITEM: (8 * Bw * N_MELS * (Fw - 1), 8 * Bw * N_MELS * (Fw - 1)),
        # K7: the clips read once, a float a frame written; a sign comparison
        # and an add a sample of each frame (ZCR), a square and an add and a
        # root a frame (RMS): bench_port/bounds/zero_crossing_rate.py, rms.py
        k7_name["zero_crossing_rate"]: (4 * (Bf * Lf + Bf * R), 2 * Bf * R * N_FFT),
        k7_name["rms"]: (4 * (Bf * Lf + Bf * R), Bf * R * (2 * N_FFT + 1)),
    }
    k1m_products = 3 * Bw * Fw * 2 * 201 * N_MELS
    mel64 = mel_powers(gen, (Bf, N_MELS, R))
    mel_wh = mel_powers(gen, (Bw, N_MELS, Fw))[..., :-1]
    item_kw = dict(per_item=True, scale=1.0 / 40.0, offset=1.0)
    istft_lib = lambda: torch.istft(S, N_FFT, HOP, window=win, center=True, length=LONG)  # noqa: E731
    cases = (
        (k2.KERNEL.name, "30 s clip", lambda: k2.stft_fused(y_long, win, **kw),
         lambda: k2.stft_plain(y_long, win, **kw),
         lambda: torch.stft(y_long, N_FFT, HOP, window=win, center=True, pad_mode="constant",
                            return_complex=True)),
        (f"{k2.KERNEL.name}[64 x 30 s]", "64 x 30 s", lambda: k2.stft_fused(y_feat, win, **kw),
         lambda: k2.stft_plain(y_feat, win, **kw),
         lambda: torch.stft(y_feat, N_FFT, HOP, window=win, center=True, pad_mode="constant",
                            return_complex=True)),
        (k2.KERNEL_MAG.name, "64 x 30 s", lambda: k2.stft_magnitude_fused(y_feat, win, **kw),
         lambda: k2.stft_magnitude_plain(y_feat, win, **kw), None),
        *((k2s_name[stat], "64 x 30 s",
           lambda stat=stat, fq=fq: k2.stft_stats_fused(y_feat, win, fq, stat=stat, **kw),
           lambda stat=stat, fq=fq: k2.stft_stats_plain(y_feat, win, fq, stat=stat, **kw), None)
          for stat, fq in (("bandwidth", freq_feat), ("rolloff", freq_feat), ("flatness", None))),
        (k3.KERNEL.name, "30 s clip", lambda: k3.istft_fused(St, win, env, **kw3),
         lambda: k3.istft_plain(St, win, env, **kw3), istft_lib),
        (f"{k3.KERNEL.name}[64 x 30 s]", "64 x 30 s",
         lambda: k3.istft_fused(S64.transpose(1, 2), win, env, **kw3),
         lambda: k3.istft_plain(S64.transpose(1, 2), win, env, **kw3),
         lambda: torch.istft(S64, N_FFT, HOP, window=win, center=True, length=LONG)),
        (f"{k3.KERNEL.name}[istft_fused_t]", "30 s clip",
         lambda: k3.istft_fused_t(S, win, env, **kw3), lambda: k3.istft_plain(St, win, env, **kw3),
         istft_lib),
        (f"{k3.KERNEL.name}[istft_fused_nat]", "30 s clip",
         lambda: k3.istft_fused_nat(S, win, env, **kw3), lambda: k3.istft_plain(St, win, env, **kw3),
         istft_lib),
        # fold is the overlap-add alone: it leaves out the envelope divide
        (k4.KERNEL.name, f"30 s clip, hop {OLA_HOP}",
         lambda: k4.overlap_add_fused(frames, env441, hop_length=OLA_HOP, output_length=T441),
         lambda: k4.overlap_add_plain(frames, env441, hop_length=OLA_HOP, output_length=T441),
         lambda: torch.nn.functional.fold(frames.transpose(1, 2), output_size=(1, T441),
                                          kernel_size=(1, N_FFT), stride=(1, OLA_HOP))),
        (f"{k4.KERNEL.name}[64 x 30 s]", f"64 x 30 s, hop {OLA_HOP}",
         lambda: k4.overlap_add_fused(frames64, env441, hop_length=OLA_HOP, output_length=T441),
         lambda: k4.overlap_add_plain(frames64, env441, hop_length=OLA_HOP, output_length=T441),
         lambda: torch.nn.functional.fold(frames64.transpose(1, 2), output_size=(1, T441),
                                          kernel_size=(1, N_FFT), stride=(1, OLA_HOP))),
        (k5.KERNEL.name, "the 4 default contrast bands of 64 x 30 s",
         lambda: [k5.quantile_extreme_means_fused(v, k, k) for v, k in bands],
         lambda: [k5.quantile_extreme_means_plain(v, k, k) for v, k in bands], None),
        (k6.KERNEL.name, f"64 x 30 s x {N_MELS} mels, top_db 80",
         lambda: k6.to_db_fused(mel64, 10.0, 1.0, 1e-10, 80.0),
         lambda: k6.to_db_plain(mel64, 10.0, 1.0, 1e-10, 80.0), None),
        *((k7_name[stat], f"64 x 30 s, frame {N_FFT}, hop {HOP}, {k7_kw[stat]['pad_mode']} pad",
           lambda stat=stat: k7.frame_stats_fused(y_feat, **k7_kw[stat]),
           lambda stat=stat: k7.frame_stats_plain(y_feat, **k7_kw[stat]), None)
          for stat in ("zero_crossing_rate", "rms")),
        (K1M, "Whisper's 64 x 30 s at 16 kHz, n_fft 400, hop 160, 128 mels",
         lambda: k1.melspectrogram_fused(y_wh, win_wh, fb_wh, **WHISPER_KW),
         lambda: k1.melspectrogram_mixed_plain(y_wh, win_wh, fb_wh, **WHISPER_KW), None),
        (K6_ITEM, f"the [..., :-1] view of Whisper's 64 x {N_MELS} x {Fw} mel, top_db 80, / 40 + 1",
         lambda: k6.to_db_fused(mel_wh, 10.0, 1.0, 1e-10, 80.0, **item_kw),
         lambda: k6.to_db_plain(mel_wh, 10.0, 1.0, 1e-10, 80.0, **item_kw), None),
    )
    # the STFT wrapper's host cost: 1000 calls on a 1 s clip, no sync; and
    # K2's device time on one 30 s clip, where the CUDA-event time of a call
    # is mostly its host path
    y_1s = y_head[:1].contiguous()
    print(f"K2 wrapper host path: {host_us(lambda: k2.stft_fused(y_1s, win, **kw)):.2f} us per call "
          f"(median of 5 runs of 1000 calls of a 1 s clip, no sync)")
    v9, k9 = bands[-1][0][:1], bands[-1][1]
    print(f"K5 wrapper host path: {host_us(lambda: k5.quantile_extreme_means_fused(v9, k9, k9)):.2f} "
          f"us per call (median of 5 runs of 1000 calls on one clip's k = {k9} band, no sync)")

    def lib_stft(y):
        return torch.stft(y, N_FFT, HOP, window=win, center=True, pad_mode="constant",
                          return_complex=True)

    for label, y, calls in (("one 30 s clip", y_long, 20), ("64 x 30 s", y_feat, 5)):
        print(f"device time per call, {label} (torch.profiler, {calls} calls): K2 "
              f"{kernel_device_ms(lambda: k2.stft_fused(y, win, **kw), 'stft_kernel', calls):.4f} ms, "
              f"torch.stft {kernel_device_ms(lambda: lib_stft(y), None, calls):.4f} ms (all its "
              f"device operations)")
    print(f"K2m device time, 64 x 30 s (torch.profiler, 5 calls): "
          f"{kernel_device_ms(lambda: k2.stft_magnitude_fused(y_feat, win, **kw), 'stft_kernel', 5):.4f} ms")
    for stat, fq in (("bandwidth", freq_feat), ("rolloff", freq_feat), ("flatness", None)):
        ms = kernel_device_ms(lambda: k2.stft_stats_fused(y_feat, win, fq, stat=stat, **kw),
                              k2.KERNEL_STATS.name, 5)
        print(f"K2s {stat} device time, 64 x 30 s (torch.profiler, 5 calls): {ms:.4f} ms")
    for stat in ("zero_crossing_rate", "rms"):
        ms = kernel_device_ms(lambda: k7.frame_stats_fused(y_feat, **k7_kw[stat]), k7.KERNEL.name,
                              20)
        bound_ms, bound_by = _bound(*work[k7_name[stat]])
        print(f"K7 {stat} device time, 64 x 30 s (torch.profiler, 20 calls): {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ({bound_by}), {100 * bound_ms / ms:.1f}% of it")
    k1_split(y_scale, y_feat, win, fb_t, kw)
    for kernel, fast in ((k1.KERNEL, False), (k1.KERNEL_FAST, True)):
        ms = kernel_device_ms(lambda: k1.melspectrogram_fused(y_head, win, fb_t, fast_gemm=fast, **kw),
                              kernel.name, 20)
        print(f"{kernel.name} device time, headline (64, 22050) (torch.profiler, 20 calls): "
              f"{ms:.4f} ms")
    k345_split(gen)
    # K1's two entries (the kernels line takes the scale configuration's)
    out = k1_times("scale (256, 88200)", y_scale, win, fb_t, 20)
    k1_times("64 x 30 s", y_feat, win, fb_t, 5)
    ms = kernel_device_ms(lambda: k1.melspectrogram_fused(y_wh, win_wh, fb_wh, **WHISPER_KW),
                          K1M, 5)
    print(f"{K1M} device time, Whisper's 64 x 30 s at 16 kHz (torch.profiler, 5 calls): "
          f"{ms:.4f} ms, bound {_bound(*work[K1M], bf16_ops=k1m_products)[0]:.4f} ms")
    for name, shape, kern, twin, lib in cases:
        # in turns, so that a slow spell of the shared host falls on all three
        p_a = cuda_ms(twin)
        l_a = cuda_ms(lib) if lib is not None else None
        k_a, k_b = cuda_ms(kern), cuda_ms(kern)
        l_b = cuda_ms(lib) if lib is not None else None
        p_b = cuda_ms(twin)
        lib_ms = statistics.median([l_a, l_b]) if lib is not None else None
        bound_ms, bound_by = _bound(*(work.get(name) or work[name.split("[")[0]]),
                                    bf16_ops=k1m_products if name == K1M else 0.0)
        print(f"{name} at {shape}: kernel {k_a:.4f} / {k_b:.4f}, plain {p_a:.4f} / {p_b:.4f}, "
              f"library {'none' if lib_ms is None else f'{lib_ms:.4f}'}, "
              f"bound {bound_ms:.4f} ({bound_by})")
        out[name] = dict(ms=statistics.median([k_a, k_b]), plain_ms=statistics.median([p_a, p_b]),
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
    out.update(slice_times(gen))
    rhythm_times(gen)
    effects_times(gen)
    return out


def device_busy_ms(prof, calls: int) -> float:
    """The device's busy time per call (ms) in a ``torch.profiler`` window
    of ``calls`` calls: the union of its kernel and copy spans."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy_us / 1e3 / calls


def profile_path(fn, calls: int, order: bool, plain: bool = True) -> None:
    """``fn()`` under ``torch.profiler`` for ``calls`` calls after two
    warm-up calls, on the kernel path and (with ``plain``) on the plain
    path (every kernel off): device time per call by kernel, the device's
    busy time (the union of its kernel and copy spans) and its idle share
    of the host's wall time; with ``order``, the port's kernels launch by
    launch in the first profiled call. The profiler lengthens the host
    side, so the windows run longer than the CUDA-event times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mlx_audio_primitives_tpu_torch.kernels import _build
    from mlx_audio_primitives_tpu_torch.utils import dispatch

    for label, enabled in (("kernel path", True), ("plain path", False))[: 1 + plain]:
        dispatch.KERNELS_ENABLED = enabled
        try:
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0) / calls
        finally:
            dispatch.KERNELS_ENABLED = True
        busy_ms = device_busy_ms(prof, calls)
        if not busy_ms:
            print(f"{label}: the profiler saw no device time")
            continue
        by_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                item = by_name.setdefault(e.name, [0.0, 0])
                item[0] += e.time_range.elapsed_us()
                item[1] += 1
        print(f"{label}: window {wall_ms:.4f}, device busy {busy_ms:.4f}, "
              f"idle {100 * (1 - busy_ms / wall_ms):.1f}%")
        for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
            print(f"  {us / 1e3 / calls:8.4f}  {n // calls:3d}x  {name[:110]}")
        if order:
            own = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                         for e in prof.events() if e.device_type == DeviceType.CUDA
                         and any(re.search(rf"::{k.name}[<(]", e.name) for k in _build.KERNELS))
            first = own[: len(own) // calls]
            print("  the port's kernels in call order (ms):",
                  ", ".join(f"{n.split('::')[1].split('(')[0]} {us / 1e3:.4f}" for _, n, us in first))


def profile_features(gen: torch.Generator, card: str, calls: int = 3) -> None:
    """Phase 6a: where the feature path's time goes, from ``torch.profiler``
    (:func:`profile_path`)."""
    phase(f"6a. where the feature path's time goes (torch.profiler, ms per call) on {card}")
    import mlx_audio_primitives_tpu_torch as ap

    y = torch.randn(FEATURES, generator=gen, device=torch.device("cuda", 0))
    profile_path(lambda: feature_set(ap, y), calls, order=True)


def profile_griffinlim(gen: torch.Generator, card: str, calls: int = 2) -> None:
    """Phase 6b: where ``griffinlim``'s time goes at 64 x 30 s, 32
    iterations (:func:`profile_path`)."""
    phase(f"6b. where griffinlim's time goes at 64 x 30 s (torch.profiler, ms per call) on {card}")
    import mlx_audio_primitives_tpu_torch as ap

    S = ap.stft(pitch_clips(gen, FEATURES), n_fft=N_FFT, hop_length=HOP).abs()
    profile_path(lambda: ap.griffinlim(S, n_iter=GL_ITERS, hop_length=HOP, random_state=0,
                                       length=LONG), calls, order=False)


def rhythm_set(ap, y: torch.Tensor) -> dict:
    """The rhythm-and-harmony front end on ``y`` (B, L): the onset envelope
    and its tempo, the STFT and CQT chromagrams, PCEN of the mel."""
    env = ap.onset_strength(y, sr=SR)
    return {"onset": env, "tempo": ap.tempo(onset_envelope=env, sr=SR),
            "chroma_stft": ap.chroma_stft(y=y, sr=SR), "chroma_cqt": ap.chroma_cqt(y, sr=SR),
            "pcen": ap.pcen(ap.melspectrogram(y, sr=SR))}


def profile_rhythm(gen: torch.Generator, card: str) -> None:
    """Phase 6c: where the rhythm-and-harmony path's time goes at 64 x 30 s
    (:func:`profile_path`), and PCEN of the mel alone (no kernel)."""
    phase(f"6c. where the rhythm path's time goes at 64 x 30 s (torch.profiler, ms per call) on "
          f"{card}")
    import mlx_audio_primitives_tpu_torch as ap

    y, _ = rhythm_clips(gen, FEATURES)
    profile_path(lambda: rhythm_set(ap, y), 2, order=True)
    M = ap.melspectrogram(y, sr=SR)
    print(f"pcen of the mel {tuple(M.shape)} alone:")
    profile_path(lambda: ap.pcen(M), 5, order=False, plain=False)


def host_path(root: str) -> None:
    """``--host-path ROOT``: the K2 wrapper's host time per call (as in phase
    5) for the port package under ``ROOT``, such as an unpacked earlier
    commit, so two wrappers can be compared in one run on one card."""
    sys.path.insert(0, os.path.abspath(root))
    environment()
    from mlx_audio_primitives_tpu_torch.kernels import stft_radix as k2
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window

    dev = torch.device("cuda", 0)
    win = _get_padded_window("hann", N_FFT, N_FFT, dev)
    y = torch.randn((1, SR), generator=torch.Generator(device="cuda").manual_seed(0), device=dev)
    kw = dict(n_fft=N_FFT, hop_length=HOP, center=True, pad_mode="constant")
    us = host_us(lambda: k2.stft_fused(y, win, **kw))
    print(f"K2 wrapper host path of {os.path.dirname(k2.__file__)}: {us:.2f} us per call "
          f"(median of 5 runs of 1000 calls of a 1 s clip, no sync)")


def k345_split_of(root: str) -> None:
    """``--k345-split ROOT``: phase 5's K3, K4 and K5 device times, K5's SASS
    counts and the feature path's CUDA-event time for the port package under
    ``ROOT``, such as an unpacked earlier commit."""
    sys.path.insert(0, os.path.abspath(root))
    environment()
    import mlx_audio_primitives_tpu_torch.kernels as kernels

    import mlx_audio_primitives_tpu_torch as ap

    print(f"K3, K4 and K5 of {os.path.dirname(kernels.__file__)}:")
    k5_sass()
    gen = torch.Generator(device="cuda").manual_seed(0)
    k345_split(gen)
    from torch.profiler import ProfilerActivity, profile

    y = torch.randn(FEATURES, generator=gen, device=torch.device("cuda", 0))
    t = [cuda_ms(lambda: feature_set(ap, y), 2, 20) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            feature_set(ap, y)
        torch.cuda.synchronize()
    print(f"features 64 x 30 s, kernel path: CUDA events {t[0]:.4f} / {t[1]:.4f} ms (median of "
          f"20 calls after 2, twice); device busy {device_busy_ms(prof, 5):.4f} ms per call "
          f"(torch.profiler, 5 calls)")


def istft_ola_of(root: str) -> None:
    """``--istft-ola ROOT``: CUDA-event times of the public ``istft`` at hop
    441 (the overlap-add tier: the inverse FFT, then K4) on one 30 s clip
    and at 64 x 30 s, for the port package under ``ROOT``, such as an
    unpacked earlier commit."""
    sys.path.insert(0, os.path.abspath(root))
    environment()
    import mlx_audio_primitives_tpu_torch as ap

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"public istft at hop {OLA_HOP} of {os.path.dirname(ap.__file__)}:")
    for label, shape, reps in (("one 30 s clip", (1, LONG), 50), ("64 x 30 s", FEATURES, 10)):
        y = torch.randn(shape, generator=gen, device=dev)
        S = ap.stft(y, n_fft=N_FFT, hop_length=OLA_HOP)
        t = [cuda_ms(lambda: ap.istft(S, hop_length=OLA_HOP, length=shape[1]), 2, reps)
             for _ in range(2)]
        print(f"  {label} {tuple(S.shape)}: {t[0]:.4f} / {t[1]:.4f} ms (median of {reps} calls "
              f"after 2, twice)")
        del y, S


def k1_split_of(root: str) -> None:
    """``--k1-split ROOT``: phase 5's K1 and K2m device times for the port
    package under ``ROOT``, such as an unpacked earlier commit."""
    sys.path.insert(0, os.path.abspath(root))
    environment()
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.ops.chroma import chroma_filterbank
    from mlx_audio_primitives_tpu_torch.ops.mel import mel_filterbank
    from mlx_audio_primitives_tpu_torch.ops.stft import _get_padded_window

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    win = _get_padded_window("hann", N_FFT, N_FFT, dev)
    fb_t = k1_weight(mel_filterbank(SR, N_FFT, N_MELS, device=dev))
    fb_c = k1_weight(chroma_filterbank(SR, N_FFT, device=dev))
    kw = dict(n_fft=N_FFT, hop_length=HOP, center=True, pad_mode="constant")
    print(f"K1 of {os.path.dirname(k1.__file__)}:")
    k1_split(torch.randn(SCALE, generator=gen, device=dev),
             torch.randn(FEATURES, generator=gen, device=dev), win, fb_t, kw, fb_c)


def acf_split_of(root: str) -> None:
    """``--acf-split ROOT``: K1's ACF entry at the ACF shape (64 x 30 s, n_fft
    4096, hop 512, 432 lags) for the port package under ``ROOT``: ptxas's
    registers and spill bytes of its n_fft 4096 instance (when this process
    built it), its resident blocks an SM, its device time per call and a
    digest of its output bits."""
    import hashlib

    sys.path.insert(0, os.path.abspath(root))
    environment()
    from mlx_audio_primitives_tpu_torch.kernels import _build
    from mlx_audio_primitives_tpu_torch.kernels import mel_fused as k1
    from mlx_audio_primitives_tpu_torch.ops import pitch as P

    _build.library()
    row = ptxas_rows(_build.build_info.get("log", "")).get((k1.KERNEL_ACF.name, 11))
    dev = torch.device("cuda", 0)
    W, n_fft = 2048, 4096
    yp = torch.nn.functional.pad(pitch_clips(torch.Generator(device="cuda").manual_seed(0), FEATURES),
                                 (W // 2, W // 2))
    _, ypad = P._acf_prep(yp, frame_length=W, hop_length=HOP)
    lo, hi = P._lag_bounds(SR, 50.0, 2000.0)
    win = P._acf_window_table(W, n_fft, device=dev)
    kwa = dict(n_fft=n_fft, hop_length=HOP, lo=lo, hi=hi + 1)
    ms = kernel_device_ms(lambda: k1.acf_fused(ypad, win, **kwa), k1.KERNEL_ACF.name, 10)
    g = k1.launch_geometry(n_fft, HOP, dev, acf=True)
    regs = "not rebuilt here" if row is None else f"{row[0]} registers, {row[1]} bytes spilled"
    print(f"ACF entry, device time per call at 64 x 30 s, n_fft {n_fft}: {ms:.4f} ms "
          f"(torch.profiler, 10 calls); its n_fft {n_fft} instance: {regs}, "
          f"{g['blocks_per_sm']} blocks an SM")
    bits = k1.acf_fused(ypad, win, **kwa).cpu().numpy().tobytes()
    print(f"ACF entry output at 64 x 30 s: sha256 {hashlib.sha256(bits).hexdigest()[:24]} (two "
          f"trees' entries bit for bit)")


def pitch_split_of(root: str) -> None:
    """``--pitch-split ROOT``: ``pitch_detect_acf`` at 64 x 30 s (defaults)
    for the port package under ``ROOT``: the kernels it launches, each one's
    device time per call, and the CUDA-event times of the kernel and plain
    routes in turns."""
    sys.path.insert(0, os.path.abspath(root))
    environment()
    import mlx_audio_primitives_tpu_torch as ap
    from mlx_audio_primitives_tpu_torch.kernels import _build

    print(f"pitch_detect_acf of {os.path.dirname(ap.__file__)}:")
    y = pitch_clips(torch.Generator(device="cuda").manual_seed(0), FEATURES)
    fn = lambda: ap.pitch_detect_acf(y, sr=SR)  # noqa: E731
    reset_counts()
    fn()
    torch.cuda.synchronize()
    launched = [k.name for k in _build.KERNELS if k.launches]
    for name in launched:
        print(f"  device time of {name} (launched once a call): "
              f"{kernel_device_ms(fn, name, 5):.4f} ms (torch.profiler, 5 calls)")
    route_times("  pitch_detect_acf 64 x 30 s (defaults)", fn, 5)


#: ACF entry variants (``--acf-ablations``), edits of ``csrc/mel_fused.cu`` as
#: K1's ablations are: the register bound that gives two blocks an SM at
#: n_fft 4096, and the later passes' fresh thread indices that keep it free
#: of spills
ACF_ABLATIONS = {
    "one block an SM (no 64-register bound)": [(
        "                                  mapt::plan_bits(LOG_M, 0) == 4\n"
        "                                      ? 1\n"
        "                                      : mapt::kMaxThreads / mapt::Geometry<LOG_M>::NT)\n"
        "mel_fused_acf_kernel(",
        "                                  1)\nmel_fused_acf_kernel(")],
    "the thread's indices kept through the whole inverse": [(
        "      acf_inverse_first_pass<LOG_M, G::GT>(v, buf + fs * FS, tw_g, twp, t, g);\n    }\n    {\n"
        "      // its later passes, with the thread's indices read afresh: derived\n"
        "      // once for the whole inverse, they made ptxas spill at 64 registers\n"
        "      const int me = opaque(tid), fs = me / T, t = me % T, g = G::GT ? me / G::GT : 0;\n"
        "      float2 v[mapt::kRegPoints];\n",
        "      acf_inverse_first_pass<LOG_M, G::GT>(v, buf + fs * FS, tw_g, twp, t, g);\n")],
}


#: K1 ablations (``--k1-ablations``): each edits ``csrc/mel_fused.cu`` of a
#: copy of the package to leave one part of the dense entry's work out (the
#: results are wrong; only the time counts), so that the time that part
#: costs shows
K1_ABLATIONS = {
    "no W loads (A fragments from registers)": [(
        "  a[0] = (k < n_bins && oka) ? __ldg(w0) : 0.f;\n"
        "  a[1] = (k < n_bins && okb) ? __ldg(w0 + 8) : 0.f;\n"
        "  a[2] = (k + 4 < n_bins && oka) ? __ldg(w1) : 0.f;\n"
        "  a[3] = (k + 4 < n_bins && okb) ? __ldg(w1 + 8) : 0.f;",
        "  (void)w0, (void)w1;\n"
        "  a[0] = (k < n_bins && oka) ? 1.f + k : 0.f;\n"
        "  a[1] = (k < n_bins && okb) ? 2.f + k : 0.f;\n"
        "  a[2] = (k + 4 < n_bins && oka) ? 3.f + ca : 0.f;\n"
        "  a[3] = (k + 4 < n_bins && okb) ? 4.f + ca : 0.f;")],
    "no power-row loads (B fragments from registers)": [(
        "      const unsigned bhi[2] = {ok0 ? __float_as_uint(r[k]) : 0u,\n"
        "                               ok1 ? __float_as_uint(r[k + 4]) : 0u};\n"
        "      const unsigned blo[2] = {ok0 ? __float_as_uint(r[M + 1 + k]) : 0u,\n"
        "                               ok1 ? __float_as_uint(r[M + 5 + k]) : 0u};",
        "      (void)r;\n"
        "      const unsigned bhi[2] = {ok0 ? 1u + k : 0u, ok1 ? 2u + k : 0u};\n"
        "      const unsigned blo[2] = {ok0 ? 3u + f : 0u, ok1 ? 4u + f : 0u};")],
    "one product (hi*hi) of the three": [(
        "      mma_tf32(d, alo, bhi);\n      mma_tf32(d, ahi, blo);\n", "")],
    "cvt.rna.tf32 for the split": [(
        "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
        "  unsigned u;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(u) : \"f\"(x));\n  return u;")],
    "one accumulator (no sum per k-step)": [(
        "      float d[4] = {0.f, 0.f, 0.f, 0.f};\n"
        "      mma_tf32(d, alo, bhi);\n      mma_tf32(d, ahi, blo);\n"
        "      mma_tf32(d, ahi, bhi);\n#pragma unroll\n"
        "      for (int i = 0; i < 4; ++i) acc[j][i] += d[i];",
        "      mma_tf32(acc[j], alo, bhi);\n      mma_tf32(acc[j], ahi, blo);\n"
        "      mma_tf32(acc[j], ahi, bhi);")],
    "half the grid (66 of 132 SMs)": [(
        "    slots[device] = sms * per_sm;", "    slots[device] = sms * per_sm / 2;")],
}

#: the fast entry's ablations (``--k1-fast-ablations``), edits of the same
#: source as the dense entry's: the band off (every tile takes every k-step,
#: as for a dense W, the 128-mel table included), two 512-thread blocks an
#: SM (8 frames a tile at n_fft 2048), the contraction left out (the
#: front end, the power rows and the stores alone), and the power rows'
#: vote on values that are not finite left out
K1_FAST_ABLATIONS = {
    "band off (every k-step of every m-tile)": [(
        "      const bool full = *flag_at(opaque(hop)) != 0;",
        "      const bool full = *flag_at(opaque(hop)) != 0 || n_mt_ > 0;"), (
        "      const bool full = *flag != 0;\n      const int tot = n_mt_ * KSTEPS;",
        "      const bool full = *flag != 0 || n_mt_ > 0;\n      const int tot = n_mt_ * KSTEPS;")],
    "two blocks an SM (512 threads, 8 frames a tile)": [(
        "using FastGeometry = mapt::Geometry<LOG_M>;",
        "using FastGeometry = mapt::Geometry<LOG_M, LOG_M == 10 ? 512 : mapt::max_threads(LOG_M)>;")],
    "no contraction (front end, power rows, stores)": [(
        "        band_unit<LOG_M, FT>(acc, rows,", "        if (b < 0) band_unit<LOG_M, FT>(acc, rows,")],
    "no vote on values that are not finite (every tile banded)": [(
        "    if (__any_sync(0xffffffffu, bad) && (me & 31) == 0) *flag = 1;", "    (void)bad;")],
}


#: K3 ablations (``--k3-ablations``), edits of ``csrc/istft_fused.cu`` as
#: K1's are of its source
K3_ABLATIONS = {
    "no spectrum loads (bins from registers)": [(
        "    x.a[r] = __ldcg(Sf + (t + r * G::S0) * sk);\n"
        "    x.b[r] = __ldcg(Sf + bin_b<LOG_M, C>(t, r) * sk);",
        "    x.a[r] = make_float2(1.f + r, 0.5f * t);\n"
        "    x.b[r] = make_float2(0.25f * r, 1.f - t);")],
    "no later passes": [(
        "      mapt::rexchange_passes<LOG_M, 1, G::GT>(buf + (me / G::T) * G::FS, v, twp, me % G::T,\n"
        "                                             G::GT ? me / G::GT : 0);\n",
        "      (void)me;\n")],
    "no overlap-add": [(
        "      overlap_add_tile<LOG_M, C>(buf,", "      if (me < 0) overlap_add_tile<LOG_M, C>(buf,")],
    "no window reads or envelope loads": [(
        "      const float2 w = win2[c * H + p];",
        "      const float2 w = make_float2(1.f + c, 1.f - c);"), (
        "        e = __ldg(reinterpret_cast<const float2*>(env + s));",
        "        e = make_float2(1.f, 2.f);")],
    "no output stores": [(
        "    if (keep && s < T) {", "    if (keep && s < T && acc[0].x == 12345.f) {")],
}


def ablations(kernel: str, source: str, table: dict, split: str, prefix: str) -> None:
    """``--k1-ablations`` / ``--k3-ablations``: the kernel's device time
    (``split`` of each copy, the line that starts with ``prefix``) for the
    package as it is and for each entry of ``table``, copies under
    ``build/<kernel>_ablations/``, each in its own process, in two rounds."""
    print(f"{kernel} ablations on", gpu_line(), flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(root, "mlx_audio_primitives_tpu_torch")
    dirs = {"as it is": root}
    for i, (label, edits) in enumerate(table.items()):
        d = os.path.join(root, "build", f"{kernel.lower()}_ablations", str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(pkg, os.path.join(d, "mlx_audio_primitives_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__", "build"))
        src = os.path.join(d, "mlx_audio_primitives_tpu_torch", "csrc", source)
        with open(src) as f:
            text = f.read()
        for old, new in edits:
            check(text.count(old) == 1, f"ablation {label!r}: its edit no longer matches the source")
            text = text.replace(old, new)
        with open(src, "w") as f:
            f.write(text)
        dirs[label] = d
    for rnd in range(2):
        for label, d in dirs.items():
            out = subprocess.run([sys.executable, os.path.abspath(__file__), split, d],
                                 capture_output=True, text=True, timeout=600)
            line = next((ln for ln in out.stdout.splitlines() if ln.startswith(prefix)), None)
            check(out.returncode == 0 and line is not None, f"ablation {label!r} failed:\n{out.stdout[-2000:]}"
                  f"{out.stderr[-2000:]}")
            print(f"round {rnd + 1}, {label}: {line.split(': ', 1)[1]}", flush=True)


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--host-path":
        host_path(sys.argv[2])
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--k1-split":
        k1_split_of(sys.argv[2])
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--istft-ola":
        istft_ola_of(sys.argv[2])
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--k345-split":
        k345_split_of(sys.argv[2])
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--k3-split":
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        environment()
        k3_split(torch.Generator(device="cuda").manual_seed(0))
        return
    if len(sys.argv) == 2 and sys.argv[1] in ("--k1-ablations", "--k1-fast-ablations"):
        fast = sys.argv[1] == "--k1-fast-ablations"
        ablations("K1_fast" if fast else "K1", "mel_fused.cu",
                  K1_FAST_ABLATIONS if fast else K1_ABLATIONS, "--k1-split",
                  "device time per call, scale (256, 88200) (torch.profiler, 20 calls): "
                  + (K1_MAIN if fast else K1_EXACT))
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--acf-split":
        acf_split_of(sys.argv[2])
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--pitch-split":
        pitch_split_of(sys.argv[2])
        return
    if len(sys.argv) == 2 and sys.argv[1] == "--acf-ablations":
        ablations("ACF", "mel_fused.cu", ACF_ABLATIONS, "--acf-split", "ACF entry, device time")
        return
    if len(sys.argv) == 2 and sys.argv[1] == "--k3-ablations":
        ablations("K3", "istft_fused.cu", K3_ABLATIONS, "--k3-split",
                  "device time per call, 64 x 30 s")
        return
    card = environment()
    build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = kernels_vs_plain(gen)
    log_mel = main_path(gen)
    features = feature_path(gen)
    large_batch(gen)
    slice_launches = slice_paths(gen)
    rhythm_launches = rhythm_paths(gen)
    effects_launches = effects_paths(gen)
    wav_dir = tempfile.mkdtemp(prefix="chip_smoke_wav_")
    try:
        utils_launches, utils_state = utils_paths(gen, wav_dir)
        parallel_launches = parallel_paths(gen, card)
        models_launches = models_paths(gen, card)
        timing = times(gen, card)
        utils_times(utils_state)
        profile_features(gen, card)
        profile_griffinlim(gen, card)
        profile_rhythm(gen, card)
        profile_effects(gen, card)
        profile_utils(utils_state, card)
    finally:
        shutil.rmtree(wav_dir, ignore_errors=True)

    from mlx_audio_primitives_tpu_torch.kernels import _build

    launches = {name: log_mel[name] + features[name] + slice_launches[name] + rhythm_launches[name]
                + effects_launches[name] + utils_launches[name] + parallel_launches[name]
                + models_launches[name] for name in log_mel}
    rows = [{"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
             "launches": launches[k.name]} for k in _build.KERNELS]
    # the natural-spectrum entries launch K3; no main path calls them, in
    # either package, so they count no launches of their own
    k3 = next(k for k in _build.KERNELS if k.name == "istft_kernel")
    rows += [{"name": f"{k3.name}[{entry}]", "route": "cuda", "source": k3.source,
              "replaces": f"mlx_audio_primitives_tpu/kernels/istft_fused.py:{line}",
              "launches": 0, "entry_of": k3.name}
             for entry, line in (("istft_fused_t", 742), ("istft_fused_nat", 1111))]
    print(json.dumps({"kernels": [
        {**row, "max_abs_err": errs[row["name"]], **timing[row["name"]]} for row in rows
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
