"""Time-axis (sequence-parallel) sharding for STFT-family ops.

Counterpart of `mlx_audio_primitives_tpu/parallel/time_shard.py`, with its
signatures, layouts and errors: shard the sample axis of a long signal over
the mesh's 'time' axis and exchange exactly the ``n_fft - hop`` halo
samples that couple neighbouring shards.

Design (a function on each rank's local tensors over a ``(data, time)``
mesh; inputs and outputs are DTensors, a plain tensor being the global
array):

* forward (STFT/mel): each time shard holds ``L_s`` samples with
  ``hop | L_s``; frames starting in a shard belong to it (``F_s = L_s/hop``
  frames each), and each shard fetches the next shard's first
  ``n_fft - hop`` samples with one ring shift
  (``torch.distributed.batch_isend_irecv``; the last shard gets zeros).
  Output frames stay sharded over 'time' with no further communication.
* inverse (ISTFT): each shard overlap-adds its own frames into a local
  buffer of ``L_s + halo``; the tail spills into the next shard's
  territory, so one ring shift the other way carries it right, where it is
  added on. The squared-window envelope follows the same halo algebra.

``center=True`` (librosa drop-in): the wrapper pads globally (``n_fft//2``
each side with ``pad_mode``), extends to a shardable length with zeros that
no kept frame reads, computes the full grid, and keeps librosa's
``1 + L//hop`` frames; the inverse overlap-adds raw shards and divides by
the exact global envelope after gathering them. Keeping fewer frames than
the grid holds moves frames between shards, so these outputs (and an
uncentred ``istft_time_sharded`` with ``length``) are gathered over 'time'
and split again, as DTensor splits, by ``torch.chunk``'s rule.

Per-shard transform (``fft_mode``): 'matmul' (an FP32 DFT GEMM, the
default), 'fft' (``torch.fft``), or 'pallas': the port's kernels on each
rank's local samples, one launch per shard: K2 (`kernels/stft_radix.py`),
K3 (`kernels/istft_fused.py`, with an envelope of ones: the halo algebra
normalises) and K1 (`kernels/mel_fused.py`). Outside the radix shape gate
'pallas' becomes 'fft'; on a CPU tensor the kernel wrappers run their plain
twins, and with the kernels disabled it is 'fft' too.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as tnf
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from .._config import COMPLEX_DTYPE, REAL_DTYPE, WINDOW_SUM_EPSILON
from ..kernels.dft import forward_basis, inverse_basis, irfft_frames, rfft_frames
from ..kernels.istft_fused import istft_fused
from ..kernels.mel_fused import melspectrogram_fused
from ..kernels.stft_radix import stft_fused
from ..ops._frames import cdiv, frame_signal_batched, overlap_add, pad_signal, window_envelope
from ..ops.convert import power_to_db
from ..ops.mel import mel_filterbank
from ..ops.stft import (
    _get_padded_window,
    _istft_envelope_table,
    _validate_stft_params,
    _window_key,
)
from ..utils import dispatch
from . import _comm
from .mesh import DATA_AXIS, TIME_AXIS, P, axis_index, axis_size, placements
from .sharding import from_local, local_shard

ArrayLike = Any


def _right_halo(y_local: torch.Tensor, halo: int, mesh: DeviceMesh) -> torch.Tensor:
    """Fetch the next time shard's first ``halo`` samples (zeros at the end)."""
    t_size = axis_size(mesh, TIME_AXIS)
    if halo == 0:
        return y_local[:, :0]
    if t_size == 1:
        return y_local.new_zeros((y_local.shape[0], halo))
    # shard k receives shard k+1's head: send my head to my LEFT neighbour
    head = _comm.ppermute(y_local[:, :halo], mesh, TIME_AXIS, shift=-1)
    if axis_index(mesh, TIME_AXIS) == t_size - 1:
        return torch.zeros_like(head)
    return head


def _resolve_sharded_mode(fft_mode: str, kernel_ok: bool) -> str:
    """Per-shard transform selection: 'matmul' (DFT GEMM, the default),
    'fft' (``torch.fft``), or 'pallas' (the port's kernels, one launch per
    shard). 'pallas' falls back to 'fft' where the radix gate fails."""
    if fft_mode not in ("matmul", "fft", "pallas"):
        raise ValueError(
            f"fft_mode must be 'matmul', 'fft' or 'pallas', got {fft_mode}"
        )
    if fft_mode == "pallas" and not kernel_ok:
        return "fft"
    return fft_mode


def _kernels_ok(n_fft: int, hop_length: int) -> bool:
    """Whether 'pallas' takes the kernel wrappers: the radix shape gate,
    with the kernels enabled (``MLX_AUDIO_TPU_DISABLE_PALLAS`` turns them
    off, here as in every op)."""
    return dispatch.KERNELS_ENABLED and dispatch.radix_shape_ok(n_fft, hop_length)


def _check_shardable(L: int, n_fft: int, hop_length: int, t_size: int) -> int:
    if L % t_size != 0:
        raise ValueError(f"signal length {L} must divide over {t_size} time shards")
    L_s = L // t_size
    if L_s % hop_length != 0:
        raise ValueError(
            f"per-shard length {L_s} must be a multiple of hop_length {hop_length}"
        )
    if n_fft - hop_length > L_s:
        raise ValueError(
            f"halo (n_fft-hop = {n_fft - hop_length}) exceeds shard length {L_s}; "
            "use fewer time shards"
        )
    return L_s


def _centered_layout(L: int, n_fft: int, hop_length: int, t_size: int):
    """Frame/padding geometry for the librosa ``center=True`` drop-in mode.

    Returns ``(pad, F, F_pad, L_total)`` where ``F`` is librosa's frame count
    ``1 + (L + 2*pad - n_fft)//hop`` and ``L_total = F_pad * hop`` extends the
    padded signal so (a) each shard owns ``L_total/t_size`` samples (a
    multiple of hop), and (b) every kept frame reads only real (librosa-
    padded) samples: max read index ``(F-1)*hop + n_fft - 1 <= L + 2*pad - 1
    <= L_total - 1``, so the trailing zero extension and the last shard's
    zero halo are touched by discarded frames only.
    """
    pad = n_fft // 2
    F = 1 + (L + 2 * pad - n_fft) // hop_length
    F_min = max(F, cdiv(L + 2 * pad, hop_length))
    F_pad = cdiv(F_min, t_size) * t_size
    L_total = F_pad * hop_length
    L_s = L_total // t_size
    if n_fft - hop_length > L_s:
        raise ValueError(
            f"halo (n_fft-hop = {n_fft - hop_length}) exceeds shard length {L_s}; "
            "use fewer time shards or a longer signal"
        )
    return pad, F, F_pad, L_total


def _pad_centered(y: torch.Tensor, pad: int, L_total: int, pad_mode: str) -> torch.Tensor:
    """librosa center pad (``pad_mode``) + zero-extend to ``L_total`` samples."""
    L = y.shape[1]
    yp = pad_signal(y, pad, pad_mode)
    return tnf.pad(yp, (0, L_total - (L + 2 * pad)))


def _global(x: Any) -> torch.Tensor:
    """The global array of ``x`` (a DTensor is gathered)."""
    return x.full_tensor() if isinstance(x, DTensor) else dispatch.to_tensor(x)


def _signal_shard(y: ArrayLike, mesh: DeviceMesh, n_fft: int, hop_length: int,
                  center: bool, pad_mode: str) -> tuple[torch.Tensor, int | None]:
    """This rank's ``(B_l, L_s)`` samples and, for ``center``, the number of
    frames to keep (None: all of them)."""
    t_size = axis_size(mesh, TIME_AXIS)
    place = placements(mesh, P(DATA_AXIS, TIME_AXIS))
    if center:
        yg = _global(y).to(REAL_DTYPE)
        if yg.dim() != 2:
            raise ValueError(f"y must be (batch, samples), got shape {tuple(yg.shape)}")
        pad, F, _, L_total = _centered_layout(yg.shape[1], n_fft, hop_length, t_size)
        return local_shard(_pad_centered(yg, pad, L_total, pad_mode), mesh, place), F
    if not isinstance(y, DTensor):
        y = dispatch.to_tensor(y, REAL_DTYPE)
    if y.ndim != 2:
        raise ValueError(f"y must be (batch, samples), got shape {tuple(y.shape)}")
    _check_shardable(y.shape[1], n_fft, hop_length, t_size)
    return local_shard(y, mesh, place).to(REAL_DTYPE), None


def _split_time(full: torch.Tensor, mesh: DeviceMesh, keep: int,
                pad_to: int | None = None) -> DTensor:
    """This rank's data shard of a time-gathered ``(B_l, n, ...)`` array,
    its first ``keep`` entries of axis 1 kept (then zero-extended to
    ``pad_to``), as a DTensor sharded (data, time): axis 1 is split by
    ``torch.chunk``'s rule, DTensor's own for uneven shards."""
    full = full[:, :keep]
    if pad_to is not None and pad_to > full.shape[1]:
        full = tnf.pad(full, (0, 0) * (full.dim() - 2) + (0, pad_to - full.shape[1]))
    n, t_size = full.shape[1], axis_size(mesh, TIME_AXIS)
    size = cdiv(n, t_size)
    start = min(axis_index(mesh, TIME_AXIS) * size, n)
    part = full[:, start:min(start + size, n)].contiguous()
    shape = torch.Size((full.shape[0] * axis_size(mesh, DATA_AXIS), *full.shape[1:]))
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(part, mesh, placements(mesh, P(DATA_AXIS, TIME_AXIS)),
                              run_check=False, shape=shape, stride=stride)


def _frames_out(local: torch.Tensor, mesh: DeviceMesh, keep: int | None,
                pad_to: int | None = None) -> DTensor:
    """Every rank's ``(B_l, n, ...)`` piece as a DTensor sharded (data,
    time); to keep only the first ``keep`` entries of axis 1 (then
    zero-extended to ``pad_to``), the pieces are gathered over 'time' and
    split again (:func:`_split_time`): keeping fewer moves entries between
    shards."""
    if keep is None:
        return from_local(local.contiguous(), mesh, placements(mesh, P(DATA_AXIS, TIME_AXIS)))
    return _split_time(_comm.all_gather(local, mesh, TIME_AXIS, dim=1), mesh, keep, pad_to)


def stft_time_sharded(
    y: ArrayLike,
    mesh: DeviceMesh,
    n_fft: int = 2048,
    hop_length: int | None = None,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = False,
    pad_mode: str = "constant",
    fft_mode: str = "matmul",
) -> DTensor:
    """STFT of ``(batch, samples)`` sharded (data, time) -> complex
    ``(batch, n_frames, n_bins)`` sharded (data, time, -).

    NOTE the FRAMES-MAJOR layout: the sharded ops put frames on axis 1 (the
    'time'-sharded axis must lead the replicated bins), unlike the
    bins-major ``(n_bins, n_frames)`` librosa convention of the
    single-device ops: swap axes 1/2 when crossing between the two APIs.

    ``center=False``: ``n_frames = samples/hop`` (the full frame grid of
    the signal zero-padded by the halo). ``center=True``: librosa frame
    semantics, any signal length, ``n_frames = 1 + samples//hop``, frames
    identical to ``ops.stft.stft``.
    """
    if hop_length is None:
        hop_length = n_fft // 4
    if win_length is None:
        win_length = n_fft
    _validate_stft_params(n_fft, hop_length, win_length, pad_mode)
    y_local, F = _signal_shard(y, mesh, n_fft, hop_length, center, pad_mode)
    halo = n_fft - hop_length
    dev = y_local.device
    win = _get_padded_window(window, win_length, n_fft, dev)
    mode = _resolve_sharded_mode(fft_mode, _kernels_ok(n_fft, hop_length))

    ext = torch.cat([y_local, _right_halo(y_local, halo, mesh)], dim=1)
    if mode == "pallas":
        # one K2 launch per shard over the halo-extended local samples; the
        # frame grid is exactly F_s = L_s/hop (center=False)
        out = stft_fused(ext.contiguous(), win, n_fft=n_fft, hop_length=hop_length,
                         center=False, pad_mode="constant").transpose(1, 2)
    else:
        basis = forward_basis(n_fft, device=dev) if mode == "matmul" else None
        out = rfft_frames(frame_signal_batched(ext, n_fft, hop_length) * win, n_fft, basis)
    return _frames_out(out.to(COMPLEX_DTYPE), mesh, F)


def istft_time_sharded(
    S: ArrayLike,
    mesh: DeviceMesh,
    n_fft: int,
    hop_length: int | None = None,
    win_length: int | None = None,
    window: str | ArrayLike = "hann",
    center: bool = False,
    length: int | None = None,
    fft_mode: str = "matmul",
) -> DTensor:
    """Inverse of :func:`stft_time_sharded`.

    Input is FRAMES-MAJOR ``(B, F, bins)``, the layout
    :func:`stft_time_sharded` emits, not the bins-major librosa layout of
    the single-device ops (swap axes 1/2 when crossing APIs).

    ``center=False``: frames sharded (data, time, -) -> signal
    ``(B, F*hop)`` sharded (data, time); per-shard local envelope
    normalisation. ``center=True``: librosa-equal reconstruction: overlap-adds
    raw shards and normalises by the exact global envelope, then trims the
    center pad, equal to single-device ``istft`` everywhere (edges
    included); ``length`` crops/zero-pads like the single-device op.
    """
    if hop_length is None:
        hop_length = n_fft // 4
    if win_length is None:
        win_length = n_fft
    _validate_stft_params(n_fft, hop_length, win_length, "constant")
    t_size = axis_size(mesh, TIME_AXIS)
    place = placements(mesh, P(DATA_AXIS, TIME_AXIS))
    halo = n_fft - hop_length
    C = cdiv(n_fft, hop_length)
    if center:
        Sg = _global(S).to(COMPLEX_DTYPE)
        F = Sg.shape[1]
        # pad zero frames so every real frame's spill stays inside the
        # sharded domain: F*hop + halo <= F_pad*hop  <=>  F_pad >= F + C - 1
        F_work = cdiv(F + C - 1, t_size) * t_size
        S_local = local_shard(tnf.pad(Sg, (0, 0, 0, F_work - F)), mesh, place)
    else:
        if not isinstance(S, DTensor):
            S = dispatch.to_tensor(S, COMPLEX_DTYPE)
        F = F_work = S.shape[1]
        if F % t_size != 0:
            raise ValueError(f"frame count {F} must divide over {t_size} time shards")
        S_local = local_shard(S, mesh, place).to(COMPLEX_DTYPE)
    F_s = F_work // t_size
    L_s = F_s * hop_length
    if halo > L_s:
        raise ValueError("halo exceeds shard length; use fewer time shards")
    dev = S_local.device
    win = _get_padded_window(window, win_length, n_fft, dev)
    mode = _resolve_sharded_mode(fft_mode, _kernels_ok(n_fft, hop_length))

    if mode == "pallas":
        # one K3 launch per shard (inverse transform + window + overlap-add);
        # an envelope of ones leaves normalisation to the halo algebra below
        local = istft_fused(S_local, win, torch.ones(L_s + halo, dtype=REAL_DTYPE, device=dev),
                            n_fft=n_fft, hop_length=hop_length, padded_length=L_s + halo)
    else:
        basis = inverse_basis(n_fft, device=dev) if mode == "matmul" else None
        fw = irfft_frames(S_local, n_fft, basis) * win
        local = overlap_add(fw, hop_length, L_s + halo)  # tail spills right

    # carry my tail to the right neighbour (the first shard receives zeros)
    t_idx = axis_index(mesh, TIME_AXIS)
    tail = _comm.ppermute(local[:, L_s:], mesh, TIME_AXIS, shift=1)
    if t_idx == 0:
        tail = torch.zeros_like(tail)
    y_local = torch.cat([local[:, :halo] + tail, local[:, halo:L_s]], dim=1)

    if center:
        # global normalisation + librosa center trim, on the gathered signal
        raw = _comm.all_gather(y_local, mesh, TIME_AXIS, dim=1)
        total = n_fft + (F - 1) * hop_length
        wkey = _window_key(window)
        if wkey is not None:
            env = _istft_envelope_table(wkey, win_length, n_fft, F, hop_length, total,
                                        device=dev)
        else:
            env = torch.clamp(window_envelope(win, F, hop_length, total), min=WINDOW_SUM_EPSILON)
        y_full = raw[:, :total] / env
        pad = n_fft // 2
        out_len = total - 2 * pad if length is None else length
        return _split_time(y_full[:, pad:], mesh, out_len, pad_to=out_len)

    env = window_envelope(win, F_s, hop_length, L_s + halo)
    # env is identical on every shard (same window, same F_s), so the
    # neighbour's env tail equals our own: only a first-shard mask needed
    head_add = torch.zeros_like(env[L_s:]) if t_idx == 0 else env[L_s:]
    env_local = torch.cat([env[:halo] + head_add, env[halo:L_s]])
    y_local = y_local / torch.clamp(env_local, min=WINDOW_SUM_EPSILON)
    if length is None:
        return from_local(y_local.contiguous(), mesh, place)
    # same crop/pad contract as the single-device op
    return _frames_out(y_local, mesh, min(length, F * hop_length), pad_to=length)


def logmel_time_sharded(
    y: ArrayLike,
    mesh: DeviceMesh,
    sr: int = 22050,
    n_fft: int = 2048,
    hop_length: int | None = None,
    win_length: int | None = None,
    n_mels: int = 128,
    window: str | ArrayLike = "hann",
    center: bool = False,
    pad_mode: str = "constant",
    fft_mode: str = "matmul",
) -> DTensor:
    """Fused log-mel frontend, dp x sp sharded: ``(B, L)`` (data, time) ->
    ``(B, F, n_mels)`` (data, time, -). Power mel in dB without top_db clip
    (the global max would need a collective; the training frontend does not
    clip). ``center=True`` gives librosa frame semantics (any length)."""
    if hop_length is None:
        hop_length = n_fft // 4
    if win_length is None:
        win_length = n_fft
    _validate_stft_params(n_fft, hop_length, win_length, pad_mode)
    y_local, F = _signal_shard(y, mesh, n_fft, hop_length, center, pad_mode)
    halo = n_fft - hop_length
    dev = y_local.device
    win = _get_padded_window(window, win_length, n_fft, dev)
    mode = _resolve_sharded_mode(fft_mode, _kernels_ok(n_fft, hop_length))
    fb_t = mel_filterbank(sr, n_fft, n_mels=n_mels, device=dev).t()  # the cached table's view

    ext = torch.cat([y_local, _right_halo(y_local, halo, mesh)], dim=1)
    if mode == "pallas":
        # the whole per-shard pipeline (frame, window, DFT, |.|^2, mel
        # GEMM) is one K1 launch
        mel = melspectrogram_fused(ext.contiguous(), win, fb_t, n_fft=n_fft,
                                   hop_length=hop_length, center=False,
                                   pad_mode="constant").transpose(1, 2)
    else:
        basis = forward_basis(n_fft, device=dev) if mode == "matmul" else None
        spec = rfft_frames(frame_signal_batched(ext, n_fft, hop_length) * win, n_fft, basis)
        mel = torch.matmul(spec.real**2 + spec.imag**2, fb_t.contiguous())
    return _frames_out(power_to_db(mel, top_db=None), mesh, F)
