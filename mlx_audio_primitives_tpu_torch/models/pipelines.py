"""Flagship composed pipelines.

Counterpart of `mlx_audio_primitives_tpu/models/pipelines.py`: the composed
DSP pipelines (melspectrogram -> dB -> MFCC) as reusable callables, the
trainable log-mel and PCEN frontends, and a multi-device training step
around the log-mel frontend that exercises dp x sp sharding.

Parameters are trees (dicts) of float32 tensors, as the JAX package's are
trees of arrays; a training step takes them as global tensors or DTensors
and returns DTensors (`models/convnet.py::make_sgd_step`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as tnf
from torch.distributed.device_mesh import DeviceMesh

from .._config import REAL_DTYPE
from ..kernels.mel_fused import melspectrogram_fused, melspectrogram_plain
from ..ops.convert import _to_db, power_to_db
from ..ops.mel import mel_filterbank, melspectrogram
from ..ops.mfcc import mfcc
from ..ops.pcen import pcen_smoother
from ..ops.stft import _as_batched, _get_padded_window
from ..parallel import _comm
from ..parallel.mesh import DATA_AXIS, TIME_AXIS, P, axis_size, placements
from ..parallel.sharding import from_local, local_shard
from ..parallel.time_shard import logmel_time_sharded
from ..utils import dispatch
from ..utils.profiler import traced

ArrayLike = Any


class LogMelFrontend:
    """Batched log-mel feature extractor (the library's flagship pipeline).

    ``(batch, samples) -> (batch, n_mels, n_frames)`` in dB: frame ->
    window -> rDFT -> power -> mel GEMM -> log, through K1 on a CUDA tensor
    where the radix shape gate admits the shape.

    ``top_db`` defaults to None: the dB dynamic-range clamp is relative to
    the GLOBAL array max (librosa semantics), so enabling it makes a batch
    item's features depend on its batch-mates, undesirable for a training
    frontend. Set it explicitly for librosa-style per-call clipping.
    """

    def __init__(
        self,
        sr: int = 22050,
        n_fft: int = 2048,
        hop_length: int = 512,
        win_length: int | None = None,
        n_mels: int = 128,
        fmin: float = 0.0,
        fmax: float | None = None,
        htk: bool = False,
        norm: str | None = "slaney",
        top_db: float | None = None,
    ):
        self.sr, self.n_fft, self.hop_length = sr, n_fft, hop_length
        self.win_length = win_length
        self.n_mels, self.fmin, self.fmax = n_mels, fmin, fmax
        self.htk, self.norm = htk, norm
        self.top_db = top_db

    def __call__(self, y: ArrayLike) -> torch.Tensor:
        mel = melspectrogram(
            y,
            sr=self.sr,
            n_fft=self.n_fft,
            hop_length=self.hop_length,
            win_length=self.win_length,
            n_mels=self.n_mels,
            fmin=self.fmin,
            fmax=self.fmax,
            htk=self.htk,
            norm=self.norm,
        )
        return power_to_db(mel, top_db=self.top_db)


class WhisperLogMelFrontend:
    """Whisper's log-mel features (openai/whisper, ``whisper/audio.py``:
    ``pad_or_trim``, then ``log_mel_spectrogram``), batched: ``(samples,)``
    or ``(batch, samples)`` at 16 kHz -> ``(n_mels, 3000)`` or ``(batch,
    n_mels, 3000)``.

    Each clip is padded with zeros or trimmed to 480,000 samples (30 s). Its
    mel power spectrogram (n_fft 400, hop 160, a periodic Hann window,
    centred with a reflect pad, Slaney mels to 8 kHz) runs K1's mixed-radix
    entry on a CUDA tensor; its last frame is dropped, as a view; then K6's
    per-item form takes ``10 log10(max(mel, 1e-10))``, floors it 80 dB below
    the clip's own maximum and maps it by ``/ 40 + 1``, which is Whisper's
    ``(max(L, L.max() - 8) + 4) / 4`` on ``L = log10(max(mel, 1e-10))``. The
    maximum is each clip's, as Hugging Face's ``WhisperFeatureExtractor``
    takes it in a batch, so a clip's features do not depend on its
    batch-mates. ``use_pallas`` routes both steps as the ops route it.
    Large-v3's 128 mels (earlier versions had 80).
    """

    sr, n_fft, hop_length, n_samples, n_mels, fmax = 16000, 400, 160, 480_000, 128, 8000.0

    def __init__(self, use_pallas: bool | None = None):
        self.use_pallas = use_pallas

    @traced("models.whisper_v3_logmel")
    def __call__(self, y: ArrayLike) -> torch.Tensor:
        y = dispatch.to_tensor(y, REAL_DTYPE)
        if y.dim() not in (1, 2):
            raise ValueError(f"expected (samples,) or (batch, samples), got shape {tuple(y.shape)}")
        n = y.shape[-1]
        if n > self.n_samples:
            y = y[..., :self.n_samples]
        elif n < self.n_samples:
            y = tnf.pad(y, (0, self.n_samples - n))
        mel = melspectrogram(
            y, sr=self.sr, n_fft=self.n_fft, hop_length=self.hop_length, window="hann",
            center=True, pad_mode="reflect", power=2.0, n_mels=self.n_mels, fmin=0.0,
            fmax=self.fmax, htk=False, norm="slaney", use_pallas=self.use_pallas,
        )
        return _to_db("power_to_db", mel[..., :-1], 1.0, 10.0, 1e-10, 80.0,
                      per_item=mel.dim() == 3, scale=1.0 / 40.0, offset=1.0,
                      use_pallas=self.use_pallas)


class MFCCPipeline:
    """Batched MFCC extractor: mel -> dB -> DCT-II -> liftering."""

    def __init__(
        self,
        sr: int = 22050,
        n_mfcc: int = 13,
        n_fft: int = 2048,
        hop_length: int = 512,
        n_mels: int = 128,
        lifter: int = 0,
    ):
        self.sr, self.n_mfcc = sr, n_mfcc
        self.n_fft, self.hop_length = n_fft, hop_length
        self.n_mels, self.lifter = n_mels, lifter

    def __call__(self, y: ArrayLike) -> torch.Tensor:
        return mfcc(
            y,
            sr=self.sr,
            n_mfcc=self.n_mfcc,
            n_fft=self.n_fft,
            hop_length=self.hop_length,
            n_mels=self.n_mels,
            lifter=self.lifter,
        )


class TrainableLogMelFrontend:
    """Log-mel frontend with a LEARNABLE filterbank.

    On a CUDA tensor the forward is K1 (`kernels/mel_fused.py`); its backward
    differentiates the plain composition (`kernels/_build.py::
    with_plain_backward`), which gives the cotangents of the filterbank and
    the signal, so the filterbank trains end to end like any other
    parameter (initialised at the mel bank, reshaped by the task).

    ``init_params()`` returns ``{"fb_t": (n_bins, n_mels)}`` initialised to
    the slaney mel bank on the default device; ``apply(params, y)`` returns
    ``(B, n_mels, F)`` dB features, differentiable in both ``params`` and
    ``y``.
    """

    def __init__(
        self,
        sr: int = 22050,
        n_fft: int = 2048,
        hop_length: int = 512,
        n_mels: int = 128,
        window: str = "hann",
    ):
        self.sr, self.n_fft, self.hop_length = sr, n_fft, hop_length
        self.n_mels = n_mels
        self.window = window

    def init_params(self) -> dict[str, torch.Tensor]:
        fb = mel_filterbank(self.sr, self.n_fft, n_mels=self.n_mels)
        return {"fb_t": fb.t().clone(memory_format=torch.contiguous_format)}

    def apply(
        self, params: dict, y: ArrayLike, use_pallas: bool | None = None,
        db: bool = True,
    ) -> torch.Tensor:
        y, input_is_1d = _as_batched(y, self.n_fft, True)
        win = _get_padded_window(self.window, self.n_fft, self.n_fft, y.device)
        # K1 takes any filterbank width (its contraction walks 16-column
        # tiles), so the route reads the width of the filterbank passed only
        # through the wrapper's shape check
        fb_t = torch.as_tensor(params["fb_t"], dtype=REAL_DTYPE, device=y.device).contiguous()
        kw = dict(n_fft=self.n_fft, hop_length=self.hop_length, center=True,
                  pad_mode="constant")
        if dispatch.route("trainable_logmel_frontend", use_pallas, y.device,
                          gate=dispatch.radix_shape_ok(self.n_fft, self.hop_length)):
            mel = melspectrogram_fused(y, win, fb_t, **kw)
        else:
            mel = melspectrogram_plain(y, win, fb_t, **kw)
        out = power_to_db(mel, top_db=None) if db else mel
        return out[0] if input_is_1d else out


# ---------------------------------------------------------------------------
# Multi-device training step (dp over 'data', sp over 'time')


def init_classifier_params(
    n_mels: int, n_classes: int, seed: int = 0
) -> dict[str, torch.Tensor]:
    rng = np.random.default_rng(seed)
    dev = dispatch.default_device()
    return {
        "w": torch.tensor(
            (rng.standard_normal((n_mels, n_classes)) / np.sqrt(n_mels)).astype(np.float32),
            device=dev,
        ),
        "b": torch.zeros((n_classes,), dtype=REAL_DTYPE, device=dev),
    }


def _nll_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``logits``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0].mean()


def make_sharded_train_step(
    mesh: DeviceMesh,
    sr: int = 22050,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    n_classes: int = 10,
    lr: float = 1e-2,
    fft_mode: str = "matmul",
):
    """SGD step of a log-mel + linear classifier, sharded dp x sp.

    The log-mel frontend runs time-sharded with the halo exchange (sequence
    parallelism), frame pooling sums over 'time' with an ``all_reduce``,
    and the loss and gradients are averaged over 'data' (data
    parallelism); parameters stay replicated. Returns
    ``step(params, y, labels) -> (new_params, loss)`` with ``y`` sharded
    (data, time) (a DTensor, or the global array).
    """
    from .convnet import make_sgd_step

    t_size = axis_size(mesh, TIME_AXIS)
    rep = placements(mesh, P())

    def body(params, y, labels):
        feats = logmel_time_sharded(
            y, mesh, sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels,
            fft_mode=fft_mode,
        ).to_local()  # (B_l, F_l, n_mels), sharded (data, time, -)
        lab = local_shard(labels, mesh, placements(mesh, P(DATA_AXIS))).to(feats.device)
        p = {k: local_shard(v, mesh, rep).detach().requires_grad_(True) for k, v in params.items()}
        # mean-pool over ALL frames: local sum + sum over 'time'
        pooled = _comm.psum(feats.sum(dim=1), mesh, TIME_AXIS) / (feats.shape[1] * t_size)
        loss = _nll_loss(torch.matmul(pooled, p["w"]) + p["b"], lab)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        # the params sit DOWNSTREAM of the sum over 'time' (pooled features
        # are complete on every time shard), so each time shard computes the
        # full, identical gradient: the mean over 'time' is a consistency
        # no-op and the mean over 'data' is the data-parallel average
        for g in grads.values():
            _comm.pmean_(g, mesh, (DATA_AXIS, TIME_AXIS))
        loss = _comm.pmean_(loss.detach(), mesh, (DATA_AXIS,))
        return loss, {k: from_local(g, mesh, rep) for k, g in grads.items()}

    return make_sgd_step(body, lr)


class TrainablePCENFrontend:
    """PCEN-mel frontend with LEARNABLE per-channel compression.

    The Wang et al. (2017) trainable frontend: on top of the (optionally
    learnable) mel filterbank, each mel channel owns its own PCEN gain,
    bias, root-compression power and smoother coefficient, all trained end
    to end. Positivity/range constraints are enforced by parameterisation
    (softplus for gain/bias/power, sigmoid for the smoother coefficient), so
    plain SGD cannot step out of the valid region. Gradients flow through
    everything: K1's plain-composition backward, the blocked-scan smoother
    (:func:`~..ops.pcen.pcen_smoother`), and the expm1/log1p compression.

    ``init_params()`` -> ``{"fb_t", "gain_raw", "bias_raw", "power_raw",
    "b_logit"}`` initialised at the published defaults (gain 0.98, bias 2,
    power 0.5, b from a 0.4 s time constant); ``apply(params, y)`` ->
    ``(B, n_mels, F)`` PCEN features.
    """

    def __init__(
        self,
        sr: int = 22050,
        n_fft: int = 2048,
        hop_length: int = 512,
        n_mels: int = 128,
        window: str = "hann",
        eps: float = 1e-6,
    ):
        self.mel = TrainableLogMelFrontend(
            sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels, window=window,
        )
        self.n_mels = n_mels
        self.eps = float(eps)
        t_frames = 0.4 * sr / float(hop_length)
        self._b0 = float((np.sqrt(1.0 + 4.0 * t_frames**2) - 1.0) / (2.0 * t_frames**2))

    @staticmethod
    def _inv_softplus(x: float) -> float:
        return float(np.log(np.expm1(x)))

    def init_params(self) -> dict[str, torch.Tensor]:
        m = self.n_mels
        p = self.mel.init_params()
        dev = p["fb_t"].device

        def full(v):
            return torch.full((m,), v, dtype=REAL_DTYPE, device=dev)

        p["gain_raw"] = full(self._inv_softplus(0.98))
        p["bias_raw"] = full(self._inv_softplus(2.0))
        p["power_raw"] = full(self._inv_softplus(0.5))
        p["b_logit"] = full(float(np.log(self._b0 / (1.0 - self._b0))))
        return p

    def apply(
        self, params: dict, y: ArrayLike, use_pallas: bool | None = None
    ) -> torch.Tensor:
        # mel POWER (the dB step of the parent class is replaced by the PCEN
        # compression law); the learned filterbank can project negative
        # values and PCEN's compression law needs nonnegative energies
        # (log1p / ``**-gain`` otherwise NaN within two SGD steps)
        mel = torch.clamp(self.mel.apply(params, y, use_pallas=use_pallas, db=False), min=0.0)
        gain = tnf.softplus(params["gain_raw"])[:, None]
        bias = tnf.softplus(params["bias_raw"])[:, None]
        power = tnf.softplus(params["power_raw"])[:, None]
        b = torch.sigmoid(params["b_logit"])
        M = pcen_smoother(mel, b)
        smooth = (self.eps + M) ** (-gain)
        return (bias**power) * torch.expm1(power * torch.log1p(mel * smooth / bias))
