"""PyTorch port: where an entry point runs.

A tensor input keeps its device: passing a CPU tensor is how a caller asks
for the CPU. A non-tensor input (here NumPy) goes to the default device,
``cuda`` unless the caller set another; on a machine without CUDA such an
input raises instead of running on the CPU unasked.
``set_default_device("cpu")`` sends NumPy inputs to the CPU (the other port
tests rely on it, through `torch_port_util`).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_port_util import signals

import mlx_audio_primitives_tpu_torch as tap
from mlx_audio_primitives_tpu_torch import _config
from mlx_audio_primitives_tpu_torch.ops.stft import magnitude_spectrogram

torch.set_num_threads(1)

_Y = signals(90, (2, 4096))
_S = (signals(91, (2, 257, 9)) + 1j * signals(92, (2, 257, 9))).astype(np.complex64)
_P = np.abs(signals(93, (2, 32, 9))) + 0.1
_FEAT = dict(n_fft=512, hop_length=128)
_ACF = dict(frame_length=512, hop_length=128, fmin=80.0, fmax=1000.0)

# name -> (call, NumPy input)
ENTRY_POINTS = {
    "stft": (lambda x: tap.stft(x, **_FEAT), _Y),
    "istft": (lambda x: tap.istft(x, hop_length=128), _S),
    "magnitude": (tap.magnitude, _S),
    "phase": (tap.phase, _S),
    "magphase": (lambda x: tap.magphase(x)[0], _S),
    "magnitude_spectrogram": (lambda x: magnitude_spectrogram(x, **_FEAT), _Y),
    "melspectrogram": (lambda x: tap.melspectrogram(x, n_mels=16, **_FEAT), _Y),
    "power_to_db": (tap.power_to_db, _P),
    "db_to_power": (tap.db_to_power, _P),
    "amplitude_to_db": (tap.amplitude_to_db, _P),
    "db_to_amplitude": (tap.db_to_amplitude, _P),
    "get_window": (lambda x: tap.get_window(x, 4096), _Y[0]),
    "spectral_centroid": (lambda x: tap.spectral_centroid(x, **_FEAT), _Y),
    "spectral_bandwidth": (lambda x: tap.spectral_bandwidth(x, **_FEAT), _Y),
    "spectral_rolloff": (lambda x: tap.spectral_rolloff(x, **_FEAT), _Y),
    "spectral_flatness": (lambda x: tap.spectral_flatness(x, **_FEAT), _Y),
    "spectral_contrast": (lambda x: tap.spectral_contrast(x, **_FEAT), _Y),
    "spectral_contrast_S": (lambda x: tap.spectral_contrast(S=x, **_FEAT), np.abs(_S)),
    "zero_crossing_rate": (tap.zero_crossing_rate, _Y),
    "poly_features": (lambda x: tap.poly_features(x, **_FEAT), _Y),
    "stack_memory": (tap.stack_memory, _P),
    "sync": (lambda x: tap.sync(x, [3]), _P),
    "mfcc": (lambda x: tap.mfcc(x, n_mels=32, **_FEAT), _Y),
    "mfcc_S": (lambda x: tap.mfcc(S=x, n_mfcc=8), _P),
    "delta": (tap.delta, _P),
    "dct": (tap.dct, _P),
    "frame": (lambda x: tap.frame(x, 512, 128), _Y),
    "rms": (tap.rms, _Y),
    "preemphasis": (tap.preemphasis, _Y),
    "deemphasis": (tap.deemphasis, _Y),
    "resample": (lambda x: tap.resample(x, 22050, 16000), _Y),
    "resample_kaiser": (lambda x: tap.resample(x, 22050, 16000, res_type="kaiser_fast"), _Y),
    "resample_poly": (lambda x: tap.resample_poly(x, 2, 3, padtype="median"), _Y),
    "griffinlim": (lambda x: tap.griffinlim(x, n_iter=2, hop_length=128), np.abs(_S)),
    "autocorrelation": (lambda x: tap.autocorrelation(x, max_lag=64), _Y),
    "pitch_detect_acf": (lambda x: tap.pitch_detect_acf(x, **_ACF)[0], _Y),
    "periodicity": (lambda x: tap.periodicity(x, **_ACF), _Y),
    "yin": (lambda x: tap.yin(x, 100.0, 1000.0, frame_length=512), _Y),
    "piptrack": (lambda x: tap.piptrack(x, **_FEAT)[0], _Y),
    "piptrack_S": (lambda x: tap.piptrack(S=x)[1], np.abs(_S)),
    "mel_to_stft": (lambda x: tap.mel_to_stft(x, n_fft=512, nnls_iter=5), _P),
    "mel_to_audio": (lambda x: tap.mel_to_audio(x, n_fft=512, hop_length=128, n_iter=2,
                                                nnls_iter=5), _P),
    "mfcc_to_mel": (lambda x: tap.mfcc_to_mel(x[:, :8], n_mels=32), _P),
    "mfcc_to_audio": (lambda x: tap.mfcc_to_audio(x[:, :8], n_mels=32, n_fft=512,
                                                  hop_length=128, n_iter=2, nnls_iter=5), _P),
}

# name -> table builder: no array input, so the table goes where a
# non-tensor input goes unless ``device=`` says otherwise
BUILDERS = {
    "get_window": lambda **kw: tap.get_window("hann", 512, **kw),
    "mel_filterbank": lambda **kw: tap.mel_filterbank(22050, 512, n_mels=16, **kw),
    "bark_filterbank": lambda **kw: tap.bark_filterbank(22050, 512, **kw),
    "linear_filterbank": lambda **kw: tap.linear_filterbank(22050, 512, n_bands=16, **kw),
}


@pytest.fixture
def default_cuda(monkeypatch):
    """The package default, as a caller who set nothing sees it."""
    monkeypatch.setattr(_config, "DEFAULT_DEVICE", torch.device("cuda"))


def test_the_package_default_is_cuda():
    import importlib

    fresh = importlib.reload(importlib.import_module("mlx_audio_primitives_tpu_torch._config"))
    try:
        assert fresh.DEFAULT_DEVICE == torch.device("cuda")
    finally:
        fresh.set_default_device("cpu")  # as `torch_port_util` left it


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_a_cpu_tensor_stays_on_the_cpu(name, default_cuda):
    fn, x = ENTRY_POINTS[name]
    out = fn(torch.from_numpy(np.array(x)))
    assert out.device.type == "cpu"


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_a_numpy_input_goes_to_cuda_or_raises(name, default_cuda):
    fn, x = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert fn(x).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="set_default_device"):
            fn(x)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_set_default_device_cpu_places_numpy_on_the_cpu(name, default_cuda):
    fn, x = ENTRY_POINTS[name]
    tap.set_default_device("cpu")
    assert fn(x).device.type == "cpu"


@pytest.mark.parametrize("name", list(BUILDERS))
def test_a_table_goes_to_cuda_or_raises(name, default_cuda):
    if torch.cuda.is_available():
        assert BUILDERS[name]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="set_default_device"):
            BUILDERS[name]()


@pytest.mark.parametrize("name", list(BUILDERS))
def test_a_table_follows_set_default_device_and_device(name, default_cuda):
    assert BUILDERS[name](device="cpu").device.type == "cpu"
    tap.set_default_device("cpu")
    assert BUILDERS[name]().device.type == "cpu"


def test_the_torch_default_device_is_not_read(default_cuda):
    # only the port's own setting decides; torch.set_default_device is left
    # to the caller's other libraries
    torch.set_default_device("cpu")
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                tap.stft(_Y, **_FEAT)
    finally:
        torch.set_default_device(None)
