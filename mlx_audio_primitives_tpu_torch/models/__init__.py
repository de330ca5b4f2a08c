"""Composed flagship pipelines, the conv classifier with its data-, tensor-
and pipeline-parallel training steps, and checkpoint/resume.

Counterpart of `mlx_audio_primitives_tpu/models/`, without its
expert-parallel (MoE) and transformer modules, which the port does not
hold yet."""

from .checkpoint import HAS_ORBAX, restore_checkpoint, save_checkpoint
from .convnet import (
    audio_classifier_apply,
    batch_sharding,
    convnet_apply,
    init_audio_classifier_params,
    init_convnet_params,
    make_convnet_train_step,
)
from .pipelines import (
    LogMelFrontend,
    MFCCPipeline,
    TrainableLogMelFrontend,
    init_classifier_params,
    make_sharded_train_step,
)
from .pipeline_parallel import (
    deep_classifier_apply,
    init_deep_classifier_params,
    make_pp_train_step,
    pp_param_sharding,
    pp_param_specs,
)
from .tensor_parallel import (
    make_tp_train_step,
    tp_param_sharding,
    tp_param_specs,
)
from .presets import (
    PRESETS,
    music_logmel,
    speech_kaldi_logmel,
    vggish_logmel,
    whisper_logmel,
)

__all__ = [
    "LogMelFrontend",
    "MFCCPipeline",
    "TrainableLogMelFrontend",
    "init_classifier_params",
    "make_sharded_train_step",
    "init_convnet_params",
    "convnet_apply",
    "init_audio_classifier_params",
    "audio_classifier_apply",
    "batch_sharding",
    "make_convnet_train_step",
    "make_tp_train_step",
    "tp_param_specs",
    "tp_param_sharding",
    "make_pp_train_step",
    "pp_param_specs",
    "pp_param_sharding",
    "init_deep_classifier_params",
    "deep_classifier_apply",
    "save_checkpoint",
    "restore_checkpoint",
    "HAS_ORBAX",
    "PRESETS",
    "whisper_logmel",
    "vggish_logmel",
    "speech_kaldi_logmel",
    "music_logmel",
]
