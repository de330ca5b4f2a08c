"""Composed flagship pipelines, the conv classifier with its data-, tensor-
and pipeline-parallel training steps, the expert-parallel (Switch MoE)
classifier, the ring-attention transformer with its context-parallel step,
and checkpoint/resume.

Counterpart of `mlx_audio_primitives_tpu/models/`, with its names in its
order."""

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
from .expert_parallel import (
    ep_batch_sharding,
    init_moe_classifier_params,
    make_ep_train_step,
    make_ep_tp_train_step,
    moe_batch_sharding,
    moe_classifier_apply,
    moe_param_sharding,
    moe_param_specs,
    moe_tp_param_sharding,
    moe_tp_param_specs,
)
from .transformer import (
    init_transformer_params,
    make_cp_train_step,
    ring_attention,
    transformer_apply,
    transformer_param_sharding,
    transformer_param_specs,
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
    "make_ep_train_step",
    "make_ep_tp_train_step",
    "moe_param_specs",
    "moe_param_sharding",
    "moe_tp_param_specs",
    "moe_tp_param_sharding",
    "moe_classifier_apply",
    "moe_batch_sharding",
    "init_moe_classifier_params",
    "ep_batch_sharding",
    "init_deep_classifier_params",
    "deep_classifier_apply",
    "init_transformer_params",
    "transformer_apply",
    "ring_attention",
    "make_cp_train_step",
    "transformer_param_specs",
    "transformer_param_sharding",
    "save_checkpoint",
    "restore_checkpoint",
    "HAS_ORBAX",
    "PRESETS",
    "whisper_logmel",
    "vggish_logmel",
    "speech_kaldi_logmel",
    "music_logmel",
]
