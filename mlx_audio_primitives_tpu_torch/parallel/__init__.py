"""Multi-device parallelism on ``torch.distributed``: mesh construction,
batch (data) sharding, and time-axis (sequence-parallel) sharded STFT/mel
with halo exchange between neighbouring ranks.

Counterpart of `mlx_audio_primitives_tpu/parallel/`, with its 18 names: a
``DeviceMesh`` takes the place of the JAX ``Mesh`` and DTensor placements
that of ``NamedSharding`` (see `mesh.py`)."""

from .mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    STAGE_AXIS,
    TIME_AXIS,
    batch_sharding,
    batch_time_sharding,
    make_ep_mesh,
    make_mesh,
    make_moe_mesh,
    make_pp_mesh,
    make_tp_mesh,
    replicated,
)
from .sharding import data_parallel, shard_batch
from .time_shard import (
    istft_time_sharded,
    logmel_time_sharded,
    stft_time_sharded,
)

__all__ = [
    "DATA_AXIS",
    "TIME_AXIS",
    "MODEL_AXIS",
    "STAGE_AXIS",
    "EXPERT_AXIS",
    "make_mesh",
    "make_tp_mesh",
    "make_pp_mesh",
    "make_ep_mesh",
    "make_moe_mesh",
    "batch_sharding",
    "batch_time_sharding",
    "replicated",
    "shard_batch",
    "data_parallel",
    "stft_time_sharded",
    "istft_time_sharded",
    "logmel_time_sharded",
]
