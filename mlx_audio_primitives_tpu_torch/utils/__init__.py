"""Runtime utilities: validation, table caches, dispatch policy, profilers,
audio file I/O, the input pipeline and warmup. The JAX package's
``utils`` names, in its order (`mlx_audio_primitives_tpu/utils/__init__.py`),
each with its counterpart here."""

from .audio_io import get_duration, load, read_wav, to_mono, wav_info, write_wav
from .cache import TableCache, cache_stats, clear_all_caches, table_cache
from .data import batch_iterator, prefetch_to_device
from .dispatch import (
    HAS_PALLAS,
    default_backend,
    has_pallas_tpu,
    is_tpu,
    pallas_interpret_mode,
    resolve_use_pallas,
)
from .profiler import (
    clear_profiling,
    start_device_trace,
    stop_device_trace,
    tracked_to_device,
    tracked_to_host,
    disable_profiling,
    enable_profiling,
    export_json,
    generate_text_report,
    get_profiling_data,
    is_profiling,
    log_cache_access,
    log_sync_point,
    log_transfer,
    profile,
    profile_section,
)
from .memory_profiler import (
    MemoryProfile,
    estimate_operation_memory,
    get_active_memory,
    get_peak_memory,
    profile_memory,
    track_memory,
)
from .validation import validate_non_negative, validate_positive, validate_range
from .warmup import enable_persistent_compilation_cache, warmup


def __getattr__(name: str):
    # HAS_PALLAS_TPU is read when asked for, as in the JAX package
    if name == "HAS_PALLAS_TPU":
        from . import dispatch

        return dispatch.has_pallas_tpu()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "read_wav",
    "write_wav",
    "load",
    "to_mono",
    "get_duration",
    "wav_info",
    "prefetch_to_device",
    "batch_iterator",
    "warmup",
    "enable_persistent_compilation_cache",
    "TableCache",
    "table_cache",
    "clear_all_caches",
    "cache_stats",
    "HAS_PALLAS",
    "HAS_PALLAS_TPU",
    "has_pallas_tpu",
    "default_backend",
    "is_tpu",
    "pallas_interpret_mode",
    "resolve_use_pallas",
    "validate_positive",
    "validate_non_negative",
    "validate_range",
    "enable_profiling",
    "disable_profiling",
    "clear_profiling",
    "is_profiling",
    "profile",
    "profile_section",
    "log_sync_point",
    "log_transfer",
    "log_cache_access",
    "get_profiling_data",
    "generate_text_report",
    "export_json",
    "tracked_to_device",
    "tracked_to_host",
    "start_device_trace",
    "stop_device_trace",
    "MemoryProfile",
    "track_memory",
    "profile_memory",
    "get_active_memory",
    "get_peak_memory",
    "estimate_operation_memory",
]
