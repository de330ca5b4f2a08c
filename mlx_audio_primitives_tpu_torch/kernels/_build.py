"""Build the port's CUDA kernels with nvcc, load them through ctypes, and run
them under autograd.

Every ``csrc/*.cu`` file is compiled in one nvcc call into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), at first use, into ``build/torch_kernels/<hash>/`` beside the
package. The hash covers the sources, the headers and the flags, so an edit
rebuilds; a file lock keeps concurrent processes from building twice.

Each kernel is described by a :class:`Kernel`: its C launcher, the argument
types, its source, the TPU kernel it replaces, and ``launches``, the count
of launches made through it. A launcher runs its kernel on the stream it is
given, allocates nothing and returns ``cudaGetLastError()``;
:meth:`Kernel.launch` raises on anything but 0. Nothing here falls back: a
missing compiler, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections.abc import Callable
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libmapt_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: Largest grid y extent: the kernels put the clip index there.
MAX_BATCH = 65535

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: What the build that produced the loaded library reported: its directory,
#: the seconds nvcc took (0.0 when an earlier build was reused) and nvcc's
#: output (register and shared-memory use per kernel).
build_info: dict = {}

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this source hash was built before; return
    the library path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "lock", "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            if not lib.exists():
                _compile(out_dir, lib)
    build_info.setdefault("dir", str(out_dir))
    build_info.setdefault("seconds", 0.0)
    return lib


def _compile(out_dir: Path, lib: Path) -> None:
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    (out_dir / "nvcc.log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{log[-6000:]}")
    os.replace(tmp, lib)
    build_info.update(dir=str(out_dir), seconds=seconds, log=log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.mapt_error_string.argtypes = [I32]
            lib.mapt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class Kernel:
    """One hand-written CUDA kernel, reached through its C launcher.

    ``argtypes`` lists the launcher's arguments before the (device, stream)
    pair every launcher ends with."""

    def __init__(self, name: str, launcher: str, argtypes: tuple, source: str,
                 replaces: str):
        self.name = name
        self.launcher = launcher
        self.argtypes = (*argtypes, I32, P)
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; count the launch."""
        if self._fn is None:
            fn = getattr(library(), self.launcher)
            fn.argtypes = list(self.argtypes)
            fn.restype = I32
            self._fn = fn
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._fn(*args, device.index, stream)
        if err != 0:
            msg = library().mapt_error_string(err).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err} ({msg})")
        self.launches += 1


#: Every kernel of the port, in the order the modules register them.
KERNELS: list[Kernel] = []


def register(kernel: Kernel) -> Kernel:
    KERNELS.append(kernel)
    return kernel


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim``
    dimensions on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class _PlainBackward(torch.autograd.Function):
    """Kernel forward, plain-composition backward (the counterpart of the
    JAX kernels' ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, launch, plain, kwargs, *tensors):
        ctx.plain = plain
        ctx.kwargs = kwargs
        ctx.save_for_backward(*tensors)
        return launch(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*xs, **ctx.kwargs)
            wrt = [x for x, n in zip(xs, needs) if n]
            grads = iter(torch.autograd.grad(out, wrt, grad, allow_unused=True))
        return (None, None, None, *(next(grads) if n else None for n in needs))


def with_plain_backward(launch: Callable, plain: Callable, *tensors: torch.Tensor,
                        **kwargs) -> torch.Tensor:
    """``launch(*tensors, **kwargs)``, differentiated as
    ``plain(*tensors, **kwargs)``: no backward kernels."""
    return _PlainBackward.apply(launch, plain, kwargs, *tensors)
