"""Build the port's CUDA kernels with nvcc, load them through ctypes, and run
them under autograd.

Every ``csrc/*.cu`` file is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), at first use,
into ``build/torch_kernels/<hash>/`` beside the package. The hash covers the
sources, the headers and the flags, so an edit rebuilds; a file lock keeps
concurrent processes from building twice.

Each kernel is described by a :class:`Kernel`: its C launcher, the argument
types, its source, the TPU kernel it replaces, and ``launches``, the count
of launches made through it; while the port records, each launch is the
span ``launch.<name>`` (`utils/profiler.py`). A launcher runs its kernel on
the stream it is given, allocates nothing and returns
``cudaGetLastError()``; :meth:`Kernel.launch` raises on anything but 0. Nothing here falls back: a
missing compiler, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from collections.abc import Callable
from pathlib import Path

import torch

from ..utils import profiler

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libmapt_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: What the build that produced the loaded library reported: its directory,
#: the seconds nvcc took (0.0 when an earlier build was reused), the seconds
#: each source's nvcc process took and nvcc's output (register and
#: shared-memory use per kernel).
build_info: dict = {}

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float


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


def _run_all(cmds: list[list[str]]) -> tuple[list[int], str, list[float]]:
    """Run the commands at once; wait for all; return their codes, their
    output (one command after another) and the seconds each took."""
    t0 = time.perf_counter()
    logs = [tempfile.TemporaryFile(mode="w+") for _ in cmds]
    procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT, text=True)
             for c, f in zip(cmds, logs)]
    seconds = [0.0] * len(procs)
    try:
        while True:
            for i, p in enumerate(procs):
                if not seconds[i] and p.poll() is not None:
                    seconds[i] = time.perf_counter() - t0
            if all(seconds) or time.perf_counter() - t0 > 900:
                break
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
    return [p.returncode for p in procs], log, seconds


def _compile(out_dir: Path, lib: Path) -> None:
    tag = f"{os.getpid()}.tmp"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    t0 = time.perf_counter()
    codes, log, per_source = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                                       for src, o in zip(sources, objs)])
    if not any(codes):
        tmp = out_dir / f"{LIB_NAME}.{tag}"
        link_codes, link_log, _ = _run_all([[_nvcc(), "-shared", "-o", str(tmp),
                                             *map(str, objs)]])
        codes, log = codes + link_codes, log + link_log
    seconds = time.perf_counter() - t0
    (out_dir / "nvcc.log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    if any(codes):
        killed = " (negative: killed at the 900 s limit)" if min(codes) < 0 else ""
        raise RuntimeError(f"nvcc failed with codes {codes}{killed}; the whole output is in "
                           f"{out_dir / 'nvcc.log'}, its end:\n{log[-6000:]}")
    os.replace(tmp, lib)
    build_info.update(dir=str(out_dir), seconds=seconds, log=log,
                      seconds_by_source={src.name: t for src, t in zip(sources, per_source)})


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
        self._span = f"launch.{name}"

    def launch(self, device: torch.device, *args, launches: int = 1) -> None:
        """Call the launcher on ``device``'s current stream; count the
        ``launches`` kernel launches it makes."""
        if profiler.recording():
            with profiler.span(self._span):
                self._launch(device, *args, launches=launches)
        else:
            self._launch(device, *args, launches=launches)

    def _launch(self, device: torch.device, *args, launches: int) -> None:
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
        self.launches += launches


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
    ``plain(*tensors, **kwargs)``: no backward kernels. Without a gradient
    to record (grad mode off, or no input requires one) the launch runs
    directly, without the autograd ``Function``'s per-call cost."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _PlainBackward.apply(launch, plain, kwargs, *tensors)
    return launch(*tensors, **kwargs)
