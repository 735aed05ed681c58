"""Build, load and launch the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``.  A library is
built once per content hash (its source, the headers beside it and the
flags), at first use, into ``minigrid_tpu_torch/_build/``.  All sources not yet
built compile together, one ``nvcc`` process each.  A failed build raises.

A :class:`Kernel` is one C entry and the whole launch protocol around it: its
wrapper in ``ops/`` builds one at import and calls :meth:`Kernel.launch` with
the entry's arguments.  ``check_tensor`` and ``check_launch`` are the
wrappers' checks of what they pass to a C entry.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from minigrid_tpu_torch.utils import trace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
_BUILD_TIMEOUT_S = 600
CUDA_DEFAULT_HOME = "/usr/local/cuda"
MAX_SHARED_BYTES = 227 * 1024  # shared memory one block may hold on Hopper
MAX_INDEX = 2 ** 31  # the kernels index their tensors with 32-bit ints


def _nvcc() -> str:
    """``nvcc`` on the PATH, else under $CUDA_HOME / $CUDA_PATH, else under
    the toolkit's default prefix."""
    homes = [os.environ.get(v) for v in ("CUDA_HOME", "CUDA_PATH")]
    candidates = [shutil.which("nvcc")] + [
        os.path.join(home, "bin", "nvcc") for home in homes + [CUDA_DEFAULT_HOME]
        if home]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(src: Path) -> Path:
    """Where the library built from ``src`` lives, named by content hash."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def compile_all(jobs: dict) -> dict:
    """Compile every ``{key: (source, library)}`` at once, one ``nvcc`` process
    each, a library appearing only whole.  Returns the compiler's output
    (ptxas register and memory report) per key; raises if any build fails."""
    nvcc = _nvcc()
    procs = {}
    for key, (src, target) in jobs.items():
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[key] = (src, target, tmp, proc)
    logs, failed = {}, []
    for key, (src, target, tmp, proc) in procs.items():
        try:
            out, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        logs[key] = out
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{src} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def build_all() -> dict[str, str]:
    """Build every source whose library is missing, all at once.  Returns
    the compiler's output per source built; raises if any build fails."""
    todo = {src.stem: (src, library_path(src)) for src in sorted(CSRC.glob("*.cu"))
            if not library_path(src).exists()}
    return compile_all(todo) if todo else {}


def check_tensor(t, name: str, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is what a kernel's C entry takes: on ``device``,
    of ``dtype`` and ``shape``, contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the kernel's inputs on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_launch(tile_bytes: int, tile: int, n: int, words_per_env: int,
                 what: str) -> None:
    """Raise ``ValueError`` unless a kernel's tile of ``tile`` envs fits in a
    block's shared memory and ``n`` envs of ``words_per_env`` elements fit
    its 32-bit indices; ``what`` names the grid."""
    if tile_bytes > MAX_SHARED_BYTES:
        raise ValueError(f"{what} needs {tile_bytes} bytes of shared memory per tile "
                         f"of {tile} envs, over the {MAX_SHARED_BYTES} a block has")
    if n * words_per_env >= MAX_INDEX:
        raise ValueError(f"{n} envs of {what} overflow the kernels' 32-bit indices")


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed (the
    span ``ops.load``)."""
    with trace.span("ops.load"):
        build_all()
        return ctypes.CDLL(str(library_path(CSRC / f"{name}.cu")))


class Kernel:
    """The C entry ``name`` of ``csrc/<name>.cu`` and its launch protocol.

    ``argtypes`` are the entry's arguments before the stream, which is always
    passed last; every entry returns 0 or a CUDA error code.  The library is
    built and loaded at the first launch, never at import.  Each launch adds
    one to the running count ``trace.launches(name)`` and, while tracing is
    on, to the traced counter ``counter`` where there is one."""

    def __init__(self, name: str, argtypes: list, counter: str | None = None):
        self.name = name
        self.argtypes = argtypes
        self.counter = counter
        self._entry = None
        trace.launched(name, 0)

    def bind(self, lib: ctypes.CDLL):
        """The entry ``name`` of ``lib``, with its argument and return types."""
        fn = getattr(lib, self.name)
        fn.argtypes = [*self.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    def check_device(self, dev: torch.device) -> None:
        """Raise ``ValueError`` unless ``dev`` is a CUDA device."""
        if dev.type != "cuda":
            raise ValueError(f"no {self.name} kernel for device {dev}")

    def launch(self, dev: torch.device, *args) -> None:
        """Launch on the current stream of the CUDA device ``dev``: the
        entry's ``args``, then the stream."""
        fn = self._entry
        if fn is None:
            fn = self._entry = self.bind(load(self.name))
        # the current stream's handle as an int: 0.2 us a call on an H100's
        # host, against 8.3 us through torch.cuda.current_stream(...).cuda_stream
        if dev.index == torch.cuda.current_device():
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
        else:
            with torch.cuda.device(dev):
                err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err}")
        trace.launched(self.name)
        if self.counter is not None:
            trace.count(self.counter, 1)

    @contextlib.contextmanager
    def substituted(self, entry):
        """Launch ``entry`` (a bound C entry of another build, or a stub) in
        place of the library's within the ``with`` block."""
        saved, self._entry = self._entry, entry
        try:
            yield
        finally:
            self._entry = saved
