"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``.  A library is
built once per content hash (its source, the headers beside it and the
flags), at first use, into ``minigrid_tpu_torch/_build/``.  All sources not yet
built compile together, one ``nvcc`` process each.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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


def build_all() -> dict[str, str]:
    """Build every source whose library is missing, all at once.  Returns
    the compiler's output (ptxas register and memory report) per source
    built; raises if any build fails."""
    todo = [src for src in sorted(CSRC.glob("*.cu"))
            if not library_path(src).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in todo:
        target = library_path(src)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, target, tmp, proc))
    logs, failed = {}, []
    for src, target, tmp, proc in jobs:
        try:
            out, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        logs[src.stem] = out
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build_all()
    return ctypes.CDLL(str(library_path(CSRC / f"{name}.cu")))
