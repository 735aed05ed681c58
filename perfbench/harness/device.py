"""The card a run uses, its caches, and the modules a run may not load."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / ".perfbench_cache"
# top-level module names a run must never hold: the JAX stack and the JAX
# package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "minigrid_tpu")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds (the program's own kernels build
    into its package's ``_build/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)


def forbidden_loaded() -> list[str]:
    """The forbidden top-level names present in ``sys.modules``, compared
    whole: ``minigrid_tpu_torch`` is not ``minigrid_tpu``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def require_cards(torch, count: int) -> None:
    """Exit with code 3 and no result unless ``count`` CUDA cards are there:
    a run never falls back to the CPU."""
    if not torch.cuda.is_available():
        sys.stderr.write("perfbench: no CUDA device; the benchmark runs on a card only\n")
        raise SystemExit(3)
    if torch.cuda.device_count() < count:
        sys.stderr.write(f"perfbench: the cell needs {count} cards, "
                         f"{torch.cuda.device_count()} present\n")
        raise SystemExit(3)


def power_limit() -> str:
    """nvidia-smi's name and power limit of each card, or why it is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out
