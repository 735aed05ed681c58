"""Observations occluded in-kernel a traced step: the program's counter
``obs.occlusion_kernel`` (one count a launch of ``ops/obs_gather.py``'s
kernel that computed the view's occlusion, the image or the window with its
mask of a CUDA tensor) over the traced steps.  A program whose
``ops/obs_gather.py`` has no ``observe_image`` computes the occlusion
eagerly around the gather, and reads ``None``; one that has it and occluded
nothing in the traced steps reads 0."""

import importlib

from perfbench.harness import program


def _occludes_in_kernel() -> bool:
    try:
        obs_gather = importlib.import_module("minigrid_tpu_torch.ops.obs_gather")
    except ImportError:
        return False
    return hasattr(obs_gather, "observe_image")


def read(run):
    rep = program.report()
    if rep is None or not run.trace_steps or not _occludes_in_kernel():
        return None
    return rep["counters"].get("obs.occlusion_kernel", 0) / run.trace_steps
