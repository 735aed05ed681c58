"""Time the window kernels against another version of their sources, on one card.

    python -m minigrid_tpu_torch.tools.kernel_ab --baseline DIR [--phases]

Run from the repository root (it reuses ``chip_smoke.py``'s inputs, compare
and timer).  ``DIR`` holds another version's ``fused_step.cu`` and
``obs_gather.cu`` (with their headers), for example the parent commit's
``minigrid_tpu_torch/csrc`` unpacked with ``git archive``.  Each source is
built as the port's kernels are (``_build.compile_all``, all at once, into
``minigrid_tpu_torch/_build/ab/``), bound and launched through the
wrapper's ``Kernel``, held bitwise against the plain version, and timed in
turns, baseline first and then current, then in reverse order, with
``chip_smoke.gpu_time_ms``: ``fused_step`` on DoorKey-8x8 at B=4096 (no
lane finishes), at B=4096 with ``max_steps`` 12 (most lanes regenerate) and
at B=32768; ``obs_gather``'s window on DoorKey-8x8 states at B=4096.  A
baseline whose C entry's signature differs from the current one is not
launched: only the versions with the same entry are compared.  The current
``obs_gather``'s image mode (the whole observation, one launch) is timed
against the plain path on the card (``core/obs.py::observe_image_plain``:
the window launch, then the occlusion, overlay and encode as eager ops) on
walked DoorKey-8x8 and DoorKey-16x16 states at B=4096, V=7.

``--phases`` also times copies of the current kernels that return before a
phase (a ``return`` inserted before the phase's first line), so that the
differences between them say where the kernel's time goes; their outputs
are incomplete and are not checked (``obs_gather``'s in image mode).

Prints one line per timing and, last, one JSON object with every time in
microseconds and the card (``nvidia-smi`` name and power limit).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
from pathlib import Path

import torch

import chip_smoke as cs
from minigrid_tpu_torch.core.obs import observe_image_plain
from minigrid_tpu_torch.ops import _build
from minigrid_tpu_torch.ops import fused_step as F
from minigrid_tpu_torch.ops import obs_gather as O

WORK = _build.BUILD_DIR / "ab"

# the first line of each phase in the kernels' bodies
PHASES = {
    "fused_step": {
        "launch only": "  stage_in(a, s, n0, nt, tid, kThreads);",
        "+ stage_in": "  if (tid < nt) step_env(",
        "+ step_env": "  if (s.done[0]) {",
        "+ regenerate, write_rows, see_words": "    if (tid < nt) occlude<kV>",
        "+ occlude": "  image_bytes<kV>(a, s, nt, tid, kThreads);",
        "+ image_bytes": "  store_bytes(a.image",
    },
    "obs_gather": {
        "launch only": "  stage_words(s.grid, a.grid",
        "+ staging": "  if (a.mode == kWindow) {",
        "+ see_words": "    if (tid < nt) occlude_columns(",
        "+ occlusion": "  view_cells<kV>(",
        "+ view_cells": "  store_view(a, s, n0",
    },
}
RETURN = {"fused_step": "  if (a.N > 0) return;\n", "obs_gather": "  if (a.B > 0) return;\n"}
KERNELS = {"fused_step": F.KERNEL, "obs_gather": O.KERNEL}


def entry_signature(src: Path, kernel: str) -> str:
    """The C entry's parameter list in ``src/<kernel>.cu``, spaces folded."""
    text = (src / f"{kernel}.cu").read_text()
    params = re.search(rf'extern "C" int {kernel}\(([^)]*)\)', text)[1]
    return " ".join(params.split())


def variants(baseline: Path, phases: bool) -> dict:
    """{(kernel, name): (source dir, {line: line with a return before it})};
    no baseline of a kernel whose C entry differs from the current one."""
    out = {}
    for kernel in PHASES:
        if entry_signature(baseline, kernel) == entry_signature(_build.CSRC, kernel):
            out[kernel, "baseline"] = (baseline, {})
        else:
            print(f"{kernel}: the baseline's C entry differs; current only", flush=True)
        out[kernel, "current"] = (_build.CSRC, {})
        if phases:
            for name, line in PHASES[kernel].items():
                out[kernel, name] = (_build.CSRC, {line: RETURN[kernel] + line})
    return out


def build(todo: dict) -> dict:
    """Build every variant at once; {(kernel, name): the C entry}."""
    jobs = {}
    for i, ((kernel, name), (src, edits)) in enumerate(todo.items()):
        d = WORK / f"{kernel}-{i}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in list(src.glob("*.cu")) + list(src.glob("*.cuh")):
            shutil.copy(f, d / f.name)
        text = (d / f"{kernel}.cu").read_text()
        for line, new in edits.items():
            if text.count(line) != 1:
                raise ValueError(f"{kernel}.cu has no single line {line!r}")
            text = text.replace(line, new)
        (d / f"{kernel}.cu").write_text(text)
        jobs[kernel, name] = (d / f"{kernel}.cu", d / f"{kernel}.so")
    _build.compile_all(jobs)
    return {key: KERNELS[key[0]].bind(ctypes.CDLL(str(so))) for key, (_, so) in jobs.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="directory with the other version's fused_step.cu, obs_gather.cu")
    ap.add_argument("--phases", action="store_true",
                    help="also time the current kernels cut before each phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda")
    card = cs.card_line()
    fns = build(variants(args.baseline, args.phases))

    cases = {f"B={cs.NUM_ENVS}": cs.fused_case(dev, cs.ENV_ID, walk=24, seed=1),
             f"B={cs.NUM_ENVS} max_steps 12":
                 cs.fused_case(dev, cs.ENV_ID, walk=24, seed=2, max_steps=12),
             f"B={cs.WIDE_ENVS}": cs.fused_case(dev, cs.ENV_ID, walk=24, seed=1,
                                                num_envs=cs.WIDE_ENVS)}
    _, _, st = cs.doorkey_walk_states(dev, cs.NUM_ENVS)
    gather_args = (st.grid, st.agent_pos, st.agent_dir, cs.VIEW)
    images = {}  # the image mode's inputs by grid
    for env_id in (cs.ENV_ID, "MiniGrid-DoorKey-16x16-v0"):
        _, p, s = cs.doorkey_walk_states(dev, cs.NUM_ENVS, env_id=env_id)
        images[f"{p.width}x{p.height}"] = (s.grid, s.agent_pos, s.agent_dir, s.carrying,
                                           cs.VIEW, False)
    for name in ("baseline", "current"):
        if ("fused_step", name) in fns:
            with F.KERNEL.substituted(fns["fused_step", name]):
                for where, (fargs, spec) in cases.items():
                    cs.compare_fused(F.fused_step(*fargs, spec),
                                     F.fused_step_plain(*fargs, spec), f"{name} {where}")
        if ("obs_gather", name) in fns:
            with O.KERNEL.substituted(fns["obs_gather", name]):
                if cs.mismatches(O.gather_view(*gather_args),
                                 O.gather_view_plain(*gather_args)):
                    raise AssertionError(f"obs_gather {name} != plain")
                for grid, iargs in images.items() if name == "current" else ():
                    if cs.mismatches(O.observe_image(*iargs), observe_image_plain(*iargs)):
                        raise AssertionError(f"obs_gather image at {grid} != plain")
    print("the versions built: bitwise equal to the plain versions", flush=True)

    us = {}
    for order in (1, -1):  # baseline, current, ..., then the reverse
        for (kernel, name), fn in list(fns.items())[::order]:
            with KERNELS[kernel].substituted(fn):
                if kernel == "fused_step":
                    for where, (fargs, spec) in cases.items():
                        ms = cs.gpu_time_ms(lambda: F.fused_step(*fargs, spec))
                        us.setdefault(f"fused_step {where} {name}", []).append(ms * 1e3)
                elif name in ("baseline", "current"):
                    ms = cs.gpu_time_ms(lambda: O.gather_view(*gather_args))
                    us.setdefault(f"obs_gather B={cs.NUM_ENVS} {name}", []).append(ms * 1e3)
                if kernel == "obs_gather" and name != "baseline":
                    for grid, iargs in images.items():
                        ms = cs.gpu_time_ms(lambda: O.observe_image(*iargs))
                        us.setdefault(f"obs_gather image {grid} B={cs.NUM_ENVS} {name}",
                                      []).append(ms * 1e3)
        with O.KERNEL.substituted(fns["obs_gather", "current"]):  # the plain path's window
            for grid, iargs in images.items():
                ms = cs.gpu_time_ms(lambda: observe_image_plain(*iargs))
                us.setdefault(f"obs_gather image {grid} B={cs.NUM_ENVS} plain eager",
                              []).append(ms * 1e3)
    for where, (fargs, spec) in cases.items():
        bound = cs.fused_bound_ms(fargs, spec, F.fused_step_plain(*fargs, spec))[0]
        us[f"fused_step {where} bound"] = [bound * 1e3]
    for key, times in us.items():
        print(f"  {key}: {', '.join(f'{t:.3f}' for t in times)} us [{card}]", flush=True)
    print(json.dumps({"us": us, "card": card}))


if __name__ == "__main__":
    main()
