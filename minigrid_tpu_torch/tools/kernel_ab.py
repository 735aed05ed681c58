"""Time the window kernels against another version of their sources, on one card.

    python -m minigrid_tpu_torch.tools.kernel_ab --baseline DIR [--phases]

Run from the repository root (it reuses ``chip_smoke.py``'s inputs, compare
and timer).  ``DIR`` holds another version's ``fused_step.cu`` and
``obs_gather.cu`` (with their headers), for example the parent commit's
``minigrid_tpu_torch/csrc`` unpacked with ``git archive``; both versions
must keep the C entries' signatures.  Each source is built as the port's
kernels are (``_build.compile_all``, all at once, into
``minigrid_tpu_torch/_build/ab/``), bound and launched through the
wrapper's ``Kernel``, held bitwise against the plain version, and timed in
turns, baseline first and then current,
then in reverse order, with ``chip_smoke.gpu_time_ms``: ``fused_step`` on
DoorKey-8x8 at B=4096 (no lane finishes), at B=4096 with ``max_steps`` 12
(most lanes regenerate) and at B=32768; ``obs_gather`` on DoorKey-8x8
states at B=4096.

``--phases`` also times copies of the current kernels that return before a
phase (a ``return`` inserted before the phase's first line), so that the
differences between them say where the kernel's time goes; their outputs
are incomplete and are not checked.

Prints one line per timing and, last, one JSON object with every time in
microseconds and the card (``nvidia-smi`` name and power limit).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
from pathlib import Path

import torch

import chip_smoke as cs
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
        "launch only": "  stage_words(g, a.grid",
        "+ staging": "  gather_rows<kV>(",
    },
}
RETURN = {"fused_step": "  if (a.N > 0) return;\n", "obs_gather": "  if (a.B > 0) return;\n"}
KERNELS = {"fused_step": F.KERNEL, "obs_gather": O.KERNEL}


def variants(baseline: Path, phases: bool) -> dict:
    """{(kernel, name): (source dir, {line: line with a return before it})}."""
    out = {}
    for kernel in PHASES:
        out[kernel, "baseline"] = (baseline, {})
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
    for name in ("baseline", "current"):
        with F.KERNEL.substituted(fns["fused_step", name]):
            for where, (fargs, spec) in cases.items():
                cs.compare_fused(F.fused_step(*fargs, spec), F.fused_step_plain(*fargs, spec),
                                 f"{name} {where}")
        with O.KERNEL.substituted(fns["obs_gather", name]):
            if cs.mismatches(O.gather_view(*gather_args), O.gather_view_plain(*gather_args)):
                raise AssertionError(f"obs_gather {name} != plain")
    print("baseline and current: bitwise equal to the plain versions", flush=True)

    us = {}
    for order in (1, -1):  # baseline, current, ..., then the reverse
        for (kernel, name), fn in list(fns.items())[::order]:
            with KERNELS[kernel].substituted(fn):
                if kernel == "fused_step":
                    for where, (fargs, spec) in cases.items():
                        ms = cs.gpu_time_ms(lambda: F.fused_step(*fargs, spec))
                        us.setdefault(f"fused_step {where} {name}", []).append(ms * 1e3)
                else:
                    ms = cs.gpu_time_ms(lambda: O.gather_view(*gather_args))
                    us.setdefault(f"obs_gather B={cs.NUM_ENVS} {name}", []).append(ms * 1e3)
    for where, (fargs, spec) in cases.items():
        bound = cs.fused_bound_ms(fargs, spec, F.fused_step_plain(*fargs, spec))[0]
        us[f"fused_step {where} bound"] = [bound * 1e3]
    for key, times in us.items():
        print(f"  {key}: {', '.join(f'{t:.3f}' for t in times)} us [{card}]", flush=True)
    print(json.dumps({"us": us, "card": card}))


if __name__ == "__main__":
    main()
