"""Profiling harness: a ``torch.profiler`` trace of the vectorized rollout.

Counterpart of ``minigrid_tpu/tools/profile.py``.  :func:`profile_rollout`
times the program shape the battery times (a random-action rollout through
:func:`minigrid_tpu_torch.tools.benchmark.random_rollout`), and with
``trace_dir`` records one more run under
:func:`minigrid_tpu_torch.tools.bench.record` and writes it into
``trace_dir`` as a chrome trace.  :func:`top_kernels` reads the newest trace
there and prints a per-kernel cost table: the device kernels of a run on the
card, or on a CPU run the top-level ``aten::`` ops (the stand-in for
launches that ``tools/bench.py --profile --device cpu`` uses).

Usage:
    python -m minigrid_tpu_torch.tools.profile --env MiniGrid-DoorKey-8x8-v0 \
        --num-envs 4096 --num-steps 128 [--trace-dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import time

# trace event categories that occupy the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_rollout(env_id: str, num_envs: int, num_steps: int,
                    trace_dir: str | None = None,
                    reset_strategy: str | None = None,
                    pool_refill: int | None = None,
                    refill_period: int = 1, device=None) -> dict:
    """Profile the SAME program shape the battery times: pass the battery
    row's strategy/refill/period to see where its step actually goes.  A
    warm-up run, then a timed one; with ``trace_dir`` a third, traced, whose
    kernels (``top_kernels``), launches a step and device idle share (None
    off the card) join the result."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.parallel.vector import VectorEnv
    from minigrid_tpu_torch.tools import bench
    from minigrid_tpu_torch.tools.benchmark import random_rollout

    env = minigrid_tpu_torch.make(env_id)
    venv = VectorEnv(env, num_envs, env.default_params,
                     reset_strategy=reset_strategy, pool_refill=pool_refill,
                     device=device)

    def run(seed: int) -> None:
        float(random_rollout(venv, seed, num_steps, refill_period)[0])

    run(0)
    t0 = time.perf_counter()
    run(1)
    wall = time.perf_counter() - t0

    result = {
        "env": env_id,
        "num_envs": num_envs,
        "num_steps": num_steps,
        "wall_s": wall,
        "steps_per_sec": num_envs * num_steps / wall,
    }
    if trace_dir:
        prof, traced_s = bench.record(lambda: run(2))
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"{time.time_ns()}.trace.json")
        prof.export_chrome_trace(path)
        events = _events(path)
        result["kernels"] = _table(events, 15)
        on_card = venv.device.type == "cuda"
        launches = sum(1 for e in events if e.get("name") in bench.LAUNCH_CALLS)
        busy_us = sum(e.get("dur", 0) for e in events
                      if e.get("cat") in DEVICE_CATEGORIES)
        result["launches_per_step"] = launches / num_steps if on_card else None
        result["device_idle_share"] = (1 - busy_us / (traced_s * 1e6)
                                       if on_card else None)
    return result


def _events(path: str) -> list[dict]:
    """The complete ('X') events of a chrome trace."""
    with open(path) as f:
        data = json.load(f)
    return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


def _top_level_ops(events: list[dict]) -> list[dict]:
    """The ``aten::`` ops of the CPU events that no other CPU op encloses,
    per thread."""
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                 key=lambda e: (e["tid"], e["ts"], -e.get("dur", 0)))
    out, tid, end = [], None, float("-inf")
    for e in ops:
        if e["tid"] != tid:
            tid, end = e["tid"], float("-inf")
        if e["ts"] >= end:
            end = e["ts"] + e.get("dur", 0)
            if e["name"].startswith("aten::"):
                out.append(e)
    return out


def _table(events: list[dict], k: int | None) -> list[tuple[str, float, int]]:
    """(name, total_ms, calls), the most time first: the device kernels, or
    in a trace without any the top-level ``aten::`` ops."""
    rows = [e for e in events if e.get("cat") == "kernel"] or _top_level_ops(events)
    dur: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for e in rows:
        dur[e["name"]] += e.get("dur", 0)
        cnt[e["name"]] += 1
    return [(n, d / 1e3, cnt[n]) for n, d in dur.most_common(k)]


def top_kernels(trace_dir: str, k: int | None = 15) -> list[tuple[str, float, int]]:
    """Parse the newest chrome trace under trace_dir: (name, total_ms, calls);
    ``k=None`` gives every row."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.trace.json")))
    if not paths:
        return []
    return _table(_events(paths[-1]), k)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="MiniGrid-DoorKey-8x8-v0")
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--num-steps", type=int, default=128)
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--strategy", default=None)
    p.add_argument("--refill", type=int, default=None)
    p.add_argument("--period", type=int, default=1)
    p.add_argument("--device", default=None, help="'cpu' to run on the CPU")
    args = p.parse_args(argv)
    res = profile_rollout(args.env, args.num_envs, args.num_steps,
                          args.trace_dir, reset_strategy=args.strategy,
                          pool_refill=args.refill,
                          refill_period=args.period, device=args.device)
    print(f"{res['env']}: {res['steps_per_sec']:,.0f} env-steps/s "
          f"({res['num_envs']} envs x {res['num_steps']} steps, "
          f"{res['wall_s']*1e3:.1f} ms)")
    if res.get("launches_per_step") is not None:
        print(f"  {res['launches_per_step']:.1f} launches/step, device idle "
              f"share {res['device_idle_share']:.3f}")
    for name, ms, calls in res.get("kernels", []):
        print(f"  {ms:8.2f} ms  x{calls:5d}  {name[:70]}")


if __name__ == "__main__":
    main()
