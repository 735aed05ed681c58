"""A short ``torch.profiler`` window, read in one pass over its exported
chrome trace (the arithmetic of the port's ``tools/profile.py`` and
``tools/bench.py::_trace``, copied so that the yardstick does not move with
the program).

The summary gives the window's length on the host clock, the seconds in
which an operation ran on the device (the union of kernel, copy and memset
intervals), the kernel launches the host issued, each kernel's calls in
order, and the breakdown the result line carries: the device operations
that took most time, and the longest idle gaps of the device grouped by
what the host was issuing when the gap ended (the harness's span and the
``aten::`` op that launched the next kernel).
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time

import torch

# trace event categories that occupy the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the runtime and driver calls that launch a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
TOP = 10


def record(body) -> tuple[list[dict], float]:
    """Run ``body()`` (work ending in a host sync) under the profiler with
    CPU and CUDA activity: (the trace's complete events, the wall seconds of
    ``body``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        body()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"], wall


def _union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _launch_context(events: list[dict]) -> dict:
    """correlation id -> 'span > op' of each launch: the outermost harness
    span (``user_annotation``) and the innermost ``aten::`` op enclosing
    the runtime call."""
    host = sorted((e for e in events if e.get("cat") in ("cpu_op", "user_annotation",
                                                            "cuda_runtime")),
                  key=lambda e: (e["tid"], e["ts"], -e.get("dur", 0)))
    out, stack, tid = {}, [], None
    for e in host:
        if e["tid"] != tid:
            tid, stack = e["tid"], []
        while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= e["ts"]:
            stack.pop()
        if e.get("cat") == "cuda_runtime":
            corr = (e.get("args") or {}).get("correlation")
            span = next((s["name"] for s in stack if s.get("cat") == "user_annotation"),
                        "-")
            op = next((s["name"] for s in reversed(stack) if s.get("cat") == "cpu_op"),
                      e["name"])
            out[corr] = f"{span} > {op}"
        else:
            stack.append(e)
    return out


def summarize(events: list[dict], wall_s: float) -> dict:
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATEGORIES),
                    key=lambda e: e["ts"])
    busy_us = _union_us([(e["ts"], e["ts"] + e.get("dur", 0)) for e in device])
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                   and e.get("name") in LAUNCH_CALLS)
    per_op: collections.Counter = collections.Counter()
    calls: dict[str, list[float]] = collections.defaultdict(list)
    for e in device:
        per_op[e["name"]] += e.get("dur", 0)
        if e.get("cat") == "kernel":
            calls[e["name"]].append(e.get("dur", 0) * 1e-6)
    context = _launch_context(events)
    gaps: collections.Counter = collections.Counter()
    for prev, nxt in zip(device, device[1:]):
        gap = nxt["ts"] - (prev["ts"] + prev.get("dur", 0))
        if gap > 0:
            corr = (nxt.get("args") or {}).get("correlation")
            gaps[context.get(corr, "-")] += gap
    return {
        "window_s": wall_s,
        "busy_s": busy_us * 1e-6,
        "launches": launches,
        "kernel_calls": dict(calls),
        "breakdown": {
            "device_ops": [[n, us * 1e-6] for n, us in per_op.most_common(TOP)],
            "idle_gaps": [[n, us * 1e-6] for n, us in gaps.most_common(TOP)],
        },
    }


def trace(body, device) -> dict | None:
    """Profile ``body()``; None off a card (a CPU run has no device
    trace)."""
    if torch.device(device).type != "cuda":
        return None
    events, wall = record(body)
    return summarize(events, wall)
