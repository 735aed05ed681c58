"""The device time of the operations a program span launched: a short
``torch.profiler`` pass (``harness/trace.py``'s ``record``) in which each
device operation is traced back, by its correlation id, to the runtime call
that launched it, and that call to the program's ``record_function`` ranges
of the span's name on the same host thread.
"""

from __future__ import annotations

import bisect
import collections

from perfbench.harness import program
from perfbench.harness.trace import DEVICE_CATEGORIES, record


def seconds_inside(events: list[dict], name: str) -> float | None:
    """Device seconds of the operations launched inside the ranges named
    ``name``; None where the trace has no such range."""
    ranges: dict = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == name:
            ranges[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0)))
    if not ranges:
        return None
    for spans in ranges.values():
        spans.sort()
    inside = set()
    for e in events:
        if e.get("cat") != "cuda_runtime" or e["tid"] not in ranges:
            continue
        spans = ranges[e["tid"]]
        k = bisect.bisect_right(spans, (e["ts"], float("inf"))) - 1
        # the program's ranges of one name do not nest, so the last range
        # that opened before the call is the only one that can hold it
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and k >= 0 and spans[k][0] <= e["ts"] <= spans[k][1]:
            inside.add(corr)
    return 1e-6 * sum(e.get("dur", 0) for e in events
                      if e.get("cat") in DEVICE_CATEGORIES
                      and (e.get("args") or {}).get("correlation") in inside)


def measure(body, name: str) -> dict | None:
    """Run ``body()`` under the profiler: the span ``name``'s device seconds,
    and its calls and the program's counters as the program recorded them
    over ``body``; None where the program has no such span.  The program's
    record is emptied afterwards, so that a traced window after this pass
    reads only its own."""
    events, _ = record(body)
    rep = program.report()
    span = rep["spans"].get(name) if rep else None
    seconds = seconds_inside(events, name)
    if rep is not None:
        from minigrid_tpu_torch.utils import trace

        trace.reset()
    if span is None or seconds is None:
        return None
    return {"device_s": seconds, "calls": span["calls"], "counters": rep["counters"]}
