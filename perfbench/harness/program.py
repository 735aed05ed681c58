"""What the program recorded of itself: ``minigrid_tpu_torch.utils.trace``'s
spans and counters.

In a run the program's tracing is on only while the traced run's profiler
records (``harness/trace.py``), so the report covers exactly the traced
steps.  A program without that module, or a run that recorded no such span
or counter, reads ``None``.
"""

from __future__ import annotations


def report() -> dict | None:
    """The program's trace report, or None where it has no tracing."""
    try:
        from minigrid_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.report()


def span_ms(run, name: str) -> float | None:
    """The span ``name``'s inclusive host ms a traced step."""
    rep = report()
    span = rep["spans"].get(name) if rep else None
    if span is None or not run.trace_steps:
        return None
    return 1e3 * span["seconds"] / run.trace_steps


def ratio(num: str, den: str) -> float | None:
    """Counter ``num`` over counter ``den``."""
    rep = report()
    counters = rep["counters"] if rep else {}
    if num not in counters or not counters.get(den):
        return None
    return counters[num] / counters[den]
