"""Spans and counters inside the port: where the host's time goes, layer by
layer, and how much of a layer's work was useful.

    from minigrid_tpu_torch.utils import trace

    with trace.span("vector.observe"):
        obs = ...
    trace.count("refill.draws", n)        # a host int
    trace.count("refill.accepted", ok)    # a device tensor, summed when read
    trace.count_false("obstacles.stuck", ok)  # its False entries, counted when read

Tracing is on while :func:`enable` is in force, or while a torch profiler
records (``torch.profiler.profile``, ``torch.autograd.profiler.profile`` or
``emit_nvtx``: each sets ``torch.autograd.profiler._is_profiler_enabled``).
Otherwise it is off, which is the default: :func:`span` then returns one
shared no-op context after a single test of :func:`on` and :func:`count`
returns at once, so nothing is allocated, no clock is read and no device work
is issued; a caller whose counter value would cost device work computes it
only while :func:`on` is true.

While tracing is on, a span records per name the number of calls, the total
host seconds (``time.perf_counter``), the self seconds (the total less the
time its child spans cover) and the names of the spans it ran inside.  While
a profiler records, the span also opens ``torch.profiler.record_function``
of its name, so it sits in the exported chrome trace (as a
``user_annotation`` event) on the same clock as the kernels it launched, and
in Nsight Systems under ``emit_nvtx``.  A span issues no host sync, no CUDA
event and no launch: its seconds are the host's, the time to issue the
layer's work, which equals the device's time only where the layer waits for
the device.

A counter adds a host int at once, or keeps a device tensor by reference and
sums it only when :func:`report` reads it, so counting launches nothing; a
counted tensor must not be written in place afterwards.  :func:`count_false`
counts a bool tensor's False entries the same way: its size at once, less
its True entries when the report sums them.  When more than
``FOLD_AT`` tensors wait under one name they are folded into one (a
concatenation and a sum, two launches), which bounds what the counter holds.

:func:`report` returns ``{"spans": {name: {"calls", "seconds",
"self_seconds", "parents"}}, "counters": {name: int}}``; the counters include
``<name>.launches`` for every kernel (``ops/_build.py::Kernel``): its running
launch count, :func:`launches`, which is kept whether tracing is on or off,
from 0 when the kernel's wrapper is imported, and which :func:`reset` leaves
alone.  The record is one per process, and spans nest as one thread opens
them.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

FOLD_AT = 1024

_OFF = contextlib.nullcontext()
_enabled = False
_spans: dict[str, "_Stat"] = {}
_counts: dict[str, int] = {}
_pending: dict[str, list[torch.Tensor]] = {}
_less: dict[str, list[torch.Tensor]] = {}  # tensors whose sums the report subtracts
_stack: list["_Span"] = []  # the spans open now, innermost last
_launches: dict[str, int] = {}  # the kernels' running launch counts, never reset


class _Stat:
    __slots__ = ("calls", "seconds", "self_seconds", "parents")

    def __init__(self):
        self.calls = 0
        self.seconds = 0.0
        self.self_seconds = 0.0
        self.parents: set[str] = set()


class _Span:
    __slots__ = ("name", "record", "start", "children")

    def __init__(self, name: str):
        self.name = name
        self.record = None
        self.children = 0.0

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.record = _profiler.record_function(self.name)
            self.record.__enter__()
        _stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.start
        _stack.pop()
        stat = _spans.get(self.name)
        if stat is None:
            stat = _spans[self.name] = _Stat()
        stat.calls += 1
        stat.seconds += seconds
        stat.self_seconds += seconds - self.children
        if _stack:
            parent = _stack[-1]
            parent.children += seconds
            stat.parents.add(parent.name)
        if self.record is not None:
            self.record.__exit__(*exc)
        return False


def on() -> bool:
    """Whether tracing is on now: a counter whose value costs device work is
    computed only while it is."""
    return _enabled or _profiler._is_profiler_enabled


def span(name: str):
    """A context that records ``name``'s host seconds while tracing is on,
    and the shared no-op context while it is off."""
    if not on():
        return _OFF
    return _Span(name)


def count(name: str, value) -> None:
    """Add ``value`` (a host int, or a device tensor summed when the report
    reads it) to the counter ``name`` while tracing is on."""
    if not on():
        return
    if isinstance(value, torch.Tensor):
        _keep(_pending, name, value)
    else:
        _counts[name] = _counts.get(name, 0) + int(value)


def count_false(name: str, mask: torch.Tensor) -> None:
    """Add the False entries of the bool device tensor ``mask`` to the
    counter ``name`` while tracing is on, launching nothing: its size now,
    less its True entries, which the report sums."""
    if not on():
        return
    _counts[name] = _counts.get(name, 0) + mask.numel()
    _keep(_less, name, mask)


def _keep(store: dict[str, list[torch.Tensor]], name: str, value: torch.Tensor) -> None:
    pending = store.setdefault(name, [])
    pending.append(value)
    if len(pending) > FOLD_AT:
        store[name] = [_fold(pending)]


def launched(name: str, n: int = 1) -> None:
    """Add ``n`` launches of the kernel ``name`` to its running count, tracing
    or not (``n`` 0 lists the kernel from 0)."""
    _launches[name] = _launches.get(name, 0) + n


def launches(name: str) -> int:
    """The running launch count of the kernel ``name``."""
    return _launches[name]


def _fold(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The tensors (of one device) summed into one, on their device."""
    return torch.cat([t.reshape(-1) for t in tensors]).sum()


def enable() -> None:
    """Turn tracing on until :func:`disable`."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn tracing off again (a recording profiler still turns it on)."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Forget every span and counter recorded so far."""
    _spans.clear()
    _counts.clear()
    _pending.clear()
    _less.clear()


def report() -> dict:
    """What was recorded since the last :func:`reset`: ``spans`` (per name
    ``calls``, ``seconds``, ``self_seconds``, ``parents``) and ``counters``
    (the device tensors summed now, one host read per counter)."""
    counters = dict(_counts)
    for store, sign in ((_pending, 1), (_less, -1)):
        for name, pending in store.items():
            total = _fold(pending)
            store[name] = [total]
            counters[name] = counters.get(name, 0) + sign * int(total)
    counters.update((f"{name}.launches", n) for name, n in _launches.items())
    spans = {name: {"calls": s.calls, "seconds": s.seconds,
                    "self_seconds": s.self_seconds, "parents": sorted(s.parents)}
             for name, s in _spans.items()}
    return {"spans": spans, "counters": counters}
