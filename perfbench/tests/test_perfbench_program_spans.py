"""CPU tests of the readers of the program's own spans and counters
(``perfbench/harness/program.py``): each reads ``None`` where the program
recorded no such span or counter, or has no tracing at all, and its value
from a report."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import run as R  # noqa: E402
from perfbench.harness import program  # noqa: E402

SPAN_METRICS = {
    "vector.transition_ms": "vector.transition",
    "vector.consume_ms": "vector.consume",
    "vector.observe_ms": "vector.observe",
    "vector.generate_ms": "vector.generate",
    "roomgrid.distractors_ms": "roomgrid.distractors",
    "babyai.reachable_ms": "babyai.reachable",
    "fused.step_ms": "fused.step",
}
RUN = SimpleNamespace(trace_steps=16)


def _report(spans=None, counters=None):
    return {"spans": {name: {"calls": 16, "seconds": s, "self_seconds": s / 2, "parents": []}
                      for name, s in (spans or {}).items()},
            "counters": counters or {}}


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader(metric, monkeypatch):
    read = R.reader(metric)
    monkeypatch.setattr(program, "report", lambda: _report({"other": 1.0}))
    assert read(RUN) is None
    monkeypatch.setattr(program, "report", lambda: _report({SPAN_METRICS[metric]: 0.048}))
    assert read(RUN) == pytest.approx(3.0)  # 48 ms over 16 steps
    assert read(SimpleNamespace(trace_steps=0)) is None
    monkeypatch.setattr(program, "report", lambda: None)  # a program without tracing
    assert read(RUN) is None


def test_refill_accept_frac_reader(monkeypatch):
    read = R.reader("vector.refill_accept_frac")
    for counters in ({}, {"refill.accepted": 3}, {"refill.accepted": 0, "refill.draws": 0}):
        monkeypatch.setattr(program, "report", lambda c=counters: _report(counters=c))
        assert read(RUN) is None
    monkeypatch.setattr(program, "report",
                        lambda: _report(counters={"refill.accepted": 17, "refill.draws": 32}))
    assert read(RUN) == 17 / 32


def test_readers_see_what_the_program_recorded():
    trace = pytest.importorskip("minigrid_tpu_torch.utils.trace")
    trace.reset()
    try:
        assert R.reader("vector.observe_ms")(RUN) is None
        trace.enable()
        with trace.span("vector.observe"):
            pass
        trace.count("refill.draws", 4)
        trace.count("refill.accepted", 1)
        trace.disable()
        assert R.reader("vector.observe_ms")(RUN) > 0
        assert R.reader("vector.refill_accept_frac")(RUN) == 0.25
    finally:
        trace.disable()
        trace.reset()
