"""CPU tests of the reader ``rng.threefry_per_step``: ``None`` from a program
without the threefry kernel (no ``threefry.launches`` in its report) or with
no traced steps, else the counter ``rng.threefry`` over the traced steps (0
where the kernel ran in none of them)."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import run as R  # noqa: E402
from perfbench.harness import program  # noqa: E402

METRIC = "rng.threefry_per_step"


@pytest.mark.parametrize("report,steps,want", [
    (None, 16, None),  # a program without tracing
    ({"spans": {}, "counters": {}}, 16, None),  # one without the kernel
    ({"spans": {}, "counters": {"rng.threefry": 5}}, 16, None),
    ({"spans": {}, "counters": {"threefry.launches": 9}}, 16, 0.0),
    ({"spans": {}, "counters": {"threefry.launches": 9, "rng.threefry": 400}}, 2, 200.0),
    ({"spans": {}, "counters": {"threefry.launches": 9, "rng.threefry": 16}}, 16, 1.0),
    ({"spans": {}, "counters": {"threefry.launches": 9, "rng.threefry": 16}}, 0, None),
])
def test_threefry_per_step_reader(report, steps, want, monkeypatch):
    monkeypatch.setattr(program, "report", lambda: report)
    assert R.reader(METRIC)(SimpleNamespace(trace_steps=steps)) == want


def test_threefry_per_step_reads_what_the_program_counted():
    trace = pytest.importorskip("minigrid_tpu_torch.utils.trace")
    trace.reset()
    try:
        run = SimpleNamespace(trace_steps=4)
        assert R.reader(METRIC)(run) == 0
        trace.enable()
        for _ in range(6):
            trace.count("rng.threefry", 1)
        trace.disable()
        assert R.reader(METRIC)(run) == 1.5
    finally:
        trace.disable()
        trace.reset()
