"""CPU tests of the reader ``roomgrid.distractors_kernel_per_step``: ``None``
from a program without the distractors kernel (no ``distractors.launches``
in its report) or with no traced steps, else the counter
``roomgrid.distractors_kernel`` over the traced steps (0 where the kernel ran
in none of them)."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import run as R  # noqa: E402
from perfbench.harness import program  # noqa: E402

METRIC = "roomgrid.distractors_kernel_per_step"


@pytest.mark.parametrize("report,steps,want", [
    (None, 16, None),  # a program without tracing
    ({"spans": {}, "counters": {}}, 16, None),  # one without the kernel
    ({"spans": {}, "counters": {"threefry.launches": 9, "rng.threefry": 320}}, 16, None),
    ({"spans": {}, "counters": {"roomgrid.distractors_kernel": 5}}, 16, None),
    ({"spans": {}, "counters": {"distractors.launches": 3}}, 16, 0.0),
    ({"spans": {}, "counters": {"distractors.launches": 9,
                                "roomgrid.distractors_kernel": 16}}, 16, 1.0),
    ({"spans": {}, "counters": {"distractors.launches": 9,
                                "roomgrid.distractors_kernel": 3}}, 2, 1.5),
    ({"spans": {}, "counters": {"distractors.launches": 9,
                                "roomgrid.distractors_kernel": 16}}, 0, None),
])
def test_distractors_kernel_per_step_reader(report, steps, want, monkeypatch):
    monkeypatch.setattr(program, "report", lambda: report)
    assert R.reader(METRIC)(SimpleNamespace(trace_steps=steps)) == want


def test_distractors_kernel_per_step_reads_what_the_program_counted():
    trace = pytest.importorskip("minigrid_tpu_torch.utils.trace")
    trace.reset()
    try:
        run = SimpleNamespace(trace_steps=4)
        assert R.reader(METRIC)(run) == 0
        trace.enable()
        for _ in range(6):
            trace.count("roomgrid.distractors_kernel", 1)
        trace.disable()
        assert R.reader(METRIC)(run) == 1.5
    finally:
        trace.disable()
        trace.reset()


def test_distractors_kernel_per_step_is_declared_for_the_babyai_cells():
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metric = next(m for m in bench["per_layer"] if m["name"] == METRIC)
    assert metric["workloads"] == ["babyai-goto.pooled-random", "babyai-bosslevel.pooled-random"]
    assert metric["layer"] == "the GoTo generator's stages" and metric["moves"] == "env_steps_per_s"
