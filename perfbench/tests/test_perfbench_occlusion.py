"""CPU tests of the reader ``obs.occlusion_kernel_per_step``: ``None`` from
a program without tracing, without traced steps or whose ``ops/obs_gather.py``
has no ``observe_image`` (it occludes eagerly), else the counter
``obs.occlusion_kernel`` over the traced steps (0 where no traced
observation was occluded in-kernel)."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import run as R  # noqa: E402
from perfbench.harness import program  # noqa: E402

METRIC = "obs.occlusion_kernel_per_step"


@pytest.mark.parametrize("report,steps,want", [
    (None, 16, None),  # a program without tracing
    ({"spans": {}, "counters": {"obs_gather.launches": 9}}, 16, 0.0),
    ({"spans": {}, "counters": {"obs.occlusion_kernel": 16}}, 16, 1.0),
    ({"spans": {}, "counters": {"obs.occlusion_kernel": 32}}, 16, 2.0),
    ({"spans": {}, "counters": {"obs.occlusion_kernel": 16}}, 0, None),
])
def test_occlusion_kernel_per_step_reader(report, steps, want, monkeypatch):
    monkeypatch.setattr(program, "report", lambda: report)
    assert R.reader(METRIC)(SimpleNamespace(trace_steps=steps)) == want


def test_occlusion_kernel_per_step_reads_none_for_an_eager_occlusion(monkeypatch):
    obs_gather = pytest.importorskip("minigrid_tpu_torch.ops.obs_gather")
    monkeypatch.delattr(obs_gather, "observe_image")
    monkeypatch.setattr(program, "report", lambda: {"spans": {}, "counters": {}})
    assert R.reader(METRIC)(SimpleNamespace(trace_steps=16)) is None


def test_occlusion_kernel_per_step_reads_what_the_program_counted():
    trace = pytest.importorskip("minigrid_tpu_torch.utils.trace")
    trace.reset()
    try:
        run = SimpleNamespace(trace_steps=4)
        assert R.reader(METRIC)(run) == 0
        trace.enable()
        for _ in range(8):
            trace.count("obs.occlusion_kernel", 1)
        trace.disable()
        assert R.reader(METRIC)(run) == 2.0
    finally:
        trace.disable()
        trace.reset()


def test_occlusion_kernel_per_step_is_declared_for_the_pooled_cells():
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metric = next(m for m in bench["per_layer"] if m["name"] == METRIC)
    observe = next(m for m in bench["per_layer"] if m["name"] == "vector.observe_ms")
    assert metric["workloads"] == observe["workloads"]
    assert metric["layer"] == observe["layer"] and metric["moves"] == "env_steps_per_s"
