"""CPU tests of the reader ``levelgen.descs_kernel_per_step``: ``None`` from
a program without the descriptor kernel (no ``descs.launches`` in its
report) or with no traced steps, else the counter ``levelgen.descs_kernel``
over the traced steps (0 where the kernel ran in none of them), as on a
traced BossLevel step on the CPU, which runs the plain loop.

    python -m pytest perfbench/tests/test_perfbench_descs.py -q
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import run as R  # noqa: E402
from perfbench.harness import program  # noqa: E402

METRIC = "levelgen.descs_kernel_per_step"


@pytest.mark.parametrize("report,steps,want", [
    (None, 16, None),  # a program without tracing
    ({"spans": {}, "counters": {}}, 16, None),  # one without the kernel
    ({"spans": {}, "counters": {"distractors.launches": 9,
                                "roomgrid.distractors_kernel": 16}}, 16, None),
    ({"spans": {}, "counters": {"levelgen.descs_kernel": 5}}, 16, None),
    ({"spans": {}, "counters": {"descs.launches": 3}}, 16, 0.0),
    ({"spans": {}, "counters": {"descs.launches": 9, "levelgen.descs_kernel": 16}}, 16, 1.0),
    ({"spans": {}, "counters": {"descs.launches": 9, "levelgen.descs_kernel": 3}}, 2, 1.5),
    ({"spans": {}, "counters": {"descs.launches": 9, "levelgen.descs_kernel": 16}}, 0, None),
])
def test_descs_kernel_per_step_reader(report, steps, want, monkeypatch):
    monkeypatch.setattr(program, "report", lambda: report)
    assert R.reader(METRIC)(SimpleNamespace(trace_steps=steps)) == want


def test_descs_kernel_per_step_reads_what_the_program_counted():
    trace = pytest.importorskip("minigrid_tpu_torch.utils.trace")
    pytest.importorskip("minigrid_tpu_torch.ops.descs")
    trace.reset()
    try:
        run = SimpleNamespace(trace_steps=4)
        assert R.reader(METRIC)(run) == 0
        trace.enable()
        for _ in range(6):
            trace.count("levelgen.descs_kernel", 1)
        trace.disable()
        assert R.reader(METRIC)(run) == 1.5
    finally:
        trace.disable()
        trace.reset()


def test_descs_kernel_per_step_reads_zero_on_a_cpu_boss_step():
    """One traced BossLevel step at a small batch on the CPU: the plain loop
    runs, so the reader reads 0 while the descriptor counters still count."""
    import torch

    import minigrid_tpu_torch as mgt
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.utils import trace

    _, _, cfg, _ = R.load_cell("babyai-bosslevel.pooled-random")
    venv = mgt.VectorEnv(mgt.make(cfg["env_id"], **cfg["env_kwargs"]), 16,
                         reset_strategy="pooled", pool_refill=16, device="cpu")
    _, state = venv.reset(rng.PRNGKey(5, "cpu"))
    trace.reset()
    trace.enable()
    try:
        venv.step(state, torch.randint(0, 8, (16,), dtype=torch.int32))
    finally:
        trace.disable()
    try:
        run = SimpleNamespace(trace_steps=1)
        assert trace.report()["counters"]["levelgen.desc_passes"] >= 1
        assert R.reader(METRIC)(run) == 0
    finally:
        trace.reset()


def test_descs_kernel_per_step_is_declared_for_the_boss_cell():
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metric = next(m for m in bench["per_layer"] if m["name"] == METRIC)
    assert metric["workloads"] == ["babyai-bosslevel.pooled-random"]
    assert metric["layer"] == "babyai/levelgen.py descriptor draws"
    assert (metric["moves"], metric["source"], metric["unit"], metric["better"]) == (
        "env_steps_per_s", "program_counter", "launches/step", "lower")
