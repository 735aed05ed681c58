"""CPU tests of the yardstick: the counting functions a roofline divides
by, at known shapes, and the reading of a profiler trace."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import run as R  # noqa: E402
from perfbench.harness import peaks  # noqa: E402
from perfbench.harness.trace import summarize  # noqa: E402

GATHER = R.reader("obs_gather_roofline").__globals__
FUSED = R.reader("fused_step_roofline").__globals__


def test_gather_bytes_at_known_shapes():
    # an agent mid-grid facing east on a 25x25 grid: the whole 7x7 view is in
    # bounds; at (1, 1) facing west, columns x 0-1 and rows y 0-4 are
    pos = np.array([[12, 12], [1, 1]])
    d = np.array([0, 2])
    assert GATHER["in_bounds_cells"](pos[:1], d[:1], 25, 25, 7) == 49
    assert GATHER["in_bounds_cells"](pos[1:], d[1:], 25, 25, 7) == 2 * 5
    b = GATHER["gather_bytes"](pos, d, 25, 25, 7)
    assert b == 2 * 12 + (49 + 10) * 4 + 2 * 49 * 4
    assert GATHER["gather_ops"](4096, 7) == 4096 * 49 * 17


def test_gather_bound_is_bytes_at_the_cell_size():
    rng = np.random.default_rng(0)
    pos = rng.integers(1, 7, size=(4096, 2))
    d = rng.integers(0, 4, size=4096)
    t = GATHER["least_seconds"](pos, d, 8, 8, 7)
    assert t == GATHER["gather_bytes"](pos, d, 8, 8, 7) / peaks.HBM_BYTES_PER_S
    assert 0.3e-6 < t < 0.45e-6


def test_fused_counts_at_known_shapes():
    n, w, h, v = 4096, 8, 8, 7
    assert FUSED["fused_bytes"](n, w, h, v, 0) == (
        n * 36 + n * 256 + 20 + n * (256 + 32 + 147 + 6) + 20)
    assert FUSED["fused_bytes"](n, w, h, v, 10) == FUSED["fused_bytes"](n, w, h, v, 0) - 10 * 252
    assert FUSED["fused_ops"](n, w, h, v, 0) == n * (60 + 49 * 27 + 8 * 7 * 6) + 3 * 80
    assert FUSED["fused_ops"](1, w, h, v, 1) - FUSED["fused_ops"](1, w, h, v, 0) == 64 * 12 + 400


def _event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_summary():
    events = [
        _event("user_annotation", "vector.step_nofill", 0, 100),
        _event("cpu_op", "aten::add", 10, 20),
        _event("cuda_runtime", "cudaLaunchKernel", 12, 5, corr=1),
        _event("cpu_op", "aten::mul", 50, 20),
        _event("cuda_runtime", "cudaLaunchKernel", 52, 5, corr=2),
        _event("kernel", "add_kernel", 20, 10, tid=7, corr=1),
        _event("kernel", "mul_kernel", 60, 30, tid=7, corr=2),
        _event("kernel", "obs_gather_kernel<7>", 80, 20, tid=7),
    ]
    s = summarize(events, 200e-6)
    assert s["launches"] == 2
    assert s["busy_s"] == pytest.approx(50e-6)  # 20-30 and 60-100, the overlap once
    assert s["kernel_calls"]["obs_gather_kernel<7>"] == [pytest.approx(20e-6)]
    assert s["breakdown"]["device_ops"][0] == ["mul_kernel", pytest.approx(30e-6)]
    assert s["breakdown"]["idle_gaps"] == [["vector.step_nofill > aten::mul",
                                            pytest.approx(30e-6)]]


def test_readers_return_nothing_without_a_trace():
    run = SimpleNamespace(trace=None, trace_steps=0, spans={}, counters={},
                          kernel_inputs={})
    for m in ("obs_gather_roofline", "fused_step_roofline", "launches_per_step.env",
              "device_idle_share.env", "vector.step_ms", "vector.refill_ms",
              "vector.fresh_frac"):
        assert R.reader(m)(run) is None


def test_roofline_reader():
    pos = np.array([[3, 3]] * 4096)
    d = np.zeros(4096, dtype=np.int64)
    least = GATHER["least_seconds"](pos, d, 8, 8, 7)
    run = SimpleNamespace(trace={"kernel_calls": {"void obs_gather_kernel<7>(Args)":
                                                  [4 * least, 4 * least]}},
                          kernel_inputs={"obs_gather": [(pos, d, 8, 8, 7)] * 2})
    assert R.reader("obs_gather_roofline")(run) == pytest.approx(25.0)
    run.kernel_inputs["obs_gather"] = run.kernel_inputs["obs_gather"][:1]
    assert R.reader("obs_gather_roofline")(run) is None
