"""The port's measuring tools on the CPU: ``tools/profile.py``,
``tools/autotune.py`` and ``tools/battery_sweep.py``, against the JAX
package's where the two share a surface (result keys, candidate labels, the
sweep's rows).  Their times mean nothing here; on the card they run in
``chip_smoke.py`` (and the trace's kernel names in
``tests/test_torch_tools_card.py``)."""

from __future__ import annotations

import json

import pytest
import torch

import jax  # noqa: F401  (the JAX package's tools below import it)

from minigrid_tpu.tools import autotune as jautotune
from minigrid_tpu.tools import battery_sweep as jsweep
from minigrid_tpu.tools import profile as jprofile

from minigrid_tpu_torch.tools import autotune, battery_sweep, profile

from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

EMPTY = "MiniGrid-Empty-5x5-v0"


@pytest.mark.parametrize("strategy,period", [(None, 1), ("pooled", 8)])
def test_profile_rollout_on_the_cpu(tmp_path, strategy, period):
    kw = dict(reset_strategy=strategy, refill_period=period)
    want = jprofile.profile_rollout(EMPTY, 4, 8, **kw)
    plain = profile.profile_rollout(EMPTY, 4, 8, device="cpu", **kw)
    assert set(plain) == set(want)
    assert plain["steps_per_sec"] > 0 and plain["wall_s"] > 0
    traced = profile.profile_rollout(EMPTY, 4, 8, trace_dir=str(tmp_path), device="cpu", **kw)
    assert set(traced) == set(want) | {"kernels", "launches_per_step", "device_idle_share"}
    # off the card there are no launches and no device: no device metric
    assert traced["launches_per_step"] is None and traced["device_idle_share"] is None
    kernels = traced["kernels"]
    assert 0 < len(kernels) <= 15
    assert all(name.startswith("aten::") and ms >= 0 and calls > 0
               for name, ms, calls in kernels)
    assert [ms for _, ms, _ in kernels] == sorted((ms for _, ms, _ in kernels), reverse=True)
    assert profile.top_kernels(str(tmp_path)) == kernels


def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_top_kernels_reads_the_newest_trace(tmp_path):
    assert profile.top_kernels(str(tmp_path)) == []
    card = [
        {"ph": "X", "cat": "kernel", "name": "obs_gather_kernel", "ts": 0, "dur": 3.0},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 5, "dur": 2.0},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 9, "dur": 2.5},
        {"ph": "X", "cat": "kernel", "name": "reduce", "ts": 12, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 9.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 99.0, "tid": 1},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3},
    ]
    _write_trace(tmp_path / "100.trace.json", card)
    assert profile.top_kernels(str(tmp_path)) == [
        ("elementwise", 0.0045, 2), ("obs_gather_kernel", 0.003, 1), ("reduce", 0.001, 1)]
    assert profile.top_kernels(str(tmp_path), 1) == [("elementwise", 0.0045, 2)]
    # a newer CPU trace: the top-level aten:: ops, each thread on its own
    cpu = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::where", "tid": 1, "ts": 0, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "tid": 1, "ts": 1, "dur": 2},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "tid": 1, "ts": 4, "dur": 6},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "tid": 1, "ts": 12, "dur": 4},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "tid": 1, "ts": 20, "dur": 4},
        {"ph": "X", "cat": "cpu_op", "name": "record", "tid": 2, "ts": 0, "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "tid": 2, "ts": 1, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "tid": 3, "ts": 1, "dur": 1},
    ]
    _write_trace(tmp_path / "200.trace.json", cpu)
    assert profile.top_kernels(str(tmp_path)) == [
        ("aten::where", 0.01, 1), ("aten::add", 0.008, 2), ("aten::mul", 0.001, 1)]


@pytest.mark.parametrize("num_envs", [8, 4096])
@pytest.mark.parametrize("expensive", [False, True])
def test_candidates_are_jax_s_without_unroll(num_envs, expensive):
    want = [c.label() for c in jautotune.candidates(num_envs, expensive) if c.unroll == 1]
    got = autotune.candidates(num_envs, expensive)
    assert [c.label() for c in got] == want
    dropped = [c for c in jautotune.candidates(num_envs, expensive) if c.unroll > 1]
    assert dropped and all(" U=" in c.label() for c in dropped)
    if num_envs == 4096:  # the phase-4j sweep's size
        assert len(got) == (16 if expensive else 17)


def test_autotune_sweeps_and_picks_best():
    """The port's copy of tests/test_tools.py's autotune test, on the CPU."""
    cands = autotune.candidates(num_envs=8, expensive=False)
    labels = [c.label() for c in cands]
    assert "fused" in labels and "conditional" in labels
    assert any(c.reset_strategy == "pooled" and c.refill_period > 1
               for c in cands)

    res = autotune.autotune(EMPTY, num_envs=8, num_steps=8, verbose=False,
                            device="cpu")
    assert res["reset_strategy"] in ("fused", "conditional", "pooled")
    assert res["steps_per_sec"] > 0
    assert res["unroll"] == 1
    # every candidate measured but K=16, which 8 steps cannot hold (it fails
    # and is reported, as in JAX)
    assert [row[0] for row in res["table"]] == [
        c.label() for c in cands if 8 % c.refill_period == 0]
    # headline selection honors the freshness floor
    assert res["fresh_frac"] is None or res["fresh_frac"] >= res["min_fresh"]
    for label, sps, fresh in res["table"]:
        assert sps > 0


def test_sweep_rows_are_jax_s():
    assert battery_sweep.SWEEP == jsweep.SWEEP
    assert len(battery_sweep.SWEEP) == 36


def test_battery_sweep_resumes(tmp_path, capsys):
    out = tmp_path / "sweep.jsonl"
    seeded = [m for m, _ in battery_sweep.SWEEP if m != "empty"]
    out.write_text("".join(json.dumps({"module": m}) + "\n" for m in seeded))
    battery_sweep.main([str(out), "--quick", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "device kernel gate skipped" in err
    assert err.count("already measured") == len(seeded)
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == len(seeded) + 1
    new = rows[-1]
    assert new["module"] == "empty" and "error" not in new, new
    assert (new["env"], new["num_envs"], new["steps"], new["device"]) == (
        "MiniGrid-Empty-8x8-v0", 256, 64, "cpu")
    assert new["strategy"] == "pooled" and new["pool_refill"] == 64
    # a second run finds every module measured and appends nothing
    battery_sweep.main([str(out), "--quick", "--device", "cpu"])
    assert out.read_text().splitlines() == [json.dumps(r) for r in rows]
    assert capsys.readouterr().err.count("already measured") == len(seeded) + 1


def test_battery_sweep_default_device_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        battery_sweep.main([str(tmp_path / "sweep.jsonl"), "--quick"])
