"""CPU tests of the cell ``babyai-bosslevel.pooled-random``: a tiny run is
``correct``; the control and each planted fault make it false, Before
evaluated as After among them; the cell's three readers read ``None``
without the program's spans and counters, and their values with them.
The cases that need many steps run the cell's ``Driver`` for a fixed
number of blocks, so that a loaded CPU cannot shorten them.

    python -m pytest perfbench/tests/test_perfbench_bosslevel.py -q
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import run as R  # noqa: E402
from perfbench.harness import program  # noqa: E402

CELL = "babyai-bosslevel.pooled-random"
SEED = 2**31 + 12345
# a batch the CPU runs in seconds, and episodes cut so that auto-resets
# happen inside a short run
WORKLOAD = {"num_envs": 64, "warmup_blocks": 1, "sample_every": 1, "sample_cap": 16}
ENV = {"max_steps": 12}
READERS = ("levelgen.descs_ms", "levelgen.desc_passes", "babyai.clauses_ms")


def tiny_run(seconds: float, **workload) -> dict:
    return R.run(CELL, SEED, seconds, False, device="cpu",
                 overrides={**WORKLOAD, **workload}, env_overrides=ENV)


def blocks_run(blocks: int, workload: dict, env: dict):
    """The cell's ``Driver`` at a small size for ``blocks`` sampled blocks:
    (the program's counts, the control's)."""
    from perfbench.drivers.vector_random import Driver

    _, _, cfg, wl = R.load_cell(CELL)
    cfg = {**cfg, "env_kwargs": {**cfg["env_kwargs"], **env}}
    drv = Driver(cfg, {**wl, **WORKLOAD, **workload, "warmup_blocks": 0}, SEED, "cpu")
    drv.setup()
    for _ in range(blocks):
        drv.block(sample=True)
    return drv.check(), drv.check(control=True)


def test_tiny_run_is_correct():
    res = tiny_run(1.0)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert res["checks"]["compared"]["value"] >= WORKLOAD["num_envs"]


def _flip_obs(out):
    obs = dict(out[0])
    image = obs["image"].clone()
    image.view(-1)[5] ^= 1
    obs["image"] = image
    return (obs,) + tuple(out[1:])


def _change_reward(out):
    reward = out[2].clone()
    reward[1] += 0.25
    return out[:2] + (reward,) + out[3:]


def _broken_vector(fault, orig):
    def step_nofill(self, state, action):
        if fault == "state_unchanged":
            out = orig(self, state, action)
            return out[:1] + (state,) + out[2:]
        if fault == "half_batch":
            half = action.clone()
            half[: action.shape[0] // 2] = 7  # 'stay': half the batch left out
            return orig(self, state, half)
        out = orig(self, state, action)
        return _flip_obs(out) if fault == "obs_byte" else _change_reward(out)
    return step_nofill


def _refill_no_levels(orig):
    def refill(self, state, windows=1):
        return orig(self, state, windows).replace(pool=state.pool)
    return refill


def _before_as_after(orig):
    """The verifier with every Before instruction evaluated as After."""
    from minigrid_tpu_torch.babyai import verifier as V

    def verify_step(vs, instr, *args, **kwargs):
        seq = torch.where(instr["seq_kind"] == V.S_BEFORE, V.S_AFTER, instr["seq_kind"])
        return orig(vs, {**instr, "seq_kind": seq.to(instr["seq_kind"].dtype)}, *args,
                    **kwargs)
    return verify_step


FAULTS = ("obs_byte", "reward", "state_unchanged", "half_batch", "refill_no_levels",
          "before_as_after")


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_makes_correct_false(fault, monkeypatch):
    from minigrid_tpu_torch.babyai import verifier as V
    from minigrid_tpu_torch.parallel.vector import VectorEnv

    if fault == "refill_no_levels":
        monkeypatch.setattr(VectorEnv, "refill", _refill_no_levels(VectorEnv.refill))
    elif fault == "before_as_after":
        monkeypatch.setattr(V, "verify_step", _before_as_after(V.verify_step))
    else:
        monkeypatch.setattr(VectorEnv, "step_nofill",
                            _broken_vector(fault, VectorEnv.step_nofill))
    if fault == "before_as_after":
        # the orders part where a clause succeeds or the hands change in a
        # Before instruction, a few env-steps in a thousand: a wider run
        counts, _ = blocks_run(16, {"num_envs": 256}, ENV)
        checks = counts.result()
        assert not R.C.correct(checks) and counts.failures() > 0, checks
        assert checks["state_wrong"]["value"] + checks["done_wrong"]["value"] > 0
        return
    res = tiny_run(0.3)
    assert not res["correct"], (fault, res["checks"])
    assert res["failed"] > 0


def test_control_is_not_correct():
    """The control (the reference's float32 reward in bfloat16, in the
    program's place) fails ``reward_ulps`` where episodes succeed: single
    GoTo clauses in two rooms of 6 cells, where random actions succeed
    within a short run."""
    env = {"room_size": 6, "num_rows": 1, "num_cols": 2, "num_dists": 8,
           "action_kinds": ["goto"], "instr_kinds": ["action"], "max_steps": 40}
    counts, control = blocks_run(24, {"num_envs": 128}, env)
    assert R.C.correct(counts.result()), counts.result()
    control = control.result()
    assert not R.C.correct(control)
    assert control["reward_ulps"]["value"] > 1000
    assert all(v["value"] == 0 for k, v in control.items()
               if k not in ("reward_ulps", "compared"))


def test_readers_read_none_without_the_program_spans(monkeypatch):
    run = SimpleNamespace(trace_steps=4)
    for report in (lambda: None, lambda: {"spans": {}, "counters": {}}):
        monkeypatch.setattr(program, "report", report)
        for metric in READERS:
            assert R.reader(metric)(run) is None, metric


def test_readers_read_the_traced_steps():
    """One traced BossLevel step at a small batch: each reader reads what
    the program recorded over it."""
    import minigrid_tpu_torch as mgt
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.utils import trace

    _, _, cfg, _ = R.load_cell(CELL)
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
        passes = trace.report()["counters"]["levelgen.desc_passes"]
        assert R.reader("levelgen.desc_passes")(run) == passes >= 1
        assert R.reader("levelgen.descs_ms")(run) > 0
        assert R.reader("babyai.clauses_ms")(run) > 0
    finally:
        trace.reset()
