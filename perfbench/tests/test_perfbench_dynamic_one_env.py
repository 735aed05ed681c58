"""CPU tests of the cells ``dynamic-obstacles-16x16.pooled-random`` and
``doorkey-8x8.one-env``: a tiny run of each is ``correct``, the one-env
cell on ``SingleEnv`` and on ``GymEnv``, its subclass; each cell's
harness control makes it false (the late collision through
``reward_ulps``, a reset that reuses the key before its own through
``start_wrong``), as do planted faults in the one-env cell (a reset that
does not move its key, a reward changed on the way to the host) and, on a
planned goal step, the bfloat16 reward; the new readers read ``None``
without the program's span and counter, and numbers with them.

    python -m pytest perfbench/tests/test_perfbench_dynamic_one_env.py -q
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import run as R  # noqa: E402
from perfbench.drivers import one_env  # noqa: E402
from perfbench.harness import program  # noqa: E402
from minigrid_tpu_torch import single_env  # noqa: E402

DO = "dynamic-obstacles-16x16.pooled-random"
ONE = "doorkey-8x8.one-env"
SEED = 2**40 + 4321
TINY_DO = {"num_envs": 64, "pool_refill": 4, "warmup_blocks": 1, "sample_every": 1,
           "sample_cap": 8}


def one_env_run(seconds: float, also_control: bool = False) -> dict:
    return R.run(ONE, SEED, seconds, False, device="cpu", also_control=also_control,
                 overrides={"sample_every": 1, "sample_cap": 32},
                 env_overrides={"max_steps": 24})


def test_dynamic_obstacles_tiny_run_is_correct():
    res = R.run(DO, SEED, 0.5, False, device="cpu", overrides=TINY_DO, also_control=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert res["checks"]["compared"]["value"] >= 2 * 64
    # the harness's control is the late collision
    assert not R.C.correct(res["control_checks"])
    assert res["control_checks"]["reward_ulps"]["value"] > 0


def test_late_collision_control_makes_reward_wrong():
    from perfbench.drivers import vector_dynamic as VD

    bench, cell, cfg, wl = R.load_cell(DO)
    drv = VD.Driver(cfg, {**wl, **TINY_DO}, SEED, torch.device("cpu"))
    drv.setup()
    for _ in range(8):
        drv.block(sample=True)
    assert R.C.correct(drv.check().result())
    assert drv.events["collisions"] > 0
    checks = drv.check(control="late_collision").result()
    assert not R.C.correct(checks) and checks["reward_ulps"]["value"] > 0
    with pytest.raises(ValueError):
        drv.check(control="no_such_control")


@pytest.mark.parametrize("adapter", ["gym", "core"])
def test_one_env_tiny_run_is_correct(adapter, monkeypatch):
    if adapter == "gym":
        gc = pytest.importorskip("minigrid_tpu_torch.gym_compat")
        monkeypatch.setattr(single_env, "SingleEnv", gc.GymEnv)
    res = one_env_run(0.5, also_control=True)
    assert res["correct"], res["checks"]
    assert res["checks"]["compared"]["value"] >= 32
    assert res["metrics"]["env_steps_per_s"]["value"] > 0
    # the harness's control: every reset after the first replays a level
    assert not R.C.correct(res["control_checks"])
    assert res["control_checks"]["start_wrong"]["value"] > 0


def test_one_env_reset_key_reuse_makes_start_wrong(monkeypatch):
    """An adapter whose unseeded reset does not move its key on replays
    one level: the second and later resets differ from their keys'."""
    reset = single_env.SingleEnv.reset

    def stuck(self, *, seed=None, options=None):
        key = self._key
        out = reset(self, seed=seed)
        if seed is None:
            self._key = key
        return out

    monkeypatch.setattr(single_env.SingleEnv, "reset", stuck)
    res = one_env_run(0.5)
    assert not res["correct"] and res["checks"]["start_wrong"]["value"] > 0


def test_one_env_changed_reward_makes_reward_wrong(monkeypatch):
    step = single_env.SingleEnv.step

    def changed(self, action):
        out = step(self, action)
        return out[:1] + (out[1] + 0.25,) + out[2:]

    monkeypatch.setattr(single_env.SingleEnv, "step", changed)
    res = one_env_run(0.3)
    assert not res["correct"] and res["checks"]["reward_ulps"]["value"] > 0


def plan_to_goal(level: dict, limit: int) -> list[int]:
    """The fewest actions that take the reference from ``level`` to the
    goal: a breadth-first search over its step."""
    from collections import deque

    from perfbench.reference import minigrid as M

    def sig(st):
        return (tuple(st["pos"][0]), int(st["dir"][0]), int(st["carrying"][0]),
                st["grid"].tobytes())

    queue, seen = deque([(level, [])]), {sig(level)}
    while queue:
        st, plan = queue.popleft()
        for a in (M.LEFT, M.RIGHT, M.FORWARD, M.PICKUP, M.TOGGLE):
            after, reward, term, trunc, _ = M.step(st, np.array([a]), limit)
            if term[0] and reward[0] > 0:
                return plan + [a]
            if term[0] or trunc[0] or sig(after) in seen:
                continue
            seen.add(sig(after))
            queue.append(({**after, "terminated": term, "truncated": trunc}, plan + [a]))
    raise AssertionError("no path to the goal")


def test_one_env_goal_step_fails_the_bfloat16_control():
    """Planned actions reach the goal: the run is correct, its goal reward
    the float32 one, and the bfloat16 control's differs from it."""
    bench, cell, cfg, wl = R.load_cell(ONE)
    drv = one_env.Driver(cfg, {**wl, "warmup_blocks": 0}, SEED, torch.device("cpu"))
    level = drv.task.generate(one_env.key_stream(drv.seed32, 1), cfg)
    plan = plan_to_goal(level, drv.params.max_steps)
    drv.pending = iter(plan)
    drv.setup()
    for _ in range(len(plan) // wl["block_steps"] + 1):
        drv.block(sample=True)
    assert any(r > 0 and term for _, r, term, _ in drv.log)
    assert R.C.correct(drv.check().result())
    checks = drv.check(control="bf16_reward").result()
    assert not R.C.correct(checks) and checks["reward_ulps"]["value"] > 0
    with pytest.raises(ValueError):
        drv.check(control="no_such_control")


def test_key_stream_is_the_adapters():
    from minigrid_tpu_torch.core import rng

    key = rng.PRNGKey(77, "cpu")
    want = []
    for _ in range(3):
        key, k = rng.split(key).unbind(0)
        want.append(k.tolist())
    assert one_env.key_stream(77, 3).tolist() == want


READERS = ("dynamicobstacles.moves_ms", "dynamicobstacles.collisions_per_step")


def test_readers_read_none_without_the_program_span_and_counter(monkeypatch):
    run = SimpleNamespace(trace_steps=4)
    for report in (lambda: None, lambda: {"spans": {}, "counters": {}}):
        monkeypatch.setattr(program, "report", report)
        for metric in READERS:
            assert R.reader(metric)(run) is None, metric


def test_readers_read_the_traced_steps(monkeypatch):
    monkeypatch.setattr(program, "report", lambda: {
        "spans": {"dynamicobstacles.moves": {"calls": 4, "seconds": 0.02,
                                             "self_seconds": 0.02, "parents": []}},
        "counters": {"dynamicobstacles.collisions": 1200}})
    run = SimpleNamespace(trace_steps=4)
    assert R.reader("dynamicobstacles.moves_ms")(run) == pytest.approx(5.0)
    assert R.reader("dynamicobstacles.collisions_per_step")(run) == pytest.approx(300.0)
