"""MiniGrid Dynamic-Obstacles-16x16 in the port against the benchmark's plain
NumPy reference (``perfbench/reference/tasks/dynamic_obstacles.py``), on
the CPU: levels made again from their keys, the balls' cells in ``extra``
included; a random walk of the pooled engine over the three actions
through collisions and auto-resets, held by the benchmark's own check;
the eight action ids; the see-through view; a ball boxed into a corner;
the program's spans and counters; and the two controls, which the
comparison must catch.  Nothing here imports JAX.

    python -m pytest tests/test_torch_dynamic_obstacles_reference.py -q
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.utils import trace
from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import run as R  # noqa: E402
from perfbench.drivers.vector_dynamic import Driver  # noqa: E402
from perfbench.harness import state as S  # noqa: E402
from perfbench.harness.checks import Counts  # noqa: E402
from perfbench.reference import minigrid as M  # noqa: E402
from perfbench.reference.tasks import dynamic_obstacles as T  # noqa: E402

CPU = torch.device("cpu")
CELL = "dynamic-obstacles-16x16.pooled-random"
_, _, CFG, WORKLOAD = R.load_cell(CELL)
ENV = mgt.make(CFG["env_id"], **CFG["env_kwargs"])
PARAMS = ENV.default_params
KEYS = np.stack([np.full(64, 3_000_000_019 >> 32), np.arange(64) * 7919 + 11], 1)
WALK_STEPS = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Under pytest-xdist, torch on one thread beside the other workers."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _differing(ref: dict, prog: dict) -> list[str]:
    """The fields in which two level dicts differ in any row."""
    assert set(ref) == set(prog), sorted(set(ref) ^ set(prog))
    return [k for k in ref if S.rows_differ(ref[k], prog[k]).any()]


def _traced(fn):
    """``fn()`` with the program's tracing on: (its result, the report)."""
    trace.reset()
    trace.enable()
    try:
        out = fn()
        rep = trace.report()
    finally:
        trace.disable()
        trace.reset()
    return out, rep


@pytest.fixture(scope="module")
def walk():
    """32 steps of the pooled engine at B=64, ``pool_refill`` 4, actions
    uniform over the three, every step sampled, tracing on."""
    wl = {**WORKLOAD, "num_envs": 64, "pool_refill": 4, "warmup_blocks": 0,
          "sample_every": 1, "sample_cap": WALK_STEPS}

    def run():
        drv = Driver(CFG, wl, 2**31 + 4242, CPU)
        drv.setup()
        for _ in range(WALK_STEPS):
            drv.block(sample=True)
        return drv

    drv, rep = _traced(run)
    counts = drv.check()
    return drv, counts, dict(drv.events), rep


def test_levels_match_reference():
    prog = ENV.generate(torch.tensor(KEYS), PARAMS, CPU)
    ref = T.generate(KEYS, CFG)
    assert _differing(ref, S.env_levels(prog)) == []
    assert ref["extra"].shape == (64, 8, 2)


def test_levels_hold_eight_balls_off_the_agent_and_goal():
    ref = T.generate(KEYS, CFG)
    grid, extra = ref["grid"], ref["extra"]
    assert ((grid == T.BALL).sum((1, 2)) == 8).all()
    rows = np.arange(64)[:, None]
    assert (grid[rows, extra[..., 0], extra[..., 1]] == T.BALL).all()
    assert (grid[:, 14, 14] == M.GOAL).all() and (grid[:, 1, 1] == M.EMPTY).all()
    # the balls' cells differ level to level: the keys draw them
    assert len({tuple(e.reshape(-1)) for e in extra}) == 64


def test_pooled_walk_matches_reference(walk):
    """Every step's state (grid, ``extra``, ``rng``), observation, reward and
    flags, the ring's serves and refills, and the reset, held against the
    reference."""
    drv, counts, _, _ = walk
    checks = counts.result()
    assert R.C.correct(checks), checks
    assert checks["compared"]["value"] == WALK_STEPS * 64 and counts.failures() == 0


def test_walk_holds_collisions_and_auto_resets(walk):
    drv, _, events, _ = walk
    assert events["collisions"] > 0
    assert events["episodes_ended"] >= events["collisions"]
    served = drv.state.n_fresh + drv.state.n_stale
    assert int(served) == events["episodes_ended"] and int(drv.state.n_stale) > 0


def test_collision_counter_is_the_walks(walk):
    _, _, events, rep = walk
    assert rep["counters"]["dynamicobstacles.collisions"] == events["collisions"]
    assert rep["counters"]["dynamicobstacles.stuck"] == events["stuck"]


def test_spans_cover_moves_and_placements(walk):
    _, _, _, rep = walk
    spans = rep["spans"]
    assert spans["dynamicobstacles.moves"]["calls"] == WALK_STEPS
    assert spans["dynamicobstacles.moves"]["parents"] == ["vector.transition"]
    # the reset's one generator call and one refill a step
    assert spans["dynamicobstacles.place"]["calls"] == WALK_STEPS + 1


def test_late_collision_control_fails(walk):
    """The control of the mechanism: the reference judging the collision on
    the grid after the balls moved, in the program's place; it is the
    harness's control (``check(control=True)``)."""
    drv, _, _, _ = walk
    for control in ("late_collision", True):
        checks = drv.check(control=control).result()
        assert not R.C.correct(checks)
        assert checks["reward_ulps"]["value"] > 0


def test_walks_rewards_are_exact_in_bfloat16(walk):
    """Every reward of the walk is 0 or -1, which bfloat16 holds exactly,
    so the bfloat16 control reads 0 there; the goal step below fails it."""
    drv, _, _, _ = walk
    checks = drv.check(control="bf16_reward").result()
    assert checks["reward_ulps"]["value"] == 0


def _level(n: int = 1) -> dict:
    return state_to_numpy(ENV.generate(torch.tensor(KEYS[:n]), PARAMS, CPU))


def _step_both(fields: dict, action: np.ndarray):
    """One ``step_state`` of the port from ``fields`` and the reference's
    step from the same level: (port state, reward, term, trunc, reference
    step, the stuck balls the port counted)."""
    state = state_from_numpy(fields, CPU)
    ref_level = S.env_levels(state)
    (state, reward, term, trunc), rep = _traced(
        lambda: ENV.step_state(state, torch.tensor(action, dtype=torch.int32), PARAMS))
    drv = object.__new__(Driver)
    drv.task, drv.cfg, drv.control = T, CFG, None
    drv.events = {"collisions": 0, "episodes_ended": 0, "stuck": 0}
    ref = drv._step(ref_level, action, PARAMS.max_steps, M.goal_reward)
    return state, reward, term, trunc, ref, drv.events, rep["counters"]


def test_goal_step_fails_the_bfloat16_control():
    """The agent one cell west of the goal, facing it, at step 100: the
    port's reward is the float32 goal reward, and the bfloat16 control's
    differs from it."""
    fields = _level()
    fields.update(agent_pos=np.array([[13, 14]]), agent_dir=np.array([0]),
                  step_count=np.array([100]))
    action = np.array([M.FORWARD])
    state, reward, term, _, ref, _, _ = _step_both(fields, action)
    assert bool(term[0]) and bool(ref.term[0])
    c = Counts()
    assert c.ulps(S.to_np(reward), ref.reward).max() == 0
    assert S.to_np(reward)[0] == M.goal_reward(101, PARAMS.max_steps)
    drv = object.__new__(Driver)
    drv.task, drv.cfg, drv.control = T, CFG, "bf16_reward"
    drv.events = {"collisions": 0, "episodes_ended": 0, "stuck": 0}
    control = drv._step(S.env_levels(state_from_numpy(fields, CPU)), action,
                        PARAMS.max_steps, M.goal_reward_bf16)
    assert c.ulps(S.to_np(reward), control.reward).max() > 0


def test_ball_boxed_in_a_corner_stays():
    """Ball 0 in the corner (1, 14), its three free neighbours held by
    balls 1-3: it finds no cell and stays, in the port and the reference;
    the port counts it as stuck."""
    fields = _level()
    grid = fields["grid"].copy()
    extra = fields["extra"].copy()
    grid[grid == int(T.BALL)] = M.EMPTY
    cells = [(1, 14), (1, 13), (2, 13), (2, 14), (5, 5), (7, 3), (9, 9), (11, 2)]
    for i, (x, y) in enumerate(cells):
        grid[0, x, y] = T.BALL
        extra[0, i] = (x, y)
    fields.update(grid=grid, extra=extra)
    state, reward, term, trunc, ref, events, counters = _step_both(
        fields, np.array([M.LEFT]))
    prog = S.env_levels(state)
    want = {**ref.after}
    assert _differing(want, prog) == []
    assert tuple(prog["extra"][0, 0]) == (1, 14)
    assert events["stuck"] >= 1
    assert counters["dynamicobstacles.stuck"] == events["stuck"]


@pytest.mark.parametrize("action", [3, 4, 5, 6, 7])
def test_actions_past_forward_turn_left(action):
    """The eight action ids: 3 and above act as left."""
    fields = _level(8)
    s_hi = ENV.step_state(state_from_numpy(fields, CPU),
                          torch.full((8,), action, dtype=torch.int32), PARAMS)
    s_left = ENV.step_state(state_from_numpy(fields, CPU),
                            torch.full((8,), M.LEFT, dtype=torch.int32), PARAMS)
    assert _differing(S.env_levels(s_left[0]), S.env_levels(s_hi[0])) == []
    assert (T.actions(np.full(8, action)) == M.LEFT).all()


def test_collision_is_judged_before_the_moves():
    """Every env facing a ball steps forward: each collides (reward -1,
    terminated) in the port and the reference, though most balls move away
    first and the agent walks into the vacated cell."""
    fields = _level(16)
    grid = fields["grid"]
    rows = np.arange(16)
    # the agent west of ball 0, facing it
    ball = fields["extra"][:, 0]
    ok = (ball[:, 0] > 1) & (grid[rows, ball[:, 0] - 1, ball[:, 1]] == M.EMPTY)
    assert ok.sum() >= 8
    fields.update(agent_pos=np.stack([ball[:, 0] - 1, ball[:, 1]], 1), agent_dir=np.zeros(16))
    state, reward, term, _, ref, _, _ = _step_both(fields, np.full(16, M.FORWARD))
    assert (S.to_np(reward)[ok] == -1).all() and S.to_np(term)[ok].all()
    assert (ref.reward[ok] == -1).all() and ref.term[ok].all()
    moved = (S.to_np(state.agent_pos) != fields["agent_pos"]).any(1)
    assert moved[ok].any()
    assert _differing(ref.after, S.env_levels(state)) == []


def test_view_sees_through_walls():
    """The port's observation is the see-through view, and it differs from
    the occluded one in some envs (a ball hides what lies behind it)."""
    state = ENV.generate(torch.tensor(KEYS), PARAMS, CPU)
    fields = state_to_numpy(state)
    rows = np.arange(64)
    fields.update(agent_pos=np.stack([np.full(64, 8), 1 + rows % 14], 1),
                  agent_dir=rows % 4)
    state = state_from_numpy(fields, CPU)
    obs = S.to_np(ENV.observation_batch(state, PARAMS)["image"])
    level = S.env_levels(state)
    assert (T.observe(level, PARAMS.agent_view_size) == obs).all()
    occluded = M.observe(level, PARAMS.agent_view_size)
    assert S.rows_differ(occluded, obs).any()
