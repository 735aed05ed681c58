"""MiniGrid ObstructedMaze-Full in the port against the benchmark's plain
NumPy reference (``perfbench/reference/obstructedmaze.py`` and
``perfbench/reference/tasks/obstructedmaze_full.py``), on the CPU: levels
made again from their keys, every plane (the box plane included) equal; a
hand-built walk in which the agent opens a box, takes the key it held,
unlocks its door and picks up the blue ball; a random walk of the pooled
engine through its auto-resets; and the control, a level whose box
contents are dropped, which the comparison must catch.  Nothing here
imports JAX.

    python -m pytest tests/test_torch_obstructedmaze_reference.py -q
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core.state import empty_grid
from minigrid_tpu_torch.envs import obstructedmaze as OMP
from minigrid_tpu_torch.utils import trace
from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import run as R  # noqa: E402
from perfbench.drivers.vector_random import Driver  # noqa: E402
from perfbench.harness import state as S  # noqa: E402
from perfbench.reference import minigrid as M  # noqa: E402
from perfbench.reference import obstructedmaze as OM  # noqa: E402
from perfbench.reference.roomgrid import Lattice  # noqa: E402
from perfbench.reference.tasks import obstructedmaze_full as T  # noqa: E402

CPU = torch.device("cpu")
CELL = "obstructedmaze-full.pooled-random"
_, _, CFG, WORKLOAD = R.load_cell(CELL)
ENV = mgt.make(CFG["env_id"], **CFG["env_kwargs"])
PARAMS = ENV.default_params
KEYS = np.stack([np.full(48, 3_000_000_019 >> 32), np.arange(48) * 7919 + 11], 1)


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


def test_levels_match_reference():
    prog = ENV.generate(torch.tensor(KEYS), PARAMS, CPU)
    assert _differing(T.generate(KEYS, CFG), S.env_levels(prog)) == []


def test_levels_hide_every_key_in_a_box():
    """Each level: eight locked doors, one key of each door's color in the
    box plane, brown balls and the blue one; in some levels a blocking ball
    was written over a box (the key stays in the plane under it).  The
    port's count of boxed keys with no cell, read through tracing, is the
    reference's: none."""
    ref = T.generate(KEYS, CFG)
    grid, box = ref["grid"], ref["box"]
    locked = (M.cell_type(grid) == M.DOOR_T) & (M.cell_state(grid) == M.LOCKED)
    assert (locked.sum((1, 2)) == 8).all()
    assert ((M.cell_type(box) == M.KEY_T).sum((1, 2)) == 8).all()
    for n in range(len(KEYS)):
        door_colors = sorted(M.cell_color(grid[n][locked[n]]).tolist())
        key_colors = sorted(M.cell_color(box[n][M.cell_type(box[n]) == M.KEY_T]).tolist())
        assert door_colors == key_colors
    balls = M.cell_type(grid) == M.BALL_T
    assert ((balls & (M.cell_color(grid) == OM.BROWN)).sum((1, 2)) == 8).all()
    assert (grid == T.TARGET).sum((1, 2)).tolist() == [1] * len(KEYS)
    under_ball = balls & (M.cell_type(box) == M.KEY_T)
    assert 0 < under_ball.any((1, 2)).sum() < len(KEYS)
    trace.reset()
    trace.enable()
    try:
        ENV.generate(torch.tensor(KEYS), PARAMS, CPU)
        missing = trace.report()["counters"]["obstructedmaze.keys_missing"]
    finally:
        trace.disable()
        trace.reset()
    assert missing == int((~T.draw(KEYS, CFG)[1]).sum()) == 0


LAT = Lattice(T.ROOM_SIZE, 3, 3)
YELLOW_KEY = int(M.pack(M.KEY_T, M.YELLOW))


def _built_level():
    """One level on the bare lattice: in side room (2, 1) a cyan box at
    (12, 8) holding a yellow key, the agent at (13, 8) facing it, the
    locked yellow door above at (12, 5); the blue ball beyond it at
    (12, 3)."""
    fields = state_to_numpy(ENV.generate(torch.tensor(KEYS[:1]), PARAMS, CPU))
    grid = LAT.lattice[None].copy()
    grid[0, 12, 8] = M.pack(M.BOX_T, OM.CYAN)
    grid[0, 12, 5] = M.pack(M.DOOR_T, M.YELLOW, M.LOCKED)
    grid[0, 12, 3] = T.TARGET
    box = np.full_like(grid, M.EMPTY)
    box[0, 12, 8] = YELLOW_KEY
    fields.update(grid=grid, box_contains=box, agent_pos=np.array([[13, 8]]),
                  agent_dir=np.array([2]))
    return state_from_numpy(fields, CPU)


L, RT, F, PICK, DROP, TOG = M.LEFT, M.RIGHT, M.FORWARD, M.PICKUP, M.DROP, M.TOGGLE
# open the box, take the key, walk round to the door, unlock it, step
# through, put the key down and pick up the ball
WALK = [TOG, PICK, RT, F, F, L, F, RT, TOG, F, F, L, DROP, RT, PICK]


def test_box_key_door_and_ball_walk_matches_reference():
    state = _built_level()
    ref = S.env_levels(state)
    for t, a in enumerate(WALK, 1):
        act = np.array([a])
        state, reward, term, trunc = ENV.step_state(state, torch.tensor(act, dtype=torch.int32),
                                                    PARAMS)
        obs = ENV.observation_batch(state, PARAMS)
        after, r_ref, t_ref, tr_ref, outcome = M.step(ref, act, PARAMS.max_steps)
        after, r_ref, t_ref = T.post_step(ref, after, act, outcome, r_ref, t_ref, CFG)
        ref = {**after, "terminated": t_ref, "truncated": tr_ref}
        assert _differing(ref, S.env_levels(state)) == [], t
        assert (M.observe(ref, PARAMS.agent_view_size) == S.to_np(obs["image"])).all(), t
        assert S.to_np(reward).view(np.int32)[0] == r_ref.view(np.int32)[0], t
        assert (S.to_np(term) == t_ref).all() and (S.to_np(trunc) == tr_ref).all(), t
        if t == 1:  # the toggle revealed the key
            assert ref["grid"][0, 12, 8] == YELLOW_KEY and ref["box"][0, 12, 8] == M.EMPTY
        if t == 9:  # the key opened the door
            assert ref["grid"][0, 12, 5] == M.pack(M.DOOR_T, M.YELLOW, M.OPEN)
    assert t_ref[0] and r_ref[0] == M.goal_reward(len(WALK), PARAMS.max_steps)


def test_pooled_walk_through_auto_resets_matches_reference():
    """48 steps of the pooled engine at B=16, episodes cut to 12 steps, a
    refill of 8 windows every 8 steps: every step's state (box planes
    included), observation, reward and flags, the ring's serves and
    refills, and the reset, held against the reference."""
    cfg = {**CFG, "env_kwargs": {**CFG["env_kwargs"], "max_steps": 12}}
    wl = {**WORKLOAD, "num_envs": 16, "pool_refill": 2, "refill_every": 8,
          "warmup_blocks": 0, "sample_cap": 6}
    drv = Driver(cfg, wl, 2**31 + 77, CPU)
    drv.setup()
    for _ in range(6):
        drv.block(sample=True)
    counts = drv.check()
    checks = counts.result()
    assert R.C.correct(checks), checks
    assert checks["compared"]["value"] == 48 * 16 and counts.failures() == 0


def test_dropped_box_contents_are_caught(monkeypatch):
    """The control: a generator that leaves its box plane empty differs
    from the reference in every level."""
    finish = OMP.ObstructedMazeEnv.finish

    def dropped(self, b, keys):
        n = keys.shape[0]
        return finish(self, {**b, "box_contains": empty_grid(PARAMS.width, PARAMS.height,
                                                             keys.device, (n,))}, keys)

    monkeypatch.setattr(OMP.ObstructedMazeEnv, "finish", dropped)
    prog = S.env_levels(ENV.generate(torch.tensor(KEYS), PARAMS, CPU))
    assert _differing(T.generate(KEYS, CFG), prog) == ["box"]
    assert S.rows_differ(T.generate(KEYS, CFG)["box"], prog["box"]).all()
