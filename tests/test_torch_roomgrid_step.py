"""The multi-room families' transitions through the port's batch engine
against the JAX package's, in lockstep, and their task paths.

One id per family, B=32 envs with ``max_steps`` 8, runs 24 steps of the same
random actions through the jitted JAX ``VectorEnv`` and the port's, each with
the reset strategy it picks (conditional for the RoomGrid families below 64
envs, fused for LockedRoom and Playground), so every env auto-resets through
its generator at least twice.  Every step's observation, reward (float32
bits), terminated and truncated agree, and so does the final state.  One more
case runs Unlock at B=64, where it goes pooled with the RoomGrid refill
window, so the ring is consumed and refilled.

The task paths start from the port's levels (bitwise JAX's, see
``tests/test_torch_roomgrid_zoo.py``) with the agent teleported: Unlock's
door toggled without and then with its key, KeyCorridor's and UnlockPickup's
target picked up, ObstructedMaze's key box toggled open.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax

import minigrid_tpu
from minigrid_tpu.parallel.vector import VectorEnv as JVectorEnv

import minigrid_tpu_torch
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.parallel.vector import PooledState

from tests.test_torch_bridge import assert_state_equal
from tests.test_torch_zoo_step import _levels, _step_both, _teleport, lockstep
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

LOCKSTEP = ["MiniGrid-Unlock-v0", "MiniGrid-UnlockPickup-v0",
            "MiniGrid-BlockedUnlockPickup-v0", "MiniGrid-KeyCorridorS4R3-v0",
            "MiniGrid-ObstructedMaze-2Dlhb-v0", "MiniGrid-LockedRoom-v0",
            "MiniGrid-Playground-v0"]
B, STEPS, MAX_STEPS = 32, 24, 8
_KEY = C.OBJECT_TO_IDX["key"]
_BOX = C.OBJECT_TO_IDX["box"]
_CYAN = C.COLOR_TO_IDX["cyan"]
_TOGGLE, _PICKUP = 5, 3


@pytest.mark.parametrize("env_id", LOCKSTEP)
def test_family_lockstep_matches_jax(env_id):
    jvenv = JVectorEnv(minigrid_tpu.make(env_id, max_steps=MAX_STEPS), B)
    venv = minigrid_tpu_torch.make_vec(env_id, B, device="cpu", max_steps=MAX_STEPS)
    assert venv.reset_strategy == jvenv.reset_strategy
    assert venv.reset_strategy == ("fused" if env_id in LOCKSTEP[-2:] else "conditional")
    _, ends, st, jst = lockstep(jvenv, venv, len(env_id), STEPS, jax_reset=False)
    assert_state_equal(st, jst, "final: ")
    assert ends >= 2 * B, ends


def test_unlock_pooled_lockstep_matches_jax():
    """B=64: pooled, a 16-level refill window a step (the family's B/64
    against the floor of 16), 24 steps of 8-step episodes."""
    env_id, b = "MiniGrid-Unlock-v0", 64
    jvenv = JVectorEnv(minigrid_tpu.make(env_id, max_steps=MAX_STEPS), b)
    venv = minigrid_tpu_torch.make_vec(env_id, b, device="cpu", max_steps=MAX_STEPS)
    assert (venv.reset_strategy, venv.pool_refill) == ("pooled", 16)
    assert (jvenv.reset_strategy, jvenv.pool_refill) == ("pooled", 16)
    _, ends, st, jst = lockstep(jvenv, venv, 3, STEPS)
    assert isinstance(st, PooledState)
    assert_state_equal(st, jst, "final: ")
    n_fresh, n_stale = int(st.n_fresh), int(st.n_stale)
    assert n_fresh + n_stale == ends >= 2 * b and n_fresh > 0


def _jstep(env_id: str):
    jenv = minigrid_tpu.make(env_id)
    jp = jenv.default_params
    return jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, jp)))


def _find(grid: np.ndarray, type_id, color) -> np.ndarray:
    """int[B, 2]: the first cell of each grid holding (type, color); each an
    int or one per grid."""
    type_id, color = (np.broadcast_to(v, grid.shape[:1]) for v in (type_id, color))
    out = np.zeros((grid.shape[0], 2), np.int64)
    for b in range(grid.shape[0]):
        xs, ys = np.nonzero(((grid[b] & 0xFF) == type_id[b])
                            & (((grid[b] >> 8) & 0xFF) == color[b]))
        out[b] = xs[0], ys[0]
    return out


def test_unlock_task_path_matches_jax():
    """Facing the locked door: a toggle without the key leaves it locked and
    pays nothing; a toggle with the key opens it, which is the task."""
    env_id = "MiniGrid-Unlock-v0"
    env, jstep = minigrid_tpu_torch.make(env_id), _jstep(env_id)
    start = _levels(env, 4, 8)
    door = start["extra"]
    f = _teleport(start, door - [1, 0], 0)
    f, r, te = _step_both(env, jstep, f, _TOGGLE, "toggle without key: ")
    assert (r == 0).all() and not te.any()
    color = (f["grid"][np.arange(8), door[:, 0], door[:, 1]] >> 8) & 0xFF
    f["carrying"] = np.stack([np.full(8, _KEY), color, np.zeros(8)], 1).astype(np.uint8)
    f, r, te = _step_both(env, jstep, f, _TOGGLE, "toggle with key: ")
    assert (r > 0).all() and te.all()


@pytest.mark.parametrize("env_id", ["MiniGrid-KeyCorridorS4R3-v0",
                                    "MiniGrid-UnlockPickup-v0"])
def test_pickup_task_path_matches_jax(env_id):
    """Facing the target from the west, a pickup carries it and pays."""
    env, jstep = minigrid_tpu_torch.make(env_id), _jstep(env_id)
    start = _levels(env, 5, 8)
    target = _find(start["grid"], start["extra"][:, 0], start["extra"][:, 1])
    f, r, te = _step_both(env, jstep, _teleport(start, target - [1, 0], 0), _PICKUP,
                          "pickup: ")
    assert (r > 0).all() and te.all()
    np.testing.assert_array_equal(f["carrying"][:, :2], start["extra"])


def test_obstructedmaze_box_reveals_its_key_matches_jax():
    """Toggling a cyan key box puts its key in the box's cell and empties the
    contents plane there; the key is then picked up."""
    env_id = "MiniGrid-ObstructedMaze-2Dlhb-v0"
    env, jstep = minigrid_tpu_torch.make(env_id), _jstep(env_id)
    start = _levels(env, 6, 8)
    box = _find(start["grid"], _BOX, _CYAN)
    rows = np.arange(8)
    hidden = start["box_contains"][rows, box[:, 0], box[:, 1]]
    assert ((hidden & 0xFF) == _KEY).all()
    f, r, te = _step_both(env, jstep, _teleport(start, box - [1, 0], 0), _TOGGLE,
                          "toggle box: ")
    np.testing.assert_array_equal(f["grid"][rows, box[:, 0], box[:, 1]], hidden)
    assert (f["box_contains"][rows, box[:, 0], box[:, 1]] == 1).all()
    f, r, te = _step_both(env, jstep, f, _PICKUP, "pickup key: ")
    assert (f["carrying"][:, 0] == _KEY).all() and not te.any()


def test_bench_loop_takes_a_multiroom_id():
    """``tools/bench.py --env ID`` times any registered id through
    ``measure_steps``: here KeyCorridorS3R1 (7x3, narrower than the view)
    pooled at B=64, on the CPU, with short episodes so the ring serves."""
    from minigrid_tpu_torch.tools import bench

    venv = minigrid_tpu_torch.make_vec("MiniGrid-KeyCorridorS3R1-v0", 64,
                                       device="cpu", max_steps=4)
    out = bench.measure_steps(venv, 8, reps=1)
    assert (out["strategy"], out["pool_refill"], out["num_envs"]) == ("pooled", 16, 64)
    assert out["n_fresh"] + out["n_stale"] >= 2 * 64
