"""The zoo's transitions through the port's batch engine against the JAX
package's, in lockstep.

For each family, B=32 envs with a small ``max_steps`` run 24 steps of the
same random actions through the JAX ``VectorEnv`` (jitted) and the port's,
each with the reset strategy it picks by default, so that envs finish and
auto-reset through their own generators several times.  Every step's
observation, reward (as float32 bits), terminated and truncated agree, and
so does the final state, ``extra`` and the pooled ring included.  Rewards
are held against the jitted JAX step because XLA rounds the task reward as
one fused multiply-add, as the port does.

Both engines start from the port's reset: its generator is held against
JAX's in ``test_torch_zoo_generate.py`` and its key split in
``test_torch_vector.py``, so a JAX reset would only compile the generator
once more.

Compiling the JAX programs is most of the time these tests take.  A reset
returns only integers, which XLA's optimization level cannot change, so a
JAX reset is compiled at level 0, in about half the time.  A step is
compiled at the default level: its reward's rounding depends on which
multiplies and subtracts XLA contracts, in context.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu
from minigrid_tpu.parallel.vector import VectorEnv as JVectorEnv

import minigrid_tpu_torch
from minigrid_tpu_torch.core import rng

from minigrid_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

from tests.test_torch_bridge import assert_state_equal
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CPU = torch.device("cpu")

# one id per family, with a max_steps that ends episodes within 24 steps
LOCKSTEP = {
    "MiniGrid-LavaGapS5-v0": 9,
    "MiniGrid-DistShift1-v0": 9,
    "MiniGrid-FourRooms-v0": 9,
    "MiniGrid-RedBlueDoors-6x6-v0": 11,
    "MiniGrid-MemoryS7-v0": 9,
    "MiniGrid-Fetch-5x5-N2-v0": 11,
    "MiniGrid-GoToDoor-5x5-v0": 11,
    "MiniGrid-GoToObject-6x6-N2-v0": 11,
    "MiniGrid-PutNear-6x6-N2-v0": 11,
    "MiniGrid-LavaCrossingS9N2-v0": 9,
    "MiniGrid-Dynamic-Obstacles-6x6-v0": 9,
    "MiniGrid-MultiRoom-N2-S4-v0": 9,
}
B, STEPS = 32, 24
INTEGER_ONLY = {"xla_backend_optimization_level": 0}
OBJECTS = [minigrid_tpu_torch.core.constants.OBJECT_TO_IDX[t]
           for t in ("key", "ball", "box")]


def assert_obs_equal(got: dict, want: dict, where: str) -> None:
    assert set(got) == set(want), where
    for k in got:
        g, w = got[k].cpu().numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype, where + k
        np.testing.assert_array_equal(g, w, err_msg=where + k)


def assert_step_equal(got, want, where: str) -> None:
    """(obs, reward, terminated, truncated); the reward as float32 bits."""
    assert_obs_equal(got[0], want[0], where)
    g_r, w_r = got[1].cpu().numpy(), np.asarray(want[1])
    assert g_r.dtype == w_r.dtype == np.float32, where
    np.testing.assert_array_equal(g_r.view(np.int32), w_r.view(np.int32),
                                  err_msg=where + "reward bits")
    for name, g, w in zip(("terminated", "truncated"), got[2:], want[2:]):
        np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w),
                                      err_msg=where + name)


def lockstep(jvenv, venv, seed: int, steps: int, num_actions: int = 8,
             jax_reset: bool = True, to_jax=None, watch=None):
    """Reset and step both engines with the same numpy actions; returns the
    per-step (rewards, episode ends) and both final states.  Without
    ``jax_reset`` the JAX engine starts from the port's reset state (an
    ``EnvState`` batch), made a JAX state by ``to_jax`` (numpy fields ->
    JAX state; :func:`_jax_state` by default).  ``watch(t, state, out)``
    sees each step's port state before the step and the step's
    (obs, state, reward, terminated, truncated, info)."""
    obs, st = venv.reset(rng.PRNGKey(seed, CPU))
    if jax_reset:
        key = jax.random.PRNGKey(seed)
        jobs, jst = jax.jit(jvenv.reset).lower(key).compile(INTEGER_ONLY)(key)
        assert_obs_equal(obs, jobs, "reset: ")
    else:
        jst = (to_jax or _jax_state)(state_to_numpy(st))
    r = np.random.default_rng(seed)
    rewards, ends = [], 0
    for t in range(steps):
        a = r.integers(0, num_actions, venv.num_envs).astype(np.int32)
        jo, jst, jr, jte, jtr, jinfo = jvenv.step(jst, jnp.asarray(a))
        out = venv.step(st, torch.from_numpy(a))
        if watch is not None:
            watch(t, st, out)
        o, st, rew, te, tr, info = out
        assert_step_equal((o, rew, te, tr), (jo, jr, jte, jtr), f"step {t}: ")
        assert set(info) == set(jinfo)
        if "final_obs" in info:
            assert_obs_equal(info["final_obs"], jinfo["final_obs"], f"step {t} final: ")
        rewards.append(np.asarray(jr))
        ends += int(np.asarray(jte | jtr).sum())
    return np.stack(rewards), ends, st, jst


@pytest.mark.parametrize("env_id", list(LOCKSTEP))
def test_family_lockstep_matches_jax(env_id):
    max_steps = LOCKSTEP[env_id]
    jvenv = JVectorEnv(minigrid_tpu.make(env_id, max_steps=max_steps), B)
    venv = minigrid_tpu_torch.make_vec(env_id, B, device="cpu", max_steps=max_steps)
    assert venv.reset_strategy == jvenv.reset_strategy
    rewards, ends, st, jst = lockstep(jvenv, venv, len(env_id), STEPS,
                                      jax_reset=False)
    assert_state_equal(st, jst, "final: ")
    # every env auto-resets at least once through its own generator
    assert ends >= B, ends
    if "Dynamic" in env_id:
        assert (rewards == -1).any()  # collisions
    if any(f in env_id for f in ("Fetch", "GoToDoor", "GoToObject")):
        assert (rewards > 0).any()  # the task reward of post_step


def _jax_state(fields: dict):
    """numpy fields (the JAX package's dtypes) -> a JAX EnvState batch."""
    from minigrid_tpu.core.state import EnvState as JEnvState

    return JEnvState(**{"box_contains": None, "carrying_contains": None,
                        **jax.tree_util.tree_map(jnp.asarray, fields)})


def _levels(env, seed: int, n: int) -> dict:
    """n levels of the port's generator (bitwise the JAX one's, see
    test_torch_zoo_generate.py) as numpy fields."""
    keys = rng.split(rng.PRNGKey(seed, CPU), n)
    return state_to_numpy(env.generate(keys, env.default_params, device="cpu"))


def _teleport(fields: dict, pos: np.ndarray, direction) -> dict:
    return {**fields, "agent_pos": pos.astype(np.int32),
            "agent_dir": np.broadcast_to(np.int32(direction), pos.shape[:1]).copy()}


def _step_both(env, jstep, fields: dict, action: int, where: str):
    """One step of the port's Env and the jitted JAX one from the same
    numpy state; returns the next state's fields and the reward."""
    n = fields["agent_dir"].shape[0]
    a = np.full(n, action, np.int32)
    jout = jstep(_jax_state(fields), jnp.asarray(a))
    out = env.step(state_from_numpy(fields, CPU), torch.from_numpy(a),
                   env.default_params)
    assert_step_equal((out[0], out[2], out[3], out[4]),
                      (jout[0], jout[2], jout[3], jout[4]), where)
    assert_state_equal(out[1], jout[1], where)
    return state_to_numpy(out[1]), np.asarray(jout[2]), np.asarray(jout[3])


def test_redbluedoors_order_matches_jax():
    """Red then blue pays; blue first fails; the FSM reads the doors in
    ``extra`` before and after the step."""
    env_id = "MiniGrid-RedBlueDoors-6x6-v0"
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    jp = jenv.default_params
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, jp)))
    start = _levels(env, 4, 8)
    red, blue = start["extra"]["red_pos"], start["extra"]["blue_pos"]
    # red, then blue: success
    f = _teleport(start, red + [1, 0], 2)
    f, r, te = _step_both(env, jstep, f, 5, "toggle red: ")
    assert (r == 0).all() and not te.any()
    f, r, te = _step_both(env, jstep, _teleport(f, blue - [1, 0], 0), 5, "toggle blue: ")
    assert (r > 0).all() and te.all()
    # blue first: failure, no reward
    f, r, te = _step_both(env, jstep, _teleport(start, blue - [1, 0], 0), 5, "blue first: ")
    assert (r == 0).all() and te.all()


def test_memory_and_putnear_task_paths_match_jax():
    """Memory: stepping onto the success or the failure cell ends the
    episode, paying only the first; PutNear: picking up the wrong object
    ends it, and a drop beside the target pays."""
    env_id = "MiniGrid-MemoryS7-v0"
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    jp = jenv.default_params
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, jp)))
    start = _levels(env, 5, 8)
    for name, paid in (("success_pos", True), ("failure_pos", False)):
        cell = start["extra"][name]
        mid = env.height // 2
        f = _teleport(start, np.stack([cell[:, 0], np.full(8, mid)], 1),
                      np.where(cell[:, 1] < mid, 3, 1))
        _, r, te = _step_both(env, jstep, f, 2, name + ": ")
        assert te.all() and ((r > 0).all() if paid else (r == 0).all())

    env_id = "MiniGrid-PutNear-6x6-N2-v0"
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    jp = jenv.default_params
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, jp)))
    start = _levels(env, 6, 32)
    # face each object from the west (where that cell is free) and pick up:
    # the move object is carried, any other ends the episode
    grid = start["grid"]
    obj = np.zeros((32, 2), np.int64)
    for b in range(32):
        xs, ys = np.nonzero(np.isin(grid[b] & 0xFF, OBJECTS))
        obj[b] = xs[0], ys[0]
    f, r, te = _step_both(env, jstep, _teleport(start, obj - [1, 0], 0), 3, "pickup: ")
    carried = f["carrying"][:, 0] != 1
    assert carried.any() and te.any()
    # drop every carried object just beside the target
    tpos = f["extra"]["target_pos"]
    f, r, te = _step_both(env, jstep, _teleport(f, tpos + [0, 1], 3), 4, "drop: ")
    assert (r > 0).any()


