"""The port's DoorKey generator and batch engine against the JAX package.

Levels are bitwise ``jax.vmap(DoorKeyEnv.generate)`` for the same keys, and
a pooled and a fused ``VectorEnv`` rollout agree with JAX's step by step
(obs, reward, terminated, truncated) and in the final state, the pooled
ring's bookkeeping included.  The pooled rollout is the program of
``minigrid_tpu_torch.tools.bench`` (and of the root ``bench.py``) at a small
size, with episodes short enough that envs finish, consume fresh levels and
fall back to stale replays.
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
from minigrid_tpu_torch.core.state import EnvParams
from minigrid_tpu_torch.envs import DoorKeyEnv
from minigrid_tpu_torch.parallel.vector import PooledState
from minigrid_tpu_torch.tools import bench

from tests.test_torch_bridge import assert_state_equal, jax_to_numpy

CPU = torch.device("cpu")
ENV_ID = "MiniGrid-DoorKey-8x8-v0"


def _assert_obs_equal(got: dict, want: dict, where: str) -> None:
    assert set(got) == set(want), where
    for k in got:
        g, w = got[k].cpu().numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype, where + k
        np.testing.assert_array_equal(g, w, err_msg=where + k)


def _assert_step_equal(got, want, where: str) -> None:
    """(obs, reward, terminated, truncated) of one step."""
    _assert_obs_equal(got[0], want[0], where)
    for name, g, w in zip(("reward", "terminated", "truncated"), got[1:], want[1:]):
        np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w),
                                      err_msg=where + name)


@pytest.mark.parametrize("size", [5, 6, 8, 16])
def test_doorkey_generate_matches_jax(size):
    jenv = minigrid_tpu.make(f"MiniGrid-DoorKey-{size}x{size}-v0")
    jkeys = jax.random.split(jax.random.PRNGKey(size), 64)
    want = jax.vmap(lambda k: jenv.generate(k, jenv.default_params))(jkeys)
    env = minigrid_tpu_torch.make(f"MiniGrid-DoorKey-{size}x{size}-v0")
    keys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    got = env.generate(keys, env.default_params, device="cpu")
    assert got.box_contains is None and got.carrying_contains is None
    assert_state_equal(got, want)


def test_env_reset_and_step_match_jax():
    """Env.reset / Env.step / task_reward on a batch == their vmapped JAX
    counterparts."""
    jenv = minigrid_tpu.make(ENV_ID, max_steps=9)
    jp = jenv.default_params
    jkeys = jax.random.split(jax.random.PRNGKey(3), 16)
    jobs, jst = jax.vmap(lambda k: jenv.reset(k, jp))(jkeys)
    env = minigrid_tpu_torch.make(ENV_ID, max_steps=9)
    p = env.default_params
    obs, st = env.reset(torch.from_numpy(np.asarray(jkeys).astype(np.int64)), p,
                        device="cpu")
    _assert_obs_equal(obs, jobs, "reset: ")
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, jp)))
    r = np.random.default_rng(0)
    for t in range(10):
        a = r.integers(0, 8, 16).astype(np.int32)
        jo, jst, jr, jte, jtr, _ = jstep(jst, jnp.asarray(a))
        o, st, rew, te, tr, info = env.step(st, torch.from_numpy(a), p)
        assert info == {}
        _assert_step_equal((o, rew, te, tr), (jo, jr, jte, jtr), f"step {t}: ")
        assert_state_equal(st, jst, f"step {t}: ")
    want = jax.jit(jax.vmap(lambda s: jenv.task_reward(s, jp)))(jst)
    np.testing.assert_array_equal(env.task_reward(st, p).numpy(), np.asarray(want))


def _jax_bench_rollout(jvenv, key, num_steps: int, period: int):
    """The root bench.py program, step by step: returns the per-step
    (obs, reward, terminated, truncated), the actions and the final state."""
    key, k_reset = jax.random.split(key)
    _, state = jvenv.reset(k_reset)
    keys = jax.random.split(key, num_steps).reshape(num_steps // period, period, -1)
    steps, actions = [], []
    for block in keys:
        for k in block:
            a = jax.random.randint(k, (jvenv.num_envs,), 0, 8, dtype=jnp.int32)
            obs, state, r, te, tr, _ = jvenv.step_nofill(state, a)
            steps.append((obs, r, te, tr))
            actions.append(a)
        state = jvenv.refill(state, period)
    return steps, actions, state


@pytest.mark.parametrize("max_steps", [12, 3])
def test_pooled_rollout_matches_jax(max_steps):
    """DoorKey-8x8, B=16, pool_refill=4: 32 step_nofill steps with refill(4)
    every 4 steps, through the port's bench loop.  At max_steps=12 every
    served level is fresh; at 3 envs finish faster than the ring refills and
    replay stale levels."""
    b, num_steps, period = 16, 32, 4
    jenv = minigrid_tpu.make(ENV_ID, max_steps=max_steps)
    jvenv = JVectorEnv(jenv, b, reset_strategy="pooled", pool_refill=4)
    want_steps, want_actions, want_state = _jax_bench_rollout(
        jvenv, jax.random.PRNGKey(0), num_steps, period)

    venv = minigrid_tpu_torch.make_vec(ENV_ID, b, reset_strategy="pooled",
                                       pool_refill=4, device="cpu",
                                       max_steps=max_steps)
    got_steps = []
    acc, state = bench.run(venv, rng.PRNGKey(0, CPU), num_steps, period,
                           on_step=lambda *out: got_steps.append(out))
    assert len(got_steps) == num_steps
    for t, (g, w) in enumerate(zip(got_steps, want_steps)):
        _assert_step_equal(g, w, f"step {t}: ")
    assert isinstance(state, PooledState)
    assert_state_equal(state, want_state, "final: ")
    n_fresh, n_stale = int(state.n_fresh), int(state.n_stale)
    assert n_fresh > 0 and (n_stale > 0) == (max_steps == 3), (n_fresh, n_stale)
    assert acc.dtype == torch.float32 and torch.isfinite(acc)
    # the actions are the twin's draws
    key = rng.split(rng.PRNGKey(0, CPU))[0]
    keys = rng.split(key, num_steps)
    for t in (0, num_steps - 1):
        np.testing.assert_array_equal(
            rng.randint(keys[t], (b,), 0, 8).numpy(), np.asarray(want_actions[t]))


def test_pooled_step_with_per_step_refill_matches_jax():
    """VectorEnv.step (consume + a one-window refill every step)."""
    b = 8
    jenv = minigrid_tpu.make("MiniGrid-DoorKey-5x5-v0", max_steps=5)
    jvenv = JVectorEnv(jenv, b, reset_strategy="pooled", pool_refill=4)
    venv = minigrid_tpu_torch.make_vec("MiniGrid-DoorKey-5x5-v0", b,
                                       reset_strategy="pooled", pool_refill=4,
                                       device="cpu", max_steps=5)
    jobs, jst = jvenv.reset(jax.random.PRNGKey(1))
    obs, st = venv.reset(rng.PRNGKey(1, CPU))
    _assert_obs_equal(obs, jobs, "reset: ")
    r = np.random.default_rng(1)
    for t in range(12):
        a = r.integers(0, 8, b).astype(np.int32)
        jo, jst, jr, jte, jtr, _ = jvenv.step(jst, jnp.asarray(a))
        o, st, rew, te, tr, _ = venv.step(st, torch.from_numpy(a))
        _assert_step_equal((o, rew, te, tr), (jo, jr, jte, jtr), f"step {t}: ")
    assert_state_equal(st, jst, "final: ")


def test_fused_rollout_matches_jax():
    """The default strategy: every finished env regenerates from its own
    stream."""
    b, num_steps = 16, 32
    jenv = minigrid_tpu.make(ENV_ID, max_steps=12)
    jvenv = JVectorEnv(jenv, b)
    assert jvenv.reset_strategy == "fused"
    venv = minigrid_tpu_torch.make_vec(ENV_ID, b, device="cpu", max_steps=12)
    assert venv.reset_strategy == "fused"
    jobs, jst = jvenv.reset(jax.random.PRNGKey(5))
    obs, st = venv.reset(rng.PRNGKey(5, CPU))
    _assert_obs_equal(obs, jobs, "reset: ")
    keys = jax.random.split(jax.random.PRNGKey(6), num_steps)
    ends = 0
    for t in range(num_steps):
        ja = jax.random.randint(keys[t], (b,), 0, 8, dtype=jnp.int32)
        a = rng.randint(torch.from_numpy(np.asarray(keys[t]).astype(np.int64)),
                        (b,), 0, 8)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        jo, jst, jr, jte, jtr, _ = jvenv.step(jst, ja)
        o, st, rew, te, tr, _ = venv.step(st, a)
        _assert_step_equal((o, rew, te, tr), (jo, jr, jte, jtr), f"step {t}: ")
        ends += int(np.asarray(jte | jtr).sum())
    assert_state_equal(st, jst, "final: ")
    assert ends >= b


def test_refill_offset_is_block_aligned():
    """Mixing one-window refills with a bulk refill(K): the K-window block
    lands at a block-aligned ring offset and never runs past the ring end
    (the clamp the JAX package's offset quantization prevents)."""
    b, c = 8, 2  # ring of 16 slots, 2-slot windows
    venv = minigrid_tpu_torch.make_vec("MiniGrid-DoorKey-5x5-v0", b,
                                       reset_strategy="pooled", pool_refill=c,
                                       device="cpu")
    _, st = venv.reset(rng.PRNGKey(2, CPU))
    st = st.replace(fresh=torch.zeros_like(st.fresh))
    st = venv.refill(st, 1)  # tick 0 -> slots [0, 2)
    st = venv.refill(st, 1)  # tick 1 -> slots [2, 4)
    st = venv.refill(st, 1)  # tick 2 -> slots [4, 6)
    st = st.replace(fresh=torch.zeros_like(st.fresh))
    st = venv.refill(st, 4)  # tick 3: raw offset 6, aligned to 8 -> [0, 8)
    np.testing.assert_array_equal(st.fresh.nonzero().flatten().numpy(), np.arange(8))
    assert int(st.tick) == 7
    with pytest.raises(ValueError):
        venv.refill(st, 3)  # 6 slots do not tile a ring of 16


def test_state_bridge_round_trips_a_pooled_state():
    """state_from_numpy builds a PooledState from a JAX one."""
    from minigrid_tpu_torch.utils.convert import state_from_numpy

    jvenv = JVectorEnv(minigrid_tpu.make("MiniGrid-DoorKey-5x5-v0"), 4,
                       reset_strategy="pooled", pool_refill=2)
    _, jst = jvenv.reset(jax.random.PRNGKey(0))
    st = state_from_numpy(jax_to_numpy(jst), CPU)
    assert isinstance(st, PooledState) and st.pool.grid.shape == (8, 5, 5)
    assert_state_equal(st, jst)


def test_registry_and_params():
    assert minigrid_tpu_torch.registered_ids() == sorted(
        f"MiniGrid-DoorKey-{s}x{s}-v0" for s in (5, 6, 8, 16))
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-6x6-v0")
    assert isinstance(env, DoorKeyEnv)
    assert env.default_params == EnvParams(width=6, height=6, max_steps=360)
    with pytest.raises(KeyError):
        minigrid_tpu_torch.make("MiniGrid-Empty-5x5-v0")
    with pytest.raises(NotImplementedError):
        minigrid_tpu_torch.make_vec(ENV_ID, 4, reset_strategy="conditional",
                                    device="cpu")
    with pytest.raises(ValueError):
        minigrid_tpu_torch.make_vec(ENV_ID, 4, reset_strategy="pooled",
                                    pool_refill=3, device="cpu")
