"""Wrapped envs through the port's batch engine against the JAX package's,
in lockstep through the auto-resets.

* ``ActionBonus`` over DoorKey-5x5, B=16, fused: the count table
  ``int32[B, W, H, 4, 8]`` and every observation and end flag bitwise, the
  bonus reward within ``REWARD_ULP`` (XLA lowers ``1 / sqrt(n)`` to its own
  ``rsqrt``, which differs from torch's ``1 / sqrt`` by up to 2 ulp);
* ``StateBonus`` over MultiRoom-N2-S4, B=64, pooled with the best-effort
  consume: the ring of ``BonusState`` carries the counts;
* ``RGBImgPartialObsWrapper`` over Empty-8x8, B=8, channels first: the
  batched render every step.

Both engines start from the port's reset (its generators are held against
JAX's elsewhere); each episode lasts 9 steps, so every env restarts at least
twice in 24 steps.  A JAX step is compiled at the default options.
"""

from __future__ import annotations

import numpy as np
import torch

import jax.numpy as jnp

import minigrid_tpu
import minigrid_tpu.wrappers as JW
from minigrid_tpu.parallel.vector import PooledState as JPooledState
from minigrid_tpu.parallel.vector import VectorEnv as JVectorEnv

import minigrid_tpu_torch
import minigrid_tpu_torch.wrappers as W
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.parallel.vector import PooledState, VectorEnv
from minigrid_tpu_torch.utils.convert import state_to_numpy

from tests.test_torch_bridge import assert_state_equal
from tests.test_torch_wrappers import assert_obs_equal
from tests.test_torch_zoo_step import _jax_state
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CPU = torch.device("cpu")
REWARD_ULP = 2
STEPS, MAX_STEPS = 24, 9


def to_jax(fields: dict):
    """numpy fields of the port's state -> the JAX state: a ``BonusState``,
    an ``EnvState``, or a ``PooledState`` ring of either."""
    if "envs" in fields:
        rest = {k: jnp.asarray(v) for k, v in fields.items() if k not in ("envs", "pool")}
        return JPooledState(envs=to_jax(fields["envs"]), pool=to_jax(fields["pool"]),
                            **rest)
    if "inner" in fields:
        return JW.BonusState(inner=_jax_state(fields["inner"]),
                             counts=jnp.asarray(fields["counts"]))
    return _jax_state(fields)


def assert_reward_close(got: torch.Tensor, want, where: str) -> int:
    """float32 rewards within REWARD_ULP; returns how many differ at all."""
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype == np.float32, where
    diff = np.abs(g.view(np.int32).astype(np.int64) - w.view(np.int32).astype(np.int64))
    assert diff.max() <= REWARD_ULP, (where, diff.max(), g, w)
    return int((diff > 0).sum())


def run_lockstep(wrap, env_id: str, num_envs: int, seed: int):
    """``wrap(module, env)`` in both packages, B envs for STEPS steps of
    the same random actions; returns (port venv, final port state,
    rewards [T, B], episode ends, rewards off by an ulp or two)."""
    jvenv = JVectorEnv(wrap(JW, minigrid_tpu.make(env_id, max_steps=MAX_STEPS)),
                       num_envs)
    venv = VectorEnv(wrap(W, minigrid_tpu_torch.make(env_id, max_steps=MAX_STEPS)),
                     num_envs, device=CPU)
    assert (venv.reset_strategy, venv.pool_refill) == (jvenv.reset_strategy,
                                                        jvenv.pool_refill)
    _, st = venv.reset(rng.PRNGKey(seed, CPU))
    jst = to_jax(state_to_numpy(st))
    r = np.random.default_rng(seed)
    rewards, ends, inexact = [], 0, 0
    for t in range(STEPS):
        a = r.integers(0, 7, num_envs).astype(np.int32)
        jo, jst, jr, jte, jtr, _ = jvenv.step(jst, jnp.asarray(a))
        o, st, rew, te, tr, _ = venv.step(st, torch.from_numpy(a))
        assert_obs_equal(o, jo, f"step {t}: ")
        inexact += assert_reward_close(rew, jr, f"step {t}: ")
        np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
        rewards.append(rew.numpy())
        ends += int((te | tr).sum())
    assert_state_equal(st, jst, "final: ")
    assert ends >= 2 * num_envs, ends
    return venv, st, np.stack(rewards), ends, inexact


def test_action_bonus_fused_lockstep_matches_jax():
    venv, st, rewards, _, _ = run_lockstep(lambda M, e: M.ActionBonus(e),
                                           "MiniGrid-DoorKey-5x5-v0", 16, 21)
    assert venv.reset_strategy == "fused"
    assert isinstance(st, W.BonusState) and st.counts.shape == (16, 5, 5, 4, 8)
    assert st.counts.dtype == torch.int32
    # the counts of one episode: one per step since its reset
    assert torch.equal(st.counts.sum(dim=(1, 2, 3, 4)), st.inner.step_count)
    # every step pays its bonus: at least 1/sqrt(step count) > 0
    assert (rewards > 0).all()
    assert (rewards < 1).any()  # a repeated (cell, direction, action)


def test_state_bonus_pooled_ring_lockstep_matches_jax():
    venv, st, _, ends, _ = run_lockstep(lambda M, e: M.StateBonus(e),
                                        "MiniGrid-MultiRoom-N2-S4-v0", 64, 22)
    assert (venv.reset_strategy, venv.best_effort, venv.best_effort_refill) == (
        "pooled", True, False)
    assert isinstance(st, PooledState)
    assert isinstance(st.envs, W.BonusState) and isinstance(st.pool, W.BonusState)
    assert st.pool.counts.shape == (128, 25, 25)
    # the ring serves levels with their counts zeroed
    assert int(st.pool.counts.sum()) == 0
    n_fresh, n_stale = int(st.n_fresh), int(st.n_stale)
    assert n_fresh + n_stale == ends and n_fresh > 0


def test_rgb_partial_lockstep_matches_jax():
    venv, st, _, _, _ = run_lockstep(
        lambda M, e: M.RGBImgPartialObsWrapper(e, channels_first=True),
        "MiniGrid-Empty-8x8-v0", 8, 23)
    assert venv.reset_strategy == "fused"
    obs = venv.step(st, torch.zeros(8, dtype=torch.int32))[0]
    assert tuple(obs["image"].shape) == (8, 3, 56, 56) and obs["image"].is_contiguous()
