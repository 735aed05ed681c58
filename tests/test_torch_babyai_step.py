"""BabyAI levels through the port's batch engine against the JAX package's,
in lockstep, through the auto-resets.

Both engines start from the port's reset (its generator is bitwise JAX's,
``tests/test_torch_babyai_generate_*.py``), and run the same random actions
through the jitted JAX ``VectorEnv`` and the port's, each with the reset
strategy it picks.  Every step's observation (the 43-int mission
included), reward (float32 bits), terminated and truncated agree, and so
does the final state, the verifier state in ``extra`` included:

* GoToObjS4, B=32, ``conditional``: a 4x4 grid (narrower than the view) and
  the dynamic per-episode ``max_steps`` (16), 48 steps;
* PickupDistDebug (PickupDist with strict clauses), B=32, ``conditional``,
  ``max_steps`` 8: picking up the wrong object fails the episode;
* GoToRedBall, B=64, ``pooled`` with its 16-level refill window and the
  best-effort refill: one unvalidated draw a slot, an invalid draw keeping
  the slot's previous level.  JAX's ``generate_attempt`` on each refill's
  keys counts the rejected draws, and there are some;
* GoToObjS4 with ``EnvParams.babyai_done_actions``: episodes end only
  through the ``done`` action.

A step is compiled at the JAX package's default options: its reward's
rounding depends on which multiply-adds XLA contracts in that program.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

import minigrid_tpu
from minigrid_tpu.babyai import verifier as JV
from minigrid_tpu.core.state import EnvState as JEnvState
from minigrid_tpu.parallel.vector import PooledState as JPooledState
from minigrid_tpu.parallel.vector import VectorEnv as JVectorEnv

import minigrid_tpu_torch
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.parallel.vector import PooledState

from tests.test_torch_babyai_generate_goto import INTEGER_PROGRAM
from tests.test_torch_bridge import assert_state_equal
from tests.test_torch_zoo_step import lockstep
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)


def babyai_jax_state(fields: dict):
    """numpy fields (the JAX package's dtypes; ``extra`` as dicts) -> a JAX
    ``EnvState`` batch with BabyAI's instruction code and verifier state, or
    a ``PooledState`` of two such batches."""
    if "envs" in fields:
        rest = {k: jnp.asarray(v) for k, v in fields.items() if k not in ("envs", "pool")}
        return JPooledState(envs=babyai_jax_state(fields["envs"]),
                            pool=babyai_jax_state(fields["pool"]), **rest)
    extra = fields["extra"]
    out = {k: None if v is None else jnp.asarray(v) for k, v in fields.items()
           if k != "extra"}
    return JEnvState(**out, extra={
        "instr": JV.InstrCode(**{k: jnp.asarray(v) for k, v in extra["instr"].items()}),
        "vs": JV.VerifierState(**{k: jnp.asarray(v) for k, v in extra["vs"].items()})})


def run_lockstep(env_id: str, num_envs: int, steps: int, seed: int, watch=None,
                 done_actions: bool = False, **overrides):
    jenv = minigrid_tpu.make(env_id, **overrides)
    jp = dataclasses.replace(jenv.default_params, babyai_done_actions=done_actions)
    jvenv = JVectorEnv(jenv, num_envs, params=jp)
    env = minigrid_tpu_torch.make(env_id, **overrides)
    p = dataclasses.replace(env.default_params, babyai_done_actions=done_actions)
    venv = minigrid_tpu_torch.VectorEnv(env, num_envs, p, device="cpu")
    assert (venv.reset_strategy, venv.pool_refill) == (jvenv.reset_strategy,
                                                        jvenv.pool_refill)
    rewards, ends, st, jst = lockstep(jvenv, venv, seed, steps, jax_reset=False,
                                      to_jax=babyai_jax_state,
                                      watch=watch)
    assert_state_equal(st, jst, "final: ")
    return venv, rewards, ends, st


def test_gotoobjs4_dynamic_max_steps_lockstep_matches_jax():
    venv, rewards, ends, st = run_lockstep("BabyAI-GoToObjS4-v0", 32, 48, 41)
    assert venv.reset_strategy == "conditional"
    assert (venv.env.width, venv.env.height) == (4, 4)
    # every episode's own limit: one GoTo in one room of 4
    assert (st.max_steps.numpy() == 16).all()
    assert ends >= 2 * 32, ends
    assert (rewards > 0).any()  # some reached the object: the task reward


def test_pickupdist_failures_lockstep_matches_jax():
    """Strict pickups: picking up an object the instruction does not name
    ends the episode with 0."""
    failures = []

    def watch(t, state, out):
        failures.append(int((out[3] & (out[2] == 0)).sum()))

    venv, rewards, ends, st = run_lockstep("BabyAI-PickupDistDebug-v0", 32, 24, 43,
                                           watch=watch, max_steps=8)
    assert venv.reset_strategy == "conditional"
    assert bool(st.extra["instr"]["strict"][:, 0].all())
    assert ends >= 2 * 32, ends
    assert (rewards > 0).any() and sum(failures) > 0, failures


def test_gotoredball_pooled_best_effort_lockstep_matches_jax():
    """B=64 pooled: each step refills one 16-slot window of the 128-slot
    ring with ``generate_attempt``; a slot whose draw is invalid keeps its
    level and is marked fresh all the same."""
    env_id, b = "BabyAI-GoToRedBall-v0", 64
    jenv = minigrid_tpu.make(env_id)
    jp = jenv.default_params
    window = 16
    keys0 = jax.random.split(jax.random.PRNGKey(0), window)
    attempt = jax.jit(jax.vmap(lambda k: jenv.generate_attempt(k, jp)[1])).lower(
        keys0).compile(INTEGER_PROGRAM)
    rejected = []

    def watch(t, state, out):
        # the refill of this step: key, k = split(state.key); split(k, 16)
        keys = rng.split(rng.split(state.key)[1], window)
        ok = np.asarray(attempt(jnp.asarray(keys.numpy().astype(np.uint32))))
        off = int(state.tick) * window % (2 * b)
        after = out[1]
        for i in np.flatnonzero(~ok):
            slot = off + i
            assert (after.pool.grid[slot] == state.pool.grid[slot]).all()
            assert (after.pool.extra["instr"]["d1"][slot]
                    == state.pool.extra["instr"]["d1"][slot]).all()
            assert bool(after.fresh[slot])
        rejected.append(int((~ok).sum()))

    venv, rewards, ends, st = run_lockstep(env_id, b, 24, 45, watch=watch, max_steps=8)
    assert (venv.reset_strategy, venv.pool_refill) == ("pooled", window)
    assert venv.best_effort_refill
    assert isinstance(st, PooledState)
    assert sum(rejected) >= 1, rejected
    n_fresh, n_stale = int(st.n_fresh), int(st.n_stale)
    assert n_fresh + n_stale == ends >= 2 * b and n_fresh > 0


def test_done_actions_mode_lockstep_matches_jax():
    """``EnvParams.babyai_done_actions``: GoToObjS4 pays only through the
    ``done`` action taken facing the object."""
    venv, rewards, ends, st = run_lockstep("BabyAI-GoToObjS4-v0", 32, 48, 47,
                                           done_actions=True)
    assert venv.params.babyai_done_actions
    assert (rewards > 0).any() and ends >= 32


def test_bench_takes_a_babyai_id():
    """``tools/bench.py --env ID`` on a BabyAI id, here at B=64 on the CPU
    with short episodes: the rate and, beside it, the strategy, the refill
    window and the ring's fresh fraction; the same beside a profile."""
    from minigrid_tpu_torch.tools import bench

    venv = minigrid_tpu_torch.make_vec("BabyAI-GoToRedBall-v0", 64, device="cpu",
                                       max_steps=4)
    out = bench.measure_steps(venv, 8, reps=1)
    assert (out["strategy"], out["pool_refill"], out["num_envs"]) == ("pooled", 16, 64)
    assert out["n_fresh"] + out["n_stale"] >= 2 * 64 and 0 < out["fresh_frac"] <= 1
    prof = bench.profile_steps(venv, 2)
    assert (prof["strategy"], prof["pool_refill"]) == ("pooled", 16)
    assert prof["n_fresh"] > 0 and "fresh_frac" in prof
