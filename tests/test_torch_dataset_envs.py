"""The port's five dataset envs against the JAX package: Contrastive,
ContrastiveTrajectory, Negated-Simple, Directions and Blocks.

* registry: class name, preset kwargs, default params, ``num_actions`` (4
  for Directions, 1 for Blocks), reset strategy (``fused``: plain ``Env``s);
* every id's ``generate`` bitwise on 32 keys against the jitted JAX
  generator (an integer program, compiled as
  ``tests/test_torch_babyai_generate_goto.py`` compiles one), and its
  mission strings;
* the host split tables and cursors row for row, and the split read when a
  batch is generated;
* BlocksDataset's move count, a ``categorical`` over ``log(p)`` in float32:
  the drawn index on 2^20 keys;
* every id in lockstep against the jitted JAX ``VectorEnv`` through the
  auto-resets, B=32 for 24 steps: the observation, the reward bits, the
  flags and the final state, Blocks' ``step_state`` drawing from the state's
  stream and Directions' scripted turns included;
* the wrong pickup (-1) and the right one (+1) of Negated-Simple and
  ContrastiveTrajectory from teleported states, and Contrastive's ``done``
  beside its object;
* ``tools/bench.py --env`` on a dataset id.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu
from minigrid_tpu.parallel.vector import VectorEnv as JVectorEnv
from minigrid_tpu.registry import spec as jspec

import minigrid_tpu_torch
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.state import map_fields
from minigrid_tpu_torch.utils.convert import state_to_numpy

from tests.test_torch_babyai_generate_goto import jax_program
from tests.test_torch_bridge import assert_state_equal
from tests.test_torch_zoo_generate import assert_contiguous, port_keys
from tests.test_torch_zoo_step import _step_both, _teleport, lockstep
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

DATASET_IDS = ["ContrastiveDataset-v0", "ContrastiveTrajectoryDataset-v0",
               "MiniGrid-Negated-Simple-v0", "DirectionsDataset-v0", "BlocksDataset-v0"]
B, STEPS = 32, 24
# a time limit (EnvParams.max_steps) that ends the pickup tasks' episodes
# within the lockstep: a random walk seldom picks an object up
LOCKSTEP_LIMIT = {"ContrastiveTrajectoryDataset-v0": 9, "MiniGrid-Negated-Simple-v0": 9}
CPU = torch.device("cpu")


@pytest.mark.parametrize("env_id", DATASET_IDS)
def test_registry_matches_jax(env_id):
    got, want = minigrid_tpu_torch.spec(env_id), jspec(env_id)
    assert got.cls.__name__ == want.cls.__name__ and got.kwargs == want.kwargs
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    p, jp = env.default_params, jenv.default_params
    for name in ("width", "height", "max_steps", "agent_view_size", "see_through_walls"):
        assert getattr(p, name) == getattr(jp, name), name
    for attr in ("name", "num_actions", "grammar_missions", "expensive_generation",
                 "desynchronized_resets"):
        assert getattr(env, attr, None) == getattr(jenv, attr, None), attr
    for n in (16, 4096):
        venv = minigrid_tpu_torch.make_vec(env_id, n, device="cpu")
        jvenv = JVectorEnv(jenv, n)
        assert venv.reset_strategy == jvenv.reset_strategy == "fused"
    assert {minigrid_tpu_torch.make(i).num_actions for i in
            ("DirectionsDataset-v0", "BlocksDataset-v0")} == {4, 1}


@pytest.mark.parametrize("env_id", DATASET_IDS)
def test_generate_matches_jax(env_id):
    jkeys = jax.random.split(jax.random.PRNGKey(len(env_id)), 32)
    want = jax_program(env_id)(jkeys)
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    got = env.generate(port_keys(jkeys), env.default_params, device="cpu")
    assert_state_equal(got, want, f"{env_id}: ")
    map_fields(lambda t: assert_contiguous(t, env_id), got)
    for m, jm in zip(got.mission.numpy(), np.asarray(want.mission)):
        assert env.mission_text(m) == jenv.mission_text(jm), env_id
    np.testing.assert_array_equal(env.mission_codes(), np.asarray(jenv.mission_codes()))


def test_split_tables_and_cursors_match_jax():
    """The contrastive and directions tables, split for split and row for
    row; the cursors over a split and after ``set_split``; a generated batch
    draws from the split active at the call."""
    for env_id in ("ContrastiveTrajectoryDataset-v0", "DirectionsDataset-v0"):
        env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
        assert list(env.splits) == list(jenv.splits)
        for name, table in jenv.splits.items():
            assert env.splits[name].dtype == table.dtype
            np.testing.assert_array_equal(env.splits[name], table, err_msg=name)
        cursor = "next_composition" if hasattr(env, "next_composition") else "next_sequence"
        # every split that has rows (Directions' 182 sequences all go to
        # train), the last first
        for split in [k for k in reversed(list(env.splits)) if len(env.splits[k])]:
            env.set_split(split)
            jenv.set_split(split)
            for _ in range(len(env.splits[split]) + 3):  # wraps around
                np.testing.assert_array_equal(getattr(env, cursor)(),
                                              getattr(jenv, cursor)())

    env_id = "ContrastiveDataset-v0"
    env = minigrid_tpu_torch.make(env_id, split_seed=3)
    jenv = minigrid_tpu.make(env_id, split_seed=3)
    env.set_split("test")
    jenv.set_split("test")
    keys = jax.random.split(jax.random.PRNGKey(8), 16)
    want = jax.jit(jax.vmap(lambda k: jenv.generate(k, jenv.default_params)))(keys)
    got = env.generate(port_keys(keys), env.default_params, device="cpu")
    assert_state_equal(got, want, "test split: ")
    test_rows = {tuple(r) for r in env.splits["test"]}
    assert {tuple(r) for r in got.extra["target"].numpy()} <= test_rows


def test_blocks_move_count_draw_matches_jax():
    """``1 + categorical(key, log(p))`` with p in float32 (1/5, 4/5 for five
    blocks and two moves): the index on 2^20 keys, the port's ``torch.log``
    against XLA's."""
    env = minigrid_tpu_torch.make("BlocksDataset-v0")
    jenv = minigrid_tpu.make("BlocksDataset-v0")
    assert env._num_actions_p.dtype == np.float32
    np.testing.assert_array_equal(env._num_actions_p, np.asarray(jenv._num_actions_p))
    keys = jax.random.split(jax.random.PRNGKey(11), 1 << 20)
    want = jax.jit(jax.vmap(lambda k: jax.random.categorical(
        k, jnp.log(jenv._num_actions_p))))(keys)
    got = rng.categorical(port_keys(keys), env._log_p(CPU))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    frac = float(got.float().mean())
    assert 0.795 < frac < 0.805  # P(two moves) = 20 / (5 + 20)


@pytest.mark.parametrize("env_id", DATASET_IDS)
def test_lockstep_matches_jax(env_id):
    """B=32, 24 steps of random actions from the env's own action space,
    through the fused auto-reset.  Negated-Simple's episodes end by the time
    limit too, which the step reports while the state's flag stays False."""
    jenv, env = minigrid_tpu.make(env_id), minigrid_tpu_torch.make(env_id)
    limit = LOCKSTEP_LIMIT.get(env_id, env.max_steps)
    jvenv = JVectorEnv(jenv, B, params=dataclasses.replace(jenv.default_params,
                                                            max_steps=limit))
    venv = minigrid_tpu_torch.VectorEnv(
        env, B, dataclasses.replace(env.default_params, max_steps=limit), device="cpu")
    assert venv.reset_strategy == jvenv.reset_strategy == "fused"
    rewards, ends, st, jst = lockstep(jvenv, venv, len(env_id), STEPS,
                                      num_actions=venv.env.num_actions, jax_reset=False)
    assert_state_equal(st, jst, "final: ")
    assert ends >= B, ends
    if "Negated" in env_id:
        assert not st.truncated.any()


@pytest.mark.parametrize("env_id", ["MiniGrid-Negated-Simple-v0",
                                    "ContrastiveTrajectoryDataset-v0"])
def test_pickup_pays_plus_or_minus_one(env_id):
    """Face each object from its west side (free where it is not a wall) and
    pick it up: the target pays +1, the other object -1, and both end the
    episode; Negated-Simple's state keeps ``truncated`` False."""
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    jp = jenv.default_params
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, jp)))
    start = state_to_numpy(env.generate(rng.split(rng.PRNGKey(21, CPU), 64),
                                        env.default_params, device="cpu"))
    grid = start["grid"]
    rewards = []
    for which in (0, -1):  # the first and the last object of each grid
        cells = np.zeros((64, 2), np.int64)
        free = np.ones(64, bool)
        for b in range(64):
            # neither empty (1) nor wall (2)
            xs, ys = np.nonzero((grid[b] & 0xFF) > 2)
            cells[b] = xs[which], ys[which]
            free[b] = (grid[b, xs[which] - 1, ys[which]] & 0xFF) == 1
        f = _teleport(start, cells - [1, 0], 0)
        nxt, r, te = _step_both(env, jstep, f, 3, f"pickup {which}: ")
        ok = free & (nxt["carrying"][:, 0] != 1)
        assert te[ok].all()
        rewards.append(r[ok])
        if "Negated" in env_id:
            assert not nxt["truncated"].any()
    r = np.concatenate(rewards)
    assert (r == 1).any() and (r == -1).any() and set(np.unique(r)) <= {-1.0, 1.0}


def test_contrastive_done_beside_the_object_pays():
    """``done`` in the 8-neighbourhood of the object pays the task reward;
    far from it, nothing; both end the episode, as ``toggle`` does."""
    env_id = "ContrastiveDataset-v0"
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    jp = jenv.default_params
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, jp)))
    start = state_to_numpy(env.generate(rng.split(rng.PRNGKey(22, CPU), 16),
                                        env.default_params, device="cpu"))
    target = start["extra"]["target_pos"]
    near = np.clip(target + [1, 1], 1, env.width - 2)
    _, r, te = _step_both(env, jstep, _teleport(start, near, 0), 6, "done near: ")
    assert te.all() and (r > 0).all()
    far = np.where(target < env.width // 2, env.width - 2, 1)
    _, r, te = _step_both(env, jstep, _teleport(start, far, 0), 6, "done far: ")
    assert te.all() and (r == 0).all()
    _, r, te = _step_both(env, jstep, start, 5, "toggle: ")
    assert te.all()


def test_bench_takes_a_dataset_id(capsys):
    """``tools/bench.py --env`` on BlocksDataset (one action) and Directions
    (four) on the CPU: the rate, the fused strategy, no ring."""
    import json

    from minigrid_tpu_torch.tools import bench

    for env_id, n_act in (("BlocksDataset-v0", 1), ("DirectionsDataset-v0", 4)):
        bench.main(["--env", env_id, "--device", "cpu", "--num-envs", "16",
                    "--steps", "4"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["strategy"] == "fused" and out["num_envs"] == 16
        assert out["value"] > 0 and "fresh_frac" not in out
        assert minigrid_tpu_torch.make(env_id).num_actions == n_act

