"""The port's checkpoint (``minigrid_tpu_torch/utils/checkpoint.py``) against
``tests/test_checkpoint.py`` and ``tests/distributed_worker.py``.

* the one-file round trip of an env batch and of a PPO runner: the restored
  run steps on exactly as the original does;
* ``state_hash`` is the JAX package's digest of the same state (an
  ``EnvState`` batch, a pooled ring, a family's ``extra`` dict, BabyAI's
  instruction code and verifier state), and it changes with the state;
* on 2 gloo ranks: a dp-sharded leaf and a replicated one through the shard
  files and the barrier, back onto a zero template; a ``ShardedVectorEnv``'s
  pooled state saved with ``batch_shard_tree``'s placement, loaded whole in
  one process, is the unsharded run's state; a leaf the files do not cover
  raises.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minigrid_tpu.core.state import EnvState as JEnvState
from minigrid_tpu.parallel.vector import PooledState as JPooledState
from minigrid_tpu.utils.checkpoint import state_hash as j_state_hash

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.parallel import multihost
from minigrid_tpu_torch.parallel.vector import VectorEnv
from minigrid_tpu_torch.utils.checkpoint import load, load_process_shards, save, state_hash
from minigrid_tpu_torch.utils.convert import state_to_numpy

from tests.test_torch_babyai_step import babyai_jax_state
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)
from tests.torch_ranks import checkpoint_round_trip

CPU = torch.device("cpu")


def _leaves_equal(a, b) -> None:
    for x, y in zip(state_to_numpy(a).items(), state_to_numpy(b).items()):
        np.testing.assert_equal(x, y)


def test_env_state_checkpoint_roundtrip(tmp_path):
    env = mgt.make("MiniGrid-DoorKey-5x5-v0")
    venv = VectorEnv(env, 4, device=CPU)
    _, state = venv.reset(rng.PRNGKey(0, CPU))
    _, state, *_ = venv.step(state, torch.zeros(4, dtype=torch.int32))
    path = str(tmp_path / "state.pt")
    save(path, state)
    _, template = venv.reset(rng.PRNGKey(1, CPU))  # a different state, same structure
    restored = venv.step(load(path, template), torch.ones(4, dtype=torch.int32))
    resumed = venv.step(state, torch.ones(4, dtype=torch.int32))
    _leaves_equal(restored[1], resumed[1])
    assert state_hash(restored[1]) == state_hash(resumed[1])


def test_ppo_runner_checkpoint_roundtrip(tmp_path):
    """The model, Adam's moments and step count, the env state, the key and
    the episode tallies come back: the next update is the same."""
    from minigrid_tpu_torch.rl import PPO, PPOConfig

    env = mgt.make("MiniGrid-Empty-5x5-v0")
    cfg = PPOConfig(num_envs=4, num_steps=8, num_updates=2, num_minibatches=2,
                    update_epochs=1)
    trainer = PPO(env, None, cfg, device=CPU)
    runner, _ = trainer.update(trainer.init(rng.PRNGKey(0, CPU)))
    path = str(tmp_path / "runner.pt")
    save(path, runner)
    restored = load(path, trainer.init(rng.PRNGKey(7, CPU)))
    assert restored.train_state.step == runner.train_state.step == 2
    a, ma = trainer.update(restored)
    b, mb = trainer.update(runner)
    for x, y in zip(a.train_state.model.parameters(), b.train_state.model.parameters()):
        assert torch.equal(x, y)
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}


def test_load_refuses_another_structure(tmp_path):
    path = str(tmp_path / "tree.pt")
    save(path, {"a": torch.zeros(3), "b": 1})
    with pytest.raises(ValueError, match="leaves"):
        load(path, {"a": torch.zeros(3)})


def test_state_hash_detects_change():
    env = mgt.make("MiniGrid-Empty-5x5-v0")
    venv = VectorEnv(env, 2, device=CPU)
    _, s1 = venv.reset(rng.PRNGKey(0, CPU))
    _, s2 = venv.reset(rng.PRNGKey(0, CPU))
    assert state_hash(s1) == state_hash(s2)
    _, s3, *_ = venv.step(s1, torch.full((2,), 2, dtype=torch.int32))
    assert state_hash(s3) != state_hash(s1)


def _jax_state(fields: dict):
    """numpy fields (the JAX package's dtypes) -> the JAX state."""
    if "envs" in fields:
        rest = {k: jnp.asarray(v) for k, v in fields.items() if k not in ("envs", "pool")}
        return JPooledState(envs=_jax_state(fields["envs"]), pool=_jax_state(fields["pool"]),
                            **rest)
    return JEnvState(**{k: None if v is None else jax.tree_util.tree_map(jnp.asarray, v)
                        for k, v in fields.items()})


# (env id, B, VectorEnv options, steps)
HASHED = {
    "doorkey": ("MiniGrid-DoorKey-5x5-v0", 4, {}, 3),
    "pooled": ("MiniGrid-DoorKey-8x8-v0", 8, {"reset_strategy": "pooled", "pool_refill": 4}, 5),
    "memory_extra": ("MiniGrid-MemoryS7-v0", 4, {}, 2),
    "babyai_pooled": ("BabyAI-GoToRedBall-v0", 4,
                      {"reset_strategy": "pooled", "pool_refill": 2}, 2),
}


@pytest.mark.parametrize("case", list(HASHED))
def test_state_hash_matches_jax(case):
    env_id, b, kwargs, steps = HASHED[case]
    env = mgt.make(env_id)
    venv = VectorEnv(env, b, device=CPU, **kwargs)
    _, state = venv.reset(rng.PRNGKey(3, CPU))
    for t in range(steps):
        action = rng.randint(rng.PRNGKey(10 + t, CPU), (b,), 0, env.num_actions)
        _, state, *_ = venv.step(state, action)
    fields = state_to_numpy(state)
    jstate = babyai_jax_state(fields) if case.startswith("babyai") else _jax_state(fields)
    assert state_hash(state) == j_state_hash(jstate)
    assert state_hash(state, size=64) == j_state_hash(jstate, size=64)


# -- shard files on 2 ranks ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist") / "dist.ckpt")
    return path, multihost.spawn(checkpoint_round_trip, 2, (path,), backend="gloo")


def test_two_rank_shard_files_roundtrip(shard_run):
    """Each rank wrote its own ``path.proc{rank}`` and no single file; the
    dp-sharded leaf comes back as the rank's rows, the replicated ones
    whole."""
    path, ranks = shard_run
    full = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    for r, out in enumerate(ranks):
        assert out["own_file"] and not out["single"]
        np.testing.assert_array_equal(out["w"], full[8 * r:8 * (r + 1)])
        assert out["step"] == 7
        np.testing.assert_array_equal(out["rep"], full.ravel()[:5])


def test_sharded_env_state_loads_whole(shard_run):
    """The ranks' pooled state, placed by ``batch_shard_tree``, loads in one
    process onto the unsharded state's template as the unsharded run's
    state (the per-rank fresh/stale counts as a vector over the ranks)."""
    path, _ = shard_run
    env = mgt.make("MiniGrid-DoorKey-5x5-v0", max_steps=6)
    venv = VectorEnv(env, 8, device=CPU, reset_strategy="pooled", pool_refill=4)
    key, k_reset = rng.split(rng.PRNGKey(3, CPU)).unbind(0)
    _, state = venv.reset(k_reset)
    keys = rng.split(key, 8)
    for t in range(8):
        _, state, *_ = venv.step(state, rng.randint(keys[t], (8,), 0, env.num_actions))
    _, template = venv.reset(rng.PRNGKey(9, CPU))
    whole = load_process_shards(path + ".env", template)
    assert int(whole.n_fresh.sum()) == int(state.n_fresh) > 0
    assert int(whole.n_stale.sum()) == int(state.n_stale)
    want = {k: v for k, v in state_to_numpy(state).items() if k not in ("n_fresh", "n_stale")}
    got = state_to_numpy(whole)
    for name in ("fresh", "tick", "key"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for part in ("envs", "pool"):
        for k, v in want[part].items():
            np.testing.assert_equal(got[part][k], v, err_msg=f"{part}.{k}")


def test_uncovered_leaf_raises(shard_run, tmp_path):
    """Without rank 1's file, the sharded leaf is half covered: refused."""
    path, _ = shard_run
    lone = str(tmp_path / "lone.ckpt")
    shutil.copy(f"{path}.proc0", f"{lone}.proc0")
    shutil.copy(f"{path}.proc0", f"{lone}.proc1.tmp")  # a crash's leftover is ignored
    with pytest.raises(ValueError, match="cover 8 of its 16 rows"):
        load_process_shards(lone, {"w": torch.zeros(16, 3), "step": 0})
    with pytest.raises(FileNotFoundError):
        load(str(tmp_path / "absent.ckpt"), {"w": torch.zeros(16, 3)})
