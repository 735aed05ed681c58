"""The port's data- and tensor-parallel PPO on gloo ranks against the JAX
package's ``PPO(mesh=...)`` on the 8-device farm (``train_step_fn``'s update,
``tests/test_rl.py:140-158``, ``tests/test_sharding.py:223-245``).

One update on DoorKey-5x5 at a 10-step limit (B=8, T=16, 2 epochs x 2
minibatches, a float32 network), both sides from the JAX init's parameters
and ``PRNGKey(0)``: over ``dp=2`` (2 ranks against a ``(2, 1)`` mesh) and
over ``dp=2 x tp=2`` (4 ranks against a ``(2, 2)`` mesh).  The metrics
within rtol 1e-4 and the same on every rank; the parameters (the ``tp``
slices put back together) within ``PARAM_ATOL`` and 1 % of their move; the
env state, observation and key after the update bitwise.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import minigrid_tpu
from minigrid_tpu.parallel.multihost import pod_mesh as j_pod_mesh
from minigrid_tpu.rl import PPO as JPPO
from minigrid_tpu.rl import ActorCritic as JActorCritic
from minigrid_tpu.rl import PPOConfig as JPPOConfig

from minigrid_tpu_torch.parallel import multihost
from minigrid_tpu_torch.utils.convert import actor_critic_to_flax

from tests.test_torch_bridge import jax_to_numpy
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)
from tests.test_torch_sharding import assert_tree_equal, gather_state
from tests.test_torch_sharding_ppo import (
    _cat,
    assert_metrics_close,
    assert_params_close,
    full_params,
    shard_ranks,
)
from tests.torch_ranks import run_all

ENV_ID, MAX_STEPS = "MiniGrid-DoorKey-5x5-v0", 10
CFG = dict(num_envs=8, num_steps=16, num_updates=1, num_minibatches=2, update_epochs=2)
MESHES = {"dp2": (2, 1), "dp2_tp2": (4, 2)}  # (devices, tp)


@pytest.fixture(scope="module")
def jax_updates():
    """Each mesh's JAX update from ``PRNGKey(0)``: {name: (params before,
    runner after, metrics)}."""
    env = minigrid_tpu.make(ENV_ID, max_steps=MAX_STEPS)
    out = {}
    for name, (n, tp) in MESHES.items():
        trainer = JPPO(env, env.default_params, JPPOConfig(**CFG),
                       mesh=j_pod_mesh(tp=tp, devices=jax.devices()[:n]),
                       network=JActorCritic(num_actions=env.num_actions, dtype=jnp.float32))
        runner = trainer.init(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, runner[0].params)
        runner, metrics = trainer.update(runner)
        out[name] = (tree, runner, metrics)
    return out


@pytest.fixture(scope="module")
def port_updates(jax_updates):
    """The port's update on each mesh's ranks from the same parameters."""
    out = {}
    for name, (n, tp) in MESHES.items():
        call = ("ppo_update", dict(env_id=ENV_ID, make_kwargs={"max_steps": MAX_STEPS},
                                   cfg_kwargs=CFG, tree=jax_updates[name][0], tp=tp))
        out[name] = [r[0] for r in multihost.spawn(run_all, n, ([call],), backend="gloo")]
    return out


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_update_matches_jax_mesh_update(jax_updates, port_updates, name):
    tree, jrunner, jmetrics = jax_updates[name]
    ranks = port_updates[name]
    assert_metrics_close(ranks, {k: float(v) for k, v in jmetrics.items()}, name)
    assert_params_close(actor_critic_to_flax(full_params(ranks)),
                        jax.tree_util.tree_map(np.asarray, jrunner[0].params), tree, name)
    shards = shard_ranks(ranks)
    assert_tree_equal(gather_state([r["env_state"] for r in shards]),
                      jax_to_numpy(jrunner[1]), f"{name} env_state ")
    for k in ("image", "direction", "mission"):
        np.testing.assert_array_equal(_cat([r["obs"][k] for r in shards], 0),
                                      np.asarray(jrunner[2][k]), err_msg=k)
    for r in ranks:
        np.testing.assert_array_equal(r["key"], np.asarray(jrunner[3]).astype(np.int64))
        assert r["steps"] == int(jrunner[0].step) == 4
    assert float(jmetrics["episodes"]) > 0
