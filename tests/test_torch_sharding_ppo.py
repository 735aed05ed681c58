"""The port's data- and tensor-parallel PPO on gloo ranks, against its
unsharded update.

* A ``dp=2`` update on Empty-5x5 and DoorKey-5x5 (``max_steps`` 6 and 10, B=8,
  T=8 and 16, 2 epochs x 2 minibatches, a float32 network from one flax
  init), a ``dp=4`` and a ``dp=2 x tp=2`` update on DoorKey-5x5, each
  against the port's unsharded update from the same parameters and key:
  observations, actions, reward bits and flags equal; values and
  log-probabilities within 1e-5; metrics within rtol 1e-4 and the same on
  every rank; parameters (the ``tp`` slices put back together) within
  ``tests/test_torch_rl_ppo.py``'s ``PARAM_ATOL`` and 1 % of their move, the
  same on every ``dp`` replica; the env state, key and episode tallies
  after the update bitwise.
* The pooled ``refill_period`` update under ``dp=2`` (BabyAI-GoToRedBallGrey
  at a 5-step limit, 2-level windows, refill every 4 steps,
  ``tests/test_rl.py:161-182``):
  the ring's tick is T on every rank, the fresh/stale counts over the ranks
  are the unsharded ones.
* ``tp_param_sharding``'s table against JAX's, leaf by leaf through the
  converters, and the converters' layouts (``rl.mesh.flax_axes``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minigrid_tpu.parallel.multihost import pod_mesh as j_pod_mesh
from minigrid_tpu.rl import ActorCritic as JActorCritic
from minigrid_tpu.rl.ppo import tp_param_sharding as j_tp_param_sharding

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.parallel import multihost
from minigrid_tpu_torch.parallel.vector import VectorEnv
from minigrid_tpu_torch.rl.mesh import flax_axes
from minigrid_tpu_torch.utils.convert import (
    actor_critic_from_flax,
    actor_critic_to_flax,
    shard_params,
    unshard_params,
)

from tests.test_torch_rl_ppo import PARAM_ATOL, PARAM_REL_L2, VALUE_ATOL
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)
from tests.test_torch_sharding import assert_tree_equal, gather_state
from tests.torch_ranks import ppo_update, run_all

CPU = torch.device("cpu")
SMALL = dict(num_envs=8, num_updates=1, num_minibatches=2, update_epochs=2)
# name: (ranks, env id, make overrides, config, tp, pooled window)
UPDATES = {
    "empty_dp2": (2, "MiniGrid-Empty-5x5-v0", {"max_steps": 6},
                  dict(SMALL, num_steps=8), 1, None),
    "doorkey_dp2": (2, "MiniGrid-DoorKey-5x5-v0", {"max_steps": 10},
                    dict(SMALL, num_steps=16), 1, None),
    "pooled_dp2": (2, "BabyAI-GoToRedBallGrey-v0", {"max_steps": 5},
                   dict(SMALL, num_steps=16, update_epochs=1, refill_period=4), 1, 2),
    "doorkey_dp4": (4, "MiniGrid-DoorKey-5x5-v0", {"max_steps": 10},
                    dict(SMALL, num_steps=16), 1, None),
    "doorkey_dp2_tp2": (4, "MiniGrid-DoorKey-5x5-v0", {"max_steps": 10},
                        dict(SMALL, num_steps=16), 2, None),
}
METRIC_RTOL = 1e-4


def flax_tree(env_id: str = "MiniGrid-DoorKey-5x5-v0", seed: int = 4) -> dict:
    """A float32 flax ActorCritic's parameters, initialised on an
    observation of ``env_id``."""
    env = mgt.make(env_id)
    obs, _ = VectorEnv(env, 1, device=CPU).reset(rng.PRNGKey(0, CPU))
    net = JActorCritic(num_actions=env.num_actions, dtype=jnp.float32)
    tree = net.init(jax.random.PRNGKey(seed), {k: jnp.asarray(v.numpy()) for k, v in obs.items()})
    return jax.tree_util.tree_map(np.asarray, tree)


def update_kwargs(name: str, tree: dict) -> dict:
    _, env_id, make_kwargs, cfg, tp, window = UPDATES[name]
    return dict(env_id=env_id, make_kwargs=make_kwargs, cfg_kwargs=cfg, tree=tree, tp=tp,
                pooled_window=window)


def spawn_updates(names, tree: dict, extra_calls=()) -> dict:
    """Each named update on its ranks, one spawn per rank count: {name:
    [rank results]} (and the extra calls' results by their names)."""
    out = {}
    for n in sorted({UPDATES[k][0] for k in names}):
        mine = [k for k in names if UPDATES[k][0] == n]
        calls = [("ppo_update", update_kwargs(k, tree)) for k in mine]
        extra = [(name, call) for name, call in extra_calls if n == 4]
        calls += [call for _, call in extra]
        per_rank = multihost.spawn(run_all, n, (calls,), backend="gloo")
        for i, name in enumerate(mine + [name for name, _ in extra]):
            out[name] = [r[i] for r in per_rank]
    return out


# -- comparing a sharded update with the unsharded one ------------------------------------------

def shard_ranks(ranks: list) -> list:
    """One rank per ``dp`` shard (``tp`` index 0): a ``tp`` group's ranks
    hold the same rows."""
    tp = 2 if ranks[0]["placement"] else 1
    return ranks[::tp]


def _cat(parts: list, axis: int):
    if isinstance(parts[0], dict):
        return {k: _cat([p[k] for p in parts], axis) for k in parts[0]}
    if parts[0] is None:
        return None
    return np.concatenate(parts, axis)


def full_params(ranks: list) -> dict:
    """The whole parameter set of a sharded run, as tensors: the ``tp``
    slices put back together; every ``dp`` replica must hold the same."""
    tp = 2 if ranks[0]["placement"] else 1
    groups = [ranks[i:i + tp] for i in range(0, len(ranks), tp)]
    fulls = []
    for group in groups:
        shards = [{n: torch.from_numpy(v) for n, v in r["params"].items()} for r in group]
        fulls.append(unshard_params(shards, [r["placement"] for r in group])
                     if tp > 1 else shards[0])
    for other in fulls[1:]:
        for n, v in other.items():
            assert torch.equal(v, fulls[0][n]), f"dp replicas differ in {n}"
    return fulls[0]


def assert_params_close(got: dict, want: dict, init: dict, where: str) -> None:
    """Each parameter within ``PARAM_ATOL`` and within ``PARAM_REL_L2`` of
    how far the update moved it (flax trees of numpy)."""
    flat_init = dict(jax.tree_util.tree_leaves_with_path(init))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    moved_any = 0.0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = flat_got[path]
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=where + jax.tree_util.keystr(path))
        moved = np.linalg.norm((w - flat_init[path]).astype(np.float64))
        moved_any = max(moved_any, moved)
        assert np.linalg.norm((g - w).astype(np.float64)) <= PARAM_REL_L2 * moved + 1e-12, (
            where, jax.tree_util.keystr(path))
    assert moved_any > 1e-4  # the update moved the parameters


def assert_metrics_close(ranks: list, want: dict, where: str) -> None:
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"], f"{where}: ranks report other metrics"
    got = ranks[0]["metrics"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=f"{where} {k}")


def assert_update_matches(ranks: list, want: dict, tree: dict, where: str) -> None:
    shards = shard_ranks(ranks)
    b = want["traj"]["action"].shape[1] // len(shards)
    assert [tuple(r["shard"]) for r in shards] == [(i * b, (i + 1) * b)
                                                   for i in range(len(shards))]
    traj = _cat([r["traj"] for r in shards], 1)
    for k in ("image", "direction", "mission"):
        np.testing.assert_array_equal(traj["obs"][k], want["traj"]["obs"][k], err_msg=k)
    for k in ("action", "done", "truncated"):
        np.testing.assert_array_equal(traj[k], want["traj"][k], err_msg=f"{where} {k}")
    np.testing.assert_array_equal(traj["reward"].view(np.int32),
                                  want["traj"]["reward"].view(np.int32))
    for k in ("value", "log_prob", "trunc_value"):
        np.testing.assert_allclose(traj[k], want["traj"][k], rtol=0, atol=VALUE_ATOL,
                                   err_msg=f"{where} {k}")
    assert_metrics_close(ranks, want["metrics"], where)
    init = actor_critic_to_flax(actor_critic_from_flax(tree, torch.float32, CPU))
    assert_params_close(actor_critic_to_flax(full_params(ranks)),
                        actor_critic_to_flax({n: torch.from_numpy(v)
                                              for n, v in want["params"].items()}),
                        init, where)
    for r in ranks:
        assert r["steps"] == want["steps"]
        np.testing.assert_array_equal(r["key"], want["key"])
    assert_tree_equal(gather_state([r["env_state"] for r in shards]),
                      {k: v for k, v in want["env_state"].items()
                       if k not in ("n_fresh", "n_stale")}, f"{where} env_state ")
    if "tick" in want:
        for r in ranks:
            assert r["tick"] == want["tick"] and tuple(r["ring"]) == tuple(want["ring"])
    for i in range(2):
        np.testing.assert_array_equal(_cat([r["running"][i] for r in shards], 0),
                                      want["running"][i])


@pytest.fixture(scope="module")
def tree():
    return flax_tree()


@pytest.fixture(scope="module")
def runs(tree):
    return spawn_updates(list(UPDATES), tree, [("tp_table", ("tp_table", {"tree": tree}))])


@pytest.mark.parametrize("name", list(UPDATES))
def test_sharded_update_matches_the_unsharded_update(runs, tree, name):
    want = ppo_update(**update_kwargs(name, tree), sharded=False)
    if UPDATES[name][5] is not None:
        assert want["tick"] == UPDATES[name][3]["num_steps"]
        assert sum(want["ring"]) > 0
    assert want["metrics"]["episodes"] > 0
    assert_update_matches(runs[name], want, tree, name)


def test_tp_sharding_table_matches_jax(runs, tree):
    """``tp_param_sharding`` on ``tp=2`` against JAX's on a ``(2, 2)`` mesh
    of the farm, leaf by leaf: a leaf is sharded in both or in neither, and
    the port shards the dim that is the flax leaf's last."""
    table = runs["tp_table"][0]
    specs = j_tp_param_sharding(tree["params"], j_pod_mesh(tp=2, devices=jax.devices()[:4]))
    jax_sharded = {jax.tree_util.keystr(p): s.spec[-1] == "tp" if len(s.spec) else False
                   for p, s in jax.tree_util.tree_leaves_with_path(specs)}
    model = actor_critic_from_flax(tree, torch.float32, CPU)
    # each parameter as 1 where sharded, through the converter to flax's paths
    marks = actor_critic_to_flax({n: torch.full(p.shape, float(table[n] is not None))
                                  for n, p in model.named_parameters()})
    got = {jax.tree_util.keystr(p): bool(v.all())
           for p, v in jax.tree_util.tree_leaves_with_path(marks["params"])}
    assert got == jax_sharded
    assert sum(got.values()) == 10  # five embeddings, two convs, two hidden denses, DoorKey's 8-action head
    for r, rank_table in enumerate(runs["tp_table"]):
        for n, entry in rank_table.items():
            if entry is None:
                continue
            dim, rows, shape = entry
            assert dim == flax_axes(n)[-1]
            k = shape[dim] // 2
            assert tuple(rows) == tuple(range((r % 2) * k, (r % 2 + 1) * k))


def test_shard_params_and_back(runs, tree):
    """``convert.shard_params`` cuts the whole parameter set to each rank's
    slices as the ``tp`` run holds them, and ``unshard_params`` puts them
    back bitwise; slices that leave a parameter uncovered raise."""
    ranks = runs["doorkey_dp2_tp2"][:2]  # the tp group of dp shard 0
    placements = [r["placement"] for r in ranks]
    full = {n: p.detach() for n, p in
            actor_critic_from_flax(tree, torch.float32, CPU).named_parameters()}
    shards = [shard_params(full, p) for p in placements]
    for shard, r in zip(shards, ranks):
        assert {n: tuple(v.shape) for n, v in shard.items()} == {
            n: v.shape for n, v in r["params"].items()}
    back = unshard_params(shards, placements)
    assert all(torch.equal(back[n], v) for n, v in full.items())
    with pytest.raises(ValueError, match="cover"):
        unshard_params(shards[:1], placements[:1])


def test_flax_axes_are_the_converters_layouts(tree):
    """``flax_axes`` permutes each port parameter into its flax leaf, as
    ``actor_critic_to_flax`` lays it out."""
    model = actor_critic_from_flax(tree, torch.float32, CPU)
    flax = dict(jax.tree_util.tree_leaves_with_path(actor_critic_to_flax(model)))
    by_name = {n: p.detach().numpy() for n, p in model.named_parameters()}
    # the converter's own order of names, matched to flax's paths by value
    for name, value in by_name.items():
        permuted = np.transpose(value, flax_axes(name))
        assert any(v.shape == permuted.shape and np.array_equal(v, permuted)
                   for v in flax.values()), name
