"""Rank bodies of the port's multi-rank tests.

Each function runs on every rank of a ``multihost.spawn`` of gloo ranks on the
CPU (``tests/test_torch_sharding*.py``, ``tests/test_torch_checkpoint.py``)
and returns numpy arrays to the parent, which puts the ranks' rows together
and compares them.  The same functions run in the parent with
``sharded=False`` for the unsharded reference.  This module imports neither
``jax`` nor ``minigrid_tpu``, so that a rank starts in seconds and never
builds the XLA device farm.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.parallel.multihost import (
    initialize,
    pod_mesh,
    process_local_slice,
    to_host,
)
from minigrid_tpu_torch.parallel.sharding import Shard, ShardedVectorEnv, batch_shard_tree
from minigrid_tpu_torch.parallel.vector import PooledState, VectorEnv
from minigrid_tpu_torch.utils.convert import actor_critic_from_flax, state_to_numpy

CPU = torch.device("cpu")


def _stack(steps: list) -> dict | np.ndarray:
    if isinstance(steps[0], dict):
        return {k: _stack([s[k] for s in steps]) for k in steps[0]}
    return torch.stack(steps).numpy()


def env_walk(env_id: str, make_kwargs: dict, venv_kwargs: dict, num_envs: int, steps: int,
             refill_period: int = 1, seed: int = 0, sharded: bool = True) -> dict:
    """Reset from ``split(PRNGKey(seed))[1]``, then ``steps`` steps of
    actions drawn over the global batch from ``split(split(key)[0], steps)``
    (this rank's rows of each draw), with a bulk refill of
    ``refill_period`` windows every ``refill_period`` consume-only steps
    when it is above 1.  Returns every observation (reset included), the
    reward bits, the flags, the final state (this rank's), and for a pooled
    ring its tick and the fresh/stale counts over every rank."""
    torch.set_num_threads(1)
    env = mgt.make(env_id, **make_kwargs)
    if sharded:
        venv = ShardedVectorEnv(env, num_envs, device=CPU, **venv_kwargs)
    else:
        venv = VectorEnv(env, num_envs, device=CPU, **venv_kwargs)
    shard = (venv.lo, venv.hi)
    key, k_reset = rng.split(rng.PRNGKey(seed, CPU)).unbind(0)
    obs, state = venv.reset(k_reset)
    keys = rng.split(key, steps)
    frames, rewards, terms, truncs = [obs], [], [], []
    for t in range(steps):
        action = rng.randint(keys[t], (num_envs,), 0, env.num_actions, rows=shard)
        if refill_period > 1:
            obs, state, reward, term, trunc, _ = venv.step_nofill(state, action)
            if (t + 1) % refill_period == 0:
                state = venv.refill(state, refill_period)
        else:
            obs, state, reward, term, trunc, _ = venv.step(state, action)
        frames.append(obs)
        rewards.append(reward.view(torch.int32))
        terms.append(term)
        truncs.append(trunc)
    out = {"shard": shard, "obs": _stack(frames), "reward": _stack(rewards),
           "terminated": _stack(terms), "truncated": _stack(truncs),
           "state": state_to_numpy(state), "strategy": venv.reset_strategy,
           "window": venv.pool_refill}
    if isinstance(state, PooledState):
        out["tick"] = int(state.tick)
        out["ring"] = (venv.ring_counts(state) if sharded
                       else (int(state.n_fresh), int(state.n_stale)))
    return out


def rollout_totals(env_id: str, num_envs: int, steps: int, seed: int) -> tuple:
    """``sharded_rollout``'s global totals on this rank."""
    from minigrid_tpu_torch.parallel.sharding import sharded_rollout

    torch.set_num_threads(1)
    env = mgt.make(env_id)
    return sharded_rollout(env, None, rng.PRNGKey(seed, CPU), num_envs, steps, device=CPU)


def mesh_facts() -> dict:
    """What ``initialize``, ``pod_mesh`` and ``process_local_slice`` say on
    this rank."""
    mesh, flat = pod_mesh(tp=2), pod_mesh(tp=1)
    return {"initialize": initialize(), "world": dist.get_world_size(),
            "rank": dist.get_rank(), "backend": dist.get_backend(),
            "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "coords": (mesh.get_local_rank("dp"), mesh.get_local_rank("tp")),
            "slice16": process_local_slice(16),
            "flat_shape": dict(zip(flat.mesh_dim_names, flat.shape))}


def run_all(calls: list) -> list:
    """Several bodies in one spawn: ``[(name, kwargs), ...]`` -> their
    results, in order."""
    return [globals()[name](**kwargs) for name, kwargs in calls]


def _ppo_trainer(env_id: str, make_kwargs: dict, cfg_kwargs: dict, tree: dict,
                 tp: int, sharded: bool, pooled_window: int | None):
    from minigrid_tpu_torch.rl import PPO, PPOConfig

    env = mgt.make(env_id, **make_kwargs)
    net = actor_critic_from_flax(tree, torch.float32, CPU)
    net.init = lambda key, obs: net  # start from the given parameters
    trainer = PPO(env, None, PPOConfig(**cfg_kwargs), network=net, device=CPU,
                  mesh=pod_mesh(tp=tp) if sharded else None)
    if pooled_window is not None:
        trainer.venv = VectorEnv(env, trainer.config.num_envs, final_obs=True,
                                 reset_strategy="pooled", pool_refill=pooled_window,
                                 device=CPU, shard=(trainer.venv.lo, trainer.venv.hi))
    return trainer


def ppo_update(env_id: str, make_kwargs: dict, cfg_kwargs: dict, tree: dict, tp: int = 1,
               seed: int = 0, sharded: bool = True, pooled_window: int | None = None) -> dict:
    """One PPO update from the flax parameters ``tree`` (float32) and
    ``PRNGKey(seed)``: the rollout (this rank's rows), the metrics, the
    runner after the update (env state, key, stats, optimizer steps) and the
    parameters (this rank's slices, with their placement)."""
    torch.set_num_threads(1)
    trainer = _ppo_trainer(env_id, make_kwargs, cfg_kwargs, tree, tp, sharded, pooled_window)
    runner = trainer.init(rng.PRNGKey(seed, CPU))
    runner, traj = trainer.rollout(runner)
    runner, metrics = trainer.optimize(runner, trainer.advantages(runner, traj))
    stats = runner.stats
    out = {"shard": (trainer.venv.lo, trainer.venv.hi), "traj": traj,
           "metrics": {k: float(v) for k, v in metrics.items()},
           "env_state": state_to_numpy(runner.env_state), "key": runner.key,
           "obs": runner.obs, "steps": runner.train_state.step,
           "params": {n: p.detach().clone()
                      for n, p in runner.train_state.model.named_parameters()},
           "placement": trainer.param_placement or {},
           "running": (stats.running_return, stats.running_length)}
    if isinstance(runner.env_state, PooledState):
        out["tick"] = int(runner.env_state.tick)
        counts = torch.stack([runner.env_state.n_fresh, runner.env_state.n_stale])
        if sharded:
            dist.all_reduce(counts)
        out["ring"] = tuple(counts.tolist())
    return to_host(out)


def tp_table(tree: dict) -> dict:
    """``rl.tp_param_sharding`` of the ActorCritic of ``tree`` on this
    rank's ``tp=2`` mesh: ``{name: (dim, rows) or None}``."""
    from minigrid_tpu_torch.rl import tp_param_sharding

    model = actor_critic_from_flax(tree, torch.float32, CPU)
    table = tp_param_sharding(model, pod_mesh(tp=2))
    return {n: None if s is None else (s.dim, s.rows, s.shape) for n, s in table.items()}


def checkpoint_round_trip(path: str) -> dict:
    """``tests/distributed_worker.py``'s checks on this rank: a dp-sharded
    leaf and a replicated one saved to shard files (with the barrier) and
    loaded back onto a zero template; a replicated-only tree; then a
    ``ShardedVectorEnv``'s pooled state with its ``batch_shard_tree``
    placement, for the parent to load whole."""
    from minigrid_tpu_torch.utils.checkpoint import load, save

    torch.set_num_threads(1)
    rank = dist.get_rank()
    full = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    lo, size = process_local_slice(16)
    rows = tuple(range(lo, lo + size))
    tree = {"w": torch.from_numpy(full[lo:lo + size].copy()), "step": 7}
    placement = {"w": Shard((16, 3), 0, rows), "step": None}
    save(path, tree, placement)
    out = {"own_file": os.path.exists(f"{path}.proc{rank}"), "single": os.path.exists(path)}
    restored = load(path, {"w": torch.zeros(size, 3), "step": 0}, placement)
    out["w"], out["step"] = restored["w"], restored["step"]
    rep = torch.from_numpy(full.ravel()[:5].copy())
    save(path + ".rep", {"r": rep})
    out["rep"] = load(path + ".rep", {"r": torch.zeros(5)})["r"]

    env = mgt.make("MiniGrid-DoorKey-5x5-v0", max_steps=6)
    venv = ShardedVectorEnv(env, 8, device=CPU, reset_strategy="pooled", pool_refill=4)
    key, k_reset = rng.split(rng.PRNGKey(3, CPU)).unbind(0)
    _, state = venv.reset(k_reset)
    keys = rng.split(key, 8)
    for t in range(8):
        _, state, *_ = venv.step(state, rng.randint(keys[t], (8,), 0, env.num_actions,
                                                    rows=venv.shard))
    save(path + ".env", state, batch_shard_tree(state, None))
    return out
