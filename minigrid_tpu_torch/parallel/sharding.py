"""Env batches sharded over the ranks of a ``DeviceMesh``.

Counterpart of ``minigrid_tpu/parallel/sharding.py``.  JAX shards the batch
axis of one program over a ``jax.sharding.Mesh``; here each rank of a
``torch.distributed`` run holds its contiguous rows ``[lo, hi)`` of the global
batch of ``num_envs`` and runs the same program on them
(``VectorEnv(shard=(lo, hi))``).  Level generation derives every episode from
keys split out of a key every rank holds, so the env loop needs no
collective, and a rank's rows are those rows of the unsharded run, bitwise.
Collectives appear only where a user reads a global number: the fresh/stale
counters of the pooled ring (:meth:`ShardedVectorEnv.ring_counts`), the
totals of :func:`sharded_rollout`, the learner's gradients.

JAX routes the observation of a sharded batch through ``jax.shard_map`` so
that each device runs the Pallas gather on its shard; a rank's own
observation of its rows is that path here, and it launches ``obs_gather``
on its card.

Without a process group (a single process) a ``mesh=None`` run is one shard
of everything.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.state import EnvParams, map_tree
from minigrid_tpu_torch.parallel.vector import PooledState, VectorEnv


def env_mesh(devices=None, axis_name: str = "env"):
    """A 1-D ``DeviceMesh`` over every rank (or the ranks ``devices``); the
    env batch shards along it."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("env_mesh needs a process group: call "
                           "multihost.initialize() first")
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks), mesh_dim_names=(axis_name,))


class MeshAxis(NamedTuple):
    """This rank's place on one axis of a mesh: ``index`` its coordinate,
    ``size`` the axis's length, ``group`` the process group of the ranks
    that differ from it on this axis alone (``None`` without a mesh)."""

    index: int
    size: int
    group: Any

    def rows(self, num: int) -> tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of a batch axis of ``num``."""
        if num % self.size:
            raise ValueError(f"num_envs={num} must be divisible by mesh size {self.size}")
        per = num // self.size
        return self.index * per, (self.index + 1) * per


def mesh_axis(mesh, axis_name: str) -> MeshAxis:
    """This rank's place on the axis ``axis_name`` of ``mesh``."""
    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has axes {mesh.mesh_dim_names}, not {axis_name!r}")
    return MeshAxis(mesh.get_local_rank(axis_name),
                    mesh.size(mesh.mesh_dim_names.index(axis_name)),
                    mesh.get_group(axis_name))


def batch_sharding(mesh, axis_name: str = "env") -> MeshAxis:
    """This rank's place on the batch axis ``axis_name`` of ``mesh``: over
    every rank when ``mesh`` is ``None`` and a process group is up, else the
    whole batch."""
    if mesh is None:
        if not (dist.is_initialized() and dist.get_world_size() > 1):
            return MeshAxis(0, 1, None)
        mesh = env_mesh(axis_name=axis_name)
    return mesh_axis(mesh, axis_name)


@dataclass(frozen=True)
class Shard:
    """This rank's part of a global leaf: the global leaf has ``shape``,
    and the local leaf is its elements at ``rows`` along ``dim`` (a scalar
    local leaf is one element of a vector: a per-rank counter)."""

    shape: tuple
    dim: int
    rows: tuple


def _rows(lo: int, hi: int) -> tuple:
    return tuple(range(lo, hi))


def batch_shard_tree(tree: Any, mesh, axis_name: str = "env") -> Any:
    """Where each leaf of this rank's env-batch tree lies in the global
    tree: a tree of the same structure whose leaves are :class:`Shard` or
    ``None`` (replicated).  JAX's rule on the local layout: a leaf with a
    leading axis (the env batch B) is this rank's rows of it; the pooled
    ring's ``pool`` and ``fresh`` (2B slots) are its slots ``[lo, hi)`` and
    ``[B + lo, B + hi)``; scalars (``tick``, the ring's ``key``) replicate,
    but for the ring's ``n_fresh``/``n_stale``, which count this rank's own
    resets: each is this rank's entry of a vector over the shards.  The
    checkpoint (``utils/checkpoint.py``) reads it."""
    sh = batch_sharding(mesh, axis_name)

    def batch(x):
        b = x.shape[0]
        return Shard((b * sh.size,) + tuple(x.shape[1:]), 0,
                     _rows(sh.index * b, (sh.index + 1) * b))

    def ring(x):
        b = x.shape[0] // 2
        big_b = b * sh.size
        lo = sh.index * b
        return Shard((2 * big_b,) + tuple(x.shape[1:]), 0,
                     _rows(lo, lo + b) + _rows(big_b + lo, big_b + lo + b))

    def per_shard(_):
        return Shard((sh.size,), 0, (sh.index,))

    def walk(t):
        if t is None or isinstance(t, (int, float, bool, str)):
            return None
        if isinstance(t, PooledState):
            return PooledState(envs=map_tree(batch, t.envs), pool=map_tree(ring, t.pool),
                               fresh=ring(t.fresh), tick=None, key=None,
                               n_fresh=per_shard(t.n_fresh), n_stale=per_shard(t.n_stale))
        if isinstance(t, torch.Tensor):
            return batch(t) if t.dim() >= 1 else None
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if dataclasses.is_dataclass(t):
            return type(t)(**{f.name: walk(getattr(t, f.name))
                              for f in dataclasses.fields(t)})
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        raise TypeError(f"batch_shard_tree: no rule for {type(t).__name__}")

    return walk(tree)


class ShardedVectorEnv:
    """A ``VectorEnv`` whose batch axis is sharded over a mesh: this rank
    steps its rows ``shard = (lo, hi)`` of ``num_envs`` (which must divide by
    the mesh size), with the global batch's key stream and pooled ring.

        venv = ShardedVectorEnv(env, 4096, mesh)
        obs, state = venv.reset(key)             # rows [lo, hi) of VectorEnv.reset(key)
        obs, state, reward, term, trunc, info = venv.step(state, action)  # action int32[hi - lo]

    ``venv_kwargs`` go to :class:`VectorEnv` (``reset_strategy``,
    ``pool_refill``, ``strict_refill``, ``final_obs``), and the strategy and
    window default to the global batch's."""

    def __init__(self, env: Env, num_envs: int, mesh=None, params: EnvParams | None = None,
                 auto_reset: bool = True, axis_name: str = "env", device=None,
                 **venv_kwargs):
        self.sharding = batch_sharding(mesh, axis_name)
        self.num_envs = num_envs
        self.shard = self.sharding.rows(num_envs)
        self.params = params if params is not None else env.default_params
        self._inner = VectorEnv(env, num_envs, self.params, auto_reset=auto_reset,
                                device=device, shard=self.shard, **venv_kwargs)
        self.device = self._inner.device

    def __getattr__(self, name: str):
        # reset_strategy, pool_refill, local_envs, step_nofill, refill, ...
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def reset(self, key: torch.Tensor):
        return self._inner.reset(key)

    def step(self, state, action: torch.Tensor):
        return self._inner.step(state, action)

    def ring_counts(self, state: PooledState) -> tuple[int, int]:
        """The pooled ring's auto-resets served fresh and stale, summed over
        the shards (one collective and one host read)."""
        counts = torch.stack([state.n_fresh, state.n_stale]).to(torch.int64)
        if self.sharding.group is not None:
            dist.all_reduce(counts, group=self.sharding.group)
        n_fresh, n_stale = counts.tolist()
        return n_fresh, n_stale


def sharded_rollout(env: Env, params: EnvParams | None, key: torch.Tensor, num_envs: int,
                    num_steps: int, mesh=None, axis_name: str = "env", device=None):
    """B x T random-policy rollout with the batch sharded over the mesh:
    reset from ``split(key)[1]``, then each step's actions from one key of
    ``split(split(key)[0], T)``, drawn over the global ``(B,)`` (this rank
    keeps its rows).  Every step folds the observation into a checksum (the
    timing protocol: no observation is skipped).  Returns the global
    ``(steps executed, total reward, episode ends)`` on every rank: one
    collective at the end."""
    venv = ShardedVectorEnv(env, num_envs, mesh, params, axis_name=axis_name, device=device)
    key, k_reset = rng.split(key.to(venv.device)).unbind(0)
    obs, state = venv.reset(k_reset)
    keys = rng.split(key, num_steps)
    dev = venv.device
    r_sum = torch.zeros((), dtype=torch.float32, device=dev)
    d_sum = torch.zeros((), dtype=torch.int64, device=dev)
    chk = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(num_steps):
        action = rng.randint(keys[t], (num_envs,), 0, env.num_actions, rows=venv.shard)
        obs, state, reward, term, trunc, _ = venv.step(state, action)
        r_sum = r_sum + reward.sum()
        d_sum = d_sum + (term | trunc).sum()
        chk = chk + sum(v.float().sum() for v in obs.values())
    totals = torch.stack([r_sum.double(), d_sum.double(), chk.double()])
    if venv.sharding.group is not None:
        dist.all_reduce(totals, group=venv.sharding.group)
    total_reward, total_dones, _ = totals.tolist()
    return num_envs * num_steps, total_reward, int(total_dones)
