"""Vectorized env batch with auto-reset.

Counterpart of ``minigrid_tpu/parallel/vector.py``: B lockstep envs, each
finished episode replaced on the device by a new level, with no host round
trip.  Two reset strategies are ported:

* ``fused`` (the default): regenerate every env from its own stream each step
  and select the finished ones;
* ``pooled``: consume pre-generated levels from a 2B-slot ring and refill it
  in contiguous windows, in the best-effort mode (an env that finds both of
  its slots spent replays its primary slot's previous level, a "stale
  replay").  ``step_nofill`` + ``refill(K)`` every K steps is the program the
  benchmark drives.

Every random draw comes from the threefry twin, so a run is bitwise the JAX
package's run for the same key and actions.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    map_fields,
    resolve_device,
)


def tree_select(pred: torch.Tensor, a, b):
    """Per-env select over two states of one dataclass type: pred is
    bool[B], fields have leading dim B; ``None`` fields stay ``None``."""

    def sel(x, y):
        return torch.where(pred.view((-1,) + (1,) * (x.dim() - 1)), x, y)

    return map_fields(sel, a, b)


@dataclass
class PooledState:
    """Batch state of the ``pooled`` strategy: the live env batch plus a
    ring of pre-generated, never-used levels.  Slots ``b`` and ``b + B`` both
    serve env ``b``."""

    envs: EnvState  # leading dim B
    pool: EnvState  # leading dim 2B — slots [0, B) primary, [B, 2B) secondary
    fresh: torch.Tensor  # bool[2B] — slot holds an unconsumed level
    tick: torch.Tensor  # int32[] — refill window rotation counter
    key: torch.Tensor  # int64[2] — refill stream
    n_fresh: torch.Tensor  # int32[] — auto-resets served a fresh level
    n_stale: torch.Tensor  # int32[] — auto-resets served a stale replay

    def replace(self, **changes) -> "PooledState":
        return dataclasses.replace(self, **changes)


class VectorEnv:
    """B lockstep instances of one env family on one device.

        obs, state = venv.reset(key)                  # key: int64[2]
        obs, state, reward, terminated, truncated, info = venv.step(state, actions)

    ``step`` auto-resets: the returned obs and state of a finished env belong
    to its new episode, while reward/terminated/truncated report the step that
    ended the old one.
    """

    def __init__(self, env: Env, num_envs: int, params: EnvParams | None = None,
                 reset_strategy: str | None = None,
                 pool_refill: int | None = None, device=None):
        self.env = env
        self.num_envs = num_envs
        self.params = params if params is not None else env.default_params
        self.device = resolve_device(device)
        reset_strategy = reset_strategy or "fused"
        if reset_strategy not in ("fused", "pooled"):
            raise NotImplementedError(
                f"reset_strategy {reset_strategy!r} is not ported yet")
        self.reset_strategy = reset_strategy
        self.pool_size = 2 * num_envs
        if pool_refill is None:
            target = min(2 * num_envs, max(16, num_envs // 16))
            # largest divisor of the ring size not exceeding the target
            pool_refill = max(
                c for c in range(1, target + 1) if (2 * num_envs) % c == 0)
        if reset_strategy == "pooled" and (2 * num_envs) % pool_refill:
            raise ValueError(
                f"pool_refill={pool_refill} must divide 2*num_envs={2 * num_envs}")
        self.pool_refill = pool_refill

    # -- helpers -----------------------------------------------------------
    def _gen_many(self, keys: torch.Tensor) -> EnvState:
        return self.env.generate(keys, self.params, self.device)

    def _obs(self, states: EnvState) -> dict:
        return self.env.observation_batch(states, self.params)

    def _step_envs(self, envs: EnvState, action: torch.Tensor):
        return self.env.step_state(envs, action.to(self.device), self.params)

    # -- API ---------------------------------------------------------------
    def reset(self, key: torch.Tensor):
        key = key.to(self.device)
        b = self.num_envs
        if self.reset_strategy != "pooled":
            envs = self._gen_many(rng.split(key, b))
            return self._obs(envs), envs
        _, k_gen, k_refill = rng.split(key, 3).unbind(0)
        # one generator call covers the envs AND the initial pool fill
        both = self._gen_many(rng.split(k_gen, b + self.pool_size))
        envs = map_fields(lambda x: x[:b], both)
        pool = map_fields(lambda x: x[b:], both)

        def scalar():
            return torch.zeros((), dtype=torch.int32, device=self.device)

        return self._obs(envs), PooledState(
            envs=envs,
            pool=pool,
            fresh=torch.ones((self.pool_size,), dtype=torch.bool,
                             device=self.device),
            tick=scalar(),
            key=k_refill,
            n_fresh=scalar(),
            n_stale=scalar(),
        )

    def step(self, state, action: torch.Tensor):
        if self.reset_strategy != "pooled":
            next_state, reward, terminated, truncated = self._step_envs(
                state, action)
            done = terminated | truncated
            # each env's own stream: regenerate from split(rng)[0]
            keys = rng.split(next_state.rng)[:, 0]
            new_state = tree_select(done, self._gen_many(keys), next_state)
            return self._obs(new_state), new_state, reward, terminated, truncated, {}
        obs, state, reward, terminated, truncated, info = self.step_nofill(
            state, action)
        return obs, self.refill(state, 1), reward, terminated, truncated, info

    def step_nofill(self, state: PooledState, action: torch.Tensor):
        """Pooled step WITHOUT the refill: consume only.  Pair with
        :meth:`refill` every K steps."""
        next_state, reward, terminated, truncated = self._step_envs(
            state.envs, action)
        done = terminated | truncated
        new_envs, flags, d_fresh, d_stale = self._consume(
            state.pool, state.fresh, next_state, done)
        new_state = state.replace(envs=new_envs, fresh=flags,
                                  n_fresh=state.n_fresh + d_fresh,
                                  n_stale=state.n_stale + d_stale)
        return self._obs(new_envs), new_state, reward, terminated, truncated, {}

    def refill(self, state: PooledState, windows: int = 1) -> PooledState:
        """Write ``windows`` refill windows (``windows * pool_refill`` fresh
        levels) to the pool ring in one contiguous block."""
        pool, fresh, tick, key = self._refill_windows(
            state.pool, state.fresh, state.tick, state.key, windows)
        return state.replace(pool=pool, fresh=fresh, tick=tick, key=key)

    # -- pooled internals --------------------------------------------------
    def _consume(self, pool: EnvState, flags: torch.Tensor,
                 next_state: EnvState, done: torch.Tensor):
        """Done envs take a level from their slot pair: primary slot b, else
        secondary b+B, else a stale replay of slot b.  Returns (new envs,
        updated freshness flags, fresh consumes, stale consumes)."""
        b = self.num_envs
        lo = map_fields(lambda p: p[:b], pool)
        hi = map_fields(lambda p: p[b:], pool)
        f_lo, f_hi = flags[:b], flags[b:]
        use_lo = done & f_lo
        use_hi = done & ~f_lo & f_hi
        flags_next = torch.cat([f_lo & ~use_lo, f_hi & ~use_hi])
        served = use_lo | use_hi
        d_fresh = served.sum(dtype=torch.int32)
        d_stale = (done & ~served).sum(dtype=torch.int32)
        fresh_states = tree_select(use_hi, hi, lo)
        return (tree_select(done, fresh_states, next_state), flags_next,
                d_fresh, d_stale)

    def _refill_windows(self, pool: EnvState, flags: torch.Tensor,
                        tick: torch.Tensor, key: torch.Tensor, windows: int):
        """Write ``windows`` contiguous refill windows at the rotating ring
        position and mark them fresh.

        The ring offset is quantized to this call's block size n: a raw
        (tick*C) % 2B offset can sit mid-ring when 1-window refills are mixed
        with bulk refill(K), and a block running past the ring end would
        never refresh the head slots.  Block-aligned offsets always fit."""
        ring, c = self.pool_size, self.pool_refill
        n = min(windows * c, ring)
        if ring % n:
            raise ValueError(
                f"windows*pool_refill={n} must divide the ring size {ring}")
        key, k = rng.split(key).unbind(0)
        off = (tick * c) % ring // n * n if n < ring else torch.zeros_like(tick)
        idx = off.to(torch.int64) + torch.arange(n, device=self.device)
        cand = self._gen_many(rng.split(k, n))
        pool = map_fields(lambda p, x: p.index_copy(0, idx, x), pool, cand)
        flags = flags.index_fill(0, idx, True)
        return pool, flags, tick + windows, key
