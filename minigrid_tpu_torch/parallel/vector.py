"""Vectorized env batch with auto-reset.

Counterpart of ``minigrid_tpu/parallel/vector.py``: B lockstep envs, each
finished episode replaced on the device by a new level.  Three reset
strategies, chosen from the family's class attributes as the JAX package
chooses them unless the caller names one:

* ``fused`` (the default): regenerate every env from its own stream each step
  and select the finished ones; no host round trip;
* ``conditional`` (families with ``expensive_generation``): regenerate only
  when an env finished.  Eager torch has no device-side branch, so the step
  reads ``done`` on the host (one sync) and regenerates just the finished
  envs; the levels are the ones the JAX package's batch-level ``cond``
  gives;
* ``pooled`` (families with ``desynchronized_resets``, from 64 envs):
  consume pre-generated levels from a 2B-slot ring and refill it in
  contiguous windows of ``pool_refill`` (B times the family's
  ``pool_refill_fraction``, 1/16 by default).  In the default best-effort
  mode an env that finds both of its slots spent replays its primary slot's
  previous level (a "stale replay"); with ``strict_refill=True`` it
  regenerates from its own stream instead, and every served level is fresh.
  ``step_nofill`` + ``refill(K)`` every K steps is the program the benchmark
  drives.  A family with ``generate_attempt`` (BabyAI) refills best-effort
  with ONE unvalidated draw a slot: where the draw is invalid the slot keeps
  its previous level, and is marked fresh all the same.  The trace counters
  ``refill.draws`` and ``refill.accepted`` count a refill's draws and the
  slots that took a new level.

A wrapper's state (``wrappers.BonusState``: an ``EnvState`` and a count
table) rides through every strategy: selects and ring copies walk into the
nested dataclass, and regeneration reads the ``rng`` it passes through.  One
case fails, as it does in the JAX package: a bonus wrapper over a family with
``generate_attempt`` on the best-effort pooled refill, where the wrapper
delegates ``generate_attempt`` to the family, whose bare ``EnvState`` cannot
fill a ring of ``BonusState``.  The first refill raises ``ValueError``;
``strict_refill=True`` and ``reset_strategy="conditional"`` run.

``final_obs=True`` adds the observation of the state each step ended in,
before the auto-reset, as ``info["final_obs"]``.  :func:`rollout` drives B
envs for T steps and returns the stacked trajectory.

``shard=(lo, hi)`` runs the envs ``[lo, hi)`` of a batch of ``num_envs`` (a
rank's share of a data-parallel batch, ``parallel/sharding.py``) with the
global batch's geometry, so that the rows it returns are those rows of the
unsharded run, bitwise, with no collective: every key is split from a key
every rank holds, and the rank generates only the levels of the rows and
ring slots it owns.  The pooled ring keeps its global size 2B and refill
window; a rank owns the slots ``[lo, hi)`` and ``[B + lo, B + hi)``, held
locally as its own ``[0, 2b)``, and writes the part of each refill window
that falls in them (possibly none).  The window's position follows the
ring's ``tick``, which a refill advances by its window count: the engine
mirrors it on the host, so a refill reads nothing back.  ``n_fresh`` and
``n_stale`` then count the rank's own auto-resets.

Every random draw comes from the threefry twin, so a run is bitwise the JAX
package's run for the same key and actions.

Tracing (``utils/trace.py``, off by default) sees the public calls as the
spans ``vector.reset``, ``vector.step``, ``vector.step_nofill`` and
``vector.refill``, and inside them ``vector.transition`` (the family's step
and ``post_step``), ``vector.consume`` (the ring's serve), ``vector.observe``
(the observation) and ``vector.generate`` (the generator).
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
from minigrid_tpu_torch.utils import trace


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


def default_strategy(env: Env, num_envs: int) -> str:
    """The reset strategy the JAX package picks for ``env`` at ``num_envs``:
    ``pooled`` for desynchronized episode ends from 64 envs, ``conditional``
    for expensive generation, ``fused`` otherwise."""
    if getattr(env, "desynchronized_resets", False) and num_envs >= 64:
        return "pooled"
    if getattr(env, "expensive_generation", False):
        return "conditional"
    return "fused"


def default_pool_refill(env: Env, num_envs: int) -> int:
    """Refill window of the pooled ring: the largest divisor of the ring
    size 2B not above ``max(16, B * pool_refill_fraction)`` (capped at 2B)."""
    frac = getattr(env, "pool_refill_fraction", 1 / 16)
    target = min(2 * num_envs, max(16, int(num_envs * frac)))
    return max(c for c in range(1, target + 1) if (2 * num_envs) % c == 0)


class VectorEnv:
    """B lockstep instances of one env family on one device.

        obs, state = venv.reset(key)                  # key: int64[2]
        obs, state, reward, terminated, truncated, info = venv.step(state, actions)

    ``step`` auto-resets: the returned obs and state of a finished env belong
    to its new episode, while reward/terminated/truncated report the step that
    ended the old one.  With ``auto_reset=False`` it returns the stepped
    states as they are, finished ones included, and the state is a plain
    ``EnvState`` batch whatever the reset strategy.
    """

    def __init__(self, env: Env, num_envs: int, params: EnvParams | None = None,
                 auto_reset: bool = True, final_obs: bool = False,
                 reset_strategy: str | None = None,
                 pool_refill: int | None = None, strict_refill: bool = False,
                 device=None, shard: tuple[int, int] | None = None):
        self.env = env
        self.num_envs = num_envs
        self.lo, self.hi = shard if shard is not None else (0, num_envs)
        if not 0 <= self.lo < self.hi <= num_envs:
            raise ValueError(f"shard {shard} is not a slice of {num_envs} envs")
        self.local_envs = self.hi - self.lo
        self.params = params if params is not None else env.default_params
        self.device = resolve_device(device)
        self.auto_reset = auto_reset
        self.final_obs = final_obs
        if reset_strategy is None:
            reset_strategy = default_strategy(env, num_envs)
        if reset_strategy not in ("fused", "conditional", "pooled"):
            raise ValueError(f"unknown reset_strategy {reset_strategy!r}")
        self.reset_strategy = reset_strategy
        self._pooled = reset_strategy == "pooled" and auto_reset
        self.pool_size = 2 * num_envs
        if pool_refill is None:
            pool_refill = default_pool_refill(env, num_envs)
        if reset_strategy == "pooled" and (2 * num_envs) % pool_refill:
            raise ValueError(
                f"pool_refill={pool_refill} must divide 2*num_envs={2 * num_envs}")
        self.pool_refill = pool_refill
        self.best_effort = not strict_refill and reset_strategy == "pooled"
        self.best_effort_refill = self.best_effort and hasattr(env, "generate_attempt")
        self._tick_mirror: tuple[torch.Tensor, int] | None = None

    # -- helpers -----------------------------------------------------------
    def _gen_many(self, keys: torch.Tensor) -> EnvState:
        with trace.span("vector.generate"):
            return self.env.generate(keys, self.params, self.device)

    def _obs(self, states: EnvState) -> dict:
        with trace.span("vector.observe"):
            return self.env.observation_batch(states, self.params)

    def _step_envs(self, envs: EnvState, action: torch.Tensor):
        with trace.span("vector.transition"):
            return self.env.step_state(envs, action.to(self.device), self.params)

    def _regen_all(self, ns: EnvState, mask: torch.Tensor) -> EnvState:
        """Every env regenerated from its own stream, kept where ``mask``:
        no host round trip, B-wide generation."""
        keys = rng.split(ns.rng)[:, 0]
        return tree_select(mask, self._gen_many(keys), ns)

    def _regen_some(self, ns: EnvState, mask: torch.Tensor) -> EnvState:
        """The envs of ``mask`` regenerated from their own streams: one host
        read of the mask, then generation for just those envs.  The levels
        are the ones :meth:`_regen_all` gives."""
        idx = mask.nonzero()[:, 0]
        if idx.numel() == 0:
            return ns
        keys = rng.split(ns.rng.index_select(0, idx))[:, 0]
        fresh = self._gen_many(keys)
        return map_fields(lambda x, y: x.index_copy(0, idx, y), ns, fresh)

    def _finish(self, next_state: EnvState, new_state: EnvState, state,
                reward, terminated, truncated):
        info = {"final_obs": self._obs(next_state)} if self.final_obs else {}
        return self._obs(new_state), state, reward, terminated, truncated, info

    # -- API ---------------------------------------------------------------
    def _split_rows(self, key: torch.Tensor, num: int, starts) -> torch.Tensor:
        """This shard's keys of ``split(key, num)``: the rows ``[s + lo, s +
        hi)`` for each start ``s``, in order."""
        parts = [rng.split(key, num, (s + self.lo, s + self.hi)) for s in starts]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def reset(self, key: torch.Tensor):
        with trace.span("vector.reset"):
            key = key.to(self.device)
            b, big_b = self.local_envs, self.num_envs
            if not self._pooled:
                envs = self._gen_many(self._split_rows(key, big_b, (0,)))
                return self._obs(envs), envs
            _, k_gen, k_refill = rng.split(key, 3).unbind(0)
            # one generator call covers the envs AND the initial pool fill: keys
            # [0, B) the envs, [B, 3B) the ring's slots
            both = self._gen_many(self._split_rows(k_gen, big_b + self.pool_size,
                                                   (0, big_b, 2 * big_b)))
            envs = map_fields(lambda x: x[:b], both)
            pool = map_fields(lambda x: x[b:], both)

            def scalar():
                return torch.zeros((), dtype=torch.int32, device=self.device)

            tick = scalar()
            self._tick_mirror = (tick, 0)
            return self._obs(envs), PooledState(
                envs=envs,
                pool=pool,
                fresh=torch.ones((2 * b,), dtype=torch.bool, device=self.device),
                tick=tick,
                key=k_refill,
                n_fresh=scalar(),
                n_stale=scalar(),
            )

    def step(self, state, action: torch.Tensor):
        with trace.span("vector.step"):
            if not self.auto_reset:
                next_state, reward, terminated, truncated = self._step_envs(
                    state, action)
                return (self._obs(next_state), next_state, reward, terminated,
                        truncated, {})
            if not self._pooled:
                next_state, reward, terminated, truncated = self._step_envs(
                    state, action)
                done = terminated | truncated
                # each env's own stream: regenerate from split(rng)[0]
                if self.reset_strategy == "conditional":
                    new_state = self._regen_some(next_state, done)
                else:
                    new_state = self._regen_all(next_state, done)
                return self._finish(next_state, new_state, new_state, reward,
                                    terminated, truncated)
            obs, state, reward, terminated, truncated, info = self.step_nofill(
                state, action)
            return obs, self.refill(state, 1), reward, terminated, truncated, info

    def step_nofill(self, state: PooledState, action: torch.Tensor):
        """Pooled step WITHOUT the refill: consume only.  Pair with
        :meth:`refill` every K steps."""
        with trace.span("vector.step_nofill"):
            next_state, reward, terminated, truncated = self._step_envs(
                state.envs, action)
            done = terminated | truncated
            new_envs, flags, d_fresh, d_stale = self._consume(
                state.pool, state.fresh, next_state, done)
            new_state = state.replace(envs=new_envs, fresh=flags,
                                      n_fresh=state.n_fresh + d_fresh,
                                      n_stale=state.n_stale + d_stale)
            return self._finish(next_state, new_envs, new_state, reward, terminated,
                                truncated)

    def refill(self, state: PooledState, windows: int = 1) -> PooledState:
        """Write ``windows`` refill windows (``windows * pool_refill`` fresh
        levels) to the pool ring in one contiguous block."""
        with trace.span("vector.refill"):
            pool, fresh, tick, key = self._refill_windows(
                state.pool, state.fresh, state.tick, state.key, windows)
            return state.replace(pool=pool, fresh=fresh, tick=tick, key=key)

    # -- pooled internals --------------------------------------------------
    def _consume(self, pool: EnvState, flags: torch.Tensor,
                 next_state: EnvState, done: torch.Tensor):
        """Done envs take a level from their slot pair: primary slot b, else
        secondary b+B, else (best effort) a stale replay of slot b or
        (strict) a level regenerated from the env's own stream.  Returns
        (new envs, updated freshness flags, fresh consumes, stale
        consumes)."""
        with trace.span("vector.consume"):
            b = self.local_envs
            lo = map_fields(lambda p: p[:b], pool)
            hi = map_fields(lambda p: p[b:], pool)
            f_lo, f_hi = flags[:b], flags[b:]
            use_lo = done & f_lo
            use_hi = done & ~f_lo & f_hi
            flags_next = torch.cat([f_lo & ~use_lo, f_hi & ~use_hi])
            served = use_lo | use_hi
            d_fresh = served.sum(dtype=torch.int32)
            fresh_states = tree_select(use_hi, hi, lo)
            if self.best_effort:
                d_stale = (done & ~served).sum(dtype=torch.int32)
                return (tree_select(done, fresh_states, next_state), flags_next,
                        d_fresh, d_stale)
            # strict: an env that missed both slots regenerates, without a host
            # round trip, so every served level is fresh
            uncovered = done & ~served
            new_envs = self._regen_all(tree_select(served, fresh_states, next_state),
                                       uncovered)
            return (new_envs, flags_next, d_fresh + uncovered.sum(dtype=torch.int32),
                    torch.zeros((), dtype=torch.int32, device=done.device))

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
        t = self._host_tick(tick)
        tick = tick + windows
        self._tick_mirror = (tick, t + windows)
        off = (t * c) % ring // n * n if n < ring else 0
        parts = self._owned_window(off, n)
        if not parts:  # the window lies wholly in other shards' slots
            return pool, flags, tick, key
        keys = torch.cat([rng.split(k, n, (p, p + m)) for p, m, _ in parts])
        idx = torch.cat([torch.arange(s, s + m, device=self.device) for _, m, s in parts])
        trace.count("refill.draws", keys.shape[0])
        if self.best_effort_refill:
            with trace.span("vector.generate"):
                cand, ok = self.env.generate_attempt(keys, self.params, self.device)
            trace.count("refill.accepted", ok)
            if type(cand) is not type(pool):
                # as in the JAX package, whose refill fails to trace here
                raise ValueError(
                    f"{type(self.env).__name__}.generate_attempt returns "
                    f"{type(cand).__name__} levels but the ring holds "
                    f"{type(pool).__name__}: a wrapper that extends the state "
                    "(ActionBonus, StateBonus) hands the best-effort refill the "
                    "wrapped family's generate_attempt; use strict_refill=True "
                    "or reset_strategy='conditional'")
            cand = tree_select(ok, cand, map_fields(lambda p: p.index_select(0, idx),
                                                    pool))
        else:
            cand = self._gen_many(keys)
            trace.count("refill.accepted", keys.shape[0])
        pool = map_fields(lambda p, x: p.index_copy(0, idx, x), pool, cand)
        flags = flags.index_fill(0, idx, True)
        return pool, flags, tick, key

    def _host_tick(self, tick: torch.Tensor) -> int:
        """The ring's tick on the host: the mirror of the tick this engine
        last made, else one read of the device (a state made elsewhere, such
        as a restored checkpoint)."""
        if self._tick_mirror is not None and self._tick_mirror[0] is tick:
            return self._tick_mirror[1]
        return int(tick)

    def _owned_window(self, off: int, n: int) -> list[tuple[int, int, int]]:
        """The parts of the ring window ``[off, off + n)`` that fall in this
        shard's slots: (position in the window, length, first local slot)
        for each, at most one in each half of the ring."""
        b, parts = self.local_envs, []
        for base, local in ((self.lo, 0), (self.num_envs + self.lo, b)):
            s0, s1 = max(off, base), min(off + n, base + b)
            if s0 < s1:
                parts.append((s0 - off, s1 - s0, local + s0 - base))
        return parts


def rollout(env: Env, params: EnvParams | None, key: torch.Tensor, num_envs: int,
            num_steps: int, policy=None, refill_period: int = 1, **venv_kwargs):
    """B envs x T steps: reset from ``split(key)[1]``, then one step per key
    of ``split(split(key)[0], T)``.  Returns (final state, trajectory: a dict
    of ``action``, ``reward``, ``terminated``, ``truncated`` stacked
    ``[T, B]``).

    ``policy(key, obs) -> int32[B]`` defaults to uniform random actions.
    ``refill_period=K`` (pooled strategy only) runs T/K blocks of K
    consume-only steps and one K-window refill, as the JAX ``rollout``'s
    nested scan does.  ``venv_kwargs`` go to :class:`VectorEnv` (``device``
    among them)."""
    venv = VectorEnv(env, num_envs, params, **venv_kwargs)
    if policy is None:
        def policy(k, obs):
            return rng.randint(k, (num_envs,), 0, env.num_actions)

    key, k_reset = rng.split(key.to(venv.device)).unbind(0)
    obs, state = venv.reset(k_reset)
    keys = rng.split(key, num_steps)
    if refill_period > 1:
        if not (venv.reset_strategy == "pooled" and venv.auto_reset):
            raise ValueError("refill_period requires the pooled reset strategy")
        if num_steps % refill_period:
            raise ValueError(f"num_steps={num_steps} is not a multiple of "
                             f"refill_period={refill_period}")
        n = min(refill_period * venv.pool_refill, 2 * num_envs)
        if (2 * num_envs) % n:
            raise ValueError(
                f"refill_period*pool_refill = {refill_period * venv.pool_refill} "
                f"must divide the pool ring size {2 * num_envs} (or exceed it)")
    traj = {name: [] for name in ("action", "reward", "terminated", "truncated")}
    for t in range(num_steps):
        action = policy(keys[t], obs)
        if refill_period > 1:
            obs, state, reward, terminated, truncated, _ = venv.step_nofill(
                state, action)
            if (t + 1) % refill_period == 0:
                state = venv.refill(state, refill_period)
        else:
            obs, state, reward, terminated, truncated, _ = venv.step(state, action)
        for name, v in zip(traj, (action, reward, terminated, truncated)):
            traj[name].append(v)
    return state, {name: torch.stack(v) for name, v in traj.items()}
