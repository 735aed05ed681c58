"""The port's multi-device env layer on gloo ranks, against its unsharded
engine and the JAX package's ``ShardedVectorEnv``.

* ``ShardedVectorEnv`` on 2 and 4 ranks (``multihost.spawn``; the rank bodies
  are ``tests/torch_ranks.py``) is bitwise the port's unsharded ``VectorEnv``
  through the auto-resets: every observation, reward bit, flag and the final
  state, the pooled ring put back together from the ranks' slots.  The cases:
  DoorKey-8x8 pooled with 2-level windows and a bulk refill of 4 windows,
  whose windows straddle the ranks; the same with 1-window refills, whose
  windows fall wholly in one rank's slots; ``conditional``; BabyAI-GoTo
  pooled with the best-effort refill; ``fused``.  The ring's tick and the
  fresh/stale counts summed over the ranks are the unsharded ones.
* DoorKey-8x8 at B=64 on 4 ranks against JAX's ``ShardedVectorEnv`` on the
  8-device farm (``tests/test_sharding.py:28-37``).
* ``sharded_rollout`` against the unsharded ``rollout``: steps and episode
  ends equal, the reward within 1e-3 (``tests/test_sharding.py:40-51``).
* ``initialize``, ``pod_mesh``, ``process_local_slice``; the rows of a
  global draw against ``jax.random``; ``bench_sharded.sweep``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu
from minigrid_tpu.parallel.multihost import process_local_slice as j_process_local_slice
from minigrid_tpu.parallel.sharding import ShardedVectorEnv as JShardedVectorEnv
from minigrid_tpu.parallel.sharding import env_mesh as j_env_mesh

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.parallel import multihost
from minigrid_tpu_torch.parallel.vector import rollout

from tests.test_torch_bridge import jax_to_numpy
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)
from tests.torch_ranks import env_walk, run_all

CPU = torch.device("cpu")

# (env id, make overrides, VectorEnv options, B, steps, refill period)
WALKS = {
    "doorkey_bulk": ("MiniGrid-DoorKey-8x8-v0", {"max_steps": 6},
                     {"reset_strategy": "pooled", "pool_refill": 2}, 8, 16, 4),
    "doorkey_step": ("MiniGrid-DoorKey-8x8-v0", {"max_steps": 5},
                     {"reset_strategy": "pooled", "pool_refill": 2}, 8, 12, 1),
    "conditional": ("MiniGrid-Empty-5x5-v0", {"max_steps": 4},
                    {"reset_strategy": "conditional"}, 8, 10, 1),
    "babyai_goto": ("BabyAI-GoTo-v0", {"max_steps": 3},
                    {"reset_strategy": "pooled", "pool_refill": 2}, 8, 7, 1),
    "fused": ("MiniGrid-DoorKey-5x5-v0", {"max_steps": 5}, {}, 8, 12, 1),
}
RANKS = {4: ("doorkey_bulk", "conditional", "babyai_goto", "fused"),
         2: ("doorkey_bulk", "doorkey_step", "conditional")}
JAX_CASE = dict(env_id="MiniGrid-DoorKey-8x8-v0", make_kwargs={}, venv_kwargs={},
                num_envs=64, steps=3, seed=4)
ROLLOUT = ("MiniGrid-Empty-5x5-v0", 32, 20, 5)  # tests/test_sharding.py's


def _walk_kwargs(case: str) -> dict:
    env_id, make_kwargs, venv_kwargs, b, steps, period = WALKS[case]
    return dict(env_id=env_id, make_kwargs=make_kwargs, venv_kwargs=venv_kwargs,
                num_envs=b, steps=steps, refill_period=period)


@pytest.fixture(scope="module")
def rank_runs():
    """One spawn of 4 ranks and one of 2, each running its walks, the
    rollout totals and (4 ranks) the JAX case and the mesh facts: {n: {what:
    [rank results]}}."""
    out = {}
    for n, cases in RANKS.items():
        calls = [("env_walk", _walk_kwargs(c)) for c in cases]
        calls.append(("rollout_totals", dict(zip(("env_id", "num_envs", "steps", "seed"),
                                                 ROLLOUT))))
        if n == 4:
            calls += [("env_walk", JAX_CASE), ("mesh_facts", {})]
        per_rank = multihost.spawn(run_all, n, (calls,), backend="gloo")
        names = list(cases) + ["rollout", "jax_case", "mesh"][:len(calls) - len(cases)]
        out[n] = {name: [r[i] for r in per_rank] for i, name in enumerate(names)}
    return out


# -- putting the ranks' rows back together ---------------------------------------------------

def _cat(parts: list, axis: int):
    if parts[0] is None:
        return None
    if isinstance(parts[0], dict):
        return {k: _cat([p[k] for p in parts], axis) for k in parts[0]}
    return np.concatenate(parts, axis)


def _ring(parts: list):
    """The ranks' local rings ``[2b]`` -> the global ``[2B]``: slots
    ``[lo, hi)`` then ``[B + lo, B + hi)`` of each."""
    if parts[0] is None:
        return None
    if isinstance(parts[0], dict):
        return {k: _ring([p[k] for p in parts]) for k in parts[0]}
    b = parts[0].shape[0] // 2
    return np.concatenate([p[:b] for p in parts] + [p[b:] for p in parts])


def gather_state(states: list) -> dict:
    if "envs" not in states[0]:
        return _cat(states, 0)
    for name in ("tick", "key"):  # replicated
        for s in states[1:]:
            np.testing.assert_array_equal(s[name], states[0][name], err_msg=name)
    return {"envs": _cat([s["envs"] for s in states], 0),
            "pool": _ring([s["pool"] for s in states]),
            "fresh": _ring([s["fresh"] for s in states]),
            "tick": states[0]["tick"], "key": states[0]["key"]}


def assert_tree_equal(got, want, where: str = "") -> None:
    if want is None:
        assert got is None, where
        return
    if isinstance(want, dict):
        assert set(got) >= set(want), (where, set(want) - set(got))
        for k in want:
            assert_tree_equal(got[k], want[k], f"{where}{k}.")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=where)


# -- ShardedVectorEnv against the unsharded engine --------------------------------------------

@pytest.mark.parametrize("n,case", [(n, c) for n, cases in RANKS.items() for c in cases])
def test_sharded_walk_is_the_unsharded_walk(rank_runs, n, case):
    """Every observation, reward bit, flag and the final state bitwise, the
    ranks' rows and ring slots put together; the tick and the fresh/stale
    counts over every rank equal the unsharded ones."""
    ranks = rank_runs[n][case]
    want = env_walk(**_walk_kwargs(case), sharded=False)
    b = WALKS[case][3] // n
    assert [r["shard"] for r in ranks] == [(i * b, (i + 1) * b) for i in range(n)]
    assert {r["strategy"] for r in ranks} == {want["strategy"]}
    for k in ("obs", "reward", "terminated", "truncated"):
        assert_tree_equal(_cat([r[k] for r in ranks], 1), want[k], f"{case} {k} ")
    assert_tree_equal(gather_state([r["state"] for r in ranks]),
                      {k: v for k, v in want["state"].items()
                       if k not in ("n_fresh", "n_stale")}, f"{case} state ")
    assert bool(want["terminated"].any() | want["truncated"].any())  # resets happened
    if "tick" in want:
        assert {r["tick"] for r in ranks} == {want["tick"]}
        assert {tuple(r["ring"]) for r in ranks} == {tuple(want["ring"])}
        assert sum(want["ring"]) > 0


def test_windows_straddle_ranks_and_miss_ranks():
    """The cases above exercise both sides of the ring ownership: a bulk
    window of 8 slots covers 2 slots of each of 4 ranks, a 1-window refill
    of 2 slots lies wholly in one of 2 ranks' slots."""
    env = mgt.make("MiniGrid-DoorKey-8x8-v0")
    from minigrid_tpu_torch.parallel.vector import VectorEnv

    four = [VectorEnv(env, 8, reset_strategy="pooled", pool_refill=2, device=CPU,
                      shard=(2 * r, 2 * r + 2)) for r in range(4)]
    assert [len(v._owned_window(0, 8)) for v in four] == [1, 1, 1, 1]
    two = [VectorEnv(env, 8, reset_strategy="pooled", pool_refill=2, device=CPU,
                     shard=(4 * r, 4 * r + 4)) for r in range(2)]
    assert [v._owned_window(4, 2) for v in two] == [[], [(0, 2, 0)]]
    assert [v._owned_window(10, 2) for v in two] == [[(0, 2, 6)], []]


def test_sharded_vector_env_matches_jax_on_the_farm(rank_runs):
    """DoorKey-8x8 at B=64: 4 ranks against JAX's ``ShardedVectorEnv`` over
    8 devices, from one key and the same actions, bitwise."""
    ranks = rank_runs[4]["jax_case"]
    c = JAX_CASE
    env = minigrid_tpu.make(c["env_id"])
    venv = JShardedVectorEnv(env, c["num_envs"], mesh=j_env_mesh(jax.devices()[:8]))
    key, k_reset = jax.random.split(jax.random.PRNGKey(c["seed"]))
    obs, state = venv.reset(k_reset)
    keys = jax.random.split(key, c["steps"])
    got_obs = _cat([r["obs"] for r in ranks], 1)
    for t in range(c["steps"] + 1):
        if t:
            action = jax.random.randint(keys[t - 1], (c["num_envs"],), 0, env.num_actions,
                                        dtype=jnp.int32)
            obs, state, reward, *_ = venv.step(state, action)
            np.testing.assert_array_equal(
                _cat([r["reward"] for r in ranks], 1)[t - 1],
                np.asarray(reward).view(np.int32))
        for k in ("image", "direction", "mission"):
            np.testing.assert_array_equal(got_obs[k][t], np.asarray(obs[k]), err_msg=k)
    assert len(state.grid.sharding.device_set) == 8
    assert_tree_equal(gather_state([r["state"] for r in ranks]),
                      {k: v for k, v in jax_to_numpy(state).items()
                       if k not in ("n_fresh", "n_stale")}, "state ")


@pytest.mark.parametrize("n", sorted(RANKS))
def test_sharded_rollout_matches_the_unsharded_rollout(rank_runs, n):
    env_id, b, steps, seed = ROLLOUT
    totals = rank_runs[n]["rollout"]
    assert len({tuple(t) for t in totals}) == 1  # every rank reports the global totals
    env = mgt.make(env_id)
    _, traj = rollout(env, None, rng.PRNGKey(seed, CPU), b, steps, device=CPU)
    got_steps, got_reward, got_dones = totals[0]
    assert got_steps == b * steps
    assert got_dones == int((traj["terminated"] | traj["truncated"]).sum())
    assert abs(got_reward - float(traj["reward"].sum())) < 1e-3


# -- multihost --------------------------------------------------------------------------------

def test_initialize_pod_mesh_and_local_slice_on_ranks(rank_runs):
    facts = rank_runs[4]["mesh"]
    assert [f["rank"] for f in facts] == [0, 1, 2, 3]
    for r, f in enumerate(facts):
        assert f["initialize"] is True and f["world"] == 4 and f["backend"] == "gloo"
        assert f["mesh_shape"] == {"dp": 2, "tp": 2}
        assert f["flat_shape"] == {"dp": 4, "tp": 1}
        assert tuple(f["coords"]) == (r // 2, r % 2)  # a tp group is consecutive ranks
        assert tuple(f["slice16"]) == (4 * r, 4)


def test_single_process_initialize_and_slice(monkeypatch):
    """No process group and no torchrun environment: ``initialize`` returns
    False and a process owns the whole batch axis, as JAX's single process
    does."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert multihost.process_local_slice(16) == j_process_local_slice(16) == (0, 16)


def test_initialize_refuses_a_partial_torchrun_environment(monkeypatch):
    for var in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="incomplete"):
        multihost.initialize()
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("127.0.0.1:1234")


def test_nccl_with_more_ranks_than_cards_names_gloo(monkeypatch):
    """NCCL refuses two ranks on one card: asking for it raises before any
    group starts, and names the backend that shares a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        multihost.initialize("127.0.0.1:1", 2, 0, backend="nccl")
    assert multihost._backend(None, 2) == "gloo"


# -- the rows of a global draw --------------------------------------------------------------

@pytest.mark.parametrize("rows", [(0, 3), (3, 8), (5, 6)])
def test_global_draw_rows_match_jax(rows):
    """A rank's rows of ``randint``, ``categorical_one_key`` and ``split``
    over the global shape are those rows of ``jax.random``'s draw, exactly."""
    lo, hi = rows
    key = jax.random.PRNGKey(21)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    want = np.asarray(jax.random.randint(key, (8,), 0, 7, dtype=jnp.int32))
    np.testing.assert_array_equal(rng.randint(tkey, (8,), 0, 7, rows=rows).numpy(),
                                  want[lo:hi])
    logits = np.random.default_rng(2).normal(size=(8, 7)).astype(np.float32)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
    got = rng.categorical_one_key(tkey, torch.from_numpy(logits[lo:hi]), rows, 8)
    np.testing.assert_array_equal(got.numpy(), want[lo:hi])
    np.testing.assert_array_equal(rng.split(tkey, 8, rows).numpy(),
                                  np.asarray(jax.random.split(key, 8))[lo:hi].astype(np.int64))


def test_bench_sharded_sweep():
    """The weak-scaling sweep on 1 and 2 gloo ranks, rows as
    ``tests/test_sharding.py::test_bench_sharded_sweep`` asserts them."""
    from minigrid_tpu_torch.tools.bench_sharded import sweep

    rows = sweep("MiniGrid-Empty-5x5-v0", [1, 2], envs_per_device=4, num_steps=8,
                 verbose=False, device="cpu")
    assert [r["n_devices"] for r in rows] == [1, 2]
    assert all(r["steps_per_sec"] > 0 for r in rows)
    assert rows[0]["efficiency"] == 1.0
