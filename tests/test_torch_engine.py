"""The rest of the port's batch engine and the core pieces the zoo needs,
against the JAX package, bitwise.

The engine: the ``conditional`` strategy (regenerating only finished envs),
the pooled ring with ``strict_refill`` (every served level fresh,
``n_stale`` 0), ``final_obs``, and ``rollout`` with and without
``refill_period``.  The core: ``rng.permutation``, the new ``grid_ops``,
``sampling``, ``MissionSpace`` and the state bridge's ``extra``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu
from minigrid_tpu.core import grid_ops as JG
from minigrid_tpu.core import mission as JM
from minigrid_tpu.core import sampling as JS
from minigrid_tpu.core.state import EnvState as JEnvState
from minigrid_tpu.core.state import empty_grid as j_empty_grid
from minigrid_tpu.parallel.vector import VectorEnv as JVectorEnv
from minigrid_tpu.parallel.vector import rollout as jrollout

import minigrid_tpu_torch
from minigrid_tpu_torch.core import grid_ops as TG
from minigrid_tpu_torch.core import mission as TM
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core import sampling as TS
from minigrid_tpu_torch.core.state import empty_grid
from minigrid_tpu_torch.parallel.vector import PooledState

from tests.test_torch_bridge import assert_state_equal, random_packed, to_port
from tests.test_torch_zoo_step import lockstep
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CPU = torch.device("cpu")


def _keys(n: int, seed: int):
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


def _eq(got: torch.Tensor, want, what: str = "") -> None:
    w = np.asarray(want)
    g = got.numpy()
    if w.dtype == np.uint32:  # the JAX package's word type; the port's is int32
        w = w.astype(np.int64)
        g = g.astype(np.int64)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


# -- core ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 10, 20, 1700])
def test_permutation_matches_jax(n):
    """One round below about 1,600 elements, two at 1,700; batched keys."""
    jk, tk = _keys(6, seed=n)
    want = jax.vmap(lambda k: jax.random.permutation(k, n))(jk)
    got = rng.permutation(tk, n)
    _eq(got, want, f"n={n}")
    assert sorted(got[0].tolist()) == list(range(n))
    # one key, and keys with two leading dims
    _eq(rng.permutation(tk[2], n), jax.random.permutation(jk[2], n))
    _eq(rng.permutation(tk.reshape(2, 3, 2), n), np.asarray(want).reshape(2, 3, n))


def test_take_helpers_match_jax():
    """take1 / take_row / take_vec: values, dtypes (take1 the promoted sum
    dtype) and 0 for an index outside the table, on shared and per-env
    tables."""
    r = np.random.default_rng(0)
    table = r.integers(-50, 50, (16, 7)).astype(np.int32)
    mats = r.integers(-50, 50, (16, 7, 2)).astype(np.int32)
    idx = r.integers(-2, 9, 16).astype(np.int32)  # some outside [0, 7)
    idxs = r.integers(-1, 8, (16, 3)).astype(np.int32)
    flags = r.random((16, 7)) < 0.5
    jt = jax.jit(jax.vmap(lambda v, m, f, i, ii: (
        JG.take1(v, i), JG.take_row(m, i), JG.take_vec(v, ii), JG.take1(f, i))))
    w1, wrow, wvec, wflag = jt(table, mats, flags, idx, idxs)
    t = torch.from_numpy
    _eq(TG.take1(t(table), t(idx)), w1, "take1")
    _eq(TG.take_row(t(mats), t(idx)), wrow, "take_row")
    _eq(TG.take_vec(t(table), t(idxs)), wvec, "take_vec")
    _eq(TG.take1(t(flags), t(idx)), wflag, "take1 of bools")
    # a shared table, indexed per env
    shared = table[0]
    want = jax.vmap(lambda i, ii: (JG.take1(shared, i), JG.take_vec(shared, ii)))(
        idx, idxs)
    _eq(TG.take1(t(shared), t(idx)), want[0], "shared take1")
    _eq(TG.take_vec(t(shared), t(idxs)), want[1], "shared take_vec")


@pytest.mark.parametrize("w,h", [(8, 8), (9, 5)])
def test_new_builders_match_jax(w, h):
    """types/colors/states, read_cell, put_if and the line walls with
    per-grid tensor coordinates (as LavaGap passes a drawn column)."""
    r = np.random.default_rng(w * h)
    n = 12
    grid = random_packed(r, (n, w, h))
    x = r.integers(0, w, n).astype(np.int32)
    y = r.integers(0, h, n).astype(np.int32)
    ln = r.integers(0, max(w, h) + 1, n).astype(np.int32)
    on = r.random(n) < 0.5
    cell = np.asarray([5, 4, 0], np.uint8)

    def jbuild(g, x, y, ln, on):
        g2 = JG.put_if(g, x, y, cell, on)
        g2 = JG.horz_wall(g2, x, y, ln)
        g2 = JG.vert_wall(g2, y % w, x % h, ln, np.asarray([9, 0, 0], np.uint8))
        g3 = JG.horz_wall(j_empty_grid(w, h), x, y)  # to the right edge
        g3 = JG.vert_wall(g3, x, y)  # to the bottom edge
        return (g2, g3, JG.read_cell(g, x, y), JG.types(g), JG.colors(g),
                JG.states(g))

    want = jax.jit(jax.vmap(jbuild))(grid, x, y, ln, on)
    t = {k: torch.from_numpy(v) for k, v in
         dict(g=grid.astype(np.int32), x=x, y=y, ln=ln, on=on).items()}
    g2 = TG.put_if(t["g"], t["x"], t["y"], cell, t["on"])
    g2 = TG.horz_wall(g2, t["x"], t["y"], t["ln"])
    g2 = TG.vert_wall(g2, t["y"] % w, t["x"] % h, t["ln"], (9, 0, 0))
    g3 = TG.horz_wall(empty_grid(w, h, CPU, (n,)), t["x"], t["y"])
    g3 = TG.vert_wall(g3, t["x"], t["y"])
    got = (g2, g3, TG.read_cell(t["g"], t["x"], t["y"]), TG.types(t["g"]),
           TG.colors(t["g"]), TG.states(t["g"]))
    for name, g, wv in zip(("put_if+walls", "walls to the edge", "read_cell",
                            "types", "colors", "states"), got, want):
        _eq(g, wv, name)
    # Python-int coordinates on one grid
    one = TG.vert_wall(TG.horz_wall(empty_grid(w, h, CPU), 1, 2, 3), 4, 0)
    ref = JG.vert_wall(JG.horz_wall(j_empty_grid(w, h), 1, 2, 3), 4, 0)
    _eq(one, ref, "static walls")


def test_rect_mask_and_place_obj_take_per_grid_tensors():
    """The search rectangle per grid (MultiRoom places in drawn rooms), top
    clamped at 0 and extent clamped to the grid."""
    r = np.random.default_rng(3)
    n, w, h = 24, 9, 7
    top = r.integers(-2, 8, (n, 2)).astype(np.int32)
    size = r.integers(0, 9, (n, 2)).astype(np.int32)
    grid = random_packed(r, (n, w, h))
    grid[..., 2:5, :] = TG.pack_word((1, 0, 0))  # some empty cells
    jk, tk = _keys(n, 9)

    def jplace(k, g, tp, sz):
        mask = JG.rect_mask(w, h, (tp[0], tp[1]), (sz[0], sz[1]))
        return (mask,) + JG.place_obj(k, g, np.asarray([5, 2, 0], np.uint8),
                                      top=(tp[0], tp[1]), size=(sz[0], sz[1]))

    want = jax.jit(jax.vmap(jplace))(jk, grid, top, size)
    tt, ts = torch.from_numpy(top), torch.from_numpy(size)
    mask = TG.rect_mask(w, h, (tt[:, 0], tt[:, 1]), (ts[:, 0], ts[:, 1]), CPU)
    got = (mask,) + TG.place_obj(tk, torch.from_numpy(grid.astype(np.int32)), (5, 2, 0),
                                 top=(tt[:, 0], tt[:, 1]), size=(ts[:, 0], ts[:, 1]))
    for name, g, wv in zip(("mask", "grid", "pos", "ok"), got, want):
        _eq(g, wv, name)
    assert got[3].any() and not got[3].all()
    # mixed: an int top with per-grid sizes
    want = jax.vmap(lambda sz: JG.rect_mask(w, h, (1, 2), (sz[0], sz[1])))(size)
    _eq(TG.rect_mask(w, h, (1, 2), (ts[:, 0], ts[:, 1]), CPU), want, "mixed")


def test_sample_two_distinct_matches_jax():
    r = np.random.default_rng(4)
    n, w, h = 32, 6, 5
    mask = r.random((n, w, h)) < np.linspace(0, 0.6, n)[:, None, None]
    mask[0] = False
    mask[1] = False
    mask[1, 2, 3] = True  # one cell: ok False, positions as JAX draws them
    jk, tk = _keys(n, 5)
    want = jax.jit(jax.vmap(JG.sample_two_distinct))(jk, mask)
    got = TG.sample_two_distinct(tk, torch.from_numpy(mask))
    for name, g, wv in zip(("pos1", "pos2", "ok"), got, want):
        _eq(g, wv, name)
    ok = got[2].numpy()
    assert not ok[0] and not ok[1] and ok[-1]
    assert (got[0][ok] != got[1][ok]).any(dim=1).all()


def test_sampling_matches_jax():
    jk, tk = _keys(64, 6)
    types = np.asarray([5, 6, 7], np.int32)

    def jdraw(k):
        return (JS.rand_color(k), JS.rand_type_color(k, types),
                JS.distinct_type_colors(k, 4, types))

    want = jax.jit(jax.vmap(jdraw))(jk)
    got = (TS.rand_color(tk), TS.rand_type_color(tk, types),
           TS.distinct_type_colors(tk, 4, types))
    for name, g, wv in zip(("rand_color", "rand_type_color", "distinct"), got, want):
        _eq(g, wv, name)
    _eq(torch.from_numpy(TS.SORTED_COLOR_IDS), JS.SORTED_COLOR_IDS)
    pairs = got[2].numpy()
    assert all(len({tuple(p) for p in row}) == 4 for row in pairs)
    with pytest.raises(ValueError):
        TS.distinct_type_colors(tk, 31, types)


def test_mission_space_matches_jax():
    def two(color, obj):
        return f"get the {color} {obj}"

    holders = [["red", "green", "blue"], ["ball", "key", "box", "blue ball"]]
    for seed in (0, 1, 7):
        got = TM.MissionSpace(two, holders, seed=seed)
        want = JM.MissionSpace(two, holders, seed=seed)
        assert [got.sample() for _ in range(8)] == [want.sample() for _ in range(8)]
    got, want = TM.MissionSpace(two, holders), JM.MissionSpace(two, holders)
    for text in ("get the red ball", "get the blue blue ball", "get the red box",
                 "get the pink ball", "get a red ball", "", "get the green key"):
        assert got.contains(text) == want.contains(text), text
    fixed = TM.MissionSpace(lambda: "reach the goal")
    assert fixed.contains("reach the goal") and not fixed.contains("x")
    assert fixed.sample() == "reach the goal"
    assert got == TM.MissionSpace(two, [holders[0][::-1], holders[1]])
    assert got != fixed and got != TM.MissionSpace(two, [["red"], holders[1]])
    baby = TM.BabyAIMissionSpace()
    assert baby.sample() == JM.BabyAIMissionSpace().sample()
    assert baby.contains("pick up the box") and not baby.contains(3)
    with pytest.raises(ValueError):
        TM.MissionSpace(two, [holders[0]])
    with pytest.raises(ValueError):
        TM.MissionSpace(two, [["red", "red"], holders[1]])


@pytest.mark.parametrize("kind", ["array", "dict", "nested"])
def test_state_bridge_carries_extra(kind):
    """extra as an array, a dict and a nested dict: JAX -> port -> numpy,
    int32 throughout."""
    r = np.random.default_rng(8)
    b = 5
    arr = lambda *s: jnp.asarray(r.integers(-9, 30, (b,) + s).astype(np.int32))  # noqa: E731
    extra = {"array": arr(3, 2),
             "dict": {"red_pos": arr(2), "blue_pos": arr(2)},
             "nested": {"move": arr(2), "deep": {"cells": arr(4, 2)}}}[kind]
    jst = JEnvState(
        grid=jnp.asarray(random_packed(r, (b, 5, 5))), box_contains=None,
        agent_pos=arr(2), agent_dir=arr(), carrying=jnp.zeros((b, 3), jnp.uint8),
        carrying_contains=None, step_count=arr(), terminated=jnp.zeros(b, bool),
        truncated=jnp.zeros(b, bool), rng=jax.random.split(jax.random.PRNGKey(0), b),
        mission=arr(4), max_steps=arr(), extra=extra)
    port = to_port(jst)
    assert_state_equal(port, jst)
    leaves = [port.extra]
    while isinstance(leaves[-1], dict):
        leaves.append(leaves[-1][sorted(leaves[-1])[-1]])
    assert leaves[-1].dtype == torch.int32


# -- the batch engine -----------------------------------------------------------

def test_conditional_with_final_obs_matches_jax():
    """``conditional`` regenerates only when an env finished: steps with no
    finished env leave the states as they are.  final_obs is the
    observation before the auto-reset."""
    env_id, b = "MiniGrid-LavaGapS5-v0", 16
    jenv = minigrid_tpu.make(env_id, max_steps=6)
    jvenv = JVectorEnv(jenv, b, reset_strategy="conditional", final_obs=True)
    venv = minigrid_tpu_torch.make_vec(env_id, b, device="cpu", max_steps=6,
                                       reset_strategy="conditional", final_obs=True)
    assert venv.reset_strategy == "conditional"
    rewards, ends, st, jst = lockstep(jvenv, venv, 11, 14, num_actions=2)
    assert_state_equal(st, jst, "final: ")
    assert ends >= b


@pytest.mark.parametrize("strict", [False, True])
def test_pooled_refill_modes_match_jax(strict):
    """PutNear (box planes, a dict ``extra``) through the pooled ring, with
    windows too small to keep up: best effort replays stale levels, strict
    regenerates them, so every served level is fresh and n_stale stays 0.
    final_obs on the pooled step too."""
    env_id, b = "MiniGrid-PutNear-6x6-N2-v0", 16
    jenv = minigrid_tpu.make(env_id, max_steps=3)
    kw = dict(reset_strategy="pooled", pool_refill=2, strict_refill=strict,
              final_obs=True)
    jvenv = JVectorEnv(jenv, b, **kw)
    venv = minigrid_tpu_torch.make_vec(env_id, b, device="cpu", max_steps=3, **kw)
    assert venv.best_effort == (not strict)
    rewards, ends, st, jst = lockstep(jvenv, venv, 12, 12)
    assert isinstance(st, PooledState)
    assert_state_equal(st, jst, "final: ")
    assert isinstance(st.envs.extra, dict) and st.pool.extra["move"].shape == (2 * b, 2)
    n_fresh, n_stale = int(st.n_fresh), int(st.n_stale)
    assert n_fresh + n_stale == ends
    if strict:
        assert n_stale == 0 and n_fresh == ends
    else:
        assert n_stale > 0


def _assert_traj_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in got:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k == "reward":
            g, w = g.view(np.int32), w.view(np.int32)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_rollout_with_refill_period_matches_jax():
    """T/K blocks of K consume-only steps and one K-window refill: the whole
    [T, B] trajectory and the final ring."""
    env_id, b, t = "MiniGrid-LavaGapS6-v0", 16, 16
    jenv = minigrid_tpu.make(env_id, max_steps=5)
    kw = dict(reset_strategy="pooled", pool_refill=4)
    jst, jtraj = jrollout(jenv, jenv.default_params, jax.random.PRNGKey(3), b, t,
                          refill_period=4, **kw)
    env = minigrid_tpu_torch.make(env_id, max_steps=5)
    st, traj = minigrid_tpu_torch.rollout(env, None, rng.PRNGKey(3, CPU), b, t,
                                          refill_period=4, device="cpu", **kw)
    assert traj["action"].shape == (t, b) and traj["reward"].dtype == torch.float32
    _assert_traj_equal(traj, jtraj)
    assert_state_equal(st, jst, "final: ")
    assert int(st.n_fresh) > 0
    with pytest.raises(ValueError):
        minigrid_tpu_torch.rollout(env, None, rng.PRNGKey(3, CPU), b, t,
                                   refill_period=4, device="cpu")  # not pooled
    with pytest.raises(ValueError):
        minigrid_tpu_torch.rollout(env, None, rng.PRNGKey(3, CPU), b, 18,
                                   refill_period=4, device="cpu", **kw)


def test_rollout_default_policy_matches_jax():
    """The default strategy and the default uniform policy, step by step."""
    env_id, b, t = "MiniGrid-LavaGapS5-v0", 16, 20
    jenv = minigrid_tpu.make(env_id, max_steps=7)
    jst, jtraj = jrollout(jenv, jenv.default_params, jax.random.PRNGKey(8), b, t)
    env = minigrid_tpu_torch.make(env_id, max_steps=7)
    st, traj = minigrid_tpu_torch.rollout(env, env.default_params,
                                          rng.PRNGKey(8, CPU), b, t, device="cpu")
    _assert_traj_equal(traj, jtraj)
    assert_state_equal(st, jst, "final: ")
    assert bool((traj["terminated"] | traj["truncated"]).any())


def test_unknown_strategy_raises():
    with pytest.raises(ValueError):
        minigrid_tpu_torch.make_vec("MiniGrid-LavaGapS5-v0", 4, device="cpu",
                                    reset_strategy="lazy")
