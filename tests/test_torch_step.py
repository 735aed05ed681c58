"""The port's ``base_step`` in lockstep with the JAX transition.

Bridged states step side by side under the same random actions (all eight)
for 64 steps, the pattern of ``tests/test_fused.py``; every state field, the
reward, terminated, truncated and the step outcome must agree exactly.  The
reward is one float32 divide, multiply and subtract in the same order on both
sides, so it is compared bitwise too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu
from minigrid_tpu.core import constants as JC
from minigrid_tpu.core.grid_ops import pack_np
from minigrid_tpu.core.state import EnvParams as JParams
from minigrid_tpu.core.state import EnvState as JEnvState
from minigrid_tpu.core.step import base_step as j_base_step

from minigrid_tpu_torch.core import step as TS
from minigrid_tpu_torch.core.state import EnvParams
from minigrid_tpu_torch.utils.convert import state_to_numpy

from tests.test_torch_bridge import assert_state_equal, to_port
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

STEPS = 64
T = JC.OBJECT_TO_IDX


def _lockstep(jstate, jparams: JParams, params: EnvParams, seed: int) -> dict:
    """Step both sides STEPS times; returns counts of what happened so the
    caller can check the rollout exercised the branches it is meant to."""
    jstep = jax.jit(jax.vmap(lambda s, a: j_base_step(s, a, jparams)))
    port = to_port(jstate)
    b = np.asarray(jstate.agent_dir).shape[0]
    r = np.random.default_rng(seed)
    seen = dict(moved=0, picked_up=0, dropped=0, toggled_door=0, goal=0, trunc=0)
    for t in range(STEPS):
        a = r.integers(0, 8, b).astype(np.int32)
        jstate, jr, jterm, jtrunc, jout = jstep(jstate, jnp.asarray(a))
        port, pr, pterm, ptrunc, pout = TS.base_step(port, torch.from_numpy(a), params)
        where = f"step {t}: "
        assert_state_equal(port, jstate, where)
        assert pr.dtype == torch.float32
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr), err_msg=where)
        np.testing.assert_array_equal(pterm.numpy(), np.asarray(jterm), err_msg=where)
        np.testing.assert_array_equal(ptrunc.numpy(), np.asarray(jtrunc), err_msg=where)
        for f in ("fwd_pos", "fwd_cell", "moved", "picked_up", "dropped",
                  "toggled_door", "prev_carrying"):
            got = getattr(pout, f).numpy()
            want = np.asarray(getattr(jout, f))
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=where + f)
        for f in ("moved", "picked_up", "dropped", "toggled_door"):
            seen[f] += int(np.asarray(getattr(jout, f)).sum())
        seen["goal"] += int((np.asarray(jr) > 0).sum())
        seen["trunc"] += int(np.asarray(jtrunc).sum())
    return seen


def test_base_step_doorkey_lockstep():
    """DoorKey-8x8 levels from the JAX generator, max_steps 40 so
    truncation fires inside the rollout."""
    env = minigrid_tpu.make("MiniGrid-DoorKey-8x8-v0", max_steps=40)
    jparams = env.default_params
    keys = jax.random.split(jax.random.PRNGKey(0), 48)
    jstate = jax.vmap(lambda k: env.generate(k, jparams))(keys)
    assert jstate.box_contains is None
    params = EnvParams(width=8, height=8, max_steps=40)
    seen = _lockstep(jstate, jparams, params, seed=1)
    assert seen["moved"] and seen["picked_up"] and seen["trunc"]


def _box_world(r: np.random.Generator, b: int, w: int, h: int) -> JEnvState:
    """Random grids over the step's whole vocabulary: walls, keys, balls,
    boxes (with contents), doors in all three states, goals and lava; agents
    anywhere (the border too, so the front cell can be out of bounds), some
    carrying a key or a box, and per-env step limits."""
    vocab = np.array([T["empty"]] * 6 + [T["wall"], T["key"], T["ball"], T["box"],
                                         T["door"], T["door"], T["goal"], T["lava"],
                                         T["floor"]])
    typ = r.choice(vocab, (b, w, h))
    col = r.integers(1, 4, (b, w, h))  # red, green, blue: keys match doors often
    st = np.where(typ == T["door"], r.integers(0, 3, (b, w, h)), 0)
    col = np.where(typ == T["empty"], 0, col)
    grid = pack_np(np.stack([typ, col, st], -1))
    contents = np.stack([r.choice([T["empty"], T["key"], T["ball"]], (b, w, h)),
                         r.integers(1, 4, (b, w, h)), np.zeros((b, w, h), int)], -1)
    contents[..., 1] = np.where(contents[..., 0] == T["empty"], 0, contents[..., 1])
    box_contains = np.where(typ == T["box"], pack_np(contents),
                            pack_np(JC.EMPTY_TRIPLE))
    carry_t = r.choice([T["empty"], T["empty"], T["key"], T["box"]], b)
    carrying = np.stack([carry_t, np.where(carry_t == T["empty"], 0,
                                           r.integers(1, 4, b)),
                         np.zeros(b, int)], -1).astype(np.uint8)
    carrying_contains = np.where(
        (carry_t == T["box"])[:, None],
        np.stack([np.full(b, T["ball"]), r.integers(1, 4, b), np.zeros(b, int)], -1),
        JC.EMPTY_TRIPLE[None]).astype(np.uint8)
    return JEnvState(
        grid=jnp.asarray(grid),
        box_contains=jnp.asarray(box_contains),
        agent_pos=jnp.asarray(np.stack([r.integers(0, w, b), r.integers(0, h, b)],
                                       -1).astype(np.int32)),
        agent_dir=jnp.asarray(r.integers(0, 4, b).astype(np.int32)),
        carrying=jnp.asarray(carrying),
        carrying_contains=jnp.asarray(carrying_contains),
        step_count=jnp.asarray(r.integers(0, 20, b).astype(np.int32)),
        terminated=jnp.zeros(b, bool),
        truncated=jnp.zeros(b, bool),
        rng=jax.random.split(jax.random.PRNGKey(int(r.integers(1000))), b),
        mission=jnp.zeros((b, 4), jnp.int32),
        max_steps=jnp.asarray(r.choice([0, 30, 70], b).astype(np.int32)),
    )


@pytest.mark.parametrize("w,h", [(7, 7), (9, 6)])
def test_base_step_box_planes_lockstep(w, h):
    """Box planes present: reveal, pickup/drop of a box with its contents,
    door FSM in every state, goal reward with per-env limits."""
    r = np.random.default_rng(w * h)
    jstate = _box_world(r, 64, w, h)
    jparams = JParams(width=w, height=h, max_steps=50)
    params = EnvParams(width=w, height=h, max_steps=50)
    seen = _lockstep(jstate, jparams, params, seed=w + h)
    assert all(seen[k] for k in seen), seen


def test_goal_reward_matches_the_compiled_jax_expression():
    """Over many (step_count, max_steps) pairs, bitwise: XLA rounds the
    multiply-subtract once, and a plain float32 multiply then subtract would
    differ in about a third of them."""
    r = np.random.default_rng(0)
    limit = r.integers(1, 6000, 200_000).astype(np.int32)
    count = (r.random(limit.shape) * limit).astype(np.int32) + 1
    want = jax.jit(lambda s, m: 1.0 - 0.9 * (s.astype(jnp.float32)
                                             / m.astype(jnp.float32)))(count, limit)
    got = TS.goal_reward(torch.from_numpy(count), torch.from_numpy(limit).float())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dir_to_vec_and_tables():
    d = torch.arange(4, dtype=torch.int32)
    dx, dy = TS.dir_to_vec(d)
    np.testing.assert_array_equal(torch.stack([dx, dy], -1).numpy(), JC.DIR_TO_VEC)
    assert TS.NUM_ACTIONS == 8 and int(TS.Actions.stay) == 7
    types = torch.arange(JC.NUM_OBJECT_TYPES, dtype=torch.int32)
    np.testing.assert_array_equal(
        TS.in_table(types, TS._table_ranges(JC.CAN_PICKUP)).numpy(), JC.CAN_PICKUP)
    cells = torch.stack([types, torch.zeros_like(types), torch.zeros_like(types)], -1)
    want = JC.CAN_OVERLAP | (np.arange(JC.NUM_OBJECT_TYPES) == T["door"])
    np.testing.assert_array_equal(TS.can_overlap(cells).numpy(), want)


def test_state_to_numpy_dtypes_after_step():
    """The stepped port state converts back in the JAX package's dtypes."""
    r = np.random.default_rng(5)
    jstate = _box_world(r, 4, 6, 6)
    port, *_ = TS.base_step(to_port(jstate), torch.zeros(4, dtype=torch.int32),
                            EnvParams(width=6, height=6))
    out = state_to_numpy(port)
    assert out["grid"].dtype == np.uint32 and out["rng"].dtype == np.uint32
    assert out["carrying"].dtype == np.uint8
