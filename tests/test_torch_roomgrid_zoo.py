"""The port's multi-room MiniGrid families against the JAX package: registry,
generators, missions and the batch engine's choice of reset strategy.

Five families stand on ``core/roomgrid.py`` (Unlock, UnlockPickup,
BlockedUnlockPickup, KeyCorridor, ObstructedMaze) and two beside it
(LockedRoom, Playground), 20 ids.  Each id's ``generate`` gives, from 32
threefry keys, bitwise the levels of ``jax.jit(jax.vmap(env.generate))``:
grid, box planes, agent, direction, mission, ``extra`` and the state's key.
The generators are integer programs but for the uniform draws of their
``categorical``s, which are exact in any rounding, so the JAX side compiles
at optimization level 0.  Their transitions are in
``tests/test_torch_roomgrid_step.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax

import minigrid_tpu
from minigrid_tpu.parallel.vector import VectorEnv as JVectorEnv
from minigrid_tpu.registry import spec as jspec

import minigrid_tpu_torch
from minigrid_tpu_torch.core.roomgrid import RoomGridEnv
from minigrid_tpu_torch.core.state import map_fields
from minigrid_tpu_torch.parallel.vector import VectorEnv

from tests.test_torch_bridge import assert_state_equal
from tests.test_torch_zoo_generate import FAST_COMPILE, assert_contiguous, port_keys
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

FAMILIES = {
    "Unlock": ["MiniGrid-Unlock-v0"],
    "UnlockPickup": ["MiniGrid-UnlockPickup-v0"],
    "BlockedUnlockPickup": ["MiniGrid-BlockedUnlockPickup-v0"],
    "KeyCorridor": [f"MiniGrid-KeyCorridorS{s}R{r}-v0"
                    for s, r in ((3, 1), (3, 2), (3, 3), (4, 3), (5, 3), (6, 3))],
    "ObstructedMaze": [f"MiniGrid-ObstructedMaze-{v}-v0" for v in
                       ("1Dl", "1Dlh", "1Dlhb", "2Dl", "2Dlh", "2Dlhb", "1Q", "2Q",
                        "Full")],
    "LockedRoom": ["MiniGrid-LockedRoom-v0"],
    "Playground": ["MiniGrid-Playground-v0"],
}
ROOMGRID_IDS = [i for ids in FAMILIES.values() for i in ids]


def test_the_roomgrid_families_have_20_ids():
    assert len(ROOMGRID_IDS) == 20 == len(set(ROOMGRID_IDS))
    assert set(ROOMGRID_IDS) <= set(minigrid_tpu_torch.registered_ids())
    # beside the BabyAI ids built on RoomGrid (tests/test_torch_babyai_*) and
    # the rest: every id of the JAX registry
    from tests.test_torch_bridge import assert_registry_complete

    assert_registry_complete()


@pytest.mark.parametrize("env_id", ROOMGRID_IDS)
def test_registry_matches_jax(env_id):
    """Same class name and preset kwargs, letter for letter, the same default
    params, and the same class attributes that pick the reset strategy."""
    got, want = minigrid_tpu_torch.spec(env_id), jspec(env_id)
    assert got.id == env_id
    assert got.cls.__name__ == want.cls.__name__
    assert got.kwargs == want.kwargs
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    p, jp = env.default_params, jenv.default_params
    for name in ("width", "height", "max_steps", "agent_view_size",
                 "see_through_walls"):
        assert getattr(p, name) == getattr(jp, name), name
    assert env.name == jenv.name and env.num_actions == jenv.num_actions
    for attr in ("expensive_generation", "desynchronized_resets",
                 "pool_refill_fraction"):
        assert getattr(env, attr, None) == getattr(jenv, attr, None), attr
    assert isinstance(env, RoomGridEnv) == (env.name not in ("LockedRoom", "Playground"))


@pytest.mark.parametrize("env_id", ROOMGRID_IDS)
def test_generate_matches_jax(env_id):
    jenv = minigrid_tpu.make(env_id)
    jp = jenv.default_params
    jkeys = jax.random.split(jax.random.PRNGKey(len(env_id)), 32)
    program = jax.jit(jax.vmap(lambda k: jenv.generate(k, jp)))
    want = program.lower(jkeys).compile(FAST_COMPILE)(jkeys)
    env = minigrid_tpu_torch.make(env_id)
    got = env.generate(port_keys(jkeys), env.default_params, device="cpu")
    assert_state_equal(got, want, f"{env_id}: ")
    # the CUDA kernels take contiguous tensors only
    map_fields(lambda t: assert_contiguous(t, env_id), got)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_missions_match_jax(family):
    """mission_codes, and mission_text of every code and of generated
    levels; every generated mission is one of the codes."""
    env_id = FAMILIES[family][-1]
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    codes = env.mission_codes()
    want = np.asarray(jenv.mission_codes())
    assert codes.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(codes, want)
    for code in codes[:: max(1, len(codes) // 20)]:
        assert env.mission_text(code) == jenv.mission_text(code)
    levels = env.generate(port_keys(jax.random.split(jax.random.PRNGKey(1), 8)),
                          env.default_params, device="cpu")
    for m in levels.mission.numpy():
        assert env.mission_text(m) == jenv.mission_text(m)
        assert (codes == m).all(axis=1).any()


@pytest.mark.parametrize("num_envs", [16, 4096])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_strategy_and_pool_refill_as_jax_chooses(family, num_envs):
    """Construction only: RoomGrid families go pooled with a 64-level window
    at B=4096 and conditional below 64 envs; LockedRoom and Playground go
    fused."""
    env_id = FAMILIES[family][-1]
    got = VectorEnv(minigrid_tpu_torch.make(env_id), num_envs, device="cpu")
    want = JVectorEnv(minigrid_tpu.make(env_id), num_envs)
    assert got.reset_strategy == want.reset_strategy
    assert got.pool_refill == want.pool_refill
    if family in ("LockedRoom", "Playground"):
        assert got.reset_strategy == "fused"
    else:
        expected = ("conditional", 16) if num_envs == 16 else ("pooled", 64)
        assert (got.reset_strategy, got.pool_refill) == expected
