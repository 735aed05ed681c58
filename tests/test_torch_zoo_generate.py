"""The port's single-room MiniGrid zoo against the JAX package: registry,
generators, missions and the batch engine's choice of reset strategy.

Every one of the 41 ids of the twelve families generates, from 32 threefry
keys, bitwise the levels ``jax.jit(jax.vmap(env.generate))`` gives: grid,
box planes, agent, direction, mission, ``extra`` and the state's key.
The generators are integer programs, so XLA's optimization level cannot
change a bit of what they return; they are compiled at level 0, which takes
a half to a third of the time.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

import minigrid_tpu
from minigrid_tpu.parallel.vector import VectorEnv as JVectorEnv
from minigrid_tpu.registry import spec as jspec

import minigrid_tpu_torch
from minigrid_tpu_torch.core.state import map_fields
from minigrid_tpu_torch.parallel.vector import VectorEnv

from tests.test_torch_bridge import assert_state_equal
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

FAMILIES = {
    "LavaGap": ["MiniGrid-LavaGapS5-v0", "MiniGrid-LavaGapS6-v0",
                "MiniGrid-LavaGapS7-v0"],
    "DistShift": ["MiniGrid-DistShift1-v0", "MiniGrid-DistShift2-v0"],
    "FourRooms": ["MiniGrid-FourRooms-v0"],
    "RedBlueDoors": ["MiniGrid-RedBlueDoors-6x6-v0", "MiniGrid-RedBlueDoors-8x8-v0"],
    "Memory": ["MiniGrid-MemoryS17Random-v0", "MiniGrid-MemoryS13Random-v0",
               "MiniGrid-MemoryS13-v0", "MiniGrid-MemoryS11-v0",
               "MiniGrid-MemoryS9-v0", "MiniGrid-MemoryS7-v0"],
    "Fetch": ["MiniGrid-Fetch-5x5-N2-v0", "MiniGrid-Fetch-6x6-N2-v0",
              "MiniGrid-Fetch-8x8-N3-v0"],
    "GoToDoor": ["MiniGrid-GoToDoor-5x5-v0", "MiniGrid-GoToDoor-6x6-v0",
                 "MiniGrid-GoToDoor-8x8-v0"],
    "GoToObject": ["MiniGrid-GoToObject-6x6-N2-v0", "MiniGrid-GoToObject-8x8-N2-v0"],
    "PutNear": ["MiniGrid-PutNear-6x6-N2-v0", "MiniGrid-PutNear-8x8-N3-v0"],
    "Crossing": [f"MiniGrid-{kind}CrossingS{s}N{n}-v0" for kind in ("Lava", "Simple")
                 for s, n in ((9, 1), (9, 2), (9, 3), (11, 5))],
    "Dynamic-Obstacles": [f"MiniGrid-Dynamic-Obstacles-{s}-v0" for s in
                          ("5x5", "Random-5x5", "6x6", "Random-6x6", "8x8", "16x16")],
    "MultiRoom": ["MiniGrid-MultiRoom-N2-S4-v0", "MiniGrid-MultiRoom-N4-S5-v0",
                  "MiniGrid-MultiRoom-N6-v0"],
}
ZOO_IDS = [i for ids in FAMILIES.values() for i in ids]
FAST_COMPILE = {"xla_backend_optimization_level": 0}
# the families ported before the zoo
EARLIER_IDS = ([f"MiniGrid-DoorKey-{s}x{s}-v0" for s in (5, 6, 8, 16)]
               + [f"MiniGrid-Empty-{s}x{s}-v0" for s in (5, 6, 8, 16)]
               + [f"MiniGrid-Empty-Random-{s}x{s}-v0" for s in (5, 6)])


def port_keys(jkeys) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkeys).astype(np.int64))


def test_the_zoo_has_41_ids():
    """The single-room zoo's 41 ids, beside the earlier families', the
    RoomGrid families' (``tests/test_torch_roomgrid_zoo.py``), BabyAI's
    (``tests/test_torch_babyai_generate_open_pickup.py``,
    ``tests/test_torch_babyai_levelgen.py``) and the dataset envs': every id
    of the JAX registry."""
    from tests.test_torch_babyai_generate_open_pickup import BABYAI_IDS
    from tests.test_torch_babyai_levelgen import SLICE_B_IDS
    from tests.test_torch_bridge import assert_registry_complete
    from tests.test_torch_dataset_envs import DATASET_IDS
    from tests.test_torch_roomgrid_zoo import ROOMGRID_IDS

    assert len(ZOO_IDS) == 41 == len(set(ZOO_IDS))
    assert minigrid_tpu_torch.registered_ids() == sorted(
        ZOO_IDS + EARLIER_IDS + ROOMGRID_IDS + BABYAI_IDS + SLICE_B_IDS + DATASET_IDS)
    assert_registry_complete()


@pytest.mark.parametrize("env_id", ZOO_IDS + EARLIER_IDS)
def test_registry_matches_jax(env_id):
    """Same class name and preset kwargs, letter for letter, and the same
    default params."""
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


@pytest.mark.parametrize("env_id", ZOO_IDS)
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


def assert_contiguous(t: torch.Tensor, where: str) -> torch.Tensor:
    assert t.is_contiguous(), where
    return t


@pytest.mark.parametrize("family", list(FAMILIES))
def test_missions_match_jax(family):
    """mission_codes, and mission_text of every code and of generated
    levels."""
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
        assert env.mission_text(m)


@pytest.mark.parametrize("num_envs", [16, 4096])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_strategy_and_pool_refill_as_jax_chooses(family, num_envs):
    """Construction only: the default reset strategy and refill window."""
    env_id = FAMILIES[family][-1]
    got = VectorEnv(minigrid_tpu_torch.make(env_id), num_envs, device="cpu")
    want = JVectorEnv(minigrid_tpu.make(env_id), num_envs)
    assert got.reset_strategy == want.reset_strategy
    assert got.pool_refill == want.pool_refill
    if family == "MultiRoom":
        expected = ("conditional", 16) if num_envs == 16 else ("pooled", 32)
        assert (got.reset_strategy, got.pool_refill) == expected
    strict = VectorEnv(minigrid_tpu_torch.make(env_id), num_envs, device="cpu",
                       reset_strategy="pooled", strict_refill=True)
    assert not strict.best_effort
