"""The port's BabyAI GoTo levels against the JAX package: registry,
generators, ``generate_attempt``, missions and the reset strategy.

Every one of the 20 single-room GoTo ids generates, from 32 threefry keys,
bitwise the levels of the jitted JAX ``env.generate``: grid, box planes,
agent, direction, the 43-int mission, the per-episode ``max_steps``, the
state's key and the ``extra`` (instruction code and verifier state, packed
planes as uint32), through up to 8 retry passes.  ``mission_text`` of every
level is the JAX package's string.  The 11 multi-room GoTo ids are in
``tests/test_torch_babyai_generate_goto_maze.py``, the Open and Pickup ids
and the checks over the whole slice in
``tests/test_torch_babyai_generate_open_pickup.py``; the three files share
the helpers here.

A generator returns integers only: the uniform draws of its
``categorical``s decide an index, which is exact in any rounding.  So the
JAX side compiles at optimization level 0 with fusion off, neither of which
can change an integer, in a fifth of the default compile; and it is traced
for one key and run per key, which halves the tracing and gives what
``jax.vmap`` gives, key by key.  One id is also run as
``jax.jit(jax.vmap(env.generate))`` at the default options, as the JAX
``VectorEnv`` runs it, and gives the same levels.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax

import minigrid_tpu
from minigrid_tpu.parallel.vector import VectorEnv as JVectorEnv
from minigrid_tpu.registry import spec as jspec

import minigrid_tpu_torch
from minigrid_tpu_torch.babyai.level import BabyAILevel
from minigrid_tpu_torch.core.state import map_fields
from minigrid_tpu_torch.parallel.vector import VectorEnv

from tests.test_torch_bridge import assert_state_equal, jax_to_numpy
from tests.test_torch_zoo_generate import assert_contiguous, port_keys
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

INTEGER_PROGRAM = {"xla_backend_optimization_level": 0,
                   "xla_disable_hlo_passes": "fusion"}
GOTO_IDS = (
    ["BabyAI-GoToRedBallGrey-v0", "BabyAI-GoToRedBall-v0",
     "BabyAI-GoToRedBallNoDists-v0", "BabyAI-GoToObj-v0", "BabyAI-GoToObjS4-v0",
     "BabyAI-GoToObjS6-v0", "BabyAI-GoToLocal-v0"]
    + [f"BabyAI-GoToLocalS{s}N{n}-v0" for s, n in
       [(5, 2), (6, 2), (6, 3), (6, 4), (7, 4), (7, 5), (8, 2), (8, 3), (8, 4),
        (8, 5), (8, 6), (8, 7)]]
    + ["BabyAI-GoTo-v0", "BabyAI-GoToObjMaze-v0", "BabyAI-GoToObjMazeOpen-v0",
       "BabyAI-GoToObjMazeS4R2-v0", "BabyAI-GoToObjMazeS4-v0",
       "BabyAI-GoToObjMazeS5-v0", "BabyAI-GoToObjMazeS6-v0",
       "BabyAI-GoToObjMazeS7-v0", "BabyAI-GoToImpUnlock-v0",
       "BabyAI-GoToRedBlueBall-v0", "BabyAI-GoToDoor-v0", "BabyAI-GoToObjDoor-v0"])
# the single-room levels, then the mazes of 2x2 and 3x3 rooms
GOTO_ROOM_IDS = [i for i in GOTO_IDS if "Maze" not in i and i not in (
    "BabyAI-GoTo-v0", "BabyAI-GoToImpUnlock-v0", "BabyAI-GoToDoor-v0",
    "BabyAI-GoToObjDoor-v0")]
GOTO_MAZE_IDS = [i for i in GOTO_IDS if i not in GOTO_ROOM_IDS]
NUM_KEYS = 32


def jax_program(env_id: str, method: str = "generate"):
    """The JAX env's ``<method>`` jitted for one key as an integer program:
    a function of a batch of keys that runs it key by key and stacks the
    results (a batch as ``jax.vmap`` gives it)."""
    jenv = minigrid_tpu.make(env_id)
    jp = jenv.default_params
    fn = getattr(jenv, method)
    key = jax.random.PRNGKey(0)
    one = jax.jit(lambda k: fn(k, jp)).lower(key).compile(INTEGER_PROGRAM)

    def run(keys):
        outs = [one(k) for k in keys]
        return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *outs)

    return run


def check_registry(env_id: str) -> None:
    """Same class name and preset kwargs, the same default params (the
    BabyAI bound on max_steps included) and the same class attributes that
    pick the reset strategy."""
    got, want = minigrid_tpu_torch.spec(env_id), jspec(env_id)
    assert got.cls.__name__ == want.cls.__name__
    assert got.kwargs == want.kwargs
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    assert isinstance(env, BabyAILevel)
    p, jp = env.default_params, jenv.default_params
    for name in ("width", "height", "max_steps", "agent_view_size",
                 "see_through_walls", "babyai_done_actions"):
        assert getattr(p, name) == getattr(jp, name), name
    for attr in ("name", "num_actions", "room_size", "num_rows", "num_cols",
                 "fixed_max_steps", "max_gen_attempts", "expensive_generation",
                 "desynchronized_resets", "pool_refill_fraction", "grammar_missions"):
        assert getattr(env, attr, None) == getattr(jenv, attr, None), attr


def check_generate(env_id: str) -> None:
    """``generate`` bitwise on 32 keys, and every level's mission string."""
    jkeys = jax.random.split(jax.random.PRNGKey(len(env_id)), NUM_KEYS)
    want = jax_program(env_id)(jkeys)
    env, jenv = minigrid_tpu_torch.make(env_id), minigrid_tpu.make(env_id)
    got = env.generate(port_keys(jkeys), env.default_params, device="cpu")
    assert_state_equal(got, want, f"{env_id}: ")
    map_fields(lambda t: assert_contiguous(t, env_id), got)
    assert got.mission.shape == (NUM_KEYS, 43)
    for m, jm in zip(got.mission.numpy(), np.asarray(want.mission)):
        text = env.mission_text(m)
        assert text and text == jenv.mission_text(jm), env_id


def check_generate_attempt(env_id: str, seed: int) -> np.ndarray:
    """``generate_attempt`` bitwise, its ``valid`` included; returns
    ``valid``.  It draws another level than ``generate`` for a key."""
    jkeys = jax.random.split(jax.random.PRNGKey(seed), NUM_KEYS)
    want, want_ok = jax_program(env_id, "generate_attempt")(jkeys)
    env = minigrid_tpu_torch.make(env_id)
    got, ok = env.generate_attempt(port_keys(jkeys), env.default_params, device="cpu")
    assert_state_equal(got, want, f"{env_id} attempt: ")
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    again = env.generate(port_keys(jkeys), env.default_params, device="cpu")
    assert (again.grid != got.grid).any()
    return ok.numpy()


def check_strategy(env_id: str, num_envs: int, expected: tuple) -> None:
    """Construction only: the reset strategy and refill window the JAX
    package picks."""
    got = VectorEnv(minigrid_tpu_torch.make(env_id), num_envs, device="cpu")
    want = JVectorEnv(minigrid_tpu.make(env_id), num_envs)
    assert (got.reset_strategy, got.pool_refill) == (want.reset_strategy,
                                                      want.pool_refill) == expected
    assert got.best_effort_refill == want.best_effort_refill == (expected[0] == "pooled")


def test_goto_has_31_ids():
    assert len(GOTO_IDS) == 31 == len(set(GOTO_IDS))
    assert set(GOTO_IDS) <= set(minigrid_tpu_torch.registered_ids())
    assert (len(GOTO_ROOM_IDS), len(GOTO_MAZE_IDS)) == (20, 11)
    for env_id in GOTO_IDS:
        env = minigrid_tpu_torch.make(env_id)
        assert (env.num_rows * env.num_cols == 1) == (env_id in GOTO_ROOM_IDS)


@pytest.mark.parametrize("env_id", GOTO_IDS)
def test_registry_matches_jax(env_id):
    check_registry(env_id)


def test_gotoobjs6_keeps_the_upstream_room_size():
    """The S6 id is registered with room_size 4, as upstream registers it."""
    assert minigrid_tpu_torch.spec("BabyAI-GoToObjS6-v0").kwargs == {"room_size": 4}
    assert minigrid_tpu_torch.make("BabyAI-GoToObjS6-v0").default_params.width == 4


@pytest.mark.parametrize("env_id", GOTO_ROOM_IDS)
def test_generate_matches_jax(env_id):
    check_generate(env_id)


def test_integer_program_options_change_no_level():
    """GoToObjS4 as the JAX ``VectorEnv`` runs it, ``jax.jit(jax.vmap(...))``
    at the default options, gives the levels of the per-key fast-compile
    program, and the port's."""
    env_id = "BabyAI-GoToObjS4-v0"
    jenv = minigrid_tpu.make(env_id)
    jp = jenv.default_params
    jkeys = jax.random.split(jax.random.PRNGKey(5), NUM_KEYS)
    fast = jax_program(env_id)(jkeys)
    default = jax.jit(jax.vmap(lambda k: jenv.generate(k, jp)))(jkeys)
    jax.tree_util.tree_map(np.testing.assert_array_equal, jax_to_numpy(fast),
                           jax_to_numpy(default))
    env = minigrid_tpu_torch.make(env_id)
    got = env.generate(port_keys(jkeys), env.default_params, device="cpu")
    assert_state_equal(got, fast)
    # 4x4: the dynamic limit of one GoTo in one room of 4
    assert (got.max_steps.numpy() == 16).all()


def test_generate_attempt_matches_jax():
    """GoToRedBall: about one draw in ten is invalid (an object walled
    off), and ``generate_attempt`` reports it."""
    ok = check_generate_attempt("BabyAI-GoToRedBall-v0", 3)
    assert ok.any()


@pytest.mark.parametrize("num_envs,expected", [(16, ("conditional", 16)),
                                               (64, ("pooled", 16)),
                                               (4096, ("pooled", 512))])
def test_single_room_strategy_as_jax_chooses(num_envs, expected):
    check_strategy("BabyAI-GoToRedBall-v0", num_envs, expected)
