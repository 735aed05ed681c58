"""The port's other BabyAI levels against the JAX package: ActionObjDoor,
FindObjS5/S6/S7, OneRoomS8/S12/S16/S20 and MoveTwoAcrossS5N2/S8N9 (the
BabyAI KeyCorridor's seven ids are in
``tests/test_torch_babyai_keycorridor.py``).

Every id's registry entry, and ``generate`` bitwise on 32 keys against the
jitted JAX generator, with the JAX package's mission strings (the checks of
``tests/test_torch_babyai_generate_goto.py``); ``generate_attempt`` on
MoveTwoAcrossS5N2 (two PutNext clauses in sequence).
Then the port as a whole: it registers every id of the JAX registry.
"""

from __future__ import annotations

import pytest

import minigrid_tpu
import minigrid_tpu_torch

from tests.test_torch_babyai_generate_goto import (
    check_generate,
    check_generate_attempt,
    check_registry,
    check_strategy,
)
from tests.test_torch_babyai_levelgen import OTHER_IDS
from tests.test_torch_bridge import PORT_ID_COUNT, assert_registry_complete
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

NOT_CORRIDOR_IDS = [i for i in OTHER_IDS if "KeyCorridor" not in i]


@pytest.mark.parametrize("env_id", NOT_CORRIDOR_IDS)
def test_registry_matches_jax(env_id):
    check_registry(env_id)


@pytest.mark.parametrize("env_id", NOT_CORRIDOR_IDS)
def test_generate_matches_jax(env_id):
    check_generate(env_id)


def test_generate_attempt_matches_jax():
    ok = check_generate_attempt("BabyAI-MoveTwoAcrossS5N2-v0", 16)
    assert ok.any()


@pytest.mark.parametrize("env_id,expected", [
    ("BabyAI-OneRoomS20-v0", ("pooled", 512)),
    ("BabyAI-MoveTwoAcrossS8N9-v0", ("pooled", 16))])
def test_strategy_as_jax_chooses(env_id, expected):
    check_strategy(env_id, 4096, expected)


def test_the_port_registers_every_jax_id():
    assert_registry_complete()
    assert len(minigrid_tpu.registered_ids()) == PORT_ID_COUNT == 171
    for env_id in minigrid_tpu.registered_ids():
        assert minigrid_tpu_torch.spec(env_id).kwargs == minigrid_tpu.registry.spec(
            env_id).kwargs, env_id
