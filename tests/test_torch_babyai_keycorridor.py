"""The port's BabyAI KeyCorridor (a class of its own, beside MiniGrid's) and
its seven ids against the JAX package: every id's registry entry, and
``generate`` bitwise on 32 keys against the jitted JAX generator with the
JAX package's mission strings (the checks of
``tests/test_torch_babyai_generate_goto.py``).
"""

from __future__ import annotations

import pytest

import minigrid_tpu_torch

from tests.test_torch_babyai_generate_goto import check_generate, check_registry
from tests.test_torch_babyai_levelgen import OTHER_IDS
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CORRIDOR_IDS = [i for i in OTHER_IDS if "KeyCorridor" in i]


def test_babyai_keycorridor_is_its_own_class():
    assert len(CORRIDOR_IDS) == 7
    env = minigrid_tpu_torch.make("BabyAI-KeyCorridorS3R1-v0")
    mg = minigrid_tpu_torch.make("MiniGrid-KeyCorridorS3R1-v0")
    assert type(env) is not type(mg) and env.name == "BabyAI-KeyCorridor"
    assert (env.width, env.height) == (7, 3)


@pytest.mark.parametrize("env_id", CORRIDOR_IDS)
def test_registry_matches_jax(env_id):
    check_registry(env_id)


@pytest.mark.parametrize("env_id", CORRIDOR_IDS)
def test_generate_matches_jax(env_id):
    check_generate(env_id)
