"""The port's BabyAI PutNext levels against the JAX package: PutNextLocal
(three ids) and PutNext without the carried start (five; the three
``...Carrying`` ids are in ``tests/test_torch_babyai_putnext_carrying.py``).

Every id's registry entry, and ``generate`` bitwise on 32 keys against the
jitted JAX generator, with the JAX package's mission strings (the checks of
``tests/test_torch_babyai_generate_goto.py``).
"""

from __future__ import annotations

import pytest

from tests.test_torch_babyai_generate_goto import (
    check_generate,
    check_registry,
    check_strategy,
)
from tests.test_torch_babyai_levelgen import PUTNEXT_IDS
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

FREE_HANDS_IDS = [i for i in PUTNEXT_IDS if "Carrying" not in i]


@pytest.mark.parametrize("env_id", FREE_HANDS_IDS)
def test_registry_matches_jax(env_id):
    check_registry(env_id)


@pytest.mark.parametrize("env_id", FREE_HANDS_IDS)
def test_generate_matches_jax(env_id):
    check_generate(env_id)


def test_strategy_as_jax_chooses():
    check_strategy("BabyAI-PutNextLocal-v0", 4096, ("pooled", 512))
