"""The port's BabyAI Unlock levels (8 ids) against the JAX package.

Every id's registry entry, and ``generate`` bitwise on 32 keys against the
jitted JAX generator, with the JAX package's mission strings (the checks of
``tests/test_torch_babyai_generate_goto.py``): KeyInBox's box planes (the
key inside the box), Unlock's per-env excluded door color.
``generate_attempt`` on KeyInBox.
"""

from __future__ import annotations

import numpy as np
import pytest

import minigrid_tpu_torch
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import rng

from tests.test_torch_babyai_generate_goto import (
    check_generate,
    check_generate_attempt,
    check_registry,
    check_strategy,
)
from tests.test_torch_babyai_levelgen import UNLOCK_IDS
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)


@pytest.mark.parametrize("env_id", UNLOCK_IDS)
def test_registry_matches_jax(env_id):
    check_registry(env_id)


@pytest.mark.parametrize("env_id", UNLOCK_IDS)
def test_generate_matches_jax(env_id):
    check_generate(env_id)


def test_generate_attempt_matches_jax():
    assert check_generate_attempt("BabyAI-KeyInBox-v0", 13).any()


def test_the_key_in_the_box():
    """KeyInBox hides a key of the locked door's color in the one box."""
    env = minigrid_tpu_torch.make("BabyAI-KeyInBox-v0")
    st = env.generate(rng.split(rng.PRNGKey(15, "cpu"), 32), env.default_params, "cpu")
    grid, box = st.grid.numpy(), st.box_contains.numpy()
    for b in range(32):
        (bx, by), = np.argwhere((grid[b] & 0xFF) == C.OBJECT_TO_IDX["box"])
        door = grid[b][(grid[b] & 0xFF) == C.OBJECT_TO_IDX["door"]]
        locked = door[(door >> 16) == C.STATE_TO_IDX["locked"]]
        assert box[b, bx, by] & 0xFF == C.OBJECT_TO_IDX["key"]
        assert (box[b, bx, by] >> 8) & 0xFF == (locked[0] >> 8) & 0xFF


def test_strategy_as_jax_chooses():
    check_strategy("BabyAI-KeyInBox-v0", 4096, ("pooled", 16))
