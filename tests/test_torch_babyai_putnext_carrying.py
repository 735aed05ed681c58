"""The port's PutNext levels with the carried start against the JAX package:
PutNextS5N2Carrying, PutNextS6N3Carrying and PutNextS7N4Carrying.

Every id's registry entry, and ``generate`` bitwise on 32 keys against the
jitted JAX generator, with the JAX package's mission strings (the checks of
``tests/test_torch_babyai_generate_goto.py``): object A in hand and off the
grid, its tracked bit moved to the carry flags.  ``generate_attempt`` on
PutNextS5N2Carrying, whose ``post_generate`` runs in every attempt of the
best-effort refill.
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
from tests.test_torch_babyai_levelgen import PUTNEXT_IDS
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CARRYING_IDS = [i for i in PUTNEXT_IDS if "Carrying" in i]


@pytest.mark.parametrize("env_id", CARRYING_IDS)
def test_registry_matches_jax(env_id):
    check_registry(env_id)


@pytest.mark.parametrize("env_id", CARRYING_IDS)
def test_generate_matches_jax(env_id):
    check_generate(env_id)


def test_generate_attempt_matches_jax():
    assert check_generate_attempt("BabyAI-PutNextS5N2Carrying-v0", 12).any()


def test_carried_start():
    """PutNextS5N2Carrying starts with object A in hand and off the grid,
    its clause's carry flag set."""
    env = minigrid_tpu_torch.make("BabyAI-PutNextS5N2Carrying-v0")
    st = env.generate(rng.split(rng.PRNGKey(14, "cpu"), 32), env.default_params, "cpu")
    held = st.carrying.numpy()
    assert (held[:, 0] != C.OBJECT_TO_IDX["empty"]).all()
    assert st.extra["vs"]["carry1"][:, 0].all()
    d1 = st.extra["instr"]["d1"][:, 0].numpy()
    assert (d1[:, 1] == held[:, 1]).all()  # desc_move names the carried color
    kinds = st.grid.numpy() & 0xFF
    objects = np.isin(kinds, [C.OBJECT_TO_IDX[t] for t in ("key", "ball", "box")])
    assert (objects.sum(axis=(1, 2)) == 3).all()  # 2 + 2 objects, one in hand


def test_strategy_as_jax_chooses():
    check_strategy("BabyAI-PutNextS7N4Carrying-v0", 4096, ("pooled", 16))
