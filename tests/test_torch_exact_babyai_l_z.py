"""Seed-exact generation against the JAX package's: the BabyAI ids whose
level name starts with L–Z (``BabyAI-<name>``), at seeds 0 and 1.

Each id replays the RoomGridLevel retry loop and its level's gen_mission on
the host, then finalises through ``BabyAILevel._finalize`` (the verifier
state, articles and step limit), so the whole state is held: the
instruction code at one clause slot for a single-clause family and four for
a composite one.  See ``test_torch_exact_minigrid.py`` for the check.
"""

from __future__ import annotations

import pytest

from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)
from tests.test_torch_exact_minigrid import BABYAI_IDS, check_exact

IDS = [i for i in BABYAI_IDS if i[len("BabyAI-")].upper() > "K"]


@pytest.mark.parametrize("env_id", IDS)
def test_exact_babyai_matches_jax(env_id):
    check_exact(env_id)
