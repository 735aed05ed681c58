"""The port's Boss levels against the JAX package: MiniBossLevel (2x2 rooms
of 5, a locked room a quarter of the time), BossLevel (3x3 rooms of 8) and
BossLevelNoUnlock, each ``generate`` bitwise on 32 keys against the jitted
JAX generator with the JAX package's mission strings (the checks of
``tests/test_torch_babyai_generate_goto.py``).  BossLevel through the
batch engine: ``tests/test_torch_babyai_boss_pooled.py``.
"""

from __future__ import annotations

import pytest

from tests.test_torch_babyai_generate_goto import check_generate
from tests.test_torch_babyai_levelgen import LEVELGEN_IDS
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

BOSS_IDS = [i for i in LEVELGEN_IDS if "Boss" in i]


def test_boss_has_three_ids():
    assert len(BOSS_IDS) == 3


@pytest.mark.parametrize("env_id", BOSS_IDS)
def test_generate_matches_jax(env_id):
    check_generate(env_id)
