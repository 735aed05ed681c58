"""The port's Synth levels against the JAX package: Synth, SynthS5R2
(``implicit_unlock=False`` with a locked room on a 13x9 lattice), SynthLoc
(location language) and SynthSeq (sequenced clauses), each ``generate``
bitwise on 32 keys against the jitted JAX generator with the JAX package's
mission strings (the checks of ``tests/test_torch_babyai_generate_goto.py``).
"""

from __future__ import annotations

import pytest

from tests.test_torch_babyai_generate_goto import check_generate
from tests.test_torch_babyai_levelgen import LEVELGEN_IDS
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

SYNTH_IDS = [i for i in LEVELGEN_IDS if "Synth" in i]


def test_synth_has_four_ids():
    assert len(SYNTH_IDS) == 4


@pytest.mark.parametrize("env_id", SYNTH_IDS)
def test_generate_matches_jax(env_id):
    check_generate(env_id)
