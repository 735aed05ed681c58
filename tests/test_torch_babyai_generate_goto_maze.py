"""The port's BabyAI GoTo levels of 2x2 and 3x3 rooms against the JAX
package: every one of the 11 ids generates, from 32 threefry keys, bitwise
the levels of the jitted JAX ``env.generate``, with the JAX package's
mission strings (the checks are
``tests/test_torch_babyai_generate_goto.py``'s), and the maze's reset
strategy and refill window are the JAX package's.
"""

from __future__ import annotations

import pytest

from tests.test_torch_babyai_generate_goto import (
    GOTO_MAZE_IDS,
    check_generate,
    check_strategy,
)
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)


@pytest.mark.parametrize("env_id", GOTO_MAZE_IDS)
def test_generate_matches_jax(env_id):
    check_generate(env_id)


@pytest.mark.parametrize("num_envs,expected", [(64, ("pooled", 16)),
                                               (4096, ("pooled", 16))])
def test_maze_strategy_as_jax_chooses(num_envs, expected):
    check_strategy("BabyAI-GoTo-v0", num_envs, expected)
