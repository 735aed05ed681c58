"""Episodes from a seed-exact reset, BabyAI: the port's ``Env.step`` (the
verifier in ``BabyAILevel.post_step``) against the JAX package's jitted
``step``, in lockstep for 16 steps, one id per BabyAI generator of
``utils/exact.py`` (four for the grammar sampler: a locked room, sequences,
locations, the boss level).  See ``test_torch_exact_step.py`` for the
check.
"""

from __future__ import annotations

import pytest

from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)
from tests.test_torch_exact_step import check_lockstep

BABYAI_STEP_IDS = [
    "BabyAI-GoToRedBallGrey-v0", "BabyAI-GoToObj-v0", "BabyAI-GoToLocalS6N3-v0",
    "BabyAI-Pickup-v0", "BabyAI-UnblockPickup-v0", "BabyAI-PickupDistDebug-v0",
    "BabyAI-PickupAbove-v0", "BabyAI-Open-v0", "BabyAI-OpenRedDoor-v0",
    "BabyAI-OpenDoorLoc-v0", "BabyAI-OpenTwoDoors-v0", "BabyAI-OpenDoorsOrderN4-v0",
    "BabyAI-PutNextLocalS5N3-v0", "BabyAI-PutNextS5N2Carrying-v0", "BabyAI-GoToObjMazeOpen-v0",
    "BabyAI-GoToImpUnlock-v0", "BabyAI-GoToRedBlueBall-v0", "BabyAI-GoToDoor-v0",
    "BabyAI-GoToObjDoor-v0", "BabyAI-Unlock-v0", "BabyAI-UnlockLocalDist-v0",
    "BabyAI-KeyInBox-v0", "BabyAI-UnlockPickupDist-v0", "BabyAI-BlockedUnlockPickup-v0",
    "BabyAI-UnlockToUnlock-v0", "BabyAI-ActionObjDoor-v0", "BabyAI-FindObjS5-v0",
    "BabyAI-KeyCorridorS3R2-v0", "BabyAI-OneRoomS8-v0", "BabyAI-MoveTwoAcrossS5N2-v0",
    "BabyAI-SynthS5R2-v0", "BabyAI-GoToSeqS5R2-v0", "BabyAI-PickupLoc-v0",
    "BabyAI-BossLevel-v0",
]


@pytest.mark.parametrize("env_id", BABYAI_STEP_IDS)
def test_exact_reset_then_step_matches_jax(env_id):
    check_lockstep(env_id)
