"""BabyAI levels built on ``BabyAILevel`` directly, with the JAX package's ids
and preset kwargs: the GoTo (31 ids), Open (13) and Pickup (5) families.
The level generator's ids (GoToSeq, PickupLoc, Synth, Boss, ...) and the
PutNext, Unlock and other families are not ported yet."""

from __future__ import annotations

from minigrid_tpu_torch.babyai.goto import (
    GoTo,
    GoToDoorBabyAI,
    GoToImpUnlock,
    GoToLocal,
    GoToObj,
    GoToObjDoor,
    GoToRedBall,
    GoToRedBallGrey,
    GoToRedBallNoDists,
    GoToRedBlueBall,
)
from minigrid_tpu_torch.babyai.level import BabyAILevel
from minigrid_tpu_torch.babyai.open import (
    Open,
    OpenDoor,
    OpenDoorColor,
    OpenDoorLoc,
    OpenDoorsOrder,
    OpenRedDoor,
    OpenTwoDoors,
)
from minigrid_tpu_torch.babyai.pickup import Pickup, PickupAbove, PickupDist, UnblockPickup
from minigrid_tpu_torch.registry import register

# --- GoTo ---
register("BabyAI-GoToRedBallGrey-v0", GoToRedBallGrey)
register("BabyAI-GoToRedBall-v0", GoToRedBall)
register("BabyAI-GoToRedBallNoDists-v0", GoToRedBallNoDists)
register("BabyAI-GoToObj-v0", GoToObj)
register("BabyAI-GoToObjS4-v0", GoToObj, room_size=4)
# the upstream registry's quirk, kept: the S6 id has room_size 4
register("BabyAI-GoToObjS6-v0", GoToObj, room_size=4)
register("BabyAI-GoToLocal-v0", GoToLocal)
for s, n in [(5, 2), (6, 2), (6, 3), (6, 4), (7, 4), (7, 5), (8, 2), (8, 3),
             (8, 4), (8, 5), (8, 6), (8, 7)]:
    register(f"BabyAI-GoToLocalS{s}N{n}-v0", GoToLocal, room_size=s, num_dists=n)
register("BabyAI-GoTo-v0", GoTo)
register("BabyAI-GoToObjMaze-v0", GoTo, num_dists=1, doors_open=False)
register("BabyAI-GoToObjMazeOpen-v0", GoTo, num_dists=1, doors_open=True)
register("BabyAI-GoToObjMazeS4R2-v0", GoTo, num_dists=1, room_size=4,
         num_rows=2, num_cols=2)
register("BabyAI-GoToObjMazeS4-v0", GoTo, num_dists=1, room_size=4)
register("BabyAI-GoToObjMazeS5-v0", GoTo, num_dists=1, room_size=5)
register("BabyAI-GoToObjMazeS6-v0", GoTo, num_dists=1, room_size=6)
register("BabyAI-GoToObjMazeS7-v0", GoTo, num_dists=1, room_size=7)
register("BabyAI-GoToImpUnlock-v0", GoToImpUnlock)
register("BabyAI-GoToRedBlueBall-v0", GoToRedBlueBall)
register("BabyAI-GoToDoor-v0", GoToDoorBabyAI)
register("BabyAI-GoToObjDoor-v0", GoToObjDoor)

# --- Open ---
register("BabyAI-Open-v0", Open)
register("BabyAI-OpenRedDoor-v0", OpenRedDoor)
register("BabyAI-OpenDoor-v0", OpenDoor)
register("BabyAI-OpenDoorDebug-v0", OpenDoor, debug=True, select_by=None)
register("BabyAI-OpenDoorColor-v0", OpenDoorColor)
register("BabyAI-OpenDoorLoc-v0", OpenDoorLoc)
register("BabyAI-OpenTwoDoors-v0", OpenTwoDoors)
register("BabyAI-OpenRedBlueDoors-v0", OpenTwoDoors, first_color="red",
         second_color="blue")
register("BabyAI-OpenRedBlueDoorsDebug-v0", OpenTwoDoors, first_color="red",
         second_color="blue", strict=True)
register("BabyAI-OpenDoorsOrderN2-v0", OpenDoorsOrder, num_doors=2)
register("BabyAI-OpenDoorsOrderN4-v0", OpenDoorsOrder, num_doors=4)
register("BabyAI-OpenDoorsOrderN2Debug-v0", OpenDoorsOrder, debug=True, num_doors=2)
register("BabyAI-OpenDoorsOrderN4Debug-v0", OpenDoorsOrder, debug=True, num_doors=4)

# --- Pickup ---
register("BabyAI-Pickup-v0", Pickup)
register("BabyAI-UnblockPickup-v0", UnblockPickup)
register("BabyAI-PickupDist-v0", PickupDist)
register("BabyAI-PickupDistDebug-v0", PickupDist, debug=True)
register("BabyAI-PickupAbove-v0", PickupAbove)

__all__ = ["BabyAILevel"]
