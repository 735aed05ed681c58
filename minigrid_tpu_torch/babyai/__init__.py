"""The BabyAI levels, with the JAX package's ids and preset kwargs: all 95
of them, the GoTo (33 ids), Open (13), Pickup (6), PutNext (11), Unlock
(8), other (17) and Synth/Boss (7) families, on ``BabyAILevel`` directly or
on the level generator ``LevelGen`` (GoToSeq, PickupLoc, Synth, Boss)."""

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
from minigrid_tpu_torch.babyai.levelgen import LevelGen
from minigrid_tpu_torch.babyai.open import (
    Open,
    OpenDoor,
    OpenDoorColor,
    OpenDoorLoc,
    OpenDoorsOrder,
    OpenRedDoor,
    OpenTwoDoors,
)
from minigrid_tpu_torch.babyai.other import (
    ActionObjDoor,
    FindObjS5,
    KeyCorridor,
    MoveTwoAcross,
    OneRoomS8,
)
from minigrid_tpu_torch.babyai.pickup import (
    Pickup,
    PickupAbove,
    PickupDist,
    PickupLoc,
    UnblockPickup,
)
from minigrid_tpu_torch.babyai.putnext import PutNext, PutNextLocal
from minigrid_tpu_torch.babyai.synth import (
    BossLevel,
    BossLevelNoUnlock,
    GoToSeq,
    MiniBossLevel,
    Synth,
    SynthLoc,
    SynthSeq,
)
from minigrid_tpu_torch.babyai.unlock import (
    BlockedUnlockPickup,
    KeyInBox,
    Unlock,
    UnlockLocal,
    UnlockPickup,
    UnlockToUnlock,
)
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
register("BabyAI-GoToSeq-v0", GoToSeq)
register("BabyAI-GoToSeqS5R2-v0", GoToSeq, room_size=5, num_rows=2, num_cols=2,
         num_dists=4)
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
register("BabyAI-PickupLoc-v0", PickupLoc)
register("BabyAI-PickupDist-v0", PickupDist)
register("BabyAI-PickupDistDebug-v0", PickupDist, debug=True)
register("BabyAI-PickupAbove-v0", PickupAbove)

# --- PutNext ---
register("BabyAI-PutNextLocal-v0", PutNextLocal)
register("BabyAI-PutNextLocalS5N3-v0", PutNextLocal, room_size=5, num_objs=3)
register("BabyAI-PutNextLocalS6N4-v0", PutNextLocal, room_size=6, num_objs=4)
register("BabyAI-PutNextS4N1-v0", PutNext, room_size=4, objs_per_room=1)
register("BabyAI-PutNextS5N2-v0", PutNext, room_size=5, objs_per_room=2)
register("BabyAI-PutNextS5N1-v0", PutNext, room_size=5, objs_per_room=1)
register("BabyAI-PutNextS6N3-v0", PutNext, room_size=6, objs_per_room=3)
register("BabyAI-PutNextS7N4-v0", PutNext, room_size=7, objs_per_room=4)
register("BabyAI-PutNextS5N2Carrying-v0", PutNext, room_size=5, objs_per_room=2,
         start_carrying=True)
register("BabyAI-PutNextS6N3Carrying-v0", PutNext, room_size=6, objs_per_room=3,
         start_carrying=True)
register("BabyAI-PutNextS7N4Carrying-v0", PutNext, room_size=7, objs_per_room=4,
         start_carrying=True)

# --- Unlock ---
register("BabyAI-Unlock-v0", Unlock)
register("BabyAI-UnlockLocal-v0", UnlockLocal)
register("BabyAI-UnlockLocalDist-v0", UnlockLocal, distractors=True)
register("BabyAI-KeyInBox-v0", KeyInBox)
register("BabyAI-UnlockPickup-v0", UnlockPickup)
register("BabyAI-UnlockPickupDist-v0", UnlockPickup, distractors=True)
register("BabyAI-BlockedUnlockPickup-v0", BlockedUnlockPickup)
register("BabyAI-UnlockToUnlock-v0", UnlockToUnlock)

# --- other ---
register("BabyAI-ActionObjDoor-v0", ActionObjDoor)
register("BabyAI-FindObjS5-v0", FindObjS5)
register("BabyAI-FindObjS6-v0", FindObjS5, room_size=6)
register("BabyAI-FindObjS7-v0", FindObjS5, room_size=7)
register("BabyAI-KeyCorridor-v0", KeyCorridor)
register("BabyAI-KeyCorridorS3R1-v0", KeyCorridor, room_size=3, num_rows=1)
register("BabyAI-KeyCorridorS3R2-v0", KeyCorridor, room_size=3, num_rows=2)
register("BabyAI-KeyCorridorS3R3-v0", KeyCorridor, room_size=3, num_rows=3)
register("BabyAI-KeyCorridorS4R3-v0", KeyCorridor, room_size=4, num_rows=3)
register("BabyAI-KeyCorridorS5R3-v0", KeyCorridor, room_size=5, num_rows=3)
register("BabyAI-KeyCorridorS6R3-v0", KeyCorridor, room_size=6, num_rows=3)
register("BabyAI-OneRoomS8-v0", OneRoomS8)
register("BabyAI-OneRoomS12-v0", OneRoomS8, room_size=12)
register("BabyAI-OneRoomS16-v0", OneRoomS8, room_size=16)
register("BabyAI-OneRoomS20-v0", OneRoomS8, room_size=20)
register("BabyAI-MoveTwoAcrossS5N2-v0", MoveTwoAcross, room_size=5, objs_per_room=2)
register("BabyAI-MoveTwoAcrossS8N9-v0", MoveTwoAcross, room_size=8, objs_per_room=9)

# --- Synth / Boss ---
register("BabyAI-Synth-v0", Synth)
register("BabyAI-SynthS5R2-v0", Synth, room_size=5, num_rows=2)
register("BabyAI-SynthLoc-v0", SynthLoc)
register("BabyAI-SynthSeq-v0", SynthSeq)
register("BabyAI-MiniBossLevel-v0", MiniBossLevel)
register("BabyAI-BossLevel-v0", BossLevel)
register("BabyAI-BossLevelNoUnlock-v0", BossLevelNoUnlock)

__all__ = ["BabyAILevel", "LevelGen"]
