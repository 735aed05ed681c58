"""Environment zoo + id registrations, with the JAX package's ids and preset
kwargs: the single-room zoo, the multi-room families built on
``core/roomgrid.py`` (Unlock, UnlockPickup, BlockedUnlockPickup,
KeyCorridor, ObstructedMaze) or beside it (LockedRoom, Playground), and the
five dataset envs (Contrastive, ContrastiveTrajectory, Negated-Simple,
Directions, Blocks)."""

from __future__ import annotations

from minigrid_tpu_torch.envs.blockedunlockpickup import BlockedUnlockPickupEnv
from minigrid_tpu_torch.envs.blocks_dataset import BlocksDataset
from minigrid_tpu_torch.envs.contrastive import (
    ContrastiveDataset,
    ContrastiveTrajectoryDataset,
)
from minigrid_tpu_torch.envs.crossing import CrossingEnv
from minigrid_tpu_torch.envs.directions_dataset import DirectionsDataset
from minigrid_tpu_torch.envs.distshift import DistShiftEnv
from minigrid_tpu_torch.envs.doorkey import DoorKeyEnv
from minigrid_tpu_torch.envs.dynamicobstacles import DynamicObstaclesEnv
from minigrid_tpu_torch.envs.empty import EmptyEnv
from minigrid_tpu_torch.envs.fetch import FetchEnv
from minigrid_tpu_torch.envs.fourrooms import FourRoomsEnv
from minigrid_tpu_torch.envs.gotodoor import GoToDoorEnv
from minigrid_tpu_torch.envs.gotoobject import GoToObjectEnv
from minigrid_tpu_torch.envs.keycorridor import KeyCorridorEnv
from minigrid_tpu_torch.envs.lavagap import LavaGapEnv
from minigrid_tpu_torch.envs.lockedroom import LockedRoomEnv
from minigrid_tpu_torch.envs.memory import MemoryEnv
from minigrid_tpu_torch.envs.multiroom import MultiRoomEnv
from minigrid_tpu_torch.envs.negated_goals import NegatedEnv, NegatedSimple
from minigrid_tpu_torch.envs.obstructedmaze import (
    ObstructedMaze_1Dlhb,
    ObstructedMaze_2Dl,
    ObstructedMaze_2Dlh,
    ObstructedMaze_2Dlhb,
    ObstructedMaze_Full,
    ObstructedMazeEnv,
)
from minigrid_tpu_torch.envs.playground import PlaygroundEnv
from minigrid_tpu_torch.envs.putnear import PutNearEnv
from minigrid_tpu_torch.envs.redbluedoors import RedBlueDoorEnv
from minigrid_tpu_torch.envs.unlock import UnlockEnv
from minigrid_tpu_torch.envs.unlockpickup import UnlockPickupEnv
from minigrid_tpu_torch.registry import register

# --- Empty ---
register("MiniGrid-Empty-5x5-v0", EmptyEnv, size=5)
register("MiniGrid-Empty-Random-5x5-v0", EmptyEnv, size=5, agent_start_pos=None)
register("MiniGrid-Empty-6x6-v0", EmptyEnv, size=6)
register("MiniGrid-Empty-Random-6x6-v0", EmptyEnv, size=6, agent_start_pos=None)
register("MiniGrid-Empty-8x8-v0", EmptyEnv, size=8)
register("MiniGrid-Empty-16x16-v0", EmptyEnv, size=16)

# --- DoorKey ---
register("MiniGrid-DoorKey-5x5-v0", DoorKeyEnv, size=5)
register("MiniGrid-DoorKey-6x6-v0", DoorKeyEnv, size=6)
register("MiniGrid-DoorKey-8x8-v0", DoorKeyEnv, size=8)
register("MiniGrid-DoorKey-16x16-v0", DoorKeyEnv, size=16)

# --- LavaCrossing / SimpleCrossing ---
register("MiniGrid-LavaCrossingS9N1-v0", CrossingEnv, size=9, num_crossings=1)
register("MiniGrid-LavaCrossingS9N2-v0", CrossingEnv, size=9, num_crossings=2)
register("MiniGrid-LavaCrossingS9N3-v0", CrossingEnv, size=9, num_crossings=3)
register("MiniGrid-LavaCrossingS11N5-v0", CrossingEnv, size=11, num_crossings=5)
register("MiniGrid-SimpleCrossingS9N1-v0", CrossingEnv, size=9, num_crossings=1,
         obstacle_type="wall")
register("MiniGrid-SimpleCrossingS9N2-v0", CrossingEnv, size=9, num_crossings=2,
         obstacle_type="wall")
register("MiniGrid-SimpleCrossingS9N3-v0", CrossingEnv, size=9, num_crossings=3,
         obstacle_type="wall")
register("MiniGrid-SimpleCrossingS11N5-v0", CrossingEnv, size=11,
         num_crossings=5, obstacle_type="wall")

# --- DistShift ---
register("MiniGrid-DistShift1-v0", DistShiftEnv, strip2_row=2)
register("MiniGrid-DistShift2-v0", DistShiftEnv, strip2_row=5)

# --- Dynamic-Obstacles ---
register("MiniGrid-Dynamic-Obstacles-5x5-v0", DynamicObstaclesEnv, size=5,
         n_obstacles=2)
register("MiniGrid-Dynamic-Obstacles-Random-5x5-v0", DynamicObstaclesEnv,
         size=5, agent_start_pos=None, n_obstacles=2)
register("MiniGrid-Dynamic-Obstacles-6x6-v0", DynamicObstaclesEnv, size=6,
         n_obstacles=3)
register("MiniGrid-Dynamic-Obstacles-Random-6x6-v0", DynamicObstaclesEnv,
         size=6, agent_start_pos=None, n_obstacles=3)
register("MiniGrid-Dynamic-Obstacles-8x8-v0", DynamicObstaclesEnv, size=8)
register("MiniGrid-Dynamic-Obstacles-16x16-v0", DynamicObstaclesEnv, size=16,
         n_obstacles=8)

# --- FourRooms ---
register("MiniGrid-FourRooms-v0", FourRoomsEnv)

# --- LavaGap ---
register("MiniGrid-LavaGapS5-v0", LavaGapEnv, size=5)
register("MiniGrid-LavaGapS6-v0", LavaGapEnv, size=6)
register("MiniGrid-LavaGapS7-v0", LavaGapEnv, size=7)

# --- Fetch ---
register("MiniGrid-Fetch-5x5-N2-v0", FetchEnv, size=5, numObjs=2)
register("MiniGrid-Fetch-6x6-N2-v0", FetchEnv, size=6, numObjs=2)
register("MiniGrid-Fetch-8x8-N3-v0", FetchEnv)

# --- GoToDoor ---
register("MiniGrid-GoToDoor-5x5-v0", GoToDoorEnv)
register("MiniGrid-GoToDoor-6x6-v0", GoToDoorEnv, size=6)
register("MiniGrid-GoToDoor-8x8-v0", GoToDoorEnv, size=8)

# --- GoToObject ---
register("MiniGrid-GoToObject-6x6-N2-v0", GoToObjectEnv)
register("MiniGrid-GoToObject-8x8-N2-v0", GoToObjectEnv, size=8, numObjs=2)

# --- Memory ---
register("MiniGrid-MemoryS17Random-v0", MemoryEnv, size=17, random_length=True)
register("MiniGrid-MemoryS13Random-v0", MemoryEnv, size=13, random_length=True)
register("MiniGrid-MemoryS13-v0", MemoryEnv, size=13)
register("MiniGrid-MemoryS11-v0", MemoryEnv, size=11)
register("MiniGrid-MemoryS9-v0", MemoryEnv, size=9)
register("MiniGrid-MemoryS7-v0", MemoryEnv, size=7)

# --- PutNear ---
register("MiniGrid-PutNear-6x6-N2-v0", PutNearEnv)
register("MiniGrid-PutNear-8x8-N3-v0", PutNearEnv, size=8, numObjs=3)

# --- RedBlueDoors ---
register("MiniGrid-RedBlueDoors-6x6-v0", RedBlueDoorEnv, size=6)
register("MiniGrid-RedBlueDoors-8x8-v0", RedBlueDoorEnv, size=8)

# --- MultiRoom ---
register("MiniGrid-MultiRoom-N2-S4-v0", MultiRoomEnv, minNumRooms=2,
         maxNumRooms=2, maxRoomSize=4)
register("MiniGrid-MultiRoom-N4-S5-v0", MultiRoomEnv, minNumRooms=6,
         maxNumRooms=6, maxRoomSize=5)
register("MiniGrid-MultiRoom-N6-v0", MultiRoomEnv, minNumRooms=6, maxNumRooms=6)

# --- KeyCorridor ---
register("MiniGrid-KeyCorridorS3R1-v0", KeyCorridorEnv, room_size=3, num_rows=1)
register("MiniGrid-KeyCorridorS3R2-v0", KeyCorridorEnv, room_size=3, num_rows=2)
register("MiniGrid-KeyCorridorS3R3-v0", KeyCorridorEnv, room_size=3, num_rows=3)
register("MiniGrid-KeyCorridorS4R3-v0", KeyCorridorEnv, room_size=4, num_rows=3)
register("MiniGrid-KeyCorridorS5R3-v0", KeyCorridorEnv, room_size=5, num_rows=3)
register("MiniGrid-KeyCorridorS6R3-v0", KeyCorridorEnv, room_size=6, num_rows=3)

# --- LockedRoom ---
register("MiniGrid-LockedRoom-v0", LockedRoomEnv)

# --- Playground ---
register("MiniGrid-Playground-v0", PlaygroundEnv)

# --- ObstructedMaze ---
register("MiniGrid-ObstructedMaze-1Dl-v0", ObstructedMaze_1Dlhb,
         key_in_box=False, blocked=False)
register("MiniGrid-ObstructedMaze-1Dlh-v0", ObstructedMaze_1Dlhb,
         key_in_box=True, blocked=False)
register("MiniGrid-ObstructedMaze-1Dlhb-v0", ObstructedMaze_1Dlhb)
register("MiniGrid-ObstructedMaze-2Dl-v0", ObstructedMaze_2Dl)
register("MiniGrid-ObstructedMaze-2Dlh-v0", ObstructedMaze_2Dlh)
register("MiniGrid-ObstructedMaze-2Dlhb-v0", ObstructedMaze_2Dlhb)
register("MiniGrid-ObstructedMaze-1Q-v0", ObstructedMaze_Full,
         agent_room=(1, 1), key_in_box=True, blocked=True, num_quarters=1,
         num_rooms_visited=5)
register("MiniGrid-ObstructedMaze-2Q-v0", ObstructedMaze_Full,
         agent_room=(1, 1), key_in_box=True, blocked=True, num_quarters=2,
         num_rooms_visited=11)
register("MiniGrid-ObstructedMaze-Full-v0", ObstructedMaze_Full)

# --- the dataset envs ---
register("ContrastiveDataset-v0", ContrastiveDataset)
register("ContrastiveTrajectoryDataset-v0", ContrastiveTrajectoryDataset)
register("MiniGrid-Negated-Simple-v0", NegatedSimple)
register("DirectionsDataset-v0", DirectionsDataset)
register("BlocksDataset-v0", BlocksDataset)

# --- Unlock family ---
register("MiniGrid-Unlock-v0", UnlockEnv)
register("MiniGrid-UnlockPickup-v0", UnlockPickupEnv)
register("MiniGrid-BlockedUnlockPickup-v0", BlockedUnlockPickupEnv)

__all__ = [
    "BlockedUnlockPickupEnv",
    "BlocksDataset",
    "ContrastiveDataset",
    "ContrastiveTrajectoryDataset",
    "CrossingEnv",
    "DirectionsDataset",
    "DistShiftEnv",
    "DoorKeyEnv",
    "DynamicObstaclesEnv",
    "EmptyEnv",
    "FetchEnv",
    "FourRoomsEnv",
    "GoToDoorEnv",
    "GoToObjectEnv",
    "KeyCorridorEnv",
    "LavaGapEnv",
    "LockedRoomEnv",
    "MemoryEnv",
    "MultiRoomEnv",
    "NegatedEnv",
    "NegatedSimple",
    "ObstructedMazeEnv",
    "ObstructedMaze_1Dlhb",
    "ObstructedMaze_2Dl",
    "ObstructedMaze_2Dlh",
    "ObstructedMaze_2Dlhb",
    "ObstructedMaze_Full",
    "PlaygroundEnv",
    "PutNearEnv",
    "RedBlueDoorEnv",
    "UnlockEnv",
    "UnlockPickupEnv",
]
