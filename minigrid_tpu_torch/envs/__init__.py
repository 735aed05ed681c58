"""Environment zoo + id registrations (the families ported so far), with the
JAX package's ids and preset kwargs."""

from __future__ import annotations

from minigrid_tpu_torch.envs.crossing import CrossingEnv
from minigrid_tpu_torch.envs.distshift import DistShiftEnv
from minigrid_tpu_torch.envs.doorkey import DoorKeyEnv
from minigrid_tpu_torch.envs.dynamicobstacles import DynamicObstaclesEnv
from minigrid_tpu_torch.envs.empty import EmptyEnv
from minigrid_tpu_torch.envs.fetch import FetchEnv
from minigrid_tpu_torch.envs.fourrooms import FourRoomsEnv
from minigrid_tpu_torch.envs.gotodoor import GoToDoorEnv
from minigrid_tpu_torch.envs.gotoobject import GoToObjectEnv
from minigrid_tpu_torch.envs.lavagap import LavaGapEnv
from minigrid_tpu_torch.envs.memory import MemoryEnv
from minigrid_tpu_torch.envs.multiroom import MultiRoomEnv
from minigrid_tpu_torch.envs.putnear import PutNearEnv
from minigrid_tpu_torch.envs.redbluedoors import RedBlueDoorEnv
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

__all__ = [
    "CrossingEnv",
    "DistShiftEnv",
    "DoorKeyEnv",
    "DynamicObstaclesEnv",
    "EmptyEnv",
    "FetchEnv",
    "FourRoomsEnv",
    "GoToDoorEnv",
    "GoToObjectEnv",
    "LavaGapEnv",
    "MemoryEnv",
    "MultiRoomEnv",
    "PutNearEnv",
    "RedBlueDoorEnv",
]
