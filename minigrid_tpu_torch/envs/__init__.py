"""Environment zoo + id registrations (the families ported so far)."""

from __future__ import annotations

from minigrid_tpu_torch.envs.doorkey import DoorKeyEnv
from minigrid_tpu_torch.envs.empty import EmptyEnv
from minigrid_tpu_torch.registry import register

register("MiniGrid-Empty-5x5-v0", EmptyEnv, size=5)
register("MiniGrid-Empty-Random-5x5-v0", EmptyEnv, size=5, agent_start_pos=None)
register("MiniGrid-Empty-6x6-v0", EmptyEnv, size=6)
register("MiniGrid-Empty-Random-6x6-v0", EmptyEnv, size=6, agent_start_pos=None)
register("MiniGrid-Empty-8x8-v0", EmptyEnv, size=8)
register("MiniGrid-Empty-16x16-v0", EmptyEnv, size=16)
register("MiniGrid-DoorKey-5x5-v0", DoorKeyEnv, size=5)
register("MiniGrid-DoorKey-6x6-v0", DoorKeyEnv, size=6)
register("MiniGrid-DoorKey-8x8-v0", DoorKeyEnv, size=8)
register("MiniGrid-DoorKey-16x16-v0", DoorKeyEnv, size=16)

__all__ = ["DoorKeyEnv", "EmptyEnv"]
