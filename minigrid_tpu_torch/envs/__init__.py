"""Environment zoo + id registrations (the families ported so far)."""

from __future__ import annotations

from minigrid_tpu_torch.envs.doorkey import DoorKeyEnv
from minigrid_tpu_torch.registry import register

register("MiniGrid-DoorKey-5x5-v0", DoorKeyEnv, size=5)
register("MiniGrid-DoorKey-6x6-v0", DoorKeyEnv, size=6)
register("MiniGrid-DoorKey-8x8-v0", DoorKeyEnv, size=8)
register("MiniGrid-DoorKey-16x16-v0", DoorKeyEnv, size=16)

__all__ = ["DoorKeyEnv"]
