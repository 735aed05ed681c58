"""UnlockPickupEnv — unlock the door, then pick up the box.

Counterpart of ``minigrid_tpu/envs/unlockpickup.py``: a box in the right room
behind a locked door, the key in the left room.  Picking up the target (the
level's only box, so a (type, color) match is an identity match) succeeds;
its (type, color) lives in ``extra``.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.roomgrid import RoomGridEnv
from minigrid_tpu_torch.core.state import EnvParams, EnvState, base_state, resolve_device
from minigrid_tpu_torch.core.step import PICKUP


def target_mission(obj: torch.Tensor) -> torch.Tensor:
    """uint8[B, 3] target cells -> int32[B, 4] missions (color, type, 0, 0)."""
    o = obj.to(torch.int32)
    zero = torch.zeros_like(o[:, 0])
    return torch.stack([o[:, 1], o[:, 0], zero, zero], dim=1)


def picked_target(state: EnvState, action: torch.Tensor, reward: torch.Tensor,
                  terminated: torch.Tensor, task_reward: torch.Tensor):
    """The pickup task of the RoomGrid families: a pickup that leaves the
    target ((type, color) in ``extra``) carried succeeds with the task
    reward.  Returns (reward, terminated)."""
    carried = state.carrying.to(torch.int32)
    match = (carried[:, 0] == state.extra[:, 0]) & (carried[:, 1] == state.extra[:, 1])
    success = (action == PICKUP) & match
    return torch.where(success, task_reward, reward), terminated | success


class UnlockPickupEnv(RoomGridEnv):
    name = "UnlockPickup"

    def __init__(self, max_steps: int | None = None, **kwargs):
        room_size = 6
        if max_steps is None:
            max_steps = 8 * room_size**2
        super().__init__(num_rows=1, num_cols=2, room_size=room_size,
                         max_steps=max_steps, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        keys = keys.to(resolve_device(device))
        k = rng.split(keys, 6).unbind(1)
        b = self.init_rooms(k[0], params)
        b, obj, _ = self.add_object(b, k[1], params, 1, 0, kind="box")
        b, door, _ = self.add_door(b, k[2], 0, 0, 0, locked=True)
        b, _, _ = self.add_object(b, k[3], params, 0, 0, kind="key",
                                  color=door[:, 1].to(torch.int32))
        b = self.place_agent_in_room(b, k[4], params, 0, 0)
        return base_state(b["grid"], b["agent_pos"], b["agent_dir"], rng=k[5],
                          mission=target_mission(obj),
                          extra=obj[:, :2].to(torch.int32))

    def post_step(self, state, action, reward, terminated, outcome, params):
        reward, terminated = picked_target(state, action, reward, terminated,
                                           self.task_reward(state, params))
        return state, reward, terminated

    def mission_text(self, mission) -> str:
        return f"pick up the {C.IDX_TO_COLOR[int(mission[0])]} box"

    def mission_codes(self) -> np.ndarray:
        box = C.OBJECT_TO_IDX["box"]
        return np.asarray([(c, box, 0, 0) for c in C.COLOR_TO_IDX.values()],
                          dtype=np.int32)
