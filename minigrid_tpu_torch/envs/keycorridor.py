"""KeyCorridorEnv — an object behind a locked door, the key elsewhere.

Counterpart of ``minigrid_tpu/envs/keycorridor.py``: three columns of rooms,
the middle one opened into a corridor, a locked door on a random right room
with the target behind it, the matching key in a random left room, and
``connect_all`` for reachability.  Picking up the target (the only object of
its type and color) succeeds; its (type, color) lives in ``extra``.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.roomgrid import RoomGridEnv
from minigrid_tpu_torch.core.state import EnvParams, EnvState, base_state, resolve_device
from minigrid_tpu_torch.envs.unlockpickup import picked_target, target_mission


class KeyCorridorEnv(RoomGridEnv):
    name = "KeyCorridor"

    def __init__(self, num_rows: int = 3, obj_type: str = "ball",
                 room_size: int = 6, max_steps: int | None = None, **kwargs):
        self.obj_type = obj_type
        if max_steps is None:
            max_steps = 30 * room_size**2
        super().__init__(room_size=room_size, num_rows=num_rows, num_cols=3,
                         max_steps=max_steps, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        keys = keys.to(resolve_device(device))
        k = rng.split(keys, 8).unbind(1)
        b = self.init_rooms(k[0], params)
        # the middle column becomes a corridor
        for j in range(1, self.num_rows):
            b = self.remove_wall(b, 1, j, 3)
        # the locked door's room and the key's room, both uniform over the
        # rows, in one draw
        room_idx, key_row = rng.randint(torch.stack([k[1], k[4]], dim=1), (), 0,
                                        self.num_rows).unbind(1)
        # the locked door and the target in that right room
        b, door, _ = self.add_door(b, k[2], 2, room_idx, 2, locked=True)
        b, obj, _ = self.add_object(b, k[3], params, 2, room_idx, kind=self.obj_type)
        # the matching key in a left room
        b, _, _ = self.add_object(b, k[5], params, 0, key_row, kind="key",
                                  color=door[:, 1].to(torch.int32))
        # the agent mid-corridor, then everything connected
        b = self.place_agent_in_room(b, k[6], params, 1, self.num_rows // 2)
        b = self.connect_all(b, rng.fold_in(k[6], 1))
        return base_state(b["grid"], b["agent_pos"], b["agent_dir"], rng=k[7],
                          mission=target_mission(obj),
                          extra=obj[:, :2].to(torch.int32))

    def post_step(self, state, action, reward, terminated, outcome, params):
        reward, terminated = picked_target(state, action, reward, terminated,
                                           self.task_reward(state, params))
        return state, reward, terminated

    def mission_text(self, mission) -> str:
        return (f"pick up the {C.IDX_TO_COLOR[int(mission[0])]} "
                f"{C.IDX_TO_OBJECT[int(mission[1])]}")

    def mission_codes(self) -> np.ndarray:
        t = C.OBJECT_TO_IDX[self.obj_type]
        return np.asarray([(c, t, 0, 0) for c in C.COLOR_TO_IDX.values()],
                          dtype=np.int32)
