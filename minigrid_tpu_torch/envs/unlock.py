"""UnlockEnv — open the locked door.

Counterpart of ``minigrid_tpu/envs/unlock.py``: two rooms, a locked door
between them, the matching key in the left room.  A toggle that leaves the
door open succeeds; the door's cell lives in ``extra``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.roomgrid import RoomGridEnv
from minigrid_tpu_torch.core.state import EnvParams, EnvState, base_state, resolve_device
from minigrid_tpu_torch.core.step import TOGGLE

_OPEN = C.STATE_TO_IDX["open"]


class UnlockEnv(RoomGridEnv):
    name = "Unlock"

    def __init__(self, max_steps: int | None = None, **kwargs):
        room_size = 6
        if max_steps is None:
            max_steps = 8 * room_size**2
        super().__init__(num_rows=1, num_cols=2, room_size=room_size,
                         max_steps=max_steps, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        keys = keys.to(resolve_device(device))
        k = rng.split(keys, 5).unbind(1)
        b = self.init_rooms(k[0], params)
        b, door, door_pos = self.add_door(b, k[1], 0, 0, 0, locked=True)
        b, _, _ = self.add_object(b, k[2], params, 0, 0, kind="key",
                                  color=door[:, 1].to(torch.int32))
        b = self.place_agent_in_room(b, k[3], params, 0, 0)
        return base_state(b["grid"], b["agent_pos"], b["agent_dir"], rng=k[4],
                          extra=door_pos)

    def post_step(self, state, action, reward, terminated, outcome, params):
        dp = state.extra
        is_open = G.states(G.read_word(state.grid, dp[:, 0], dp[:, 1])) == _OPEN
        success = (action == TOGGLE) & is_open
        reward = torch.where(success, self.task_reward(state, params), reward)
        return state, reward, terminated | success

    def mission_text(self, mission) -> str:
        return "open the door"
