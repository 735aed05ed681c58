"""FourRoomsEnv — the four-room maze with random openings.

Counterpart of ``minigrid_tpu/envs/fourrooms.py``: a 19x19 grid split into
four rooms by two mid walls, one random opening per wall segment, and the
agent and the goal at random free cells (or at fixed ones).
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    base_state,
    empty_grid,
    resolve_device,
)


class FourRoomsEnv(Env):
    name = "FourRooms"

    def __init__(self, agent_pos=None, goal_pos=None, max_steps: int = 100,
                 **kwargs):
        self._agent_default_pos = agent_pos
        self._goal_default_pos = goal_pos
        super().__init__(grid_size=19, max_steps=max_steps, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        n = keys.shape[0]
        w, h = params.width, params.height
        room_w, room_h = w // 2, h // 2
        k = rng.split(keys, 8).unbind(1)

        grid = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h)
        grid = G.vert_wall(grid, room_w, 0, room_h)
        grid = G.vert_wall(grid, room_w, room_h, h - room_h)
        grid = G.horz_wall(grid, 0, room_h, room_w)
        grid = G.horz_wall(grid, room_w, room_h, w - room_w)

        # one opening per wall segment: upper and lower halves of the
        # vertical wall, left and right halves of the horizontal one
        draw_keys = torch.stack(k[:4], dim=1)  # [N, 4, 2]
        lo = G.const([1, room_h + 1, 1, room_w + 1], dev)
        hi = G.const([room_h, h - 1, room_w, w - 1], dev)
        gap0, gap1, gap2, gap3 = rng.randint(draw_keys, (), lo, hi).unbind(1)
        grid = G.put(grid, room_w, gap0, C.EMPTY_TRIPLE)
        grid = G.put(grid, room_w, gap1, C.EMPTY_TRIPLE)
        grid = G.put(grid, gap2, room_h, C.EMPTY_TRIPLE)
        grid = G.put(grid, gap3, room_h, C.EMPTY_TRIPLE)

        if self._agent_default_pos is not None:
            agent_pos = G.const(self._agent_default_pos, dev, torch.int32).repeat(n, 1)
            grid = G.put(grid, agent_pos[:, 0], agent_pos[:, 1], C.EMPTY_TRIPLE)
            agent_dir = rng.randint(k[4], (), 0, 4)
        else:
            _, agent_pos, _ = G.place_obj(k[4], grid, None)
            agent_dir = rng.randint(k[5], (), 0, 4)

        if self._goal_default_pos is not None:
            gx, gy = self._goal_default_pos
            grid = G.put(grid, gx, gy, C.GOAL_TRIPLE)
        else:
            grid, _, _ = G.place_obj(k[6], grid, C.GOAL_TRIPLE,
                                     agent_pos=agent_pos)
        return base_state(grid, agent_pos, agent_dir, rng=k[7],
                          has_boxes=False)

    def mission_text(self, mission) -> str:
        return "reach the goal"
