"""LavaGapEnv — cross a lava strip through one gap.

Counterpart of ``minigrid_tpu/envs/lavagap.py``: the agent top-left facing
east, the goal bottom-right, a vertical obstacle strip at a random column with
one random gap.
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
    fixed_pose,
    resolve_device,
)


class LavaGapEnv(Env):
    name = "LavaGap"

    def __init__(self, size: int, obstacle_type: str = "lava",
                 max_steps: int | None = None, **kwargs):
        if size < 5:
            raise ValueError("LavaGap needs size >= 5")
        self.obstacle_type = obstacle_type
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(grid_size=size, see_through_walls=False,
                         max_steps=max_steps, **kwargs)

    def _obstacle_triple(self):
        return C.LAVA_TRIPLE if self.obstacle_type == "lava" else C.WALL_TRIPLE

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        w, h = params.width, params.height
        k_gx, k_gy, k_state = rng.split(keys, 3).unbind(1)

        grid = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h)
        grid = G.put(grid, w - 2, h - 2, C.GOAL_TRIPLE)
        # the strip's column and its gap's row
        gap_x = rng.randint(k_gx, (), 2, w - 2)
        gap_y = rng.randint(k_gy, (), 1, h - 1)
        grid = G.vert_wall(grid, gap_x, 1, h - 2, self._obstacle_triple())
        grid = G.put(grid, gap_x, gap_y, C.EMPTY_TRIPLE)

        pos, direction = fixed_pose(keys.shape[0], (1, 1), 0, dev)
        return base_state(grid, pos, direction, rng=k_state,
                          has_boxes=False)

    def mission_text(self, mission) -> str:
        if self.obstacle_type == "lava":
            return "avoid the lava and get to the green goal square"
        return "find the opening and get to the green goal square"
