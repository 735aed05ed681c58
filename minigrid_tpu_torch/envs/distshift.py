"""DistShiftEnv — two lava strips, one on a variant row.

Counterpart of ``minigrid_tpu/envs/distshift.py``: the goal at (W-2, 1), lava
strips along row 1 and row ``strip2_row`` over columns 3..W-4, the agent at a
fixed start or a random free cell.
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


class DistShiftEnv(Env):
    name = "DistShift"

    def __init__(self, width: int = 9, height: int = 7, agent_start_pos=(1, 1),
                 agent_start_dir: int = 0, strip2_row: int = 2,
                 max_steps: int | None = None, **kwargs):
        self.agent_start_pos = agent_start_pos
        self.agent_start_dir = agent_start_dir
        self.strip2_row = strip2_row
        if max_steps is None:
            max_steps = 4 * width * height
        super().__init__(width=width, height=height, see_through_walls=True,
                         max_steps=max_steps, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        n = keys.shape[0]
        w, h = params.width, params.height
        k_pos, k_dir, k_state = rng.split(keys, 3).unbind(1)

        grid = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h)
        grid = G.put(grid, w - 2, 1, C.GOAL_TRIPLE)
        grid = G.horz_wall(grid, 3, 1, w - 6, C.LAVA_TRIPLE)
        grid = G.horz_wall(grid, 3, self.strip2_row, w - 6, C.LAVA_TRIPLE)
        grid = grid.expand(n, w, h)

        if self.agent_start_pos is not None:
            pos, direction = fixed_pose(n, self.agent_start_pos,
                                        self.agent_start_dir, dev)
        else:
            _, pos, _ = G.place_obj(k_pos, grid, None)
            direction = rng.randint(k_dir, (), 0, 4)
        return base_state(grid, pos, direction, rng=k_state,
                          has_boxes=False)

    def mission_text(self, mission) -> str:
        return "get to the green goal square"
