"""RedBlueDoorEnv — open the red door, then the blue door.

Counterpart of ``minigrid_tpu/envs/redbluedoors.py``: a 2S x S grid with an
inner S x S room, a red door in its left wall and a blue door in its right
wall.  The ordering check compares the doors' open flags before and after the
transition, so the env overrides ``step_state``; the door positions live in
``extra``.
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

_DOOR = C.OBJECT_TO_IDX["door"]
_OPEN = C.STATE_TO_IDX["open"]
_CLOSED = C.STATE_TO_IDX["closed"]


class RedBlueDoorEnv(Env):
    name = "RedBlueDoors"

    def __init__(self, size: int = 8, max_steps: int | None = None, **kwargs):
        self.size = size
        if max_steps is None:
            max_steps = 20 * size**2
        super().__init__(width=2 * size, height=size, max_steps=max_steps,
                         **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        n = keys.shape[0]
        s = self.size
        k = rng.split(keys, 5).unbind(1)

        grid = G.wall_rect(empty_grid(2 * s, s, dev), 0, 0, 2 * s, s)
        grid = G.wall_rect(grid, s // 2, 0, s, s).expand(n, 2 * s, s)

        # the agent inside the inner room
        room = G.rect_mask(2 * s, s, (s // 2, 0), (s, s), dev)
        _, agent_pos, _ = G.place_obj(k[0], grid, None, reject_mask=~room)
        draw_keys = torch.stack([k[1], k[2], k[3]], dim=1)  # [N, 3, 2]
        lo, hi = G.const([0, 1, 1], dev), G.const([4, s - 1, s - 1], dev)
        agent_dir, red_y, blue_y = rng.randint(draw_keys, (), lo, hi).unbind(1)

        red_pos = torch.stack([torch.full_like(red_y, s // 2), red_y], dim=1)
        blue_pos = torch.stack([torch.full_like(blue_y, s // 2 + s - 1), blue_y], dim=1)
        red = (_DOOR, C.COLOR_TO_IDX["red"], _CLOSED)
        blue = (_DOOR, C.COLOR_TO_IDX["blue"], _CLOSED)
        grid = G.put(grid, red_pos[:, 0], red_pos[:, 1], red)
        grid = G.put(grid, blue_pos[:, 0], blue_pos[:, 1], blue)

        extra = {"red_pos": red_pos, "blue_pos": blue_pos}
        return base_state(grid, agent_pos, agent_dir, rng=k[4],
                          extra=extra, has_boxes=False)

    @staticmethod
    def _is_open(grid: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        return G.states(G.read_word(grid, pos[:, 0], pos[:, 1])) == _OPEN

    def step_state(self, state: EnvState, action, params: EnvParams):
        red_pos, blue_pos = state.extra["red_pos"], state.extra["blue_pos"]
        red_before = self._is_open(state.grid, red_pos)
        blue_before = self._is_open(state.grid, blue_pos)

        state, reward, terminated, truncated = super().step_state(
            state, action, params)

        red_after = self._is_open(state.grid, red_pos)
        blue_after = self._is_open(state.grid, blue_pos)
        # blue opened after red: success; blue opened first, or red closed
        # again while blue is open: failure
        success = blue_after & red_before
        fail = (blue_after & ~red_before) | (~blue_after & red_after & blue_before)
        reward = torch.where(success, self.task_reward(state, params),
                             torch.where(fail, torch.zeros_like(reward), reward))
        terminated = terminated | success | fail
        state = state.replace(terminated=terminated)
        return state, reward, terminated, truncated

    def mission_text(self, mission) -> str:
        return "open the red door then the blue door"
