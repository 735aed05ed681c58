"""MemoryEnv — a T-maze: remember the start object, go to its match.

Counterpart of ``minigrid_tpu/envs/memory.py``: a start room holding a green
key or ball, a hallway (of random length in the ``Random`` ids) and two
candidate objects at its end.  Stepping onto the cell in front of the
matching object succeeds, onto the other fails; ``pickup`` acts as
``toggle``.  The two cells live in ``extra``, a dict.
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
from minigrid_tpu_torch.core.step import PICKUP, TOGGLE

_KEY = C.OBJECT_TO_IDX["key"]
_BALL = C.OBJECT_TO_IDX["ball"]
_GREEN = C.COLOR_TO_IDX["green"]


def _green(obj_type: torch.Tensor) -> torch.Tensor:
    """uint8[N, 3] green objects of the given types."""
    return torch.stack([obj_type, torch.full_like(obj_type, _GREEN),
                        torch.zeros_like(obj_type)], dim=1).to(torch.uint8)


class MemoryEnv(Env):
    name = "Memory"

    def __init__(self, size: int = 8, random_length: bool = False,
                 max_steps: int | None = None, **kwargs):
        if size % 2 != 1:
            raise ValueError("Memory needs an odd size")
        self.random_length = random_length
        if max_steps is None:
            max_steps = 5 * size**2
        super().__init__(grid_size=size, see_through_walls=False,
                         max_steps=max_steps, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        n = keys.shape[0]
        w, h = params.width, params.height
        k = rng.split(keys, 6).unbind(1)
        mid = h // 2
        upper, lower = mid - 2, mid + 2  # the start room's walls

        if self.random_length:
            hallway_end = rng.randint(k[0], (), 4, w - 2)
        else:
            hallway_end = torch.full((n,), w - 3, dtype=torch.int32, device=dev)

        grid = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h)
        grid = G.horz_wall(grid, 1, upper, 4)
        grid = G.horz_wall(grid, 1, lower, 4)
        grid = G.put(grid, 4, upper + 1, C.WALL_TRIPLE)
        grid = G.put(grid, 4, lower - 1, C.WALL_TRIPLE)
        xs, ys = G.coords(w, h, dev)
        end = hallway_end[:, None, None]
        hall = (xs >= 5) & (xs < end) & ((ys == upper + 1) | (ys == lower - 1))
        grid = G.set_where(grid, hall, C.WALL_TRIPLE)
        vwall = ((xs == end) & (ys != mid)) | (xs == end + 2)
        grid = G.set_where(grid, vwall, C.WALL_TRIPLE)

        # the agent somewhere along the hallway, facing east
        ax = rng.randint(k[1], (), 1, hallway_end + 1)
        agent_pos = torch.stack([ax, torch.full_like(ax, mid)], dim=1)
        agent_dir = torch.zeros((n,), dtype=torch.int32, device=dev)

        start_is_key, top_is_ball = (rng.randint(torch.stack([k[2], k[3]], 1), (), 0, 2)
                                     == 0).unbind(1)
        start_t = torch.where(start_is_key, _KEY, _BALL).to(torch.int32)
        top_t = torch.where(top_is_ball, _BALL, _KEY).to(torch.int32)
        bot_t = torch.where(top_is_ball, _KEY, _BALL).to(torch.int32)
        grid = G.put(grid, 1, mid - 1, _green(start_t))
        grid = G.put(grid, hallway_end + 1, mid - 2, _green(top_t))
        grid = G.put(grid, hallway_end + 1, mid + 2, _green(bot_t))

        # the cells one step toward the hallway from the matching object and
        # from the other one
        matches_top = start_t == top_t
        success_y = torch.where(matches_top, mid - 1, mid + 1).to(torch.int32)
        failure_y = torch.where(matches_top, mid + 1, mid - 1).to(torch.int32)
        extra = {
            "success_pos": torch.stack([hallway_end + 1, success_y], dim=1),
            "failure_pos": torch.stack([hallway_end + 1, failure_y], dim=1),
        }
        return base_state(grid, agent_pos, agent_dir, rng=k[5],
                          extra=extra, has_boxes=False)

    def step_state(self, state: EnvState, action, params: EnvParams):
        action = action.to(torch.int32)
        action = torch.where(action == PICKUP, TOGGLE, action)
        state, reward, terminated, truncated = super().step_state(
            state, action, params)
        at_success = (state.agent_pos == state.extra["success_pos"]).all(dim=1)
        at_failure = (state.agent_pos == state.extra["failure_pos"]).all(dim=1)
        reward = torch.where(at_success, self.task_reward(state, params),
                             torch.where(at_failure, torch.zeros_like(reward), reward))
        terminated = terminated | at_success | at_failure
        state = state.replace(terminated=terminated)
        return state, reward, terminated, truncated

    def mission_text(self, mission) -> str:
        return "go to the matching object at the end of the hallway"
