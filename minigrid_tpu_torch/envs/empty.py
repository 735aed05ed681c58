"""EmptyEnv — reach the goal in an empty room.

Counterpart of ``minigrid_tpu/envs/empty.py``: walled border, goal in the
bottom-right corner, the agent at a fixed corner (the default) or, for the
``Random`` variants (``agent_start_pos=None``), at a uniform free cell with a
random direction.  The room is open, so ``see_through_walls`` is on and the
observation skips occlusion.  Every draw comes from the threefry twin, in the
JAX generator's ``split(key, 4)`` order, so a batch of keys gives bitwise the
levels ``jax.vmap(EmptyEnv.generate)`` gives.
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


class EmptyEnv(Env):
    name = "Empty"

    def __init__(self, size: int = 8,
                 agent_start_pos: tuple[int, int] | None = (1, 1),
                 agent_start_dir: int = 0, max_steps: int | None = None,
                 **kwargs):
        self.agent_start_pos = agent_start_pos
        self.agent_start_dir = agent_start_dir
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(grid_size=size, max_steps=max_steps,
                         see_through_walls=True, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        """One room per key of ``keys`` (int64[N, 2])."""
        dev = resolve_device(device)
        keys = keys.to(dev)
        n = keys.shape[0]
        w, h = params.width, params.height
        grid = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h)
        grid = G.put(grid, w - 2, h - 2, C.GOAL_TRIPLE).expand(n, w, h).contiguous()

        _, k_pos, k_dir, k_state = rng.split(keys, 4).unbind(1)
        if self.agent_start_pos is not None:
            pos, direction = fixed_pose(n, self.agent_start_pos,
                                        self.agent_start_dir, dev)
        else:
            _, pos, _ = G.place_obj(k_pos, grid, None)
            direction = rng.randint(k_dir, (), 0, 4)
        return base_state(grid, pos, direction, rng=k_state.contiguous(),
                          has_boxes=False)

    def mission_text(self, mission) -> str:
        return "get to the green goal square"
