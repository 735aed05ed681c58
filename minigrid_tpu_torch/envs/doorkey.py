"""DoorKeyEnv — locked yellow door in a random splitting wall.

Counterpart of ``minigrid_tpu/envs/doorkey.py``: surrounding walls, goal
bottom-right, a vertical wall at a random column, the agent and a yellow key on
the left side, a locked yellow door at a random row of the wall.  Every draw
comes from the threefry twin (:mod:`minigrid_tpu_torch.core.rng`), so a batch
of keys gives bitwise the levels ``jax.vmap(DoorKeyEnv.generate)`` gives.
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
_KEY = C.OBJECT_TO_IDX["key"]
_YELLOW = C.COLOR_TO_IDX["yellow"]
_LOCKED = C.STATE_TO_IDX["locked"]


class DoorKeyEnv(Env):
    name = "DoorKey"

    def __init__(self, size: int = 8, max_steps: int | None = None, **kwargs):
        if max_steps is None:
            max_steps = 10 * size**2
        super().__init__(grid_size=size, max_steps=max_steps, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        """Closed-form generator over a batch of keys int64[N, 2].

        The free region left of the splitting wall is the rectangle
        x in [1, split), y in [1, h-1), so the reference's rejection-sampled
        placements reduce to integer draws over that rectangle."""
        dev = resolve_device(device)
        keys = keys.to(dev)
        w, h = params.width, params.height
        k_split, k_cells, k_dir, k_door, k_state = rng.split(keys, 5).unbind(1)

        # static base: outer walls + goal bottom-right
        base = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h)
        base = G.put(base, w - 2, h - 2, C.GOAL_TRIPLE)

        split = rng.randint(k_split, (), 2, w - 2)  # [N]
        rows = h - 2
        n_free = (split - 1) * rows
        k1, k2 = rng.split(k_cells).unbind(1)
        # The four remaining draws are independent: one batched randint
        # over their keys, each with its own range.
        draw_keys = torch.stack([k1, k2, k_dir, k_door], dim=1)  # [N, 4, 2]
        hi = torch.stack([n_free, n_free - 1, torch.full_like(n_free, 4),
                          torch.full_like(n_free, w - 2)], dim=1)
        lo = torch.zeros_like(hi)
        lo[:, 3] = 1
        r1, r2, agent_dir, door_y = rng.randint(draw_keys, (), lo, hi).unbind(1)
        # agent and key: two distinct cells of the left interior
        r2 = r2 + (r2 >= r1).to(torch.int32)
        agent_pos = torch.stack([1 + r1 // rows, 1 + r1 % rows], dim=1)
        key_x, key_y = 1 + r2 // rows, 1 + r2 % rows

        xs, ys = G.coords(w, h, dev)
        wall_mask = xs == split[:, None, None]
        door_mask = wall_mask & (ys == door_y[:, None, None])
        key_mask = (xs == key_x[:, None, None]) & (ys == key_y[:, None, None])
        grid = G.set_where(base, wall_mask, C.WALL_TRIPLE)
        grid = G.set_where(grid, door_mask, (_DOOR, _YELLOW, _LOCKED))
        grid = G.set_where(grid, key_mask, (_KEY, _YELLOW, 0))
        return base_state(grid, agent_pos, agent_dir.contiguous(),
                          rng=k_state.contiguous(), has_boxes=False)
