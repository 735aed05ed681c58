"""CrossingEnv — lava or wall rivers with one guaranteed zigzag path.

Counterpart of ``minigrid_tpu/envs/crossing.py``: N rivers drawn among the
odd grid lines (a permutation over the 2K candidates, vertical then
horizontal), filled with obstacles, then one opening carved per river along a
shuffled sequence of horizontal and vertical moves, room by room.  The walk
is unrolled over the N moves, with one room index per env and draw bounds
that differ per env.
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


class CrossingEnv(Env):
    name = "Crossing"

    def __init__(self, size: int = 9, num_crossings: int = 1,
                 obstacle_type: str = "lava", max_steps: int | None = None,
                 **kwargs):
        if size % 2 != 1:
            raise ValueError("Crossing needs an odd size")
        self.num_crossings = num_crossings
        self.obstacle_type = obstacle_type
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(grid_size=size, see_through_walls=False,
                         max_steps=max_steps, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        s = params.width  # square, odd
        n = self.num_crossings
        cand = torch.arange(2, s - 2, 2, dtype=torch.int32, device=dev)
        k = cand.shape[0]
        if n > 2 * k:
            raise ValueError("more crossings than candidate lines")
        k_riv, k_path, k_open, k_state = rng.split(keys, 4).unbind(1)

        grid = G.wall_rect(empty_grid(s, s, dev), 0, 0, s, s)
        grid = G.put(grid, s - 2, s - 2, C.GOAL_TRIPLE)
        obstacle = C.LAVA_TRIPLE if self.obstacle_type == "lava" else C.WALL_TRIPLE

        # N rivers among the 2K candidates: ids [0, K) are the vertical
        # lines x = cand, [K, 2K) the horizontal ones y = cand
        sel = rng.permutation(k_riv, 2 * k)[:, :n]  # [B, n]
        slot = torch.arange(k, device=dev)
        v_mask = ((slot == sel[..., None]) & (sel < k)[..., None]).any(dim=1)  # [B, K]
        h_mask = ((slot == (sel - k)[..., None]) & (sel >= k)[..., None]).any(dim=1)

        xs, ys = G.coords(s, s, dev)
        v_river = ((xs[..., None] == cand) & v_mask[:, None, None]).any(dim=-1)
        h_river = ((ys[..., None] == cand) & h_mask[:, None, None]).any(dim=-1)
        interior = (xs >= 1) & (xs <= s - 2) & (ys >= 1) & (ys <= s - 2)
        grid = G.set_where(grid, (v_river | h_river) & interior, obstacle)

        def limits(mask):
            """[B, K+2]: 0, the selected lines in order, s-1, then zeros."""
            count = torch.cumsum(mask.to(torch.int32), dim=1)
            total = count[:, -1]
            ii = torch.arange(k + 2, device=dev)
            hot = mask[:, None, :] & (count[:, None, :] == ii[:, None])  # [B, K+2, K]
            lim = (hot.to(torch.int32) * cand).sum(dim=-1, dtype=torch.int32)
            lim = torch.where(ii == (total + 1)[:, None], s - 1, lim).to(torch.int32)
            return lim, total

        limits_v, nv = limits(v_mask)
        limits_h, _ = limits(h_mask)

        # the path: nv horizontal moves among n, shuffled
        dir_h = rng.permutation(k_path, n) < nv[:, None]  # [B, n]

        open_keys = rng.split(k_open, max(n, 1))
        room_i = torch.zeros_like(nv)
        room_j = torch.zeros_like(nv)
        for t in range(n):
            is_h = dir_h[:, t]
            lv0, lv1 = G.take1(limits_v, room_i), G.take1(limits_v, room_i + 1)
            lh0, lh1 = G.take1(limits_h, room_j), G.take1(limits_h, room_j + 1)
            # across a vertical river: x is the river, y random in the room;
            # across a horizontal one: y is the river, x random in the room
            yh = rng.randint(open_keys[:, t], (), lh0 + 1, lh1)
            xv = rng.randint(rng.fold_in(open_keys[:, t], 1), (), lv0 + 1, lv1)
            ox = torch.where(is_h, lv1, xv)
            oy = torch.where(is_h, yh, lh1)
            grid = G.put(grid, ox, oy, C.EMPTY_TRIPLE)
            room_i = room_i + is_h.to(torch.int32)
            room_j = room_j + (~is_h).to(torch.int32)

        pos, direction = fixed_pose(keys.shape[0], (1, 1), 0, dev)
        return base_state(grid, pos, direction, rng=k_state,
                          has_boxes=False)

    def mission_text(self, mission) -> str:
        if self.obstacle_type == "lava":
            return "avoid the lava and get to the green goal square"
        return "find the opening and get to the green goal square"
