"""MultiRoomEnv — a chain of connected rooms ending in a goal.

Counterpart of ``minigrid_tpu/envs/multiroom.py``.  One chain attempt places
rooms one after another: each step draws 8 tries of (exit door in the
previous room, room size, top-left corner by the entry-wall rule), keeps the
first try that is in bounds and overlaps no room but its predecessor, and the
attempt ends when no try fits or the chain is long enough.  The JAX package
runs that as a ``lax.while_loop`` per attempt under ``vmap``; here the
``num_attempts`` attempts of every env are a second batch axis ``[B, A]`` and
the loop runs ``maxNumRooms`` times, each lane moving only while it is live.
The longest attempt (the first of the longest) is rasterized, its doors get
colors distinct from the previous door's, the agent starts in the first room
and the goal lies in the last.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.sampling import SORTED_COLOR_IDS
from minigrid_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    base_state,
    empty_grid,
    resolve_device,
)

_DOOR = C.OBJECT_TO_IDX["door"]
_CLOSED = C.STATE_TO_IDX["closed"]
_TRIES = 8  # tries per room before an attempt gives up


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last dim (0 where there is none),
    as ``jnp.argmax`` of a bool array."""
    return mask.to(torch.int32).argmax(dim=-1)


class MultiRoomEnv(Env):
    # Generation is a chain builder with retries; episode ends scatter, so
    # the batch engine serves auto-resets from the pooled ring with small
    # refill windows (B/128).
    expensive_generation = True
    desynchronized_resets = True
    pool_refill_fraction = 1 / 128

    name = "MultiRoom"

    def __init__(self, minNumRooms: int, maxNumRooms: int, maxRoomSize: int = 10,
                 max_steps: int | None = None, num_attempts: int = 16, **kwargs):
        if not (minNumRooms > 0 and maxNumRooms >= minNumRooms and maxRoomSize >= 4):
            raise ValueError("MultiRoom needs 0 < minNumRooms <= maxNumRooms "
                             "and maxRoomSize >= 4")
        self.minNumRooms = minNumRooms
        self.maxNumRooms = maxNumRooms
        self.maxRoomSize = maxRoomSize
        self.num_attempts = num_attempts
        if max_steps is None:
            max_steps = maxNumRooms * 20
        super().__init__(grid_size=25, max_steps=max_steps, **kwargs)

    def _chain_attempts(self, keys: torch.Tensor, num_rooms: torch.Tensor,
                        width: int, height: int):
        """Room chains for keys ``[B, A, 2]`` and ``num_rooms`` int32[B]:
        (tops, sizes, entries int32[B, A, n, 2], count int32[B, A])."""
        n, t = self.maxNumRooms, _TRIES
        dev = keys.device
        lead = keys.shape[:-1]
        key, k_entry = rng.split(keys).unbind(-2)
        epos = rng.randint(k_entry, (2,), 0, width - 2)  # [B, A, 2]
        tops = torch.zeros(lead + (n, 2), dtype=torch.int32, device=dev)
        sizes = torch.zeros_like(tops)
        entries = torch.zeros_like(tops)
        count = torch.zeros(lead, dtype=torch.int32, device=dev)
        entry_wall = torch.full(lead, 2, dtype=torch.int32, device=dev)
        dead = torch.zeros(lead, dtype=torch.bool, device=dev)
        slot = torch.arange(n, device=dev)
        target = num_rooms[:, None]
        lo = G.const([0, 0, 0, 4, 4, 0], dev)

        def pick(v, i):  # v[..., i] per lane, i int[...]
            return v.gather(-1, i[..., None])[..., 0]

        # each pass commits one room or kills the lane, so maxNumRooms
        # passes reach the while loop's end in every lane
        for _ in range(n):
            live = (count < target) & ~dead
            key_next, k_exit, k_epos, k_sx, k_sy, k_top = rng.split(key, 6).unbind(-2)
            first = (count == 0)[..., None]
            prev = (slot == (count - 1).clamp(min=0)[..., None])[..., None]  # [B,A,n,1]
            prev_top = torch.where(prev, tops, 0).sum(dim=-2, dtype=torch.int32)
            prev_size = torch.where(prev, sizes, 0).sum(dim=-2, dtype=torch.int32)

            # the pass's six draws of 8 tries, independent of one another, in
            # one randint over their keys (each with its own range): the
            # exit wall, the exit door's offsets along x and y, the room's
            # size, and the corner's offset
            draw_keys = torch.stack([k_exit, k_epos, rng.fold_in(k_epos, 1), k_sx,
                                     k_sy, k_top], dim=-2)  # [B, A, 6, 2]
            hi = torch.stack([torch.full_like(count, 3), prev_size[..., 0] - 2,
                              prev_size[..., 1] - 2,
                              torch.full_like(count, self.maxRoomSize + 1),
                              torch.full_like(count, self.maxRoomSize + 1),
                              torch.full_like(count, 1 << 30)], dim=-1)
            i3, off_x, off_y, sx, sy, r1 = rng.randint(
                draw_keys, (t,), lo[:, None], hi[..., None]).unbind(-2)  # [B, A, T]

            # the tries' exit doors, on a wall of the previous room other
            # than the one it was entered by
            exit_wall = i3 + (i3 >= entry_wall[..., None]).to(torch.int32)
            off_x, off_y = off_x + 1, off_y + 1
            px, py = prev_top[..., 0:1], prev_top[..., 1:2]
            sx_prev, sy_prev = prev_size[..., 0:1], prev_size[..., 1:2]
            exit_x = torch.where(exit_wall == 0, px + sx_prev - 1,
                                 torch.where(exit_wall == 2, px, px + off_x))
            exit_y = torch.where(exit_wall == 1, py + sy_prev - 1,
                                 torch.where(exit_wall == 3, py, py + off_y))
            ex = torch.where(first, epos[..., 0:1], exit_x)
            ey = torch.where(first, epos[..., 1:2], exit_y)
            wall = torch.where(first, 2, (exit_wall + 2) % 4)

            # the room's corner by the entry-wall rule (the entry door never
            # lands on a corner)
            def span(first, end):  # floor modulo, as jnp's % on int32
                return first + torch.remainder(r1, (end - first).clamp(min=1))

            top_x = torch.where(wall == 0, ex - sx + 1,
                                torch.where(wall == 2, ex, span(ex - sx + 2, ex)))
            top_y = torch.where(wall == 1, ey - sy + 1,
                                torch.where(wall == 3, ey, span(ey - sy + 2, ey)))
            top_x = torch.where(first, ex, top_x)
            top_y = torch.where(first, ey, top_y)

            # in bounds (the reference's asymmetric checks) and clear of
            # every room but the predecessor
            in_bounds = ((top_x >= 0) & (top_y >= 0)
                         & (top_x + sx <= width) & (top_y + sy < height))
            prior = (slot < (count - 1)[..., None])[..., None, :]  # [B,A,1,n]
            ox, oy = tops[..., None, :, 0], tops[..., None, :, 1]
            osx, osy = sizes[..., None, :, 0], sizes[..., None, :, 1]
            tx, ty = top_x[..., None], top_y[..., None]
            non_overlap = ((tx + sx[..., None] < ox) | (ox + osx <= tx)
                           | (ty + sy[..., None] < oy) | (oy + osy <= ty))
            valid = in_bounds & ~(prior & ~non_overlap).any(dim=-1)  # [B,A,T]

            # the first valid try commits
            commit = valid.any(dim=-1)
            k = _first_true(valid)
            row = ((slot == count[..., None]) & commit[..., None])[..., None]
            tops_new = torch.where(row, torch.stack([pick(top_x, k), pick(top_y, k)],
                                                    -1)[..., None, :], tops)
            sizes_new = torch.where(row, torch.stack([pick(sx, k), pick(sy, k)],
                                                     -1)[..., None, :], sizes)
            entries_new = torch.where(row, torch.stack([pick(ex, k), pick(ey, k)],
                                                       -1)[..., None, :], entries)
            wall_new = torch.where(commit, pick(wall, k), entry_wall)

            lv = live[..., None, None]
            tops = torch.where(lv, tops_new, tops)
            sizes = torch.where(lv, sizes_new, sizes)
            entries = torch.where(lv, entries_new, entries)
            count = torch.where(live, count + commit.to(torch.int32), count)
            entry_wall = torch.where(live, wall_new, entry_wall)
            dead = torch.where(live, ~commit, dead)
            key = torch.where(live[..., None], key_next, key)
        return tops, sizes, entries, count

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        b = keys.shape[0]
        w, h = params.width, params.height
        n, a = self.maxNumRooms, self.num_attempts
        k = rng.split(keys, a + 6)  # [B, A+6, 2]

        num_rooms = rng.randint(k[:, 0], (), self.minNumRooms, self.maxNumRooms + 1)
        tops, sizes, entries, count = self._chain_attempts(
            rng.split(k[:, 1], a), num_rooms, w, h)
        # the first of the longest attempts
        best = count.argmax(dim=1)
        tops, sizes, entries = (G.take_row(v, best) for v in (tops, sizes, entries))
        count = G.take1(count, best)

        # the rooms' walls
        grid = empty_grid(w, h, dev, (b,))
        xs, ys = G.coords(w, h, dev)
        for r in range(n):
            x0, y0 = tops[:, r, 0, None, None], tops[:, r, 1, None, None]
            x1 = x0 + sizes[:, r, 0, None, None]
            y1 = y0 + sizes[:, r, 1, None, None]
            inside = (xs >= x0) & (xs < x1) & (ys >= y0) & (ys < y1)
            border = inside & ((xs == x0) | (xs == x1 - 1) | (ys == y0) | (ys == y1 - 1))
            grid = G.set_where(grid, border & (r < count)[:, None, None], C.WALL_TRIPLE)

        # the chain's doors, each color unlike the previous door's
        prev_rank = torch.full((b,), -1, dtype=torch.int32, device=dev)
        colors = G.const(SORTED_COLOR_IDS, dev, torch.int32)
        # door r draws from fold_in(key, r): a color rank among 9 (skipping
        # the previous door's) and, for the first door, among 10; all doors'
        # draws at once
        kc = rng.fold_in(k[:, a + 1, None], torch.arange(1, n, device=dev))
        ranks = rng.randint(torch.stack([kc, rng.fold_in(kc, 1)], dim=-2), (), 0,
                            G.const([9, 10], dev))  # [B, n-1, 2]
        for r in range(1, n):
            i9, i10 = ranks[:, r - 1, 0], ranks[:, r - 1, 1]
            rank = torch.where(prev_rank < 0, i10,
                               i9 + (i9 >= prev_rank).to(torch.int32))
            active = r < count
            color = G.take1(colors, rank)
            door = torch.stack([torch.full_like(color, _DOOR), color,
                                torch.full_like(color, _CLOSED)], dim=1).to(torch.uint8)
            grid = G.put_if(grid, entries[:, r, 0], entries[:, r, 1], door, active)
            prev_rank = torch.where(active, rank, prev_rank)

        # the agent in the first room, the goal in the last
        _, agent_pos, _ = G.place_obj(k[:, a + 2], grid, None,
                                      top=(tops[:, 0, 0], tops[:, 0, 1]),
                                      size=(sizes[:, 0, 0], sizes[:, 0, 1]))
        agent_dir = rng.randint(k[:, a + 3], (), 0, 4)
        last = count - 1  # -1 (no room) reads zeros, as the masked reduce
        last_top, last_size = G.take_row(tops, last), G.take_row(sizes, last)
        grid, _, _ = G.place_obj(k[:, a + 4], grid, C.GOAL_TRIPLE, agent_pos=agent_pos,
                                 top=(last_top[:, 0], last_top[:, 1]),
                                 size=(last_size[:, 0], last_size[:, 1]))
        return base_state(grid, agent_pos, agent_dir, rng=k[:, a + 5],
                          has_boxes=False)

    def mission_text(self, mission) -> str:
        return "traverse the rooms to get to the goal"
