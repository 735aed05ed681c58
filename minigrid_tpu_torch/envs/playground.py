"""PlaygroundEnv — 3x3 rooms, colored doors, 12 random objects, no task.

Counterpart of ``minigrid_tpu/envs/playground.py``.  The JAX generator splits
its key 52 ways and consumes the keys in order: for each wall segment between
rooms a door offset and a door color, then the agent's cell and direction,
then a (type, color) and a cell for each of the 12 objects, then the state's
stream.  The walls are static and no door lies on a later wall, so the port
draws every door at once and writes them in one scatter; the objects are
placed one after another, each avoiding the agent.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.roomgrid import stamp_words
from minigrid_tpu_torch.core.sampling import rand_color, rand_type_color
from minigrid_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    base_state,
    empty_grid,
    resolve_device,
)

_DOOR = C.OBJECT_TO_IDX["door"]
_CLOSED = C.STATE_TO_IDX["closed"]
_TYPE_IDS = (C.OBJECT_TO_IDX["key"], C.OBJECT_TO_IDX["ball"], C.OBJECT_TO_IDX["box"])
_NUM_OBJS = 12
_NUM_KEYS = 52


class PlaygroundEnv(Env):
    name = "Playground"

    def __init__(self, max_steps: int = 100, **kwargs):
        super().__init__(grid_size=19, max_steps=max_steps, **kwargs)
        w = h = self.width
        room_w, room_h = w // 3, h // 3
        grid = G.wall_rect(empty_grid(w, h, "cpu"), 0, 0, w, h)
        # per door, in the generator's order: (key index of its offset, the
        # fixed coordinate, the first cell along the wall, the offset's
        # range, horizontal wall?)
        doors, ki = [], 0
        for j in range(3):
            for i in range(3):
                xl, yt = i * room_w, j * room_h
                xr, yb = xl + room_w, yt + room_h
                if i + 1 < 3:
                    grid = G.vert_wall(grid, xr, yt, room_h)
                    doors.append((ki, xr, yt + 1, yb - yt - 2, False))
                    ki += 2
                if j + 1 < 3:
                    grid = G.horz_wall(grid, xl, yb, room_w)
                    doors.append((ki, yb, xl + 1, xr - xl - 2, True))
                    ki += 2
        self._walls = grid.numpy()
        self._doors = doors
        self._first_free_key = ki

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        n = keys.shape[0]
        k = rng.split(keys, _NUM_KEYS)
        grid = G.const(self._walls, dev, torch.int32).expand(n, -1, -1)

        # the doors: each draws its offset from key ki and its color from ki + 1
        ki = G.const([d[0] for d in self._doors], dev)
        fixed, first, span, horizontal = (
            G.const([d[c] for d in self._doors], dev, dtype)
            for c, dtype in ((1, torch.int32), (2, torch.int32), (3, torch.int32),
                             (4, torch.bool)))
        offset = rng.randint(k[:, ki], (), 0, span)  # [B, n_doors]
        color = rand_color(k[:, ki + 1])
        along = first + offset
        pos = torch.stack([torch.where(horizontal, along, fixed),
                           torch.where(horizontal, fixed, along)], dim=-1)
        words = _DOOR | (color << 8) | (_CLOSED << 16)
        grid = stamp_words(grid, pos, words, torch.ones_like(offset, dtype=torch.bool))

        a = self._first_free_key
        _, agent_pos, _ = G.place_obj(k[:, a], grid, None)
        agent_dir = rng.randint(k[:, a + 1], (), 0, 4)

        # the objects: all (type, color) pairs at once, then one cell each
        obj_keys = k[:, a + 2:a + 2 + 2 * _NUM_OBJS]
        objs = rand_type_color(obj_keys[:, 0::2], _TYPE_IDS)  # [B, 12, 2]
        triples = torch.cat([objs, torch.zeros_like(objs[..., :1])], dim=-1)
        for o in range(_NUM_OBJS):
            grid, _, _ = G.place_obj(obj_keys[:, 2 * o + 1], grid,
                                     triples[:, o].to(torch.uint8), agent_pos=agent_pos)
        return base_state(grid, agent_pos, agent_dir, rng=k[:, a + 2 + 2 * _NUM_OBJS])
