"""LockedRoomEnv — six rooms off a hallway, one locked with the goal inside.

Counterpart of ``minigrid_tpu/envs/lockedroom.py``: the static six-room
layout around a central hallway, a random locked room holding the goal, six
distinct door colors, the matching key in another random room and the agent
in the hallway.  Success is the base goal rule.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.roomgrid import stamp_words, type_triple
from minigrid_tpu_torch.core.sampling import SORTED_COLOR_IDS
from minigrid_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    base_state,
    empty_grid,
    resolve_device,
)

_DOOR = C.OBJECT_TO_IDX["door"]
_KEY = C.OBJECT_TO_IDX["key"]
_CLOSED = C.STATE_TO_IDX["closed"]
_LOCKED = C.STATE_TO_IDX["locked"]


class LockedRoomEnv(Env):
    name = "LockedRoom"

    def __init__(self, size: int = 19, max_steps: int | None = None, **kwargs):
        self.size = size
        if max_steps is None:
            max_steps = 10 * size
        super().__init__(grid_size=size, max_steps=max_steps, **kwargs)
        w = h = size
        lw, rw = w // 2 - 2, w // 2 + 2
        grid = G.wall_rect(empty_grid(w, h, "cpu"), 0, 0, w, h)
        grid = G.vert_wall(grid, lw, 0)
        grid = G.vert_wall(grid, rw, 0)
        for n in range(3):
            j = n * (h // 3)
            grid = G.horz_wall(grid, 0, j, lw)
            grid = G.horz_wall(grid, rw, j, w - rw)
        self._walls = grid.numpy()
        # the six rooms' (top, size, door cell), (left, right) per band
        rooms = []
        for n in range(3):
            j = n * (h // 3)
            room_w, room_h = lw + 1, h // 3 + 1
            rooms.append(((0, j), (room_w, room_h), (lw, j + 3)))
            rooms.append(((rw, j), (room_w, room_h), (rw, j + 3)))
        self._tops = np.asarray([r[0] for r in rooms], np.int32)
        self._sizes = np.asarray([r[1] for r in rooms], np.int32)
        self._door_pos = np.asarray([r[2] for r in rooms], np.int32)

    def _cell_in_room(self, keys: torch.Tensor, room: torch.Tensor) -> torch.Tensor:
        """A uniform interior cell of one room per env, drawn as two
        ``randint`` with that room's bounds (keys ``[B, 2, 2]``, one for x
        and one for y): int32[B, 2]."""
        dev = keys.device
        top = G.take_row(G.const(self._tops, dev, torch.int32).expand(len(room), -1, -1),
                         room)
        size = G.take_row(G.const(self._sizes, dev, torch.int32).expand(len(room), -1, -1),
                          room)
        return top + 1 + rng.randint(keys, (), 0, size - 2)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        n = keys.shape[0]
        w = h = self.size
        lw, rw = w // 2 - 2, w // 2 + 2
        k = rng.split(keys, 10)
        grid = G.const(self._walls, dev, torch.int32).expand(n, -1, -1)

        # the locked room, and the goal anywhere inside it
        locked = rng.randint(k[:, 0], (), 0, 6)
        goal = self._cell_in_room(k[:, 1:3], locked)
        grid = G.put(grid, goal[:, 0], goal[:, 1], C.GOAL_TRIPLE)

        # six distinct door colors, the locked room's door locked
        colors = G.take_vec(G.const(SORTED_COLOR_IDS, dev, torch.int32),
                            rng.permutation(k[:, 3], 10)[:, :6])
        states = torch.where(torch.arange(6, device=dev) == locked[:, None],
                             _LOCKED, _CLOSED).to(torch.int32)
        doors = _DOOR | (colors << 8) | (states << 16)
        door_pos = G.const(self._door_pos, dev, torch.int32).expand(n, -1, -1)
        grid = stamp_words(grid, door_pos, doors, torch.ones_like(states, dtype=torch.bool))

        # the key in another room, drawn among the five others
        kr = rng.randint(k[:, 4], (), 0, 5)
        kr = kr + (kr >= locked).to(torch.int32)
        key_cell = self._cell_in_room(k[:, 5:7], kr)
        locked_color = G.take1(colors, locked)
        grid = G.put(grid, key_cell[:, 0], key_cell[:, 1],
                     type_triple(_KEY, locked_color, n, dev))

        # the agent in the hallway
        hall = G.rect_mask(w, h, (lw, 0), (rw - lw, h), dev)
        _, agent_pos, _ = G.place_obj(k[:, 7], grid, None, reject_mask=~hall)
        agent_dir = rng.randint(k[:, 8], (), 0, 4)

        zero = torch.zeros_like(kr)
        mission = torch.stack([locked_color, G.take1(colors, kr), zero, zero], dim=1)
        return base_state(grid, agent_pos, agent_dir, rng=k[:, 9], mission=mission,
                          has_boxes=False)

    def mission_text(self, mission) -> str:
        lc = C.IDX_TO_COLOR[int(mission[0])]
        kc = C.IDX_TO_COLOR[int(mission[1])]
        return (f"get the {lc} key from the {kc} room,"
                f" unlock the {lc} door and go to the goal")

    def mission_codes(self) -> np.ndarray:
        vals = list(C.COLOR_TO_IDX.values())
        return np.asarray([(a, b, 0, 0) for a in vals for b in vals if a != b],
                          dtype=np.int32)
