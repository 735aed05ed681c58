"""BabyAI Open levels, batch-first.

Counterpart of ``minigrid_tpu/babyai/open.py``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.babyai import verifier as V
from minigrid_tpu_torch.babyai.level import BabyAILevel
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.sampling import SORTED_COLOR_IDS

_DOOR = C.OBJECT_TO_IDX["door"]
_DOOR_LOCAL = V.OBJ_TYPES.index("door") + 1


def _open(color, strict=False) -> dict:
    return V.single_clause(V.K_OPEN, V.desc(_DOOR, color), strict=strict)


def _door_colors(keys: torch.Tensor, n: int) -> torch.Tensor:
    """n distinct door colors per env: a permutation prefix over the sorted
    color names, int32[B, n]."""
    table = G.const(SORTED_COLOR_IDS, keys.device, torch.int32)
    return G.take_vec(table, rng.permutation(keys, 10)[:, :n])


class Open(BabyAILevel):
    """Open a door, maybe in another room of the maze."""

    name = "Open"

    def gen_level(self, keys, params):
        k = rng.split(keys, 6).unbind(1)
        b = self.init_rooms(k[0], params)
        b = self.place_agent_any(b, k[1], params)
        b = self.connect_all(b, k[2])
        b, _, _ = self.add_distractors(b, k[3], params, num_distractors=18,
                                       all_unique=False)
        valid = self.objs_reachable(b, params)
        # a uniform door of the grid: a categorical over the cells, held on
        # its index
        grid = b["grid"]
        doors = (G.types(grid) == _DOOR).flatten(1)
        pos = rng.categorical(k[4], torch.where(doors, 0.0, -torch.inf))
        color = G.colors(grid.flatten(1).gather(1, pos.to(torch.int64)[:, None])[:, 0])
        return self.finish_level(b, _open(color), params, valid & doors.any(dim=1))


class OpenRedDoor(BabyAILevel):
    """Open the red door between two rooms."""

    name = "OpenRedDoor"

    def __init__(self, **kwargs):
        super().__init__(num_rows=1, num_cols=2, room_size=5, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 3).unbind(1)
        red = C.COLOR_TO_IDX["red"]
        b = self.init_rooms(k[0], params)
        b, _, _ = self.add_door(b, k[1], 0, 0, 0, color=red, locked=False)
        b = self.place_agent_in_room(b, k[2], params, 0, 0)
        instr = V.single_clause(V.K_OPEN, V.desc(_DOOR, red, n=keys.shape[0],
                                                 device=keys.device))
        return self.finish_level(b, instr, params)


class OpenDoor(BabyAILevel):
    """Open the door named by its color or by its location."""

    name = "OpenDoor"

    def __init__(self, debug=False, select_by=None, **kwargs):
        self.select_by = select_by
        self.debug = debug
        super().__init__(**kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 8).unbind(1)
        b = self.init_rooms(k[0], params)
        colors = _door_colors(k[1], 4)
        for i in range(4):
            b, _, _ = self.add_door(b, k[2 + i], 1, 1, door_idx=i, color=colors[:, i],
                                    locked=False)
        if self.select_by is None:
            by_color = rng.randint(k[6], (), 0, 2) == 0
        else:
            by_color = torch.full((keys.shape[0],), self.select_by == "color",
                                  device=keys.device)
        loc = 1 + rng.randint(rng.fold_in(k[6], 1), (), 0, 4)
        d = torch.stack([torch.full_like(loc, _DOOR_LOCAL),
                         torch.where(by_color, colors[:, 0], 0),
                         torch.where(by_color, 0, loc)], dim=1)
        b = self.place_agent_in_room(b, k[7], params, 1, 1)
        return self.finish_level(b, V.single_clause(V.K_OPEN, d, strict=self.debug),
                                 params)


class OpenDoorColor(OpenDoor):
    name = "OpenDoorColor"

    def __init__(self, **kwargs):
        super().__init__(select_by="color", **kwargs)


class OpenDoorLoc(OpenDoor):
    name = "OpenDoorLoc"

    def __init__(self, **kwargs):
        super().__init__(select_by="loc", **kwargs)


class OpenTwoDoors(BabyAILevel):
    """Open door X, then door Y, on opposite walls."""

    name = "OpenTwoDoors"

    def __init__(self, first_color=None, second_color=None, strict=False,
                 max_steps=None, **kwargs):
        self.first_color = first_color
        self.second_color = second_color
        self.strict = strict
        room_size = 6
        if max_steps is None:
            max_steps = 20 * room_size**2
        super().__init__(room_size=room_size, max_steps=max_steps, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 5).unbind(1)
        b = self.init_rooms(k[0], params)
        colors = _door_colors(k[1], 2)
        c1 = (torch.full_like(colors[:, 0], C.COLOR_TO_IDX[self.first_color])
              if self.first_color else colors[:, 0])
        c2 = (torch.full_like(colors[:, 1], C.COLOR_TO_IDX[self.second_color])
              if self.second_color else colors[:, 1])
        b, _, _ = self.add_door(b, k[2], 1, 1, 2, color=c1, locked=False)
        b, _, _ = self.add_door(b, k[3], 1, 1, 0, color=c2, locked=False)
        b = self.place_agent_in_room(b, k[4], params, 1, 1)
        instr = V.seq_instr(V.S_BEFORE, _open(c1, self.strict), _open(c2))
        return self.finish_level(b, instr, params)


class OpenDoorsOrder(BabyAILevel):
    """Open one door, or two in a given order."""

    name = "OpenDoorsOrder"

    def __init__(self, num_doors: int, debug=False, max_steps=None, **kwargs):
        assert num_doors >= 2
        self.num_doors = num_doors
        self.debug = debug
        room_size = 6
        if max_steps is None:
            max_steps = 20 * room_size**2
        super().__init__(room_size=room_size, max_steps=max_steps, **kwargs)

    def gen_level(self, keys, params):
        n = self.num_doors
        k = rng.split(keys, n + 5).unbind(1)
        b = self.init_rooms(k[0], params)
        colors = _door_colors(k[1], n)
        for i in range(n):
            b, _, _ = self.add_door(b, k[2 + i], 1, 1, color=colors[:, i], locked=False)
        b = self.place_agent_in_room(b, k[n + 2], params, 1, 1)
        # two distinct doors and a mode: 0 one door, 1 before, 2 after
        p = rng.permutation(k[n + 3], n)
        c1, c2 = G.take1(colors, p[:, 0]), G.take1(colors, p[:, 1])
        mode = rng.randint(k[n + 4], (), 0, 3)
        seq = V.seq_instr(torch.where(mode == 1, V.S_BEFORE, V.S_AFTER),
                          _open(c1, self.debug), _open(c2, self.debug))
        # mode 0: a single clause, operand b zeroed
        two = (mode != 0)[:, None]
        keep = torch.cat([torch.ones_like(two), torch.ones_like(two), two, two],
                         dim=1).to(torch.int32)
        instr = {**seq,
                 "seq_kind": torch.where(mode == 0, V.S_SINGLE, seq["seq_kind"]),
                 "b_and": seq["b_and"] & (mode != 0),
                 "kinds": seq["kinds"] * keep,
                 "d1": seq["d1"] * keep[..., None]}
        return self.finish_level(b, instr, params)
