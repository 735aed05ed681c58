"""BabyAI's other levels, batch-first: ActionObjDoor, FindObj, the BabyAI
KeyCorridor (a class of its own, beside MiniGrid's), OneRoom and
MoveTwoAcross.

Counterpart of ``minigrid_tpu/babyai/other.py``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.babyai import verifier as V
from minigrid_tpu_torch.babyai.level import BabyAILevel
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng

_DOOR = C.OBJECT_TO_IDX["door"]
_BALL = C.OBJECT_TO_IDX["ball"]


def _pickup_type(obj: torch.Tensor) -> dict:
    """Pick up any object of ``obj``'s type."""
    return V.single_clause(V.K_PICKUP, V.desc(obj[:, 0].to(torch.int32)))


class ActionObjDoor(BabyAILevel):
    """Pick up or go to an object, or go to or open a door."""

    name = "ActionObjDoor"

    def __init__(self, **kwargs):
        super().__init__(room_size=7, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 9).unbind(1)
        b = self.init_rooms(k[0], params)
        b, objs, _ = self.add_distractors(b, k[1], params, 1, 1, num_distractors=5)
        doors = []
        for i in range(4):
            b, door, _ = self.add_door(b, k[2 + i], 1, 1, locked=False)
            color = door[:, 1].to(torch.int32)
            doors.append(torch.stack([torch.full_like(color, _DOOR), color], dim=1))
        b = self.place_agent_in_room(b, k[6], params, 1, 1)
        cands = torch.cat([objs, torch.stack(doors, dim=1)], dim=1)  # [B, 9, 2]
        obj = G.take_row(cands, rng.randint(k[7], (), 0, 9))
        coin = rng.randint(k[8], (), 0, 2) == 0
        kind = torch.where(coin, V.K_GOTO,
                           torch.where(obj[:, 0] == _DOOR, V.K_OPEN, V.K_PICKUP))
        instr = V.single_clause(kind, V.desc(obj[:, 0], obj[:, 1]))
        return self.finish_level(b, instr, params)


class FindObjS5(BabyAILevel):
    """Pick up an object hidden in a random room."""

    name = "FindObjS5"

    def __init__(self, room_size=5, max_steps=None, **kwargs):
        if max_steps is None:
            max_steps = 20 * room_size**2
        super().__init__(room_size=room_size, max_steps=max_steps, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 5).unbind(1)
        b = self.init_rooms(k[0], params)
        # the reference draws the room's column index from the rows and its
        # row index from the columns; the same on the square lattice
        ri = rng.randint(k[1], (), 0, self.num_rows)
        rj = rng.randint(rng.fold_in(k[1], 1), (), 0, self.num_cols)
        b, obj, _ = self.add_object(b, k[2], params, ri, rj)
        b = self.place_agent_in_room(b, k[3], params, 1, 1)
        b = self.connect_all(b, k[4])
        return self.finish_level(b, _pickup_type(obj), params)


class KeyCorridor(BabyAILevel):
    """A ball behind a locked door, its key in another room; the
    instruction names the ball's type only."""

    name = "BabyAI-KeyCorridor"

    def __init__(self, num_rows=3, obj_type="ball", room_size=6, max_steps=None,
                 **kwargs):
        self.obj_type = obj_type
        if max_steps is None:
            max_steps = 30 * room_size**2
        super().__init__(room_size=room_size, num_rows=num_rows, num_cols=3,
                         max_steps=max_steps, **kwargs)

    def gen_level(self, keys, params):
        rows = self.num_rows
        k = rng.split(keys, 7).unbind(1)
        b = self.init_rooms(k[0], params)
        for j in range(1, rows):
            b = self.remove_wall(b, 1, j, 3)
        room_idx = rng.randint(k[1], (), 0, rows)
        b, door, _ = self.add_door(b, k[2], 2, room_idx, 2, locked=True)
        b, obj, _ = self.add_object(b, k[3], params, 2, room_idx, kind=self.obj_type)
        key_row = rng.randint(k[4], (), 0, rows)
        b, _, _ = self.add_object(b, k[5], params, 0, key_row, "key",
                                  door[:, 1].to(torch.int32))
        b = self.place_agent_in_room(b, k[6], params, 1, rows // 2)
        b = self.connect_all(b, rng.fold_in(k[6], 1))
        return self.finish_level(b, _pickup_type(obj), params)


class OneRoomS8(BabyAILevel):
    """Pick up the ball of one room."""

    name = "OneRoomS8"

    def __init__(self, room_size=8, **kwargs):
        super().__init__(room_size=room_size, num_rows=1, num_cols=1, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 3).unbind(1)
        b = self.init_rooms(k[0], params)
        b, _, _ = self.add_object(b, k[1], params, 0, 0, kind="ball")
        b = self.place_agent_in_room(b, k[2], params, 0, 0)
        instr = V.single_clause(V.K_PICKUP, V.desc(_BALL, n=keys.shape[0],
                                                   device=keys.device))
        return self.finish_level(b, instr, params)


class MoveTwoAcross(BabyAILevel):
    """Two PutNext tasks across two rooms, one before the other."""

    name = "MoveTwoAcross"

    def __init__(self, room_size: int, objs_per_room: int, max_steps=None, **kwargs):
        if objs_per_room > 9:
            raise ValueError("MoveTwoAcross holds at most 9 objects a room")
        self.objs_per_room = objs_per_room
        if max_steps is None:
            max_steps = 16 * room_size**2
        super().__init__(num_rows=1, num_cols=2, room_size=room_size,
                         max_steps=max_steps, **kwargs)

    def gen_level(self, keys, params):
        n = self.objs_per_room
        k = rng.split(keys, 6).unbind(1)
        b = self.init_rooms(k[0], params)
        b = self.place_agent_in_room(b, k[1], params, 0, 0)
        b, objs_l, _ = self.add_distractors(b, k[2], params, 0, 0, num_distractors=n)
        b, objs_r, _ = self.add_distractors(b, k[3], params, 1, 0, num_distractors=n)
        b = self.remove_wall(b, 0, 0, 0)
        pl = rng.permutation(k[4], n)
        pr = rng.permutation(k[5], n)
        a, d = G.take_row(objs_l, pl[:, 0]), G.take_row(objs_l, pl[:, 1])
        bb, c = G.take_row(objs_r, pr[:, 0]), G.take_row(objs_r, pr[:, 1])
        instr = V.seq_instr(
            V.S_BEFORE,
            V.single_clause(V.K_PUTNEXT, V.desc(a[:, 0], a[:, 1]),
                            V.desc(bb[:, 0], bb[:, 1])),
            V.single_clause(V.K_PUTNEXT, V.desc(c[:, 0], c[:, 1]),
                            V.desc(d[:, 0], d[:, 1])))
        valid = self.putnext_valid(b, instr, params, b["agent_pos"], b["agent_dir"])
        return self.finish_level(b, instr, params, valid)
