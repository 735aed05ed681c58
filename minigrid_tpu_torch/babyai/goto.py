"""BabyAI GoTo levels, batch-first.

Counterpart of ``minigrid_tpu/babyai/goto.py``: every ``gen_level`` takes
one key per env and draws from the same ``split`` chain as the JAX level.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.babyai import verifier as V
from minigrid_tpu_torch.babyai.level import BabyAILevel
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng

_BALL = C.OBJECT_TO_IDX["ball"]
_DOOR = C.OBJECT_TO_IDX["door"]
_RED = C.COLOR_TO_IDX["red"]
_BLUE = C.COLOR_TO_IDX["blue"]
_GREY = C.COLOR_TO_IDX["grey"]


def _goto(type_id, color) -> dict:
    return V.single_clause(V.K_GOTO, V.desc(type_id, color))


class GoToRedBallGrey(BabyAILevel):
    """Go to the red ball; grey distractors."""

    name = "GoToRedBallGrey"

    def __init__(self, room_size=8, num_dists=7, **kwargs):
        self.num_dists = num_dists
        super().__init__(num_rows=1, num_cols=1, room_size=room_size, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 4).unbind(1)
        b = self.init_rooms(k[0], params)
        b = self.place_agent_in_room(b, k[1], params, 0, 0)
        b, _, _ = self.add_object(b, k[2], params, 0, 0, "ball", _RED)
        b, _, _ = self.add_distractors(b, k[3], params, 0, 0,
                                       num_distractors=self.num_dists,
                                       all_unique=False, color_override=_GREY)
        valid = self.objs_reachable(b, params)
        instr = V.single_clause(V.K_GOTO, V.desc(_BALL, _RED, n=keys.shape[0],
                                                 device=keys.device))
        return self.finish_level(b, instr, params, valid)


class GoToRedBall(BabyAILevel):
    """Go to the red ball, with distractors."""

    name = "GoToRedBall"

    def __init__(self, room_size=8, num_dists=7, **kwargs):
        self.num_dists = num_dists
        super().__init__(num_rows=1, num_cols=1, room_size=room_size, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 4).unbind(1)
        b = self.init_rooms(k[0], params)
        b = self.place_agent_in_room(b, k[1], params, 0, 0)
        b, _, _ = self.add_object(b, k[2], params, 0, 0, "ball", _RED)
        b, _, _ = self.add_distractors(b, k[3], params, 0, 0,
                                       num_distractors=self.num_dists,
                                       all_unique=False)
        valid = self.objs_reachable(b, params)
        instr = V.single_clause(V.K_GOTO, V.desc(_BALL, _RED, n=keys.shape[0],
                                                 device=keys.device))
        return self.finish_level(b, instr, params, valid)


class GoToRedBallNoDists(GoToRedBall):
    name = "GoToRedBallNoDists"

    def __init__(self, **kwargs):
        super().__init__(room_size=8, num_dists=0, **kwargs)


class GoToObj(BabyAILevel):
    """Go to the one object of an empty room."""

    name = "GoToObj"

    def __init__(self, room_size=8, **kwargs):
        super().__init__(num_rows=1, num_cols=1, room_size=room_size, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 3).unbind(1)
        b = self.init_rooms(k[0], params)
        b = self.place_agent_in_room(b, k[1], params, 0, 0)
        b, objs, _ = self.add_distractors(b, k[2], params, num_distractors=1)
        return self.finish_level(b, _goto(objs[:, 0, 0], objs[:, 0, 1]), params)


class GoToLocal(BabyAILevel):
    """Go to one of several objects in a single room."""

    name = "GoToLocal"

    def __init__(self, room_size=8, num_dists=8, **kwargs):
        self.num_dists = num_dists
        super().__init__(num_rows=1, num_cols=1, room_size=room_size, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 4).unbind(1)
        b = self.init_rooms(k[0], params)
        b = self.place_agent_in_room(b, k[1], params, 0, 0)
        b, objs, _ = self.add_distractors(b, k[2], params,
                                          num_distractors=self.num_dists,
                                          all_unique=False)
        valid = self.objs_reachable(b, params)
        picked = G.take_row(objs, rng.randint(k[3], (), 0, self.num_dists))
        return self.finish_level(b, _goto(picked[:, 0], picked[:, 1]), params, valid)


class GoTo(BabyAILevel):
    """Go to an object, maybe in another room of the maze."""

    name = "GoTo"

    def __init__(self, room_size=8, num_rows=3, num_cols=3, num_dists=18,
                 doors_open=False, **kwargs):
        self.num_dists = num_dists
        self.doors_open = doors_open
        super().__init__(num_rows=num_rows, num_cols=num_cols, room_size=room_size,
                         **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 5).unbind(1)
        b = self.init_rooms(k[0], params)
        b = self.place_agent_any(b, k[1], params)
        b = self.connect_all(b, k[2])
        b, objs, _ = self.add_distractors(b, k[3], params,
                                          num_distractors=self.num_dists,
                                          all_unique=False)
        valid = self.objs_reachable(b, params)
        picked = G.take_row(objs, rng.randint(k[4], (), 0, self.num_dists))
        instr = _goto(picked[:, 0], picked[:, 1])
        if self.doors_open:
            # open_all_doors: every door's state field to 'open'
            grid = b["grid"]
            b = {**b, "grid": torch.where(
                G.types(grid) == _DOOR,
                (grid & 0xFFFF) | (C.STATE_TO_IDX["open"] << 16), grid)}
        return self.finish_level(b, instr, params, valid)


class GoToImpUnlock(BabyAILevel):
    """Go to an object that may sit in a locked room."""

    name = "GoToImpUnlock"

    def gen_level(self, keys, params):
        n_rooms = self.num_rows * self.num_cols
        k = rng.split(keys, 9 + 2 * n_rooms).unbind(1)
        b = self.init_rooms(k[0], params)

        # a locked door on a random room, its key in another
        li = rng.randint(k[1], (), 0, self.num_cols)
        lj = rng.randint(k[2], (), 0, self.num_rows)
        b, door, _ = self.add_door(b, k[3], li, lj, locked=True)
        slots = torch.arange(n_rooms, device=keys.device)
        logits = torch.where(slots == (lj * self.num_cols + li)[:, None], -torch.inf, 0.0)
        kr = rng.categorical(k[4], logits)
        b, _, _ = self.add_object(b, k[5], params, kr % self.num_cols,
                                  kr // self.num_cols, "key",
                                  door[:, 1].to(torch.int32))
        b = self.connect_all(b, k[6])

        # two distractors in every unlocked room
        ki = 7
        for i in range(self.num_cols):
            for j in range(self.num_rows):
                not_locked = ~((li == i) & (lj == j))
                b, _, _ = self.add_distractors(b, k[ki], params, i, j,
                                               num_distractors=2, all_unique=False,
                                               enabled=not_locked)
                ki += 1

        b = self.place_agent_any(b, k[ki], params, exclude_room=(li, lj))
        valid = self.objs_reachable(b, params)

        # the target, inside the locked room
        b, objs, _ = self.add_distractors(b, k[ki + 1], params, li, lj,
                                          num_distractors=1, all_unique=False)
        return self.finish_level(b, _goto(objs[:, 0, 0], objs[:, 0, 1]), params, valid)


class GoToRedBlueBall(BabyAILevel):
    """Go to the one red or blue ball."""

    name = "GoToRedBlueBall"

    def __init__(self, room_size=8, num_dists=7, **kwargs):
        self.num_dists = num_dists
        super().__init__(num_rows=1, num_cols=1, room_size=room_size, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 5).unbind(1)
        b = self.init_rooms(k[0], params)
        b = self.place_agent_in_room(b, k[1], params, 0, 0)
        b, dists, _ = self.add_distractors(b, k[2], params, 0, 0,
                                           num_distractors=self.num_dists,
                                           all_unique=False)
        # a red or blue ball among the distractors rejects the level
        bad = ((dists[..., 0] == _BALL)
               & ((dists[..., 1] == _RED) | (dists[..., 1] == _BLUE))).any(dim=1)
        color = torch.where(rng.randint(k[3], (), 0, 2) == 0, _RED, _BLUE).to(torch.int32)
        b, _, _ = self.add_object(b, k[4], params, 0, 0, "ball", color)
        valid = self.objs_reachable(b, params) & ~bad
        return self.finish_level(b, _goto(_BALL, color), params, valid)


class GoToDoorBabyAI(BabyAILevel):
    """Go to the door of a given color."""

    name = "BabyAI-GoToDoor"

    def __init__(self, **kwargs):
        super().__init__(room_size=7, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 7).unbind(1)
        b = self.init_rooms(k[0], params)
        colors = []
        for i in range(4):
            b, door, _ = self.add_door(b, k[1 + i], 1, 1)
            colors.append(door[:, 1].to(torch.int32))
        b = self.place_agent_in_room(b, k[5], params, 1, 1)
        color = G.take1(torch.stack(colors, dim=1), rng.randint(k[6], (), 0, 4))
        return self.finish_level(b, _goto(_DOOR, color), params)


class GoToObjDoor(BabyAILevel):
    """Go to an object or a door of the agent's room."""

    name = "GoToObjDoor"

    def __init__(self, **kwargs):
        super().__init__(room_size=8, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 8).unbind(1)
        b = self.init_rooms(k[0], params)
        b = self.place_agent_in_room(b, k[1], params, 1, 1)
        b, objs, _ = self.add_distractors(b, k[2], params, 1, 1, num_distractors=8,
                                          all_unique=False)
        doors = []
        for i in range(4):
            b, door, _ = self.add_door(b, k[3 + i], 1, 1)
            doors.append(torch.stack([torch.full_like(door[:, 1], _DOOR, dtype=torch.int32),
                                      door[:, 1].to(torch.int32)], dim=1))
        valid = self.objs_reachable(b, params)
        cands = torch.cat([objs, torch.stack(doors, dim=1)], dim=1)  # [B, 12, 2]
        pick = rng.randint(k[7], (), 0, 12)
        instr = _goto(G.take1(cands[..., 0], pick), G.take1(cands[..., 1], pick))
        return self.finish_level(b, instr, params, valid)
