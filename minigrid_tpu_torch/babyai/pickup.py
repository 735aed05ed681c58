"""BabyAI Pickup levels, batch-first.

Counterpart of ``minigrid_tpu/babyai/pickup.py``; PickupLoc is a
``LevelGen`` preset.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.babyai import verifier as V
from minigrid_tpu_torch.babyai.level import BabyAILevel
from minigrid_tpu_torch.babyai.levelgen import LevelGen
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng


def _pickup_one_of(objs: torch.Tensor, pick: torch.Tensor, strict=False) -> dict:
    return V.single_clause(V.K_PICKUP, V.desc(G.take1(objs[..., 0], pick),
                                              G.take1(objs[..., 1], pick)),
                           strict=strict)


class Pickup(BabyAILevel):
    """Pick up an object, maybe in another room of the maze."""

    name = "Pickup"

    def gen_level(self, keys, params):
        k = rng.split(keys, 5).unbind(1)
        b = self.init_rooms(k[0], params)
        b = self.place_agent_any(b, k[1], params)
        b = self.connect_all(b, k[2])
        b, objs, _ = self.add_distractors(b, k[3], params, num_distractors=18,
                                          all_unique=False)
        valid = self.objs_reachable(b, params)
        instr = _pickup_one_of(objs, rng.randint(k[4], (), 0, 18))
        return self.finish_level(b, instr, params, valid)


class UnblockPickup(BabyAILevel):
    """Pick up an object behind obstructions: a level where every object is
    reachable is rejected."""

    name = "UnblockPickup"

    def gen_level(self, keys, params):
        k = rng.split(keys, 5).unbind(1)
        b = self.init_rooms(k[0], params)
        b = self.place_agent_any(b, k[1], params)
        b = self.connect_all(b, k[2])
        b, objs, _ = self.add_distractors(b, k[3], params, num_distractors=20,
                                          all_unique=False)
        valid = ~self.objs_reachable(b, params)
        instr = _pickup_one_of(objs, rng.randint(k[4], (), 0, 20))
        return self.finish_level(b, instr, params, valid)


class PickupLoc(LevelGen):
    """Pick up an object, maybe named by its location."""

    name = "PickupLoc"

    def __init__(self, **kwargs):
        super().__init__(action_kinds=["pickup"], instr_kinds=["action"], num_rows=1,
                         num_cols=1, num_dists=8, locked_room_prob=0, locations=True,
                         unblocking=False, **kwargs)


class PickupDist(BabyAILevel):
    """Pick up an object named by its type, its color or both."""

    name = "PickupDist"

    def __init__(self, debug=False, **kwargs):
        self.debug = debug
        super().__init__(num_rows=1, num_cols=1, room_size=7, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 5).unbind(1)
        b = self.init_rooms(k[0], params)
        b, objs, _ = self.add_distractors(b, k[1], params, 0, 0, num_distractors=5)
        b = self.place_agent_in_room(b, k[2], params, 0, 0)
        picked = G.take_row(objs, rng.randint(k[3], (), 0, 5))
        select_by = rng.randint(k[4], (), 0, 3)  # type / color / both
        t = torch.where(select_by == 1, 0, picked[:, 0])  # color only: any type
        c = torch.where(select_by == 0, 0, picked[:, 1])  # type only: any color
        instr = V.single_clause(V.K_PICKUP, V.desc(t, c), strict=self.debug)
        return self.finish_level(b, instr, params)


class PickupAbove(BabyAILevel):
    """Pick up the object in the room above."""

    name = "PickupAbove"

    def __init__(self, max_steps=None, **kwargs):
        room_size = 6
        if max_steps is None:
            max_steps = 8 * room_size**2
        super().__init__(room_size=room_size, max_steps=max_steps, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 5).unbind(1)
        b = self.init_rooms(k[0], params)
        b, obj, _ = self.add_object(b, k[1], params, 1, 0)
        b, _, _ = self.add_door(b, k[2], 1, 1, 3, locked=False)
        b = self.place_agent_in_room(b, k[3], params, 1, 1)
        b = self.connect_all(b, k[4])
        instr = V.single_clause(V.K_PICKUP, V.desc(obj[:, 0].to(torch.int32),
                                                   obj[:, 1].to(torch.int32)))
        return self.finish_level(b, instr, params)
