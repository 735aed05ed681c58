"""BabyAI Unlock levels, batch-first.

Counterpart of ``minigrid_tpu/babyai/unlock.py``.  KeyInBox is the first
BabyAI level whose box planes hold something: the key hides in a box.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.babyai import verifier as V
from minigrid_tpu_torch.babyai.level import BabyAILevel
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.roomgrid import type_triple
from minigrid_tpu_torch.core.sampling import SORTED_COLOR_IDS, rand_color
from minigrid_tpu_torch.core.state import empty_grid

_DOOR = C.OBJECT_TO_IDX["door"]
_BALL = C.OBJECT_TO_IDX["ball"]
_BOX = C.OBJECT_TO_IDX["box"]
_KEY = C.OBJECT_TO_IDX["key"]


def _door_color(door: torch.Tensor) -> torch.Tensor:
    return door[:, 1].to(torch.int32)


class Unlock(BabyAILevel):
    """Open a locked door whose key lies in another room."""

    name = "Unlock"

    def gen_level(self, keys, params):
        rows, cols = self.num_rows, self.num_cols
        n_rooms = rows * cols
        k = rng.split(keys, 10 + n_rooms).unbind(1)
        b = self.init_rooms(k[0], params)

        li = rng.randint(k[1], (), 0, cols)
        lj = rng.randint(k[2], (), 0, rows)
        b, door, _ = self.add_door(b, k[3], li, lj, locked=True)
        rooms = torch.arange(n_rooms, device=keys.device)
        logits = torch.where(rooms == (lj * cols + li)[:, None], -torch.inf, 0.0)
        kr = rng.categorical(k[4], logits)
        b, _, _ = self.add_object(b, k[5], params, kr % cols, kr // cols, "key",
                                  _door_color(door))

        # half the levels keep the locked door's color off the other doors
        flip = rng.randint(k[6], (), 0, 2) == 0
        b = self.connect_all(b, k[7], exclude_color=torch.where(
            flip, _door_color(door), -1))

        ki = 8
        for i in range(cols):
            for j in range(rows):
                not_locked = ~((li == i) & (lj == j))
                b, _, _ = self.add_distractors(b, k[ki], params, i, j, num_distractors=3,
                                               all_unique=False, enabled=not_locked)
                ki += 1
        b = self.place_agent_any(b, k[ki], params, exclude_room=(li, lj))
        valid = self.objs_reachable(b, params)
        instr = V.single_clause(V.K_OPEN, V.desc(_DOOR, _door_color(door)))
        return self.finish_level(b, instr, params, valid)


class UnlockLocal(BabyAILevel):
    """Fetch the key and unlock the door of the agent's room."""

    name = "UnlockLocal"

    def __init__(self, distractors=False, **kwargs):
        self.distractors = distractors
        super().__init__(**kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 5).unbind(1)
        b = self.init_rooms(k[0], params)
        b, door, _ = self.add_door(b, k[1], 1, 1, locked=True)
        b, _, _ = self.add_object(b, k[2], params, 1, 1, "key", _door_color(door))
        if self.distractors:
            b, _, _ = self.add_distractors(b, k[3], params, 1, 1, num_distractors=3)
        b = self.place_agent_in_room(b, k[4], params, 1, 1)
        instr = V.single_clause(V.K_OPEN, V.desc(_DOOR, n=keys.shape[0],
                                                 device=keys.device))
        return self.finish_level(b, instr, params)


class KeyInBox(BabyAILevel):
    """Unlock the door; the key hides in a box."""

    name = "KeyInBox"

    def gen_level(self, keys, params):
        n, dev = keys.shape[0], keys.device
        k = rng.split(keys, 5).unbind(1)
        b = self.init_rooms(k[0], params)
        if "box_contains" not in b:
            b["box_contains"] = empty_grid(params.width, params.height, dev, (n,))
        b, door, _ = self.add_door(b, k[1], 1, 1, locked=True)
        box = type_triple(_BOX, rand_color(k[2]), n, dev)
        b, pos, ok = self.place_in_room(b, k[3], params, 1, 1, box)
        b["box_contains"] = G.put_if(b["box_contains"], pos[:, 0], pos[:, 1],
                                     type_triple(_KEY, _door_color(door), n, dev), ok)
        b = self.place_agent_in_room(b, k[4], params, 1, 1)
        instr = V.single_clause(V.K_OPEN, V.desc(_DOOR, n=n, device=dev))
        return self.finish_level(b, instr, params)


class UnlockPickup(BabyAILevel):
    """Unlock the door, then pick up the box."""

    name = "BabyAI-UnlockPickup"

    def __init__(self, distractors=False, max_steps=None, **kwargs):
        self.distractors = distractors
        room_size = 6
        if max_steps is None:
            max_steps = 8 * room_size**2
        super().__init__(num_rows=1, num_cols=2, room_size=room_size,
                         max_steps=max_steps, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 6).unbind(1)
        b = self.init_rooms(k[0], params)
        b, obj, _ = self.add_object(b, k[1], params, 1, 0, kind="box")
        b, door, _ = self.add_door(b, k[2], 0, 0, 0, locked=True)
        b, _, _ = self.add_object(b, k[3], params, 0, 0, "key", _door_color(door))
        if self.distractors:
            b, _, _ = self.add_distractors(b, k[4], params, num_distractors=4)
        b = self.place_agent_in_room(b, k[5], params, 0, 0)
        instr = V.single_clause(V.K_PICKUP, V.desc(obj[:, 0].to(torch.int32),
                                                   obj[:, 1].to(torch.int32)))
        return self.finish_level(b, instr, params)


class BlockedUnlockPickup(BabyAILevel):
    """A ball blocks the locked door; pick up the box behind it."""

    name = "BabyAI-BlockedUnlockPickup"

    def __init__(self, max_steps=None, **kwargs):
        room_size = 6
        if max_steps is None:
            max_steps = 16 * room_size**2
        super().__init__(num_rows=1, num_cols=2, room_size=room_size,
                         max_steps=max_steps, **kwargs)

    def gen_level(self, keys, params):
        n, dev = keys.shape[0], keys.device
        k = rng.split(keys, 6).unbind(1)
        b = self.init_rooms(k[0], params)
        b, _, _ = self.add_object(b, k[1], params, 1, 0, kind="box")
        b, door, door_pos = self.add_door(b, k[2], 0, 0, 0, locked=True)
        ball = type_triple(_BALL, rand_color(k[3]), n, dev)
        b = {**b, "grid": G.put(b["grid"], door_pos[:, 0] - 1, door_pos[:, 1], ball)}
        b, _, _ = self.add_object(b, k[4], params, 0, 0, "key", _door_color(door))
        b = self.place_agent_in_room(b, k[5], params, 0, 0)
        instr = V.single_clause(V.K_PICKUP, V.desc(_BOX, n=n, device=dev))
        return self.finish_level(b, instr, params)


class UnlockToUnlock(BabyAILevel):
    """Unlock door B to reach the key of door A."""

    name = "UnlockToUnlock"

    def __init__(self, max_steps=None, **kwargs):
        room_size = 6
        if max_steps is None:
            max_steps = 30 * room_size**2
        super().__init__(num_rows=1, num_cols=3, room_size=room_size,
                         max_steps=max_steps, **kwargs)

    def gen_level(self, keys, params):
        n, dev = keys.shape[0], keys.device
        k = rng.split(keys, 8).unbind(1)
        b = self.init_rooms(k[0], params)
        colors = G.take_vec(G.const(SORTED_COLOR_IDS, dev, torch.int32),
                            rng.permutation(k[1], 10)[:, :2])
        b, _, _ = self.add_door(b, k[2], 0, 0, 0, color=colors[:, 0], locked=True)
        b, _, _ = self.add_object(b, k[3], params, 2, 0, "key", colors[:, 0])
        b, _, _ = self.add_door(b, k[4], 1, 0, 0, color=colors[:, 1], locked=True)
        b, _, _ = self.add_object(b, k[5], params, 1, 0, "key", colors[:, 1])
        b, _, _ = self.add_object(b, k[6], params, 0, 0, kind="ball")
        b = self.place_agent_in_room(b, k[7], params, 1, 0)
        instr = V.single_clause(V.K_PICKUP, V.desc(_BALL, n=n, device=dev))
        return self.finish_level(b, instr, params)
