"""BabyAI PutNext levels, batch-first.

Counterpart of ``minigrid_tpu/babyai/putnext.py``.  With ``start_carrying``
the level starts with object A in the agent's hands: ``post_generate`` takes
it off the grid after the verifier was set up on the whole grid, as the
reference orders it, and moves its tracked bit into the carry flags.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.babyai import verifier as V
from minigrid_tpu_torch.babyai.level import BabyAILevel
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng


class PutNextLocal(BabyAILevel):
    """Put A next to B in one room."""

    name = "PutNextLocal"

    def __init__(self, room_size=8, num_objs=8, **kwargs):
        self.num_objs = num_objs
        super().__init__(num_rows=1, num_cols=1, room_size=room_size, **kwargs)

    def gen_level(self, keys, params):
        k = rng.split(keys, 4).unbind(1)
        b = self.init_rooms(k[0], params)
        b = self.place_agent_in_room(b, k[1], params, 0, 0)
        b, objs, _ = self.add_distractors(b, k[2], params, num_distractors=self.num_objs,
                                          all_unique=True)
        valid = self.objs_reachable(b, params)
        p = rng.permutation(k[3], self.num_objs)
        o1, o2 = G.take_row(objs, p[:, 0]), G.take_row(objs, p[:, 1])
        instr = V.single_clause(V.K_PUTNEXT, V.desc(o1[:, 0], o1[:, 1]),
                                V.desc(o2[:, 0], o2[:, 1]))
        valid = valid & self.putnext_valid(b, instr, params, b["agent_pos"],
                                           b["agent_dir"])
        return self.finish_level(b, instr, params, valid)


class PutNext(BabyAILevel):
    """Move an object of one room next to one of the other."""

    name = "PutNext"

    def __init__(self, room_size: int, objs_per_room: int, start_carrying=False,
                 max_steps=None, **kwargs):
        if not (room_size >= 4 and objs_per_room <= 9):
            raise ValueError("PutNext needs room_size >= 4 and at most 9 objects a room")
        self.objs_per_room = objs_per_room
        self.start_carrying = start_carrying
        if max_steps is None:
            max_steps = 8 * room_size**2
        super().__init__(num_rows=1, num_cols=2, room_size=room_size,
                         max_steps=max_steps, **kwargs)

    def gen_level(self, keys, params):
        n = self.objs_per_room
        k = rng.split(keys, 7).unbind(1)
        b = self.init_rooms(k[0], params)
        b = self.place_agent_in_room(b, k[1], params, 0, 0)
        b, objs_l, pos_l = self.add_distractors(b, k[2], params, 0, 0, num_distractors=n)
        b, objs_r, pos_r = self.add_distractors(b, k[3], params, 1, 0, num_distractors=n)
        b = self.remove_wall(b, 0, 0, 0)
        ia = rng.randint(k[4], (), 0, n)
        ib = rng.randint(k[5], (), 0, n)
        flip = (rng.randint(k[6], (), 0, 2) == 0)[:, None]
        left, right = G.take_row(objs_l, ia), G.take_row(objs_r, ib)
        a = torch.where(flip, right, left)
        a_pos = torch.where(flip, G.take_row(pos_r, ib), G.take_row(pos_l, ia))
        c = torch.where(flip, left, right)
        instr = V.single_clause(V.K_PUTNEXT, V.desc(a[:, 0], a[:, 1]),
                                V.desc(c[:, 0], c[:, 1]))
        valid = self.putnext_valid(b, instr, params, b["agent_pos"], b["agent_dir"])
        b = dict(b)
        b["carry_triple"] = torch.cat([a, torch.zeros_like(a[:, :1])],
                                      dim=1).to(torch.uint8)
        b["carry_pos"] = a_pos.to(torch.int32)
        return self.finish_level(b, instr, params, valid)

    def post_generate(self, state, b, params):
        if not self.start_carrying:
            return state
        pos = b["carry_pos"]
        grid = G.put(state.grid, pos[:, 0], pos[:, 1], C.EMPTY_TRIPLE)
        vs = state.extra["vs"]
        kk, w = vs["tracked1"].shape[1:]
        # obj_a's cell in clause 0's planes
        slot0 = (torch.arange(kk, device=pos.device) == 0)[None, :, None]
        cell = V.onehot_packed(w, pos[:, 0], pos[:, 1])[:, None]  # [B, 1, W]
        cell_mask = torch.where(slot0, cell, torch.zeros_like(cell))
        # obj_a always matches the moved desc; it also matches the fixed one
        # when its type and color satisfy desc2, and the reference keeps it
        # in that set while it is carried: carry2 too
        match2 = ((vs["tracked2"] & cell_mask) != 0).any(dim=-1)
        vs = {**vs,
              "carry1": vs["carry1"] | slot0[..., 0],
              "carry2": vs["carry2"] | match2,
              "tracked1": vs["tracked1"] & ~cell_mask,
              "tracked2": vs["tracked2"] & ~cell_mask}
        return state.replace(grid=grid, carrying=b["carry_triple"].contiguous(),
                             extra={**state.extra, "vs": vs})


class PutNextCarrying(PutNext):
    name = "PutNextCarrying"

    def __init__(self, room_size, objs_per_room, **kwargs):
        super().__init__(room_size, objs_per_room, start_carrying=True, **kwargs)
