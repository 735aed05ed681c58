"""LevelGen, the BabyAI grammar sampler, batch-first.

Counterpart of ``minigrid_tpu/babyai/levelgen.py``: an optional locked room
with its key elsewhere, ``connect_all``, distractors, the agent outside the
locked room, and a random instruction of the {action, and, seq} x {goto,
pickup, open, putnext} grammar over random object descriptors.

The JAX package resamples the 8 descriptors of an instruction (4 for the
first desc of each clause, 4 for the second) in one fueled ``while_loop`` of
at most 24 redraws: a lane redraws while nothing matches it.  Lane s starts
from ``fold_in(key, s)`` split into (chain, first draw); its r-th redraw
takes the second half of the r-th split of its own chain, whatever the other
lanes do, and an accepted lane never redraws.  The plain version,
:meth:`LevelGen._rand_objs_plain`, which a CPU tensor takes, is up to 24
masked passes over the (env, lane) pairs still redrawing, compacted each
pass as :meth:`BabyAILevel.generate` compacts envs; each pass reads on the
host whether a pair is left, and matches the new descriptors of those pairs
only.  A CUDA tensor takes one launch of ``ops/descs.py``'s kernel instead,
bit for bit the same draws.  A lane still unmatched after 24 redraws keeps
its 24th draw, as in the JAX package, which still calls the level valid.

Tracing (``utils/trace.py``) sees the locked room and its key as the span
``levelgen.layout``, :meth:`LevelGen._rand_objs` as ``levelgen.descs`` and
the instruction's shape, clause kinds and validity checks as
``levelgen.instr``; the counters ``levelgen.desc_passes`` (the first draw
and each redraw pass: 1 + the most redraws of any lane) and
``levelgen.desc_redraws`` (the (env, lane) pairs redrawn, summed over the
passes) count the descriptor loop's work, host ints on the plain loop and
device tensors, summed when read, on the kernel.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.babyai import verifier as V
from minigrid_tpu_torch.babyai.level import BabyAILevel
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.sampling import SORTED_COLOR_IDS
from minigrid_tpu_torch.ops import descs as descs_op
from minigrid_tpu_torch.utils import trace

_DOOR = C.OBJECT_TO_IDX["door"]
_LOCKED = C.STATE_TO_IDX["locked"]
_ACTION_IDS = {"goto": V.K_GOTO, "pickup": V.K_PICKUP, "open": V.K_OPEN,
               "putnext": V.K_PUTNEXT}
# a descriptor lane redraws at most this many times
DESC_FUEL = 24
_KEY_LOCAL = V.OBJ_TYPES.index("key") + 1


def count_desc_draws(redraws: torch.Tensor) -> None:
    """The plain loop's counters from a call's redraws int32[B, 8]: a pass
    redraws every lane still unmatched, so ``levelgen.desc_passes`` is 1 +
    the most redraws of any lane and ``levelgen.desc_redraws`` their sum.
    Device tensors, summed when read; nothing is computed while tracing is
    off."""
    trace.count("levelgen.desc_passes", 1)
    if redraws.numel() and trace.on():
        trace.count("levelgen.desc_passes", redraws.max())
    trace.count("levelgen.desc_redraws", redraws)


class LevelGen(BabyAILevel):
    name = "LevelGen"

    def __init__(self, room_size=8, num_rows=3, num_cols=3, num_dists=18,
                 locked_room_prob=0.5, locations=True, unblocking=True,
                 implicit_unlock=True,
                 action_kinds=("goto", "pickup", "open", "putnext"),
                 instr_kinds=("action", "and", "seq"), **kwargs):
        self.num_dists = num_dists
        self.locked_room_prob = locked_room_prob
        self.locations = locations
        self.unblocking = unblocking
        self.implicit_unlock = implicit_unlock
        self.action_kinds = list(action_kinds)
        self.instr_kinds = list(instr_kinds)
        super().__init__(room_size=room_size, num_rows=num_rows, num_cols=num_cols,
                         **kwargs)

    # ------------------------------------------------------------------ #

    def _rand_action_kind(self, keys: torch.Tensor) -> torch.Tensor:
        """A uniform action kind per key: int32[...]."""
        ids = G.const([_ACTION_IDS[a] for a in self.action_kinds], keys.device,
                      torch.int32)
        return ids[rng.randint(keys, (), 0, len(self.action_kinds)).long()]

    def _sample_descs(self, keys: torch.Tensor, kind: torch.Tensor,
                      fixed: torch.Tensor) -> torch.Tensor:
        """One descriptor draw per key: int32[P, 3] (local type, color,
        location).  The type rule follows the clause kind: open -> door;
        goto, or the fixed object of putnext -> any type; otherwise not a
        door.  The four ``randint`` draws of ``split(key, 4)`` run as one
        batched draw (the same values: each key's words depend on it
        alone)."""
        spans = G.const([11, 12, 2, 4], keys.device)
        r = rng.randint(rng.split(keys, 4), (), 0, spans)  # [P, 4]
        ci, u = r[:, 0], r[:, 1]
        # color: uniform over [any, *colors]
        color = torch.where(ci == 0, 0, G.take_vec(
            G.const(SORTED_COLOR_IDS, keys.device, torch.int32), ci - 1))
        any_ok = (kind == V.K_GOTO) | ((kind == V.K_PUTNEXT) & fixed)
        t_local = torch.where(kind == V.K_OPEN, 4,
                              torch.where(any_ok, 1 + u % 4, 1 + u % 3))
        loc = torch.zeros_like(u)
        if self.locations:
            # a location with probability 1/2
            loc = torch.where(r[:, 2] == 0, 1 + r[:, 3], 0)
        return torch.stack([t_local, color, loc], dim=-1).to(torch.int32)

    def _descs_match(self, b: dict, room_mask: torch.Tensor,
                     locked_rect: torch.Tensor, has_locked: torch.Tensor,
                     env: torch.Tensor, descs: torch.Tensor) -> torch.Tensor:
        """bool[P]: whether descriptor ``descs[p]`` matches an object of env
        ``env[p]`` (one outside the locked room, without implicit
        unlocking)."""
        m = V.desc_match_mask(b["grid"][env], descs, b["agent_pos"][env],
                              b["agent_dir"][env], room_mask[env])
        ok = m.flatten(1).any(dim=1)
        if not self.implicit_unlock:
            outside = (m & ~locked_rect[env]).flatten(1).any(dim=1)
            ok = ok & torch.where(has_locked[env], outside, True)
        return ok

    def _rand_objs(self, key_d1: torch.Tensor, key_d2: torch.Tensor, b: dict,
                   params, locked_rect: torch.Tensor, has_locked: torch.Tensor,
                   kinds: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The 8 descriptors of each env's instruction: (d1 int32[B, 4, 3],
        d2 int32[B, 4, 3], redraws int32[B, 8] per lane, d1's lanes first).
        ``kinds`` int32[B, 4] are the clause kinds.  A CPU tensor takes the
        plain loop, any other device the kernel (or raises)."""
        if key_d1.device.type == "cpu":
            return self._rand_objs_plain(key_d1, key_d2, b, params, locked_rect,
                                         has_locked, kinds)
        descs, redraws = descs_op.draw(key_d1, key_d2, b, kinds, locked_rect, has_locked,
                                       self.room_size, self.locations, self.implicit_unlock)
        count_desc_draws(redraws)
        k = descs_op.CLAUSES
        return descs[:, :k], descs[:, k:], redraws

    def _rand_objs_plain(self, key_d1: torch.Tensor, key_d2: torch.Tensor, b: dict,
                         params, locked_rect: torch.Tensor, has_locked: torch.Tensor,
                         kinds: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """:meth:`_rand_objs` as masked eager passes with a host read each."""
        dev = key_d1.device
        n, k = kinds.shape
        lanes = torch.arange(k, device=dev)
        keys0 = torch.cat([rng.fold_in(key_d1[:, None], lanes),
                           rng.fold_in(key_d2[:, None], lanes)], dim=1)  # [B, 8, 2]
        chain, first = rng.split(keys0.reshape(-1, 2)).unbind(-2)
        kind8 = torch.cat([kinds, kinds], dim=1).reshape(-1)
        fixed8 = (torch.arange(2 * k, device=dev) >= k).expand(n, 2 * k).reshape(-1)
        env8 = torch.arange(n, device=dev).repeat_interleave(2 * k)
        room_mask = self.agent_room_mask(b, params)

        descs = self._sample_descs(first, kind8, fixed8)
        trace.count("levelgen.desc_passes", 1)
        ok = self._descs_match(b, room_mask, locked_rect, has_locked, env8, descs)
        redraws = torch.zeros((n * 2 * k,), dtype=torch.int32, device=dev)
        idx = (~ok).nonzero()[:, 0]
        chain = chain[idx]
        for _ in range(DESC_FUEL):
            if idx.numel() == 0:
                break
            trace.count("levelgen.desc_passes", 1)
            trace.count("levelgen.desc_redraws", idx.numel())
            chain, sub = rng.split(chain).unbind(-2)
            cand = self._sample_descs(sub, kind8[idx], fixed8[idx])
            descs = descs.index_copy(0, idx, cand)
            redraws = redraws.index_add(0, idx, torch.ones_like(idx, dtype=torch.int32))
            left = (~self._descs_match(b, room_mask, locked_rect, has_locked,
                                       env8[idx], cand)).nonzero()[:, 0]
            idx, chain = idx[left], chain[left]
        descs = descs.reshape(n, 2 * k, 3)
        return descs[:, :k], descs[:, k:], redraws.reshape(n, 2 * k)

    # ------------------------------------------------------------------ #

    def _layout(self, k: tuple, params) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """The rooms, the optional locked room with its key in another room,
        the doors, the distractors and the agent: (builder, has_locked
        bool[B], locked_rect bool[B, W, H]).  ``k`` are the level's 16 keys."""
        rows, cols = self.num_rows, self.num_cols
        n_rooms = rows * cols
        b = self.init_rooms(k[0], params)
        dev = k[0].device
        n = k[0].shape[0]
        rooms = torch.arange(n_rooms, device=dev)

        # the locked room: statically absent when it cannot be drawn, or in a
        # single room (no internal wall to put its door on)
        use_locked = self.locked_room_prob > 0 and n_rooms > 1
        if use_locked:
            with trace.span("levelgen.layout"):
                has_locked = rng.uniform(k[1]) < self.locked_room_prob
                # (room, side) with a neighbor, uniform
                sides = [self.wall_id_for(r % cols, r // cols, s)[1]
                         for r in range(n_rooms) for s in range(4)]
                logits = torch.where(G.const(sides, dev, torch.bool), 0.0, -torch.inf)
                pick = rng.categorical(k[2], logits)
                lr = pick // 4
                li, lj = lr % cols, lr // cols
                b, door, _ = self.add_door(b, k[3], li, lj, pick % 4, locked=True,
                                           enabled=has_locked)
                # its key in another room
                logits_k = torch.where(rooms == lr[:, None], -torch.inf, 0.0)
                kr = rng.categorical(k[4], logits_k)
                b, _, _ = self.add_object(b, k[5], params, kr % cols, kr // cols, "key",
                                          door[:, 1].to(torch.int32), enabled=has_locked)
                locked_rect = (self.room_rect_mask(params, li, lj, dev)
                               & has_locked[:, None, None])
        else:
            has_locked = torch.zeros((n,), dtype=torch.bool, device=dev)
            locked_rect = torch.zeros((n, params.width, params.height),
                                      dtype=torch.bool, device=dev)

        b = self.connect_all(b, k[6])
        b, _, _ = self.add_distractors(b, k[7], params, num_distractors=self.num_dists,
                                       all_unique=False)
        if use_locked:
            # the agent in a uniform room, the locked one excluded where it
            # exists (not place_agent_any: the exclusion is gated per env)
            k_room, k_pos = rng.split(k[8]).unbind(1)
            logits_a = torch.where((rooms == lr[:, None]) & has_locked[:, None],
                                   -torch.inf, 0.0)
            room = rng.categorical(k_room, logits_a)
            b = self.place_agent_in_room(b, k_pos, params, room % cols, room // cols)
        else:
            b = self.place_agent_any(b, k[8], params)
        return b, has_locked, locked_rect

    def gen_level(self, keys, params):
        k = rng.split(keys, 16).unbind(1)
        b, has_locked, locked_rect = self._layout(k, params)
        dev = keys.device
        n = keys.shape[0]
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
        if not self.unblocking:
            valid = valid & self.objs_reachable(b, params)

        # the instruction: its clause kinds, descriptors for the four slots,
        # then its shape
        with trace.span("levelgen.instr"):
            ck = self._rand_action_kind(rng.fold_in(k[10][:, None],
                                                    torch.arange(4, device=dev)))
        with trace.span("levelgen.descs"):
            d1, d2, _ = self._rand_objs(k[11], k[12], b, params, locked_rect,
                                        has_locked, ck)
        with trace.span("levelgen.instr"):
            instr, valid = self._instr(k, b, params, ck, d1, d2, valid)
        return self.finish_level(b, instr, params, valid)

    def _instr(self, k: tuple, b: dict, params, ck: torch.Tensor, d1: torch.Tensor,
               d2: torch.Tensor, valid: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """The instruction's shape over the drawn clauses, and the level's
        validity after ``putnext_valid`` and the unblocking check."""
        dev = ck.device
        n = ck.shape[0]
        instr_kind = rng.randint(k[9], (), 0, len(self.instr_kinds))

        def kind_is(name):
            return instr_kind == (self.instr_kinds.index(name)
                                  if name in self.instr_kinds else -1)

        is_action, is_and, is_seq = kind_is("action"), kind_is("and"), kind_is("seq")
        # seq operands are an action or an and
        a_is_and = is_and | (is_seq & (rng.randint(k[13], (), 0, 2) == 0))
        b_is_and = is_seq & (rng.randint(rng.fold_in(k[13], 1), (), 0, 2) == 0)
        seq_code = torch.where(
            is_action, V.S_SINGLE,
            torch.where(is_and, V.S_AND,
                        torch.where(rng.randint(k[14], (), 0, 2) == 0,
                                    V.S_BEFORE, V.S_AFTER))).to(torch.int32)
        # the slots in use: a top-level And takes slots 0 and 2
        use = torch.stack([torch.ones_like(is_and), a_is_and & ~is_and,
                           is_and | is_seq, b_is_and], dim=1)
        instr = {
            "seq_kind": seq_code,
            "a_and": a_is_and & ~is_and,
            "b_and": b_is_and,
            "kinds": (ck * use).to(torch.int32),
            "d1": d1 * use[..., None],
            "d2": d2 * use[..., None],
            "strict": torch.zeros((n, 4), dtype=torch.bool, device=dev),
        }

        valid = valid & self.putnext_valid(b, instr, params, b["agent_pos"],
                                           b["agent_dir"])
        if self.unblocking:
            # no clause names a key of a locked door's color
            g = b["grid"]
            locked_doors = (G.types(g) == _DOOR) & (G.states(g) == _LOCKED)
            palette = torch.arange(C.NUM_COLORS, device=dev)
            locked_colors = (locked_doors[..., None]
                             & (G.colors(g)[..., None] == palette)).flatten(1, 2).any(1)
            for d in (instr["d1"], instr["d2"]):
                named = locked_colors.gather(1, d[..., 1].long())  # [B, 4]
                valid = valid & ~(use & (d[..., 0] == _KEY_LOCAL) & (d[..., 1] > 0)
                                  & named).any(dim=1)
        return instr, valid
