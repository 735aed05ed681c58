"""BabyAI level base: RoomGridLevel on the port's RoomGrid, batch-first.

Counterpart of ``minigrid_tpu/babyai/level.py``:

* the generate-validate-retry loop becomes up to ``max_gen_attempts`` masked
  passes: each pass draws a level for every env still invalid, from that
  env's own key chain (``key, sub = split(key)`` a pass, as the JAX
  package's fueled ``while_loop``), and an env still invalid after the last
  pass keeps its last draw.  The pass reads on the host which envs are left;
* the per-episode step limit ``num_navs * room² * rows * cols`` is stored in
  ``state.max_steps`` unless the family fixes ``max_steps``;
* the step hook runs the verifier: success ends the episode with the task
  reward, failure with 0;
* ``objs_reachable`` is a fixed number of boolean dilations (doors of any
  state pass, other objects are reached but block), so no host read enters
  the generator.

The observation's ``mission`` is the flattened instruction, int32[B, 43];
:meth:`BabyAILevel.mission_text` rebuilds the reference's string.

Tracing (``utils/trace.py``) sees ``place_agent_any`` as the span
``roomgrid.place_agent``, ``objs_reachable`` as ``babyai.reachable``,
``_finalize`` as ``babyai.finalize`` and the verifier's ``post_step`` as
``babyai.verify``; the counter ``reset.draws`` counts the rows drawn over
:meth:`BabyAILevel.generate`'s passes.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.babyai import verifier as V
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.roomgrid import RoomGridEnv
from minigrid_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    base_state,
    map_tree,
    resolve_device,
)
from minigrid_tpu_torch.utils import trace

MISSION_LEN = 43


def flatten_instr(instr: dict, articles: torch.Tensor) -> torch.Tensor:
    """Instruction code -> int32[B, 43] mission: [seq, a_and, b_and,
    kinds(4), d1(12), d2(12), strict(4), articles(8)], where articles[2k] and
    articles[2k+1] say whether clause k's desc1/desc2 take 'a' (several
    objects match) rather than 'the'.  Single-clause codes are zero-padded,
    so every family has the same layout."""
    instr = V.pad_clauses(instr)
    n = articles.shape[0]
    if articles.shape[1] < 8:
        articles = torch.cat([articles, articles.new_zeros((n, 8 - articles.shape[1]))],
                             dim=1)
    parts = [instr["seq_kind"][:, None], instr["a_and"][:, None], instr["b_and"][:, None],
             instr["kinds"], instr["d1"].reshape(n, -1), instr["d2"].reshape(n, -1),
             instr["strict"], articles]
    return torch.cat([p.to(torch.int32) for p in parts], dim=1)


def unflatten_instr(mission) -> tuple[dict, np.ndarray]:
    """One env's int32[43] mission -> (instruction code as numpy, articles)."""
    m = np.asarray(mission)
    instr = {
        "seq_kind": m[0], "a_and": bool(m[1]), "b_and": bool(m[2]),
        "kinds": m[3:7], "d1": m[7:19].reshape(4, 3), "d2": m[19:31].reshape(4, 3),
        "strict": m[31:35].astype(bool),
    }
    return instr, m[35:43]


def desc_surface(d, plural: bool) -> str:
    """ObjDesc.surface."""
    t, color, loc = int(d[0]), int(d[1]), int(d[2])
    s = "object" if t == 0 else V.OBJ_TYPES[t - 1]
    if color:
        s = C.IDX_TO_COLOR[color] + " " + s
    if loc == 3:
        s += " in front of you"
    elif loc == 4:
        s += " behind you"
    elif loc in (1, 2):
        s += " on your " + V.LOC_NAMES[loc - 1]
    return ("a " if plural else "the ") + s


def clause_surface(kind: int, d1, d2, a1: bool, a2: bool) -> str:
    if kind == V.K_GOTO:
        return "go to " + desc_surface(d1, a1)
    if kind == V.K_PICKUP:
        return "pick up " + desc_surface(d1, a1)
    if kind == V.K_OPEN:
        return "open " + desc_surface(d1, a1)
    if kind == V.K_PUTNEXT:
        return "put " + desc_surface(d1, a1) + " next to " + desc_surface(d2, a2)
    return ""


class BabyAILevel(RoomGridEnv):
    """Base class of the BabyAI levels: a subclass implements
    :meth:`gen_level`, one unvalidated draw of a batch of levels."""

    name = "BabyAILevel"
    max_gen_attempts: int = 8
    # missions come from a grammar; a gym adapter accepts every string
    grammar_missions = True

    def __init__(self, room_size: int = 8, num_rows: int = 3, num_cols: int = 3,
                 max_steps: int | None = None, **kwargs):
        # max_steps=None: a per-episode limit from the instruction; the params
        # field holds a bound above it
        self.fixed_max_steps = max_steps is not None
        nav_bound = room_size**2 * num_rows * num_cols * 8
        # verifier outcomes end episodes at scattered steps: pooled resets,
        # with refill windows sized to how fast episodes turn over (single
        # rooms end within about room² steps, mazes run long)
        self.desynchronized_resets = True
        self.pool_refill_fraction = 1 / 8 if num_rows * num_cols == 1 else 1 / 256
        super().__init__(room_size=room_size, num_rows=num_rows, num_cols=num_cols,
                         max_steps=max_steps if max_steps is not None else nav_bound,
                         **kwargs)

    # ------------------------------------------------------------------ #
    # generation
    # ------------------------------------------------------------------ #

    def gen_level(self, keys: torch.Tensor, params: EnvParams
                  ) -> tuple[dict, dict, torch.Tensor]:
        """One draw per key: (builder, instruction code, valid bool[B])."""
        raise NotImplementedError

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        keys = keys.to(resolve_device(device))
        # split(key, 3): the chain, an unused key (the JAX package's
        # speculative attempts, which no level turns on), the state's stream
        chain, _, k_state = rng.split(keys, 3).unbind(1)
        idx = torch.arange(keys.shape[0], device=keys.device)
        drawn = None
        for _ in range(self.max_gen_attempts):
            trace.count("reset.draws", idx.shape[0])
            chain, sub = rng.split(chain).unbind(1)
            b, instr, valid = self.gen_level(sub, params)
            part = {"b": b, "instr": instr}
            drawn = part if drawn is None else map_tree(
                lambda d, p: d.index_copy(0, idx, p), drawn, part)
            left = (~valid).nonzero()[:, 0]
            if left.numel() == 0:
                break
            idx, chain = idx[left], chain[left]
        return self._finalize(drawn["b"], drawn["instr"], k_state, params)

    def generate_attempt(self, keys: torch.Tensor, params: EnvParams,
                         device=None) -> tuple[EnvState, torch.Tensor]:
        """ONE unvalidated draw per key: (states, valid bool[B]).  The pooled
        ring's best-effort refill keeps a slot's previous level where the
        draw is invalid.  It draws from ``split(key, 3)[1]``, so its level
        differs from :meth:`generate`'s for the same key."""
        keys = keys.to(resolve_device(device))
        _, k0, k_state = rng.split(keys, 3).unbind(1)
        b, instr, valid = self.gen_level(k0, params)
        return self._finalize(b, instr, k_state, params), valid

    def _finalize(self, b: dict, instr: dict, k_state: torch.Tensor,
                  params: EnvParams) -> EnvState:
        """The verifier state, the articles and the step limit of each
        level: one pass of 2K desc-match planes serves both the tracked
        planes and the 'a'/'the' flags."""
        with trace.span("babyai.finalize"):
            grid, pos, direction = b["grid"], b["agent_pos"], b["agent_dir"]
            n, k = instr["kinds"].shape
            room_mask = self.agent_room_mask(b, params)
            masks = V.desc_match_mask(grid, torch.cat([instr["d1"], instr["d2"]], dim=1),
                                      pos, direction, room_mask)
            tracked1, tracked2 = masks[:, :k], masks[:, k:]
            plural = masks.sum(dim=(2, 3)) > 1
            # interleaved [d1_0, d2_0, d1_1, d2_1, ...]
            articles = torch.stack([plural[:, :k], plural[:, k:]], dim=2).reshape(n, 2 * k)
            vs = V.init_verifier_state(grid, instr, pos, direction, room_mask,
                                       masks=(tracked1, tracked2))
            if self.fixed_max_steps:
                max_steps = 0  # params.max_steps
            else:
                max_steps = V.num_navs(instr) * (self.room_size**2 * self.num_rows
                                                 * self.num_cols)
            state = base_state(grid, pos, direction, rng=k_state,
                               mission=flatten_instr(instr, articles),
                               box_contains=b.get("box_contains"), max_steps=max_steps,
                               extra={"instr": instr, "vs": vs})
            return self.post_generate(state, b, params)

    def post_generate(self, state: EnvState, b: dict, params: EnvParams) -> EnvState:
        """Hook for levels that change the state after the reset."""
        return state

    def place_agent_any(self, b: dict, keys: torch.Tensor, params: EnvParams,
                        exclude_room=None) -> dict:
        """The agent in a uniform room (one ``categorical`` over the rooms),
        then placed there; ``exclude_room`` (i, j), a value or one per env,
        takes a room out of the draw."""
        with trace.span("roomgrid.place_agent"):
            k_room, k_pos = rng.split(keys).unbind(1)
            n_rooms = self.num_rows * self.num_cols
            logits = torch.zeros((n_rooms,), device=keys.device)
            if exclude_room is not None:
                i, j = exclude_room
                r = j * self.num_cols + i
                slots = torch.arange(n_rooms, device=keys.device)
                r = r[:, None] if isinstance(r, torch.Tensor) else r
                logits = torch.where(slots == r, -torch.inf, 0.0)
            room = rng.categorical(k_room, logits)
            return self.place_agent_in_room(b, k_pos, params, room % self.num_cols,
                                            room // self.num_cols)

    def finish_level(self, b: dict, instr: dict, params: EnvParams, valid=True
                     ) -> tuple[dict, dict, torch.Tensor]:
        """The (builder, instruction, valid bool[B]) a :meth:`gen_level`
        returns."""
        n, dev = b["grid"].shape[0], b["grid"].device
        if not isinstance(valid, torch.Tensor):
            valid = torch.full((n,), bool(valid), dtype=torch.bool, device=dev)
        return b, instr, valid

    def agent_room_mask(self, b: dict, params: EnvParams) -> torch.Tensor:
        """bool[B, W, H]: each agent's starting room, walls included."""
        s = self.room_size
        pos = b["agent_pos"]
        return self.room_rect_mask(params, pos[:, 0] // (s - 1), pos[:, 1] // (s - 1),
                                   pos.device)

    # ------------------------------------------------------------------ #
    # stepping
    # ------------------------------------------------------------------ #

    def post_step(self, state, action, reward, terminated, outcome, params):
        with trace.span("babyai.verify"):
            vs, status = V.verify_step(
                state.extra["vs"], state.extra["instr"], state.grid, state.agent_pos,
                state.agent_dir, action, outcome, done_actions=params.babyai_done_actions)
            state = state.replace(extra={**state.extra, "vs": vs})
            reward = torch.where(status == V.SUCCESS, self.task_reward(state, params),
                                 torch.where(status == V.FAILURE, 0.0, reward))
            return state, reward, terminated | (status != V.CONTINUE)

    # ------------------------------------------------------------------ #
    # validation
    # ------------------------------------------------------------------ #

    def objs_reachable(self, b: dict, params: EnvParams) -> torch.Tensor:
        """check_objs_reachable as a flood fill from the agent: doors of any
        state pass, other objects are reached but block.  bool[B].

        The JAX package runs 2 (W + H) dilations on grids of at most 144
        cells and rounds that up to a multiple of 4 on larger ones; the port
        runs the same count, which covers every shortest path a BabyAI level
        can hold, and never reads a convergence flag on the host."""
        with trace.span("babyai.reachable"):
            grid = b["grid"]
            _, w, h = grid.shape
            types = grid & 0xFF
            empty = types == C.OBJECT_TO_IDX["empty"]
            wall = types == C.OBJECT_TO_IDX["wall"]
            expandable = empty | (types == C.OBJECT_TO_IDX["door"])
            dev = grid.device
            xs = torch.arange(w, device=dev)[:, None]
            ys = torch.arange(h, device=dev)[None, :]
            pos = b["agent_pos"]
            agent_cell = (xs == pos[:, 0, None, None]) & (ys == pos[:, 1, None, None])
            expandable = expandable | agent_cell
            # the edge masks drop what the rolls wrap around
            edges = ((1, 1, xs != 0), (-1, 1, xs != w - 1), (1, 2, ys != 0),
                     (-1, 2, ys != h - 1))
            trips = 2 * (w + h)
            if w * h > 144:
                trips = (trips + 3) // 4 * 4
            reach = agent_cell
            for _ in range(trips):
                src = reach & expandable
                for shift, dim, keep in edges:
                    reach = reach | (torch.roll(src, shift, dim) & keep)
            objects = ~empty & ~wall
            return (~objects | reach).flatten(1).all(dim=1)

    def putnext_valid(self, b: dict, instr: dict, params: EnvParams,
                      agent_pos: torch.Tensor, agent_dir: torch.Tensor) -> torch.Tensor:
        """validate_instrs for PutNext clauses: the move and fixed sets share
        no object and no pair of them is already 4-adjacent.  bool[B]."""
        n = instr["kinds"].shape[1]
        masks = V.desc_match_mask(b["grid"], torch.cat([instr["d1"], instr["d2"]], dim=1),
                                  agent_pos, agent_dir, None)
        m1, m2 = masks[:, :n], masks[:, n:]  # bool[B, n, W, H]
        w, h = m2.shape[2], m2.shape[3]
        dev = m2.device
        xs = torch.arange(w, device=dev)[:, None]
        ys = torch.arange(h, device=dev)[None, :]
        dil = ((torch.roll(m2, 1, 2) & (xs != 0))
               | (torch.roll(m2, -1, 2) & (xs != w - 1))
               | (torch.roll(m2, 1, 3) & (ys != 0))
               | (torch.roll(m2, -1, 3) & (ys != h - 1)))
        shared = (m1 & m2).flatten(2).any(dim=2)
        adjacent = (m1 & dil).flatten(2).any(dim=2)
        is_pn = instr["kinds"] == V.K_PUTNEXT
        return (~is_pn | (~shared & ~adjacent)).all(dim=1)

    # ------------------------------------------------------------------ #
    # mission surface
    # ------------------------------------------------------------------ #

    def mission_codes(self) -> np.ndarray:
        """One representative code, "go to the red ball": the instruction
        space is a grammar, not a list of templates."""
        code = np.zeros((1, MISSION_LEN), np.int32)
        code[0, 3] = V.K_GOTO
        code[0, 7] = V.OBJ_TYPES.index("ball") + 1  # d1[0] type
        code[0, 8] = C.COLOR_TO_IDX["red"]  # d1[0] color
        return code

    def mission_text(self, mission) -> str:
        instr, articles = unflatten_instr(mission)
        kinds, d1, d2 = instr["kinds"], instr["d1"], instr["d2"]

        def clause(k):
            return clause_surface(int(kinds[k]), d1[k], d2[k], bool(articles[2 * k]),
                                  bool(articles[2 * k + 1]))

        def operand(base, is_and):
            return clause(base) + " and " + clause(base + 1) if is_and else clause(base)

        a = operand(0, instr["a_and"])
        b = operand(2, instr["b_and"])
        seq = int(instr["seq_kind"])
        if seq == V.S_SINGLE:
            return a
        if seq == V.S_AND:
            return a + " and " + b
        if seq == V.S_BEFORE:
            return a + ", then " + b
        return a + " after you " + b
