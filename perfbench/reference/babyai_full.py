"""Plain NumPy reference of BabyAI's whole instruction verifier
(Chevalier-Boisvert et al., ICLR 2019; Minigrid's
``minigrid/envs/babyai/core/verifier.py`` and ``roomgrid_level.py``): the
descriptions, the four action instructions, their And/Before/After
composition, the step limit and the articles, as the configuration states
them.

Upstream, over one env:

* ``ObjDesc.find_matching_objs``: the objects of the description's type and
  color; one with a location (left, right, in front, behind) lies in the
  room the agent starts in, on that side of the agent's pose at reset.  The
  matched objects (``obj_set``) are tracked for the episode; their
  positions (``obj_poss``) are refreshed on every drop action
  (``update_objs_poss``), for every description of the instruction;
* ``GoToInstr``: the cell in front of the agent is one of ``obj_poss``;
  ``PickupInstr``: a pickup action with empty hands at the clause's last
  check, now holding a tracked object; ``OpenInstr``: a toggle that leaves a
  tracked door in front of the agent open; ``PutNextInstr``: a drop of the
  tracked object the agent held at the clause's last check onto a cell
  next to one of the fixed description's positions.  Each clause keeps what
  the hands held when it was last checked (``preCarrying``);
* ``AndInstr``: each operand checked until it has succeeded, success when
  both have; ``BeforeInstr``: a, then b (b checked in the step a succeeds);
  ``AfterInstr``: the mirror.  Success ends the episode with the goal
  reward of the step.

A level's verifier state is the configuration's: per clause k (four slots,
operand a in slots 0-1, operand b in 2-3) the planes of the tracked objects'
cells ``tracked1``/``tracked2`` (desc and the fixed desc), the positions
checked ``stale1``/``stale2`` (``obj_poss``), whether the hand holds a
tracked object ``carry1``/``carry2``, the clause's last-checked hands
``pre_empty``/``pre_carry1``, ``last_match`` (unused without done actions),
and per operand ``a_packed``/``b_packed``: its status plus 4 and 8 for its
first and second clause having succeeded.  An object is identified by the
cell it stands on, or by the hand that holds it: it moves only by the
agent's pickup and drop.

Where the configuration departs from upstream (its ``assumed`` entries),
this module follows the configuration, and says so at the place.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import minigrid as M

K_NONE, K_GOTO, K_PICKUP, K_OPEN, K_PUTNEXT = range(5)
S_SINGLE, S_BEFORE, S_AFTER, S_AND = range(4)
CONTINUE, SUCCESS, FAILURE = 0, 1, 2
# a description's type: 0 "object" (any of the four), box, ball, key, door
DESC_TYPES = np.array([-1, M.BOX_T, M.BALL_T, M.KEY_T, M.DOOR_T], np.int64)
K = 4
MISSION_LEN = 43


# -- descriptions ---------------------------------------------------------------

def matches(types, colors, xs, ys, desc, pos, d, room) -> np.ndarray:
    """``ObjDesc.find_matching_objs``'s test of one object: whether objects
    of type ``types`` and color ``colors`` at (``xs``, ``ys``) match ``desc``
    [..., 3] (type, color or 0 for any, location 0 none / 1 left / 2 right /
    3 front / 4 behind), the location taken from the agent's pose ``pos``
    [..., 2], ``d`` and, with ``room`` (x0, y0, size) of the agent's starting
    room, only inside it.  Arguments broadcast; type 0 ("object") matches
    any of the four describable types."""
    t, color, loc = desc[..., 0], desc[..., 1], desc[..., 2]
    describable = ((types == M.BOX_T) | (types == M.BALL_T) | (types == M.KEY_T)
                   | (types == M.DOOR_T))
    type_ok = np.where(t == 0, describable, types == DESC_TYPES[t])
    color_ok = (color == 0) | (colors == color)
    vx, vy = xs - pos[..., 0], ys - pos[..., 1]
    d1 = M.DIR_TO_VEC[d]
    # (d1, d2) an oriented basis: d2 = (-d1.y, d1.x)
    dot1 = vx * d1[..., 0] + vy * d1[..., 1]
    dot2 = vx * -d1[..., 1] + vy * d1[..., 0]
    side = np.where(loc == 1, dot2 < 0, np.where(loc == 2, dot2 > 0, np.where(
        loc == 3, dot1 > 0, dot1 < 0)))
    if room is not None:
        x0, y0, size = room
        side = side & (xs >= x0) & (xs < x0 + size) & (ys >= y0) & (ys < y0 + size)
    return type_ok & color_ok & ((loc == 0) | side)


def find_matching_objs(grid: np.ndarray, desc: np.ndarray, pos: np.ndarray,
                       d: np.ndarray, room) -> np.ndarray:
    """:func:`matches` over every cell of the grids int[N, W, H], one
    description ``desc`` int[N, 3] and pose a grid (``room``: x0 int[N],
    y0 int[N], size): bool[N, W, H]."""
    n, w, h = grid.shape
    xs = np.arange(w)[None, :, None]
    ys = np.arange(h)[None, None, :]
    if room is not None:
        room = (room[0][:, None, None], room[1][:, None, None], room[2])
    return matches(M.cell_type(grid), M.cell_color(grid), xs, ys, desc[:, None, None],
                   pos[:, None, None], d[:, None, None], room)


def objects(grid: np.ndarray) -> dict:
    """The objects a description can name, per grid, as lists padded to
    the longest: ``t``, ``c``, ``x``, ``y`` int[N, O] (padding: type 0,
    which no description names)."""
    n = grid.shape[0]
    t = M.cell_type(grid)
    e, x, y = np.nonzero((t == M.BOX_T) | (t == M.BALL_T) | (t == M.KEY_T) | (t == M.DOOR_T))
    count = np.bincount(e, minlength=n)
    slot = np.arange(e.size) - np.repeat(np.cumsum(count) - count, count)
    o = max(int(count.max(initial=0)), 1)
    out = {f: np.zeros((n, o), np.int64) for f in ("t", "c", "x", "y")}
    out["t"][e, slot] = t[e, x, y]
    out["c"][e, slot] = M.cell_color(grid[e, x, y])
    out["x"][e, slot], out["y"][e, slot] = x, y
    return out


def any_match(objs: dict, env: np.ndarray, desc: np.ndarray, pos: np.ndarray, d: np.ndarray,
              room) -> np.ndarray:
    """Whether description ``desc[i]`` int[P, 3] names an object of grid
    ``env[i]`` (``objs`` from :func:`objects`; ``pos``, ``d``, ``room`` per
    grid): bool[P]."""
    o = {f: v[env] for f, v in objs.items()}
    if room is not None:
        room = (room[0][env, None], room[1][env, None], room[2])
    return matches(o["t"], o["c"], o["x"], o["y"], desc[:, None], pos[env, None],
                   d[env, None], room).any(1)


def match_all(grid, descs: np.ndarray, pos, d, room) -> np.ndarray:
    """:func:`find_matching_objs` of each of M descriptions [N, M, 3]:
    bool[N, M, W, H]."""
    return np.stack([find_matching_objs(grid, descs[:, m], pos, d, room)
                     for m in range(descs.shape[1])], 1)


def num_navs_needed(kinds: np.ndarray) -> np.ndarray:
    """``RoomGridLevel.num_navs_needed``: 2 a PutNext, 1 another action
    clause, summed over the instruction: int[N]."""
    return np.where(kinds == K_PUTNEXT, 2, np.where(kinds == K_NONE, 0, 1)).sum(1)


def pos_next_to(cells: np.ndarray) -> np.ndarray:
    """The cells 4-adjacent to a True cell of bool[..., W, H]
    (``pos_next_to``: manhattan distance 1)."""
    out = np.zeros_like(cells)
    out[..., 1:, :] |= cells[..., :-1, :]
    out[..., :-1, :] |= cells[..., 1:, :]
    out[..., :, 1:] |= cells[..., :, :-1]
    out[..., :, :-1] |= cells[..., :, 1:]
    return out


# -- the verifier's state -------------------------------------------------------

def unpack_planes(words: np.ndarray, h: int) -> np.ndarray:
    """int64[..., W] words -> bool[..., W, H], bit y of word x cell (x, y)."""
    octets = np.ascontiguousarray(words, "<i8")[..., None].view(np.uint8)
    return np.unpackbits(octets, axis=-1, bitorder="little")[..., :h].astype(bool)


def pack_planes(mask: np.ndarray) -> np.ndarray:
    """The inverse of :func:`unpack_planes`."""
    bits = np.zeros(mask.shape[:-1] + (64,), bool)
    bits[..., :mask.shape[-1]] = mask
    return np.packbits(bits, axis=-1, bitorder="little").view("<i8")[..., 0].astype(np.int64)


def reset_verifier(tracked1: np.ndarray, tracked2: np.ndarray) -> dict:
    """Every clause's state at reset from its descriptions' matches
    bool[N, K, W, H]: nothing held, every ``preCarrying`` None, every
    operand continuing."""
    n, k = tracked1.shape[:2]
    p1, p2 = pack_planes(tracked1), pack_planes(tracked2)
    no = np.zeros((n, k), bool)
    return {"tracked1": p1, "tracked2": p2, "stale1": p1.copy(), "stale2": p2.copy(),
            "carry1": no.copy(), "carry2": no.copy(), "pre_empty": ~no,
            "pre_carry1": no.copy(), "last_match": no.copy(),
            "a_packed": np.zeros(n, np.int64), "b_packed": np.zeros(n, np.int64)}


def move_objects(tracked: np.ndarray, carry: np.ndarray, fwd: np.ndarray,
                 picked: np.ndarray, dropped: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The tracked objects after the agent's pickup or drop at the cells
    ``fwd`` [N, 2]: one picked up from a tracked cell is held, one held and
    dropped stands at the drop cell.  (tracked bool[N, K, W, H], carry
    bool[N, K]).

    Upstream a tracked box that a toggle opens is replaced by its contents
    and tracked no more; the configuration keeps its cell tracked
    (``assumed``: ``toggled_box_stays_tracked``), so a toggle moves
    nothing here."""
    n, _, w, h = tracked.shape
    rows = np.arange(n)
    fx, fy = np.clip(fwd[:, 0], 0, w - 1), np.clip(fwd[:, 1], 0, h - 1)
    tracked = tracked.copy()
    at_front = tracked[rows, :, fx, fy]
    carry = np.where(picked[:, None], at_front, carry)
    cell = np.where(picked[:, None], False, at_front) | (dropped[:, None] & carry)
    tracked[rows, :, fx, fy] = cell
    return tracked, carry & ~dropped[:, None]


def clause_results(vs: dict, tracked1: np.ndarray, stale1: np.ndarray,
                   stale2: np.ndarray, carry1: np.ndarray, instr: dict,
                   after: dict, action: np.ndarray, outcome: dict) -> np.ndarray:
    """What each clause's ``verify_action`` returns if it is checked this
    step: int[N, K].  Planes and carry flags are those after the objects
    moved and the positions were refreshed; ``vs`` holds the clauses'
    ``preCarrying`` of their last check."""
    n, _, w, h = tracked1.shape
    rows = np.arange(n)
    front = after["pos"] + M.DIR_TO_VEC[after["dir"]]
    inb = (front[:, 0] >= 0) & (front[:, 0] < w) & (front[:, 1] >= 0) & (front[:, 1] < h)
    fx, fy = np.clip(front[:, 0], 0, w - 1), np.clip(front[:, 1], 0, h - 1)
    fcell = np.where(inb, after["grid"][rows, fx, fy], M.WALL)
    front_door = M.cell_type(fcell) == M.DOOR_T
    holding = M.cell_type(after["carrying"]) != M.EMPTY_T
    kind, strict = instr["kinds"], instr["strict"].astype(bool)
    a = action[:, None]

    goto = stale1[rows, :, fx, fy] & inb[:, None]
    open_ok = ((a == M.TOGGLE) & tracked1[rows, :, fx, fy] & inb[:, None]
               & (front_door & (M.cell_state(fcell) == M.OPEN))[:, None])
    open_fail = (a == M.TOGGLE) & strict & front_door[:, None] & ~open_ok
    pickup = (a == M.PICKUP) & vs["pre_empty"] & carry1
    pickup_fail = (a == M.PICKUP) & strict & holding[:, None] & ~pickup
    # the object held at the last check, dropped now beside a fixed one
    drop = outcome["fwd"]
    at_drop = np.zeros((n, w, h), bool)
    ok = outcome["dropped"]
    at_drop[rows[ok], drop[ok, 0], drop[ok, 1]] = True
    beside = (stale2 & pos_next_to(at_drop)[:, None]).any((2, 3))
    putnext = (a == M.DROP) & ok[:, None] & vs["pre_carry1"] & beside
    putnext_fail = (a == M.PICKUP) & strict & holding[:, None]

    res = np.full(kind.shape, CONTINUE, np.int64)
    for k_id, succ, fail in ((K_GOTO, goto, None), (K_PICKUP, pickup, pickup_fail),
                             (K_OPEN, open_ok, open_fail), (K_PUTNEXT, putnext, putnext_fail)):
        res = np.where((kind == k_id) & succ, SUCCESS, res)
        if fail is not None:
            res = np.where((kind == k_id) & fail & (res == CONTINUE), FAILURE, res)
    return res


class _Env:
    """One env's composite verifier over a step: the upstream control flow
    of And/Before/After, checking the clauses whose results ``would``
    holds."""

    def __init__(self, would, seq, a_and, b_and, a_packed, b_packed):
        self.would = would
        self.seq = seq
        self.is_and = (a_and, b_and)
        # per operand: its status and its two clauses' success flags
        self.stat = [a_packed % 4, b_packed % 4]
        self.done = [[(a_packed // 4) % 2 == 1, (a_packed // 8) % 2 == 1],
                     [(b_packed // 4) % 2 == 1, (b_packed // 8) % 2 == 1]]
        self.checked = [False] * K

    def operand(self, o: int) -> int:
        """Operand ``o`` (0: a, 1: b) checked: an ``AndInstr`` of its two
        clauses, each checked until it has succeeded, or its one clause."""
        base = 2 * o
        done = self.done[o]
        # the configuration's snapshot rule (``assumed``: ``clause_snapshots``):
        # both clauses of a checked And take their snapshot, one that has
        # already succeeded included (it is never read again)
        self.checked[base] = True
        self.checked[base + 1] = self.is_and[o]
        r0 = SUCCESS if done[0] else self.would[base]
        r1 = SUCCESS if done[1] else self.would[base + 1]
        done[0], done[1] = r0 == SUCCESS, r1 == SUCCESS
        if not self.is_and[o]:
            return self.would[base]
        return SUCCESS if r0 == SUCCESS and r1 == SUCCESS else CONTINUE

    def verify(self) -> int:
        if self.seq == S_SINGLE:
            r = self.operand(0)
            if r == SUCCESS:
                self.stat[0] = SUCCESS
            return r
        if self.seq == S_AND:
            for o in (0, 1):
                if self.stat[o] != SUCCESS and self.operand(o) == SUCCESS:
                    self.stat[o] = SUCCESS
            return SUCCESS if self.stat[0] == self.stat[1] == SUCCESS else CONTINUE
        first, then = (0, 1) if self.seq == S_BEFORE else (1, 0)
        if self.stat[first] == SUCCESS:
            self.stat[then] = self.operand(then)
            return self.stat[then]
        self.stat[first] = self.operand(first)
        if self.stat[first] == FAILURE:
            return FAILURE
        if self.stat[first] == SUCCESS:
            self.stat[then] = self.operand(then)
            return self.stat[then]
        return CONTINUE

    def packed(self, o: int) -> int:
        return self.stat[o] + 4 * int(self.done[o][0]) + 8 * int(self.done[o][1])


def verify_step(before: dict, after: dict, action: np.ndarray, outcome: dict
                ) -> tuple[np.ndarray, dict]:
    """``RoomGridLevel.step``'s verifier over one transition ``before`` ->
    ``after`` (levels of the minigrid reference, ``extra`` holding the
    instruction code and the verifier state): (status int[N], the new
    verifier state)."""
    vs, instr = before["extra"]["vs"], before["extra"]["instr"]
    n, w, h = after["grid"].shape
    tracked = [unpack_planes(vs[f], h) for f in ("tracked1", "tracked2")]
    stale = [unpack_planes(vs[f], h) for f in ("stale1", "stale2")]
    carry = [vs["carry1"].astype(bool), vs["carry2"].astype(bool)]
    for i in (0, 1):
        tracked[i], carry[i] = move_objects(tracked[i], carry[i], outcome["fwd"],
                                            outcome["picked"], outcome["dropped"])
        # update_objs_poss on every drop action
        refresh = action == M.DROP
        stale[i] = np.where(refresh[:, None, None, None], tracked[i], stale[i])
    would = clause_results(vs, tracked[0], stale[0], stale[1], carry[0], instr, after,
                           action, outcome)
    status = np.zeros(n, np.int64)
    a_packed, b_packed = vs["a_packed"].copy(), vs["b_packed"].copy()
    checked = np.zeros((n, K), bool)
    for i in range(n):
        env = _Env(would[i].tolist(), int(instr["seq_kind"][i]), bool(instr["a_and"][i]),
                   bool(instr["b_and"][i]), int(vs["a_packed"][i]), int(vs["b_packed"][i]))
        status[i] = env.verify()
        a_packed[i], b_packed[i] = env.packed(0), env.packed(1)
        checked[i] = env.checked
    # each checked clause's preCarrying: the hands after the step
    empty_after = M.cell_type(after["carrying"]) == M.EMPTY_T
    new = {**vs,
           "tracked1": pack_planes(tracked[0]), "tracked2": pack_planes(tracked[1]),
           "stale1": pack_planes(stale[0]), "stale2": pack_planes(stale[1]),
           "carry1": carry[0], "carry2": carry[1],
           "pre_empty": np.where(checked, empty_after[:, None], vs["pre_empty"]),
           "pre_carry1": np.where(checked, carry[0], vs["pre_carry1"]),
           "a_packed": a_packed, "b_packed": b_packed}
    return status, new


def mission(instr: dict, plural: np.ndarray) -> np.ndarray:
    """The configuration's mission code int[N, 43]: [seq, a_and, b_and,
    kinds(4), d1(4x3), d2(4x3), strict(4), articles(8)], articles[2k] and
    [2k + 1] whether clause k's descriptions take "a" (several objects
    match, ``ObjDesc.surface``) rather than "the"; ``plural`` bool[N, 2K],
    d1's first."""
    n = plural.shape[0]
    articles = np.stack([plural[:, :K], plural[:, K:]], 2).reshape(n, 2 * K)
    parts = [instr["seq_kind"][:, None], instr["a_and"][:, None], instr["b_and"][:, None],
             instr["kinds"], instr["d1"].reshape(n, -1), instr["d2"].reshape(n, -1),
             instr["strict"], articles]
    return np.concatenate([np.asarray(p).astype(np.int64) for p in parts], 1)
