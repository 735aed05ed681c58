"""BabyAI BossLevel: the base step plus the whole instruction verifier
(``babyai_full.py``), and the levels made again from their keys (Minigrid's
``minigrid/envs/babyai/core/levelgen.py::LevelGen`` with its defaults, as
the configuration draws them).

One draw from a key, ``k = split(key, 16)``:

* the lattice of ``Lattice.init_rooms(k[0])``, the agent at the middle of
  the grid facing right (``RoomGrid._gen_grid``);
* a locked room when ``uniform(k[1]) < locked_room_prob``: a uniform (room,
  side) pair among those with a neighbour (``categorical(k[2])``), a locked
  door of color ``rand_color`` on that wall's slot (``add_door``, ``k[3]``),
  and a key of its color in another uniform room (``categorical(k[4])``,
  placed as ``add_object`` places, ``k[5]``);
* ``connect_all(k[6])``: walls touching the locked room are not eligible;
* ``num_dists`` distractors, duplicates allowed (``k[7]``);
* the agent in a uniform room other than the locked one (``k[8]``);
* the instruction's shape ``randint(k[9], 0, 3)`` (action, and, seq), four
  clause kinds ``randint(fold_in(k[10], s), 0, 4)`` (goto, pickup, open,
  putnext; both lists as the configuration's ``instr_kinds`` and
  ``action_kinds`` give them, these by default), the descriptions of
  each slot from ``k[11]`` (the first) and ``k[12]`` (the fixed one), seq
  operands' And from ``k[13]`` and ``fold_in(k[13], 1)``, Before or After
  from ``k[14]``;
* ``validate_instrs``: no PutNext whose objects are shared or already
  adjacent, no clause naming a key of the locked door's color.

A reset draws at most 8 times from ``key, sub = split(key)`` of
``split(key, 3)[0]`` and keeps the first valid draw, else the 8th; a refill
draws once from ``split(key, 3)[1]``, and a slot whose draw is not valid
keeps its level.  ``split(key, 3)[2]`` is the level's own stream.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import babyai_full as BF
from perfbench.reference import minigrid as M
from perfbench.reference import roomgrid as RG
from perfbench.reference.roomgrid import Lattice

MAX_DRAWS = 8
DESC_FUEL = 24
ACTION_IDS = {"goto": BF.K_GOTO, "pickup": BF.K_PICKUP, "open": BF.K_OPEN,
              "putnext": BF.K_PUTNEXT}
# LevelGen's defaults, BossLevel's grammar
ACTION_KINDS = ("goto", "pickup", "open", "putnext")
INSTR_KINDS = ("action", "and", "seq")
KEY_LOCAL = 3  # the description type of a key


def _lattice(cfg: dict) -> Lattice:
    kw = cfg["env_kwargs"]
    return Lattice(kw["room_size"], kw["num_rows"], kw["num_cols"])


def _neighbour(lat: Lattice, room: int, side: int) -> int | None:
    """The room beside ``room`` on ``side`` (0 right, 1 down, 2 left, 3
    up), or None at the grid's edge."""
    i, j = room % lat.cols, room // lat.cols
    di, dj = M.DIR_TO_VEC[side]
    i, j = i + di, j + dj
    return j * lat.cols + i if 0 <= i < lat.cols and 0 <= j < lat.rows else None


def _wall_of(lat: Lattice, room: int, side: int) -> int:
    other = _neighbour(lat, room, side)
    return next(w for w, (pair, _, _) in enumerate(lat.walls)
                if set(pair) == {room, other})


def _room_xy(lat: Lattice, room: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return room % lat.cols, room // lat.cols


def uniform_below(keys: np.ndarray, p: float) -> np.ndarray:
    """``uniform(key) < p``: the float is its word's 23 high bits over 2^23,
    exact, so the test is on those bits."""
    return (M.bits(keys) >> np.uint64(9)).astype(np.float64) < p * 2**23


def add_locked_room(lat: Lattice, b: dict, k: np.ndarray, prob: float
                    ) -> tuple[dict, np.ndarray, np.ndarray]:
    """``LevelGen.add_locked_room`` where ``uniform(k[1]) < prob``: (builder,
    has_locked bool[N], the locked room int[N])."""
    n = k.shape[0]
    rooms = lat.rows * lat.cols
    has = uniform_below(k[:, 1], prob)
    pairs = [(r, s) for r in range(rooms) for s in range(4)]
    admitted = np.array([_neighbour(lat, r, s) is not None for r, s in pairs])
    pick = RG.categorical(k[:, 2], np.broadcast_to(admitted, (n, len(pairs))))
    room, side = pick // 4, pick % 4
    walls = [_wall_of(lat, r, s) if ok else 0 for (r, s), ok in zip(pairs, admitted)]
    wall = np.array(walls)[pick]
    # add_door(locked=True): split(key, 3) into color, lock, side draws
    color = RG.rand_color(M.split(k[:, 3], 3)[:, 0])
    grid = b["grid"].copy()
    rr = np.nonzero(has)[0]
    pos = b["door_pos"][rr, wall[rr]]
    grid[rr, pos[:, 0], pos[:, 1]] = M.pack(M.DOOR_T, color[rr], M.LOCKED)
    has_door = b["has_door"].copy()
    has_door[rr, wall[rr]] = True
    # the key of its color in another room: add_object's split(key, 3)
    admitted_k = np.arange(rooms)[None, :] != room[:, None]
    kroom = RG.categorical(k[:, 4], admitted_k)
    ki, kj = _room_xy(lat, kroom)
    free = (grid == M.EMPTY) & lat.room_mask(ki, kj) & ~_near(lat, b)
    kpos, ok = RG.sample_cell(M.split(k[:, 5], 3)[:, 2], free)
    put = ok & has
    grid[np.nonzero(put)[0], kpos[put, 0], kpos[put, 1]] = M.pack(M.KEY_T, color[put])
    return {**b, "grid": grid, "has_door": has_door}, has, room


def agent_room(lat: Lattice, b: dict) -> tuple[np.ndarray, np.ndarray, int]:
    """The agent's room as (x0, y0, size), walls included: where a located
    description looks."""
    step = lat.s - 1
    return b["pos"][:, 0] // step * step, b["pos"][:, 1] // step * step, lat.s


def _near(lat: Lattice, b: dict) -> np.ndarray:
    """The cells within manhattan distance 1 of the agent: no object is
    placed there."""
    px, py = b["pos"][:, 0, None, None], b["pos"][:, 1, None, None]
    return np.abs(lat.xs - px) + np.abs(lat.ys - py) < 2


def connect_all(lat: Lattice, b: dict, keys: np.ndarray, locked: np.ndarray) -> dict:
    """``RoomGrid.connect_all`` with a locked room: walls drawn in the order
    of ``permutation(split(key)[0], n_walls)``, each wall with no door yet
    and not touching a locked room (``locked`` bool[N, rooms]) turned into a
    closed door of color ``rand_color(split(split(key)[1], n_walls)[w])``,
    until every room is reachable (the locked one through its door)."""
    n = keys.shape[0]
    k = M.split(keys)
    nw = len(lat.walls)
    rank = RG.permutation(k[:, 0], nw)
    colors = RG.rand_color(M.split(k[:, 1], nw))
    rooms = lat.rows * lat.cols
    has = b["has_door"].copy()
    label = np.broadcast_to(np.arange(rooms), (n, rooms)).copy()
    for w, ((r1, r2), _, _) in enumerate(lat.walls):
        label = RG._join(label, has[:, w], r1, r2)
    joined = (label == label[:, :1]).all(1)
    room1 = np.array([pair[0] for pair, _, _ in lat.walls])
    room2 = np.array([pair[1] for pair, _, _ in lat.walls])
    new = np.zeros_like(has)
    rr = np.arange(n)
    for r in range(nw):
        w = (rank == r).argmax(1)
        add = ~joined & ~has[rr, w] & ~locked[rr, room1[w]] & ~locked[rr, room2[w]]
        new[rr[add], w[add]] = True
        has[rr[add], w[add]] = True
        for wi, ((a, c), _, _) in enumerate(lat.walls):
            label = RG._join(label, add & (w == wi), a, c)
        joined = (label == label[:, :1]).all(1)
    grid = b["grid"].copy()
    pos = b["door_pos"]
    ni, wi = np.nonzero(new)
    grid[ni, pos[ni, wi, 0], pos[ni, wi, 1]] = RG.DOOR_CLOSED | (colors[ni, wi] << 8)
    return {**b, "grid": grid, "has_door": has}


# -- the instruction --------------------------------------------------------------

def sample_desc(keys: np.ndarray, kind: np.ndarray, fixed: np.ndarray, locations: bool
                ) -> np.ndarray:
    """``LevelGen.rand_obj``'s one draw, ``split(key, 4)``: a color uniform
    over [any, *colors], a type uniform over the clause's types (open: door;
    goto and PutNext's fixed object: box, ball, key, door; otherwise box,
    ball, key; as ``u % 4`` or ``u % 3`` of ``u`` uniform below 12), and with
    ``locations`` a location with probability 1/2.  int[N, 3]."""
    s = M.split(keys, 4)
    ci = M.randint(s[:, 0], (), 0, 11)
    u = M.randint(s[:, 1], (), 0, 12)
    color = np.where(ci == 0, 0, RG.SORTED_COLORS[np.maximum(ci - 1, 0)])
    any_type = (kind == BF.K_GOTO) | ((kind == BF.K_PUTNEXT) & fixed)
    t = np.where(kind == BF.K_OPEN, 4, np.where(any_type, 1 + u % 4, 1 + u % 3))
    loc = np.zeros_like(u)
    if locations:
        loc = np.where(M.randint(s[:, 2], (), 0, 2) == 0, 1 + M.randint(s[:, 3], (), 0, 4), 0)
    return np.stack([t, color, loc], 1)


def rand_objs(key1: np.ndarray, key2: np.ndarray, kinds: np.ndarray, b: dict,
              room: np.ndarray, locations: bool) -> tuple[np.ndarray, np.ndarray]:
    """The two descriptions of each of the 4 slots, (first, fixed) int[N, 4,
    3] each: ``rand_obj`` until one matches an object.  Lane s of the first
    descriptions draws from ``fold_in(key1, s)``, of the fixed ones from
    ``fold_in(key2, s)``, split into the lane's chain and its first draw;
    its r-th redraw is the second key of the r-th split of its chain, so the
    lanes are independent and are drawn side by side here.  Upstream
    restarts the level after 100 tries; the configuration keeps the 24th
    redraw (``assumed``: ``descriptor_fuel``)."""
    n = key1.shape[0]
    lanes = np.arange(BF.K)
    keys = np.concatenate([M.fold_in(key1[:, None], lanes), M.fold_in(key2[:, None], lanes)],
                          1).reshape(-1, 2)  # [N * 8, 2], env-major
    kind = np.concatenate([kinds, kinds], 1).reshape(-1)
    fixed = np.broadcast_to(np.arange(2 * BF.K) >= BF.K, (n, 2 * BF.K)).reshape(-1)
    env = np.repeat(np.arange(n), 2 * BF.K)
    c = M.split(keys)
    chain = c[:, 0]
    desc = sample_desc(c[:, 1], kind, fixed, locations)

    objs = BF.objects(b["grid"])

    def unmatched(i):
        return ~BF.any_match(objs, env[i], desc[i], b["pos"], b["dir"], room)

    idx = np.nonzero(unmatched(np.arange(n * 2 * BF.K)))[0]
    for _ in range(DESC_FUEL):
        if not idx.size:
            break
        c = M.split(chain[idx])
        chain[idx] = c[:, 0]
        desc[idx] = sample_desc(c[:, 1], kind[idx], fixed[idx], locations)
        idx = idx[unmatched(idx)]
    desc = desc.reshape(n, 2 * BF.K, 3)
    return desc[:, :BF.K], desc[:, BF.K:]


def putnext_valid(b: dict, instr: dict) -> np.ndarray:
    """``validate_instrs`` of each PutNext clause: no object matches both
    descriptions, and none to move already stands next to a fixed one.
    Upstream matches a located description in the agent's room only; the
    configuration's check matches it anywhere (``assumed``:
    ``putnext_check_everywhere``).  bool[N]."""
    ok = np.ones(b["grid"].shape[0], bool)
    for s in range(BF.K):
        m1 = BF.find_matching_objs(b["grid"], instr["d1"][:, s], b["pos"], b["dir"], None)
        m2 = BF.find_matching_objs(b["grid"], instr["d2"][:, s], b["pos"], b["dir"], None)
        bad = (m1 & m2).any((1, 2)) | (m1 & BF.pos_next_to(m2)).any((1, 2))
        ok &= ~((instr["kinds"][:, s] == BF.K_PUTNEXT) & bad)
    return ok


def unblocking_valid(b: dict, instr: dict, use: np.ndarray) -> np.ndarray:
    """``validate_instrs`` with unblocking: no description names a key of a
    locked door's color.  Upstream reads the descriptions of each clause;
    the configuration reads both descriptions of every clause in use, the
    fixed one of a clause that is not PutNext included (``assumed``:
    ``unblocking_reads_both_descs``).  bool[N]."""
    g = b["grid"]
    n = g.shape[0]
    locked = (M.cell_type(g) == M.DOOR_T) & (M.cell_state(g) == M.LOCKED)
    # bool[N, colors]: a locked door of that color
    colors = np.zeros((n, 16), bool)
    e, x, y = np.nonzero(locked)
    colors[e, M.cell_color(g[e, x, y])] = True
    ok = np.ones(n, bool)
    for f in ("d1", "d2"):
        t, c = instr[f][..., 0], instr[f][..., 1]
        named = colors[np.arange(n)[:, None], c]
        ok &= ~(use & (t == KEY_LOCAL) & (c > 0) & named).any(1)
    return ok


def draw(keys: np.ndarray, cfg: dict) -> tuple[dict, dict, np.ndarray]:
    """One draw of BossLevel's level a key: (builder, instruction code,
    valid bool[N])."""
    kw = cfg["env_kwargs"]
    lat = _lattice(cfg)
    n = keys.shape[0]
    k = M.split(keys, 16)
    b = lat.init_rooms(k[:, 0])
    mid = ((lat.cols // 2) * (lat.s - 1) + lat.s // 2, (lat.rows // 2) * (lat.s - 1) + lat.s // 2)
    b["pos"] = np.broadcast_to(np.array(mid), (n, 2)).copy()
    b["dir"] = np.zeros(n, np.int64)
    rooms = lat.rows * lat.cols
    b, has_locked, lroom = add_locked_room(lat, b, k, kw["locked_room_prob"])
    locked = (np.arange(rooms)[None, :] == lroom[:, None]) & has_locked[:, None]
    b = connect_all(lat, b, k[:, 6], locked)
    b, _ = lat.add_distractors(b, k[:, 7], kw["num_dists"])
    # the agent in a uniform room but the locked one
    s8 = M.split(k[:, 8])
    room = RG.categorical(s8[:, 0], ~locked)
    b = lat.place_agent_in_room(b, s8[:, 1], *_room_xy(lat, room))

    action_kinds = kw.get("action_kinds", ACTION_KINDS)
    instr_kinds = list(kw.get("instr_kinds", INSTR_KINDS))
    shape = M.randint(k[:, 9], (), 0, len(instr_kinds))
    ids = np.array([ACTION_IDS[a] for a in action_kinds])
    ck = ids[M.randint(M.fold_in(k[:, 10, None], np.arange(BF.K)), (), 0, len(ids))]
    d1, d2 = rand_objs(k[:, 11], k[:, 12], ck, b, agent_room(lat, b), kw["locations"])
    is_action, is_and, is_seq = (shape == (instr_kinds.index(x) if x in instr_kinds else -1)
                                 for x in INSTR_KINDS)
    a_and = is_seq & (M.randint(k[:, 13], (), 0, 2) == 0)
    b_and = is_seq & (M.randint(M.fold_in(k[:, 13], 1), (), 0, 2) == 0)
    seq = np.where(is_action, BF.S_SINGLE, np.where(
        is_and, BF.S_AND, np.where(M.randint(k[:, 14], (), 0, 2) == 0, BF.S_BEFORE, BF.S_AFTER)))
    # the slots in use: a seq's operand a in 0 (and 1 where an And), b in 2
    # (and 3); a top-level And's two clauses in 0 and 2
    use = np.stack([np.ones(n, bool), a_and, is_and | is_seq, b_and], 1)
    instr = {"seq_kind": seq, "a_and": a_and, "b_and": b_and, "kinds": ck * use,
             "d1": d1 * use[..., None], "d2": d2 * use[..., None],
             "strict": np.zeros((n, BF.K), bool)}
    valid = putnext_valid(b, instr) & unblocking_valid(b, instr, use)
    return b, instr, valid


def episode_limit(cfg: dict, kinds: np.ndarray) -> np.ndarray:
    """A level's own step limit: num_navs_needed times the maze's cells,
    room_size^2 x rooms; 0 (the env's fixed limit) where the configuration
    fixes ``max_steps``."""
    kw = cfg["env_kwargs"]
    if "max_steps" in kw:
        return np.zeros(kinds.shape[0], np.int64)
    return BF.num_navs_needed(kinds) * kw["room_size"] ** 2 * kw["num_rows"] * kw["num_cols"]


def _finish(b: dict, instr: dict, state_keys: np.ndarray, cfg: dict) -> dict:
    """The level a draw stands for: every field the configuration's state
    holds, the instruction and the verifier's start with it."""
    lat = _lattice(cfg)
    grid = b["grid"]
    n, w, h = grid.shape
    room = agent_room(lat, b)
    m1 = BF.match_all(grid, instr["d1"], b["pos"], b["dir"], room)
    m2 = BF.match_all(grid, instr["d2"], b["pos"], b["dir"], room)
    plural = np.concatenate([m1.sum((2, 3)), m2.sum((2, 3))], 1) > 1
    return {
        "grid": grid, "pos": b["pos"], "dir": b["dir"],
        "carrying": np.full(n, M.EMPTY, np.int64),
        "step_count": np.zeros(n, np.int64),
        "max_steps": episode_limit(cfg, instr["kinds"]),
        "rng": state_keys,
        "mission": BF.mission(instr, plural),
        "terminated": np.zeros(n, bool), "truncated": np.zeros(n, bool),
        "box": np.full((n, w, h), M.EMPTY, np.int64),
        "carrying_box": np.full(n, M.EMPTY, np.int64),
        "extra": {"instr": instr, "vs": BF.reset_verifier(m1, m2)},
    }


def _put(a, rows: np.ndarray, v):
    if isinstance(a, dict):
        return {k: _put(a[k], rows, v[k]) for k in a}
    a = a.copy()
    a[rows] = v
    return a


def generate(keys: np.ndarray, cfg: dict) -> dict:
    """A reset's levels: the first valid of at most 8 draws, else the 8th.
    Upstream draws until one is valid (``assumed``: ``reset_draw_cap``)."""
    chain, _, state_keys = (M.split(keys, 3)[:, i] for i in range(3))
    left = np.arange(keys.shape[0])
    out = None
    for _ in range(MAX_DRAWS):
        s = M.split(chain)
        chain = s[:, 0]
        b, instr, ok = draw(s[:, 1], cfg)
        part = {"b": {f: b[f] for f in ("grid", "pos", "dir")}, "instr": instr}
        out = part if out is None else _put(out, left, part)
        left, chain = left[~ok], chain[~ok]
        if not left.size:
            break
    return _finish(out["b"], out["instr"], state_keys, cfg)


def attempt(keys: np.ndarray, cfg: dict) -> tuple[dict, np.ndarray]:
    """A refill's levels: one draw each, and whether it is valid."""
    s = M.split(keys, 3)
    b, instr, ok = draw(s[:, 1], cfg)
    return _finish(b, instr, s[:, 2], cfg), ok


def post_step(before: dict, after: dict, action, outcome, reward, terminated, cfg,
              reward_fn=M.goal_reward):
    """The verifier after the transition: success ends the episode with the
    goal reward of the step, failure with 0."""
    status, vs = BF.verify_step(before, after, action, outcome)
    reward = reward.copy()
    limit = np.where(after["max_steps"] > 0, after["max_steps"],
                     cfg["env_kwargs"].get("max_steps", 0))
    for i in np.nonzero(status == BF.SUCCESS)[0]:
        reward[i] = reward_fn(int(after["step_count"][i]), int(limit[i]))
    reward[status == BF.FAILURE] = 0
    after = {**after, "extra": {**after["extra"], "vs": vs}}
    return after, reward, terminated | (status != BF.CONTINUE)


def modelled(level: dict) -> dict:
    """Every field the reference computes: the state, the whole instruction
    code, the mission and every field of the verifier's state."""
    extra = level["extra"]
    return {**level, "extra": {"instr": dict(extra["instr"]), "vs": dict(extra["vs"])}}
