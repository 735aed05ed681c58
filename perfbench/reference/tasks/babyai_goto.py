"""BabyAI GoTo: the base step plus the GoTo instruction's verifier, and the
levels made again from their keys (Minigrid's
``minigrid/envs/babyai/goto.py::GoTo.gen_mission`` and
``RoomGridLevel._gen_grid`` as the configuration draws them).

One draw from a key: ``split(key, 5)`` into the rooms, the agent, the
doors, the distractors and the target; the rooms of ``Lattice.init_rooms``,
the agent anywhere (``place_agent_any``), ``connect_all``, ``num_dists``
distractors, and "go to the <color> <type>" of a uniform one of them.  The
draw is accepted when every object is reachable.  A reset draws at most
8 times from ``key, sub = split(key)`` of ``split(key, 3)[0]`` and keeps
the last draw; a refill draws once from ``split(key, 3)[1]``, and a slot
whose draw is not accepted keeps its level.  ``split(key, 3)[2]`` is the
level's own stream.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import babyai as BA
from perfbench.reference import minigrid as M
from perfbench.reference.roomgrid import Lattice

MAX_DRAWS = 8
MISSION_LEN = 43
# the instruction's description types: box, ball, key, door
DESC_OF_TYPE = {M.BOX_T: 1, M.BALL_T: 2, M.KEY_T: 3, M.DOOR_T: 4}


def draw(keys: np.ndarray, cfg: dict) -> tuple[dict, np.ndarray]:
    """One draw of GoTo's level a key: (the builder with the target's
    (type, color) under ``target``, accepted bool[N])."""
    kw = cfg["env_kwargs"]
    lat = Lattice(kw["room_size"], kw["num_rows"], kw["num_cols"])
    k = M.split(keys, 5)
    b = lat.init_rooms(k[:, 0])
    b = lat.place_agent_any(b, k[:, 1])
    b = lat.connect_all(b, k[:, 2])
    b, objs = lat.add_distractors(b, k[:, 3], kw["num_dists"])
    accepted = lat.objs_reachable(b)
    pick = M.randint(k[:, 4], (), 0, objs.shape[1])
    b["target"] = objs[np.arange(keys.shape[0]), pick]
    return b, accepted


def episode_limit(cfg: dict) -> int:
    """A level's own step limit: num_navs_needed (1 for GoTo) times the
    maze's cells, room_size^2 x rooms; 0 (the env's fixed limit) where the
    configuration fixes ``max_steps``."""
    kw = cfg["env_kwargs"]
    if "max_steps" in kw:
        return 0
    return kw["room_size"] ** 2 * kw["num_rows"] * kw["num_cols"]


def _finish(b: dict, state_keys: np.ndarray, cfg: dict) -> dict:
    """The level a builder stands for: every field the configuration's
    state holds, the instruction and the verifier's start with it."""
    grid = b["grid"]
    n, w, h = grid.shape
    t, color = b["target"][:, 0], b["target"][:, 1]
    d1 = np.stack([np.vectorize(DESC_OF_TYPE.get)(t), color, np.zeros(n, np.int64)], 1)
    d2 = np.zeros((n, 3), np.int64)
    tracked = BA.desc_mask(grid, d1)
    # d2 ("any object", no color) matches every key, ball, box and door
    plural = np.stack([tracked.sum((1, 2)) > 1,
                       np.isin(M.cell_type(grid), (M.KEY_T, M.BALL_T, M.BOX_T, M.DOOR_T))
                       .sum((1, 2)) > 1], 1)
    instr = {"seq_kind": np.zeros(n, np.int64), "a_and": np.zeros(n, bool),
             "b_and": np.zeros(n, bool), "kinds": np.full((n, 1), BA.K_GOTO),
             "d1": d1[:, None], "d2": d2[:, None], "strict": np.zeros((n, 1), bool)}
    # the mission: [seq, a_and, b_and, kinds(4), d1(4x3), d2(4x3), strict(4),
    # articles(8)], the one clause in slot 0
    mission = np.zeros((n, MISSION_LEN), np.int64)
    mission[:, 3] = BA.K_GOTO
    mission[:, 7:10] = d1
    mission[:, 35:37] = plural
    packed = BA.pack_planes(tracked)[:, None]
    return {
        "grid": grid,
        "pos": b["pos"], "dir": b["dir"],
        "carrying": np.full(n, M.EMPTY, np.int64),
        "step_count": np.zeros(n, np.int64),
        "max_steps": np.full(n, episode_limit(cfg), np.int64),
        "rng": state_keys,
        "mission": mission,
        "terminated": np.zeros(n, bool), "truncated": np.zeros(n, bool),
        "box": np.full((n, w, h), M.EMPTY, np.int64),
        "carrying_box": np.full(n, M.EMPTY, np.int64),
        "extra": {"instr": instr,
                  "vs": {"tracked1": packed, "stale1": packed.copy(),
                         "carry1": np.zeros((n, 1), bool)}},
    }


def generate(keys: np.ndarray, cfg: dict) -> dict:
    """A reset's levels: the first accepted of at most 8 draws, else the
    8th."""
    chain, _, state_keys = (M.split(keys, 3)[:, i] for i in range(3))
    left = np.arange(keys.shape[0])
    out = None
    for _ in range(MAX_DRAWS):
        s = M.split(chain)
        chain = s[:, 0]
        b, ok = draw(s[:, 1], cfg)
        if out is None:
            out = b
        else:
            out = {f: _put(out[f], left, v) for f, v in b.items()}
        left, chain = left[~ok], chain[~ok]
        if not left.size:
            break
    return _finish(out, state_keys, cfg)


def attempt(keys: np.ndarray, cfg: dict) -> tuple[dict, np.ndarray]:
    """A refill's levels: one draw each, and whether it is accepted."""
    s = M.split(keys, 3)
    b, ok = draw(s[:, 1], cfg)
    return _finish(b, s[:, 2], cfg), ok


def _put(a: np.ndarray, rows: np.ndarray, v: np.ndarray) -> np.ndarray:
    a = a.copy()
    a[rows] = v
    return a


def post_step(before: dict, after: dict, action, outcome, reward, terminated, cfg,
              reward_fn=M.goal_reward):
    """The verifier after the transition: success ends the episode with the
    goal reward of the step."""
    vs = before["extra"]["vs"]
    h = after["grid"].shape[2]
    tracked = BA.unpack_planes(vs["tracked1"][:, 0], h)
    checked = BA.unpack_planes(vs["stale1"][:, 0], h)
    success, tracked, checked, carry = BA.goto_step(
        before, after, action, outcome, tracked, checked, vs["carry1"][:, 0])
    reward = reward.copy()
    for i in np.nonzero(success)[0]:
        reward[i] = reward_fn(int(after["step_count"][i]), int(after["max_steps"][i]))
    new_vs = {**vs, "tracked1": BA.pack_planes(tracked)[:, None],
              "stale1": BA.pack_planes(checked)[:, None], "carry1": carry[:, None]}
    after = {**after, "extra": {**after["extra"], "vs": new_vs}}
    return after, reward, terminated | success


def modelled(level: dict) -> dict:
    """The fields the reference computes: the state, the instruction, and
    of the verifier's state the tracked and checked positions and the
    carried flag (the rest serves other instructions)."""
    vs = level["extra"]["vs"]
    return {**level, "extra": {"instr": level["extra"]["instr"],
                               "vs": {k: vs[k] for k in ("tracked1", "stale1", "carry1")}}}
