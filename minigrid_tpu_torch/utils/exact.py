"""Seed-exact generation: the reference's levels, seed for seed, on the host.

Counterpart of ``minigrid_tpu/utils/exact.py``.  The batch reset draws its
levels with the threefry twin (``core/rng.py``); their layout distributions
match the reference, but single seeds do not, because a numpy Generator's
stream cannot be replayed on a device.  :func:`reset_exact` regenerates a
level by replaying the reference's ``np_random`` call order in numpy (every
``_rand_int``, ``shuffle`` and ``choice`` in the same sequence, including
``place_obj``'s sample-per-try rejection loop, minigrid_env.py:338-363), so

    obs, state = reset_exact(env, seed)

gives the initial observation and world state the reference gives for
``ref_env.reset(seed=seed)``, with no reference import, as the JAX package's
``reset_exact`` does, bit for bit.  The result is the port's batch-first
``(obs, state)`` with a batch of one, on CUDA unless ``device`` names another
device; ``Env.step`` carries the episode from there.  Its two halves are
:func:`host_level` (the replay, numpy on the host) and
:func:`finalize_level` (the state and the observation on the device).

The generators are the JAX package's numpy code, unchanged: the stream
depends on the order of every draw, so the reference quirks that shape it
are kept too (the ``direction is h`` identity tests of Crossing; the
np.int64 identity comparisons of GoToImpUnlock and Unlock, goto.py:148-166,
unlock.py:25-48).  Only the seams differ: the payloads become tensors on the
target device, the state's key is ``rng.PRNGKey(seed)``, BabyAI's
instruction codes are the port's ``[1, ...]`` codes (one clause slot for a
single-clause family, four for a composite one), finalised by the same
``BabyAILevel._finalize`` as a batch reset.  The Generator is built from
numpy alone (``np.random.Generator(np.random.PCG64(SeedSequence(seed)))``,
what gymnasium's ``seeding.np_random`` builds), so gymnasium is not needed.

Supported: every registered id but the four fork dataset envs
(Contrastive*, Directions, Blocks), which draw from the global
``random``/``np.random`` modules and keep split iterators across resets, so
seed parity is undefined for them; they raise ``NotImplementedError``.  The
Negated envs' mission surface coin comes from the unseeded global
``random`` module in the reference; the replay draws it last from the
seeded stream, as the JAX package does.  This is a host tool for parity and
evaluation, not a hot path.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.babyai import verifier as V
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.grid_ops import pack_np
from minigrid_tpu_torch.core.state import base_state, map_tree, resolve_device

# instruction codes are built on the host and moved with the level
_HOST = torch.device("cpu")

_EMPTY = np.asarray(C.EMPTY_TRIPLE, np.uint8)
_WALL = np.asarray(
    [C.OBJECT_TO_IDX["wall"], C.COLOR_TO_IDX["grey"], 0], np.uint8
)
_GOAL = np.asarray(
    [C.OBJECT_TO_IDX["goal"], C.COLOR_TO_IDX["green"], 0], np.uint8
)
_LAVA = np.asarray(
    [C.OBJECT_TO_IDX["lava"], C.COLOR_TO_IDX["red"], 0], np.uint8
)


def _np_random(seed: int) -> np.random.Generator:
    """The Generator the reference's gym.Env.reset(seed) builds
    (gymnasium's ``seeding.np_random``), from numpy alone."""
    if not isinstance(seed, int) or seed < 0:
        raise ValueError(f"seed must be a non-negative Python int, got {seed!r}")
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


class _HostGrid:
    """Numpy mirror of the reference's mutable generation state: the encode
    tensor plus agent pose, with the placement API consuming the same RNG
    stream (minigrid_env.py:246-394)."""

    def __init__(self, rng, width: int, height: int):
        self.rng = rng
        self.w, self.h = width, height
        self.grid = np.broadcast_to(_EMPTY, (width, height, 3)).copy()
        self.agent_pos = (-1, -1)
        self.agent_dir = -1

    # -- RNG helpers (minigrid_env.py:252-258) -----------------------------
    def rand_int(self, lo: int, hi: int) -> int:
        return int(self.rng.integers(lo, hi))

    # -- wall builders (grid.py:80-108) ------------------------------------
    def horz_wall(self, x, y, length=None, triple=_WALL):
        length = self.w - x if length is None else length
        self.grid[x:x + length, y] = triple

    def vert_wall(self, x, y, length=None, triple=_WALL):
        length = self.h - y if length is None else length
        self.grid[x, y:y + length] = triple

    def wall_rect(self, x, y, w, h):
        self.horz_wall(x, y, w)
        self.horz_wall(x, y + h - 1, w)
        self.vert_wall(x, y, h)
        self.vert_wall(x + w - 1, y, h)

    def put(self, x, y, triple):
        self.grid[x, y] = triple

    def is_empty(self, x, y) -> bool:
        return (self.grid[x, y] == _EMPTY).all()

    # -- placement (minigrid_env.py:312-394) --------------------------------
    def place_obj(self, triple, top=None, size=None, reject_fn=None) -> tuple:
        """The reference rejection loop: samples TWO ints per try whether or
        not the try is accepted — the stream-order detail seed parity
        hinges on (minigrid_env.py:338-363)."""
        top = (0, 0) if top is None else (max(top[0], 0), max(top[1], 0))
        size = (self.w, self.h) if size is None else size
        while True:
            pos = (
                self.rand_int(top[0], min(top[0] + size[0], self.w)),
                self.rand_int(top[1], min(top[1] + size[1], self.h)),
            )
            if not self.is_empty(*pos):
                continue
            if pos == tuple(self.agent_pos):
                continue
            if reject_fn and reject_fn(pos):
                continue
            break
        if triple is not None:
            self.put(pos[0], pos[1], triple)
        return pos

    def place_agent(self, top=None, size=None, rand_dir=True) -> tuple:
        self.agent_pos = (-1, -1)
        pos = self.place_obj(None, top, size)
        self.agent_pos = pos
        if rand_dir:
            self.agent_dir = self.rand_int(0, 4)
        return pos


# ---------------------------------------------------------------------------
# Per-family generators, each replaying the reference _gen_grid call order.
# ---------------------------------------------------------------------------


def _gen_empty(env, g: _HostGrid) -> None:
    """envs/empty.py:96-114."""
    g.wall_rect(0, 0, g.w, g.h)
    g.put(g.w - 2, g.h - 2, _GOAL)
    if env.agent_start_pos is not None:
        g.agent_pos = tuple(env.agent_start_pos)
        g.agent_dir = int(env.agent_start_dir)
    else:
        g.place_agent()


def _gen_doorkey(env, g: _HostGrid) -> None:
    """envs/doorkey.py:76-99."""
    g.wall_rect(0, 0, g.w, g.h)
    g.put(g.w - 2, g.h - 2, _GOAL)
    split = g.rand_int(2, g.w - 2)
    g.vert_wall(split, 0)
    g.place_agent(size=(split, g.h))
    door_idx = g.rand_int(1, g.w - 2)
    door = np.asarray(
        [C.OBJECT_TO_IDX["door"], C.COLOR_TO_IDX["yellow"],
         C.STATE_TO_IDX["locked"]], np.uint8)
    g.put(split, door_idx, door)
    key = np.asarray(
        [C.OBJECT_TO_IDX["key"], C.COLOR_TO_IDX["yellow"], 0], np.uint8)
    g.place_obj(key, top=(0, 0), size=(split, g.h))


def _gen_lavagap(env, g: _HostGrid) -> None:
    """envs/lavagap.py:101-130."""
    g.wall_rect(0, 0, g.w, g.h)
    g.agent_pos, g.agent_dir = (1, 1), 0
    g.put(g.w - 2, g.h - 2, _GOAL)
    gap = (g.rand_int(2, g.w - 2), g.rand_int(1, g.h - 1))
    obstacle = _LAVA if getattr(env, "obstacle_type", "lava") == "lava" else _WALL
    g.vert_wall(gap[0], 1, g.h - 2, obstacle)
    g.put(gap[0], gap[1], _EMPTY)


def _gen_fourrooms(env, g: _HostGrid) -> None:
    """envs/fourrooms.py:79-128."""
    g.horz_wall(0, 0)
    g.horz_wall(0, g.h - 1)
    g.vert_wall(0, 0)
    g.vert_wall(g.w - 1, 0)
    room_w, room_h = g.w // 2, g.h // 2
    for j in range(2):
        for i in range(2):
            x_l, y_t = i * room_w, j * room_h
            x_r, y_b = x_l + room_w, y_t + room_h
            if i + 1 < 2:
                g.vert_wall(x_r, y_t, room_h)
                g.put(x_r, g.rand_int(y_t + 1, y_b), _EMPTY)
            if j + 1 < 2:
                g.horz_wall(x_l, y_b, room_w)
                g.put(g.rand_int(x_l + 1, x_r), y_b, _EMPTY)
    agent_default = getattr(env, "_agent_default_pos", None)
    goal_default = getattr(env, "_goal_default_pos", None)
    if agent_default is not None:
        g.agent_pos = tuple(agent_default)
        g.put(agent_default[0], agent_default[1], _EMPTY)
        g.agent_dir = g.rand_int(0, 4)
    else:
        g.place_agent()
    if goal_default is not None:
        g.put(goal_default[0], goal_default[1], _GOAL)
    else:
        g.place_obj(_GOAL)


def _gen_crossing(env, g: _HostGrid) -> None:
    """envs/crossing.py:127-177 — shuffle/choice call order preserved."""
    g.wall_rect(0, 0, g.w, g.h)
    g.agent_pos, g.agent_dir = (1, 1), 0
    g.put(g.w - 2, g.h - 2, _GOAL)

    obstacle = _LAVA if getattr(env, "obstacle_type", "lava") == "lava" else _WALL
    v, h = object(), object()
    rivers = [(v, i) for i in range(2, g.h - 2, 2)]
    rivers += [(h, j) for j in range(2, g.w - 2, 2)]
    g.rng.shuffle(rivers)
    rivers = rivers[: env.num_crossings]
    rivers_v = sorted(pos for direction, pos in rivers if direction is v)
    rivers_h = sorted(pos for direction, pos in rivers if direction is h)
    import itertools as itt

    obstacle_pos = itt.chain(
        itt.product(range(1, g.w - 1), rivers_h),
        itt.product(rivers_v, range(1, g.h - 1)),
    )
    for i, j in obstacle_pos:
        g.put(i, j, obstacle)

    path = [h] * len(rivers_v) + [v] * len(rivers_h)
    g.rng.shuffle(path)
    limits_v = [0] + rivers_v + [g.h - 1]
    limits_h = [0] + rivers_h + [g.w - 1]
    room_i = room_j = 0
    for direction in path:
        if direction is h:
            i = limits_v[room_i + 1]
            j = int(g.rng.choice(range(limits_h[room_j] + 1,
                                       limits_h[room_j + 1])))
            room_i += 1
        else:
            i = int(g.rng.choice(range(limits_v[room_i] + 1,
                                       limits_v[room_i + 1])))
            j = limits_h[room_j + 1]
            room_j += 1
        g.put(i, j, _EMPTY)


def _gen_distshift(env, g: _HostGrid) -> None:
    """envs/distshift.py:96-121."""
    g.wall_rect(0, 0, g.w, g.h)
    g.put(g.w - 2, 1, _GOAL)
    for i in range(g.w - 6):
        g.put(3 + i, 1, _LAVA)
        g.put(3 + i, env.strip2_row, _LAVA)
    if env.agent_start_pos is not None:
        g.agent_pos = tuple(env.agent_start_pos)
        g.agent_dir = int(env.agent_start_dir)
    else:
        g.place_agent()


_SORTED_COLORS = sorted(C.COLOR_TO_IDX)  # == reference COLOR_NAMES


def _rand_elem(g: _HostGrid, lst):
    """MiniGridEnv._rand_elem (minigrid_env.py:267-274)."""
    return lst[g.rand_int(0, len(lst))]


def _door(color_id: int, state: str = "closed") -> np.ndarray:
    return np.asarray([C.OBJECT_TO_IDX["door"], color_id,
                       C.STATE_TO_IDX[state]], np.uint8)


def _obj(type_name: str, color_id: int) -> np.ndarray:
    return np.asarray([C.OBJECT_TO_IDX[type_name], color_id, 0], np.uint8)


def _gen_gotodoor(env, g: _HostGrid) -> dict:
    """envs/gotodoor.py:92-126 — incl. the distinct-color rejection loop."""
    w = g.rand_int(5, g.w + 1)
    h = g.rand_int(5, g.h + 1)
    g.wall_rect(0, 0, w, h)
    door_pos = [(g.rand_int(2, w - 2), 0), (g.rand_int(2, w - 2), h - 1),
                (0, g.rand_int(2, h - 2)), (w - 1, g.rand_int(2, h - 2))]
    door_colors: list[str] = []
    while len(door_colors) < 4:
        color = _rand_elem(g, _SORTED_COLORS)
        if color in door_colors:
            continue
        door_colors.append(color)
    for pos, cname in zip(door_pos, door_colors):
        g.put(pos[0], pos[1], _door(C.COLOR_TO_IDX[cname]))
    g.place_agent(size=(w, h))
    tgt = g.rand_int(0, 4)
    return {
        "mission": np.asarray(
            [C.COLOR_TO_IDX[door_colors[tgt]], 0, 0, 0], np.int32),
        "extra": np.asarray(door_pos[tgt], np.int32),
    }


def _gen_fetch(env, g: _HostGrid) -> dict:
    """envs/fetch.py:108-159 — type-then-color draw per object, duplicates
    allowed; 5-way mission syntax draw after the target choice."""
    g.horz_wall(0, 0)
    g.horz_wall(0, g.h - 1)
    g.vert_wall(0, 0)
    g.vert_wall(g.w - 1, 0)
    objs = []
    for _ in range(env.numObjs):
        t = _rand_elem(g, ["key", "ball"])
        cname = _rand_elem(g, _SORTED_COLORS)
        g.place_obj(_obj(t, C.COLOR_TO_IDX[cname]))
        objs.append((t, cname))
    g.place_agent()
    t, cname = objs[g.rand_int(0, len(objs))]
    syntax = g.rand_int(0, 5)
    tgt = np.asarray([C.OBJECT_TO_IDX[t], C.COLOR_TO_IDX[cname]], np.int32)
    return {
        "mission": np.asarray([syntax, tgt[1], tgt[0], 0], np.int32),
        "extra": tgt,
    }


def _gen_gotoobject(env, g: _HostGrid) -> dict:
    """envs/gotoobject.py:43-91 — distinct (type, color) rejection loop."""
    g.wall_rect(0, 0, g.w, g.h)
    objs, obj_pos = [], []
    while len(objs) < env.numObjs:
        t = _rand_elem(g, ["key", "ball", "box"])
        cname = _rand_elem(g, _SORTED_COLORS)
        if (t, cname) in objs:
            continue
        pos = g.place_obj(_obj(t, C.COLOR_TO_IDX[cname]))
        objs.append((t, cname))
        obj_pos.append(pos)
    g.place_agent()
    i = g.rand_int(0, len(objs))
    t, cname = objs[i]
    return {
        "mission": np.asarray(
            [C.COLOR_TO_IDX[cname], C.OBJECT_TO_IDX[t], 0, 0], np.int32),
        "extra": np.asarray(obj_pos[i], np.int32),
    }


def _gen_putnear(env, g: _HostGrid) -> dict:
    """envs/putnear.py:95-173 — near_obj reject_fn + retry target draw."""
    g.horz_wall(0, 0)
    g.horz_wall(0, g.h - 1)
    g.vert_wall(0, 0)
    g.vert_wall(g.w - 1, 0)
    objs, obj_pos = [], []

    def near_obj(p1):
        return any(abs(p1[0] - p2[0]) <= 1 and abs(p1[1] - p2[1]) <= 1
                   for p2 in obj_pos)

    while len(objs) < env.numObjs:
        t = _rand_elem(g, ["key", "ball", "box"])
        cname = _rand_elem(g, _SORTED_COLORS)
        if (t, cname) in objs:
            continue
        pos = g.place_obj(_obj(t, C.COLOR_TO_IDX[cname]), reject_fn=near_obj)
        objs.append((t, cname))
        obj_pos.append(pos)
    g.place_agent()
    mv = g.rand_int(0, len(objs))
    while True:
        tg = g.rand_int(0, len(objs))
        if tg != mv:
            break
    mt, mc = objs[mv]
    tt, tc = objs[tg]
    return {
        "mission": np.asarray(
            [C.COLOR_TO_IDX[mc], C.OBJECT_TO_IDX[mt],
             C.COLOR_TO_IDX[tc], C.OBJECT_TO_IDX[tt]], np.int32),
        "extra": {
            "move": np.asarray(
                [C.OBJECT_TO_IDX[mt], C.COLOR_TO_IDX[mc]], np.int32),
            "target_pos": np.asarray(obj_pos[tg], np.int32),
        },
    }


def _gen_dynamicobstacles(env, g: _HostGrid) -> dict:
    """envs/dynamicobstacles.py:100-133."""
    g.wall_rect(0, 0, g.w, g.h)
    g.put(g.w - 2, g.h - 2, _GOAL)
    if env.agent_start_pos is not None:
        g.agent_pos = tuple(env.agent_start_pos)
        g.agent_dir = int(env.agent_start_dir)
    else:
        g.place_agent()
    positions = [g.place_obj(_obj("ball", C.COLOR_TO_IDX["blue"]))
                 for _ in range(env.n_obstacles)]
    return {"extra": np.asarray(positions, np.int32).reshape(-1, 2)}


def _gen_redbluedoor(env, g: _HostGrid) -> dict:
    """envs/redbluedoors.py:79-100."""
    s = env.size
    g.wall_rect(0, 0, 2 * s, s)
    g.wall_rect(s // 2, 0, s, s)
    g.place_agent(top=(s // 2, 0), size=(s, s))
    red_pos = (s // 2, g.rand_int(1, s - 1))
    g.put(red_pos[0], red_pos[1], _door(C.COLOR_TO_IDX["red"]))
    blue_pos = (s // 2 + s - 1, g.rand_int(1, s - 1))
    g.put(blue_pos[0], blue_pos[1], _door(C.COLOR_TO_IDX["blue"]))
    return {"extra": {"red_pos": np.asarray(red_pos, np.int32),
                      "blue_pos": np.asarray(blue_pos, np.int32)}}


def _gen_memory(env, g: _HostGrid) -> dict:
    """envs/memory.py:95-151."""
    g.horz_wall(0, 0)
    g.horz_wall(0, g.h - 1)
    g.vert_wall(0, 0)
    g.vert_wall(g.w - 1, 0)
    mid = g.h // 2
    upper, lower = mid - 2, mid + 2
    hallway_end = g.rand_int(4, g.w - 2) if env.random_length else g.w - 3
    for i in range(1, 5):
        g.put(i, upper, _WALL)
        g.put(i, lower, _WALL)
    g.put(4, upper + 1, _WALL)
    g.put(4, lower - 1, _WALL)
    for i in range(5, hallway_end):
        g.put(i, upper + 1, _WALL)
        g.put(i, lower - 1, _WALL)
    for j in range(g.h):
        if j != mid:
            g.put(hallway_end, j, _WALL)
        g.put(hallway_end + 2, j, _WALL)
    g.agent_pos = (g.rand_int(1, hallway_end + 1), mid)
    g.agent_dir = 0
    green = C.COLOR_TO_IDX["green"]
    start = _rand_elem(g, ["key", "ball"])
    g.put(1, mid - 1, _obj(start, green))
    top, bot = _rand_elem(g, [("ball", "key"), ("key", "ball")])
    g.put(hallway_end + 1, mid - 2, _obj(top, green))
    g.put(hallway_end + 1, mid + 2, _obj(bot, green))
    if start == top:
        success, failure = (hallway_end + 1, mid - 1), (hallway_end + 1, mid + 1)
    else:
        success, failure = (hallway_end + 1, mid + 1), (hallway_end + 1, mid - 1)
    return {"extra": {"success_pos": np.asarray(success, np.int32),
                      "failure_pos": np.asarray(failure, np.int32)}}


class _HostRoomGrid:
    """Numpy mirror of the reference RoomGrid builder
    (core/roomgrid.py:89-438): the room lattice with per-wall door
    positions drawn in _gen_grid order, placement with reject_next_to,
    door/object adders, and the connect_all rejection loop — all consuming
    the same np_random stream as the reference."""

    def __init__(self, g: _HostGrid, room_size: int, rows: int, cols: int):
        self.g = g
        self.room_size, self.rows, self.cols = room_size, rows, cols
        s = room_size
        # room bookkeeping: top, door_pos[4], doors[4], neighbors[4], locked
        self.top = {}
        self.door_pos = {}
        self.doors = {}
        self.neighbors = {}
        self.locked = {}
        self.objs: list[tuple[str, str]] = []
        for j in range(rows):
            for i in range(cols):
                self.top[i, j] = (i * (s - 1), j * (s - 1))
                g.wall_rect(i * (s - 1), j * (s - 1), s, s)
                self.door_pos[i, j] = [None] * 4
                self.doors[i, j] = [None] * 4
                self.neighbors[i, j] = [None] * 4
                self.locked[i, j] = False
        for j in range(rows):
            for i in range(cols):
                tx, ty = self.top[i, j]
                x_l, y_l = tx + 1, ty + 1
                x_m, y_m = tx + s - 1, ty + s - 1
                if i < cols - 1:
                    self.neighbors[i, j][0] = (i + 1, j)
                    self.door_pos[i, j][0] = (x_m, g.rand_int(y_l, y_m))
                if j < rows - 1:
                    self.neighbors[i, j][1] = (i, j + 1)
                    self.door_pos[i, j][1] = (g.rand_int(x_l, x_m), y_m)
                if i > 0:
                    self.neighbors[i, j][2] = (i - 1, j)
                    self.door_pos[i, j][2] = self.door_pos[i - 1, j][0]
                if j > 0:
                    self.neighbors[i, j][3] = (i, j - 1)
                    self.door_pos[i, j][3] = self.door_pos[i, j - 1][1]
        g.agent_pos = ((cols // 2) * (s - 1) + s // 2,
                       (rows // 2) * (s - 1) + s // 2)
        g.agent_dir = 0

    # -- placement (roomgrid.py:181-228) -----------------------------------
    def place_in_room(self, i, j, triple):
        g = self.g
        tx, ty = self.top[i, j]

        def reject_next_to(pos):
            sx, sy = g.agent_pos
            return abs(sx - pos[0]) + abs(sy - pos[1]) < 2

        return g.place_obj(triple, top=(tx, ty),
                           size=(self.room_size, self.room_size),
                           reject_fn=reject_next_to)

    def add_object(self, i, j, kind=None, color=None):
        g = self.g
        if kind is None:
            kind = _rand_elem(g, ["key", "ball", "box"])
        if color is None:
            color = _rand_elem(g, _SORTED_COLORS)
        pos = self.place_in_room(i, j, _obj(kind, C.COLOR_TO_IDX[color]))
        self.objs.append((kind, color))
        return (kind, color), pos

    def add_door(self, i, j, door_idx=None, color=None, locked=None):
        g = self.g
        if door_idx is None:
            while True:
                door_idx = g.rand_int(0, 4)
                if (self.neighbors[i, j][door_idx]
                        and self.doors[i, j][door_idx] is None):
                    break
        if color is None:
            color = _rand_elem(g, _SORTED_COLORS)
        if locked is None:
            locked = g.rand_int(0, 2) == 0  # _rand_bool
        self.locked[i, j] = locked
        pos = self.door_pos[i, j][door_idx]
        g.put(pos[0], pos[1],
              _door(C.COLOR_TO_IDX[color], "locked" if locked else "closed"))
        self.doors[i, j][door_idx] = color
        ni, nj = self.neighbors[i, j][door_idx]
        self.doors[ni, nj][(door_idx + 2) % 4] = color
        return color, pos

    def remove_wall(self, i, j, wall_idx):
        tx, ty = self.top[i, j]
        s = self.room_size
        if wall_idx == 0:
            for k in range(1, s - 1):
                self.g.put(tx + s - 1, ty + k, _EMPTY)
        elif wall_idx == 1:
            for k in range(1, s - 1):
                self.g.put(tx + k, ty + s - 1, _EMPTY)
        elif wall_idx == 2:
            for k in range(1, s - 1):
                self.g.put(tx, ty + k, _EMPTY)
        else:
            for k in range(1, s - 1):
                self.g.put(tx + k, ty, _EMPTY)
        self.doors[i, j][wall_idx] = True
        ni, nj = self.neighbors[i, j][wall_idx]
        self.doors[ni, nj][(wall_idx + 2) % 4] = True

    def place_agent(self, i=None, j=None, rand_dir=True):
        g = self.g
        if i is None:
            i = g.rand_int(0, self.cols)
        if j is None:
            j = g.rand_int(0, self.rows)
        tx, ty = self.top[i, j]
        while True:
            g.place_agent(top=(tx, ty),
                          size=(self.room_size, self.room_size),
                          rand_dir=rand_dir)
            dx, dy = [(1, 0), (0, 1), (-1, 0), (0, -1)][g.agent_dir]
            fx, fy = g.agent_pos[0] + dx, g.agent_pos[1] + dy
            front = g.grid[fx, fy]
            if (front == _EMPTY).all() or front[0] == _WALL[0]:
                break
        return g.agent_pos

    def room_from_pos(self, x, y):
        s = self.room_size
        return (x // (s - 1), y // (s - 1))

    def connect_all(self, door_colors=None):
        """roomgrid.py:336-394 — the literal rejection loop."""
        g = self.g
        door_colors = _SORTED_COLORS if door_colors is None else door_colors
        start = self.room_from_pos(*g.agent_pos)
        start = (min(start[0], self.cols - 1), min(start[1], self.rows - 1))
        while True:
            reach, stack = set(), [start]
            while stack:
                room = stack.pop()
                if room in reach:
                    continue
                reach.add(room)
                for k in range(4):
                    if self.doors[room][k]:
                        stack.append(self.neighbors[room][k])
            if len(reach) == self.rows * self.cols:
                break
            i = g.rand_int(0, self.cols)
            j = g.rand_int(0, self.rows)
            k = g.rand_int(0, 4)
            if not self.door_pos[i, j][k] or self.doors[i, j][k]:
                continue
            if self.locked[i, j] or self.locked[self.neighbors[i, j][k]]:
                continue
            color = _rand_elem(g, door_colors)
            self.add_door(i, j, k, color, False)

    def add_distractors(self, i=None, j=None, num_distractors=10,
                        all_unique=True):
        """roomgrid.py:396-438 — color-then-type draw order."""
        g = self.g
        dists = []
        while len(dists) < num_distractors:
            color = _rand_elem(g, _SORTED_COLORS)
            kind = _rand_elem(g, ["key", "ball", "box"])
            if all_unique and (kind, color) in self.objs:
                continue
            ri = g.rand_int(0, self.cols) if i is None else i
            rj = g.rand_int(0, self.rows) if j is None else j
            _, pos = self.add_object(ri, rj, kind, color)
            dists.append(((kind, color), pos))
        return dists


def _gen_keycorridor(env, g: _HostGrid) -> dict:
    """envs/keycorridor.py:99-127."""
    rg = _HostRoomGrid(g, env.room_size, env.num_rows, 3)
    for j in range(1, env.num_rows):
        rg.remove_wall(1, j, 3)
    room_idx = g.rand_int(0, env.num_rows)
    door_color, _ = rg.add_door(2, room_idx, 2, locked=True)
    (kind, color), _ = rg.add_object(2, room_idx, kind=env.obj_type)
    rg.add_object(0, g.rand_int(0, env.num_rows), "key", door_color)
    rg.place_agent(1, env.num_rows // 2)
    rg.connect_all()
    tgt = np.asarray([C.OBJECT_TO_IDX[kind], C.COLOR_TO_IDX[color]], np.int32)
    return {"mission": np.asarray([tgt[1], tgt[0], 0, 0], np.int32),
            "extra": tgt}


def _gen_unlock(env, g: _HostGrid) -> dict:
    """envs/unlock.py:75-87."""
    rg = _HostRoomGrid(g, env.room_size, 1, 2)
    door_color, pos = rg.add_door(0, 0, 0, locked=True)
    rg.add_object(0, 0, "key", door_color)
    rg.place_agent(0, 0)
    return {"extra": np.asarray(pos, np.int32)}


def _gen_unlockpickup(env, g: _HostGrid) -> dict:
    """envs/unlockpickup.py:77-93."""
    rg = _HostRoomGrid(g, env.room_size, 1, 2)
    (kind, color), _ = rg.add_object(1, 0, kind="box")
    door_color, _ = rg.add_door(0, 0, 0, locked=True)
    rg.add_object(0, 0, "key", door_color)
    rg.place_agent(0, 0)
    tgt = np.asarray([C.OBJECT_TO_IDX[kind], C.COLOR_TO_IDX[color]], np.int32)
    return {"mission": np.asarray([tgt[1], tgt[0], 0, 0], np.int32),
            "extra": tgt}


def _gen_blockedunlockpickup(env, g: _HostGrid) -> dict:
    """envs/blockedunlockpickup.py:84-101."""
    rg = _HostRoomGrid(g, env.room_size, 1, 2)
    (kind, color), _ = rg.add_object(1, 0, kind="box")
    door_color, pos = rg.add_door(0, 0, 0, locked=True)
    ball_color = _rand_elem(g, _SORTED_COLORS)  # _rand_color
    g.put(pos[0] - 1, pos[1], _obj("ball", C.COLOR_TO_IDX[ball_color]))
    rg.add_object(0, 0, "key", door_color)
    rg.place_agent(0, 0)
    tgt = np.asarray([C.OBJECT_TO_IDX[kind], C.COLOR_TO_IDX[color]], np.int32)
    return {"mission": np.asarray([tgt[1], tgt[0], 0, 0], np.int32),
            "extra": tgt}


def _gen_lockedroom(env, g: _HostGrid) -> dict:
    """envs/lockedroom.py:94-165 — draw-and-remove color order, retry key
    room, rand_pos without emptiness checks."""
    w, h = g.w, g.h
    g.wall_rect(0, 0, w, h)
    lw, rw = w // 2 - 2, w // 2 + 2
    g.vert_wall(lw, 0)
    g.vert_wall(rw, 0)
    rooms = []
    for n in range(3):
        j = n * (h // 3)
        g.horz_wall(0, j, lw)
        g.horz_wall(rw, j, w - rw)
        room_w, room_h = lw + 1, h // 3 + 1
        rooms.append(((0, j), (room_w, room_h), (lw, j + 3)))
        rooms.append(((rw, j), (room_w, room_h), (rw, j + 3)))

    def rand_pos(room):
        (tx, ty), (sx, sy), _ = room
        return (g.rand_int(tx + 1, tx + sx - 1),
                g.rand_int(ty + 1, ty + sy - 1))

    locked = g.rand_int(0, 6)  # _rand_elem(rooms)
    gx, gy = rand_pos(rooms[locked])
    g.put(gx, gy, _GOAL)

    colors = set(_SORTED_COLORS)
    room_colors = []
    for r in range(6):
        cname = _rand_elem(g, sorted(colors))
        colors.remove(cname)
        room_colors.append(cname)
        state = "locked" if r == locked else "closed"
        dx, dy = rooms[r][2]
        g.put(dx, dy, _door(C.COLOR_TO_IDX[cname], state))

    while True:
        kr = g.rand_int(0, 6)
        if kr != locked:
            break
    kx, ky = rand_pos(rooms[kr])
    g.put(kx, ky, _obj("key", C.COLOR_TO_IDX[room_colors[locked]]))
    g.place_agent(top=(lw, 0), size=(rw - lw, h))
    return {"mission": np.asarray(
        [C.COLOR_TO_IDX[room_colors[locked]], C.COLOR_TO_IDX[room_colors[kr]],
         0, 0], np.int32)}


def _gen_multiroom(env, g: _HostGrid) -> None:
    """envs/multiroom.py:101-281 — the recursive chain placement replayed
    literally: per-attempt entry position, per-depth size/offset draws, the
    8-try exit-wall loop, best-of restart, and the reference's
    rand_int(0, width-2) for BOTH entry coordinates (:112)."""
    w, h = g.w, g.h

    def place_room(num_left, room_list, min_sz, max_sz, entry_wall, entry_pos):
        size_x = g.rand_int(min_sz, max_sz + 1)
        size_y = g.rand_int(min_sz, max_sz + 1)
        if not room_list:
            top_x, top_y = entry_pos
        elif entry_wall == 0:
            top_x = entry_pos[0] - size_x + 1
            top_y = g.rand_int(entry_pos[1] - size_y + 2, entry_pos[1])
        elif entry_wall == 1:
            top_x = g.rand_int(entry_pos[0] - size_x + 2, entry_pos[0])
            top_y = entry_pos[1] - size_y + 1
        elif entry_wall == 2:
            top_x = entry_pos[0]
            top_y = g.rand_int(entry_pos[1] - size_y + 2, entry_pos[1])
        else:
            top_x = g.rand_int(entry_pos[0] - size_x + 2, entry_pos[0])
            top_y = entry_pos[1]
        if top_x < 0 or top_y < 0:
            return False
        if top_x + size_x > w or top_y + size_y >= h:
            return False
        for (rx, ry), (rsx, rsy), _ in room_list[:-1]:
            non_overlap = (top_x + size_x < rx or rx + rsx <= top_x
                           or top_y + size_y < ry or ry + rsy <= top_y)
            if not non_overlap:
                return False
        room_list.append(((top_x, top_y), (size_x, size_y), entry_pos))
        if num_left == 1:
            return True
        for _ in range(8):
            wall_set = sorted({0, 1, 2, 3} - {entry_wall})
            exit_wall = _rand_elem(g, wall_set)
            if exit_wall == 0:
                exit_pos = (top_x + size_x - 1,
                            top_y + g.rand_int(1, size_y - 1))
            elif exit_wall == 1:
                exit_pos = (top_x + g.rand_int(1, size_x - 1),
                            top_y + size_y - 1)
            elif exit_wall == 2:
                exit_pos = (top_x, top_y + g.rand_int(1, size_y - 1))
            else:
                exit_pos = (top_x + g.rand_int(1, size_x - 1), top_y)
            if place_room(num_left - 1, room_list, min_sz, max_sz,
                          (exit_wall + 2) % 4, exit_pos):
                break
        return True

    num_rooms = g.rand_int(env.minNumRooms, env.maxNumRooms + 1)
    room_list: list = []
    while len(room_list) < num_rooms:
        cur: list = []
        entry_pos = (g.rand_int(0, w - 2), g.rand_int(0, w - 2))
        place_room(num_rooms, cur, 4, env.maxRoomSize, 2, entry_pos)
        if len(cur) > len(room_list):
            room_list = cur

    prev_color = None
    for idx, ((tx, ty), (sx, sy), entry_pos) in enumerate(room_list):
        for i in range(sx):
            g.put(tx + i, ty, _WALL)
            g.put(tx + i, ty + sy - 1, _WALL)
        for j in range(sy):
            g.put(tx, ty + j, _WALL)
            g.put(tx + sx - 1, ty + j, _WALL)
        if idx > 0:
            door_colors = set(_SORTED_COLORS)
            if prev_color:
                door_colors.remove(prev_color)
            cname = _rand_elem(g, sorted(door_colors))
            g.put(entry_pos[0], entry_pos[1], _door(C.COLOR_TO_IDX[cname]))
            prev_color = cname

    g.place_agent(room_list[0][0], room_list[0][1])
    g.place_obj(_GOAL, room_list[-1][0], room_list[-1][1])


def _obst_add_door(g: _HostGrid, rg: _HostRoomGrid, contains, i, j,
                   door_idx, color, locked, key_in_box, blocked):
    """ObstructedMazeEnv.add_door (obstructedmaze.py:131-160): base door,
    blocking ball one cell in front, key (optionally boxed) in the room."""
    door_color, pos = rg.add_door(i, j, door_idx, color, locked)
    if blocked:
        vec = [(1, 0), (0, 1), (-1, 0), (0, -1)][door_idx]
        g.put(pos[0] - vec[0], pos[1] - vec[1],
              _obj("ball", C.COLOR_TO_IDX["brown"]))  # COLOR_NAMES[1]
    if locked:
        if key_in_box:
            p = rg.place_in_room(
                i, j, _obj("box", C.COLOR_TO_IDX["cyan"]))  # COLOR_NAMES[2]
            contains[p[0], p[1]] = _obj("key", C.COLOR_TO_IDX[door_color])
        else:
            rg.place_in_room(i, j, _obj("key", C.COLOR_TO_IDX[door_color]))
    return door_color, pos


def _obst_payload(contains) -> dict:
    blue, ball = C.COLOR_TO_IDX["blue"], C.OBJECT_TO_IDX["ball"]
    return {
        "mission": np.asarray([blue, ball, 0, 0], np.int32),
        "extra": np.asarray([ball, blue], np.int32),
        "box_contains": contains,
    }


def _gen_obstructed_1dlhb(env, g: _HostGrid) -> dict:
    """obstructedmaze.py:163-189 (1Dl / 1Dlh / 1Dlhb by flags)."""
    rg = _HostRoomGrid(g, env.room_size, 1, 2)
    door_colors = _rand_subset(g, _SORTED_COLORS, len(_SORTED_COLORS))
    contains = np.broadcast_to(_EMPTY, (g.w, g.h, 3)).copy()
    _obst_add_door(g, rg, contains, 0, 0, 0, door_colors[0], True,
                   env.key_in_box, env.blocked)
    rg.add_object(1, 0, "ball", "blue")
    rg.place_agent(0, 0)
    return _obst_payload(contains)


def _gen_obstructed_full(env, g: _HostGrid) -> dict:
    """obstructedmaze.py:192-264 (Full / 2Dl* / 1Q / 2Q by presets)."""
    rg = _HostRoomGrid(g, env.room_size, 3, 3)
    door_colors = _rand_subset(g, _SORTED_COLORS, len(_SORTED_COLORS))
    contains = np.broadcast_to(_EMPTY, (g.w, g.h, 3)).copy()
    side_rooms = [(2, 1), (1, 2), (0, 1), (1, 0)][: env.num_quarters]
    for i, side in enumerate(side_rooms):
        rg.add_door(1, 1, i, door_colors[i], False)
        for k in (-1, 1):
            _obst_add_door(g, rg, contains, side[0], side[1], (i + k) % 4,
                           door_colors[(i + k) % len(door_colors)], True,
                           env.key_in_box, env.blocked)
    corners = [(2, 0), (2, 2), (0, 2), (0, 0)][: env.num_quarters]
    ball_room = _rand_elem(g, corners)
    rg.add_object(ball_room[0], ball_room[1], "ball", "blue")
    rg.place_agent(*env.agent_room)
    return _obst_payload(contains)


def _gen_playground(env, g: _HostGrid) -> None:
    """envs/playground.py:30-90: custom 3x3 lattice (NOT RoomGrid), one
    colored closed door per internal wall segment, 12 random objects."""
    g.wall_rect(0, 0, g.w, g.h)
    room_w, room_h = g.w // 3, g.h // 3
    for j in range(3):
        for i in range(3):
            xl, yt = i * room_w, j * room_h
            xr, yb = xl + room_w, yt + room_h
            if i + 1 < 3:
                g.vert_wall(xr, yt, room_h)
                y = g.rand_int(yt + 1, yb - 1)
                color = _rand_elem(g, _SORTED_COLORS)
                g.put(xr, y, _door(C.COLOR_TO_IDX[color]))
            if j + 1 < 3:
                g.horz_wall(xl, yb, room_w)
                x = g.rand_int(xl + 1, xr - 1)
                color = _rand_elem(g, _SORTED_COLORS)
                g.put(x, yb, _door(C.COLOR_TO_IDX[color]))
    g.place_agent()
    for _ in range(12):
        t = _rand_elem(g, ["key", "ball", "box"])
        color = _rand_elem(g, _SORTED_COLORS)
        g.place_obj(_obj(t, C.COLOR_TO_IDX[color]))


def _gen_negated(env, g: _HostGrid) -> dict:
    """Fork negated_goals.py:148-215: walls, agent, target from the
    direct/negated split, distractor with different type AND color
    (color-then-type draw order), template index.

    The mission's color-vs-type surface coin is drawn by the reference
    from the UNSEEDED global ``random`` module (negated_goals.py:134) —
    the reference itself is not seed-reproducible there.  The host draw
    comes from the np_random stream instead (it is the final consumer, so
    the layout stream is unaffected); everything else is bit-exact."""
    g.wall_rect(0, 0, g.w, g.h)
    g.place_agent()
    if env.mission_type == "EITHER":
        negated = g.rand_int(0, 2) == 0  # _rand_bool
    else:
        negated = env.mission_type == "NEGATED"
    tgt_types = env._neg_types if negated else env._dir_types
    tgt_colors = env._neg_colors if negated else env._dir_colors
    t_type = int(tgt_types[g.rand_int(0, len(tgt_types))])
    t_color = int(tgt_colors[g.rand_int(0, len(tgt_colors))])
    t_pos = g.place_obj(np.asarray([t_type, t_color, 0], np.uint8))
    # distractor opts exclude the target's type and color; reference draws
    # color FIRST then type (negated_goals.py:165-171)
    type_opts = [int(t) for t in env._distra_types if int(t) != t_type]
    color_opts = [int(c) for c in env._all_colors if int(c) != t_color]
    d_color = _rand_elem(g, color_opts)
    d_type = _rand_elem(g, type_opts)
    g.place_obj(np.asarray([d_type, d_color, 0], np.uint8))
    template = g.rand_int(0, 10)  # _rand_elem(base_templates)
    use_color = g.rand_int(0, 2) == 0  # see docstring: unseeded upstream
    desc = d_color if negated else t_color
    desc_t = d_type if negated else t_type
    return {
        "mission": np.asarray(
            [template, int(negated), int(use_color),
             desc if use_color else desc_t], np.int32),
        "extra": {"target": np.asarray([t_type, t_color], np.int32),
                  "target_cell": np.asarray(t_pos, np.int32)},
    }


_GENERATORS = {
    "Empty": _gen_empty,
    "DoorKey": _gen_doorkey,
    "LavaGap": _gen_lavagap,
    "FourRooms": _gen_fourrooms,
    "Crossing": _gen_crossing,
    "DistShift": _gen_distshift,
    "GoToDoor": _gen_gotodoor,
    "Fetch": _gen_fetch,
    "GoToObject": _gen_gotoobject,
    "PutNear": _gen_putnear,
    "DynamicObstacles": _gen_dynamicobstacles,
    "RedBlueDoor": _gen_redbluedoor,
    "Memory": _gen_memory,
    "LockedRoom": _gen_lockedroom,
    "MultiRoom": _gen_multiroom,
    "Negated": _gen_negated,
    "NegatedSimple": _gen_negated,
    "Playground": _gen_playground,
    "ObstructedMaze_1Dlhb": _gen_obstructed_1dlhb,
    "ObstructedMaze_Full": _gen_obstructed_full,
    "ObstructedMaze_2Dl": _gen_obstructed_full,
    "ObstructedMaze_2Dlh": _gen_obstructed_full,
    "ObstructedMaze_2Dlhb": _gen_obstructed_full,
    "KeyCorridor": _gen_keycorridor,
    "Unlock": _gen_unlock,
    "UnlockPickup": _gen_unlockpickup,
    "BlockedUnlockPickup": _gen_blockedunlockpickup,
}


def _desc(type_id, color_id=0, loc=0) -> torch.Tensor:
    """``V.desc`` for one env: int32[1, 3] on the host."""
    return V.desc(type_id, color_id, loc, n=1, device=_HOST)


def _single_clause(kind, d1, d2=None, strict=False) -> dict:
    """A single-clause code with one slot, as the JAX package's ``n=1``
    code (composites from ``V.and_instr``/``V.seq_instr`` have four)."""
    return V.single_clause(kind, d1, d2=d2, strict=strict, k=1)


class _RejectSampling(Exception):
    """Mirror of the reference's RejectSampling (roomgrid_level.py:16)."""


def _check_objs_reachable_host(g: _HostGrid) -> None:
    """check_objs_reachable (roomgrid_level.py:249-301): BFS from the agent
    where doors of any state are passable and other objects block
    expansion; any unreachable non-wall object rejects the sample."""
    door_t = C.OBJECT_TO_IDX["door"]
    empty_t = C.OBJECT_TO_IDX["empty"]
    wall_t = C.OBJECT_TO_IDX["wall"]
    reachable: set = set()
    stack = [tuple(g.agent_pos)]
    while stack:
        i, j = stack.pop()
        if i < 0 or i >= g.w or j < 0 or j >= g.h:
            continue
        if (i, j) in reachable:
            continue
        reachable.add((i, j))
        t = g.grid[i, j, 0]
        if t != empty_t and t != door_t:
            continue
        stack += [(i + 1, j), (i - 1, j), (i, j + 1), (i, j - 1)]
    for i in range(g.w):
        for j in range(g.h):
            t = g.grid[i, j, 0]
            if t == empty_t or t == wall_t:
                continue
            if (i, j) not in reachable:
                raise _RejectSampling(f"unreachable object at {(i, j)}")


def _babyai_goto_redball(env, g: _HostGrid, grey: bool):
    """babyai/goto.py:23-56 (GoToRedBallGrey recolors distractors grey
    AFTER sampling, goto.py:28-29)."""

    rg = _HostRoomGrid(g, env.room_size, 1, 1)
    rg.place_agent()
    rg.add_object(0, 0, "ball", "red")
    dists = rg.add_distractors(num_distractors=env.num_dists,
                               all_unique=False)
    if grey:
        for _, pos in dists:
            g.grid[pos[0], pos[1], 1] = C.COLOR_TO_IDX["grey"]
    _check_objs_reachable_host(g)
    return _single_clause(
        V.K_GOTO, _desc(C.OBJECT_TO_IDX["ball"], C.COLOR_TO_IDX["red"]))


def _babyai_goto_obj(env, g: _HostGrid):
    """babyai/goto.py:68-81."""

    rg = _HostRoomGrid(g, env.room_size, 1, 1)
    rg.place_agent()
    dists = rg.add_distractors(num_distractors=1)
    (kind, color), _ = dists[0]
    return _single_clause(
        V.K_GOTO, _desc(C.OBJECT_TO_IDX[kind], C.COLOR_TO_IDX[color]))


def _babyai_goto_local(env, g: _HostGrid):
    """babyai/goto.py:84-98."""

    rg = _HostRoomGrid(g, env.room_size, 1, 1)
    rg.place_agent()
    dists = rg.add_distractors(num_distractors=env.num_dists,
                               all_unique=False)
    _check_objs_reachable_host(g)
    (kind, color), _ = _rand_elem(g, dists)
    return _single_clause(
        V.K_GOTO, _desc(C.OBJECT_TO_IDX[kind], C.COLOR_TO_IDX[color]))


def _rand_subset(g: _HostGrid, lst, n):
    """_rand_subset (minigrid_env.py:276-290): draw-and-remove."""
    lst = list(lst)
    out = []
    while len(out) < n:
        e = _rand_elem(g, lst)
        lst.remove(e)
        out.append(e)
    return out


def _clause(kind, type_name=None, color_name=None, loc=0, strict=False,
            d2=None):

    d1 = _desc(0 if type_name is None else C.OBJECT_TO_IDX[type_name],
                0 if color_name is None else C.COLOR_TO_IDX[color_name],
                loc)
    return _single_clause(kind, d1, d2=d2, strict=strict)


def _validate_putnext_host(g: _HostGrid, da, db) -> None:
    """validate_instrs' PutNextInstr branch (roomgrid_level.py:159-176):
    shared objects, existing adjacency, or a single self-move reject the
    sample.  da/db = (type_name, color_name)."""
    def cells(type_name, color_name):
        t = C.OBJECT_TO_IDX[type_name]
        c = C.COLOR_TO_IDX[color_name]
        return [(i, j) for i in range(g.w) for j in range(g.h)
                if g.grid[i, j, 0] == t and g.grid[i, j, 1] == c]

    a_cells, b_cells = cells(*da), cells(*db)
    if set(a_cells) & set(b_cells):
        raise _RejectSampling("objects match both lhs and rhs of PutNext")
    for (xa, ya) in a_cells:
        for (xb, yb) in b_cells:
            if abs(xa - xb) + abs(ya - yb) == 1:
                raise _RejectSampling("objs already next to each other")


def _babyai_pickup(env, g: _HostGrid):
    """babyai/pickup.py:12-23 (Pickup: multi-room, connect_all)."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    rg.place_agent()
    rg.connect_all()
    dists = rg.add_distractors(num_distractors=18, all_unique=False)
    _check_objs_reachable_host(g)
    (kind, color), _ = _rand_elem(g, dists)
    return _clause(V.K_PICKUP, kind, color)


def _babyai_unblock_pickup(env, g: _HostGrid):
    """babyai/pickup.py:26-43: at least one object must be UNreachable."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    rg.place_agent()
    rg.connect_all()
    dists = rg.add_distractors(num_distractors=20, all_unique=False)
    try:
        _check_objs_reachable_host(g)
    except _RejectSampling:
        pass
    else:
        raise _RejectSampling("all objects reachable")
    (kind, color), _ = _rand_elem(g, dists)
    return _clause(V.K_PICKUP, kind, color)


def _babyai_pickup_dist(env, g: _HostGrid):
    """babyai/pickup.py:71-97: distractors first, then agent; 3-way
    select_by wildcards."""

    rg = _HostRoomGrid(g, env.room_size, 1, 1)
    dists = rg.add_distractors(num_distractors=5)
    rg.place_agent(0, 0)
    (kind, color), _ = _rand_elem(g, dists)
    select_by = _rand_elem(g, ["type", "color", "both"])
    if select_by == "color":
        kind = None
    elif select_by == "type":
        color = None
    return _clause(V.K_PICKUP, kind, color, strict=env.debug)


def _babyai_pickup_above(env, g: _HostGrid):
    """babyai/pickup.py:100-120."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    (kind, color), _ = rg.add_object(1, 0)
    rg.add_door(1, 1, 3, locked=False)
    rg.place_agent(1, 1)
    rg.connect_all()
    return _clause(V.K_PICKUP, kind, color)


def _babyai_open(env, g: _HostGrid):
    """babyai/open.py:17-42 (Open: the door list enumerates every room's
    doors, so shared doors appear twice — same draw weights as the
    reference)."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    rg.place_agent()
    rg.connect_all()
    rg.add_distractors(num_distractors=18, all_unique=False)
    _check_objs_reachable_host(g)
    doors = []
    for i in range(rg.cols):
        for j in range(rg.rows):
            for d in rg.doors[i, j]:
                if d:
                    doors.append(d)
    color = _rand_elem(g, doors)
    return _clause(V.K_OPEN, "door", color)


def _babyai_open_red_door(env, g: _HostGrid):
    """babyai/open.py:45-58."""

    rg = _HostRoomGrid(g, env.room_size, 1, 2)
    rg.add_door(0, 0, 0, "red", locked=False)
    rg.place_agent(0, 0)
    return _clause(V.K_OPEN, "door", "red")


def _babyai_open_door(env, g: _HostGrid):
    """babyai/open.py:61-94 (OpenDoor / OpenDoorColor / OpenDoorLoc)."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    door_colors = _rand_subset(g, _SORTED_COLORS, 4)
    for i, color in enumerate(door_colors):
        rg.add_door(1, 1, door_idx=i, color=color, locked=False)
    select_by = env.select_by
    if select_by is None:
        select_by = _rand_elem(g, ["color", "loc"])
    if select_by == "color":
        code = _clause(V.K_OPEN, "door", door_colors[0], strict=env.debug)
    else:
        loc = 1 + V.LOC_NAMES.index(_rand_elem(g, list(V.LOC_NAMES)))
        code = _clause(V.K_OPEN, "door", None, loc=loc, strict=env.debug)
    rg.place_agent(1, 1)
    return code


def _babyai_open_two_doors(env, g: _HostGrid):
    """babyai/open.py:97-137."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    colors = _rand_subset(g, _SORTED_COLORS, 2)
    first = env.first_color if env.first_color else colors[0]
    second = env.second_color if env.second_color else colors[1]
    rg.add_door(1, 1, 2, color=first, locked=False)
    rg.add_door(1, 1, 0, color=second, locked=False)
    rg.place_agent(1, 1)
    return V.seq_instr(
        V.S_BEFORE,
        _clause(V.K_OPEN, "door", first, strict=env.strict),
        _clause(V.K_OPEN, "door", second),
    )


def _babyai_open_doors_order(env, g: _HostGrid):
    """babyai/open.py:140-180 (random-wall add_door + 3-way mode)."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    colors = _rand_subset(g, _SORTED_COLORS, env.num_doors)
    doors = []
    for i in range(env.num_doors):
        color, _ = rg.add_door(1, 1, color=colors[i], locked=False)
        doors.append(color)
    rg.place_agent(1, 1)
    d1, d2 = _rand_subset(g, doors, 2)
    mode = g.rand_int(0, 3)
    c1 = _clause(V.K_OPEN, "door", d1, strict=env.debug)
    if mode == 0:
        return c1
    c2 = _clause(V.K_OPEN, "door", d2, strict=env.debug)
    return V.seq_instr(V.S_BEFORE if mode == 1 else V.S_AFTER, c1, c2)


def _babyai_putnext_local(env, g: _HostGrid):
    """babyai/putnext.py:10-28 + the PutNext validate_instrs branch."""

    rg = _HostRoomGrid(g, env.room_size, 1, 1)
    rg.place_agent()
    dists = rg.add_distractors(num_distractors=env.num_objs, all_unique=True)
    _check_objs_reachable_host(g)
    (o1, o2) = _rand_subset(g, dists, 2)
    (k1, c1), (k2, c2) = o1[0], o2[0]
    _validate_putnext_host(g, (k1, c1), (k2, c2))

    return _single_clause(
        V.K_PUTNEXT,
        _desc(C.OBJECT_TO_IDX[k1], C.COLOR_TO_IDX[c1]),
        d2=_desc(C.OBJECT_TO_IDX[k2], C.COLOR_TO_IDX[c2]))


def _babyai_putnext(env, g: _HostGrid):
    """babyai/putnext.py:31-93 (incl. the start_carrying payload for
    post_generate)."""

    rg = _HostRoomGrid(g, env.room_size, 1, 2)
    rg.place_agent(0, 0)
    objs_l = rg.add_distractors(0, 0, env.objs_per_room)
    objs_r = rg.add_distractors(1, 0, env.objs_per_room)
    rg.remove_wall(0, 0, 0)
    a, a_pos = _rand_elem(g, objs_l)
    b, b_pos = _rand_elem(g, objs_r)
    if g.rand_int(0, 2) == 0:  # _rand_bool
        a, b = b, a
        a_pos, b_pos = b_pos, a_pos
    _validate_putnext_host(g, a, b)
    instr = _single_clause(
        V.K_PUTNEXT,
        _desc(C.OBJECT_TO_IDX[a[0]], C.COLOR_TO_IDX[a[1]]),
        d2=_desc(C.OBJECT_TO_IDX[b[0]], C.COLOR_TO_IDX[b[1]]))
    extra_b = {
        "carry_triple": np.asarray(
            [C.OBJECT_TO_IDX[a[0]], C.COLOR_TO_IDX[a[1]], 0], np.uint8),
        "carry_pos": np.asarray(a_pos, np.int32),
    }
    return instr, extra_b


_LOC_IDS = {"left": 1, "right": 2, "front": 3, "behind": 4}


def _open_all_doors(g: _HostGrid, rg: _HostRoomGrid) -> None:
    """open_all_doors (roomgrid_level.py:237-247): flip every door open."""
    door_t = C.OBJECT_TO_IDX["door"]
    for i in range(g.w):
        for j in range(g.h):
            if g.grid[i, j, 0] == door_t:
                g.grid[i, j, 2] = C.STATE_TO_IDX["open"]


def _locked_room_retry_place_agent(g, rg, locked_room):
    """LevelGen/Unlock's agent placement loop: re-place until the start
    room is not the locked room (levelgen.py:67-73, unlock.py:60-66)."""
    while True:
        rg.place_agent()
        if locked_room is not None:
            ri, rj = rg.room_from_pos(*g.agent_pos)
            if (min(ri, rg.cols - 1), min(rj, rg.rows - 1)) == locked_room:
                continue
        break


def _babyai_goto(env, g: _HostGrid):
    """babyai/goto.py:101-135 (GoTo; doors_open -> open_all_doors)."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    rg.place_agent()
    rg.connect_all()
    dists = rg.add_distractors(num_distractors=env.num_dists,
                               all_unique=False)
    _check_objs_reachable_host(g)
    (kind, color), _ = _rand_elem(g, dists)
    if env.doors_open:
        _open_all_doors(g, rg)
    return _clause(V.K_GOTO, kind, color)


def _babyai_goto_imp_unlock(env, g: _HostGrid):
    """babyai/goto.py:138-180."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    i_d = g.rand_int(0, rg.cols)
    j_d = g.rand_int(0, rg.rows)
    door_color, _ = rg.add_door(i_d, j_d, locked=True)
    # Reference quirk (goto.py:148-156): `if ik is id and jk is jd` compares
    # np.int64 draws by IDENTITY — always False — so the "key in a different
    # room" retry never fires and the key may land in the locked room.
    ik = g.rand_int(0, rg.cols)
    jk = g.rand_int(0, rg.rows)
    rg.add_object(ik, jk, "key", door_color)
    rg.connect_all()
    # Same quirk (goto.py:163-166): `i is not id or j is not jd` is always
    # True for int-vs-np.int64, so EVERY room gets distractors.
    for i in range(rg.cols):
        for j in range(rg.rows):
            rg.add_distractors(i, j, num_distractors=2, all_unique=False)
    _locked_room_retry_place_agent(g, rg, (i_d, j_d))
    _check_objs_reachable_host(g)
    (kind, color), _ = rg.add_distractors(i_d, j_d, num_distractors=1,
                                          all_unique=False)[0]
    return _clause(V.K_GOTO, kind, color)


def _babyai_goto_redblueball(env, g: _HostGrid):
    """babyai/goto.py:206-233: distractors must contain no red/blue ball."""

    rg = _HostRoomGrid(g, env.room_size, 1, 1)
    rg.place_agent()
    dists = rg.add_distractors(num_distractors=env.num_dists,
                               all_unique=False)
    for (kind, color), _ in dists:
        if kind == "ball" and color in ("blue", "red"):
            raise _RejectSampling("can only have one blue or red ball")
    color = _rand_elem(g, ["red", "blue"])
    rg.add_object(0, 0, "ball", color)
    _check_objs_reachable_host(g)
    return _clause(V.K_GOTO, "ball", color)


def _babyai_goto_door_b(env, g: _HostGrid):
    """babyai/goto.py:236-253 (GoToDoor: four fully random doors)."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    colors = []
    for _ in range(4):
        color, _ = rg.add_door(1, 1)
        colors.append(color)
    rg.place_agent(1, 1)
    return _clause(V.K_GOTO, "door", _rand_elem(g, colors))


def _babyai_goto_objdoor(env, g: _HostGrid):
    """babyai/goto.py:256-279."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    rg.place_agent(1, 1)
    objs = [d[0] for d in rg.add_distractors(1, 1, num_distractors=8,
                                             all_unique=False)]
    for _ in range(4):
        color, _ = rg.add_door(1, 1)
        objs.append(("door", color))
    _check_objs_reachable_host(g)
    kind, color = _rand_elem(g, objs)
    return _clause(V.K_GOTO, kind, color)


def _babyai_unlock_b(env, g: _HostGrid):
    """babyai/unlock.py:13-67 (Unlock: 50% unique-color connect_all)."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    i_d = g.rand_int(0, rg.cols)
    j_d = g.rand_int(0, rg.rows)
    door_color, _ = rg.add_door(i_d, j_d, locked=True)
    # Reference quirk (unlock.py:25-33): the `ik is id and jk is jd` retry
    # never fires (np.int64 identity) — one draw, key may land locked-in.
    ik = g.rand_int(0, rg.cols)
    jk = g.rand_int(0, rg.rows)
    rg.add_object(ik, jk, "key", door_color)
    if g.rand_int(0, 2) == 0:  # _rand_bool
        # `filter(lambda c: c is not door.color, ...)`: interned str
        # identity DOES work here, so the exclusion is real
        rg.connect_all([c for c in _SORTED_COLORS if c != door_color])
    else:
        rg.connect_all()
    # distractor-room filter is always True (int vs np.int64 `is not`)
    for i in range(rg.cols):
        for j in range(rg.rows):
            rg.add_distractors(i, j, num_distractors=3, all_unique=False)
    _locked_room_retry_place_agent(g, rg, (i_d, j_d))
    _check_objs_reachable_host(g)
    return _clause(V.K_OPEN, "door", door_color)


def _babyai_unlock_local(env, g: _HostGrid):
    """babyai/unlock.py:70-86 (type-only OpenInstr)."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    door_color, _ = rg.add_door(1, 1, locked=True)
    rg.add_object(1, 1, "key", door_color)
    if env.distractors:
        rg.add_distractors(1, 1, num_distractors=3)
    rg.place_agent(1, 1)
    return _clause(V.K_OPEN, "door", None)


def _babyai_keyinbox(env, g: _HostGrid):
    """babyai/unlock.py:89-105: the key hides inside a box (box_contains
    payload for the builder)."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    door_color, _ = rg.add_door(1, 1, locked=True)
    box_color = _rand_elem(g, _SORTED_COLORS)  # _rand_color
    pos = rg.place_in_room(1, 1, _obj("box", C.COLOR_TO_IDX[box_color]))
    rg.place_agent(1, 1)
    contains = np.broadcast_to(_EMPTY, (g.w, g.h, 3)).copy()
    contains[pos[0], pos[1]] = _obj("key", C.COLOR_TO_IDX[door_color])
    return (_clause(V.K_OPEN, "door", None),
            {"box_contains": contains})


def _babyai_unlockpickup_b(env, g: _HostGrid):
    """babyai/unlock.py:108-142."""

    rg = _HostRoomGrid(g, env.room_size, 1, 2)
    (kind, color), _ = rg.add_object(1, 0, kind="box")
    door_color, _ = rg.add_door(0, 0, 0, locked=True)
    rg.add_object(0, 0, "key", door_color)
    if env.distractors:
        rg.add_distractors(num_distractors=4)
    rg.place_agent(0, 0)
    return _clause(V.K_PICKUP, kind, color)


def _babyai_blockedunlockpickup_b(env, g: _HostGrid):
    """babyai/unlock.py:145-170 (type-only PickupInstr)."""

    rg = _HostRoomGrid(g, env.room_size, 1, 2)
    rg.add_object(1, 0, kind="box")
    door_color, pos = rg.add_door(0, 0, 0, locked=True)
    ball_color = _rand_elem(g, _SORTED_COLORS)  # _rand_color
    g.put(pos[0] - 1, pos[1], _obj("ball", C.COLOR_TO_IDX[ball_color]))
    rg.add_object(0, 0, "key", door_color)
    rg.place_agent(0, 0)
    return _clause(V.K_PICKUP, "box", None)


def _babyai_unlocktounlock(env, g: _HostGrid):
    """babyai/unlock.py:173-202 (type-only PickupInstr)."""

    rg = _HostRoomGrid(g, env.room_size, 1, 3)
    colors = _rand_subset(g, _SORTED_COLORS, 2)
    rg.add_door(0, 0, door_idx=0, color=colors[0], locked=True)
    rg.add_object(2, 0, kind="key", color=colors[0])
    rg.add_door(1, 0, door_idx=0, color=colors[1], locked=True)
    rg.add_object(1, 0, kind="key", color=colors[1])
    rg.add_object(0, 0, kind="ball")
    rg.place_agent(1, 0)
    return _clause(V.K_PICKUP, "ball", None)


def _babyai_actionobjdoor(env, g: _HostGrid):
    """babyai/other.py:18-48 (3-way action over objects and doors)."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    objs = [d[0] for d in rg.add_distractors(1, 1, num_distractors=5)]
    for _ in range(4):
        color, _ = rg.add_door(1, 1, locked=False)
        objs.append(("door", color))
    rg.place_agent(1, 1)
    kind, color = _rand_elem(g, objs)
    if kind == "door":
        alt = V.K_GOTO if g.rand_int(0, 2) == 0 else V.K_OPEN
    else:
        alt = V.K_GOTO if g.rand_int(0, 2) == 0 else V.K_PICKUP
    return _clause(alt, kind, color)


def _babyai_findobj(env, g: _HostGrid):
    """babyai/other.py:51-70 (FindObjS5; note the reference draws the
    column bound from num_rows and vice versa — square grids)."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    i = g.rand_int(0, rg.rows)
    j = g.rand_int(0, rg.cols)
    (kind, _), _ = rg.add_object(i, j)
    rg.place_agent(1, 1)
    rg.connect_all()
    return _clause(V.K_PICKUP, kind, None)


def _babyai_keycorridor_b(env, g: _HostGrid):
    """babyai/other.py:73-110 (type-only PickupInstr)."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, 3)
    for j in range(1, rg.rows):
        rg.remove_wall(1, j, 3)
    room_idx = g.rand_int(0, rg.rows)
    door_color, _ = rg.add_door(2, room_idx, 2, locked=True)
    (kind, _), _ = rg.add_object(2, room_idx, kind=env.obj_type)
    rg.add_object(0, g.rand_int(0, rg.rows), "key", door_color)
    rg.place_agent(1, rg.rows // 2)
    rg.connect_all()
    return _clause(V.K_PICKUP, kind, None)


def _babyai_oneroom(env, g: _HostGrid):
    """babyai/other.py:113-123."""

    rg = _HostRoomGrid(g, env.room_size, 1, 1)
    rg.add_object(0, 0, kind="ball")
    rg.place_agent()
    return _clause(V.K_PICKUP, "ball", None)


def _babyai_movetwoacross(env, g: _HostGrid):
    """babyai/other.py:126-180: Before(PutNext, PutNext) across rooms."""

    rg = _HostRoomGrid(g, env.room_size, 1, 2)
    rg.place_agent(0, 0)
    objs_l = rg.add_distractors(0, 0, env.objs_per_room)
    objs_r = rg.add_distractors(1, 0, env.objs_per_room)
    rg.remove_wall(0, 0, 0)
    sel_l = _rand_subset(g, objs_l, 2)
    sel_r = _rand_subset(g, objs_r, 2)
    a, d = sel_l[0][0], sel_l[1][0]
    b, c = sel_r[0][0], sel_r[1][0]
    for move, fixed in ((a, b), (c, d)):
        _validate_putnext_host(g, move, fixed)

    def pn(move, fixed):

        return _single_clause(
            V.K_PUTNEXT,
            _desc(C.OBJECT_TO_IDX[move[0]], C.COLOR_TO_IDX[move[1]]),
            d2=_desc(C.OBJECT_TO_IDX[fixed[0]], C.COLOR_TO_IDX[fixed[1]]))

    return V.seq_instr(V.S_BEFORE, pn(a, b), pn(c, d))


def _find_cells(g: _HostGrid, rg: _HostRoomGrid, type_name, color_name, loc):
    """ObjDesc.find_matching_objs host-side (verifier.py:104-169): cells
    whose (type, color) match, with location predicates relative to the
    agent's pose restricted to its room (borders included)."""
    cells = []
    s = rg.room_size
    if loc is not None:
        ri, rj = rg.room_from_pos(*g.agent_pos)
        ri, rj = min(ri, rg.cols - 1), min(rj, rg.rows - 1)
        tx, ty = rg.top[ri, rj]
        d1 = [(1, 0), (0, 1), (-1, 0), (0, -1)][g.agent_dir]
        d2 = (-d1[1], d1[0])
    t_id = None if type_name is None else C.OBJECT_TO_IDX[type_name]
    c_id = None if color_name is None else C.COLOR_TO_IDX[color_name]
    for i in range(g.w):
        for j in range(g.h):
            t = g.grid[i, j, 0]
            if t == C.OBJECT_TO_IDX["empty"]:
                continue
            if t_id is not None and t != t_id:
                continue
            if c_id is not None and g.grid[i, j, 1] != c_id:
                continue
            if loc is not None:
                if not (tx <= i < tx + s and ty <= j < ty + s):
                    continue
                v = (i - g.agent_pos[0], j - g.agent_pos[1])
                dots = {"left": v[0] * d2[0] + v[1] * d2[1] < 0,
                        "right": v[0] * d2[0] + v[1] * d2[1] > 0,
                        "front": v[0] * d1[0] + v[1] * d1[1] > 0,
                        "behind": v[0] * d1[0] + v[1] * d1[1] < 0}
                if not dots[loc]:
                    continue
            cells.append((i, j))
    return cells


def _babyai_levelgen(env, g: _HostGrid):
    """LevelGen.gen_mission (levelgen.py:58-210): optional locked room,
    connect_all, distractors, agent-outside-locked-room retry, rand_instr
    over the {action, and, seq} grammar with rand_obj descriptor rejection
    loops — all on the reference stream — plus validate_instrs
    (roomgrid_level.py:145-198) host-side."""

    rg = _HostRoomGrid(g, env.room_size, env.num_rows, env.num_cols)
    locked_room = None
    locked_door_color = None
    if g.rng.uniform(0.0, 1.0) < env.locked_room_prob:  # _rand_float
        while True:  # add_locked_room (levelgen.py:85-112)
            i = g.rand_int(0, rg.cols)
            j = g.rand_int(0, rg.rows)
            d = g.rand_int(0, 4)
            locked_room = (i, j)
            if rg.neighbors[i, j][d] is None:
                continue
            locked_door_color, _ = rg.add_door(i, j, d, locked=True)
            break
        while True:
            i = g.rand_int(0, rg.cols)
            j = g.rand_int(0, rg.rows)
            if (i, j) == locked_room:
                continue
            rg.add_object(i, j, "key", locked_door_color)
            break
    rg.connect_all()
    rg.add_distractors(num_distractors=env.num_dists, all_unique=False)
    while True:
        rg.place_agent()
        if locked_room is not None:
            ri, rj = rg.room_from_pos(*g.agent_pos)
            if (min(ri, rg.cols - 1), min(rj, rg.rows - 1)) == locked_room:
                continue
        break
    if not env.unblocking:
        _check_objs_reachable_host(g)

    def in_locked(pos):
        tx, ty = rg.top[locked_room]
        s = rg.room_size
        return tx <= pos[0] < tx + s and ty <= pos[1] < ty + s

    def rand_obj(types):
        """rand_obj (levelgen.py:114-155): color-then-type draw, optional
        location, match + implicit-unlock rejection, 100-try fuel."""
        tries = 0
        while True:
            if tries > 100:
                raise _RejectSampling("failed to find suitable object")
            tries += 1
            color = _rand_elem(g, [None, *_SORTED_COLORS])
            type_name = _rand_elem(g, types)
            loc = None
            if env.locations and g.rand_int(0, 2) == 0:  # _rand_bool
                loc = _rand_elem(g, list(_LOC_IDS))
            cells = _find_cells(g, rg, type_name, color, loc)
            if not cells:
                continue
            if not env.implicit_unlock and locked_room is not None:
                if all(in_locked(p) for p in cells):
                    continue
            return (type_name, color, loc)

    types_all = ["box", "ball", "key", "door"]
    types_not_door = ["box", "ball", "key"]

    def rand_instr(action_kinds, instr_kinds):
        """rand_instr (levelgen.py:157-210) as a host AST."""
        kind = _rand_elem(g, list(instr_kinds))
        if kind == "action":
            action = _rand_elem(g, list(action_kinds))
            if action == "goto":
                return ("goto", rand_obj(types_all), None)
            if action == "pickup":
                return ("pickup", rand_obj(types_not_door), None)
            if action == "open":
                return ("open", rand_obj(["door"]), None)
            return ("putnext", rand_obj(types_not_door), rand_obj(types_all))
        if kind == "and":
            a = rand_instr(action_kinds, ["action"])
            b = rand_instr(action_kinds, ["action"])
            return ("and", a, b)
        a = rand_instr(action_kinds, ["action", "and"])
        b = rand_instr(action_kinds, ["action", "and"])
        seq = _rand_elem(g, ["before", "after"])
        return (seq, a, b)

    ast = rand_instr(env.action_kinds, env.instr_kinds)

    # validate_instrs (roomgrid_level.py:145-198).  Locked-door colors come
    # from a grid scan — equivalent to the reference's per-room door walk,
    # which visits every locked door object (only set membership matters).
    locked_colors = []
    if env.unblocking:
        door_t = C.OBJECT_TO_IDX["door"]
        locked_s = C.STATE_TO_IDX["locked"]
        for i in range(g.w):
            for j in range(g.h):
                if g.grid[i, j, 0] == door_t and g.grid[i, j, 2] == locked_s:
                    locked_colors.append(int(g.grid[i, j, 1]))

    def validate(node):
        op = node[0]
        if op == "putnext":
            (mt, mc, ml), (ft, fc, fl) = node[1], node[2]
            move_cells = _find_cells(g, rg, mt, mc, ml)
            fixed_cells = _find_cells(g, rg, ft, fc, fl)
            if set(move_cells) & set(fixed_cells):
                raise _RejectSampling("match both lhs and rhs of PutNext")
            for (xa, ya) in move_cells:
                for (xb, yb) in fixed_cells:
                    if abs(xa - xb) + abs(ya - yb) == 1:
                        raise _RejectSampling("objs already next")
        if op in ("goto", "pickup", "open", "putnext"):
            if not env.unblocking:
                return
            for desc in (node[1], node[2]):
                if desc is None:
                    continue
                t, c, _ = desc
                if (t == "key" and c is not None
                        and C.COLOR_TO_IDX[c] in locked_colors):
                    raise _RejectSampling("key matches a locked door")
            return
        validate(node[1])
        validate(node[2])

    validate(ast)

    def conv(node):
        op = node[0]
        if op in ("goto", "pickup", "open", "putnext"):
            kind = {"goto": V.K_GOTO, "pickup": V.K_PICKUP,
                    "open": V.K_OPEN, "putnext": V.K_PUTNEXT}[op]
            (t, c, loc) = node[1]
            d1 = _desc(C.OBJECT_TO_IDX[t],
                        0 if c is None else C.COLOR_TO_IDX[c],
                        0 if loc is None else _LOC_IDS[loc])
            d2 = None
            if node[2] is not None:
                (t2, c2, l2) = node[2]
                d2 = _desc(C.OBJECT_TO_IDX[t2],
                            0 if c2 is None else C.COLOR_TO_IDX[c2],
                            0 if l2 is None else _LOC_IDS[l2])
            return _single_clause(kind, d1, d2=d2)
        if op == "and":
            return V.and_instr(conv(node[1]), conv(node[2]))
        return V.seq_instr(V.S_BEFORE if op == "before" else V.S_AFTER,
                           conv(node[1]), conv(node[2]))

    return conv(ast)


# BabyAI families: gen_mission host replays, keyed on class name.  Each
# returns the InstrCode (optionally with extra builder keys for
# post_generate); the RoomGridLevel retry loop (roomgrid_level.py:118-143)
# and verifier-state finalization live in reset_exact.
_BABYAI_GENERATORS = {
    "GoToRedBallGrey": lambda e, g: _babyai_goto_redball(e, g, True),
    "GoToRedBall": lambda e, g: _babyai_goto_redball(e, g, False),
    "GoToRedBallNoDists": lambda e, g: _babyai_goto_redball(e, g, False),
    "GoToObj": _babyai_goto_obj,
    "GoToLocal": _babyai_goto_local,
    "Pickup": _babyai_pickup,
    "UnblockPickup": _babyai_unblock_pickup,
    "PickupDist": _babyai_pickup_dist,
    "PickupDistDebug": _babyai_pickup_dist,
    "PickupAbove": _babyai_pickup_above,
    "Open": _babyai_open,
    "OpenRedDoor": _babyai_open_red_door,
    "OpenDoor": _babyai_open_door,
    "OpenDoorColor": _babyai_open_door,
    "OpenDoorLoc": _babyai_open_door,
    "OpenTwoDoors": _babyai_open_two_doors,
    "OpenDoorsOrder": _babyai_open_doors_order,
    "PutNextLocal": _babyai_putnext_local,
    "PutNext": _babyai_putnext,
    "PutNextCarrying": _babyai_putnext,
    "GoTo": _babyai_goto,
    "GoToImpUnlock": _babyai_goto_imp_unlock,
    "GoToRedBlueBall": _babyai_goto_redblueball,
    "GoToDoorBabyAI": _babyai_goto_door_b,
    "GoToObjDoor": _babyai_goto_objdoor,
    "Unlock": _babyai_unlock_b,
    "UnlockLocal": _babyai_unlock_local,
    "KeyInBox": _babyai_keyinbox,
    "UnlockPickup": _babyai_unlockpickup_b,
    "BlockedUnlockPickup": _babyai_blockedunlockpickup_b,
    "UnlockToUnlock": _babyai_unlocktounlock,
    "ActionObjDoor": _babyai_actionobjdoor,
    "FindObjS5": _babyai_findobj,
    "KeyCorridor": _babyai_keycorridor_b,
    "OneRoomS8": _babyai_oneroom,
    "MoveTwoAcross": _babyai_movetwoacross,
    "PickupLoc": _babyai_levelgen,
    "GoToSeq": _babyai_levelgen,
    "Synth": _babyai_levelgen,
    "SynthS5R2": _babyai_levelgen,
    "SynthLoc": _babyai_levelgen,
    "SynthSeq": _babyai_levelgen,
    "MiniBossLevel": _babyai_levelgen,
    "BossLevel": _babyai_levelgen,
    "BossLevelNoUnlock": _babyai_levelgen,
    "LevelGen": _babyai_levelgen,
}


def _is_babyai(env) -> bool:
    from minigrid_tpu_torch.babyai.level import BabyAILevel

    return isinstance(env, BabyAILevel)


def supported(env) -> bool:
    name = type(env).__name__.replace("Env", "")
    if _is_babyai(env):
        return name in _BABYAI_GENERATORS
    return name in _GENERATORS


def _one(a, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A host array as a batch of one on ``dev``."""
    return torch.from_numpy(np.asarray(a)[None]).to(device=dev, dtype=dtype)


def reset_exact(env, seed: int, params=None, device=None):
    """Reference-identical reset: the batch-first ``(obs, EnvState)`` of one
    env for ``seed``, matching ``ref_env.reset(seed=seed)`` bit for bit, on
    ``device`` (CUDA unless named): :func:`host_level`, then
    :func:`finalize_level`."""
    params = params if params is not None else env.default_params
    dev = resolve_device(device)
    return finalize_level(env, host_level(env, seed, params), seed, params, dev)


def host_level(env, seed: int, params=None) -> dict:
    """The host half of :func:`reset_exact`: the level replayed on the
    reference's stream, as numpy: ``grid`` (W, H, 3) triples, ``agent_pos``,
    ``agent_dir``, the family's ``payload`` (mission, ``extra``, box
    contents, a carried start) and, for BabyAI, the instruction code
    ``instr`` on the host."""
    params = params if params is not None else env.default_params
    name = type(env).__name__.replace("Env", "")
    if _is_babyai(env):
        # BabyAI class names can shadow MiniGrid families (Unlock,
        # KeyCorridor, UnlockPickup...) — dispatch on the level base class.
        if name not in _BABYAI_GENERATORS:
            raise NotImplementedError(
                f"seed-exact generation not implemented for BabyAI level "
                f"{type(env).__name__}; supported: "
                f"{sorted(_BABYAI_GENERATORS)}")
        return _host_level_babyai(env, seed, params, _BABYAI_GENERATORS[name])
    try:
        gen = _GENERATORS[name]
    except KeyError:
        raise NotImplementedError(
            f"seed-exact generation not implemented for {type(env).__name__};"
            f" supported: {sorted(_GENERATORS)}"
        ) from None
    g = _HostGrid(_np_random(seed), params.width, params.height)
    payload = gen(env, g) or {}
    assert (g.agent_pos[0] >= 0 and g.agent_pos[1] >= 0
            and g.agent_dir >= 0)
    return {"grid": g.grid, "agent_pos": g.agent_pos, "agent_dir": g.agent_dir,
            "payload": payload}


def _host_level_babyai(env, seed: int, params, gen_mission) -> dict:
    """BabyAI's host half: the RoomGridLevel retry loop
    (roomgrid_level.py:118-143) replayed on the host — each attempt rebuilds
    the room lattice and runs the level's gen_mission on the continuing
    np_random stream, RejectSampling restarts it."""
    g = _HostGrid(_np_random(seed), params.width, params.height)
    while True:
        g.grid[:] = _EMPTY
        g.agent_pos, g.agent_dir = (-1, -1), -1
        try:
            result = gen_mission(env, g)
        except _RejectSampling:
            continue
        break
    instr, payload = result if isinstance(result, tuple) else (result, {})
    return {"grid": g.grid, "agent_pos": g.agent_pos, "agent_dir": g.agent_dir,
            "payload": payload, "instr": instr}


def finalize_level(env, level: dict, seed: int, params=None, device=None):
    """The device half of :func:`reset_exact`: a :func:`host_level` as the
    ``(obs, EnvState)`` of a batch of one on ``device`` (CUDA unless named),
    its key ``PRNGKey(seed)``.  A BabyAI level goes through the same
    ``_finalize`` as a batch reset (the verifier state, article flags and
    per-episode step limit), so its state is structurally a batch reset's."""
    params = params if params is not None else env.default_params
    dev = resolve_device(device)
    payload = level["payload"]
    grid = _one(pack_np(level["grid"]), torch.int32, dev)
    pos = _one(level["agent_pos"], torch.int32, dev)
    direction = _one(level["agent_dir"], torch.int32, dev)
    key = rng.PRNGKey(seed, dev)[None]
    box_contains = None
    if "box_contains" in payload:  # host payloads carry triples; the state is packed
        box_contains = _one(pack_np(payload["box_contains"]), torch.int32, dev)
    if "instr" in level:
        b = {"grid": grid, "agent_pos": pos, "agent_dir": direction}
        if "carry_triple" in payload:
            b["carry_triple"] = _one(payload["carry_triple"], torch.uint8, dev)
            b["carry_pos"] = _one(payload["carry_pos"], torch.int32, dev)
        if box_contains is not None:
            b["box_contains"] = box_contains
        instr = map_tree(lambda t: t.to(dev), level["instr"])
        state = env._finalize(b, instr, key, params)
        return env.observation(state, params), state
    kw = {"has_boxes": box_contains is not None, "box_contains": box_contains}
    if "mission" in payload:
        kw["mission"] = _one(payload["mission"], torch.int32, dev)
    if "extra" in payload:
        kw["extra"] = map_tree(lambda a: _one(a, torch.int32, dev), payload["extra"])
    state = base_state(grid, pos, direction, rng=key, **kw)
    return env.observation(state, params), state
