"""Plain NumPy reference of the RoomGrid level builder (Minigrid's
``minigrid/core/roomgrid.py``: ``RoomGrid``, ``add_object``,
``add_distractors``, ``place_agent``, ``connect_all``; BabyAI's
``check_objs_reachable``) as the configuration draws it.

A ``rows`` x ``cols`` lattice of rooms of ``room_size`` cells (walls
included), neighbouring rooms sharing a wall.  Every internal wall gets one
door slot up front, a uniform cell strictly inside the wall.  Random draws
are the configuration's stream (``minigrid.py``): ``categorical`` is a
Gumbel-max draw, which with logits of 0 and -inf picks the admitted index
whose uniform is largest, the first on ties, and is computed so.

Levels are batched over a leading dim N; a builder is a dict of ``grid``
int64[N, W, H], ``door_pos`` int64[N, n_walls, 2], ``has_door``
bool[N, n_walls], ``pos`` int64[N, 2], ``dir`` int64[N].
"""

from __future__ import annotations

import math

import numpy as np

from perfbench.reference import minigrid as M

# the color ids in the order of their sorted names (blue, brown, cyan,
# green, grey, orange, purple, red, white, yellow): _rand_color's space
SORTED_COLORS = np.array([3, 9, 8, 2, 6, 10, 4, 1, 7, 5], np.int64)
KIND_TYPES = np.array([M.KEY_T, M.BALL_T, M.BOX_T], np.int64)
DOOR_CLOSED = int(M.pack(M.DOOR_T, 0, M.CLOSED))


def uniform_rank(keys: np.ndarray, counters: np.ndarray) -> np.ndarray:
    """The order key of ``uniform(key, (n,), tiny, 1)`` at the given entries
    of the draw: its 23 mantissa bits, ``bits >> 9`` (the float is exact and
    increasing in them).  keys [N, 2], counters int [N, m] -> [N, m]."""
    k = np.asarray(keys, np.uint64)
    a, b = M.threefry2x32(k[:, 0, None], k[:, 1, None], np.zeros(counters.shape, np.uint64),
                          counters.astype(np.uint64))
    return (a ^ b) >> np.uint64(9)


def categorical(keys: np.ndarray, admitted: np.ndarray) -> np.ndarray:
    """``categorical(key, where(admitted, 0, -inf))`` over the last dim of
    ``admitted`` bool[N, n]: the admitted index whose uniform is largest."""
    n = admitted.shape[1]
    r = uniform_rank(keys, np.broadcast_to(np.arange(n), admitted.shape))
    r = np.where(admitted, r.astype(np.int64), -1)
    return r.argmax(1)


def permutation(keys: np.ndarray, n: int) -> np.ndarray:
    """``permutation(key, n)``: ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each
    a stable sort of the row by fresh 32-bit words of ``split(key)[1]``."""
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2**32 - 1))
    x = np.broadcast_to(np.arange(n), (keys.shape[0], n))
    for _ in range(rounds):
        s = M.split(keys)
        keys = s[:, 0]
        order = np.argsort(M.bits(s[:, 1], (n,)), axis=1, kind="stable")
        x = np.take_along_axis(x, order, 1)
    return x


def rand_color(keys: np.ndarray) -> np.ndarray:
    return SORTED_COLORS[M.randint(keys, (), 0, 10)]


def sample_cell(keys: np.ndarray, free: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The r-th free cell in x-major order, r uniform below their count:
    (pos [N, 2], ok [N]); pos (0, 0) where no cell is free."""
    n, w, h = free.shape
    counts = np.cumsum(free.reshape(n, w * h), 1)
    total = counts[:, -1]
    r = M.randint(keys, (), 0, np.maximum(total, 1))
    idx = (counts <= r[:, None]).sum(1)
    ok = total > 0
    pos = np.stack([idx // h, idx % h], 1)
    return np.where(ok[:, None], pos, 0), ok


class Lattice:
    def __init__(self, room_size: int, rows: int, cols: int):
        self.s, self.rows, self.cols = room_size, rows, cols
        step = room_size - 1
        self.w, self.h = step * cols + 1, step * rows + 1
        # internal walls: right of room (i, j) for i < cols - 1, then below
        # room (i, j) for j < rows - 1, each j-major; (rooms, fixed slot
        # coordinate, whether the slot runs along y)
        self.walls = ([((j * cols + i, j * cols + i + 1), ((i + 1) * step, j * step), True)
                       for j in range(rows) for i in range(cols - 1)]
                      + [((j * cols + i, (j + 1) * cols + i), (i * step, (j + 1) * step), False)
                         for j in range(rows - 1) for i in range(cols)])
        xs, ys = np.meshgrid(np.arange(self.w), np.arange(self.h), indexing="ij")
        self.xs, self.ys = xs, ys
        self.lattice = np.where((xs % step == 0) | (ys % step == 0), M.WALL, M.EMPTY)

    def room_mask(self, i: np.ndarray, j: np.ndarray) -> np.ndarray:
        """bool[N, W, H]: room (i, j) of each level, walls included."""
        step = self.s - 1
        tx, ty = (i * step)[:, None, None], (j * step)[:, None, None]
        return ((self.xs >= tx) & (self.xs < tx + self.s)
                & (self.ys >= ty) & (self.ys < ty + self.s))

    def init_rooms(self, keys: np.ndarray) -> dict:
        """Every room's walls, and a door slot drawn on each internal wall:
        ``(_, k_h, k_v) = split(key, 3)``, one ``randint(1, room_size - 1)``
        draw for the walls along y and one for those along x."""
        n = keys.shape[0]
        k = M.split(keys, 3)
        along_y = [wl for wl in self.walls if wl[2]]
        along_x = [wl for wl in self.walls if not wl[2]]
        slots = []
        if along_y:
            off = M.randint(k[:, 1], (len(along_y),), 1, self.s - 1)
            slots.append(np.stack([np.broadcast_to([c[0] for _, c, _ in along_y], off.shape),
                                   np.array([c[1] for _, c, _ in along_y]) + off], -1))
        if along_x:
            off = M.randint(k[:, 2], (len(along_x),), 1, self.s - 1)
            slots.append(np.stack([np.array([c[0] for _, c, _ in along_x]) + off,
                                   np.broadcast_to([c[1] for _, c, _ in along_x], off.shape)],
                                  -1))
        return {"grid": np.broadcast_to(self.lattice, (n, self.w, self.h)).copy(),
                "door_pos": np.concatenate(slots, 1),
                "has_door": np.zeros((n, len(self.walls)), bool)}

    def place_agent_any(self, b: dict, keys: np.ndarray) -> dict:
        """A uniform room, then the agent in it: ``split(key)``."""
        k = M.split(keys)
        room = categorical(k[:, 0], np.ones((keys.shape[0], self.rows * self.cols), bool))
        return self.place_agent_in_room(b, k[:, 1], room % self.cols, room // self.cols)

    def place_agent_in_room(self, b: dict, keys: np.ndarray, i: np.ndarray,
                            j: np.ndarray) -> dict:
        """A uniform (cell, direction) of the room whose cell is empty and
        whose front cell is empty or a wall (any pair where none is): one
        categorical over the W x H x 4 pairs, index (x H + y) 4 + d."""
        n = keys.shape[0]
        grid = b["grid"]
        t = M.cell_type(grid)
        empty = (t == M.EMPTY_T) & self.room_mask(i, j)
        ok = np.zeros((n, self.w, self.h, 4), bool)
        for d, (dx, dy) in enumerate(M.DIR_TO_VEC):
            front = np.roll(t, (-dx, -dy), axis=(1, 2))
            ok[..., d] = empty & ((front == M.EMPTY_T) | (front == M.WALL_T))
        flat = ok.reshape(n, -1)
        none = ~flat.any(1)
        # the admitted pairs lie in the room: draw the uniforms there alone
        step = self.s - 1
        a, c, d = np.meshgrid(np.arange(self.s), np.arange(self.s), np.arange(4), indexing="ij")
        x = (i * step)[:, None] + a.ravel()
        y = (j * step)[:, None] + c.ravel()
        idx = (x * self.h + y) * 4 + d.ravel()
        rows = np.arange(n)[:, None]
        pick = idx[rows[:, 0], categorical_at(keys, idx, flat[rows, idx])]
        if none.any():
            pick[none] = categorical(keys[none], np.ones((int(none.sum()), flat.shape[1]), bool))
        cell = pick // 4
        return {**b, "pos": np.stack([cell // self.h, cell % self.h], 1), "dir": pick % 4}

    def connect_all(self, b: dict, keys: np.ndarray) -> dict:
        """Doors on random walls until every room joins the agent's: the
        walls in the order of ``permutation(split(key)[0], n_walls)``'s
        values, each eligible wall (no door yet) turned into a closed door
        of color ``rand_color(split(split(key)[1], n_walls)[w])``, stopping
        once all rooms connect."""
        n = keys.shape[0]
        k = M.split(keys)
        nw = len(self.walls)
        rank = permutation(k[:, 0], nw)
        colors = rand_color(M.split(k[:, 1], nw))
        rooms = self.rows * self.cols
        # union-find as labels: each room's component
        label = np.broadcast_to(np.arange(rooms), (n, rooms)).copy()
        has = b["has_door"].copy()
        for w, ((r1, r2), _, _) in enumerate(self.walls):
            label = _join(label, has[:, w], r1, r2)
        joined = (label == label[:, :1]).all(1)
        new = np.zeros_like(has)
        rr = np.arange(n)
        for r in range(nw):
            w = (rank == r).argmax(1)
            add = ~joined & ~has[rr, w]
            new[rr[add], w[add]] = True
            for wi, ((r1, r2), _, _) in enumerate(self.walls):
                label = _join(label, add & (w == wi), r1, r2)
            joined = (label == label[:, :1]).all(1)
        grid = b["grid"].copy()
        pos = b["door_pos"]
        ni, wi = np.nonzero(new)
        grid[ni, pos[ni, wi, 0], pos[ni, wi, 1]] = DOOR_CLOSED | (colors[ni, wi] << 8)
        return {**b, "grid": grid, "has_door": has | new}

    def add_distractors(self, b: dict, keys: np.ndarray, num: int) -> tuple[dict, np.ndarray]:
        """``num`` keys, balls or boxes, duplicates allowed, one after
        another: ``(key, k_tc, k_i, k_j, k_pos) = split(key, 5)`` each, a
        uniform (kind, color) of the 30, a uniform room, and a uniform empty
        cell of it at manhattan distance 2 or more from the agent
        (``split(k_pos, 3)[2]``).  Returns (builder, int64[N, num, 2] of
        (type, color))."""
        n = keys.shape[0]
        grid = b["grid"].copy()
        px, py = b["pos"][:, 0, None, None], b["pos"][:, 1, None, None]
        near = np.abs(self.xs - px) + np.abs(self.ys - py) < 2
        rr = np.arange(n)
        added = []
        for _ in range(num):
            k = M.split(keys, 5)
            keys = k[:, 0]
            combo = M.randint(k[:, 1], (), 0, 30)
            t, color = KIND_TYPES[combo // 10], SORTED_COLORS[combo % 10]
            ri = M.randint(k[:, 2], (), 0, self.cols)
            rj = M.randint(k[:, 3], (), 0, self.rows)
            free = (grid == M.EMPTY) & self.room_mask(ri, rj) & ~near
            pos, ok = sample_cell(M.split(k[:, 4], 3)[:, 2], free)
            grid[rr[ok], pos[ok, 0], pos[ok, 1]] = t[ok] | (color[ok] << 8)
            added.append(np.stack([t, color], 1))
        return {**b, "grid": grid}, np.stack(added, 1)

    def objs_reachable(self, b: dict) -> np.ndarray:
        """``check_objs_reachable`` as the configuration bounds it: a flood
        from the agent through empty cells and doors, ``2 (W + H)`` steps
        (rounded up to a multiple of 4 above 144 cells); every object (door
        included) next to a cell it reached.  bool[N]."""
        grid = b["grid"]
        n = grid.shape[0]
        t = M.cell_type(grid)
        start = np.zeros(grid.shape, bool)
        start[np.arange(n), b["pos"][:, 0], b["pos"][:, 1]] = True
        walk = (t == M.EMPTY_T) | (t == M.DOOR_T) | start
        steps = 2 * (self.w + self.h)
        if self.w * self.h > 144:
            steps = (steps + 3) // 4 * 4
        reach = start
        for _ in range(steps):
            grown = reach | _beside(reach & walk)
            if (grown == reach).all():
                break
            reach = grown
        objects = (t != M.EMPTY_T) & (t != M.WALL_T)
        return (~objects | reach).all((1, 2))


def categorical_at(keys: np.ndarray, counters: np.ndarray, admitted: np.ndarray) -> np.ndarray:
    """The position in ``counters`` [N, m] (ascending) of the admitted entry
    whose uniform is largest: a categorical whose admitted indices all lie
    among ``counters``."""
    r = np.where(admitted, uniform_rank(keys, counters).astype(np.int64), -1)
    return r.argmax(1)


def _join(label: np.ndarray, on: np.ndarray, r1: int, r2: int) -> np.ndarray:
    """Merge the components of rooms r1 and r2 in the rows ``on``."""
    a, b = label[:, r1:r1 + 1], label[:, r2:r2 + 1]
    lo = np.minimum(a, b)
    merge = on[:, None] & ((label == a) | (label == b))
    return np.where(merge, lo, label)


def _beside(m: np.ndarray) -> np.ndarray:
    """The cells next to a True cell (4-neighbourhood), not the cell."""
    out = np.zeros_like(m)
    out[:, 1:] |= m[:, :-1]
    out[:, :-1] |= m[:, 1:]
    out[:, :, 1:] |= m[:, :, :-1]
    out[:, :, :-1] |= m[:, :, 1:]
    return out
