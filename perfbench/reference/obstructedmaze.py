"""Plain NumPy reference of ObstructedMaze's door placement (Minigrid's
``minigrid/envs/obstructedmaze.py``: ``ObstructedMazeEnv._gen_grid`` and
``ObstructedMazeEnv.add_door``, on ``RoomGrid.add_door`` and
``RoomGrid.place_in_room``) as the configuration draws it.

A builder here is ``roomgrid.py``'s (``grid``, ``door_pos``, ``has_door``)
plus the agent's ``pos`` and ``dir`` (RoomGrid's start in the middle of the
grid, facing right, until the agent is placed), the ``box`` plane (the
packed contents of each cell's box) and the door palette ``door_colors``
int64[N, 10].

The fixed colors are the first three of the sorted color names: the ball to
find blue, the blocking balls brown, the boxes that hide keys cyan.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import minigrid as M
from perfbench.reference.roomgrid import SORTED_COLORS, Lattice, permutation, sample_cell

BLUE, BROWN, CYAN = (int(c) for c in SORTED_COLORS[:3])
# a door side's neighbouring room: right, down, left, up
SIDE_STEP = ((1, 0), (0, 1), (-1, 0), (0, -1))


def init_rooms(lat: Lattice, keys: np.ndarray) -> dict:
    """The rooms, the agent at RoomGrid's start, an empty box plane, and the
    door palette: ``(k_rooms, k_palette) = split(key)``, the ten colors in
    the order of ``permutation(k_palette, 10)``."""
    n = keys.shape[0]
    k = M.split(keys)
    b = lat.init_rooms(k[:, 0])
    mid = (lat.cols // 2) * (lat.s - 1) + lat.s // 2, (lat.rows // 2) * (lat.s - 1) + lat.s // 2
    b["pos"] = np.broadcast_to(np.array(mid, np.int64), (n, 2)).copy()
    b["dir"] = np.zeros(n, np.int64)
    b["box"] = np.full((n, lat.w, lat.h), M.EMPTY, np.int64)
    b["door_colors"] = SORTED_COLORS[permutation(k[:, 1], 10)]
    return b


def wall_between(lat: Lattice, i: int, j: int, side: int) -> int:
    """The index in ``lat.walls`` of the wall on ``side`` of room (i, j)."""
    di, dj = SIDE_STEP[side]
    pair = sorted((j * lat.cols + i, (j + dj) * lat.cols + i + di))
    return next(w for w, (rooms, _, _) in enumerate(lat.walls) if list(rooms) == pair)


def add_door(lat: Lattice, b: dict, i: int, j: int, side: int, color: np.ndarray,
             locked: bool) -> tuple[dict, np.ndarray]:
    """RoomGrid.add_door with the side, color and lock given: the wall's
    door slot becomes the door.  Returns (builder, the door's cell [N, 2])."""
    w = wall_between(lat, i, j, side)
    pos = b["door_pos"][:, w]
    rr = np.arange(pos.shape[0])
    grid = b["grid"].copy()
    grid[rr, pos[:, 0], pos[:, 1]] = M.pack(M.DOOR_T, color, M.LOCKED if locked else M.CLOSED)
    has = b["has_door"].copy()
    has[:, w] = True
    return {**b, "grid": grid, "has_door": has}, pos


def place_in_room(lat: Lattice, b: dict, keys: np.ndarray, i, j) -> tuple[np.ndarray, np.ndarray]:
    """RoomGrid.place_in_room's cell: uniform among the room's empty cells
    at manhattan distance 2 or more from the agent.  (pos [N, 2], ok [N])."""
    n = keys.shape[0]
    px, py = b["pos"][:, 0, None, None], b["pos"][:, 1, None, None]
    near = np.abs(lat.xs - px) + np.abs(lat.ys - py) < 2
    room = lat.room_mask(np.broadcast_to(i, (n,)), np.broadcast_to(j, (n,)))
    free = (M.cell_type(b["grid"]) == M.EMPTY_T) & room & ~near
    return sample_cell(keys, free)


def add_locked_door(lat: Lattice, b: dict, keys: np.ndarray, i: int, j: int, side: int,
                    color: np.ndarray, key_in_box: bool, blocked: bool) -> tuple[dict, np.ndarray]:
    """ObstructedMazeEnv.add_door of a locked door: ``(_, k_key) =
    split(key)``; the door; with ``blocked`` a brown ball on room (i, j)'s
    side of it (written over whatever is there); its key in room (i, j),
    inside a cyan box with ``key_in_box``.  Returns (builder, ok [N]: the
    key found a cell)."""
    k_key = M.split(keys)[:, 1]
    b, door = add_door(lat, b, i, j, side, color, locked=True)
    rr = np.arange(keys.shape[0])
    grid = b["grid"].copy()
    if blocked:
        dx, dy = M.DIR_TO_VEC[side]
        grid[rr, door[:, 0] - dx, door[:, 1] - dy] = M.pack(M.BALL_T, BROWN)
    b = {**b, "grid": grid}
    pos, ok = place_in_room(lat, b, k_key, i, j)
    key = M.pack(M.KEY_T, color)
    grid = b["grid"].copy()
    if key_in_box:
        box = b["box"].copy()
        grid[rr[ok], pos[ok, 0], pos[ok, 1]] = M.pack(M.BOX_T, CYAN)
        box[rr[ok], pos[ok, 0], pos[ok, 1]] = key[ok]
        b = {**b, "box": box}
    else:
        grid[rr[ok], pos[ok, 0], pos[ok, 1]] = key[ok]
    return {**b, "grid": grid}, ok
