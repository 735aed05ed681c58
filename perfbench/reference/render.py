"""Plain NumPy reference of the agent's RGB view, as ``RGBImgPartialObsWrapper``
serves it: Minigrid's ``MiniGridEnv.get_pov_render`` (the view of
``gen_obs_grid``, invisible cells set to nothing by ``Grid.process_vis``,
the carried object at the agent's cell, drawn by ``Grid.render`` with the
agent at the bottom centre facing up), ``Grid.render_tile`` at 3
subdivisions, the ``render`` of the objects DoorKey shows, and
``minigrid/utils/rendering.py``'s ``fill_coords``, ``point_in_*``,
``rotate_fn`` and ``downsample``.

Written pixel by pixel as the upstream code is, from the configuration's
encoding (``minigrid.py``), never from the program.  The view draws no
highlight, as the JAX package's ``pov_render`` draws none.  Tiles are kept
per (cell, agent direction, tile size), as ``Grid.render_tile``'s cache
keeps them.
"""

from __future__ import annotations

import math

import numpy as np

from perfbench.reference import minigrid as M

SUBDIVS = 3
# RGB of the configuration's color ids (red 1 .. orange 10)
COLORS = {
    1: (255, 0, 0), 2: (0, 255, 0), 3: (0, 0, 255), 4: (112, 39, 195), 5: (255, 255, 0),
    6: (100, 100, 100), 7: (255, 255, 255), 8: (0, 255, 255), 9: (139, 69, 19),
    10: (255, 99, 71),
}


# -- minigrid/utils/rendering.py ------------------------------------------------

def downsample(img: np.ndarray, factor: int) -> np.ndarray:
    img = img.reshape([img.shape[0] // factor, factor, img.shape[1] // factor, factor, 3])
    img = img.mean(axis=3)
    return img.mean(axis=1)


def fill_coords(img: np.ndarray, fn, color) -> np.ndarray:
    """Fill the pixels whose centre, scaled to [0, 1], satisfies ``fn``."""
    for y in range(img.shape[0]):
        for x in range(img.shape[1]):
            yf = (y + 0.5) / img.shape[0]
            xf = (x + 0.5) / img.shape[1]
            if fn(xf, yf):
                img[y, x] = color
    return img


def rotate_fn(fin, cx, cy, theta):
    def fout(x, y):
        x = x - cx
        y = y - cy
        x2 = cx + x * math.cos(-theta) - y * math.sin(-theta)
        y2 = cy + y * math.cos(-theta) + x * math.sin(-theta)
        return fin(x2, y2)

    return fout


def point_in_circle(cx, cy, r):
    def fn(x, y):
        return (x - cx) * (x - cx) + (y - cy) * (y - cy) <= r * r

    return fn


def point_in_rect(xmin, xmax, ymin, ymax):
    def fn(x, y):
        return xmin <= x <= xmax and ymin <= y <= ymax

    return fn


def point_in_triangle(a, b, c):
    a = np.array(a, dtype=np.float32)
    b = np.array(b, dtype=np.float32)
    c = np.array(c, dtype=np.float32)

    def fn(x, y):
        v0 = c - a
        v1 = b - a
        v2 = np.array((x, y)) - a
        dot00 = np.dot(v0, v0)
        dot01 = np.dot(v0, v1)
        dot02 = np.dot(v0, v2)
        dot11 = np.dot(v1, v1)
        dot12 = np.dot(v1, v2)
        inv_denom = 1 / (dot00 * dot11 - dot01 * dot01)
        u = (dot11 * dot02 - dot01 * dot12) * inv_denom
        v = (dot00 * dot12 - dot01 * dot02) * inv_denom
        return (u >= 0) and (v >= 0) and (u + v) < 1

    return fn


# -- WorldObj.render of DoorKey's objects -----------------------------------------

def render_object(img: np.ndarray, word: int) -> None:
    """Draw the packed cell ``word`` on a supersampled tile: nothing for an
    empty cell; walls, goals, doors and keys as their ``render``."""
    t, state = int(M.cell_type(word)), int(M.cell_state(word))
    if t == M.EMPTY_T:
        return
    c = np.array(COLORS[int(M.cell_color(word))], dtype=np.uint8)
    if t in (M.WALL_T, M.GOAL_T):
        fill_coords(img, point_in_rect(0, 1, 0, 1), c)
    elif t == M.DOOR_T:
        if state == M.OPEN:
            fill_coords(img, point_in_rect(0.88, 1.00, 0.00, 1.00), c)
            fill_coords(img, point_in_rect(0.92, 0.96, 0.04, 0.96), (0, 0, 0))
        elif state == M.LOCKED:
            fill_coords(img, point_in_rect(0.00, 1.00, 0.00, 1.00), c)
            fill_coords(img, point_in_rect(0.06, 0.94, 0.06, 0.94), 0.45 * np.array(c))
            # the key slot
            fill_coords(img, point_in_rect(0.52, 0.75, 0.50, 0.56), c)
        else:
            fill_coords(img, point_in_rect(0.00, 1.00, 0.00, 1.00), c)
            fill_coords(img, point_in_rect(0.04, 0.96, 0.04, 0.96), (0, 0, 0))
            fill_coords(img, point_in_rect(0.08, 0.92, 0.08, 0.92), c)
            fill_coords(img, point_in_rect(0.12, 0.88, 0.12, 0.88), (0, 0, 0))
            # the handle
            fill_coords(img, point_in_circle(cx=0.75, cy=0.50, r=0.08), c)
    elif t == M.KEY_T:
        # the shaft, the teeth, the ring
        fill_coords(img, point_in_rect(0.50, 0.63, 0.31, 0.88), c)
        fill_coords(img, point_in_rect(0.38, 0.50, 0.59, 0.66), c)
        fill_coords(img, point_in_rect(0.38, 0.50, 0.81, 0.88), c)
        fill_coords(img, point_in_circle(cx=0.56, cy=0.28, r=0.190), c)
        fill_coords(img, point_in_circle(cx=0.56, cy=0.28, r=0.064), (0, 0, 0))
    else:
        raise ValueError(f"no painter for cell type {t}")


# -- Grid.render_tile and get_pov_render ---------------------------------------------

_tiles: dict[tuple, np.ndarray] = {}


def render_tile(word: int, agent_dir: int | None, tile_size: int) -> np.ndarray:
    """One cell's tile, float [T, T, 3] as ``downsample`` leaves it: the grid
    lines, the object, the agent's triangle over it."""
    key = (word, agent_dir, tile_size)
    if key in _tiles:
        return _tiles[key]
    img = np.zeros((tile_size * SUBDIVS, tile_size * SUBDIVS, 3), dtype=np.uint8)
    # the grid lines (top and left edges)
    fill_coords(img, point_in_rect(0, 0.031, 0, 1), (100, 100, 100))
    fill_coords(img, point_in_rect(0, 1, 0, 0.031), (100, 100, 100))
    render_object(img, word)
    if agent_dir is not None:
        tri_fn = point_in_triangle((0.12, 0.19), (0.87, 0.50), (0.12, 0.81))
        tri_fn = rotate_fn(tri_fn, cx=0.5, cy=0.5, theta=0.5 * math.pi * agent_dir)
        fill_coords(img, tri_fn, (255, 0, 0))
    img = downsample(img, SUBDIVS)
    _tiles[key] = img
    return img


def pov_cells(level: dict, v: int) -> np.ndarray:
    """The packed cells of every env's view [B, V, V] ([x, y]) as
    ``get_pov_render`` draws them: the rotated window, invisible cells
    empty, the carried object (or nothing) at the agent's cell."""
    cells = M.view_cells(level["grid"], level["pos"], level["dir"], v)
    cells = np.where(M.process_vis(cells), cells, M.EMPTY)
    cells[:, v // 2, v - 1] = level["carrying"]
    return cells


def pov_frames(level: dict, v: int, tile_size: int) -> np.ndarray:
    """``get_pov_render`` of every env: uint8[B, V T, V T, 3], rows y,
    the agent at (V // 2, V - 1) facing up (direction 3)."""
    cells = pov_cells(level, v)
    b = cells.shape[0]
    at_agent = np.zeros(cells.shape, bool)
    at_agent[:, v // 2, v - 1] = True
    ids, where = np.unique(np.stack([cells, at_agent], -1).reshape(-1, 2), axis=0,
                           return_inverse=True)
    tiles = np.stack([render_tile(int(w), 3 if a else None, tile_size) for w, a in ids])
    frames = tiles.astype(np.uint8)[where.reshape(cells.shape)]  # [B, x, y, T, T, 3]
    return frames.transpose(0, 2, 3, 1, 4, 5).reshape(b, v * tile_size, v * tile_size, 3)
