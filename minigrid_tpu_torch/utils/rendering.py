"""Host-side tile rasterizer (numpy, vectorized).

Produces the exact pixel output of the reference CPU rasterizer
(``minigrid/utils/rendering.py``), but evaluates every shape predicate on a
whole coordinate grid at once instead of per-pixel Python loops: pixel (y, x)
samples at ((x+0.5)/W, (y+0.5)/H) (rendering.py:30-35), tiles render at
3× supersampling then mean-pool down (rendering.py:8-22), and the per-object
painters reproduce each ``WorldObj.render`` (world_object.py:154-679).

This module runs ONCE per tile size to build the texture atlas in
:mod:`minigrid_tpu_torch.ops.render`; it is never on the device hot path.
The port's own copy of ``minigrid_tpu/utils/rendering.py``, painter for
painter, so the two atlases are byte-equal.
"""

from __future__ import annotations

import math

import numpy as np

from minigrid_tpu_torch.core import constants as C

# ---------------------------------------------------------------------------
# vectorized predicate combinators — each returns a bool mask (H, W)
# ---------------------------------------------------------------------------


def _grid_coords(h: int, w: int):
    y = (np.arange(h)[:, None] + 0.5) / h
    x = (np.arange(w)[None, :] + 0.5) / w
    return np.broadcast_to(x, (h, w)), np.broadcast_to(y, (h, w))


def fill(img: np.ndarray, mask_fn, color) -> np.ndarray:
    """fill_coords (rendering.py:25-37) over a whole pixel grid."""
    xf, yf = _grid_coords(img.shape[0], img.shape[1])
    img[mask_fn(xf, yf)] = color
    return img


def rect(xmin, xmax, ymin, ymax):
    def fn(x, y):
        return (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)

    return fn


def circle(cx, cy, r):
    def fn(x, y):
        return (x - cx) ** 2 + (y - cy) ** 2 <= r * r

    return fn


def oval(cx, cy, rx, ry):
    def fn(x, y):
        return ((x - cx) ** 2) * ry * ry + ((y - cy) ** 2) * rx * rx <= (rx * ry) ** 2

    return fn


def line(x0, y0, x1, y1, r):
    """Capsule around a segment (rendering.py:53-81)."""
    p0 = np.array([x0, y0])
    d = np.array([x1 - x0, y1 - y0], dtype=np.float64)
    dist = float(np.hypot(*d))
    d = d / dist

    def fn(x, y):
        pqx, pqy = x - p0[0], y - p0[1]
        a = np.clip(pqx * d[0] + pqy * d[1], 0, dist)
        px, py = p0[0] + a * d[0], p0[1] + a * d[1]
        return (x - px) ** 2 + (y - py) ** 2 <= r * r

    return fn


def triangle(a, b, c):
    a, b, c = (np.asarray(p, dtype=np.float64) for p in (a, b, c))
    v0, v1 = c - a, b - a
    dot00, dot01, dot11 = v0 @ v0, v0 @ v1, v1 @ v1
    inv = 1.0 / (dot00 * dot11 - dot01 * dot01)

    def fn(x, y):
        v2x, v2y = x - a[0], y - a[1]
        dot02 = v0[0] * v2x + v0[1] * v2y
        dot12 = v1[0] * v2x + v1[1] * v2y
        u = (dot11 * dot02 - dot01 * dot12) * inv
        v = (dot00 * dot12 - dot01 * dot02) * inv
        return (u >= 0) & (v >= 0) & (u + v < 1)

    return fn


def rotate(fin, cx, cy, theta):
    """rotate_fn (rendering.py:40-50)."""
    cos_t, sin_t = math.cos(-theta), math.sin(-theta)

    def fout(x, y):
        dx, dy = x - cx, y - cy
        return fin(cx + dx * cos_t - dy * sin_t, cy + dy * cos_t + dx * sin_t)

    return fout


def downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Mean-pool (rendering.py:8-22); returns float like the reference."""
    h, w = img.shape[0] // factor, img.shape[1] // factor
    return img.reshape(h, factor, w, factor, 3).mean(axis=3).mean(axis=1)


def highlight(img: np.ndarray, color=(255, 255, 255), alpha=0.30) -> None:
    """highlight_img (rendering.py:131-139), in place on uint8."""
    blend = img + alpha * (np.asarray(color, dtype=np.uint8) - img)
    img[:, :, :] = blend.clip(0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# per-object painters — one per WorldObj.render implementation
# ---------------------------------------------------------------------------

_T = C.OBJECT_TO_IDX


def paint_object(img: np.ndarray, type_idx: int, color_idx: int, state: int):
    """Draw object `type_idx` with color/state onto a supersampled tile."""
    c = C.COLORS[C.IDX_TO_COLOR[color_idx]] if color_idx in C.IDX_TO_COLOR else (
        np.zeros(3, np.uint8))
    t = type_idx
    if t in (_T["unseen"], _T["empty"], _T["agent"]):
        return
    if t == _T["wall"]:  # world_object.py:213-214
        fill(img, rect(0, 1, 0, 1), c)
    elif t == _T["floor"]:  # world_object.py:178-181
        fill(img, rect(0.031, 1, 0.031, 1), c // 2)
    elif t == _T["goal"]:  # world_object.py:165-166
        fill(img, rect(0, 1, 0, 1), c)
    elif t == _T["lava"]:  # world_object.py:191-204
        fill(img, rect(0, 1, 0, 1), (255, 128, 0))
        for i in range(3):
            ylo, yhi = 0.3 + 0.2 * i, 0.4 + 0.2 * i
            fill(img, line(0.1, ylo, 0.3, yhi, r=0.03), (0, 0, 0))
            fill(img, line(0.3, yhi, 0.5, ylo, r=0.03), (0, 0, 0))
            fill(img, line(0.5, ylo, 0.7, yhi, r=0.03), (0, 0, 0))
            fill(img, line(0.7, yhi, 0.9, ylo, r=0.03), (0, 0, 0))
    elif t == _T["door"]:  # world_object.py:254-276
        if state == C.STATE_TO_IDX["open"]:
            fill(img, rect(0.88, 1.00, 0.00, 1.00), c)
            fill(img, rect(0.92, 0.96, 0.04, 0.96), (0, 0, 0))
        elif state == C.STATE_TO_IDX["locked"]:
            fill(img, rect(0.00, 1.00, 0.00, 1.00), c)
            fill(img, rect(0.06, 0.94, 0.06, 0.94), 0.45 * np.asarray(c))
            fill(img, rect(0.52, 0.75, 0.50, 0.56), c)
        else:
            fill(img, rect(0.00, 1.00, 0.00, 1.00), c)
            fill(img, rect(0.04, 0.96, 0.04, 0.96), (0, 0, 0))
            fill(img, rect(0.08, 0.92, 0.08, 0.92), c)
            fill(img, rect(0.12, 0.88, 0.12, 0.88), (0, 0, 0))
            fill(img, circle(0.75, 0.50, 0.08), c)
    elif t == _T["square"]:  # world_object.py:286-289
        fill(img, rect(0.2, 0.8, 0.2, 0.8), c)
    elif t == _T["circle"]:  # world_object.py:298-299
        fill(img, circle(0.5, 0.5, 0.31), c)
    elif t == _T["oval"]:  # world_object.py:308-309
        fill(img, oval(0.5, 0.5, 0.4, 0.2), c)
    elif t == _T["line"]:  # world_object.py:318-319
        fill(img, rect(0.1, 0.9, 0.45, 0.55), c)
    elif t == _T["rectangle"]:  # world_object.py:328-329
        fill(img, rect(0.3, 0.7, 0.1, 0.9), c)
    elif t == _T["diamond"]:  # world_object.py:338-340
        fill(img, triangle((0.5, 0.25), (0.5, 0.75), (0.85, 0.5)), c)
        fill(img, triangle((0.5, 0.25), (0.5, 0.75), (0.15, 0.5)), c)
    elif t == _T["ring"]:  # world_object.py:349-351
        fill(img, circle(0.5, 0.5, 0.31), c)
        fill(img, circle(0.5, 0.5, 0.15), (0, 0, 0))
    elif t == _T["star"]:  # world_object.py:360-362
        fill(img, triangle((0.15, 0.3), (0.85, 0.3), (0.5, 0.9)), c)
        fill(img, triangle((0.15, 0.7), (0.85, 0.7), (0.5, 0.1)), c)
    elif t == _T["cross"]:  # world_object.py:371-373
        fill(img, rect(0.4, 0.6, 0.1, 0.9), c)
        fill(img, rect(0.1, 0.9, 0.4, 0.6), c)
    elif t == _T["arrow"]:  # world_object.py:382-384
        fill(img, rect(0.1, 0.6, 0.4, 0.6), c)
        fill(img, triangle((0.6, 0.25), (0.9, 0.5), (0.6, 0.75)), c)
    elif t == _T["key"]:  # world_object.py:395-407
        fill(img, rect(0.50, 0.63, 0.31, 0.88), c)
        fill(img, rect(0.38, 0.50, 0.59, 0.66), c)
        fill(img, rect(0.38, 0.50, 0.81, 0.88), c)
        fill(img, circle(0.56, 0.28, 0.190), c)
        fill(img, circle(0.56, 0.28, 0.064), (0, 0, 0))
    elif t == _T["ball"]:  # world_object.py:416-420
        fill(img, circle(0.5, 0.5, 0.31), c)
        fill(img, rect(0.19, 0.81, 0.45, 0.55), (0, 0, 0))
        fill(img, rect(0.45, 0.55, 0.19, 0.81), (0, 0, 0))
    elif t == _T["box"]:  # world_object.py:430-438
        fill(img, rect(0.12, 0.88, 0.12, 0.88), c)
        fill(img, rect(0.18, 0.82, 0.18, 0.82), (0, 0, 0))
        fill(img, rect(0.16, 0.84, 0.47, 0.53), c)
    elif t == _T["block"]:  # world_object.py:452-455
        fill(img, rect(0, 1, 0, 1), c)
    elif t == _T["gripped_block"]:  # world_object.py:476-483 — the reference
        # fills the border with the *integer* COLOR_TO_IDX['grey'] == 6,
        # i.e. near-black (6, 6, 6); reproduced as-is.
        fill(img, rect(0, 1, 0, 1), c)
        g6 = (6, 6, 6)
        fill(img, rect(0, 0.1, 0, 1), g6)
        fill(img, rect(0.9, 1, 0, 1), g6)
        fill(img, rect(0, 1, 0, 0.1), g6)
        fill(img, rect(0, 1, 0.9, 1), g6)
    elif t == _T["tree"]:  # world_object.py:492-499
        fill(img, rect(0.4, 0.6, 0.8, 0.9), c)
        fill(img, triangle((0.1, 0.8), (0.9, 0.8), (0.5, 0.5)), c)
        fill(img, triangle((0.2, 0.6), (0.8, 0.6), (0.5, 0.3)), c)
        fill(img, triangle((0.3, 0.4), (0.7, 0.4), (0.5, 0.1)), c)
    elif t == _T["cup"]:  # world_object.py:508-514
        fill(img, circle(0.7, 0.5, 0.2), c)
        fill(img, circle(0.7, 0.5, 0.1), (0, 0, 0))
        fill(img, rect(0.15, 0.7, 0.2, 0.8), c)
    elif t == _T["tool"]:  # world_object.py:523-528
        fill(img, rect(0.45, 0.55, 0.15, 0.85), c)
        fill(img, rect(0.25, 0.75, 0.15, 0.45), c)
    elif t == _T["building"]:  # world_object.py:537-544
        fill(img, rect(0.2, 0.8, 0.5, 0.8), c)
        fill(img, rect(0.45, 0.55, 0.6, 0.8), (0, 0, 0))
        fill(img, triangle((0.1, 0.5), (0.9, 0.5), (0.5, 0.1)), c)
    elif t == _T["crate"]:  # world_object.py:554-563
        fill(img, rect(0.1, 0.9, 0.1, 0.9), c)
        for lo in (0.15, 0.30, 0.45, 0.60, 0.75):
            fill(img, rect(lo, lo + 0.10, 0.15, 0.85), (0, 0, 0))
    elif t == _T["chair"]:  # world_object.py:572-579
        fill(img, rect(0.2, 0.3, 0.15, 0.85), c)
        fill(img, rect(0.2, 0.8, 0.45, 0.55), c)
        fill(img, rect(0.7, 0.8, 0.5, 0.85), c)
    elif t == _T["flower"]:  # world_object.py:588-600
        fill(img, rect(0.47, 0.53, 0.5, 0.85), c)
        fill(img, circle(0.5, 0.3, 0.05), c)
        for px, py in ((0.66, 0.3), (0.58, 0.16), (0.42, 0.16), (0.34, 0.3),
                       (0.42, 0.44), (0.58, 0.44)):
            fill(img, circle(px, py, 0.07), c)
    elif t == _T["north"]:  # world_object.py:610-620
        fill(img, rect(0.2, 0.3, 0.2, 0.8), c)
        fill(img, rect(0.7, 0.8, 0.2, 0.8), c)
        fill(img, rect(0.6, 0.7, 0.65, 0.8), c)
        fill(img, rect(0.5, 0.6, 0.5, 0.65), c)
        fill(img, rect(0.4, 0.5, 0.35, 0.5), c)
        fill(img, rect(0.3, 0.4, 0.2, 0.35), c)
    elif t == _T["east"]:  # world_object.py:629-638
        fill(img, rect(0.2, 0.3, 0.2, 0.8), c)
        fill(img, rect(0.2, 0.8, 0.7, 0.8), c)
        fill(img, rect(0.2, 0.5, 0.45, 0.55), c)
        fill(img, rect(0.2, 0.8, 0.2, 0.3), c)
    elif t == _T["south"]:  # world_object.py:647-658
        fill(img, rect(0.2, 0.8, 0.7, 0.8), c)
        fill(img, rect(0.2, 0.3, 0.3, 0.55), c)
        fill(img, rect(0.2, 0.8, 0.45, 0.55), c)
        fill(img, rect(0.7, 0.8, 0.45, 0.7), c)
        fill(img, rect(0.2, 0.8, 0.2, 0.3), c)
    elif t == _T["west"]:  # world_object.py:667-678
        fill(img, rect(0.2, 0.3, 0.2, 0.8), c)
        fill(img, rect(0.7, 0.8, 0.2, 0.8), c)
        fill(img, rect(0.30, 0.38, 0.6, 0.75), c)
        fill(img, rect(0.38, 0.46, 0.5, 0.65), c)
        fill(img, rect(0.46, 0.54, 0.4, 0.55), c)
        fill(img, rect(0.54, 0.62, 0.5, 0.65), c)
        fill(img, rect(0.62, 0.70, 0.6, 0.75), c)
    else:
        raise ValueError(f"no painter for object type {t}")


def render_tile(type_idx: int, color_idx: int, state: int,
                agent_dir: int | None = None, highlight_tile: bool = False,
                tile_size: int = C.TILE_PIXELS, subdivs: int = 3) -> np.ndarray:
    """One tile, exactly Grid.render_tile's pipeline (grid.py:145-198):
    grid lines, object, agent triangle, highlight, 3× downsample."""
    img = np.zeros((tile_size * subdivs, tile_size * subdivs, 3), dtype=np.uint8)
    fill(img, rect(0, 0.031, 0, 1), (100, 100, 100))
    fill(img, rect(0, 1, 0, 0.031), (100, 100, 100))
    paint_object(img, type_idx, color_idx, state)
    if agent_dir is not None:
        tri = triangle((0.12, 0.19), (0.87, 0.50), (0.12, 0.81))
        tri = rotate(tri, 0.5, 0.5, 0.5 * math.pi * agent_dir)
        fill(img, tri, (255, 0, 0))
    if highlight_tile:
        highlight(img)
    return downsample(img, subdivs).astype(np.uint8)
