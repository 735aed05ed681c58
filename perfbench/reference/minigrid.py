"""Plain NumPy reference of the MiniGrid semantics the benchmark's cells run.

Written from the published environment (Farama Minigrid's ``MiniGridEnv.step``,
``gen_obs_grid``, ``Grid.slice``/``rotate_left``/``process_vis``/``encode``)
and from the configuration's stated encoding and random stream, never from
the program: it imports nothing of the system under test.  Everything is
batched over a leading env dim B and written as plain loops over the view's
rows and columns, so that each line reads as the upstream code does.

Cells are packed words ``type | color << 8 | state << 16`` (int64 here), the
encoding the configuration states.  A state is a dict of NumPy arrays:

    grid int64[B, W, H], pos int64[B, 2], dir int64[B], carrying int64[B]
    (packed, EMPTY when the hands are free), step_count int64[B],
    max_steps int64[B] (0: the configuration's limit)

and, where a configuration has boxes, ``box`` int64[B, W, H] (the packed
contents of each cell's box) and ``carrying_box`` int64[B].

Random numbers are threefry2x32 as ``jax.random`` computes them with
``jax_threefry_partitionable`` on: the stream the configuration names as the
one its levels are drawn from.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

# -- the configuration's encoding ---------------------------------------------

EMPTY_T, WALL_T, DOOR_T = 1, 2, 4
KEY_T, BALL_T, BOX_T = 21, 22, 23
GOAL_T, LAVA_T = 31, 32
RED, GREEN, BLUE, PURPLE, YELLOW, GREY = 1, 2, 3, 4, 5, 6
OPEN, CLOSED, LOCKED = 0, 1, 2

LEFT, RIGHT, FORWARD, PICKUP, DROP, TOGGLE, DONE, STAY = range(8)
DIR_TO_VEC = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], dtype=np.int64)


def pack(t, c=0, s=0):
    return np.asarray(t, np.int64) | (np.asarray(c, np.int64) << 8) | (np.asarray(s, np.int64) << 16)


def cell_type(w):
    return w & 0xFF


def cell_color(w):
    return (w >> 8) & 0xFF


def cell_state(w):
    return (w >> 16) & 0xFF


EMPTY = int(pack(EMPTY_T))
WALL = int(pack(WALL_T, GREY))
GOAL = int(pack(GOAL_T, GREEN))


def can_overlap(w):
    """WorldObj.can_overlap: floorless empty cells, goal, lava, open doors."""
    t = cell_type(w)
    return ((t == EMPTY_T) | (t == GOAL_T) | (t == LAVA_T)
            | ((t == DOOR_T) & (cell_state(w) == OPEN)))


def can_pickup(w):
    t = cell_type(w)
    return (t == KEY_T) | (t == BALL_T) | (t == BOX_T)


def see_behind(w):
    """Walls block the view, doors unless open, nothing else does."""
    t = cell_type(w)
    return (t != WALL_T) & ((t != DOOR_T) | (cell_state(w) == OPEN))


# -- threefry2x32 and the jax.random calls the configurations draw with ------

_M = np.uint64(0xFFFFFFFF)


def _rotl(x, d):
    return ((x << np.uint64(d)) & _M) | (x >> np.uint64(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, on uint64 arrays holding 32-bit words."""
    k1, k2, x1, x2 = (np.asarray(a, np.uint64) for a in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ np.uint64(0x1BD11BDA))
    a = (x1 + ks[0]) & _M
    b = (x2 + ks[1]) & _M
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rot[i % 2]:
            a = (a + b) & _M
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M
        b = (b + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M
    return a, b


def _iota_hash(keys, shape):
    keys = np.asarray(keys, np.uint64)
    n = int(np.prod(shape)) if shape else 1
    ctr = np.arange(n, dtype=np.uint64).reshape(shape)
    ex = (...,) + (None,) * len(shape)
    return threefry2x32(keys[..., 0][ex], keys[..., 1][ex], np.zeros_like(ctr), ctr)


def split(keys, num=2):
    """``jax.random.split``: keys [..., 2] -> [..., num, 2]."""
    a, b = _iota_hash(keys, (num,))
    return np.stack([a, b], axis=-1)


def fold_in(keys, data):
    keys = np.asarray(keys, np.uint64)
    d = np.asarray(data, np.uint64)
    a, b = threefry2x32(keys[..., 0], keys[..., 1], np.zeros_like(d), d)
    return np.stack(np.broadcast_arrays(a, b), axis=-1)


def bits(keys, shape=()):
    a, b = _iota_hash(keys, tuple(shape))
    return a ^ b


def randint(keys, shape, lo, hi):
    """``jax.random.randint(key, shape, lo, hi, int32)`` for keys [..., 2];
    bounds broadcast against ``[..., *shape]``."""
    shape = tuple(shape)
    sub = split(keys)
    higher = bits(sub[..., 0, :], shape)
    lower = bits(sub[..., 1, :], shape)
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    span = np.where(hi <= lo, 1, (hi - lo) & 0xFFFFFFFF).astype(np.uint64)
    mult = (np.uint64(1 << 16) % span)
    mult = (mult * mult) % span
    off = (((higher % span) * mult + (lower % span)) & _M) % span
    out = (lo + off.astype(np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)
    return out.astype(np.int64)


# -- float32 rewards ----------------------------------------------------------

def f32_nearest(x: Fraction) -> np.float32:
    """The float32 nearest to the exact rational ``x``, ties to even."""
    guess = np.float32(float(x))
    cands = [np.nextafter(guess, np.float32(-np.inf)), guess,
             np.nextafter(guess, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.int32)) & 1))
    return np.float32(best)


def goal_reward(step_count: int, max_steps: int) -> np.float32:
    """``1 - 0.9 * (step_count / max_steps)`` as the configuration states it
    in float32: the quotient rounded to float32, then ``1 + (-0.9f) * q``
    rounded once (a fused multiply-add)."""
    q = np.float32(np.float32(step_count) / np.float32(max_steps))
    return f32_nearest(1 + Fraction(float(np.float32(-0.9))) * Fraction(float(q)))


def bf16(x) -> np.float32:
    """``x`` rounded to bfloat16 (8 bits of mantissa, to nearest even),
    held in a float32."""
    b = np.asarray(np.float32(x)).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return np.asarray(b.astype(np.uint32)).view(np.float32)[()]


def goal_reward_bf16(step_count: int, max_steps: int) -> np.float32:
    """The control: the same expression in bfloat16, the precision below
    the configuration's float32, every operation rounded to it."""
    q = bf16(bf16(step_count) / bf16(max_steps))
    return bf16(bf16(1) - bf16(bf16(0.9) * q))


# -- the transition -----------------------------------------------------------

def front_pos(pos, d):
    return pos + DIR_TO_VEC[d]


def step(state: dict, action: np.ndarray, limit: int, reward_fn=goal_reward) -> tuple:
    """MiniGridEnv.step over the batch: (new state, reward float32[B],
    terminated bool[B], truncated bool[B], outcome dict).  ``limit`` is the
    configuration's ``max_steps``, used where a state's own is 0."""
    b = action.shape[0]
    _, w, h = state["grid"].shape
    rows = np.arange(b)
    grid = state["grid"].copy()  # the front cell is written in place
    box = state.get("box")
    box = None if box is None else box.copy()
    pos, d, carrying = state["pos"], state["dir"], state["carrying"]
    carrying_box = state.get("carrying_box")
    step_count = state["step_count"] + 1
    max_steps = np.where(state["max_steps"] > 0, state["max_steps"], limit)

    fwd = front_pos(pos, d)
    fx, fy = fwd[:, 0], fwd[:, 1]
    inb = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    cx, cy = np.clip(fx, 0, w - 1), np.clip(fy, 0, h - 1)
    fcell = np.where(inb, grid[rows, cx, cy], WALL)
    fbox = box[rows, cx, cy] if box is not None else np.full(b, EMPTY)
    ftype = cell_type(fcell)
    hands_free = cell_type(carrying) == EMPTY_T

    a = action.astype(np.int64)
    d = np.where(a == LEFT, (d + 3) % 4, np.where(a == RIGHT, (d + 1) % 4, d))
    # forward: move where the front cell can be overlapped; the goal ends
    # the episode with its reward, lava ends it with none
    fwd_ok = (a == FORWARD) & inb & can_overlap(fcell)
    pos = np.where(fwd_ok[:, None], fwd, pos)
    hit_goal = (a == FORWARD) & (ftype == GOAL_T)
    terminated = hit_goal | ((a == FORWARD) & (ftype == LAVA_T))
    reward = np.zeros(b, np.float32)
    for i in np.nonzero(hit_goal)[0]:
        reward[i] = reward_fn(int(step_count[i]), int(max_steps[i]))
    # pickup: a key, ball or box in front, hands free
    picked = (a == PICKUP) & inb & can_pickup(fcell) & hands_free
    # drop: onto an empty front cell, something in hand
    dropped = (a == DROP) & inb & (ftype == EMPTY_T) & ~hands_free
    # toggle: a door's lock and hinge, a box opens into its contents
    tog = (a == TOGGLE) & inb
    tog_door = tog & (ftype == DOOR_T)
    tog_box = tog & (ftype == BOX_T)
    fstate = cell_state(fcell)
    has_key = (cell_type(carrying) == KEY_T) & (cell_color(carrying) == cell_color(fcell))
    door_state = np.where(fstate == LOCKED, np.where(has_key, OPEN, LOCKED), 1 - fstate)
    new_fcell = fcell
    new_fcell = np.where(picked, EMPTY, new_fcell)
    new_fcell = np.where(dropped, carrying, new_fcell)
    new_fcell = np.where(tog_door, pack(DOOR_T, cell_color(fcell), door_state), new_fcell)
    new_fcell = np.where(tog_box, fbox, new_fcell)
    new_fbox = np.where(picked | tog_box, EMPTY, fbox)
    if carrying_box is not None:
        new_fbox = np.where(dropped, carrying_box, new_fbox)
        carrying_box = np.where(picked, fbox, np.where(dropped, EMPTY, carrying_box))
    carrying = np.where(picked, fcell, np.where(dropped, EMPTY, carrying))
    # DONE and STAY change nothing
    grid[rows[inb], cx[inb], cy[inb]] = new_fcell[inb]
    if box is not None:
        box[rows[inb], cx[inb], cy[inb]] = new_fbox[inb]
    truncated = step_count >= max_steps
    out = {**state, "grid": grid, "pos": pos, "dir": d, "carrying": carrying,
           "step_count": step_count}
    if box is not None:
        out["box"] = box
        out["carrying_box"] = carrying_box
    outcome = {"fwd": fwd, "picked": picked, "dropped": dropped}
    return out, reward, terminated, truncated, outcome


# -- the observation ----------------------------------------------------------

def _view_offsets(v: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """For each direction, the world offset from the agent of every cell of
    the rotated view [i, j]: ``Grid.slice`` at the view's top corner, then
    ``rotate_left`` (dir + 1) times (``np.rot90(a, -1)`` on [x, y] arrays)."""
    half = v // 2
    tops = {0: (0, -half), 1: (-half, 0), 2: (-v + 1, -half), 3: (-half, -v + 1)}
    out = []
    for d in range(4):
        tx, ty = tops[d]
        ii, jj = np.meshgrid(np.arange(v), np.arange(v), indexing="ij")
        ox, oy = tx + ii, ty + jj
        for _ in range(d + 1):
            ox, oy = np.rot90(ox, -1), np.rot90(oy, -1)
        out.append((ox.copy(), oy.copy()))
    return out


def process_vis(cells: np.ndarray) -> np.ndarray:
    """Grid.process_vis over a batch of rotated views [B, V, V], the agent
    at (V // 2, V - 1): the upstream loops, B-wide."""
    b, v, _ = cells.shape
    mask = np.zeros((b, v, v), bool)
    mask[:, v // 2, v - 1] = True
    clear = see_behind(cells)
    for j in reversed(range(v)):
        for i in range(v - 1):
            go = mask[:, i, j] & clear[:, i, j]
            mask[:, i + 1, j] |= go
            if j > 0:
                mask[:, i + 1, j - 1] |= go
                mask[:, i, j - 1] |= go
        for i in reversed(range(1, v)):
            go = mask[:, i, j] & clear[:, i, j]
            mask[:, i - 1, j] |= go
            if j > 0:
                mask[:, i - 1, j - 1] |= go
                mask[:, i, j - 1] |= go
    return mask


def view_cells(grid, pos, d, v: int) -> np.ndarray:
    """The rotated V x V window of every env, packed; outside the grid a
    grey wall."""
    b, w, h = grid.shape
    out = np.empty((b, v, v), np.int64)
    for k, (ox, oy) in enumerate(_view_offsets(v)):
        sel = np.nonzero(d == k)[0]
        if sel.size == 0:
            continue
        wx = pos[sel, 0, None, None] + ox
        wy = pos[sel, 1, None, None] + oy
        inb = (wx >= 0) & (wx < w) & (wy >= 0) & (wy < h)
        cells = grid[sel[:, None, None], np.clip(wx, 0, w - 1), np.clip(wy, 0, h - 1)]
        out[sel] = np.where(inb, cells, WALL)
    return out


def encode(cells, mask) -> np.ndarray:
    """Grid.encode(vis_mask): uint8[B, V, V, 3], unseen cells (0, 0, 0)."""
    w = np.where(mask, cells, 0)
    return np.stack([cell_type(w), cell_color(w), cell_state(w)], -1).astype(np.uint8)


def observe(state: dict, v: int, overlay_first: bool = False) -> np.ndarray:
    """gen_obs's image: slice, rotate, occlusion, the carried object at the
    agent's cell (empty hands: an empty cell), encode.  ``overlay_first``
    writes the carried object before the occlusion pass, as the fused
    engine's configuration states; the agent's own cell is always seen, and
    nothing it can carry blocks the view, so both orders give one image."""
    cells = view_cells(state["grid"], state["pos"], state["dir"], v)
    if overlay_first:
        cells[:, v // 2, v - 1] = state["carrying"]
    mask = process_vis(cells)
    cells[:, v // 2, v - 1] = state["carrying"]
    return encode(cells, mask)


# -- DoorKey's level generator --------------------------------------------------

def doorkey_generate(keys: np.ndarray, size: int) -> dict:
    """DoorKey's levels from keys [N, 2] as the configuration draws them:
    ``split(key, 5)`` into the wall column, the two cells, the direction,
    the door row and the state's stream; the wall column uniform in
    [2, size - 2), the agent and the key on two distinct uniform cells left
    of it, the locked yellow door at a uniform row of the wall."""
    n = keys.shape[0]
    w = h = size
    k = split(keys, 5)
    split_x = randint(k[:, 0], (), 2, w - 2)
    rows = h - 2
    nfree = (split_x - 1) * rows
    k1, k2 = split(k[:, 1], 2)[:, 0], split(k[:, 1], 2)[:, 1]
    r1 = randint(k1, (), 0, nfree)
    r2 = randint(k2, (), 0, nfree - 1)
    d = randint(k[:, 2], (), 0, 4)
    door_y = randint(k[:, 3], (), 1, w - 2)
    r2 = r2 + (r2 >= r1)
    grid = np.full((n, w, h), EMPTY, np.int64)
    grid[:, 0, :] = grid[:, -1, :] = grid[:, :, 0] = grid[:, :, -1] = WALL
    grid[:, w - 2, h - 2] = GOAL
    rr = np.arange(n)
    grid[rr[:, None], split_x[:, None], np.arange(h)[None, :]] = WALL
    grid[rr, split_x, door_y] = pack(DOOR_T, YELLOW, LOCKED)
    grid[rr, 1 + r2 // rows, 1 + r2 % rows] = pack(KEY_T, YELLOW)
    return {
        "grid": grid,
        "pos": np.stack([1 + r1 // rows, 1 + r1 % rows], 1),
        "dir": d,
        "carrying": np.full(n, EMPTY, np.int64),
        "step_count": np.zeros(n, np.int64),
        "max_steps": np.zeros(n, np.int64),
        "rng": k[:, 4].astype(np.int64),
    }
