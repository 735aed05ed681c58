"""Plain NumPy reference of the fused engine's step, as its configuration
states it: the MiniGrid transition of a box-free env, the goal reward as
``fma(count, -K, 1)`` with ``K = f32(f32(0.9) * f32(1 / max_steps))``, a
per-step key ``(next, sub) = split(key)`` and draws ``randint(sub, (N, 8),
0, 2^24)`` from which every finished env's new DoorKey level is built in
closed form, then the observation of the new state.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from perfbench.reference import minigrid as M

DRAW_COLUMNS = 8
DRAW_SPAN = 1 << 24


def reward_factor(max_steps: int) -> np.float32:
    return np.float32(np.float32(0.9) * np.float32(1 / max_steps))


def fused_reward(step_count: int, max_steps: int) -> np.float32:
    c = Fraction(float(np.float32(step_count)))
    return M.f32_nearest(1 - c * Fraction(float(reward_factor(max_steps))))


def fused_reward_bf16(step_count: int, max_steps: int) -> np.float32:
    """The control: the fused reward in bfloat16, every operation rounded
    to it."""
    k = M.bf16(M.bf16(0.9) * M.bf16(M.bf16(1) / M.bf16(max_steps)))
    return M.bf16(M.bf16(1) - M.bf16(M.bf16(step_count) * k))


def doorkey_closed_form(r: np.ndarray, size: int) -> dict:
    """The level of each row of draws r [N, 8]: wall column ``2 + r0 % (W -
    4)``, door row ``1 + r1 % (W - 3)``, agent and key on two distinct cells
    of the left part from r2 and r3, direction ``r4 % 4``."""
    n = r.shape[0]
    w = h = size
    split_x = 2 + r[:, 0] % (w - 4)
    door_y = 1 + r[:, 1] % (w - 3)
    rows = h - 2
    nfree = (split_x - 1) * rows
    r1 = r[:, 2] % nfree
    r2 = r[:, 3] % np.maximum(nfree - 1, 1)
    r2 = r2 + (r2 >= r1)
    grid = np.full((n, w, h), M.EMPTY, np.int64)
    grid[:, 0, :] = grid[:, -1, :] = grid[:, :, 0] = grid[:, :, -1] = M.WALL
    grid[:, w - 2, h - 2] = M.GOAL
    rr = np.arange(n)
    grid[rr[:, None], split_x[:, None], np.arange(h)[None, :]] = M.WALL
    grid[rr, split_x, door_y] = M.pack(M.DOOR_T, M.YELLOW, M.LOCKED)
    grid[rr, 1 + r2 // rows, 1 + r2 % rows] = M.pack(M.KEY_T, M.YELLOW)
    return {"grid": grid, "pos": np.stack([1 + r1 // rows, 1 + r1 % rows], 1),
            "dir": r[:, 4] % 4}


def step(state: dict, action: np.ndarray, key: np.ndarray, size: int,
         max_steps: int, view: int, reward_fn=fused_reward) -> tuple:
    """One fused step: (new state, image, reward, terminated, truncated,
    next key).  ``state`` is the minigrid reference's dict without boxes."""
    st = {**state, "max_steps": np.zeros_like(state["step_count"])}
    nxt, reward, term, trunc, _ = M.step(st, action, max_steps, reward_fn)
    done = term | trunc
    k_next, sub = M.split(key)[0], M.split(key)[1]
    r = M.randint(sub, (action.shape[0], DRAW_COLUMNS), 0, DRAW_SPAN)
    lvl = doorkey_closed_form(r, size)
    nxt["grid"] = np.where(done[:, None, None], lvl["grid"], nxt["grid"])
    nxt["pos"] = np.where(done[:, None], lvl["pos"], nxt["pos"])
    nxt["dir"] = np.where(done, lvl["dir"], nxt["dir"])
    nxt["step_count"] = np.where(done, 0, nxt["step_count"])
    nxt["carrying"] = np.where(done, M.EMPTY, nxt["carrying"])
    image = M.observe(nxt, view, overlay_first=True)
    return nxt, image, reward, term, trunc, k_next
