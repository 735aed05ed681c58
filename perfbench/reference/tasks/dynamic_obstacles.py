"""MiniGrid Dynamic-Obstacles: the levels made again from their keys, the
obstacles' moves before the base step, and the collision penalty
(Minigrid's ``minigrid/envs/dynamicobstacles.py::DynamicObstaclesEnv``,
``_gen_grid`` and ``step``, as the configuration draws it).

A level from a key: ``k = split(key, n + 3)`` for ``n`` obstacles.  The
room is walled, the green goal at (W - 2, H - 2), the agent at the fixed
start pose (``k[0]`` and ``k[1]`` draw it where the start is random);
obstacle i is a blue ball on one uniform draw from ``k[i + 2]`` over the
empty cells that are not the agent's, each later ball seeing the earlier
ones; ``k[-1]`` is the level's own stream.  The balls' cells are the
state's ``extra`` [N, n, 2], in placement order.  Every draw is accepted.

A step (``DynamicObstaclesEnv.step``): an action of 3 or more becomes
``left``; the front cell is read before anything moves, and it is not
clear where it holds anything but the goal (walls count); then
``(rng, key) = split(rng)``, and ball i in order draws from ``fold_in(key,
i)`` one uniform cell of the empty cells of the 3 x 3 window around it
that are not the agent's (its own cell holds it, so it stays only where no
cell is free), later balls seeing the earlier moves; then the base step on
the grid after the moves; a forward step whose front cell was not clear
gets reward -1 and ends the episode.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import minigrid as M
from perfbench.reference.roomgrid import sample_cell

BALL = int(M.pack(M.BALL_T, M.BLUE))


def _settings(cfg: dict) -> dict:
    kw = cfg["env_kwargs"]
    size = kw["size"]
    n = kw["n_obstacles"]
    # too many obstacles for the room are cut down, as upstream does
    n = int(n) if n <= size / 2 + 1 else int(size / 2)
    return {"size": size, "n": n,
            "start": tuple(kw.get("agent_start_pos", (1, 1))),
            "start_dir": kw.get("agent_start_dir", 0)}


def generate(keys: np.ndarray, cfg: dict) -> dict:
    """The levels of ``keys`` [N, 2], every field the configuration's state
    holds."""
    s = _settings(cfg)
    w = h = s["size"]
    n = keys.shape[0]
    k = M.split(keys, s["n"] + 3)
    grid = np.full((n, w, h), M.EMPTY, np.int64)
    grid[:, 0, :] = grid[:, -1, :] = grid[:, :, 0] = grid[:, :, -1] = M.WALL
    grid[:, w - 2, h - 2] = M.GOAL
    pos = np.broadcast_to(np.array(s["start"], np.int64), (n, 2)).copy()
    xs, ys = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    agent = (xs == pos[:, 0, None, None]) & (ys == pos[:, 1, None, None])
    rr = np.arange(n)
    balls = []
    for i in range(s["n"]):
        cell, ok = sample_cell(k[:, i + 2], (M.cell_type(grid) == M.EMPTY_T) & ~agent)
        grid[rr[ok], cell[ok, 0], cell[ok, 1]] = BALL
        balls.append(cell)
    return {
        "grid": grid, "pos": pos,
        "dir": np.full(n, s["start_dir"], np.int64),
        "carrying": np.full(n, M.EMPTY, np.int64),
        "step_count": np.zeros(n, np.int64),
        "max_steps": np.zeros(n, np.int64),
        "rng": k[:, -1].astype(np.int64),
        "mission": np.zeros((n, 4), np.int64),
        "terminated": np.zeros(n, bool), "truncated": np.zeros(n, bool),
        "extra": np.stack(balls, 1) if balls else np.zeros((n, 0, 2), np.int64),
    }


def attempt(keys: np.ndarray, cfg: dict) -> tuple[dict, np.ndarray]:
    """A refill's levels: the family has no acceptance test, so every draw
    is accepted."""
    return generate(keys, cfg), np.ones(keys.shape[0], bool)


def actions(action: np.ndarray) -> np.ndarray:
    """The three actions of the configuration: 3 and above become left."""
    a = np.asarray(action, np.int64)
    return np.where(a >= 3, M.LEFT, a)


def not_clear(state: dict) -> np.ndarray:
    """bool[B]: the agent's front cell holds something other than the goal."""
    b, w, h = state["grid"].shape
    f = M.front_pos(state["pos"], state["dir"])
    fx, fy = np.clip(f[:, 0], 0, w - 1), np.clip(f[:, 1], 0, h - 1)
    t = M.cell_type(state["grid"][np.arange(b), fx, fy])
    return (t != M.EMPTY_T) & (t != M.GOAL_T)


def move_obstacles(state: dict) -> tuple[dict, np.ndarray]:
    """The balls' moves of one step: (the state after them, the stream
    split, bool[B, n] whether each ball found a free cell)."""
    b, w, h = state["grid"].shape
    sub = M.split(state["rng"])
    key = sub[:, 1]
    grid = state["grid"].copy()
    extra = state["extra"].copy()
    pos = state["pos"]
    xs, ys = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    agent = (xs == pos[:, 0, None, None]) & (ys == pos[:, 1, None, None])
    rr = np.arange(b)
    moved = np.zeros(extra.shape[:2], bool)
    for i in range(extra.shape[1]):
        old = extra[:, i].copy()
        window = ((np.abs(xs - old[:, 0, None, None]) <= 1)
                  & (np.abs(ys - old[:, 1, None, None]) <= 1))
        free = (M.cell_type(grid) == M.EMPTY_T) & window & ~agent
        cell, ok = sample_cell(M.fold_in(key, i), free)
        new = np.where(ok[:, None], cell, old)
        grid[rr[ok], old[ok, 0], old[ok, 1]] = M.EMPTY
        grid[rr, new[:, 0], new[:, 1]] = BALL
        extra[:, i] = new
        moved[:, i] = ok
    return {**state, "grid": grid, "extra": extra, "rng": sub[:, 0].astype(np.int64)}, moved


def post_step(before: dict, after: dict, action, outcome, reward, terminated, cfg,
              reward_fn=M.goal_reward):
    """The collision: a forward step whose front cell in ``before`` (the
    state before the balls moved) was not clear gets reward -1 and ends the
    episode."""
    collided = (action == M.FORWARD) & not_clear(before)
    reward = np.where(collided, np.float32(-1), reward).astype(np.float32)
    return after, reward, terminated | collided


def observe(state: dict, v: int) -> np.ndarray:
    """gen_obs's image under ``see_through_walls``: every cell of the view
    is seen, the carried object (an empty cell with free hands) at the
    agent's cell."""
    cells = M.view_cells(state["grid"], state["pos"], state["dir"], v)
    cells[:, v // 2, v - 1] = state["carrying"]
    return M.encode(cells, np.ones(cells.shape, bool))


def modelled(level: dict) -> dict:
    """The fields the reference computes for this task: all of them."""
    return level
