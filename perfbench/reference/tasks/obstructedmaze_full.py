"""MiniGrid ObstructedMaze-Full: the base step, success on picking up the
blue ball, and the levels made again from their keys (Minigrid's
``minigrid/envs/obstructedmaze.py::ObstructedMaze_Full._gen_grid`` as the
configuration draws it).

One level from a key: ``k = split(key, 4 + 3 q)`` for ``q`` quarters.  The
rooms and the door palette from ``k[0]``; for each quarter i the unlocked
door from the agent's room on its side i, coloured palette[i], then for d in
(-1, +1) the locked door on side (i + d) mod 4 of side room i, coloured
palette[(i + d) mod 10], from ``k[2 + 3 i + (d > 0)]`` (``k[1 + 3 i]`` draws
nothing); the corner room of the ball by ``randint(k[-3], 0, q)``; the blue
ball by ``add_object(k[-2])``; the agent in its room from ``fold_in(k[-2],
7)``; ``k[-1]`` is the level's own stream.  Every draw is accepted.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import minigrid as M
from perfbench.reference import obstructedmaze as OM
from perfbench.reference.roomgrid import Lattice

ROOM_SIZE = 6
SIDE_ROOMS = ((2, 1), (1, 2), (0, 1), (1, 0))
CORNERS = np.array([(2, 0), (2, 2), (0, 2), (0, 0)], np.int64)
TARGET = int(M.pack(M.BALL_T, OM.BLUE))


def _settings(cfg: dict) -> dict:
    kw = cfg["env_kwargs"]
    return {"quarters": kw["num_quarters"], "key_in_box": kw["key_in_box"],
            "blocked": kw["blocked"], "agent_room": tuple(kw["agent_room"])}


def episode_limit(cfg: dict) -> int:
    """The env's fixed limit, ``4 x num_rooms_visited x room_size^2``
    unless the configuration sets ``max_steps``."""
    kw = cfg["env_kwargs"]
    return kw.get("max_steps", 4 * kw["num_rooms_visited"] * ROOM_SIZE ** 2)


def draw(keys: np.ndarray, cfg: dict) -> tuple[dict, np.ndarray]:
    """The builders of ``keys`` [N, 2] and whether every boxed key found a
    cell."""
    s = _settings(cfg)
    lat = Lattice(ROOM_SIZE, 3, 3)
    q = s["quarters"]
    k = M.split(keys, 4 + 3 * q)
    b = OM.init_rooms(lat, k[:, 0])
    keys_ok = np.ones(keys.shape[0], bool)
    for i in range(q):
        b, _ = OM.add_door(lat, b, 1, 1, i, b["door_colors"][:, i], locked=False)
        for n, d in enumerate((-1, 1)):
            b, ok = OM.add_locked_door(lat, b, k[:, 2 + 3 * i + n], *SIDE_ROOMS[i],
                                       (i + d) % 4, b["door_colors"][:, (i + d) % 10],
                                       s["key_in_box"], s["blocked"])
            keys_ok &= ok
    corner = CORNERS[M.randint(k[:, -3], (), 0, q)]
    pos, ok = OM.place_in_room(lat, b, M.split(k[:, -2], 3)[:, 2], corner[:, 0], corner[:, 1])
    rr = np.arange(keys.shape[0])
    grid = b["grid"].copy()
    grid[rr[ok], pos[ok, 0], pos[ok, 1]] = TARGET
    room = np.broadcast_to(np.array(s["agent_room"], np.int64), (keys.shape[0], 2))
    b = lat.place_agent_in_room({**b, "grid": grid}, M.fold_in(k[:, -2], 7), room[:, 0],
                                room[:, 1])
    b["rng"] = k[:, -1]
    return b, keys_ok


def _finish(b: dict) -> dict:
    """The level a builder stands for: every field the configuration's
    state holds."""
    n = b["grid"].shape[0]
    return {
        "grid": b["grid"], "pos": b["pos"], "dir": b["dir"],
        "carrying": np.full(n, M.EMPTY, np.int64),
        "step_count": np.zeros(n, np.int64),
        "max_steps": np.zeros(n, np.int64),
        "rng": b["rng"].astype(np.int64),
        "mission": np.broadcast_to(np.array([OM.BLUE, M.BALL_T, 0, 0], np.int64), (n, 4)),
        "terminated": np.zeros(n, bool), "truncated": np.zeros(n, bool),
        "box": b["box"],
        "carrying_box": np.full(n, M.EMPTY, np.int64),
        "extra": np.broadcast_to(np.array([M.BALL_T, OM.BLUE], np.int64), (n, 2)),
    }


def generate(keys: np.ndarray, cfg: dict) -> dict:
    """A reset's levels: one draw a key."""
    return _finish(draw(keys, cfg)[0])


def attempt(keys: np.ndarray, cfg: dict) -> tuple[dict, np.ndarray]:
    """A refill's levels: the family has no acceptance test, so every draw
    is accepted (a level whose boxed key found no cell included)."""
    return generate(keys, cfg), np.ones(keys.shape[0], bool)


def post_step(before: dict, after: dict, action, outcome, reward, terminated, cfg,
              reward_fn=M.goal_reward):
    """A pickup that leaves the blue ball carried succeeds with the goal
    reward of the step."""
    success = (action == M.PICKUP) & (after["carrying"] == TARGET)
    reward = reward.copy()
    limit = episode_limit(cfg)
    for i in np.nonzero(success)[0]:
        reward[i] = reward_fn(int(after["step_count"][i]), limit)
    return after, reward, terminated | success


def modelled(level: dict) -> dict:
    """The fields the reference computes for this task: all of them."""
    return level
