"""ObstructedMaze — locked doors, keys hidden in boxes, balls blocking doors.

Counterpart of ``minigrid_tpu/envs/obstructedmaze.py``.  Fixed palette roles:
the target ball blue (the first color name), blocking balls brown, key boxes
cyan; the door colors are a random permutation of all ten.  A hidden key lives
in the ``box_contains`` plane under its box, so toggling the box reveals it
through ``base_step``.  Picking up the blue ball succeeds.

Tracing (``utils/trace.py``) sees ``ObstructedMaze_Full.generate``'s three
stages as the spans ``obstructedmaze.rooms`` (the rooms and the palette),
``obstructedmaze.doors`` (the door loop with its blocking balls and boxed
keys) and ``obstructedmaze.target`` (the ball to find and the agent), and
counts the boxed keys that found no free cell as
``obstructedmaze.keys_missing``.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.roomgrid import RoomGridEnv, type_triple
from minigrid_tpu_torch.core.sampling import SORTED_COLOR_IDS
from minigrid_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    base_state,
    empty_grid,
    resolve_device,
)
from minigrid_tpu_torch.envs.unlockpickup import picked_target
from minigrid_tpu_torch.utils import trace

_BALL = C.OBJECT_TO_IDX["ball"]
_KEY = C.OBJECT_TO_IDX["key"]
_BOX = C.OBJECT_TO_IDX["box"]
_BLUE = C.COLOR_TO_IDX[C.COLOR_NAMES[0]]    # the ball to find
_BROWN = C.COLOR_TO_IDX[C.COLOR_NAMES[1]]   # blocking balls
_CYAN = C.COLOR_TO_IDX[C.COLOR_NAMES[2]]    # key boxes


class ObstructedMazeEnv(RoomGridEnv):
    name = "ObstructedMaze"

    def __init__(self, num_rows, num_cols, num_rooms_visited,
                 max_steps: int | None = None, **kwargs):
        room_size = 6
        if max_steps is None:
            max_steps = 4 * num_rooms_visited * room_size**2
        super().__init__(room_size=room_size, num_rows=num_rows,
                         num_cols=num_cols, max_steps=max_steps, **kwargs)

    def add_door_om(self, b: dict, keys: torch.Tensor, params: EnvParams, i, j,
                    door_idx: int, color, locked: bool, key_in_box: bool,
                    blocked: bool):
        """A door, a brown ball blocking it from room (i, j)'s side when
        ``blocked``, and for a locked door its key in room (i, j), inside a
        cyan box when ``key_in_box``."""
        n = keys.shape[0]
        dev = keys.device
        k_door, k_key = rng.split(keys).unbind(1)
        b, door, door_pos = self.add_door(b, k_door, i, j, door_idx,
                                          color=color, locked=locked)
        if blocked:
            dx, dy = (int(v) for v in C.DIR_TO_VEC[door_idx])
            b = dict(b)
            b["grid"] = G.put(b["grid"], door_pos[:, 0] - dx, door_pos[:, 1] - dy,
                              (_BALL, _BROWN, 0))
        if locked:
            key_triple = type_triple(_KEY, color, n, dev)
            if key_in_box:
                b, pos, ok = self.place_in_room(b, k_key, params, i, j,
                                                (_BOX, _CYAN, 0))
                if trace.on():
                    # a key with no cell leaves its door shut for good
                    trace.count("obstructedmaze.keys_missing", ~ok)
                b = dict(b)
                b["box_contains"] = G.put_if(b["box_contains"], pos[:, 0], pos[:, 1],
                                             key_triple, ok)
            else:
                b, _, _ = self.place_in_room(b, k_key, params, i, j, key_triple)
        return b, door, door_pos

    def init_rooms(self, keys: torch.Tensor, params: EnvParams) -> dict:
        k_init, k_perm = rng.split(keys).unbind(1)
        b = super().init_rooms(k_init, params)
        n = keys.shape[0]
        b["box_contains"] = empty_grid(params.width, params.height, keys.device, (n,))
        # the door palette: a random permutation of all ten colors
        b["door_colors"] = G.take_vec(G.const(SORTED_COLOR_IDS, keys.device, torch.int32),
                                      rng.permutation(k_perm, 10))
        return b

    def finish(self, b: dict, keys: torch.Tensor) -> EnvState:
        n = keys.shape[0]
        mission = G.const([_BLUE, _BALL, 0, 0], keys.device, torch.int32).expand(n, 4)
        target = G.const([_BALL, _BLUE], keys.device, torch.int32).expand(n, 2)
        return base_state(b["grid"], b["agent_pos"], b["agent_dir"], rng=keys,
                          mission=mission, box_contains=b["box_contains"],
                          extra=target)

    def post_step(self, state, action, reward, terminated, outcome, params):
        reward, terminated = picked_target(state, action, reward, terminated,
                                           self.task_reward(state, params))
        return state, reward, terminated

    def mission_text(self, mission) -> str:
        return f"pick up the {C.IDX_TO_COLOR[int(mission[0])]} ball"

    def mission_codes(self) -> np.ndarray:
        return np.asarray([(_BLUE, _BALL, 0, 0)], dtype=np.int32)


class ObstructedMaze_1Dlhb(ObstructedMazeEnv):
    """Two rooms side by side, one locked door."""

    def __init__(self, key_in_box: bool = True, blocked: bool = True, **kwargs):
        self.key_in_box = key_in_box
        self.blocked = blocked
        super().__init__(num_rows=1, num_cols=2, num_rooms_visited=2, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        keys = keys.to(resolve_device(device))
        k = rng.split(keys, 5).unbind(1)
        b = self.init_rooms(k[0], params)
        b, _, _ = self.add_door_om(b, k[1], params, 0, 0, 0,
                                   color=b["door_colors"][:, 0], locked=True,
                                   key_in_box=self.key_in_box, blocked=self.blocked)
        b, _, _ = self.add_object(b, k[2], params, 1, 0, kind="ball", color=_BLUE)
        b = self.place_agent_in_room(b, k[3], params, 0, 0)
        return self.finish(b, k[4])


class ObstructedMaze_Full(ObstructedMazeEnv):
    """3x3 rooms: an unlocked door from the middle into each of
    ``num_quarters`` side rooms, locked doors on both sides of each side
    room, the ball in a random corner room."""

    def __init__(self, agent_room=(1, 1), key_in_box: bool = True,
                 blocked: bool = True, num_quarters: int = 4,
                 num_rooms_visited: int = 25, **kwargs):
        self.agent_room = agent_room
        self.key_in_box = key_in_box
        self.blocked = blocked
        self.num_quarters = num_quarters
        super().__init__(num_rows=3, num_cols=3,
                         num_rooms_visited=num_rooms_visited, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        keys = keys.to(resolve_device(device))
        dev = keys.device
        k = rng.split(keys, 4 + 3 * self.num_quarters).unbind(1)
        with trace.span("obstructedmaze.rooms"):
            b = self.init_rooms(k[0], params)

        with trace.span("obstructedmaze.doors"):
            side_rooms = [(2, 1), (1, 2), (0, 1), (1, 0)][: self.num_quarters]
            for i, side_room in enumerate(side_rooms):
                b, _, _ = self.add_door(b, k[1 + 3 * i], 1, 1, i,
                                        color=b["door_colors"][:, i], locked=False)
                for n, d in enumerate((-1, 1)):
                    # the door side is (i + d) % 4, its color (i + d) % 10 of
                    # the palette: the reference indexes the ten colors with
                    # i + d
                    b, _, _ = self.add_door_om(
                        b, k[2 + 3 * i + n], params, side_room[0], side_room[1],
                        (i + d) % 4, color=b["door_colors"][:, (i + d) % 10],
                        locked=True, key_in_box=self.key_in_box, blocked=self.blocked)

        with trace.span("obstructedmaze.target"):
            corners = G.const([(2, 0), (2, 2), (0, 2), (0, 0)][: self.num_quarters],
                              dev, torch.int32)
            pick = rng.randint(k[-3], (), 0, corners.shape[0])
            ball_room = G.take_row(corners.expand(pick.shape[0], -1, -1), pick)
            b, _, _ = self.add_object(b, k[-2], params, ball_room[:, 0], ball_room[:, 1],
                                      kind="ball", color=_BLUE)
            b = self.place_agent_in_room(b, rng.fold_in(k[-2], 7), params,
                                         self.agent_room[0], self.agent_room[1])
        return self.finish(b, k[-1])


class ObstructedMaze_2Dl(ObstructedMaze_Full):
    def __init__(self, **kwargs):
        super().__init__((2, 1), False, False, 1, 4, **kwargs)


class ObstructedMaze_2Dlh(ObstructedMaze_Full):
    def __init__(self, **kwargs):
        super().__init__((2, 1), True, False, 1, 4, **kwargs)


class ObstructedMaze_2Dlhb(ObstructedMaze_Full):
    def __init__(self, **kwargs):
        super().__init__((2, 1), True, True, 1, 4, **kwargs)
