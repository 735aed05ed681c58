"""GoToDoorEnv — say ``done`` next to the named door.

Counterpart of ``minigrid_tpu/envs/gotodoor.py``: a walled room of random
extent with four doors of distinct colors on its borders.  ``done`` beside
the target door pays; ``toggle`` and ``done`` end the episode.  The target
door's position lives in ``extra``.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.sampling import SORTED_COLOR_IDS
from minigrid_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    base_state,
    empty_grid,
    resolve_device,
)
from minigrid_tpu_torch.core.step import DONE, TOGGLE

_DOOR = C.OBJECT_TO_IDX["door"]
_CLOSED = C.STATE_TO_IDX["closed"]


class GoToDoorEnv(Env):
    name = "GoToDoor"

    def __init__(self, size: int = 5, max_steps: int | None = None, **kwargs):
        if size < 5:
            raise ValueError("GoToDoor needs size >= 5")
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(grid_size=size, see_through_walls=True,
                         max_steps=max_steps, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        wmax, hmax = params.width, params.height
        k = rng.split(keys, 10).unbind(1)

        # the room's extent, then a door on each of its four walls
        w, h = rng.randint(torch.stack([k[0], k[1]], dim=1), (), 5,
                           G.const([wmax + 1, hmax + 1], dev)).unbind(1)
        grid = G.wall_rect(empty_grid(wmax, hmax, dev), 0, 0, w, h)
        span = torch.stack([w, w, h, h], dim=1) - 2
        dx0, dx1, dy2, dy3 = rng.randint(torch.stack(k[2:6], dim=1), (), 2,
                                         span).unbind(1)
        zero = torch.zeros_like(dx0)
        door_pos = torch.stack([torch.stack([dx0, zero], 1),
                                torch.stack([dx1, h - 1], 1),
                                torch.stack([zero, dy2], 1),
                                torch.stack([w - 1, dy3], 1)], dim=1)  # [N, 4, 2]

        # four distinct colors: a permutation prefix
        perm4 = rng.permutation(k[6], 10)[:, :4]
        colors = G.take_vec(G.const(SORTED_COLOR_IDS, dev, torch.int32), perm4)
        for i in range(4):
            door = torch.stack([torch.full_like(colors[:, i], _DOOR), colors[:, i],
                                torch.full_like(colors[:, i], _CLOSED)], dim=1)
            grid = G.put(grid, door_pos[:, i, 0], door_pos[:, i, 1],
                         door.to(torch.uint8))

        # the agent inside the (possibly smaller) room
        room = G.rect_mask(wmax, hmax, (0, 0), (w, h), dev)
        _, agent_pos, _ = G.place_obj(k[7], grid, None, reject_mask=~room)
        agent_dir = rng.randint(k[8], (), 0, 4)

        tgt = rng.randint(rng.fold_in(k[8], 1), (), 0, 4)
        zero = torch.zeros_like(tgt)
        mission = torch.stack([G.take1(colors, tgt), zero, zero, zero], dim=1)
        tgt_pos = G.take_row(door_pos, tgt)
        return base_state(grid, agent_pos, agent_dir, rng=k[9],
                          mission=mission, extra=tgt_pos, has_boxes=False)

    def post_step(self, state, action, reward, terminated, outcome, params):
        ax, ay = state.agent_pos[:, 0], state.agent_pos[:, 1]
        tx, ty = state.extra[:, 0], state.extra[:, 1]
        adjacent = ((ax == tx) & ((ay - ty).abs() == 1)) | (
            (ay == ty) & ((ax - tx).abs() == 1))
        is_done = action == DONE
        reward = torch.where(is_done & adjacent, self.task_reward(state, params),
                             reward)
        return state, reward, terminated | is_done | (action == TOGGLE)

    def mission_text(self, mission) -> str:
        return f"go to the {C.IDX_TO_COLOR[int(mission[0])]} door"

    def mission_codes(self) -> np.ndarray:
        return np.asarray([(c, 0, 0, 0) for c in C.COLOR_TO_IDX.values()],
                          dtype=np.int32)
