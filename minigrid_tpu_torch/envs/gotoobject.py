"""GoToObjectEnv — say ``done`` next to the named object.

Counterpart of ``minigrid_tpu/envs/gotoobject.py``: ``numObjs`` distinct
(type, color) keys, balls and boxes, one of them the target.  ``done`` in the
target's 8-neighbourhood pays; ``toggle`` and ``done`` end the episode.  Boxes
can appear, so the state keeps the box planes; the target's position lives in
``extra``.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.sampling import distinct_type_colors
from minigrid_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    base_state,
    empty_grid,
    resolve_device,
)
from minigrid_tpu_torch.core.step import DONE, TOGGLE
from minigrid_tpu_torch.envs.fetch import object_triple

_TYPE_IDS = tuple(C.OBJECT_TO_IDX[t] for t in ("key", "ball", "box"))


class GoToObjectEnv(Env):
    name = "GoToObject"

    def __init__(self, size: int = 6, numObjs: int = 2,
                 max_steps: int | None = None, **kwargs):
        self.numObjs = numObjs
        if max_steps is None:
            max_steps = 5 * size**2
        super().__init__(grid_size=size, see_through_walls=True,
                         max_steps=max_steps, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        n = keys.shape[0]
        w, h = params.width, params.height
        k = rng.split(keys, self.numObjs + 5).unbind(1)

        grid = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h)
        grid = grid.expand(n, w, h)
        objs = distinct_type_colors(k[0], self.numObjs, _TYPE_IDS)  # [N, n, 2]
        positions = []
        for i in range(self.numObjs):
            grid, pos, _ = G.place_obj(k[i + 1], grid, object_triple(objs[:, i]))
            positions.append(pos)
        positions = torch.stack(positions, dim=1)  # [N, n, 2]

        _, agent_pos, _ = G.place_obj(k[-4], grid, None)
        agent_dir = rng.randint(k[-3], (), 0, 4)
        tgt = rng.randint(k[-2], (), 0, self.numObjs)
        tgt_obj = G.take_row(objs, tgt)
        zero = torch.zeros_like(tgt)
        mission = torch.stack([tgt_obj[:, 1], tgt_obj[:, 0], zero, zero], dim=1)
        return base_state(grid, agent_pos, agent_dir, rng=k[-1],
                          mission=mission, extra=G.take_row(positions, tgt))

    def post_step(self, state, action, reward, terminated, outcome, params):
        d = (state.agent_pos - state.extra).abs()
        near = (d[:, 0] <= 1) & (d[:, 1] <= 1)
        is_done = action == DONE
        reward = torch.where(is_done & near, self.task_reward(state, params), reward)
        return state, reward, terminated | is_done | (action == TOGGLE)

    def mission_text(self, mission) -> str:
        return (f"go to the {C.IDX_TO_COLOR[int(mission[0])]} "
                f"{C.IDX_TO_OBJECT[int(mission[1])]}")

    def mission_codes(self) -> np.ndarray:
        return np.asarray([(c, t, 0, 0) for c in C.COLOR_TO_IDX.values()
                           for t in _TYPE_IDS], dtype=np.int32)
