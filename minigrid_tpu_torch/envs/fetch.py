"""FetchEnv — pick up the named object; a wrong pickup ends with 0 reward.

Counterpart of ``minigrid_tpu/envs/fetch.py``: ``numObjs`` random keys and
balls (duplicates allowed), one of them the target, and five mission
phrasings.  Any pickup ends the episode; only the target pays.  The target's
(type, color) lives in ``extra``.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.sampling import rand_type_color
from minigrid_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    base_state,
    empty_grid,
    resolve_device,
)
from minigrid_tpu_torch.core.step import StepOutcome

_SYNTAX = ["get a", "go get a", "fetch a", "go fetch a", "you must fetch a"]
_TYPE_IDS = (C.OBJECT_TO_IDX["key"], C.OBJECT_TO_IDX["ball"])
_EMPTY_T = C.OBJECT_TO_IDX["empty"]


def object_triple(type_color: torch.Tensor) -> torch.Tensor:
    """int32[N, 2] (type, color) pairs -> uint8[N, 3] cells of state 0."""
    return torch.cat([type_color, torch.zeros_like(type_color[:, :1])],
                     dim=1).to(torch.uint8)


class FetchEnv(Env):
    name = "Fetch"

    def __init__(self, size: int = 8, numObjs: int = 3,
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
        k = rng.split(keys, 2 * self.numObjs + 4).unbind(1)

        grid = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h)
        grid = grid.expand(n, w, h)
        # the objects, duplicates allowed, each placed after the last
        objs = rand_type_color(torch.stack(k[0:2 * self.numObjs:2], dim=1), _TYPE_IDS)
        for i in range(self.numObjs):
            grid, _, _ = G.place_obj(k[2 * i + 1], grid, object_triple(objs[:, i]))

        _, agent_pos, _ = G.place_obj(k[-4], grid, None)
        agent_dir = rng.randint(k[-3], (), 0, 4)
        # the target, then the phrasing from the target key's second fold
        tgt = G.take_row(objs, rng.randint(k[-2], (), 0, self.numObjs))
        syntax = rng.randint(rng.fold_in(k[-2], 1), (), 0, 5)
        mission = torch.stack([syntax, tgt[:, 1], tgt[:, 0], torch.zeros_like(syntax)],
                              dim=1)
        return base_state(grid, agent_pos, agent_dir, rng=k[-1],
                          mission=mission, extra=tgt, has_boxes=False)

    def post_step(self, state, action, reward, terminated, outcome: StepOutcome,
                  params):
        carried = state.carrying.to(torch.int32)
        carrying = carried[:, 0] != _EMPTY_T
        match = carrying & (carried[:, 0] == state.extra[:, 0]) & (
            carried[:, 1] == state.extra[:, 1])
        reward = torch.where(
            carrying,
            torch.where(match, self.task_reward(state, params), torch.zeros_like(reward)),
            reward)
        return state, reward, terminated | carrying

    def mission_text(self, mission) -> str:
        syntax = _SYNTAX[int(mission[0])]
        color = C.IDX_TO_COLOR[int(mission[1])]
        obj = C.IDX_TO_OBJECT[int(mission[2])]
        return f"{syntax} {color} {obj}"

    def mission_codes(self) -> np.ndarray:
        codes = [(s, c, t, 0)
                 for s in range(len(_SYNTAX))
                 for c in C.COLOR_TO_IDX.values()
                 for t in _TYPE_IDS]
        return np.asarray(codes, dtype=np.int32)
