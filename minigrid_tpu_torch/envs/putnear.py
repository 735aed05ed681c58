"""PutNearEnv — pick up object A and drop it next to object B.

Counterpart of ``minigrid_tpu/envs/putnear.py``: ``numObjs`` distinct
(type, color) objects placed so that no two touch, a move object and a
distinct target object.  Picking up the wrong object ends the episode; so
does any drop attempt while carrying, which pays only when the drop lands in
the target's 8-neighbourhood.  Boxes can appear, so the state keeps the box
planes; the move object and the target's position live in ``extra``.
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
from minigrid_tpu_torch.core.step import DROP, PICKUP, StepOutcome
from minigrid_tpu_torch.envs.fetch import object_triple

_TYPE_IDS = tuple(C.OBJECT_TO_IDX[t] for t in ("key", "ball", "box"))
_EMPTY_T = C.OBJECT_TO_IDX["empty"]


class PutNearEnv(Env):
    name = "PutNear"

    def __init__(self, size: int = 6, numObjs: int = 2,
                 max_steps: int | None = None, **kwargs):
        self.numObjs = numObjs
        if max_steps is None:
            max_steps = 5 * size
        super().__init__(grid_size=size, see_through_walls=True,
                         max_steps=max_steps, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        n = keys.shape[0]
        w, h = params.width, params.height
        k = rng.split(keys, self.numObjs + 6).unbind(1)

        grid = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h)
        grid = grid.expand(n, w, h)
        objs = distinct_type_colors(k[0], self.numObjs, _TYPE_IDS)  # [N, n, 2]
        xs, ys = G.coords(w, h, dev)
        near = torch.zeros((n, w, h), dtype=torch.bool, device=dev)
        positions = []
        for i in range(self.numObjs):
            grid, pos, _ = G.place_obj(k[i + 1], grid, object_triple(objs[:, i]),
                                       reject_mask=near)
            positions.append(pos)
            near = near | (((xs - pos[:, 0, None, None]).abs() <= 1)
                           & ((ys - pos[:, 1, None, None]).abs() <= 1))
        positions = torch.stack(positions, dim=1)  # [N, n, 2]

        _, agent_pos, _ = G.place_obj(k[-5], grid, None)
        agent_dir = rng.randint(k[-4], (), 0, 4)
        # the move object, and a target drawn among the others
        mv = rng.randint(k[-3], (), 0, self.numObjs)
        tg = rng.randint(k[-2], (), 0, self.numObjs - 1)
        tg = tg + (tg >= mv).to(torch.int32)
        move, target = G.take_row(objs, mv), G.take_row(objs, tg)
        mission = torch.stack([move[:, 1], move[:, 0], target[:, 1], target[:, 0]],
                              dim=1)
        extra = {"move": move, "target_pos": G.take_row(positions, tg)}
        return base_state(grid, agent_pos, agent_dir, rng=k[-1],
                          mission=mission, extra=extra)

    def post_step(self, state, action, reward, terminated,
                  outcome: StepOutcome, params):
        move = state.extra["move"]
        tpos = state.extra["target_pos"]
        carried = state.carrying.to(torch.int32)
        carrying = carried[:, 0] != _EMPTY_T
        wrong = carrying & ((carried[:, 0] != move[:, 0]) | (carried[:, 1] != move[:, 1]))
        terminated = terminated | ((action == PICKUP) & wrong)

        was_carrying = outcome.prev_carrying[:, 0].to(torch.int32) != _EMPTY_T
        drop_try = (action == DROP) & was_carrying
        d = (outcome.fwd_pos - tpos).abs()
        success = outcome.dropped & (d[:, 0] <= 1) & (d[:, 1] <= 1)
        reward = torch.where(drop_try & success, self.task_reward(state, params),
                             reward)
        return state, reward, terminated | drop_try

    def mission_text(self, mission) -> str:
        return (f"put the {C.IDX_TO_COLOR[int(mission[0])]} "
                f"{C.IDX_TO_OBJECT[int(mission[1])]} near the "
                f"{C.IDX_TO_COLOR[int(mission[2])]} "
                f"{C.IDX_TO_OBJECT[int(mission[3])]}")

    def mission_codes(self) -> np.ndarray:
        pairs = [(c, t) for c in C.COLOR_TO_IDX.values() for t in _TYPE_IDS]
        return np.asarray([(mc, mt, tc, tt) for (mc, mt) in pairs
                           for (tc, tt) in pairs if (mc, mt) != (tc, tt)],
                          dtype=np.int32)
