"""DynamicObstaclesEnv — moving ball obstacles, a collision penalty.

Counterpart of ``minigrid_tpu/envs/dynamicobstacles.py``:

* actions >= 3 become ``left``;
* the collision test reads the grid before the obstacles move: the front
  cell neither empty nor the goal (walls included);
* each obstacle moves to a uniform empty cell of the 3x3 window around it
  (its own cell is taken during the draw), one after another, so later
  obstacles see earlier moves; the draws come from the state's own stream,
  ``split_rng`` then ``fold_in(key, i)`` for obstacle i;
* walking forward into a blocked cell gives reward -1 and ends the episode.

The obstacle positions live in ``extra``, int32[B, n, 2].

Tracing (``utils/trace.py``) sees the step's stream split and obstacle loop
as the span ``dynamicobstacles.moves`` and the generator's obstacle
placements as ``dynamicobstacles.place``; it counts the envs whose forward
step collided as ``dynamicobstacles.collisions`` and the obstacles that
found no free cell and stayed as ``dynamicobstacles.stuck`` (device
tensors, summed when read, computed only while tracing is on).
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid_ops as G
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.state import (
    EnvParams,
    EnvState,
    base_state,
    empty_grid,
    fixed_pose,
    resolve_device,
)
from minigrid_tpu_torch.core.step import dir_to_vec
from minigrid_tpu_torch.utils import trace

_BALL = np.asarray([C.OBJECT_TO_IDX["ball"], C.COLOR_TO_IDX["blue"], 0],
                   dtype=np.uint8)
_GOAL_T = C.OBJECT_TO_IDX["goal"]
_EMPTY_T = C.OBJECT_TO_IDX["empty"]


class DynamicObstaclesEnv(Env):
    name = "DynamicObstacles"

    def __init__(self, size: int = 8, agent_start_pos=(1, 1),
                 agent_start_dir: int = 0, n_obstacles: int = 4,
                 max_steps: int | None = None, **kwargs):
        self.agent_start_pos = agent_start_pos
        self.agent_start_dir = agent_start_dir
        # too many obstacles for the room are cut down
        if n_obstacles <= size / 2 + 1:
            self.n_obstacles = int(n_obstacles)
        else:
            self.n_obstacles = int(size / 2)
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(grid_size=size, see_through_walls=True,
                         max_steps=max_steps, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        b = keys.shape[0]
        w, h = params.width, params.height
        k = rng.split(keys, self.n_obstacles + 3).unbind(1)

        grid = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h)
        grid = G.put(grid, w - 2, h - 2, C.GOAL_TRIPLE)
        grid = grid.expand(b, w, h)

        if self.agent_start_pos is not None:
            agent_pos, agent_dir = fixed_pose(b, self.agent_start_pos,
                                              self.agent_start_dir, dev)
        else:
            _, agent_pos, _ = G.place_obj(k[0], grid, None)
            agent_dir = rng.randint(k[1], (), 0, 4)

        positions = []
        with trace.span("dynamicobstacles.place"):
            for i in range(self.n_obstacles):
                grid, pos, _ = G.place_obj(k[i + 2], grid, _BALL, agent_pos=agent_pos)
                positions.append(pos)
        if positions:
            extra = torch.stack(positions, dim=1)
        else:
            extra = torch.zeros((b, 0, 2), dtype=torch.int32, device=dev)
        return base_state(grid, agent_pos, agent_dir, rng=k[-1],
                          extra=extra, has_boxes=False)

    def propose_move(self, i: int, key: torch.Tensor, grid: torch.Tensor,
                     old: torch.Tensor, agent_pos: torch.Tensor, xs: torch.Tensor,
                     ys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Obstacle i's proposed cell in each env: uniform over the empty
        cells of its 3x3 window, not the agent's.  Returns (pos int32[B, 2],
        ok bool[B]).  Overridable, e.g. to replay another engine's motion."""
        window = (((xs - old[:, 0, None, None]).abs() <= 1)
                  & ((ys - old[:, 1, None, None]).abs() <= 1))
        mask = G.is_empty(grid) & window
        mask = mask & ~((xs == agent_pos[:, 0, None, None])
                        & (ys == agent_pos[:, 1, None, None]))
        return G.sample_cell(rng.fold_in(key, i), mask)

    def step_state(self, state: EnvState, action, params: EnvParams):
        action = action.to(torch.int32)
        action = torch.where(action >= 3, 0, action)

        # the collision test, on the grid before the obstacles move
        fdx, fdy = dir_to_vec(state.agent_dir)
        fx = (state.agent_pos[:, 0] + fdx).clamp(0, params.width - 1)
        fy = (state.agent_pos[:, 1] + fdy).clamp(0, params.height - 1)
        fwd_type = G.types(G.read_word(state.grid, fx, fy))
        not_clear = (fwd_type != _EMPTY_T) & (fwd_type != _GOAL_T)

        with trace.span("dynamicobstacles.moves"):
            state, key = self.split_rng(state)
            grid = state.grid
            xs, ys = G.coords(params.width, params.height, grid.device)
            new_positions, moved = [], []
            for i in range(self.n_obstacles):
                old = state.extra[:, i]
                pos, ok = self.propose_move(i, key, grid, old, state.agent_pos, xs, ys)
                new_pos = torch.where(ok[:, None], pos, old)
                grid = G.put_if(grid, old[:, 0], old[:, 1], C.EMPTY_TRIPLE, ok)
                grid = G.put(grid, new_pos[:, 0], new_pos[:, 1], _BALL)
                new_positions.append(new_pos)
                moved.append(ok)
            if new_positions:
                state = state.replace(grid=grid, extra=torch.stack(new_positions, dim=1))

        state, reward, terminated, truncated = super().step_state(
            state, action, params)
        collided = (action == 2) & not_clear
        if trace.on():
            trace.count("dynamicobstacles.collisions", collided)
            for ok in moved:
                trace.count_false("dynamicobstacles.stuck", ok)
        reward = torch.where(collided, -1.0, reward)
        terminated = terminated | collided
        state = state.replace(terminated=terminated)
        return state, reward, terminated, truncated

    def mission_text(self, mission) -> str:
        return "get to the green goal square"
