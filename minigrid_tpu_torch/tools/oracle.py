"""OracleAgent — BFS demo generator.

Counterpart of ``minigrid_tpu/tools/oracle.py`` (re-derivation of
``minigrid/oracle_agent.py:17-191``): textbook BFS over agent positions with
straight-first expansion (oracle_agent.py:92-154), greedy turn/forward action
emission toward each path cell (oracle_agent.py:68-89), and demo tuples
``(mission, obss, actions, rewards, target_cell, label)``
(oracle_agent.py:156-191).

This is a host-side dataset tool, not a training hot path: it drives the
env on a batch of one (keys ``[1, 2]``) and reads the agent's pose back to
the host every step.  Keys split as the JAX package's do, so the levels, and
with them the demos, are the JAX tool's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.grid_ops import unpack_np
from minigrid_tpu_torch.core.state import EnvState, resolve_device
from minigrid_tpu_torch.core.step import Actions
from minigrid_tpu_torch.utils.convert import to_host

VEC_TO_DIR = {(1, 0): 0, (0, 1): 1, (-1, 0): 2, (0, -1): 3}
T = C.OBJECT_TO_IDX


def breadth_first_search(grid: np.ndarray, initial_states, accept_fn: Callable):
    """BFS over (x, y, dx, dy) states, straight-first expansion
    (oracle_agent.py:92-154).  Walls block; closed doors block; other objects
    are accept-only (not expanded through)."""
    queue = [(state, None) for state in initial_states]
    previous_pos: dict = {}

    while queue:
        state, prev_pos = queue[0]
        queue = queue[1:]
        i, j, di, dj = state
        if (i, j) in previous_pos:
            continue
        t, c, s = grid[i, j]
        previous_pos[(i, j)] = prev_pos

        if accept_fn(i, j):
            path = []
            pos = (i, j)
            while pos:
                path.append(pos)
                pos = previous_pos[pos]
            return path[::-1], (i, j), previous_pos

        overlap = t in (T["empty"], T["goal"], T["floor"], T["lava"]) or (
            t == T["door"] and s == 0
        )
        if not overlap:
            continue
        for k, l in [(di, dj), (dj, di), (-dj, -di), (-di, -dj)]:
            queue.append(((i + k, j + l, k, l), (i, j)))
    return None, None, previous_pos


def _pose(state: EnvState) -> tuple[np.ndarray, int]:
    """The agent's position and direction of env 0, in one host copy."""
    pos, d = to_host([state.agent_pos[0], state.agent_dir[0]])
    return pos, int(d)


class OracleAgent:
    """Drives a functional env, a batch of one on ``device`` (CUDA unless
    named), with BFS-optimal actions."""

    def __init__(self, env: Env, params=None, device=None):
        self.env = env
        self.params = params if params is not None else env.default_params
        self.device = resolve_device(device)

    # -- path/action logic ---------------------------------------------------

    def next_action(self, state: EnvState, next_cell, next_cell_is_goal,
                    mission: str) -> int:
        """Greedy rotation/step toward `next_cell` (oracle_agent.py:68-89)."""
        curr_pos, curr_dir = _pose(state)
        required_dir = VEC_TO_DIR[tuple(np.asarray(next_cell) - curr_pos)]
        if required_dir == curr_dir:
            if next_cell_is_goal:
                m = mission.lower()
                if "go to" in m:
                    return int(Actions.done)
                if "pickup" in m or "pick up" in m:
                    return int(Actions.pickup)
                return int(Actions.done)
            return int(Actions.forward)
        if abs(required_dir - curr_dir) == 2:
            return int(Actions.right)
        if (curr_dir + 1) % 4 == required_dir:
            return int(Actions.right)
        return int(Actions.left)

    def action_sequence(self, state: EnvState, goal) -> list[tuple] | None:
        """The BFS path to `goal` (a grid cell), as path cells."""
        grid = unpack_np(state.grid[0].cpu().numpy())
        pos, d = _pose(state)
        start = (int(pos[0]), int(pos[1]),
                 int(C.DIR_TO_VEC[d][0]), int(C.DIR_TO_VEC[d][1]))
        accept = lambda i, j: [i, j] == list(goal)  # noqa: E731
        path, _, _ = breadth_first_search(grid, [start], accept)
        return path

    def _target_cell(self, state: EnvState) -> np.ndarray:
        for k in ("target_cell", "target_pos"):
            if k in state.extra:
                return state.extra[k][0].cpu().numpy()
        raise ValueError("env state does not expose a target cell")

    # -- demo generation (oracle_agent.py:156-191) ----------------------------

    def generate_demos(self, key: torch.Tensor, num_demos: int = 1):
        """Up to ``num_demos`` successful demos from levels drawn by
        splitting ``key`` (int64[2]) once a demo; each observation is row 0
        of the env's, as numpy."""
        key = key.to(self.device)
        demos = []
        for d in range(num_demos):
            key, k = rng.split(key).unbind(0)
            obs, state = self.env.reset(k[None], self.params, self.device)
            target = self._target_cell(state)
            mission = self.env.mission_text(state.mission[0].cpu().numpy())
            path = self.action_sequence(state, list(target))
            if path is None:
                continue
            obss, actions, rewards = [], [], []
            done = False
            for cell in path[1:]:
                goal_cell = cell == tuple(target)
                # Rotate/step until standing at the cell; the goal cell ends
                # with a facing done/pickup action instead (the agent cannot
                # stand on it).
                for _ in range(8 + 1):
                    at_cell = np.array_equal(_pose(state)[0], cell)
                    if at_cell:
                        break
                    a = self.next_action(state, cell, goal_cell, mission)
                    obss.append(dict(zip(obs, to_host([v[0] for v in obs.values()]))))
                    action = torch.full((1,), a, dtype=torch.int32, device=self.device)
                    obs, state, r, te, tr, _ = self.env.step(state, action, self.params)
                    r, te, tr = to_host([r[0], te[0], tr[0]])
                    actions.append(a)
                    rewards.append(float(r))
                    done = bool(te) or bool(tr)
                    if done:
                        break
                if done:
                    break
            if not done or sum(rewards) <= 0:
                continue
            demos.append((mission, obss, actions, rewards, tuple(target),
                          mission))
        return demos
