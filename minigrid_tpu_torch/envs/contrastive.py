"""Contrastive dataset envs: compositional (color, type) splits.

Counterpart of ``minigrid_tpu/envs/contrastive.py``.  The (color x
non-base type) compositions are shuffled once with a fixed numpy seed and
split into train/val/test.  An episode draws its composition uniformly from
the active split (:meth:`set_split`), read when the batch is generated;
:meth:`next_composition` is the sequential host cursor for dataset dumps.
Each split table moves to the device once.
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
    resolve_device,
)
from minigrid_tpu_torch.core.step import DONE, TOGGLE, StepOutcome
from minigrid_tpu_torch.envs.fetch import object_triple

_EMPTY_T = C.OBJECT_TO_IDX["empty"]


def _compositions(seed: int) -> np.ndarray:
    """int32[M, 2] (color id, type id) over COLOR_NAMES x NON_BASE_OBJ_NAMES,
    shuffled by ``np.random.default_rng(seed)``."""
    combos = np.asarray([(C.COLOR_TO_IDX[c], C.OBJECT_TO_IDX[t])
                         for c in C.COLOR_NAMES for t in C.NON_BASE_OBJ_NAMES],
                        np.int32)
    np.random.default_rng(seed).shuffle(combos)
    return combos


class SplitTables:
    """Host split tables with a cursor: the active split's table moves to a
    device once and is reused."""

    def __init__(self, splits: dict):
        self.splits = splits
        self._on_device = {}

    def table(self, split: str, device) -> torch.Tensor:
        key = (split, torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = torch.from_numpy(self.splits[split]).to(device)
        return self._on_device[key]


class ContrastiveDataset(Env):
    """One object per episode; ``done`` next to it pays."""

    name = "ContrastiveDataset"
    mission_prefix = "A"

    def __init__(self, size: int = 7, numObjs: int = 1, splits=(0.7, 0.1, 0.2),
                 split_seed: int = 0, max_steps: int | None = None, **kwargs):
        self.numObjs = numObjs
        combos = _compositions(split_seed)
        n = len(combos)
        a, b = int(splits[0] * n), int(sum(splits[:2]) * n)
        self.splits = {"train": combos[:a], "val": combos[a:b], "test": combos[b:]}
        self._tables = SplitTables(self.splits)
        self.curr_split = "train"
        self.curr_comp_idx = 0
        if max_steps is None:
            max_steps = 5 * size**2
        super().__init__(grid_size=size, see_through_walls=True, max_steps=max_steps,
                         **kwargs)

    def set_split(self, split: str) -> None:
        self.curr_split = split
        self.curr_comp_idx = 0

    def next_composition(self) -> np.ndarray:
        """The sequential composition cursor."""
        table = self.splits[self.curr_split]
        comp = table[self.curr_comp_idx]
        self.curr_comp_idx = (self.curr_comp_idx + 1) % len(table)
        return comp

    def _start(self, k: tuple, params: EnvParams, dev):
        """The walls, the target drawn from the active split, and the agent:
        (grid, table, target index, target (color, type), target cell, agent
        cell, agent direction)."""
        w, h = params.width, params.height
        n = k[0].shape[0]
        grid = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h).expand(n, w, h)
        table = self._tables.table(self.curr_split, dev)
        ti = rng.randint(k[0], (), 0, table.shape[0])
        comp = table[ti.long()]
        grid, pos, _ = G.place_obj(k[1], grid, object_triple(comp.flip(1)))
        _, agent_pos, _ = G.place_obj(k[2], grid, None)
        agent_dir = rng.randint(k[3], (), 0, 4)
        return grid, table, ti, comp, pos, agent_pos, agent_dir

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        k = rng.split(keys.to(dev), 6).unbind(1)
        grid, _, _, comp, pos, agent_pos, agent_dir = self._start(k, params, dev)
        mission = torch.cat([comp, torch.zeros_like(comp)], dim=1)
        return base_state(grid, agent_pos, agent_dir, rng=k[4], mission=mission,
                          extra={"target": comp, "target_pos": pos}, has_boxes=False)

    def post_step(self, state, action, reward, terminated, outcome, params):
        # done next to the target pays; toggle ends the episode
        d = (state.agent_pos - state.extra["target_pos"]).abs()
        near = (d[:, 0] <= 1) & (d[:, 1] <= 1)
        is_done = action == DONE
        reward = torch.where(is_done & near, self.task_reward(state, params), reward)
        return state, reward, terminated | is_done | (action == TOGGLE)

    def mission_text(self, mission) -> str:
        return (f"{self.mission_prefix} {C.IDX_TO_COLOR[int(mission[0])]} "
                f"{C.IDX_TO_OBJECT[int(mission[1])]}")

    def mission_codes(self) -> np.ndarray:
        combos = np.concatenate([self.splits[s] for s in ("train", "val", "test")])
        return np.concatenate([combos, np.zeros((len(combos), 2), np.int32)], axis=1)


class ContrastiveTrajectoryDataset(ContrastiveDataset):
    """The target and distractors from the same split; a pickup pays +1 for
    the target and -1 for anything else."""

    name = "ContrastiveTrajectoryDataset"
    mission_prefix = "Pickup"

    def __init__(self, size: int = 8, numObjs: int = 2, **kwargs):
        super().__init__(size=size, numObjs=numObjs, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        k = rng.split(keys.to(dev), 6 + 2 * self.numObjs).unbind(1)
        grid, table, ti, comp, pos, agent_pos, agent_dir = self._start(k, params, dev)
        # distractors from the split, the target's row excluded
        m = table.shape[0]
        for i in range(self.numObjs - 1):
            rd = rng.randint(k[4 + 2 * i], (), 0, m - 1)
            d = table[(rd + (rd >= ti).to(torch.int32)).long()]
            grid, _, _ = G.place_obj(k[5 + 2 * i], grid, object_triple(d.flip(1)),
                                     agent_pos=agent_pos)
        mission = torch.cat([comp, torch.zeros_like(comp)], dim=1)
        return base_state(grid, agent_pos, agent_dir, rng=k[-1], mission=mission,
                          extra={"target": comp, "target_pos": pos}, has_boxes=False)

    def post_step(self, state, action, reward, terminated, outcome: StepOutcome,
                  params):
        held = state.carrying.to(torch.int32)
        target = state.extra["target"]
        carrying = held[:, 0] != _EMPTY_T
        match = carrying & (held[:, 0] == target[:, 1]) & (held[:, 1] == target[:, 0])
        reward = torch.where(carrying, torch.where(match, 1.0, -1.0), reward)
        return state, reward, terminated | carrying
