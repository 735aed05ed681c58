"""NegatedEnv: a negation-language pickup task with train/eval splits.

Counterpart of ``minigrid_tpu/envs/negated_goals.py``: a target and one
distractor of another type AND another color, a mission from ten templates
with an optional negation (a negated mission describes the distractor), and
types and colors split into train/eval halves.  A pickup pays +1 for the
target and -1 otherwise, and ends the episode; the state's ``truncated`` is
forced to False, as the reference forces it (the step still reports the
time limit).
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
from minigrid_tpu_torch.core.step import StepOutcome

_THINGS = ["key", "box", "ball", "tree", "cup", "tool", "building", "crate",
           "chair", "flower"]
_SHAPES = ["square", "circle", "oval", "line", "rectangle", "diamond", "ring",
           "cross", "star", "arrow"]
_COLORS = ["red", "green", "blue", "purple", "yellow", "grey", "white",
           "cyan", "brown", "orange"]

BASE_TEMPLATES = [
    "The target is <not><the><desc>.",
    "The <desc><obj> is <not>the target.",
    "The object to pick up is <not><the><desc>.",
    "The object that is <not><the><desc> must be picked up.",
    "Pick up the object that is <not><the><desc>.",
    "Get the object that is <not><the><desc>.",
    "<not><the><desc>.",
    "Navigate to the object that is <not><desc>",
    "Find the object that is <not><desc>",
    "The object that is <not><desc> is the goal",
]

_EMPTY_T = C.OBJECT_TO_IDX["empty"]


def _other(table: torch.Tensor, value: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """A uniform entry of ``table`` other than ``value`` (the first entry
    equal to it is skipped): int32[B]."""
    rank = (table == value[:, None]).to(torch.int32).argmax(dim=1)
    r = rng.randint(keys, (), 0, table.shape[0] - 1)
    return table[(r + (r >= rank).to(torch.int32)).long()]


class NegatedEnv(Env):
    name = "NegatedEnv"
    # missions come from a template grammar; a gym adapter accepts every
    # string
    grammar_missions = True

    def __init__(self, size: int = 6, agent_start_pos=(1, 1), agent_start_dir: int = 0,
                 num_distractors: int = 1, mode: str = "TRAIN",
                 mission_type: str = "EITHER", training_type: str = "all",
                 use_color: bool = True, **kwargs):
        if mode not in ("TRAIN", "EVAL"):
            raise ValueError(f"mode must be TRAIN or EVAL, got {mode!r}")
        if mission_type not in ("DIRECT", "NEGATED", "EITHER"):
            raise ValueError(f"unknown mission_type {mission_type!r}")
        self.mode = mode
        self.mission_type = mission_type
        self.training_type = training_type
        self.use_color = use_color

        half = len(_SHAPES) // 2
        if training_type == "1set":
            set1, set2, distra = _SHAPES[:half], _SHAPES[half:], _SHAPES
        elif training_type == "all":
            set1 = _SHAPES[:half] + _THINGS[:half]
            set2 = _SHAPES[half:] + _THINGS[half:]
            distra = _SHAPES + _THINGS
        else:
            raise NotImplementedError(
                "training_type '2set' uses tuple-valued splits; use '1set' or 'all'")
        dir_t, neg_t = (set1, set2) if mode == "TRAIN" else (set2, set1)
        self._dir_types = np.asarray([C.OBJECT_TO_IDX[t] for t in dir_t], np.int32)
        self._neg_types = np.asarray([C.OBJECT_TO_IDX[t] for t in neg_t], np.int32)
        self._distra_types = np.asarray([C.OBJECT_TO_IDX[t] for t in distra], np.int32)
        chalf = len(_COLORS) // 2
        c1 = [C.COLOR_TO_IDX[c] for c in _COLORS[:chalf]]
        c2 = [C.COLOR_TO_IDX[c] for c in _COLORS[chalf:]]
        self._dir_colors = np.asarray(c1 if mode == "TRAIN" else c2, np.int32)
        self._neg_colors = np.asarray(c2 if mode == "TRAIN" else c1, np.int32)
        self._all_colors = np.asarray([C.COLOR_TO_IDX[c] for c in _COLORS], np.int32)
        super().__init__(grid_size=size, max_steps=size * size + 5,
                         see_through_walls=True, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        n = keys.shape[0]
        w, h = params.width, params.height
        k = rng.split(keys, 12).unbind(1)
        grid = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h).expand(n, w, h)

        _, agent_pos, _ = G.place_obj(k[0], grid, None)
        agent_dir = rng.randint(k[1], (), 0, 4)
        if self.mission_type == "EITHER":
            negated = rng.randint(k[2], (), 0, 2) == 0
        else:
            negated = torch.full((n,), self.mission_type == "NEGATED", device=dev)

        def table(values):
            return G.const(values, dev, torch.int32)

        # the target from the split of its mission kind
        t_types = torch.where(negated[:, None], table(self._neg_types),
                              table(self._dir_types))
        t_colors = torch.where(negated[:, None], table(self._neg_colors),
                               table(self._dir_colors))
        t_type = G.take1(t_types, rng.randint(k[3], (), 0, len(self._dir_types)))
        t_color = G.take1(t_colors, rng.randint(k[4], (), 0, len(self._dir_colors)))
        grid, t_pos, _ = G.place_obj(k[5], grid, self._triple(t_type, t_color),
                                     agent_pos=agent_pos)

        # a distractor of another type and another color
        d_type = _other(table(self._distra_types), t_type, k[6])
        d_color = _other(table(self._all_colors), t_color, k[7])
        grid, _, _ = G.place_obj(k[8], grid, self._triple(d_type, d_color),
                                 agent_pos=agent_pos)

        # a negated mission describes the distractor
        template = rng.randint(k[9], (), 0, len(BASE_TEMPLATES))
        use_color = rng.randint(k[10], (), 0, 2) == 0
        desc_color = torch.where(negated, d_color, t_color)
        desc_type = torch.where(negated, d_type, t_type)
        mission = torch.stack([template, negated.to(torch.int32),
                               use_color.to(torch.int32),
                               torch.where(use_color, desc_color, desc_type)], dim=1)
        extra = {"target": torch.stack([t_type, t_color], dim=1).to(torch.int32),
                 "target_cell": t_pos}
        return base_state(grid, agent_pos, agent_dir, rng=k[11], mission=mission,
                          extra=extra)

    @staticmethod
    def _triple(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        return torch.stack([t, c, torch.zeros_like(t)], dim=1).to(torch.uint8)

    def post_step(self, state, action, reward, terminated, outcome: StepOutcome,
                  params):
        held = state.carrying.to(torch.int32)
        target = state.extra["target"]
        carrying = held[:, 0] != _EMPTY_T
        match = carrying & (held[:, 0] == target[:, 0]) & (held[:, 1] == target[:, 1])
        reward = torch.where(carrying, torch.where(match, 1.0, -1.0), reward)
        state = state.replace(truncated=torch.zeros_like(state.truncated))
        return state, reward, terminated | carrying

    def mission_text(self, mission) -> str:
        m = np.asarray(mission)
        out = BASE_TEMPLATES[int(m[0])].replace("<not>", "not " if m[1] else "")
        desc = int(m[3])
        if m[2]:
            out = out.replace("<desc>", C.IDX_TO_COLOR[desc])
            out = out.replace("<obj>", " object").replace("<the>", "")
        else:
            out = out.replace("<the>", "the ").replace("<desc>", C.IDX_TO_OBJECT[desc])
            out = out.replace("<obj>", "")
        return out


class NegatedSimple(NegatedEnv):
    name = "NegatedSimple"

    def __init__(self, **kwargs):
        super().__init__(size=8, **kwargs)
