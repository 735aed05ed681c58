"""DirectionsDataset: a scripted language dataset of rotations.

Counterpart of ``minigrid_tpu/envs/directions_dataset.py``: compass glyphs
at the edges of a 3x3 grid, the agent in the middle, and a sequence of verbs
per episode that the env carries out itself: :meth:`step_state` ignores the
action and turns the agent by the next verb (its own four actions: left,
right, turn around, stay).  The sequences (13 verbs, lengths 1 to
``max_actions``) are enumerated, shuffled with a fixed numpy seed and split
on the host; an episode draws from the active split, and
:meth:`next_sequence` is the sequential cursor.  Each split table moves to
the device once.
"""

from __future__ import annotations

import itertools

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
from minigrid_tpu_torch.envs.contrastive import SplitTables

DD_LEFT, DD_RIGHT, DD_TURN_AROUND, DD_STAY = range(4)

# verb -> action
HL_ACTION_VERBS = {
    "does nothing": DD_STAY,
    "turns left": DD_LEFT,
    "turns right": DD_RIGHT,
    "goes straight": DD_STAY,
    "turns around": DD_TURN_AROUND,
    "turns 90 degrees clockwise": DD_RIGHT,
    "turns 180 degrees clockwise": DD_TURN_AROUND,
    "turns 270 degrees clockwise": DD_LEFT,
    "turns 360 degrees clockwise": DD_STAY,
    "turns 90 degrees counterclockwise": DD_LEFT,
    "turns 180 degrees counterclockwise": DD_TURN_AROUND,
    "turns 270 degrees counterclockwise": DD_RIGHT,
    "turns 360 degrees counterclockwise": DD_STAY,
}
VERB_NAMES = list(HL_ACTION_VERBS.keys())
VERB_ACTIONS = np.asarray([HL_ACTION_VERBS[v] for v in VERB_NAMES], np.int32)
# the turn of each action: left -1, right +1, around +2, stay 0
DD_DELTA = np.asarray([3, 1, 2, 0], np.int32)
# the turn of each verb
_VERB_DELTA = DD_DELTA[VERB_ACTIONS]

DIRECTIONS_IDX_TO_STR = ["east", "south", "west", "north"]


class DirectionsDataset(Env):
    name = "DirectionsDataset"
    # missions come from a template grammar; a gym adapter accepts every
    # string
    grammar_missions = True
    num_actions = 4

    def __init__(self, size: int = 3, max_actions: int = 2, split_seed: int = 0,
                 train_size: int = 262144, val_size: int = 10000,
                 test_size: int = 1000, icl_examples: int = 10,
                 lengthN_sizes: int = 2000, **kwargs):
        self.max_actions = max_actions
        # enumerate, shuffle and split the sequences; padded with -1
        r = np.random.default_rng(split_seed)
        base = []
        for i in range(1, max_actions + 1):
            base += [list(s) for s in
                     itertools.product(range(len(VERB_NAMES)), repeat=i)]
        r.shuffle(base)

        def pad(seqs, width):
            out = np.full((len(seqs), width), -1, np.int32)
            for row, s in enumerate(seqs):
                out[row, :len(s)] = s
            return out

        ends = np.cumsum([0, train_size, val_size, test_size, icl_examples])
        self.splits = {name: pad(base[ends[i]:ends[i + 1]], max_actions)
                       for i, name in enumerate(("train", "val", "test", "icl_examples"))}
        # the length-extrapolation splits
        for i in range(1, max_actions + 1):
            seqs = r.integers(0, len(VERB_NAMES), size=(lengthN_sizes, i))
            self.splits[f"length+{i}"] = pad(list(seqs), max_actions)
        self._tables = SplitTables(self.splits)
        self.set_split("train")
        super().__init__(grid_size=size, see_through_walls=True,
                         max_steps=max_actions * 10, agent_view_size=size, **kwargs)

    def set_split(self, split: str) -> None:
        self.curr_split = split
        self.curr_idx = 0

    def next_sequence(self) -> np.ndarray:
        table = self.splits[self.curr_split]
        seq = table[self.curr_idx]
        self.curr_idx = (self.curr_idx + 1) % len(table)
        return seq

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        n = keys.shape[0]
        w = h = params.width
        k = rng.split(keys, 4).unbind(1)
        grid = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h)
        # the compass glyphs (the reference swaps height and width here; the
        # grid is square)
        red = C.COLOR_TO_IDX["red"]
        for name, (x, y) in [("west", (0, w // 2)), ("south", (h // 2, w - 1)),
                             ("east", (h - 1, w // 2)), ("north", (h // 2, 0))]:
            grid = G.put(grid, x, y, (C.OBJECT_TO_IDX[name], red, 0))
        table = self._tables.table(self.curr_split, dev)
        seq = table[rng.randint(k[0], (), 0, table.shape[0]).long()]
        agent_pos, _ = fixed_pose(n, ((w - 1) // 2, (h - 1) // 2), 0, dev)
        agent_dir = rng.randint(k[1], (), 0, 4)
        # mission = [start direction, verb ids padded with -1]
        mission = torch.cat([agent_dir[:, None], seq], dim=1)
        extra = {"seq": seq, "n_verbs": (seq >= 0).sum(dim=1, dtype=torch.int32),
                 "verb_step": torch.zeros((n,), dtype=torch.int32, device=dev),
                 "start_dir": agent_dir}
        return base_state(grid.expand(n, w, h), agent_pos, agent_dir, rng=k[2],
                          mission=mission, extra=extra, has_boxes=False)

    def step_state(self, state: EnvState, action, params: EnvParams):
        """The scripted turn: the action is ignored."""
        ex = state.extra
        step = ex["verb_step"].clamp(0, self.max_actions - 1)
        verb = ex["seq"].gather(1, step.long()[:, None])[:, 0]
        delta = G.const(_VERB_DELTA, state.grid.device, torch.int32)[verb.clamp(min=0).long()]
        verb_step = ex["verb_step"] + 1
        terminated = verb_step >= ex["n_verbs"]
        step_count = state.step_count + 1
        truncated = step_count >= params.max_steps
        state = state.replace(agent_dir=(state.agent_dir + delta) % 4,
                              step_count=step_count, terminated=terminated,
                              truncated=truncated, extra={**ex, "verb_step": verb_step})
        return state, torch.zeros_like(state.step_count, dtype=torch.float32), \
            terminated, truncated

    def mission_text(self, mission) -> str:
        m = np.asarray(mission)
        out = f"The robot is facing {DIRECTIONS_IDX_TO_STR[int(m[0])]}."
        for i, v in enumerate(m[1:]):
            if v < 0:
                break
            verb = VERB_NAMES[int(v)]
            out += f" The robot {verb}." if i == 0 else f" Then the robot {verb}."
        return out

    def outcome_text(self, state: EnvState) -> str:
        """The final-direction phrase of a one-env state."""
        return (" The robot is now facing "
                f"{DIRECTIONS_IDX_TO_STR[int(state.agent_dir.reshape(-1)[0])]}.")
