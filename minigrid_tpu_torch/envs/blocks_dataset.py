"""BlocksDataset: a scripted blocks-world stacking language dataset.

Counterpart of ``minigrid_tpu/envs/blocks_dataset.py``: five colored blocks
start in columns 1 to 5 of the bottom row; each scripted step picks a random
block and moves it, with everything stacked on it, on top of another random
column.  :meth:`step_state` ignores the action and draws from the state's
stream.  An episode lasts a drawn number of moves, weighted by permutation
counts; the phrases are rebuilt on the host.
"""

from __future__ import annotations

import math

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

INT_TO_WORD = {0: "zero", 1: "one", 2: "two", 3: "three", 4: "four",
               5: "five", 6: "six", 7: "seven", 8: "eight", 9: "nine",
               10: "ten"}
ALL_COLORS = ["red", "green", "blue", "yellow", "purple"]
_BLOCK = C.OBJECT_TO_IDX["block"]


class BlocksDataset(Env):
    name = "BlocksDataset"
    num_actions = 1  # scripted; the action is ignored

    def __init__(self, max_actions: int = 2, max_blocks: int = 5, **kwargs):
        self.max_actions = max_actions
        self.max_blocks = max_blocks
        self._color_ids = np.asarray([C.COLOR_TO_IDX[c] for c in ALL_COLORS], np.int32)
        # the number of moves, weighted by permutations(max_blocks, i); the
        # JAX package holds the weights in float32 and takes their log there
        p = np.asarray([math.factorial(max_blocks) // math.factorial(max_blocks - i)
                        for i in range(1, max_actions + 1)], np.float64)
        self._num_actions_p = (p / p.sum()).astype(np.float32)
        self._logits = {}
        size = max_blocks + 2
        super().__init__(grid_size=size, see_through_walls=True,
                         max_steps=max_actions * 10, **kwargs)

    def generate(self, keys: torch.Tensor, params: EnvParams,
                 device=None) -> EnvState:
        dev = resolve_device(device)
        keys = keys.to(dev)
        n, m = keys.shape[0], self.max_blocks
        w = h = params.width
        k = rng.split(keys, 4).unbind(1)
        grid = G.wall_rect(empty_grid(w, h, dev), 0, 0, w, h).expand(n, w, h)

        # the blocks in a random color order along the bottom row
        order = rng.permutation(k[0], m)
        colors = G.take_vec(G.const(self._color_ids, dev, torch.int32), order)
        pos = torch.stack([torch.arange(1, m + 1, dtype=torch.int32, device=dev),
                           torch.full((m,), h - 2, dtype=torch.int32, device=dev)], dim=1)
        for i in range(m):
            grid = G.put(grid, i + 1, h - 2, self._block(colors[:, i]))

        n_actions = 1 + rng.categorical(k[1], self._log_p(dev))
        extra = {
            "colors": colors,  # block i's color id
            "pos": pos.expand(n, m, 2).contiguous(),  # block i's (x, y)
            "n_actions": n_actions,
            "curr": torch.zeros((n,), dtype=torch.int32, device=dev),
            # per move: (block, end column), for the phrases
            "trace": torch.full((n, self.max_actions, 2), -1, dtype=torch.int32,
                                device=dev),
        }
        agent_pos, agent_dir = fixed_pose(n, (1, 1), 0, dev)
        return base_state(grid, agent_pos, agent_dir, rng=k[2], extra=extra,
                          has_boxes=False)

    def _log_p(self, dev) -> torch.Tensor:
        """``log`` of the move-count weights in float32, on ``dev`` once."""
        if dev not in self._logits:
            self._logits[dev] = torch.log(torch.from_numpy(self._num_actions_p).to(dev))
        return self._logits[dev]

    @staticmethod
    def _block(color: torch.Tensor) -> torch.Tensor:
        return torch.stack([torch.full_like(color, _BLOCK), color,
                            torch.zeros_like(color)], dim=1).to(torch.uint8)

    def step_state(self, state: EnvState, action, params: EnvParams):
        """One scripted stack move."""
        m = self.max_blocks
        h = params.height
        state, key = self.split_rng(state)
        k_block, k_col = rng.split(key).unbind(1)
        pos, colors = state.extra["pos"], state.extra["colors"]

        # a random block, and a random column other than its own
        bi = rng.randint(k_block, (), 0, m)
        start = G.take_row(pos, bi)
        sx, sy = start[:, 0:1], start[:, 1:2]
        rc = rng.randint(k_col, (), 0, m - 1)[:, None]
        end_col = 1 + rc + (rc + 1 >= sx).to(torch.int32)
        # the lowest free row of the end column
        end_row = (h - 2) - (pos[..., 0] == end_col).sum(dim=1, keepdim=True,
                                                         dtype=torch.int32)
        # the picked block and the ones stacked on it
        moved = (pos[..., 0] == sx) & (pos[..., 1] <= sy)
        new_pos = torch.stack([torch.where(moved, end_col, pos[..., 0]),
                               torch.where(moved, end_row - (sy - pos[..., 1]),
                                           pos[..., 1])], dim=-1)

        grid = state.grid
        for i in range(m):
            grid = G.put_if(grid, pos[:, i, 0], pos[:, i, 1], C.EMPTY_TRIPLE, moved[:, i])
        for i in range(m):
            grid = G.put_if(grid, new_pos[:, i, 0], new_pos[:, i, 1],
                            self._block(colors[:, i]), moved[:, i])

        curr = state.extra["curr"]
        row = (torch.arange(self.max_actions, device=curr.device)
               == curr.clamp(0, self.max_actions - 1)[:, None])
        trace = torch.where(row[..., None], torch.cat([bi[:, None], end_col], dim=1)[:, None],
                            state.extra["trace"])
        curr = curr + 1
        terminated = curr >= state.extra["n_actions"]
        state = state.replace(grid=grid, step_count=state.step_count + 1,
                              terminated=terminated,
                              extra={**state.extra, "pos": new_pos, "curr": curr,
                                     "trace": trace})
        return (state, torch.zeros_like(curr, dtype=torch.float32), terminated,
                torch.zeros_like(terminated))

    # -- the phrases, rebuilt on the host from a one-env state ---------------

    def init_phrase(self, state: EnvState) -> str:
        names = [C.IDX_TO_COLOR[int(c)] for c in np.asarray(state.extra["colors"]).ravel()]
        return (" ".join(f"a {c}," for c in names[:-1])
                + f" and a {names[-1]} block start in columns one through"
                " five respectively.").capitalize()

    def action_phrases(self, state: EnvState) -> list[str]:
        colors = np.asarray(state.extra["colors"]).ravel()
        out = []
        for i, (bi, col) in enumerate(np.asarray(state.extra["trace"]).reshape(-1, 2)):
            if bi < 0:
                break
            c1 = C.IDX_TO_COLOR[int(colors[bi])]
            verb = (f"picks up the {c1} block and places it in column "
                    f"{INT_TO_WORD[int(col)]}")
            out.append(f" The robot {verb}." if i == 0 else f" Then the robot {verb}.")
        return out

    def outcome_phrase(self, state: EnvState) -> str:
        """The tallest-tower query."""
        pos = np.asarray(state.extra["pos"]).reshape(-1, 2)
        colors = np.asarray(state.extra["colors"]).ravel()
        heights = np.zeros(self.max_blocks + 2, int)
        for x, _ in pos:
            heights[x] += 1
        tallest = int(np.argmax(heights[1:self.max_blocks + 1])) + 1
        stack = sorted([(y, c) for (x, y), c in zip(pos, colors) if x == tallest])
        names = [C.IDX_TO_COLOR[int(c)] for _, c in stack]
        block_s = "block" if len(names) == 1 else "blocks"
        out = (f" The tallest stack is in column {INT_TO_WORD[tallest]} and"
               f" is {INT_TO_WORD[len(names)]} {block_s} tall. It consists"
               " of the ")
        if len(names) == 1:
            return out + f"{names[0]} block."
        return out + f"{', '.join(names[:-1])}, and {names[-1]} blocks."

    def mission_text(self, mission) -> str:
        return ""
