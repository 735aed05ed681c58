"""The transition, batch-first.

Counterpart of ``minigrid_tpu/core/step.py``: all eight actions
(left/right/forward/pickup/drop/toggle/done/stay) evaluated as masked selects
over the env batch, with the door lock FSM and the box-reveal toggle folded
into the same select tree.  At most one grid cell (the one in front of the
agent) changes per step; the port reads and writes it by direct indexing.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.grid_ops import (
    const_triple,
    pack_cells,
    read_word,
    unpack_cells,
    write_word,
)
from minigrid_tpu_torch.core.state import EnvParams, EnvState


def _table_ranges(table) -> list[tuple[int, int]]:
    """Contiguous index ranges where a boolean behavior table is True."""
    ids = np.where(np.asarray(table))[0]
    assert len(ids) > 0
    ranges, start, prev = [], int(ids[0]), int(ids[0])
    for i in ids[1:]:
        i = int(i)
        if i == prev + 1:
            prev = i
        else:
            ranges.append((start, prev))
            start = prev = i
    ranges.append((start, prev))
    return ranges


def in_table(t: torch.Tensor, ranges: list[tuple[int, int]]) -> torch.Tensor:
    """Membership of type ids in a behavior table as a compare-chain."""
    acc = None
    for lo, hi in ranges:
        c = (t == lo) if lo == hi else ((t >= lo) & (t <= hi))
        acc = c if acc is None else (acc | c)
    return acc


_OVERLAP_RANGES = _table_ranges(C.CAN_OVERLAP)
_PICKUP_RANGES = _table_ranges(C.CAN_PICKUP)


def dir_to_vec(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """DIR_TO_VEC as selects; int32 (dx, dy) of d's shape."""
    one, zero = torch.ones_like(d), torch.zeros_like(d)
    dx = torch.where(d == 0, one, torch.where(d == 2, -one, zero))
    dy = torch.where(d == 1, one, torch.where(d == 3, -one, zero))
    return dx, dy


_DOOR = C.OBJECT_TO_IDX["door"]
_KEY = C.OBJECT_TO_IDX["key"]
_BOX = C.OBJECT_TO_IDX["box"]
_GOAL = C.OBJECT_TO_IDX["goal"]
_LAVA = C.OBJECT_TO_IDX["lava"]
_EMPTY_T = C.OBJECT_TO_IDX["empty"]
_OPEN = C.STATE_TO_IDX["open"]
_LOCKED = C.STATE_TO_IDX["locked"]

LEFT, RIGHT, FORWARD, PICKUP, DROP, TOGGLE, DONE, STAY = range(8)
NUM_ACTIONS = 8


class Actions(IntEnum):
    """User-facing action enum, same names/values as the reference."""

    left = 0
    right = 1
    forward = 2
    pickup = 3
    drop = 4
    toggle = 5
    done = 6
    stay = 7


@dataclass
class StepOutcome:
    """What base_step observed and decided, per env; families build task
    rewards on top."""

    fwd_pos: torch.Tensor  # int32[B, 2] — cell in front (pre-action direction)
    fwd_cell: torch.Tensor  # uint8[B, 3] — its contents before the action
    moved: torch.Tensor  # bool[B]
    picked_up: torch.Tensor  # bool[B]
    dropped: torch.Tensor  # bool[B]
    toggled_door: torch.Tensor  # bool[B] — a door FSM transition fired
    prev_carrying: torch.Tensor  # uint8[B, 3]


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """``a * b + c`` for float32 ``a``, ``b``, rounded to float32 once, as a
    fused multiply-add rounds it.

    The product is exact in float64; the sum is rounded to odd there (TwoSum
    gives the error, and an inexact sum with an even last bit moves one ulp
    toward the exact value), which makes the final float32 rounding exact."""
    p = a.double() * b.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def episode_limit(state: EnvState, params: EnvParams) -> torch.Tensor:
    """float32[B] step limit of each env: its own ``max_steps``, or the
    static ``params.max_steps`` where that is 0."""
    return torch.where(state.max_steps > 0, state.max_steps,
                       torch.full_like(state.max_steps, params.max_steps)
                       ).to(torch.float32)


def goal_reward(step_count: torch.Tensor, max_steps: torch.Tensor) -> torch.Tensor:
    """``1 - 0.9 * (step_count / max_steps)`` in float32, for int32
    ``step_count`` and float32 ``max_steps``.

    XLA compiles the JAX package's expression into one fused multiply-add
    (the product is not rounded on its own), so the port rounds the same way:
    a plain torch multiply then subtract differs from it by one ulp in about
    a third of the cases."""
    frac = step_count.to(torch.float32) / max_steps
    return _fma_f32(torch.full_like(frac, -0.9), frac, 1.0)


def can_overlap(cell: torch.Tensor) -> torch.Tensor:
    """Walkability of (..., 3) cell triples: the type table plus open doors."""
    t = cell[..., 0].to(torch.int32)
    s = cell[..., 2].to(torch.int32)
    return in_table(t, _OVERLAP_RANGES) | ((t == _DOOR) & (s == _OPEN))


def base_step(
    state: EnvState, action: torch.Tensor, params: EnvParams
) -> tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor, StepOutcome]:
    """One transition of every env.  Returns (state', reward float32[B],
    terminated, truncated, outcome).

    reward = 1 - 0.9 * step_count / max_steps on reaching the goal, with
    step_count already incremented (:func:`goal_reward`); termination on
    goal or lava, truncation at max_steps."""
    dev = state.grid.device
    action = action.to(torch.int32)
    step_count = state.step_count + 1
    max_steps = episode_limit(state, params)
    empty = const_triple(C.EMPTY_TRIPLE, dev)
    wall = const_triple(C.WALL_TRIPLE, dev)

    is_left = action == LEFT
    is_right = action == RIGHT
    is_forward = action == FORWARD
    is_pickup = action == PICKUP
    is_drop = action == DROP
    is_toggle = action == TOGGLE

    d = state.agent_dir
    new_dir = torch.where(is_left, (d + 3) % 4,
                          torch.where(is_right, (d + 1) % 4, d))

    # front cell, from the PRE-action direction
    dx, dy = dir_to_vec(d)
    fwd_pos = state.agent_pos + torch.stack([dx, dy], dim=-1)
    w, h = params.width, params.height
    fx, fy = fwd_pos[:, 0], fwd_pos[:, 1]
    in_bounds = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    cx = fx.clamp(0, w - 1)
    cy = fy.clamp(0, h - 1)
    fwd_word = read_word(state.grid, cx, cy)
    fwd_cell = torch.where(in_bounds[:, None], unpack_cells(fwd_word), wall)
    has_boxes = state.box_contains is not None
    if has_boxes:
        fwd_contains = unpack_cells(read_word(state.box_contains, cx, cy))
    else:
        fwd_contains = empty
    fwd_type = fwd_cell[:, 0].to(torch.int32)
    fwd_state = fwd_cell[:, 2].to(torch.int32)
    fwd_is_none = fwd_type == _EMPTY_T
    carry_type = state.carrying[:, 0].to(torch.int32)
    hands_free = carry_type == _EMPTY_T

    # forward
    moved = is_forward & can_overlap(fwd_cell) & in_bounds
    new_pos = torch.where(moved[:, None], fwd_pos, state.agent_pos)
    hit_goal = is_forward & (fwd_type == _GOAL)
    hit_lava = is_forward & (fwd_type == _LAVA)
    terminated = hit_goal | hit_lava
    reward = goal_reward(step_count, max_steps)
    reward = torch.where(hit_goal, reward, torch.zeros_like(reward))

    # pickup / drop / toggle
    picked_up = (is_pickup & in_table(fwd_type, _PICKUP_RANGES)
                 & hands_free & in_bounds)
    dropped = is_drop & fwd_is_none & ~hands_free & in_bounds
    toggling = is_toggle & ~fwd_is_none & (fwd_type != 0) & in_bounds
    is_door = fwd_type == _DOOR
    is_locked = fwd_state == _LOCKED
    has_matching_key = (carry_type == _KEY) & (state.carrying[:, 1] == fwd_cell[:, 1])
    # Door FSM: locked+key -> open; locked without key stays locked;
    # open <-> closed otherwise.
    new_door_state = torch.where(
        is_locked,
        torch.where(has_matching_key, torch.full_like(fwd_state, _OPEN),
                    torch.full_like(fwd_state, _LOCKED)),
        1 - fwd_state,
    ).to(torch.uint8)
    toggle_door = toggling & is_door
    toggled_door = toggle_door & (is_locked & has_matching_key | ~is_locked)
    # Box reveal: cell <- contents, contents plane cleared.
    toggle_box = toggling & (fwd_type == _BOX)

    # the single front-cell write
    door_cell = torch.stack([fwd_cell[:, 0], fwd_cell[:, 1], new_door_state], dim=-1)
    new_fwd_cell = fwd_cell
    new_fwd_cell = torch.where(picked_up[:, None], empty, new_fwd_cell)
    new_fwd_cell = torch.where(dropped[:, None], state.carrying, new_fwd_cell)
    new_fwd_cell = torch.where(toggle_door[:, None], door_cell, new_fwd_cell)
    new_fwd_cell = torch.where(toggle_box[:, None], fwd_contains, new_fwd_cell)
    grid = write_word(state.grid, cx, cy,
                      torch.where(in_bounds, pack_cells(new_fwd_cell), fwd_word))

    if has_boxes:
        old_contains = read_word(state.box_contains, cx, cy)
        new_fwd_contains = fwd_contains
        new_fwd_contains = torch.where((picked_up | toggle_box)[:, None], empty,
                                       new_fwd_contains)
        new_fwd_contains = torch.where(dropped[:, None], state.carrying_contains,
                                       new_fwd_contains)
        box_contains = write_word(
            state.box_contains, cx, cy,
            torch.where(in_bounds, pack_cells(new_fwd_contains), old_contains))
        new_carrying_contains = torch.where(
            picked_up[:, None], fwd_contains,
            torch.where(dropped[:, None], empty, state.carrying_contains))
    else:
        box_contains = None
        new_carrying_contains = None

    new_carrying = torch.where(
        picked_up[:, None], fwd_cell,
        torch.where(dropped[:, None], empty, state.carrying))

    truncated = step_count >= max_steps.to(torch.int32)

    new_state = state.replace(
        grid=grid,
        box_contains=box_contains,
        agent_pos=new_pos,
        agent_dir=new_dir,
        carrying=new_carrying,
        carrying_contains=new_carrying_contains,
        step_count=step_count,
        terminated=terminated,
        truncated=truncated,
    )
    outcome = StepOutcome(
        fwd_pos=fwd_pos,
        fwd_cell=fwd_cell,
        moved=moved,
        picked_up=picked_up,
        dropped=dropped,
        toggled_door=toggled_door,
        prev_carrying=state.carrying,
    )
    return new_state, reward, terminated, truncated, outcome
