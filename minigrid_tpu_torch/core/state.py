"""Environment state as a dataclass of batch-first tensors.

Counterpart of ``minigrid_tpu/core/state.py``.  Where the JAX package keeps one
env's state as a pytree and vmaps over a batch, the port keeps the batch: the
leading dim of every field is the env batch B.

``Box.contains`` is the only per-cell state the packed cell word cannot
carry: it lives in a parallel ``box_contains`` plane, and a matching
``carrying_contains`` triple follows a carried box.  Families whose cells can
never hold a box (DoorKey) leave both as ``None``, and the step skips the box
logic.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

from minigrid_tpu_torch.core.constants import EMPTY_TRIPLE
from minigrid_tpu_torch.core.grid_ops import const_triple, pack_word


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Without a card the default raises; it never carries on on the
    CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclass
class EnvState:
    """Per-env episode state, batch-first."""

    grid: torch.Tensor  # int32[B, W, H] — packed (type | color<<8 | state<<16)
    box_contains: torch.Tensor | None  # int32[B, W, H] packed contents, or None
    agent_pos: torch.Tensor  # int32[B, 2] — (x, y)
    agent_dir: torch.Tensor  # int32[B] — 0 east / 1 south / 2 west / 3 north
    carrying: torch.Tensor  # uint8[B, 3] — carried triple; type empty => hands free
    carrying_contains: torch.Tensor | None  # uint8[B, 3] contents of a carried box
    step_count: torch.Tensor  # int32[B]
    terminated: torch.Tensor  # bool[B]
    truncated: torch.Tensor  # bool[B]
    rng: torch.Tensor  # int64[B, 2] — threefry key words (uint32 values)
    mission: torch.Tensor  # int32[B, 4] — packed mission code
    max_steps: torch.Tensor  # int32[B] — per-episode limit; 0 = params.max_steps

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class EnvParams:
    """Static episode configuration (Python scalars)."""

    width: int = 8
    height: int = 8
    max_steps: int = 100
    agent_view_size: int = 7
    see_through_walls: bool = False


def map_fields(fn: Callable, *states):
    """Apply ``fn`` field by field across dataclass states of one type,
    skipping fields that are ``None``."""
    first = states[0]
    out = {}
    for f in dataclasses.fields(first):
        vals = [getattr(s, f.name) for s in states]
        out[f.name] = None if vals[0] is None else fn(*vals)
    return type(first)(**out)


def empty_grid(width: int, height: int, device, batch: tuple = ()) -> torch.Tensor:
    """A packed grid of 'empty' cells, shape ``batch + (W, H)``."""
    return torch.full(batch + (width, height), pack_word(EMPTY_TRIPLE),
                      dtype=torch.int32, device=device)


def no_object(batch: int, device) -> torch.Tensor:
    """uint8[B, 3] triples meaning 'no object' (hands free / box empty)."""
    return const_triple(EMPTY_TRIPLE, device).expand(batch, 3).clone()


def base_state(
    grid: torch.Tensor,
    agent_pos: torch.Tensor,
    agent_dir: torch.Tensor,
    rng: torch.Tensor,
    mission: torch.Tensor | None = None,
    box_contains: torch.Tensor | None = None,
    max_steps=0,
    has_boxes: bool = True,
) -> EnvState:
    """A fresh batch of states at step 0.  ``has_boxes=False`` drops the
    ``box_contains``/``carrying_contains`` planes."""
    b, w, h = grid.shape
    dev = grid.device
    if box_contains is None and has_boxes:
        box_contains = empty_grid(w, h, dev, (b,))
    if mission is None:
        mission = torch.zeros((b, 4), dtype=torch.int32, device=dev)
    return EnvState(
        grid=grid,
        box_contains=box_contains,
        agent_pos=agent_pos.to(torch.int32),
        agent_dir=agent_dir.to(torch.int32),
        carrying=no_object(b, dev),
        carrying_contains=no_object(b, dev) if has_boxes else None,
        step_count=torch.zeros((b,), dtype=torch.int32, device=dev),
        terminated=torch.zeros((b,), dtype=torch.bool, device=dev),
        truncated=torch.zeros((b,), dtype=torch.bool, device=dev),
        rng=rng,
        mission=mission.to(torch.int32),
        max_steps=torch.full((b,), max_steps, dtype=torch.int32, device=dev),
    )
