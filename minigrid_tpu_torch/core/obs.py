"""Egocentric partial observation, batch-first.

Counterpart of ``minigrid_tpu/core/obs.py``.  The reference pipeline is
slice -> rotate -> occlusion (``process_vis``) -> carried-object overlay ->
encode.  Slice and rotation collapse into one gather: for view cell (vi, vj)
the world coordinate is

    world = agent_pos + f_vec * (V-1-vj) + r_vec * (vi - V//2)

with out-of-bounds cells reading as grey walls.  On CUDA tensors the whole
observation, occlusion, overlay and encode included, is one launch of the
hand-written kernel of :mod:`minigrid_tpu_torch.ops.obs_gather`; on CPU
tensors it is ``observe_grid_plain``/``observe_image_plain``: that module's
plain gather, then ``process_vis``, the overlay and ``encode_view`` in plain
torch.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.grid_ops import pack_cells, unpack_cells
from minigrid_tpu_torch.core.state import EnvParams, EnvState
from minigrid_tpu_torch.core.step import _table_ranges, dir_to_vec, in_table

_SEE_BEHIND_RANGES = _table_ranges(C.SEE_BEHIND)
_DOOR = C.OBJECT_TO_IDX["door"]
_OPEN = C.STATE_TO_IDX["open"]


def view_world_coords(
    agent_pos: torch.Tensor, agent_dir: torch.Tensor, view_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """World (x, y) of every view cell: int32[B, V, V] each, indexed
    [b, vi, vj].  The agent sits at view cell (V//2, V-1) facing up the
    view."""
    v = view_size
    f0, f1 = dir_to_vec(agent_dir)
    f0, f1 = f0[:, None, None], f1[:, None, None]
    r0, r1 = -f1, f0
    ar = torch.arange(v, dtype=torch.int32, device=agent_pos.device)
    vi = ar[None, :, None]
    vj = ar[None, None, :]
    wx = agent_pos[:, 0, None, None] + f0 * (v - 1 - vj) + r0 * (vi - v // 2)
    wy = agent_pos[:, 1, None, None] + f1 * (v - 1 - vj) + r1 * (vi - v // 2)
    return wx, wy


def _view_exts(agent_pos: torch.Tensor, agent_dir: torch.Tensor, view_size: int):
    """Top-left world corner (top_x, top_y) of the UNROTATED view rectangle
    for each env; int32[B] each."""
    half = view_size // 2
    px, py, d = agent_pos[:, 0], agent_pos[:, 1], agent_dir
    top_x = torch.where(d == 0, px,
                        torch.where(d == 2, px - view_size + 1, px - half))
    top_y = torch.where(d == 1, py,
                        torch.where(d == 3, py - view_size + 1, py - half))
    return top_x, top_y


def gather_view(grid, agent_pos, agent_dir, view_size: int) -> torch.Tensor:
    """The rotated egocentric window of every env, packed:
    int32[B, W, H] -> int32[B, V, V].  The kernel on CUDA tensors, the plain
    version on CPU tensors."""
    from minigrid_tpu_torch.ops import obs_gather

    return obs_gather.gather_view(grid, agent_pos, agent_dir, view_size)


def see_behind(cells: torch.Tensor) -> torch.Tensor:
    """Transparency of packed cells: the type table plus the open-door rule."""
    t = cells & 0xFF
    s = (cells >> 16) & 0xFF
    return in_table(t, _SEE_BEHIND_RANGES) & ((t != _DOOR) | (s == _OPEN))


def process_vis(cells: torch.Tensor, view_size: int) -> torch.Tensor:
    """Occlusion mask bool[B, V, V] over packed view cells int32[B, V, V];
    the agent at (V//2, V-1).

    Rows are processed bottom-up; within a row a left-to-right then
    right-to-left propagation runs, each visible transparent cell lighting
    its lateral neighbour and the cells ahead.  As in the JAX package, column
    j of the mask and see planes lives in one word (bit i = cell (i, j)) and
    the in-row recurrence is evaluated bit-parallel by doubling.  The words
    are int64, so no shift of a V <= 31 bit word reaches the sign bit."""
    v = view_size
    assert v <= 31
    b = cells.shape[0]
    dev = cells.device
    see = see_behind(cells).to(torch.int64)  # [B, V(i), V(j)]
    weights = torch.arange(v, dtype=torch.int64, device=dev)[None, :, None]
    see_cols = (see << weights).sum(dim=1)  # [B, V] — one word per column
    full = (1 << v) - 1
    not_last = (1 << (v - 1)) - 1
    not_first = full & ~1

    dists = []
    d = 1
    while d < v:
        dists.append(d)
        d *= 2

    zero = torch.zeros((b,), dtype=torch.int64, device=dev)
    cols = [zero] * v
    cols[v - 1] = torch.full((b,), 1 << (v // 2), dtype=torch.int64, device=dev)

    for j in range(v - 1, -1, -1):
        m = cols[j]
        s = see_cols[:, j]

        # L2R: m[i+1] |= m[i] & s[i]; P_d bit i = all-seen s[i-d .. i-1]
        p = (s << 1) & full
        for dd in dists:
            m = m | ((m << dd) & p & full)
            p = p & ((p << dd) & full)
        prop1 = m & s & not_last

        # R2L on the L2R result; Q_d bit i = all-seen s[i+1 .. i+d]
        q = s >> 1
        m2 = m
        for dd in dists:
            m2 = m2 | ((m2 >> dd) & q)
            q = q & (q >> dd)
        prop2 = m2 & s & not_first

        cols[j] = m2
        if j > 0:
            cols[j - 1] = (cols[j - 1] | prop1 | ((prop1 << 1) & full)
                           | prop2 | (prop2 >> 1))
    packed = torch.stack(cols, dim=1)  # [B, V(j)]
    return ((packed[:, None, :] >> weights) & 1) > 0


def observe_grid_plain(grid, agent_pos, agent_dir, carrying, view_size: int,
                       see_through: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(packed view cells int32[B, V, V] with the carried object uint8[B, 3]
    at (V//2, V-1), vis_mask bool[B, V, V]): the window, its occlusion (none
    with ``see_through``), then the overlay, in plain torch around
    :func:`gather_view`."""
    v = view_size
    cells = gather_view(grid, agent_pos, agent_dir, v)
    if see_through:
        vis_mask = torch.ones(cells.shape, dtype=torch.bool, device=cells.device)
    else:
        vis_mask = process_vis(cells, v)
    # The agent sees what it carries; empty hands encode as None.  The
    # window is a fresh tensor, so the overlay writes it in place.
    cells[:, v // 2, v - 1] = pack_cells(carrying)
    return cells, vis_mask


def encode_view(cells: torch.Tensor, vis_mask: torch.Tensor) -> torch.Tensor:
    """Masked encode: invisible cells -> unseen (0, 0, 0); packed
    int32[..., V, V] -> uint8[..., V, V, 3]."""
    return unpack_cells(torch.where(vis_mask, cells, torch.zeros_like(cells)))


def observe_image_plain(grid, agent_pos, agent_dir, carrying, view_size: int,
                        see_through: bool) -> torch.Tensor:
    """The encoded image uint8[B, V, V, 3] of :func:`observe_grid_plain`."""
    return encode_view(*observe_grid_plain(grid, agent_pos, agent_dir, carrying, view_size,
                                           see_through))


def _observe_args(states: EnvState, params: EnvParams) -> tuple:
    return (states.grid, states.agent_pos, states.agent_dir, states.carrying.contiguous(),
            params.agent_view_size, params.see_through_walls)


def gen_obs_grid_batch(
    states: EnvState, params: EnvParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """(packed view cells int32[B, V, V] with the carried-object overlay,
    vis_mask bool[B, V, V])."""
    from minigrid_tpu_torch.ops import obs_gather

    return obs_gather.observe_grid(*_observe_args(states, params))


def gen_obs_batch(states: EnvState, params: EnvParams) -> dict:
    """The observation dict of every env: image uint8[B, V, V, 3], direction
    int32[B], mission int32[B, M] (M = 4 for the MiniGrid families, 43 for
    a BabyAI instruction)."""
    from minigrid_tpu_torch.ops import obs_gather

    return {
        "image": obs_gather.observe_image(*_observe_args(states, params)),
        "direction": states.agent_dir,
        "mission": states.mission,
    }
