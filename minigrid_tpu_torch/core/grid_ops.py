"""Grid construction ops over the packed cell words.

Counterpart of ``minigrid_tpu/core/grid_ops.py``.  A grid is ``int32[..., W, H]``
with each cell's (type, color, state) triple packed into one word:
``type | color << 8 | state << 16``.  Every field is below 256, so every word
is below 2^24 and int32 holds it without loss (the JAX package keeps the same
words as uint32).

The builders take a batch of grids with any leading dims; a coordinate is a
Python int (the same for every grid) or a tensor of the leading shape (one
per grid).  Where the JAX package reads and writes single cells as masked
reduces and selects (a TPU lowering constraint), the port indexes directly and
returns the same values.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C

_EMPTY_T = C.OBJECT_TO_IDX["empty"]


def pack_word(triple) -> int:
    """One (type, color, state) triple -> its packed word, as a Python int."""
    t = np.asarray(triple).astype(np.int64)
    return int(t[0]) | (int(t[1]) << 8) | (int(t[2]) << 16)


@functools.cache
def _const_triple(triple: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(triple, dtype=torch.uint8, device=device)


def const_triple(triple, device) -> torch.Tensor:
    """A host (type, color, state) triple as uint8[3] on ``device``, copied
    there once per device and then reused."""
    return _const_triple(tuple(int(v) for v in np.asarray(triple)),
                         torch.device(device))


def pack_cells(cells: torch.Tensor) -> torch.Tensor:
    """(..., 3) triples (any integer dtype) -> packed int32[...]."""
    c = cells.to(torch.int32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)


def unpack_cells(packed: torch.Tensor) -> torch.Tensor:
    """packed int32[...] -> uint8[..., 3] (type, color, state)."""
    return torch.stack(
        [packed & 0xFF, (packed >> 8) & 0xFF, (packed >> 16) & 0xFF], dim=-1
    ).to(torch.uint8)


def pack_np(cells: np.ndarray) -> np.ndarray:
    """Host-side pack: numpy (..., 3) -> int32[...]."""
    c = np.asarray(cells).astype(np.int32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)


def unpack_np(packed: np.ndarray) -> np.ndarray:
    """Host-side unpack: numpy packed words -> uint8[..., 3]."""
    p = np.asarray(packed)
    return np.stack(
        [p & 0xFF, (p >> 8) & 0xFF, (p >> 16) & 0xFF], axis=-1
    ).astype(np.uint8)


def coords(width: int, height: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, H) x / y index planes."""
    xs = torch.arange(width, dtype=torch.int32, device=device)[:, None]
    ys = torch.arange(height, dtype=torch.int32, device=device)[None, :]
    return xs.expand(width, height), ys.expand(width, height)


def _per_grid(v):
    """A coordinate or word per grid, broadcast over the trailing (W, H)."""
    return v[..., None, None] if isinstance(v, torch.Tensor) else v


def set_where(grid: torch.Tensor, mask: torch.Tensor, triple) -> torch.Tensor:
    """Write ``triple`` at every cell where ``mask`` is True.  ``triple`` is
    one host triple, or a tensor (..., 3) of one triple per grid."""
    if isinstance(triple, torch.Tensor):
        word = _per_grid(pack_cells(triple))
    else:
        word = pack_word(triple)
    return torch.where(mask, word, grid)


def put(grid: torch.Tensor, x, y, triple) -> torch.Tensor:
    """put_obj: single-cell write at (x, y)."""
    xs, ys = coords(grid.shape[-2], grid.shape[-1], grid.device)
    mask = (xs == _per_grid(x)) & (ys == _per_grid(y))
    return set_where(grid, mask, triple)


def wall_rect(grid: torch.Tensor, x, y, rw, rh, triple=None) -> torch.Tensor:
    """Rectangle outline of walls (or of ``triple``)."""
    triple = C.WALL_TRIPLE if triple is None else triple
    xs, ys = coords(grid.shape[-2], grid.shape[-1], grid.device)
    x, y, rw, rh = (_per_grid(v) for v in (x, y, rw, rh))
    inside = (xs >= x) & (xs < x + rw) & (ys >= y) & (ys < y + rh)
    border = inside & (
        (xs == x) | (xs == x + rw - 1) | (ys == y) | (ys == y + rh - 1)
    )
    return set_where(grid, border, triple)


def read_word(grid: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Packed word at (x, y) of each grid; x, y have the grids' leading shape
    and must be in bounds."""
    h = grid.shape[-1]
    flat = grid.flatten(-2)
    idx = (x.to(torch.int64) * h + y.to(torch.int64))[..., None]
    return flat.gather(-1, idx)[..., 0]


def write_word(grid: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               word: torch.Tensor) -> torch.Tensor:
    """A copy of the grids with ``word`` written at (x, y) of each; x, y and
    word have the grids' leading shape and x, y must be in bounds."""
    h = grid.shape[-1]
    idx = (x.to(torch.int64) * h + y.to(torch.int64))[..., None]
    flat = grid.flatten(-2).scatter(-1, idx, word[..., None])
    return flat.view(grid.shape)


def is_empty(grid: torch.Tensor) -> torch.Tensor:
    """Mask of cells that encode None (type empty)."""
    return (grid & 0xFF) == _EMPTY_T
