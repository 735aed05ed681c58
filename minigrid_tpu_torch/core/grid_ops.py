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


@functools.cache
def _const(values: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, device, dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """A small host table (ints) as a tensor on ``device``, copied there once
    per device and then reused: a per-call copy from host memory would stall
    the stream.  Callers must not write to it."""
    return _const(tuple(int(v) for v in np.asarray(values).reshape(-1)),
                  torch.device(device), dtype).view(np.shape(values))


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


def types(grid: torch.Tensor) -> torch.Tensor:
    """int32 type ids of packed cells."""
    return grid & 0xFF


def colors(grid: torch.Tensor) -> torch.Tensor:
    """int32 color ids of packed cells."""
    return (grid >> 8) & 0xFF


def states(grid: torch.Tensor) -> torch.Tensor:
    """int32 door-state field of packed cells."""
    return (grid >> 16) & 0xFF


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype ``jnp.sum`` gives a table of ``dtype``: integers and bools
    widen to 32 bits (int32 here, the port's word type), floats keep
    theirs."""
    return dtype if dtype.is_floating_point else torch.int32


def _pick(table: torch.Tensor, idx: torch.Tensor, lead: int) -> torch.Tensor:
    """``table[..., idx]`` along dim ``lead`` with the JAX masked reduce's
    values: an index outside the table reads 0.  ``table`` is one shared
    table (``lead == 0``) or one per entry of ``idx``'s leading dims."""
    n = table.shape[lead]
    idx = idx.to(torch.int64)
    inside = (idx >= 0) & (idx < n)
    safe = idx.clamp(0, n - 1)
    if lead == 0:
        out = table[safe]
    else:
        # the index dims past the leading ones flatten into one gather dim
        rest = table.shape[lead + 1:]
        flat = safe.reshape(safe.shape[:lead] + (-1,))
        flat = flat.reshape(flat.shape + (1,) * len(rest)).expand(
            flat.shape + rest)
        out = table.gather(lead, flat).reshape(safe.shape + rest)
    mask = inside.reshape(inside.shape + (1,) * (out.dim() - inside.dim()))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype, device=out.device))


def take1(vec, i: torch.Tensor) -> torch.Tensor:
    """One element of a small table per index: ``vec[i]`` for a shared 1-D
    table, or ``vec[..., i]`` for one table per index (``vec`` of shape
    ``i.shape + (n,)``).  As the JAX masked reduce: an index outside the
    table reads 0, and the dtype is the one ``jnp.sum`` gives (int32 for
    integer and bool tables)."""
    vec = torch.as_tensor(vec, device=i.device)
    lead = 0 if vec.dim() == 1 else i.dim()
    return _pick(vec, i, lead).to(_sum_dtype(vec.dtype))


def take_row(mat: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` of one small ``[n, ...]`` table per index (``mat`` of shape
    ``i.shape + (n, ...)``), in ``mat``'s dtype; rows outside read 0."""
    return _pick(mat, i, i.dim())


def take_vec(vec, idxs: torch.Tensor) -> torch.Tensor:
    """``vec[idxs]`` for a shared 1-D table, or one table per leading entry
    (``vec`` of shape ``idxs.shape[:-1] + (n,)``), in ``vec``'s dtype;
    indices outside read 0."""
    vec = torch.as_tensor(vec, device=idxs.device)
    lead = 0 if vec.dim() == 1 else vec.dim() - 1
    return _pick(vec, idxs, lead)


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


def read_cell(grid: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """uint8 (type, color, state) triple at (x, y) of each grid; in bounds."""
    return unpack_cells(read_word(grid, x, y))


def put_if(grid: torch.Tensor, x, y, triple, enabled=True) -> torch.Tensor:
    """put where ``enabled`` (a bool or one per grid); elsewhere the grid
    passes through."""
    xs, ys = coords(grid.shape[-2], grid.shape[-1], grid.device)
    mask = (xs == _per_grid(x)) & (ys == _per_grid(y)) & _per_grid(enabled)
    return set_where(grid, mask, triple)


def horz_wall(grid: torch.Tensor, x, y, length=None, triple=None) -> torch.Tensor:
    """A row of walls (or of ``triple``) from (x, y), ``length`` cells long,
    to the right edge when ``length`` is None."""
    w, h = grid.shape[-2], grid.shape[-1]
    length = w - x if length is None else length
    triple = C.WALL_TRIPLE if triple is None else triple
    xs, ys = coords(w, h, grid.device)
    x, y, length = (_per_grid(v) for v in (x, y, length))
    return set_where(grid, (ys == y) & (xs >= x) & (xs < x + length), triple)


def vert_wall(grid: torch.Tensor, x, y, length=None, triple=None) -> torch.Tensor:
    """A column of walls (or of ``triple``) from (x, y), ``length`` cells
    long, to the bottom edge when ``length`` is None."""
    w, h = grid.shape[-2], grid.shape[-1]
    length = h - y if length is None else length
    triple = C.WALL_TRIPLE if triple is None else triple
    xs, ys = coords(w, h, grid.device)
    x, y, length = (_per_grid(v) for v in (x, y, length))
    return set_where(grid, (xs == x) & (ys >= y) & (ys < y + length), triple)


def is_empty(grid: torch.Tensor) -> torch.Tensor:
    """Mask of cells that encode None (type empty)."""
    return (grid & 0xFF) == _EMPTY_T


def rect_mask(width: int, height: int, top: tuple, size: tuple,
              device) -> torch.Tensor:
    """Mask of the place_obj search rectangle: top clamped at 0, extent
    clamped to the grid.  Each of ``top``/``size``'s entries is a Python int
    or a tensor of one value per grid; the mask is (W, H), or batched over
    the tensors' shape."""
    xs, ys = coords(width, height, device)

    def lo(v):
        return v.clamp(min=0) if isinstance(v, torch.Tensor) else max(int(v), 0)

    def hi(t, n, limit):
        if isinstance(t, torch.Tensor) or isinstance(n, torch.Tensor):
            return torch.clamp(torch.as_tensor(t + n, device=device), max=limit)
        return min(t + int(n), limit)

    tx, ty = lo(top[0]), lo(top[1])
    ex, ey = hi(tx, size[0], width), hi(ty, size[1], height)
    tx, ty, ex, ey = (_per_grid(v) for v in (tx, ty, ex, ey))
    return (xs >= tx) & (xs < ex) & (ys >= ty) & (ys < ey)


def sample_cell(keys: torch.Tensor, mask: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform draw over the True cells of each (W, H) mask of a batch
    ``[B, W, H]``, one key of ``keys`` (int64[B, 2]) per grid.

    Returns (pos int32[B, 2], ok bool[B]).  ``ok`` is False where the mask is
    empty, and pos is then (0, 0).  The draw is the JAX package's
    count-and-select: ``r = randint(0, max(total, 1))`` over the running count
    of True cells, and the first cell whose count exceeds r."""
    from minigrid_tpu_torch.core import rng  # rng -> state -> grid_ops

    b, w, h = mask.shape
    counts = torch.cumsum(mask.reshape(b, w * h).to(torch.int32), dim=1,
                          dtype=torch.int32)
    total = counts[:, -1]
    ok = total > 0
    r = rng.randint(keys, (), 0, torch.clamp(total, min=1))
    # counts is non-decreasing: the first index with counts > r is the
    # number of indices with counts <= r
    idx = (counts <= r[:, None]).sum(dim=1, dtype=torch.int32)
    pos = torch.stack([idx // h, idx % h], dim=1)
    return torch.where(ok[:, None], pos, torch.zeros_like(pos)), ok


def _cell_of(counts: torch.Tensor, r: torch.Tensor, h: int) -> torch.Tensor:
    """int32[B, 2] cell of the first running count above r, as JAX's
    ``argmax(counts > r)``: the cell (0, 0) where no count is above r."""
    idx = (counts <= r[:, None]).sum(dim=1, dtype=torch.int32)
    idx = torch.where(idx == counts.shape[1], torch.zeros_like(idx), idx)
    return torch.stack([idx // h, idx % h], dim=1)


def sample_two_distinct(keys: torch.Tensor, mask: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two distinct uniform cells of each (W, H) mask of a batch
    ``[B, W, H]`` from one running count.  Returns (pos1, pos2 int32[B, 2],
    ok bool[B]); ``ok`` is False where the mask has fewer than two cells,
    and the positions are then what the JAX draw gives."""
    from minigrid_tpu_torch.core import rng  # rng -> state -> grid_ops

    b, w, h = mask.shape
    counts = torch.cumsum(mask.reshape(b, w * h).to(torch.int32), dim=1,
                          dtype=torch.int32)
    total = counts[:, -1]
    k1, k2 = rng.split(keys).unbind(1)
    r1 = rng.randint(k1, (), 0, torch.clamp(total, min=1))
    r2 = rng.randint(k2, (), 0, torch.clamp(total - 1, min=1))
    r2 = r2 + (r2 >= r1).to(torch.int32)
    return _cell_of(counts, r1, h), _cell_of(counts, r2, h), total >= 2


def place_obj(keys: torch.Tensor, grid: torch.Tensor, triple,
              agent_pos: torch.Tensor | None = None, top: tuple = (0, 0),
              size: tuple | None = None,
              reject_mask: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """place_obj as one masked draw per grid of ``grid`` ``[B, W, H]``.

    Placement is uniform over cells that are empty, not the agent's
    (``agent_pos`` int32[B, 2]), inside the (top, size) rectangle and not in
    ``reject_mask``.  Returns (grid', pos int32[B, 2], ok bool[B]).
    ``triple=None`` reserves a cell without writing (the place_agent
    path).  ``top``/``size`` entries may be tensors of one value per grid."""
    _, w, h = grid.shape
    if size is None:
        size = (w, h)
    mask = is_empty(grid) & rect_mask(w, h, top, size, grid.device)
    if agent_pos is not None:
        xs, ys = coords(w, h, grid.device)
        mask = mask & ~((xs == _per_grid(agent_pos[:, 0]))
                        & (ys == _per_grid(agent_pos[:, 1])))
    if reject_mask is not None:
        mask = mask & ~reject_mask
    pos, ok = sample_cell(keys, mask)
    if triple is not None:
        xs, ys = coords(w, h, grid.device)
        write = ((xs == _per_grid(pos[:, 0])) & (ys == _per_grid(pos[:, 1]))
                 & _per_grid(ok))
        grid = set_where(grid, write, triple)
    return grid, pos, ok
