"""RGB rendering as a texture-atlas gather, batch-first.

Counterpart of ``minigrid_tpu/ops/render.py``.  The whole tile space —
(type × color × state) × (no agent | 4 agent directions) × (plain |
highlighted) — is rasterized ONCE per tile size on the host
(:mod:`minigrid_tpu_torch.utils.rendering`) into a texture atlas, and moved
to a device once per (tile size, device).  A frame is then one row gather
from the ``[NUM_VARIANTS * NUM_CODES, T*T*3]`` atlas and one permute:

    frame[b, j*T:(j+1)*T, i*T:(i+1)*T] = atlas[variant(b, i, j), code(b, i, j)]

Frames are row-major ``[y, x]`` like the reference's, and the first axis
within a tile is y.  The gather is ``index_select``: the JAX package's is an
XLA gather too, not a Pallas kernel.

Tracing (``utils/trace.py``) sees :func:`pov_render_batch` as the span
``render.pov`` and counts its frames as ``render.frames``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.obs import gen_obs_grid_batch, view_world_coords
from minigrid_tpu_torch.core.state import EnvParams, EnvState, resolve_device
from minigrid_tpu_torch.utils import rendering as R
from minigrid_tpu_torch.utils import trace

NUM_CODES = C.NUM_OBJECT_TYPES * C.NUM_COLORS * 3  # 34 * 11 * 3
NUM_VARIANTS = 10  # (plain | highlight) x (none | 4 agent dirs)
UNSEEN_PACKED = 1  # packed (empty, 0, 0): how the POV shows an invisible cell
POV_AGENT_VARIANT = 4  # the agent triangle facing up (dir slot 3 + 1)

_atlas_np: dict[int, np.ndarray] = {}
_atlas_dev: dict[tuple[int, str], torch.Tensor] = {}


def _build_atlas_np(tile_size: int, subdivs: int = 3) -> np.ndarray:
    """(NUM_VARIANTS, NUM_CODES, T, T, 3) uint8 texture atlas."""
    ss = tile_size * subdivs
    atlas = np.zeros((NUM_VARIANTS, NUM_CODES, tile_size, tile_size, 3),
                     dtype=np.uint8)
    base = np.zeros((ss, ss, 3), dtype=np.uint8)
    for t in range(C.NUM_OBJECT_TYPES):
        for c in range(C.NUM_COLORS):
            for s in range(3):
                code = (t * C.NUM_COLORS + c) * 3 + s
                base[:] = 0
                R.fill(base, R.rect(0, 0.031, 0, 1), (100, 100, 100))
                R.fill(base, R.rect(0, 1, 0, 0.031), (100, 100, 100))
                try:
                    R.paint_object(base, t, c, s)
                except (ValueError, KeyError):
                    pass  # codes with no painter render as bare tiles
                for agent_slot in range(5):
                    img = base.copy()
                    if agent_slot > 0:
                        tri = R.triangle((0.12, 0.19), (0.87, 0.50), (0.12, 0.81))
                        tri = R.rotate(tri, 0.5, 0.5,
                                       0.5 * math.pi * (agent_slot - 1))
                        R.fill(img, tri, (255, 0, 0))
                    atlas[agent_slot, code] = R.downsample(img, subdivs).astype(
                        np.uint8)
                    hl = img.copy()
                    R.highlight(hl)
                    atlas[5 + agent_slot, code] = R.downsample(
                        hl, subdivs).astype(np.uint8)
    return atlas


def atlas_np(tile_size: int = C.TILE_PIXELS) -> np.ndarray:
    """The host atlas of a tile size, built once and cached."""
    if tile_size not in _atlas_np:
        _atlas_np[tile_size] = _build_atlas_np(tile_size)
    return _atlas_np[tile_size]


def get_atlas(tile_size: int = C.TILE_PIXELS, device=None) -> torch.Tensor:
    """The atlas as uint8[NUM_VARIANTS, NUM_CODES, T, T, 3] on ``device``
    (CUDA unless named): built on the host once per tile size, moved to a
    device once per (tile size, device)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (tile_size, str(dev))
    if key not in _atlas_dev:
        _atlas_dev[key] = torch.from_numpy(atlas_np(tile_size)).to(dev)
    return _atlas_dev[key]


def cell_codes(grid: torch.Tensor) -> torch.Tensor:
    """Atlas code per packed cell: (type*11 + color)*3 + state, int64 of
    the grid's shape."""
    g = grid.to(torch.int64)
    t, c, s = g & 0xFF, (g >> 8) & 0xFF, (g >> 16) & 0xFF
    return (t * C.NUM_COLORS + c) * 3 + s


def tile_frames(atlas: torch.Tensor, flat: torch.Tensor,
                channels_first: bool = False) -> torch.Tensor:
    """The atlas gather: flat atlas indices (variant * NUM_CODES + code)
    int64[B, X, Y] -> frames uint8[B, Y*T, X*T, 3], or uint8[B, 3, Y*T, X*T]
    with ``channels_first``.  One ``index_select`` of T*T*3-byte rows, then
    one copy into the frame layout (row-major [y, x], within a tile y
    first)."""
    b, nx, ny = flat.shape
    tile = atlas.shape[-2]
    rows = atlas.reshape(NUM_VARIANTS * NUM_CODES, tile * tile * 3)
    tiles = rows.index_select(0, flat.reshape(-1)).reshape(b, nx, ny, tile, tile, 3)
    if channels_first:
        return tiles.permute(0, 5, 2, 3, 1, 4).reshape(b, 3, ny * tile, nx * tile)
    return tiles.permute(0, 2, 3, 1, 4, 5).reshape(b, ny * tile, nx * tile, 3)


def render_grid(
    grid: torch.Tensor,
    atlas: torch.Tensor,
    agent_pos: torch.Tensor | None = None,
    agent_dir: torch.Tensor | None = None,
    highlight_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Grid.render (grid.py:200-242) as one gather: packed int32[B, W, H]
    -> uint8[B, H*T, W*T, 3]; ``agent_pos`` int32[B, 2], ``agent_dir``
    int32[B], ``highlight_mask`` bool[B, W, H]."""
    b, w, h = grid.shape
    variant = torch.zeros((b, w, h), dtype=torch.int64, device=grid.device)
    if agent_pos is not None:
        xs = torch.arange(w, device=grid.device)[None, :, None]
        ys = torch.arange(h, device=grid.device)[None, None, :]
        at_agent = (xs == agent_pos[:, 0, None, None]) & (ys == agent_pos[:, 1, None, None])
        variant = torch.where(at_agent, 1 + agent_dir.to(torch.int64)[:, None, None],
                              variant)
    if highlight_mask is not None:
        variant = variant + 5 * highlight_mask.to(torch.int64)
    return tile_frames(atlas, variant * NUM_CODES + cell_codes(grid))


def highlight_mask(states: EnvState, params: EnvParams) -> torch.Tensor:
    """bool[B, W, H]: the world cells the agent sees, at the state's own
    ``agent_view_size`` — the visible view cells scattered back onto the
    grid (view cells map to distinct world cells)."""
    b, w, h = states.grid.shape
    wx, wy = view_world_coords(states.agent_pos, states.agent_dir,
                               params.agent_view_size)
    _, vis = gen_obs_grid_batch(states, params)
    seen = vis & (wx >= 0) & (wx < w) & (wy >= 0) & (wy < h)
    # cells not seen go to a spare column past the grid, cut off below
    idx = torch.where(seen, wx * h + wy, w * h).to(torch.int64).reshape(b, -1)
    mask = torch.zeros((b, w * h + 1), dtype=torch.bool, device=states.grid.device)
    mask.scatter_(1, idx, True)
    return mask[:, :w * h].reshape(b, w, h)


def full_render(states: EnvState, params: EnvParams, atlas: torch.Tensor,
                highlight: bool = True) -> torch.Tensor:
    """get_full_render (minigrid_env.py:669-715): each env's world frame,
    uint8[B, H*T, W*T, 3], with the agent's visible view highlighted."""
    hmask = highlight_mask(states, params) if highlight else None
    return render_grid(states.grid, atlas, states.agent_pos, states.agent_dir, hmask)


def pov_indices(states: EnvState, params: EnvParams) -> torch.Tensor:
    """The atlas rows of every env's POV, int64[B, V, V]: its view cells
    (invisible ones the packed empty word), the agent's tile at
    (V//2, V-1) facing up."""
    v = params.agent_view_size
    cells, vis = gen_obs_grid_batch(states, params)  # packed int32[B, V, V]
    codes = cell_codes(torch.where(vis, cells, UNSEEN_PACKED))
    variant = torch.zeros((v, v), dtype=torch.int64, device=codes.device)
    variant[v // 2, v - 1] = POV_AGENT_VARIANT
    return variant * NUM_CODES + codes


def pov_render_batch(states: EnvState, params: EnvParams, atlas: torch.Tensor,
                     channels_first: bool = False) -> torch.Tensor:
    """get_pov_render (minigrid_env.py:653-667) of every env: the agent's
    view with invisible cells blanked, the agent at (V//2, V-1) facing up.
    uint8[B, V*T, V*T, 3], or uint8[B, 3, V*T, V*T] with
    ``channels_first``; contiguous either way."""
    with trace.span("render.pov"):
        trace.count("render.frames", states.agent_dir.shape[0])
        return tile_frames(atlas, pov_indices(states, params), channels_first)


def pov_render(states: EnvState, params: EnvParams,
               atlas: torch.Tensor) -> torch.Tensor:
    """The JAX package's per-env ``pov_render``; here the batch, in the
    reference's HWC layout."""
    return pov_render_batch(states, params, atlas)


def get_frame(states: EnvState, params: EnvParams, highlight: bool = True,
              tile_size: int = C.TILE_PIXELS, agent_pov: bool = False) -> torch.Tensor:
    """MiniGridEnv.get_frame (minigrid_env.py:717-740) of every env."""
    atlas = get_atlas(tile_size, states.grid.device)
    if agent_pov:
        return pov_render(states, params, atlas)
    return full_render(states, params, atlas, highlight=highlight)
