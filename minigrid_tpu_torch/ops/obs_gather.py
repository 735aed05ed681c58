"""The egocentric observation: CUDA kernel, plain versions and wrappers.

Replaces the JAX package's Pallas kernel ``ops/obs_pallas.py::_make_kernel``
(driven by ``gather_view_pallas_packed``) and its rotation epilogue, and the
occlusion, carried-object overlay and encode around it.  The kernel is
``csrc/obs_gather.cu``: a block per tile of 32 envs staged in shared memory,
rotation folded into the coordinates, out-of-bounds cells stamped with the
packed grey wall; in one launch it gives the window (:func:`gather_view`),
the image (:func:`observe_image`) or the window with the carried object and
its occlusion mask (:func:`observe_grid`).  See the source for its bound on
the card.

Each wrapper takes the plain version for a tensor on the CPU
(``core/obs.py``'s ``observe_image_plain`` and ``observe_grid_plain`` for the
last two) and the kernel for a CUDA tensor; on a CUDA tensor it launches the
kernel or raises.  ``trace.launches("obs_gather")`` counts the kernel
launches, so that a run can show that its observations went through the
kernel; while tracing, the counter ``obs.occlusion_kernel`` counts the
launches that computed the occlusion.
"""

from __future__ import annotations

import ctypes

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.grid_ops import pack_word
from minigrid_tpu_torch.core.obs import (observe_grid_plain, observe_image_plain,
                                         view_world_coords)
from minigrid_tpu_torch.ops._build import Kernel, check_launch, check_tensor
from minigrid_tpu_torch.utils import trace

WALL_PACKED = pack_word(C.WALL_TRIPLE)
TILE = 32  # envs per block (csrc/obs_gather.cu kTile)
MAX_VIEW = 31  # a view column is one 32-bit word (csrc/obs_gather.cu kMaxView)
WINDOW, IMAGE, GRID = 0, 1, 2  # the kernel's modes (csrc/obs_gather.cu kWindow, ...)
OCCLUSION_COUNTER = "obs.occlusion_kernel"

KERNEL = Kernel("obs_gather", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6)


def gather_view_plain(grid: torch.Tensor, agent_pos: torch.Tensor,
                      agent_dir: torch.Tensor, view_size: int) -> torch.Tensor:
    """Plain torch version: int32[B, W, H] -> int32[B, V, V]."""
    b, w, h = grid.shape
    v = view_size
    wx, wy = view_world_coords(agent_pos, agent_dir, v)
    oob = (wx < 0) | (wx >= w) | (wy < 0) | (wy >= h)
    idx = (wx.clamp(0, w - 1) * h + wy.clamp(0, h - 1)).to(torch.int64)
    cells = grid.reshape(b, w * h).gather(1, idx.reshape(b, v * v))
    return torch.where(oob, WALL_PACKED, cells.reshape(b, v, v))


def gather_tile_bytes(width: int, height: int, view_size: int = 0, mode: int = WINDOW) -> int:
    """Shared memory of one block of the kernel: per env its grid row, pose
    and direction; beyond the window, its view's column words, its output
    (three bytes a view cell for the image, five for the window and its
    mask) and its carried triple (``csrc/obs_gather.cu::tile_bytes``)."""
    v = view_size
    return 4 * TILE * (width * height + 3) + (mode > 0) * TILE * (
        4 * v + (1 + 2 * mode) * v * v + 3)


def _launch(mode: int, grid: torch.Tensor, agent_pos: torch.Tensor, agent_dir: torch.Tensor,
            carrying: torch.Tensor | None, view_size: int, see_through: bool = False):
    """Check what the kernel takes, then launch it in ``mode`` on fresh
    outputs: (out, vis), vis None but in grid mode.  Forms are checked
    before the device, so a tensor on a device without the kernel raises
    for its form first."""
    if grid.dim() != 3:
        raise ValueError(f"grid must be [B, W, H], got {tuple(grid.shape)}")
    b, w, h = grid.shape
    v = int(view_size)
    if v < 1 or (mode != WINDOW and v > MAX_VIEW):
        raise ValueError(f"view_size must be 1 to {MAX_VIEW}, got {v}")
    check_launch(gather_tile_bytes(w, h, v, mode), TILE, b,
                 max(w * h, v * v * (3 if mode == IMAGE else 1)), f"a {w}x{h} grid")
    checks = [(grid, "grid", torch.int32, (b, w, h)),
              (agent_pos, "agent_pos", torch.int32, (b, 2)),
              (agent_dir, "agent_dir", torch.int32, (b,))]
    if mode != WINDOW:
        checks.append((carrying, "carrying", torch.uint8, (b, 3)))
    for t, name, dtype, shape in checks:
        check_tensor(t, name, dtype, shape, grid.device)
    KERNEL.check_device(grid.device)
    dev = grid.device
    if mode == IMAGE:
        out = torch.empty((b, v, v, 3), dtype=torch.uint8, device=dev)
    else:
        out = torch.empty((b, v, v), dtype=torch.int32, device=dev)
    vis = torch.empty((b, v, v), dtype=torch.bool, device=dev) if mode == GRID else None
    if b == 0:
        return out, vis
    KERNEL.launch(dev, grid.data_ptr(), agent_pos.data_ptr(), agent_dir.data_ptr(),
                  carrying.data_ptr() if mode != WINDOW else None, out.data_ptr(),
                  vis.data_ptr() if vis is not None else None, b, w, h, v, mode,
                  int(bool(see_through)))
    if mode != WINDOW and not see_through:
        trace.count(OCCLUSION_COUNTER, 1)
    return out, vis


def gather_view(grid: torch.Tensor, agent_pos: torch.Tensor,
                agent_dir: torch.Tensor, view_size: int) -> torch.Tensor:
    """Rotated egocentric window of every env, packed:
    grid int32[B, W, H], agent_pos int32[B, 2], agent_dir int32[B] ->
    int32[B, V, V]."""
    if grid.device.type == "cpu":
        return gather_view_plain(grid, agent_pos, agent_dir, view_size)
    return _launch(WINDOW, grid, agent_pos, agent_dir, None, view_size)[0]


def observe_image(grid: torch.Tensor, agent_pos: torch.Tensor, agent_dir: torch.Tensor,
                  carrying: torch.Tensor, view_size: int, see_through: bool) -> torch.Tensor:
    """The image of every env's view: the window's occlusion (none with
    ``see_through``), the carried object uint8[B, 3] at (V//2, V-1), unseen
    cells (0, 0, 0); uint8[B, V, V, 3]."""
    if grid.device.type == "cpu":
        return observe_image_plain(grid, agent_pos, agent_dir, carrying, view_size, see_through)
    return _launch(IMAGE, grid, agent_pos, agent_dir, carrying, view_size, see_through)[0]


def observe_grid(grid: torch.Tensor, agent_pos: torch.Tensor, agent_dir: torch.Tensor,
                 carrying: torch.Tensor, view_size: int,
                 see_through: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(the packed window with the carried object at (V//2, V-1),
    int32[B, V, V]; its occlusion mask, bool[B, V, V], all True with
    ``see_through``)."""
    if grid.device.type == "cpu":
        return observe_grid_plain(grid, agent_pos, agent_dir, carrying, view_size, see_through)
    return _launch(GRID, grid, agent_pos, agent_dir, carrying, view_size, see_through)
