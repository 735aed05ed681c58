"""The egocentric-window gather: CUDA kernel, plain version and wrapper.

Replaces the JAX package's Pallas kernel ``ops/obs_pallas.py::_make_kernel``
(driven by ``gather_view_pallas_packed``) and its rotation epilogue.  The
kernel is ``csrc/obs_gather.cu``: a block per tile of 32 envs staged in shared
memory, one thread per (env, view row), rotation folded into the
coordinates, out-of-bounds cells stamped with the packed grey wall.  See the
source for its bound on the card.

:func:`gather_view` takes the plain version for a tensor on the CPU and the
kernel for a CUDA tensor; on a CUDA tensor it launches the kernel or raises.
``trace.launches("obs_gather")`` counts the kernel launches, so that a run can
show that its observations went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.grid_ops import pack_word
from minigrid_tpu_torch.core.obs import view_world_coords
from minigrid_tpu_torch.ops._build import Kernel, check_launch, check_tensor

WALL_PACKED = pack_word(C.WALL_TRIPLE)
TILE = 32  # envs per block (csrc/obs_gather.cu kTile)

KERNEL = Kernel("obs_gather", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4)


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


def gather_tile_bytes(width: int, height: int) -> int:
    """Shared memory of one block of the kernel: per env its grid row, pose
    and direction (``csrc/obs_gather.cu::tile_bytes``)."""
    return 4 * TILE * (width * height + 3)


def gather_view(grid: torch.Tensor, agent_pos: torch.Tensor,
                agent_dir: torch.Tensor, view_size: int) -> torch.Tensor:
    """Rotated egocentric window of every env, packed:
    grid int32[B, W, H], agent_pos int32[B, 2], agent_dir int32[B] ->
    int32[B, V, V]."""
    if grid.device.type == "cpu":
        return gather_view_plain(grid, agent_pos, agent_dir, view_size)
    KERNEL.check_device(grid.device)
    if grid.dim() != 3:
        raise ValueError(f"grid must be [B, W, H], got {tuple(grid.shape)}")
    b, w, h = grid.shape
    v = int(view_size)
    if v < 1:
        raise ValueError(f"view_size must be positive, got {v}")
    check_launch(gather_tile_bytes(w, h), TILE, b, max(w * h, v * v), f"a {w}x{h} grid")
    for t, name, shape in ((grid, "grid", (b, w, h)), (agent_pos, "agent_pos", (b, 2)),
                           (agent_dir, "agent_dir", (b,))):
        check_tensor(t, name, torch.int32, shape, grid.device)
    out = torch.empty((b, v, v), dtype=torch.int32, device=grid.device)
    if b == 0:
        return out
    KERNEL.launch(grid.device, grid.data_ptr(), agent_pos.data_ptr(), agent_dir.data_ptr(),
                  out.data_ptr(), b, w, h, v)
    return out
