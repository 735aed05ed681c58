"""The egocentric-window gather: CUDA kernel, plain version and wrapper.

Replaces the JAX package's Pallas kernel ``ops/obs_pallas.py::_make_kernel``
(driven by ``gather_view_pallas_packed``) and its rotation epilogue.  The
kernel is ``csrc/obs_gather.cu``: one thread per (env, view cell), rotation
folded into the coordinates, out-of-bounds cells stamped with the packed grey
wall.  See the source for its bound on the card.

:func:`gather_view` takes the plain version for a tensor on the CPU and the
kernel for a CUDA tensor; on a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts the kernel launches, so that a run can show that its
observations went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.grid_ops import pack_word
from minigrid_tpu_torch.core.obs import view_world_coords

WALL_PACKED = pack_word(C.WALL_TRIPLE)

LAUNCHES = 0


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


@functools.cache
def _kernel():
    from minigrid_tpu_torch.ops import _build

    fn = _build.load("obs_gather").obs_gather
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, grid on {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gather_view(grid: torch.Tensor, agent_pos: torch.Tensor,
                agent_dir: torch.Tensor, view_size: int) -> torch.Tensor:
    """Rotated egocentric window of every env, packed:
    grid int32[B, W, H], agent_pos int32[B, 2], agent_dir int32[B] ->
    int32[B, V, V]."""
    if grid.device.type == "cpu":
        return gather_view_plain(grid, agent_pos, agent_dir, view_size)
    if grid.device.type != "cuda":
        raise ValueError(f"no obs_gather kernel for device {grid.device}")
    if grid.dim() != 3:
        raise ValueError(f"grid must be [B, W, H], got {tuple(grid.shape)}")
    b, w, h = grid.shape
    v = int(view_size)
    if v < 1:
        raise ValueError(f"view_size must be positive, got {v}")
    _check(grid, "grid", (b, w, h), grid.device)
    _check(agent_pos, "agent_pos", (b, 2), grid.device)
    _check(agent_dir, "agent_dir", (b,), grid.device)
    out = torch.empty((b, v, v), dtype=torch.int32, device=grid.device)
    if b == 0:
        return out
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        err = _kernel()(grid.data_ptr(), agent_pos.data_ptr(),
                        agent_dir.data_ptr(), out.data_ptr(), b, w, h, v, stream)
    if err != 0:
        raise RuntimeError(f"obs_gather kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
