"""LevelGen's descriptor redraws: CUDA kernel and wrapper.

``babyai/levelgen.py::LevelGen._rand_objs`` draws the 8 descriptors of each
env's instruction and redraws a lane while nothing in the env matches it, at
most ``DESC_FUEL`` times, as the JAX package's fueled ``while_loop`` does.
Its plain version, ``_rand_objs_plain``, runs that loop as masked eager
passes over the (env, lane) pairs still redrawing, about 145 launches and a
host read a pass.  For a CUDA tensor the loop runs here instead: one launch
of ``csrc/descs.cu`` for every lane of every env, bit for bit the loop's
descriptors and redraw counts (see the source for its bound).

:func:`draw` checks the argument forms and dtypes before it looks at the
device, then launches the kernel for a CUDA tensor and raises for any other
device: the CPU path is the plain loop, which never calls in here.
``trace.launches("descs")`` counts the launches; each also counts
``levelgen.descs_kernel`` in the program's trace.
"""

from __future__ import annotations

import ctypes

import torch

from minigrid_tpu_torch.ops._build import Kernel, check_launch

LANES = 8  # descriptor lanes an env: 4 clauses' first descs, then their second
CLAUSES = 4
LOCATIONS, IMPLICIT_UNLOCK = 1, 2  # csrc/descs.cu's flags

KERNEL = Kernel("descs", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10,
                counter="levelgen.descs_kernel")


def tile_bytes(width: int, height: int) -> int:
    """Shared memory of one block: its env's grid (``csrc/descs.cu::tile_bytes``)."""
    return width * height * 4


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or tuple(t.shape) != shape:
        got = f"{t.dtype} {tuple(t.shape)}" if isinstance(t, torch.Tensor) else type(t).__name__
        raise TypeError(f"{name} must be {dtype} {shape}, got {got}")


def draw(key_d1: torch.Tensor, key_d2: torch.Tensor, b: dict, kinds: torch.Tensor,
         locked_rect: torch.Tensor, has_locked: torch.Tensor, room_size: int,
         locations: bool, implicit_unlock: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``LevelGen._rand_objs``' loop on the kernel: the builder ``b``'s
    ``grid``, ``agent_pos`` and ``agent_dir``, the clause kinds int32[B, 4],
    the locked room's cells bool[B, W, H] and flag bool[B], and the
    preset's ``room_size``, ``locations`` and ``implicit_unlock``.  Returns
    (descriptors int32[B, 8, 3], d1's lanes first; redraws int32[B, 8])."""
    if isinstance(room_size, bool) or not isinstance(room_size, int) or room_size < 2:
        raise ValueError(f"room_size must be an int of at least 2, got {room_size!r}")
    for flag, name in ((locations, "locations"), (implicit_unlock, "implicit_unlock")):
        if not isinstance(flag, bool):
            raise TypeError(f"{name} must be a bool, got {type(flag).__name__}")
    grid = b["grid"]
    if grid.dtype != torch.int32 or grid.dim() != 3 or min(grid.shape[1:]) < 1:
        raise TypeError(f"grid must be int32 [B, W, H], got {grid.dtype} {tuple(grid.shape)}")
    n, w, h = grid.shape
    for key, name in ((key_d1, "key_d1"), (key_d2, "key_d2")):
        _check(key, name, torch.int64, (n, 2))
    for t, name, dtype, shape in (
            (b["agent_pos"], "agent_pos", torch.int32, (n, 2)),
            (b["agent_dir"], "agent_dir", torch.int32, (n,)),
            (kinds, "kinds", torch.int32, (n, CLAUSES)),
            (locked_rect, "locked_rect", torch.bool, (n, w, h)),
            (has_locked, "has_locked", torch.bool, (n,))):
        _check(t, name, dtype, shape)
    check_launch(tile_bytes(w, h), 1, n, max(w * h, LANES * 3), f"a {w}x{h} grid")

    dev = key_d1.device
    KERNEL.check_device(dev)
    ins = (key_d2, grid, b["agent_pos"], b["agent_dir"], kinds, locked_rect, has_locked)
    names = ("key_d2", "grid", "agent_pos", "agent_dir", "kinds", "locked_rect", "has_locked")
    for t, name in zip(ins, names):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, key_d1 on {dev}")
    descs = torch.empty((n, LANES, 3), dtype=torch.int32, device=dev)
    redraws = torch.empty((n, LANES), dtype=torch.int32, device=dev)
    if n == 0:
        return descs, redraws
    # the kernel walks keys and grids at any batch stride (the keys are
    # columns of the level's 16-way split), each grid row-major
    if (w > 1 and grid.stride(1) != h) or (h > 1 and grid.stride(2) != 1):
        grid = grid.contiguous()
    small = [t.contiguous() for t in ins[2:]]
    flags = (LOCATIONS if locations else 0) | (IMPLICIT_UNLOCK if implicit_unlock else 0)
    KERNEL.launch(dev, key_d1.data_ptr(), key_d2.data_ptr(), grid.data_ptr(),
                  *(t.data_ptr() for t in small), descs.data_ptr(), redraws.data_ptr(),
                  n, w, h, room_size, key_d1.stride(0), key_d1.stride(1),
                  key_d2.stride(0), key_d2.stride(1), grid.stride(0), flags)
    return descs, redraws
