"""RoomGrid's sequential distractor placement: CUDA kernel and wrapper.

``core/roomgrid.py::RoomGridEnv.add_distractors`` places its objects one after
another where the room is drawn per object (``i`` or ``j`` None on a lattice of
more than one room): each placement reads the grid the last one wrote, as the
JAX package's ``lax.scan`` does.  Its plain version is that loop, in
``add_distractors`` itself, about 160 eager launches an object.  For a CUDA
tensor the loop runs here instead: one launch of ``csrc/distractors.cu`` for
every object of every env, bit for bit the loop's grid, ``obj_mask``, added
(type, color) pairs and positions (see the source for its bound).

:func:`place` checks the argument forms and dtypes before it looks at the
device, then launches the kernel for a CUDA tensor and raises for any other
device: the CPU path is ``add_distractors``' loop, which never calls in here.
A room coordinate, ``enabled`` and ``color_override`` are Python values or
tensors of one value per env, read through a stride (0 for a single value).
``trace.launches("distractors")`` counts the launches; each also counts
``roomgrid.distractors_kernel`` in the program's trace.
"""

from __future__ import annotations

import ctypes
import numbers

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.sampling import SORTED_COLOR_IDS
from minigrid_tpu_torch.ops._build import Kernel, check_launch

WARPS = 4  # envs a block (csrc/distractors.cu kWarps)
NUM_COMBOS = 30  # (kind, color) pairs of obj_mask
KIND_IDS = tuple(C.OBJECT_TO_IDX[k] for k in ("key", "ball", "box"))
ALL_UNIQUE, DRAW_I, DRAW_J, OVERRIDE = 1, 2, 4, 8  # csrc/distractors.cu's flags

_P = ctypes.c_void_p
_I = ctypes.c_int32


class Args(ctypes.Structure):
    """``csrc/distractors.cu::Args``, field for field."""
    _fields_ = ([(name, _P) for name in (
        "keys", "grid", "obj_mask", "agent_pos", "room_i", "room_j", "enabled", "color",
        "out_grid", "out_mask", "added", "positions")]
        + [(name, _I) for name in (
            "n", "width", "height", "room_size", "num_rows", "num_cols", "num",
            "key_stride", "key_word", "grid_stride",
            "room_i_stride", "room_i_value", "room_j_stride", "room_j_value",
            "enabled_stride", "enabled_value", "color_stride", "color_value", "flags")]
        + [("sorted_colors", _I * len(SORTED_COLOR_IDS)), ("kind_ids", _I * len(KIND_IDS))])


def tile_bytes(width: int, height: int) -> int:
    """Shared memory of one block: its envs' grids
    (``csrc/distractors.cu::tile_bytes``)."""
    return WARPS * width * height * 4


def _per_env(v, name: str, n: int, dtype: torch.dtype):
    """A Python value or a tensor of one value per env -> (tensor or None,
    its stride, the value).  A tensor is checked here, and moved to the
    keys' device and converted once the device is known."""
    if not isinstance(v, torch.Tensor):
        if dtype == torch.bool:
            if not isinstance(v, (numbers.Integral, np.bool_)):
                raise TypeError(f"{name} must be a bool or a bool tensor, got {type(v).__name__}")
            return None, 0, int(bool(v))
        if isinstance(v, (bool, np.bool_)) or not isinstance(v, numbers.Integral):
            raise TypeError(f"{name} must be an int or an int tensor, got {type(v).__name__}")
        if not -2**31 <= v < 2**31:
            raise ValueError(f"{name} {v} is outside int32")
        return None, 0, int(v)
    if dtype == torch.bool and v.dtype != torch.bool:
        raise TypeError(f"{name} must be a bool tensor, got {v.dtype}")
    if dtype != torch.bool and (v.dtype == torch.bool or v.dtype.is_floating_point
                                or v.dtype.is_complex):
        raise TypeError(f"{name} must be an integer tensor, got {v.dtype}")
    if v.numel() not in (1, n) or v.dim() > 1:
        raise ValueError(f"{name} must hold one value or one per env ({n}), "
                         f"got {tuple(v.shape)}")
    return v.reshape(-1), int(v.numel() != 1), 0


class _Kernel(Kernel):
    def bind(self, lib: ctypes.CDLL):
        """As :meth:`Kernel.bind`; raises if the library's ``Args`` is not
        :class:`Args`."""
        size = lib.distractors_args_size()  # an int, ctypes' default return type
        if size != ctypes.sizeof(Args):
            raise RuntimeError(f"csrc/distractors.cu's Args is {size} bytes, the wrapper's "
                               f"{ctypes.sizeof(Args)}")
        return super().bind(lib)


KERNEL = _Kernel("distractors", [ctypes.c_void_p], counter="roomgrid.distractors_kernel")


def place(b: dict, keys: torch.Tensor, lattice: tuple[int, int, int], i, j, num: int,
          all_unique: bool, enabled, color_override
          ) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """``add_distractors``' sequential path on the kernel: ``lattice`` is
    (num_rows, num_cols, room_size), ``i`` or ``j`` (or both) None, the
    rest as ``add_distractors`` takes them.  Returns (builder with a new
    ``grid`` and ``obj_mask``, int32[B, num, 2] (type id, color id),
    int32[B, num, 2] positions)."""
    num_rows, num_cols, room_size = (int(v) for v in lattice)
    if num_rows * num_cols < 2 or room_size < 3:
        raise ValueError(f"the sequential path needs a lattice of rooms, got {lattice}")
    if i is not None and j is not None:
        raise ValueError("with both i and j fixed, add_distractors places in one shot")
    if isinstance(num, bool) or not isinstance(num, int) or num < 1:
        raise ValueError(f"num_distractors must be a positive int, got {num!r}")
    if not isinstance(all_unique, bool):
        raise TypeError(f"all_unique must be a bool, got {type(all_unique).__name__}")
    grid, obj_mask, agent_pos = b["grid"], b["obj_mask"], b["agent_pos"]
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
        raise TypeError(f"keys must be int64 [B, 2], got {keys.dtype} {tuple(keys.shape)}")
    n = keys.shape[0]
    if grid.dtype != torch.int32 or grid.dim() != 3 or grid.shape[0] != n:
        raise TypeError(f"grid must be int32 [{n}, W, H], got {grid.dtype} {tuple(grid.shape)}")
    w, h = grid.shape[1:]
    for t, name, dtype, shape in ((obj_mask, "obj_mask", torch.bool, (n, NUM_COMBOS)),
                                  (agent_pos, "agent_pos", torch.int32, (n, 2))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
    # (the fixed column, the fixed row, enabled, color_override) as (tensor or
    # None, stride, value); the placeholders of a drawn room and of no
    # override are never read
    dtypes = (torch.int32, torch.int32, torch.bool, torch.int32)
    forms = [_per_env(v, name, n, dtype) for name, v, dtype in zip(
        ("i", "j", "enabled", "color_override"),
        (0 if i is None else i, 0 if j is None else j, enabled,
         0 if color_override is None else color_override), dtypes)]
    check_launch(tile_bytes(w, h), WARPS, n, max(w * h, 2 * num, NUM_COMBOS),
                 f"a {w}x{h} grid")

    dev = keys.device
    KERNEL.check_device(dev)
    for t, name in ((grid, "grid"), (obj_mask, "obj_mask"), (agent_pos, "agent_pos")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the keys on {dev}")
    # the kernel walks the batch at any stride (connect_all's grids are rows
    # of a wider scatter, init_rooms' one expanded lattice) but each grid
    # row-major
    if (w > 1 and grid.stride(1) != h) or (h > 1 and grid.stride(2) != 1):
        grid = grid.contiguous()
    obj_mask, agent_pos = obj_mask.contiguous(), agent_pos.contiguous()
    out_grid = torch.empty((n, w, h), dtype=torch.int32, device=dev)
    out_mask = torch.empty((n, NUM_COMBOS), dtype=torch.bool, device=dev)
    added = torch.empty((n, num, 2), dtype=torch.int32, device=dev)
    positions = torch.empty((n, num, 2), dtype=torch.int32, device=dev)
    b = dict(b)
    b["grid"], b["obj_mask"] = out_grid, out_mask
    if n == 0:
        return b, added, positions

    forms = [(None if t is None else t.to(device=dev, dtype=dtype).contiguous(), stride, value)
             for (t, stride, value), dtype in zip(forms, dtypes)]
    flags = ((ALL_UNIQUE if all_unique else 0) | (DRAW_I if i is None else 0)
             | (DRAW_J if j is None else 0) | (OVERRIDE if color_override is not None else 0))
    args = Args(
        keys.data_ptr(), grid.data_ptr(), obj_mask.data_ptr(), agent_pos.data_ptr(),
        *(None if t is None else t.data_ptr() for t, _, _ in forms),
        out_grid.data_ptr(), out_mask.data_ptr(), added.data_ptr(), positions.data_ptr(),
        n, w, h, room_size, num_rows, num_cols, num,
        keys.stride(0), keys.stride(1), grid.stride(0),
        *(x for _, stride, value in forms for x in (stride, value)), flags,
        (_I * len(SORTED_COLOR_IDS))(*(int(c) for c in SORTED_COLOR_IDS)),
        (_I * len(KIND_IDS))(*KIND_IDS))
    KERNEL.launch(dev, ctypes.byref(args))
    return b, added, positions
