"""The threefry2x32 hash over counters: CUDA kernel, layouts and wrapper.

``core/rng.py``'s ``split``, ``bits`` and ``fold_in`` hash counter pairs
``(0, c)`` under keys; their plain version, ``core/rng.py::threefry2x32``,
runs the 20 rounds as eager int64 ops.  For a CUDA tensor they come here
instead: one launch of ``csrc/threefry.cu`` a call, the same words bit for
bit, written in the caller's layout (see the source for its bound).

A call is laid out as ``n x m`` elements, element ``(i, j)`` reading its
key at ``i * ks_i + j * ks_j`` (word 1 ``kw`` further) and its counter at
``i * ds_i + j * ds_j`` of ``data``, or ``base + j`` without data.  The
layouts are plain Python (:func:`iota_layout`, :func:`fold_layout`), so
the CPU tests hold them against the plain path; keys are walked through
their strides and copied only where their leading dims cannot be walked
with one stride (two, for ``fold_in`` by a tensor).

The wrapper checks dtypes and shapes before it looks at the device, then
launches the kernel for a CUDA tensor and raises for any other device: the
CPU path is ``core/rng.py``'s, which never calls in here.
``trace.launches("threefry")`` counts the launches; each also counts
``rng.threefry`` in the program's trace.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from minigrid_tpu_torch.ops._build import MAX_INDEX, Kernel

KERNEL = Kernel("threefry", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                + [ctypes.c_uint, ctypes.c_int], counter="rng.threefry")


class Layout(NamedTuple):
    """One launch's tensors and extents: ``keys`` (and ``data``) are read at
    the strides given, ``out_shape`` is written contiguously, pairs of
    words or (``xor``) their xor."""
    keys: torch.Tensor
    data: torch.Tensor | None
    out_shape: tuple
    n: int
    m: int
    ks_i: int
    ks_j: int
    kw: int
    ds_i: int
    ds_j: int
    base: int
    xor: bool


def iota_rows(shape: tuple, rows: tuple[int, int] | None) -> tuple[int, tuple]:
    """The iota counters of a draw of ``shape``, only the rows ``[lo, hi)``
    of its first dim with ``rows``: (the first counter, the shape drawn)."""
    if math.prod(shape) >= 1 << 32:
        raise ValueError("random draws above 2^32 values need the high counter")
    first = shape[0] if shape else 1
    lo, hi = (0, first) if rows is None else rows
    if not 0 <= lo <= hi <= first:
        raise ValueError(f"rows {rows} outside the draw's first dim of {shape}")
    inner = math.prod(shape[1:])
    return lo * inner, ((hi - lo,) + tuple(shape[1:]) if shape else ())


def _one_stride(shape, strides) -> int | None:
    """The stride that walks the dims ``shape`` (at ``strides``) as one
    row-major dim, or None where none does."""
    stride = expect = None
    for size, st in zip(reversed(shape), reversed(strides)):
        if size == 1:
            continue
        if expect is not None and st != expect:
            return None
        if stride is None:
            stride = st
        expect = st * size
    return 0 if stride is None else stride


def _check_keys(keys: torch.Tensor) -> None:
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be int64, got {keys.dtype}")
    if keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be [..., 2], got {tuple(keys.shape)}")


def iota_layout(keys: torch.Tensor, base: int, count: tuple, pairs: bool) -> Layout:
    """``split`` (``pairs``: ``[..., *count, 2]``) or ``bits``
    (``[..., *count]``, the words' xor) of the counters ``base + j`` for
    ``j < prod(count)`` under each key."""
    _check_keys(keys)
    lead = tuple(keys.shape[:-1])
    ks = _one_stride(lead, keys.stride()[:-1])
    if ks is None:
        keys = keys.reshape(-1, 2)
        ks = keys.stride(0)
    out_shape = lead + count + ((2,) if pairs else ())
    return Layout(keys, None, out_shape, math.prod(lead), math.prod(count), ks, 0,
                  keys.stride(-1), 0, 0, base, not pairs)


def _broadcast(a: tuple, b: tuple) -> tuple:
    n = max(len(a), len(b))
    a, b = (1,) * (n - len(a)) + a, (1,) * (n - len(b)) + b
    out = []
    for x, y in zip(a, b):
        if x != y and 1 not in (x, y):
            raise ValueError(f"keys {a} and data {b} do not broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


def _strides_over(t: torch.Tensor, shape: tuple, dims: int) -> list[int]:
    """The strides of ``t``'s first ``dims`` dims broadcast to ``shape``: 0
    along a dim it broadcasts over."""
    sizes, strides = t.shape[:dims], t.stride()[:dims]
    pad = len(shape) - dims
    return [0] * pad + [st if sz != 1 else 0 for sz, st in zip(sizes, strides)]


def _two_dims(shape: tuple, a: list[int], b: list[int]) -> list | None:
    """``shape`` walked at strides ``a`` and ``b`` as at most two row-major
    dims ``[(size, stride_a, stride_b), ...]``, or None."""
    dims: list = []
    for size, sa, sb in zip(shape, a, b):
        if size == 1:
            continue
        if dims and dims[-1][1] == sa * size and dims[-1][2] == sb * size:
            dims[-1] = (dims[-1][0] * size, sa, sb)
        else:
            dims.append((size, sa, sb))
    return dims if len(dims) <= 2 else None


def fold_layout(keys: torch.Tensor, data: torch.Tensor) -> Layout:
    """``fold_in`` by an int64 tensor ``data`` that broadcasts against the
    keys' leading dims: ``[*broadcast, 2]``."""
    _check_keys(keys)
    if data.dtype != torch.int64:
        raise TypeError(f"fold_in data must be int64, got {data.dtype}")
    lead = _broadcast(tuple(keys.shape[:-1]), tuple(data.shape))
    dims = _two_dims(lead, _strides_over(keys, lead, keys.dim() - 1),
                     _strides_over(data, lead, data.dim()))
    if dims is None:
        keys = keys.expand(lead + (2,)).reshape(-1, 2)
        data = data.expand(lead).reshape(-1)
        dims = [(keys.shape[0], keys.stride(0), data.stride(0))]
    (n, ks_i, ds_i), (m, ks_j, ds_j) = ([(1, 0, 0)] * (2 - len(dims)) + dims)
    return Layout(keys, data, lead + (2,), n, m, ks_i, ks_j, keys.stride(-1), ds_i, ds_j,
                  0, False)


def launch(lay: Layout) -> torch.Tensor:
    """Run one layout on its keys' device: a new int64 tensor of
    ``lay.out_shape``."""
    total = lay.n * lay.m
    key_reach = (lay.n - 1) * lay.ks_i + (lay.m - 1) * lay.ks_j + lay.kw
    data_reach = (lay.n - 1) * lay.ds_i + (lay.m - 1) * lay.ds_j
    if 2 * total >= MAX_INDEX or max(key_reach, data_reach) >= MAX_INDEX:
        raise ValueError(f"a threefry draw of {lay.out_shape} overflows the kernel's "
                         "32-bit indices")
    dev = lay.keys.device
    KERNEL.check_device(dev)
    if lay.data is not None and lay.data.device != dev:
        raise ValueError(f"fold_in data is on {lay.data.device}, the keys on {dev}")
    out = torch.empty(lay.out_shape, dtype=torch.int64, device=dev)
    if total == 0:
        return out
    KERNEL.launch(dev, lay.keys.data_ptr(), None if lay.data is None else lay.data.data_ptr(),
                  out.data_ptr(), lay.n, lay.m, lay.ks_i, lay.ks_j, lay.kw, lay.ds_i, lay.ds_j,
                  lay.base, int(lay.xor))
    return out


def split(keys: torch.Tensor, num: int, rows: tuple[int, int] | None = None) -> torch.Tensor:
    """``core/rng.py::split`` on the kernel."""
    base, count = iota_rows((num,), rows)
    return launch(iota_layout(keys, base, count, pairs=True))


def bits(keys: torch.Tensor, shape: tuple, rows: tuple[int, int] | None = None) -> torch.Tensor:
    """``core/rng.py::bits`` on the kernel."""
    base, count = iota_rows(shape, rows)
    return launch(iota_layout(keys, base, count, pairs=False))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``core/rng.py::fold_in`` on the kernel: ``data`` an int in
    ``[0, 2^32)`` (the counter ``base``) or an int tensor."""
    if isinstance(data, torch.Tensor):
        return launch(fold_layout(keys, data.to(device=keys.device, dtype=torch.int64)))
    if not 0 <= int(data) < 1 << 32:
        raise ValueError(f"fold_in data must lie in [0, 2^32), got {data}")
    return launch(iota_layout(keys, int(data), (), pairs=True))
