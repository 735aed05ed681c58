"""Copies of what the program hands back, kept for the check after the
window: the program may write its outputs in place on a later call (a
replayed CUDA graph writes the same buffers every time), so a reference
kept across calls could read a later value.

:func:`keep` copies every tensor of a tree (tensors, dicts, tuples, lists,
dataclasses and namespaces of them) into one byte buffer with one
``torch.cat``: one launch for up to 128 tensors.  :meth:`Kept.restore`
gives the tree back, each tensor a view of that buffer.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch


class Kept:
    def __init__(self, skeleton, buf: torch.Tensor | None, layout: list):
        self.skeleton, self.buf, self.layout = skeleton, buf, layout

    def restore(self):
        leaves = [self.buf[off:off + n].view(dtype).reshape(shape)
                  for off, n, dtype, shape in self.layout]
        return _build(self.skeleton, leaves)


def keep(tree) -> Kept:
    leaves: list[torch.Tensor] = []
    seen: dict[int, int] = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen[id(x)] = len(leaves)
                leaves.append(x)
            return ("tensor", seen[id(x)])
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return ("dataclass", type(x),
                    {f.name: walk(getattr(x, f.name)) for f in dataclasses.fields(x)})
        if isinstance(x, SimpleNamespace):
            return ("namespace", {k: walk(v) for k, v in vars(x).items()})
        if isinstance(x, dict):
            return ("dict", {k: walk(v) for k, v in x.items()})
        if isinstance(x, (tuple, list)):
            return ("sequence", type(x), [walk(v) for v in x])
        return ("value", x)

    skeleton = walk(tree)
    # widest elements first, so that every view of the buffer is aligned
    order = sorted(range(len(leaves)), key=lambda i: -leaves[i].element_size())
    layout: list = [None] * len(leaves)
    parts, off = [], 0
    for i in order:
        t = leaves[i]
        n = t.numel() * t.element_size()
        layout[i] = (off, n, t.dtype, tuple(t.shape))
        parts.append(t.contiguous().reshape(-1).view(torch.uint8))
        off += n
    buf = torch.cat(parts) if parts else None
    return Kept(skeleton, buf, layout)


def distinct(tensors: list[torch.Tensor]) -> bool:
    """Whether tensors that are all held at once sit at distinct addresses:
    the allocator hands out no held memory twice, so a repeated address is
    a buffer the program wrote again in place."""
    ptrs = [t.data_ptr() for t in tensors if t.numel()]
    return len(set(ptrs)) == len(ptrs)


def _build(node, leaves):
    kind = node[0]
    if kind == "tensor":
        return leaves[node[1]]
    if kind == "dataclass":
        return node[1](**{k: _build(v, leaves) for k, v in node[2].items()})
    if kind == "namespace":
        return SimpleNamespace(**{k: _build(v, leaves) for k, v in node[1].items()})
    if kind == "dict":
        return {k: _build(v, leaves) for k, v in node[1].items()}
    if kind == "sequence":
        return node[1](_build(v, leaves) for v in node[2])
    return node[1]
