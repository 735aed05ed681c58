"""Checkpoint / resume for env state and trainer state.

Counterpart of ``minigrid_tpu/utils/checkpoint.py``, with ``torch.save`` in
place of flax's msgpack:

    save(path, state)                 # an EnvState batch, a PPO runner, ...
    state = load(path, template)      # template supplies the structure

A tree is ``None``, a tensor, a Python scalar, a dict, a list or tuple (a
``NamedTuple`` such as ``PPORunner``), a dataclass (``EnvState``,
``PooledState``, ``EpisodeStats``, ``TrainState``), an ``nn.Module`` (its
``state_dict``) or an optimizer (its ``state_dict``, one leaf).  A callable
(a learning-rate schedule) is structure, not data: the template's is kept.
``load`` returns the template's structure with the saved values, each tensor
on the template leaf's device and dtype; a module's and an optimizer's
values are loaded into the template's own objects, in place.

Two on-disk layouts, selected automatically:

* **one process** (no process group, or one rank): one file at ``path``;
* **several ranks**: each rank writes its slices to ``path.proc{rank}``, each
  with its place in the global leaf from a placement tree
  (``parallel/sharding.py::batch_shard_tree`` for an env batch,
  ``rl.tp_param_sharding`` for a model's parameters; ``None`` for a leaf
  every rank holds whole, written by rank 0 only), and a barrier closes the
  save.  ``load`` rebuilds every global leaf from all the files (a shared
  filesystem, or files gathered beforehand), refuses files that leave a
  leaf uncovered, and slices it back to the template's placement.

Both write to a temporary name and ``os.replace`` it, so a crash never
leaves a torn checkpoint.  :func:`state_hash` is the JAX package's digest of
an env state, byte for byte; :func:`max_abs_diff` compares two trees of one
structure (a saved runner and its restored copy, two training runs).
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import os
from typing import Any, Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from minigrid_tpu_torch.parallel.sharding import Shard
from minigrid_tpu_torch.utils.convert import _UINT32, _extra_to_numpy

_SCALARS = (bool, int, float)


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _children(tree: Any, placement: Any) -> list[tuple[Any, Any]] | None:
    """(child, its placement) pairs of a container in a fixed order, or
    ``None`` for a leaf.  A ``None`` placement places every child ``None``
    (whole on every rank)."""
    def place(key):
        if isinstance(placement, dict):
            return placement.get(key)
        if placement is None:
            return None
        return getattr(placement, key) if isinstance(key, str) else placement[key]

    if isinstance(tree, nn.Module):
        return [(v, place(k)) for k, v in tree.state_dict().items()]
    if isinstance(tree, dict):
        return [(tree[k], place(k)) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(getattr(tree, f.name), place(f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [(v, place(i)) for i, v in enumerate(tree)]
    return None


def _is_structure(x: Any) -> bool:
    """Kept from the template, not saved: nothing, a schedule, a name."""
    return x is None or isinstance(x, str) or (callable(x) and not isinstance(
        x, (nn.Module, torch.Tensor)))


def _flatten(tree: Any, placement: Any = None) -> Iterator[tuple[Any, Any]]:
    """(leaf, placement) in the tree's order: tensors, Python scalars and
    optimizers (whose ``state_dict`` is one leaf)."""
    if _is_structure(tree):
        return
    if isinstance(tree, (torch.Tensor, torch.optim.Optimizer) + _SCALARS):
        yield tree, placement
        return
    children = _children(tree, placement)
    if children is None:
        raise TypeError(f"checkpoint: no rule for {type(tree).__name__}")
    for child, child_placement in children:
        yield from _flatten(child, child_placement)


def _unflatten(template: Any, values: Iterator) -> Any:
    """The template's structure with the values of ``values`` in
    :func:`_flatten`'s order."""
    if _is_structure(template):
        return template
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(next(values)).to(device=template.device, dtype=template.dtype)
    if isinstance(template, torch.optim.Optimizer):
        template.load_state_dict(next(values))
        return template
    if isinstance(template, _SCALARS):
        return type(template)(next(values))
    if isinstance(template, nn.Module):
        with torch.no_grad():
            for t in template.state_dict().values():
                t.copy_(torch.as_tensor(next(values)))
        return template
    if isinstance(template, dict):
        return {k: _unflatten(template[k], values) for k in sorted(template)}
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), values)
            for f in dataclasses.fields(template) if f.init})
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(v, values) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, values) for v in template)
    raise TypeError(f"checkpoint: no rule for {type(template).__name__}")


def _host(leaf: Any) -> Any:
    """A leaf as it is written: tensors on the CPU, an optimizer as its
    ``state_dict``."""
    if isinstance(leaf, torch.optim.Optimizer):
        leaf = leaf.state_dict()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    if isinstance(leaf, dict):
        return {k: _host(v) for k, v in leaf.items()}
    if isinstance(leaf, list):
        return [_host(v) for v in leaf]
    return leaf


def _write(path: str, payload: Any) -> None:
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint


def save(path: str, tree: Any, placement: Any = None) -> None:
    """Save ``tree`` to ``path``: one file in one process, else this rank's
    shard file (``placement`` says where its leaves lie) and a barrier."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if _world()[1] == 1:
        _write(path, [_host(leaf) for leaf, _ in _flatten(tree)])
        return
    save_process_shards(path, tree, placement)
    dist.barrier()


def save_process_shards(path: str, tree: Any, placement: Any = None) -> None:
    """Write this rank's part of ``tree`` to ``path.proc{rank}``: each leaf
    with a :class:`Shard` placement as its slice and global index, each
    other leaf (whole on every rank) from rank 0 only.  :func:`save` calls
    it on several ranks and then waits for all of them."""
    rank, _ = _world()
    payload = []
    for leaf, where in _flatten(tree, placement):
        if isinstance(where, Shard):
            payload.append(("shard", where.shape, where.dim, torch.tensor(where.rows),
                            _host(leaf).reshape(_local_shape(where))))
        elif rank == 0:
            payload.append(("full", None, None, None, _host(leaf)))
        else:
            payload.append(("skip", None, None, None, None))
    _write(f"{path}.proc{rank}", payload)


def _local_shape(shard: Shard) -> tuple:
    shape = list(shard.shape)
    shape[shard.dim] = len(shard.rows)
    return tuple(shape)


def load(path: str, template: Any, placement: Any = None) -> Any:
    """Restore a tree saved by :func:`save` into ``template``'s structure
    (and, from shard files, onto ``placement``)."""
    if os.path.exists(path):
        leaves = torch.load(path, weights_only=True)
        n = sum(1 for _ in _flatten(template))
        if n != len(leaves):
            raise ValueError(f"template has {n} leaves, checkpoint {len(leaves)}")
        return _unflatten(template, iter(leaves))
    return load_process_shards(path, template, placement)


def load_process_shards(path: str, template: Any, placement: Any = None) -> Any:
    """Rebuild a checkpoint from its ``path.proc*`` files: every global leaf
    from all the files, then this rank's part of it by ``placement``.  A
    sharded leaf whose rows the files do not all cover raises
    ``ValueError`` (a rank's file missing)."""
    # '*.tmp' are leftovers of a crash mid-save
    files = sorted(f for f in glob.glob(path + ".proc*") if not f.endswith(".tmp"))
    if not files:
        raise FileNotFoundError(path)
    payloads = [torch.load(f, weights_only=True) for f in files]
    wanted = list(_flatten(template, placement))
    if any(len(p) != len(wanted) for p in payloads):
        raise ValueError(f"template has {len(wanted)} leaves, checkpoint "
                         f"{sorted({len(p) for p in payloads})}")
    values = []
    for i, (leaf, where) in enumerate(wanted):
        entries = [p[i] for p in payloads if p[i][0] != "skip"]
        if not entries:
            raise ValueError(f"leaf {i}: no shard file holds it")
        full = _assemble(i, entries)
        if isinstance(where, Shard):
            rows = torch.tensor(where.rows)
            full = full.index_select(where.dim, rows).reshape(leaf.shape)
        values.append(full)
    return _unflatten(template, iter(values))


def _assemble(i: int, entries: list) -> Any:
    """A global leaf from its entries in the shard files."""
    if entries[0][0] == "full":
        return entries[0][4]
    _, shape, dim, _, first = entries[0]
    full = torch.empty(shape, dtype=first.dtype)
    covered = torch.zeros(shape[dim], dtype=torch.bool)
    for _, _, _, rows, part in entries:
        full.index_copy_(dim, rows, part)
        covered[rows] = True
    if not bool(covered.all()):
        raise ValueError(f"leaf {i}: the shard files cover {int(covered.sum())} of its "
                         f"{shape[dim]} rows (missing a rank's file?)")
    return full


def _values(leaf: Any) -> Iterator[Any]:
    """A leaf's values: itself, or an optimizer's ``state_dict`` entries."""
    if isinstance(leaf, torch.optim.Optimizer):
        leaf = leaf.state_dict()
    if isinstance(leaf, dict):
        for k in sorted(leaf, key=str):
            yield from _values(leaf[k])
    elif isinstance(leaf, (list, tuple)):
        for v in leaf:
            yield from _values(v)
    else:
        yield leaf


def max_abs_diff(a: Any, b: Any) -> float:
    """The largest |a - b| over the leaves of two trees of one structure
    (tensors, Python numbers, optimizer states), in float64; 0.0 when they
    are equal, NaN where one holds a NaN the other lacks.  A tree of another
    structure, shape or dtype raises ``ValueError``."""
    xs = [v for leaf, _ in _flatten(a) for v in _values(leaf)]
    ys = [v for leaf, _ in _flatten(b) for v in _values(leaf)]
    if len(xs) != len(ys):
        raise ValueError(f"trees of {len(xs)} and {len(ys)} values")
    worst = 0.0
    for x, y in zip(xs, ys):
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            raise ValueError("a tensor against a non-tensor")
        if not isinstance(x, torch.Tensor):
            if x == y:
                continue
            if not (isinstance(x, _SCALARS) and isinstance(y, _SCALARS)):
                raise ValueError(f"values differ: {x!r} and {y!r}")
            x, y = torch.tensor(float(x)), torch.tensor(float(y))
        elif x.shape != y.shape or x.dtype != y.dtype:
            raise ValueError(f"leaves of {tuple(x.shape)} {x.dtype} and "
                             f"{tuple(y.shape)} {y.dtype}")
        if x.numel() == 0:
            continue
        x, y = x.detach().cpu().double(), y.detach().cpu().double()
        same = (x == y) | (x.isnan() & y.isnan())
        d = torch.where(same, 0.0, (x - y).abs()).max()
        worst = float("nan") if d.isnan() else max(worst, float(d))
        if worst != worst:
            return worst
    return worst


# -- the JAX package's state digest --------------------------------------------------

def _jax_leaves(tree: Any, name: str = "", depth: int | None = None) -> Iterator[np.ndarray]:
    """An env state's leaves as the JAX package flattens its pytree: a
    dataclass's fields in order, ``None`` skipped, each in the JAX dtype
    (packed words and keys uint32).  ``depth`` counts the dicts entered
    inside ``extra``: a dict there is a JAX dict, flattened in sorted key
    order, and a dict within it stands for a JAX dataclass (BabyAI's
    instruction code and verifier state), in its fields' order."""
    if tree is None:
        return
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _jax_leaves(getattr(tree, f.name), f.name,
                                   0 if f.name == "extra" else depth)
    elif isinstance(tree, dict):
        for k in (tree if depth else sorted(tree)):
            yield from _jax_leaves(tree[k], k, None if depth is None else depth + 1)
    elif depth is not None:
        yield _extra_to_numpy(tree)
    else:
        arr = tree.detach().cpu().numpy()
        yield arr.astype(np.uint32) if name in _UINT32 else arr


def state_hash(state: Any, size: int = 16) -> str:
    """Deterministic digest of an env state: the JAX package's
    ``state_hash`` of the same state (sha256 over every leaf's bytes and
    shape in the JAX package's order and dtypes), the analogue of
    ``MiniGridEnv.hash`` extended to the whole state."""
    m = hashlib.sha256()
    for arr in _jax_leaves(state):
        m.update(arr.tobytes())
        m.update(str(arr.shape).encode())
    return m.hexdigest()[:size]

