"""Batched sampling helpers shared by the env generators.

Counterpart of ``minigrid_tpu/core/sampling.py``: a uniform color, a uniform
(type, color) pair, and n distinct pairs as a permutation prefix over the
type x color product.  Every draw comes from the threefry twin, one key per
env (``[..., 2]``), so a batch gives bitwise what the vmapped JAX helpers
give.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.grid_ops import const, take1, take_vec

# Color ids in COLOR_NAMES (sorted) order: the space _rand_color draws from.
SORTED_COLOR_IDS = np.asarray([C.COLOR_TO_IDX[n] for n in C.COLOR_NAMES],
                              dtype=np.int32)
NUM_COLOR_NAMES = len(C.COLOR_NAMES)  # 10


def _table(values, device) -> torch.Tensor:
    return const(values, device, torch.int32)


def rand_color(keys: torch.Tensor) -> torch.Tensor:
    """One uniform color id per key: int32[...]."""
    i = rng.randint(keys, (), 0, NUM_COLOR_NAMES)
    return take1(_table(SORTED_COLOR_IDS, keys.device), i)


def rand_type_color(keys: torch.Tensor, type_ids) -> torch.Tensor:
    """One uniform (type, color) pair per key, duplicates allowed:
    int32[..., 2]."""
    k1, k2 = rng.split(keys).unbind(-2)
    types = _table(type_ids, keys.device)
    t = take1(types, rng.randint(k1, (), 0, types.shape[0]))
    return torch.stack([t, rand_color(k2)], dim=-1).to(torch.int32)


def distinct_type_colors(keys: torch.Tensor, n: int, type_ids) -> torch.Tensor:
    """n distinct (type, color) pairs per key, uniform without replacement
    over the |types| x 10 product: int32[..., n, 2]."""
    types = _table(type_ids, keys.device)
    total = types.shape[0] * NUM_COLOR_NAMES
    if n > total:
        raise ValueError(f"{n} distinct pairs out of {total}")
    perm = rng.permutation(keys, total)[..., :n]
    t = take_vec(types, perm // NUM_COLOR_NAMES)
    c = take_vec(_table(SORTED_COLOR_IDS, keys.device), perm % NUM_COLOR_NAMES)
    return torch.stack([t, c], dim=-1).to(torch.int32)
