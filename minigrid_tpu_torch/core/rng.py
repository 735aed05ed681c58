"""A bit-exact twin of ``jax.random`` (threefry2x32) on torch tensors.

The JAX package draws every random number from ``jax.random``: the level
generators, the pooled level ring, the per-env auto-reset streams.  This module
reproduces the calls they make, bit for bit, as jax 0.9 computes them with
``jax_threefry_partitionable`` on (its default):

* ``split`` is ``_threefry_split_foldlike``: key i of ``split(k, n)`` is the
  threefry hash of the counter pair (0, i) under k;
* 32-bit ``bits`` is ``bits1 ^ bits2`` of ``_threefry_random_bits_partitionable``
  over the same iota counters;
* ``randint`` is ``jax.random._randint``: two bit draws from ``split(key)``,
  unsigned span arithmetic, ``span = 1`` when ``maxval <= minval``.

A key is a pair of uint32 words.  torch has no full uint32 arithmetic, so keys
and intermediate words are int64 holding values in [0, 2^32), masked after
every add and rotate.  Every function is batched: a key tensor has shape
``[..., 2]`` and the leading dims broadcast through.
"""

from __future__ import annotations

import math

import torch

from minigrid_tpu_torch.core.state import resolve_device

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under the
    key (k1, k2).  All int64 holding uint32 values; shapes broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: int64[2] = (0, seed
    mod 2^32)."""
    return torch.tensor([0, seed & _M32], dtype=torch.int64,
                        device=resolve_device(device))


def _hash_iota(keys: torch.Tensor, shape: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """threefry over the iota counters (0, i) of ``shape`` for each key:
    ``[..., 2]`` keys -> two ``[..., *shape]`` word tensors."""
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError("random draws above 2^32 values need the high counter")
    lo = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(shape)
    expand = (...,) + (None,) * len(shape)
    return threefry2x32(keys[..., 0][expand], keys[..., 1][expand],
                        torch.zeros_like(lo), lo)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` keys -> ``[..., num, 2]``."""
    b1, b2 = _hash_iota(keys, (num,))
    return torch.stack([b1, b2], dim=-1)


def bits(keys: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): ``[..., 2]`` keys -> int64
    ``[..., *shape]`` of uint32 values."""
    b1, b2 = _hash_iota(keys, tuple(shape))
    return b1 ^ b2


def _bound_tensor(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    return torch.full((), int(v), dtype=torch.int64, device=device)


def randint(keys: torch.Tensor, shape: tuple, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``.

    ``keys`` is ``[..., 2]``; ``minval``/``maxval`` are int32-range ints or
    int tensors that broadcast against ``[..., *shape]``.  Returns int32.
    Int bounds stay on the host: no copy to the device per draw."""
    shape = tuple(shape)
    sub = split(keys)  # [..., 2, 2]
    words = bits(sub, shape)  # [..., 2, *shape]
    higher = words.select(-1 - len(shape), 0)
    lower = words.select(-1 - len(shape), 1)
    if isinstance(minval, torch.Tensor) or isinstance(maxval, torch.Tensor):
        lo, hi = (_bound_tensor(v, keys.device) for v in (minval, maxval))
        span = (hi - lo) & _M32
        span = torch.where(hi <= lo, torch.ones_like(span), span)
        multiplier = torch.remainder(torch.full_like(span, 1 << 16), span)
    else:
        lo, hi = int(minval), int(maxval)
        span = 1 if hi <= lo else (hi - lo) & _M32
        multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    offset = (((higher % span) * multiplier) + (lower % span)) & _M32
    offset = offset % span
    # int32 add with wraparound, as jax adds in the sampling dtype
    out = ((lo + offset + (1 << 31)) & _M32) - (1 << 31)
    return out.to(torch.int32)
