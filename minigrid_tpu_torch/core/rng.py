"""A bit-exact twin of ``jax.random`` (threefry2x32) on torch tensors.

The JAX package draws every random number from ``jax.random``: the level
generators, the pooled level ring, the per-env auto-reset streams.  This module
reproduces the calls they make, bit for bit, as jax 0.9 computes them with
``jax_threefry_partitionable`` on (its default):

* ``split`` is ``_threefry_split_foldlike``: key i of ``split(k, n)`` is the
  threefry hash of the counter pair (0, i) under k;
* ``fold_in(k, d)`` is ``threefry_2x32(k, threefry_seed(d))``, the hash of
  the pair (0, d), so ``fold_in(k, 1) == split(k)[1]``;
* 32-bit ``bits`` is ``bits1 ^ bits2`` of ``_threefry_random_bits_partitionable``
  over the same iota counters;
* ``randint`` is ``jax.random._randint``: two bit draws from ``split(key)``,
  unsigned span arithmetic, ``span = 1`` when ``maxval <= minval``;
* ``permutation(key, n)`` is ``jax.random._shuffle`` of ``arange(n)``: per
  round ``key, sub = split(key)`` and a stable sort by ``bits(sub, (n,))``;
* float32 ``uniform`` is ``jax.random._uniform``: ``bits >> 9 | 0x3f800000``
  bitcast to float, minus 1, scaled, clamped below at ``minval``;
* ``categorical`` (``mode="low"``) is ``argmax(-log(-log(u)) + logits)`` with
  ``u = uniform(key, minval=tiny, maxval=1)``, the first index on ties: one
  key per row of logits, the form ``jax.vmap`` gives; ``categorical_one_key``
  is the same draw from ONE key over a whole batch of logits, the form of
  ``jax.random.categorical(key, logits[B, n])`` itself (the learner's
  action draw).

``top_k`` is ``jax.lax.top_k``'s order (not a draw): largest first, equal
values lower index first.

A key is a pair of uint32 words.  torch has no full uint32 arithmetic, so keys
and intermediate words are int64 holding values in [0, 2^32), masked after
every add and rotate.  Every function is batched: a key tensor has shape
``[..., 2]`` and the leading dims broadcast through.

``threefry2x32`` is the plain version of the hash, and a CPU tensor takes it.
On a CUDA tensor ``split``, ``bits`` and ``fold_in``, and every draw built on
them, hash in one launch of ``ops/threefry.py``'s kernel instead, bit for bit
the same words; there is no fallback.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.ops import threefry

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


def _hash_iota(keys: torch.Tensor, shape: tuple,
               rows: tuple[int, int] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """threefry over the iota counters (0, i) of ``shape`` for each key:
    ``[..., 2]`` keys -> two ``[..., *shape]`` word tensors.  With ``rows =
    (lo, hi)`` only the rows ``[lo, hi)`` of the first dim of ``shape``
    are hashed: the same words as those rows of the whole draw."""
    base, shape = threefry.iota_rows(shape, rows)
    lo = torch.arange(base, base + math.prod(shape), dtype=torch.int64,
                      device=keys.device).reshape(shape)
    expand = (...,) + (None,) * len(shape)
    return threefry2x32(keys[..., 0][expand], keys[..., 1][expand],
                        torch.zeros_like(lo), lo)


def split(keys: torch.Tensor, num: int = 2, rows: tuple[int, int] | None = None) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` keys -> ``[..., num, 2]``; with
    ``rows = (lo, hi)`` the keys ``[lo, hi)`` of the ``num`` alone."""
    if keys.device.type != "cpu":
        return threefry.split(keys, num, rows)
    b1, b2 = _hash_iota(keys, (num,), rows)
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the threefry hash of the counter pair
    (0, data) under each key, ``[..., 2]`` -> ``[..., 2]``.  ``data`` is an
    int in [0, 2^32) or an int tensor of such values that broadcasts against
    the keys' leading dims.  ``fold_in(k, 1) == split(k)[1]``."""
    if keys.device.type != "cpu":
        return threefry.fold_in(keys, data)
    if isinstance(data, torch.Tensor):
        data = data.to(device=keys.device, dtype=torch.int64)
    elif not 0 <= int(data) <= _M32:
        raise ValueError(f"fold_in data must lie in [0, 2^32), got {data}")
    else:
        data = torch.full((), int(data), dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def bits(keys: torch.Tensor, shape: tuple = (),
         rows: tuple[int, int] | None = None) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): ``[..., 2]`` keys -> int64
    ``[..., *shape]`` of uint32 values; with ``rows = (lo, hi)`` the rows
    ``[lo, hi)`` of the first dim of ``shape`` alone."""
    if keys.device.type != "cpu":
        return threefry.bits(keys, tuple(shape), rows)
    b1, b2 = _hash_iota(keys, tuple(shape), rows)
    return b1 ^ b2


def _bound_tensor(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    return torch.full((), int(v), dtype=torch.int64, device=device)


def randint(keys: torch.Tensor, shape: tuple, minval, maxval,
            rows: tuple[int, int] | None = None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``.

    ``keys`` is ``[..., 2]``; ``minval``/``maxval`` are int32-range ints or
    int tensors that broadcast against ``[..., *shape]`` (against the rows
    drawn, with ``rows``).  Returns int32.  ``rows = (lo, hi)`` returns only
    the rows ``[lo, hi)`` of the first dim of ``shape``, bitwise those rows
    of the whole draw: a rank's share of a batch-wide draw.  Int bounds stay
    on the host: no copy to the device per draw."""
    shape = tuple(shape)
    sub = split(keys)  # [..., 2, 2]
    words = bits(sub, shape, rows)  # [..., 2, *shape]
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


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``[..., 2]`` keys -> int32
    ``[..., n]``, each row a permutation of ``range(n)``.

    ``ceil(3 ln(max(1, n)) / ln(2^32 - 1))`` rounds (one below n of about
    1,600); each round splits the key and sorts the row stably by fresh
    32-bit words, as ``lax.sort_key_val`` does."""
    n = int(n)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_M32)))
    x = torch.arange(n, dtype=torch.int32, device=keys.device)
    x = x.expand(keys.shape[:-1] + (n,))
    for _ in range(rounds):
        keys, sub = split(keys).unbind(-2)
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = x.gather(-1, order)
    return x.contiguous()


_TINY = float(torch.finfo(torch.float32).tiny)


def uniform(keys: torch.Tensor, shape: tuple = (), minval: float = 0.0,
            maxval: float = 1.0, rows: tuple[int, int] | None = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``:
    ``[..., 2]`` keys -> float32 ``[..., *shape]`` in [minval, maxval)
    (only the rows ``[lo, hi)`` of its first dim with ``rows``).

    The 23 high bits of each word become the mantissa of a float in [1, 2);
    minus 1 that is a multiple of 2^-23 in [0, 1), exact.  Bitwise for the
    ranges the JAX package draws, [0, 1) and [tiny, 1), where the scale is
    exactly 1 and no rounding order can change a bit."""
    words = bits(keys, tuple(shape), rows)
    floats = (((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
              - 1.0)
    # the bounds and their difference in float32, as JAX converts them
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    return torch.clamp(floats * float(span) + float(lo), min=float(lo))


def categorical(keys: torch.Tensor, logits: torch.Tensor,
                mode: str = "low") -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` per row, over the last dim:
    keys ``[..., 2]`` and float32 logits ``[..., n]`` -> int32 ``[...]``,
    each row drawn from its own key (leading dims broadcast), which is what
    ``jax.vmap`` of the call over per-env keys gives.  A single key ``[2]``
    broadcasts ONE row of noise over every row of logits; that is not
    ``jax.random.categorical(key, logits[B, n])``, which draws ``(B, n)``
    noise from the one key: use :func:`categorical_one_key` for that.

    The Gumbel-max draw of ``mode="low"``: ``argmax(-log(-log(u)) + logits)``
    for ``u = uniform(key, (n,), tiny, 1)``, the first index on ties, index 0
    when every logit is ``-inf``.  The noise is strictly increasing in ``u``
    and its neighbouring values lie several ulps apart, so the index does not
    depend on the last bit of ``log``: with logits of 0 and ``-inf`` (nearly
    every draw of the JAX package) it is JAX's index exactly.  Other finite
    logits must be computed as JAX computes them: BlocksDataset's are
    ``log(p)`` of float32 weights, and with the same float32 ``log(p)`` the
    index is JAX's on 2^20 keys (``tests/test_torch_dataset_envs.py``).  JAX's
    ``use_high_dynamic_range_gumbel`` mode draws two uniforms per entry; no
    caller sets it, and it raises here."""
    if mode != "low":
        raise ValueError(f"categorical supports mode='low' only, got {mode!r}")
    u = uniform(keys, (logits.shape[-1],), _TINY, 1.0)
    return _gumbel_argmax(u, logits)


def categorical_one_key(key: torch.Tensor, logits: torch.Tensor,
                        rows: tuple[int, int] | None = None,
                        num_rows: int | None = None) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` with ONE key ``[2]`` over a
    batch of float32 logits ``[..., n]`` -> int32 ``[...]``: the noise is
    ``uniform(key, logits.shape, tiny, 1)``, one draw over the whole shape,
    as JAX draws it when a single key meets batched logits (the learner's
    action draw, ``minigrid_tpu/rl/ppo.py:346``).  Same Gumbel-max and tie
    rule as :func:`categorical`.

    ``rows = (lo, hi)`` with ``num_rows``: ``logits`` ``[hi - lo, n]`` are
    the rows ``[lo, hi)`` of a ``[num_rows, n]`` batch, and the draw is
    those rows of the draw over the whole batch, bitwise (a rank's share of
    a data-parallel rollout)."""
    if key.shape != (2,):
        raise ValueError(f"categorical_one_key takes one key [2], got {tuple(key.shape)}")
    shape = tuple(logits.shape)
    if rows is not None:
        if logits.dim() != 2 or num_rows is None or rows[1] - rows[0] != shape[0]:
            raise ValueError(f"rows {rows} of {num_rows} do not match logits {shape}")
        shape = (num_rows, shape[1])
    return _gumbel_argmax(uniform(key, shape, _TINY, 1.0, rows), logits)


def _gumbel_argmax(u: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + logits, dim=-1).to(torch.int32)


def top_k(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k(values, k)`` over the last dim: (the k largest values,
    their int32 indices), largest first and equal values lower index first,
    as XLA orders them.  ``torch.topk`` promises no order among ties; a
    stable descending sort keeps the lower index first."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)
