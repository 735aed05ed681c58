"""Plain NumPy reference of the pooled auto-reset ring, as its configuration
states it.

B envs share a ring of 2B pre-generated levels: slots b and b + B serve env
b.  An env whose episode ended takes the level of slot b if that slot is
fresh, else of slot b + B if that one is, else (best effort) replays slot
b's level, which counts as stale.  A refill of K windows writes ``K *
pool_refill`` fresh levels into the contiguous block of slots at offset
``(tick * pool_refill) % 2B`` rounded down to the block size, from the keys
``split(k, n)`` where ``(key', k) = split(key)``, and advances the tick by K;
a slot whose draw the task does not accept keeps its level (best effort).
At reset ``(_, k_gen, k_refill) = split(key, 3)``: the first B levels of
``split(k_gen, 3B)`` are the envs, the other 2B fill the ring.

A level is a dict of arrays with a leading level dim.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import minigrid as M


def serve(flags: np.ndarray, done: np.ndarray):
    """For the envs whose episode ended: (their rows, the slot each takes
    its level from, whether that level is fresh, the flags after)."""
    b = done.shape[0]
    idx = np.nonzero(done)[0]
    f_lo, f_hi = flags[idx], flags[idx + b]
    slot = np.where(~f_lo & f_hi, idx + b, idx)
    fresh = f_lo | f_hi
    flags = flags.copy()
    flags[slot[fresh]] = False
    return idx, slot, fresh, flags


def put_rows(levels: dict, idx: np.ndarray, rows: dict) -> dict:
    """``levels`` with rows ``idx`` replaced by ``rows`` (nested dicts too)."""
    if isinstance(levels, dict):
        return {k: put_rows(levels[k], idx, rows[k]) for k in levels}
    out = levels.copy()
    out[idx] = rows
    return out


def select_rows(take: np.ndarray, a: dict, b: dict) -> dict:
    """Rows of ``a`` where ``take``, else of ``b`` (nested dicts too)."""
    if isinstance(a, dict):
        return {k: select_rows(take, a[k], b[k]) for k in a}
    a, b = np.asarray(a), np.asarray(b)
    return np.where(take.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def refill_block(tick: int, windows: int, pool_refill: int, ring: int) -> tuple[int, int]:
    """(offset, size) of the block a refill of ``windows`` windows writes."""
    n = min(windows * pool_refill, ring)
    off = (tick * pool_refill) % ring // n * n if n < ring else 0
    return off, n


def refill_keys(key: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(the ring's next key, the n level keys of this refill)."""
    nxt, k = M.split(key)[0], M.split(key)[1]
    return nxt, M.split(k, n)


def reset_keys(key: np.ndarray, num_envs: int) -> tuple[np.ndarray, np.ndarray]:
    """(the 3B level keys of the envs and the ring, the ring's key)."""
    k = M.split(key, 3)
    return M.split(k[1], 3 * num_envs), k[2]
