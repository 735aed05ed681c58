"""BossLevel through the port's batch engine against the jitted JAX
``VectorEnv`` in lockstep (``tests/test_torch_babyai_step.py``'s harness):
B=64 ``pooled`` with its 16-level refill window and the best-effort refill,
16 steps at ``max_steps`` 8 (two waves of auto-resets).  Every step's
observation, reward bits and flags, and the final state, the ring and the
verifier state included, agree.
"""

from __future__ import annotations

import torch

from tests.test_torch_babyai_step import run_lockstep
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)


def test_bosslevel_pooled_best_effort_lockstep_matches_jax():
    """A 16-slot window of the 128-slot ring refilled each step with one
    unvalidated draw a slot.  A rejected draw keeps the slot's level, marked
    fresh all the same: some slots of the refilled windows keep their grid
    (a new 22x22 level equal to the old one is all but impossible)."""
    b, window = 64, 16
    kept = []

    def watch(t, state, out):
        off = int(state.tick) * window % (2 * b)
        before = state.pool.grid[off:off + window]
        after = out[1].pool.grid[off:off + window]
        kept.append(int((before == after).flatten(1).all(dim=1).sum()))
        assert bool(out[1].fresh[off:off + window].all())

    venv, rewards, ends, st = run_lockstep("BabyAI-BossLevel-v0", b, 16, 55, watch=watch,
                                           max_steps=8)
    assert (venv.reset_strategy, venv.pool_refill) == ("pooled", window)
    assert venv.best_effort_refill
    assert sum(kept) >= 1, kept
    n_fresh, n_stale = int(st.n_fresh), int(st.n_stale)
    assert n_fresh + n_stale == ends >= 2 * b and n_fresh > 0
    assert isinstance(st.pool.grid, torch.Tensor) and st.pool.grid.shape == (128, 22, 22)
