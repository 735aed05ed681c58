"""The port's threefry twin against ``jax.random``, bit for bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minigrid_tpu_torch.core import rng
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CPU = torch.device("cpu")


def _np(key: torch.Tensor) -> np.ndarray:
    return key.numpy().astype(np.uint32)


def _keys(n: int, seed: int = 0):
    """n JAX keys and the same keys as the port's int64 tensor."""
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 42, 123456789, 2**31 - 1, -1, -7])
def test_prng_key(seed):
    got = rng.PRNGKey(seed, CPU)
    assert got.dtype == torch.int64 and got.shape == (2,)
    np.testing.assert_array_equal(_np(got), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 5, 37])
def test_split(num):
    for seed in (0, 5, 2**31 - 1):
        key = jax.random.PRNGKey(seed)
        got = rng.split(rng.PRNGKey(seed, CPU), num)
        assert got.shape == (num, 2)
        np.testing.assert_array_equal(_np(got), np.asarray(jax.random.split(key, num)))
    # batched [N, 2] keys against jax.vmap
    jk, tk = _keys(9, seed=num)
    want = jax.vmap(lambda k: jax.random.split(k, num))(jk)
    np.testing.assert_array_equal(_np(rng.split(tk, num)), np.asarray(want))


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5)])
def test_bits(shape):
    jk, tk = _keys(4, seed=11)
    want = jax.vmap(lambda k: jax.random.bits(k, shape))(jk)
    got = rng.bits(tk, shape)
    assert got.shape == (4,) + shape
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))


@pytest.mark.parametrize("lo,hi", [(0, 8), (2, 6), (1, 6), (-5, 3), (0, 1),
                                   (3, 3), (4, 2), (0, 2**31 - 1),
                                   (-2**31, 2**31 - 1), (0, 100_000)])
def test_randint_static_range(lo, hi):
    """Scalar and vector shapes, static bounds, including maxval <= minval
    (span 1: minval every time) and spans above 2^16."""
    for seed in (0, 3):
        key = jax.random.PRNGKey(seed)
        tkey = rng.PRNGKey(seed, CPU)
        for shape in ((), (64,)):
            want = jax.random.randint(key, shape, lo, hi, dtype=jnp.int32)
            got = rng.randint(tkey, shape, lo, hi)
            assert got.dtype == torch.int32 and tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_randint_per_row_bounds_batched():
    """Batched keys with one (minval, maxval) per key, some maxval <= minval:
    the generator's dynamic ``randint(k, (), 0, n_free - 1)`` pattern."""
    n = 64
    jk, tk = _keys(n, seed=21)
    r = np.random.default_rng(0)
    lo = r.integers(-3, 4, n).astype(np.int32)
    hi = (lo + r.integers(-2, 40, n)).astype(np.int32)
    want = jax.vmap(lambda k, a, b: jax.random.randint(k, (), a, b))(jk, lo, hi)
    got = rng.randint(tk, (), torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[hi <= lo] == lo[hi <= lo]).all()
    # per-row bounds broadcast over a vector shape
    want = jax.vmap(lambda k, a, b: jax.random.randint(k, (5,), a, b))(jk, lo, hi)
    got = rng.randint(tk, (5,), torch.from_numpy(lo)[:, None],
                      torch.from_numpy(hi)[:, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))



@pytest.mark.parametrize("data", [0, 1, 5, 2**31 - 1, 2**31, 2**32 - 1])
def test_fold_in(data):
    """Single and batched keys, data 0 and at and above 2^31."""
    for seed in (0, 42, 2**31 - 1):
        got = rng.fold_in(rng.PRNGKey(seed, CPU), data)
        assert got.dtype == torch.int64 and got.shape == (2,)
        np.testing.assert_array_equal(
            _np(got), np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data)))
    jk, tk = _keys(6, seed=data % 97)
    want = jax.vmap(lambda k: jax.random.fold_in(k, data))(jk)
    np.testing.assert_array_equal(_np(rng.fold_in(tk, data)), np.asarray(want))


def test_fold_in_per_key_data_and_split_identity():
    jk, tk = _keys(5, seed=3)
    data = np.array([0, 1, 7, 2**31, 2**32 - 1], dtype=np.uint32)
    want = jax.vmap(jax.random.fold_in)(jk, data)
    got = rng.fold_in(tk, torch.from_numpy(data.astype(np.int64)))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # fold_in(k, 1) == split(k)[1], which FusedVectorEnv.reset relies on
    assert torch.equal(rng.fold_in(tk, 1), rng.split(tk)[:, 1])
    with pytest.raises(ValueError):
        rng.fold_in(tk, -1)
    with pytest.raises(ValueError):
        rng.fold_in(tk, 2**32)
