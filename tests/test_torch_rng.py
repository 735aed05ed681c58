"""The port's threefry twin against ``jax.random``, bit for bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.ops import threefry
from minigrid_tpu_torch.utils import trace
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


# -- the kernel's dispatch and layouts (ops/threefry.py) ------------------------------

def _emulate(lay: threefry.Layout) -> torch.Tensor:
    """What the kernel computes from a layout, element (i, j) read at the
    layout's strides and hashed with the plain version: the CPU's stand-in
    for ``csrc/threefry.cu``."""
    size = (lay.n, lay.m)
    at = lay.keys.storage_offset()
    k0 = torch.as_strided(lay.keys, size, (lay.ks_i, lay.ks_j), at)
    k1 = torch.as_strided(lay.keys, size, (lay.ks_i, lay.ks_j), at + lay.kw)
    if lay.data is None:
        c = lay.base + torch.arange(lay.m, dtype=torch.int64).expand(size)
    else:
        c = torch.as_strided(lay.data, size, (lay.ds_i, lay.ds_j), lay.data.storage_offset())
    y0, y1 = rng.threefry2x32(k0, k1, torch.zeros_like(c), c)
    return ((y0 ^ y1) if lay.xor else torch.stack([y0, y1], -1)).reshape(lay.out_shape)


def _words(*lead: int, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2**32, lead + (2,), generator=g, dtype=torch.int64)


_EXTREME = torch.tensor([[0, 0], [2**32 - 1, 2**32 - 1], [0, 2**32 - 1], [2**32 - 1, 0]])
_PERMUTED = _words(5, 4, 3).permute(2, 1, 0, 3)  # no one stride walks its leading dims
_COLUMNS = _words(8).T.contiguous().T  # [8, 2], the two words 8 apart


def _iota(keys, shape, rows, pairs):
    base, count = threefry.iota_rows(tuple(shape), rows)
    return threefry.iota_layout(keys, base, count, pairs)


# (name, the layout, the plain path's result, whether the layout copies the keys)
_LAYOUT_CASES = {
    **{f"split{num}-b{b}": (lambda b=b, num=num: _iota(_words(b), (num,), None, True),
                            lambda b=b, num=num: rng.split(_words(b), num), False)
       for b in (1, 16) for num in (2, 3, 5, 37)},
    "split-of-unbind": (lambda: _iota(rng.split(_words(16), 5).unbind(1)[3], (3,), None, True),
                        lambda: rng.split(rng.split(_words(16), 5).unbind(1)[3], 3), False),
    "split-rows": (lambda: _iota(_words(), (4096,), (5, 77), True),
                   lambda: rng.split(_words(), 4096)[5:77], False),
    "split-words-strided": (lambda: _iota(_COLUMNS, (3,), None, True),
                            lambda: rng.split(_COLUMNS, 3), False),
    "split-one-key": (lambda: _iota(_words(), (3,), None, True),
                      lambda: rng.split(_words(), 3), False),
    "split-extreme-words": (lambda: _iota(_EXTREME, (5,), None, True),
                            lambda: rng.split(_EXTREME, 5), False),
    "split-empty-batch": (lambda: _iota(_words(0), (3,), None, True),
                          lambda: rng.split(_words(0), 3), False),
    "split-permuted-keys": (lambda: _iota(_PERMUTED, (3,), None, True),
                            lambda: rng.split(_PERMUTED, 3), True),
    **{f"bits{shape}": (lambda shape=shape: _iota(_words(4), shape, None, False),
                        lambda shape=shape: rng.bits(_words(4), shape), False)
       for shape in ((), (30,), (484,), (64, 7))},
    "bits-rows": (lambda: _iota(_words(), (64, 7), (10, 42), False),
                  lambda: rng.bits(_words(), (64, 7))[10:42], False),
    "bits-of-unbind": (lambda: _iota(rng.split(_words(8), 2).unbind(-2)[1], (7,), None, False),
                       lambda: rng.bits(rng.split(_words(8), 2).unbind(-2)[1], (7,)), False),
    "bits-extreme-words": (lambda: _iota(_EXTREME, (30,), None, False),
                           lambda: rng.bits(_EXTREME, (30,)), False),
    "bits-empty-draw": (lambda: _iota(_words(4), (0,), None, False),
                        lambda: rng.bits(_words(4), (0,)), False),
    "fold-int": (lambda: _iota(_words(9), (), None, True),  # fold_in(k, d): the counter d
                 lambda: rng.split(_words(9), 1)[:, 0], False),
    "fold-lanes": (lambda: threefry.fold_layout(_words(12)[:, None], torch.arange(8)),
                   lambda: rng.fold_in(_words(12)[:, None], torch.arange(8)), False),
    "fold-per-key": (lambda: threefry.fold_layout(_words(12), torch.arange(12) * 977),
                     lambda: rng.fold_in(_words(12), torch.arange(12) * 977), False),
    "fold-one-key": (lambda: threefry.fold_layout(_words(), torch.arange(5)),
                     lambda: rng.fold_in(_words(), torch.arange(5)), False),
    "fold-3d": (lambda: threefry.fold_layout(_words(3, 4, 5), torch.arange(4)[:, None]),
                lambda: rng.fold_in(_words(3, 4, 5), torch.arange(4)[:, None]), False),
    "fold-extreme": (lambda: threefry.fold_layout(_EXTREME, torch.tensor([0, 2**32 - 1,
                                                                          1, 2**31])),
                     lambda: rng.fold_in(_EXTREME, torch.tensor([0, 2**32 - 1, 1, 2**31])),
                     False),
    "fold-words-strided": (lambda: threefry.fold_layout(_COLUMNS, torch.arange(8)),
                           lambda: rng.fold_in(_COLUMNS, torch.arange(8)), False),
    "fold-permuted-keys": (lambda: threefry.fold_layout(_PERMUTED, torch.arange(5)),
                           lambda: rng.fold_in(_PERMUTED, torch.arange(5)), True),
}


@pytest.mark.parametrize("case", sorted(_LAYOUT_CASES))
def test_kernel_layouts_give_the_plain_words(case):
    """The layouts the wrapper hands the kernel, read as the kernel reads
    them, give the plain path's words in its shape; keys are walked in place
    (no copy) unless no stride walks them."""
    layout, plain, copies = _LAYOUT_CASES[case]
    lay, want = layout(), plain()
    got = _emulate(lay)
    assert got.shape == want.shape and got.dtype == want.dtype == torch.int64
    assert torch.equal(got, want)
    assert 2 * lay.n * lay.m < 2**31 and lay.keys.dtype == torch.int64
    assert (lay.keys.is_contiguous() and lay.kw == 1) or not copies


def test_kernel_layouts_read_fold_in_keys_and_lanes_in_place():
    """``levelgen``'s ``fold_in(keys[:, None], lanes)``: two dims, the keys'
    row stride and the lanes' own, nothing copied."""
    keys = rng.split(_words(16), 5)[:, 2]  # [16, 2], row stride 10
    lanes = torch.arange(8)
    lay = threefry.fold_layout(keys[:, None], lanes)
    assert (lay.n, lay.m, lay.ks_i, lay.ks_j, lay.ds_i, lay.ds_j) == (16, 8, 10, 0, 0, 1)
    assert lay.keys.data_ptr() == keys.data_ptr() and lay.data.data_ptr() == lanes.data_ptr()
    assert lay.out_shape == (16, 8, 2) and not lay.xor
    lay = _iota(keys, (30,), None, False)
    assert (lay.n, lay.m, lay.ks_i, lay.base, lay.out_shape) == (16, 30, 10, 0, (16, 30))


_DRAWS = {
    "split": lambda k: rng.split(k, 5),
    "bits": lambda k: rng.bits(k, (3, 4), (1, 3)),
    "fold_in": lambda k: rng.fold_in(k, 7),
    "fold_in-tensor": lambda k: rng.fold_in(k[:, None], torch.arange(3)),
    "randint": lambda k: rng.randint(k, (6,), 0, 9),
    "uniform": lambda k: rng.uniform(k, (6,)),
    "permutation": lambda k: rng.permutation(k, 9),
    "categorical": lambda k: rng.categorical(k, torch.zeros(4, 5)),
    "categorical_one_key": lambda k: rng.categorical_one_key(k[0], torch.zeros(4, 5)),
}


@pytest.mark.parametrize("draw", sorted(_DRAWS))
def test_cpu_tensors_take_the_plain_path(draw, monkeypatch):
    """A CPU tensor never reaches the kernel's wrapper, and launches nothing."""
    def refuse(lay):
        raise AssertionError("a CPU draw reached the kernel")

    monkeypatch.setattr(threefry, "launch", refuse)
    assert trace.launches("threefry") == 0
    out = _DRAWS[draw](_words(4))
    assert out.device == CPU and trace.launches("threefry") == 0


_REFUSED = {
    "cpu-keys": (lambda: threefry.split(_words(4), 2), ValueError, "no threefry kernel"),
    "meta-keys": (lambda: rng.split(_words(4).to("meta"), 2), ValueError, "no threefry kernel"),
    "meta-bits": (lambda: rng.bits(_words(4).to("meta"), (3,)), ValueError, "no threefry"),
    "meta-fold_in": (lambda: rng.fold_in(_words(4).to("meta"), torch.arange(4, device="meta")),
                     ValueError, "no threefry kernel"),
    "int32-keys": (lambda: threefry.split(_words(4).int(), 2), TypeError, "int64"),
    "float-keys": (lambda: threefry.bits(_words(4).double(), (3,)), TypeError, "int64"),
    "keys-not-pairs": (lambda: threefry.split(torch.zeros(4, 3, dtype=torch.int64), 2),
                       ValueError, r"\[\.\.\., 2\]"),
    "float-fold-data": (lambda: threefry.fold_layout(_words(4), torch.zeros(4)), TypeError,
                        "int64"),
    "fold-data-out-of-range": (lambda: threefry.fold_in(_words(4), 2**32), ValueError, "2\\^32"),
    "fold-not-broadcast": (lambda: threefry.fold_layout(_words(4), torch.arange(3)),
                           ValueError, "broadcast"),
    "rows-outside": (lambda: threefry.bits(_words(4), (8,), (3, 9)), ValueError, "outside"),
    "index-overflow": (lambda: threefry.launch(_iota(_words(2**16), (2**15,), None, True)),
                       ValueError, "32-bit"),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_kernel_wrapper_refuses(case):
    """Wrong dtypes, shapes and extents are refused before the device is
    looked at; a device with no kernel (the CPU, ``meta``) raises: no
    fallback to the plain path."""
    call, error, match = _REFUSED[case]
    with pytest.raises(error, match=match):
        call()
    assert trace.launches("threefry") == 0
