"""The port's learner networks against the JAX package's flax modules
(``minigrid_tpu/rl/networks.py``, ``minigrid_tpu/rl/rnn.py``).

* ``ObsEncoder`` and ``ActorCritic`` on flax's own parameters, carried across
  by ``utils/convert.py``: 64 DoorKey-8x8 observations and 16 BabyAI ones
  (non-zero mission codes), float32 within 1e-5, bfloat16 within 1e-2 of the
  largest output's magnitude;
* the converters' round trip flax -> port -> flax, bitwise;
* the port's init in distribution, against the standard deviations flax's
  initializers specify;
* ``RecurrentActorCritic`` over 16 steps with dones, and the cleared carry
  equal to a fresh one.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from minigrid_tpu.rl import ActorCritic as JActorCritic
from minigrid_tpu.rl import ObsEncoder as JObsEncoder
from minigrid_tpu.rl.rnn import RecurrentActorCritic as JRecurrent

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.parallel.vector import VectorEnv
from minigrid_tpu_torch.rl import ActorCritic, RecurrentActorCritic
from minigrid_tpu_torch.rl import networks as N
from minigrid_tpu_torch.utils.convert import (
    actor_critic_from_flax,
    actor_critic_to_flax,
    recurrent_from_flax,
    recurrent_to_flax,
)

from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CPU = torch.device("cpu")
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
F32_ATOL = 1e-5
# bf16: the two sides round their bf16 sums and products at other points (a
# probe found 1.6e-3 of the largest logit; 4.4e-3 of the largest value)
BF16_REL = 1e-2
# the recurrent network in bf16: its carry is bf16 (a relative step of 2^-8),
# and each step's rounding of c and h may go either way and is fed back; over
# 16 steps the worst seen was 1.4e-2 of the largest output (h itself)
BF16_RECURRENT_REL = 3e-2


def observations(env_id: str, n: int, seed: int, steps: int = 5) -> dict:
    """``n`` observations of ``env_id`` after a short random walk, as numpy."""
    venv = VectorEnv(mgt.make(env_id), n, device=CPU)
    obs, st = venv.reset(rng.PRNGKey(seed, CPU))
    for t in range(steps):
        obs, st, *_ = venv.step(st, rng.randint(rng.PRNGKey(seed + 100 + t, CPU), (n,), 0, 7))
    return {k: v.numpy() for k, v in obs.items()}


@pytest.fixture(scope="module")
def obs_sets():
    sets = {"DoorKey-8x8": observations("MiniGrid-DoorKey-8x8-v0", 64, 1),
            "GoToLocal": observations("BabyAI-GoToLocal-v0", 16, 2)}
    assert (sets["GoToLocal"]["mission"] != 0).any()
    return sets


def to_jax(obs: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in obs.items()}


def to_torch(obs: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in obs.items()}


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_close(got: torch.Tensor, want, dtype_name: str, what: str,
                 bf16_rel: float = BF16_REL) -> None:
    """float32 within ``F32_ATOL``; bf16 within ``bf16_rel`` of the largest
    magnitude of ``want``."""
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL, err_msg=what)
    else:
        err = np.abs(got - want).max()
        assert err <= bf16_rel * np.abs(want).max(), (what, err, np.abs(want).max())


# -- the feed-forward network -------------------------------------------------------------

@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("obs_name", ["DoorKey-8x8", "GoToLocal"])
def test_actor_critic_matches_flax(obs_sets, obs_name, dtype_name):
    """Logits and values on flax's parameters, the policy head scaled x100 so
    that the logits are far from zero."""
    tdt, jdt = DTYPES[dtype_name]
    obs = obs_sets[obs_name]
    jnet = JActorCritic(num_actions=7, dtype=jdt)
    tree = tree_np(jnet.init(jax.random.PRNGKey(5), to_jax(obs)))
    tree["params"]["Dense_1"]["kernel"] = tree["params"]["Dense_1"]["kernel"] * 100
    jl, jv = jnet.apply(jax.tree_util.tree_map(jnp.asarray, tree), to_jax(obs))
    model = actor_critic_from_flax(tree, tdt, CPU)
    with torch.no_grad():
        logits, value = model(to_torch(obs))
    assert logits.dtype == value.dtype == torch.float32
    assert float(logits.abs().max()) > 0.1
    assert_close(logits, jl, dtype_name, "logits")
    assert_close(value, jv, dtype_name, "value")


@pytest.mark.parametrize("dtype_name", DTYPES)
def test_obs_encoder_matches_flax(obs_sets, dtype_name):
    """The encoder alone, on the BabyAI observations (43 mission slots)."""
    tdt, jdt = DTYPES[dtype_name]
    obs = obs_sets["GoToLocal"]
    jenc = JObsEncoder(dtype=jdt)
    variables = jenc.init(jax.random.PRNGKey(6), to_jax(obs))
    want = jenc.apply(variables, to_jax(obs))
    tree = {"params": {"ObsEncoder_0": tree_np(variables)["params"],
                       "Dense_0": {"kernel": np.zeros((256, 256), np.float32),
                                   "bias": np.zeros(256, np.float32)},
                       "Dense_1": {"kernel": np.zeros((256, 7), np.float32),
                                   "bias": np.zeros(7, np.float32)},
                       "Dense_2": {"kernel": np.zeros((256, 1), np.float32),
                                   "bias": np.zeros(1, np.float32)}}}
    encoder = actor_critic_from_flax(tree, tdt, CPU).encoder
    with torch.no_grad():
        got = encoder(to_torch(obs))
    assert got.dtype == tdt and tuple(got.shape) == (16, 256)
    assert_close(got, want, dtype_name, "features")


def test_parameter_count_and_layout():
    """The default network at V=7: flax's 1,850,201 parameters, its first
    dense layer 7*7*128 + 16 + 16 = 6,304 rows wide."""
    obs = observations("MiniGrid-DoorKey-8x8-v0", 2, 3, steps=0)
    model = ActorCritic(num_actions=8).init(rng.PRNGKey(0, CPU), to_torch(obs))
    assert sum(p.numel() for p in model.parameters()) == 1_850_201
    assert tuple(model.encoder.dense.weight.shape) == (256, 6304)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["ActorCritic", "RecurrentActorCritic"])
def test_flax_round_trip_is_bitwise(obs_sets, kind):
    obs = to_jax(obs_sets["DoorKey-8x8"])
    if kind == "ActorCritic":
        tree = tree_np(JActorCritic(num_actions=7).init(jax.random.PRNGKey(7), obs))
        back = actor_critic_to_flax(actor_critic_from_flax(tree, device=CPU))
    else:
        net = JRecurrent(num_actions=7)
        tree = tree_np(net.init(jax.random.PRNGKey(8), net.initialize_carry(64), obs,
                                jnp.zeros((64,), bool)))
        back = recurrent_to_flax(recurrent_from_flax(tree, device=CPU))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


# -- init ---------------------------------------------------------------------------------

def flax_std(path: str, shape: tuple, embed_dim: int = 16) -> float:
    """The standard deviation flax's initializer specifies for a kernel:
    ``lecun_normal`` (variance 1/fan_in), ``default_embed_init`` (1/E)."""
    if "Embed" in path:
        return 1.0 / math.sqrt(embed_dim)
    return math.sqrt(1.0 / math.prod(shape[:-1]))  # HWIO / [in, out]: fan_in


def test_init_matches_flax_in_distribution(obs_sets):
    """Every kernel of at least 4,096 entries within 5 % of flax's std (the
    generator is seeded from the key, so this cannot flake), biases zero,
    the heads orthogonal with gains 0.01 and 1; one key, one network."""
    obs = to_torch(obs_sets["DoorKey-8x8"])
    model = ActorCritic(num_actions=7).init(rng.PRNGKey(21, CPU), obs)
    tree = actor_critic_to_flax(model)
    checked = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = jax.tree_util.keystr(path)
        if name.endswith("['bias']"):
            assert not leaf.any(), name
        elif "Dense_1" in name or "Dense_2" in name:
            gain = 0.01 if "Dense_1" in name else 1.0
            np.testing.assert_allclose(leaf.T @ leaf, gain ** 2 * np.eye(leaf.shape[1]),
                                       atol=1e-6 * gain ** 2, err_msg=name)
        elif leaf.size >= 4096:
            std = flax_std(name, leaf.shape)
            assert abs(leaf.std() / std - 1) < 0.05, (name, leaf.std(), std)
            if "Embed" not in name:  # truncated at two standard deviations
                assert np.abs(leaf).max() <= 2 * std / N._TRUNC_STD + 1e-6, name
            checked += 1
    assert checked == 4  # Conv_0, Conv_1, the two hidden Denses (every table is smaller)
    again = ActorCritic(num_actions=7).init(rng.PRNGKey(21, CPU), obs)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    other = ActorCritic(num_actions=7).init(rng.PRNGKey(22, CPU), obs)
    assert not torch.equal(model.encoder.dense.weight, other.encoder.dense.weight)


def test_small_tables_by_their_initializers():
    """The 4x16 and 11x16 embedding tables and the LSTM's hidden blocks are
    too small to sample a std from: hold the initializers themselves on
    large tensors of the same fan."""
    gen = torch.Generator().manual_seed(0)
    table = N.embed_normal_(torch.empty(20000, 16), 16, gen)
    assert abs(float(table.std()) * 4.0 - 1) < 0.02  # 1/sqrt(16)
    kernel = N.lecun_normal_(torch.empty(256, 4000), 4000, gen)
    assert abs(float(kernel.std()) * math.sqrt(4000) - 1) < 0.02
    block = N.orthogonal_(torch.empty(256, 256), 1.0, gen)
    torch.testing.assert_close(block @ block.T, torch.eye(256), atol=1e-5, rtol=0)


# -- the recurrent network -------------------------------------------------------------

@pytest.mark.parametrize("dtype_name", DTYPES)
def test_recurrent_matches_flax_over_16_steps(dtype_name):
    """16 steps of 16 MemoryS7 envs (4-step episodes, so the done-gated
    carry clears), flax's parameters, the carry fed back each step; and
    ``unroll`` (the encoder over all steps at once) equal to the step loop."""
    tdt, jdt = DTYPES[dtype_name]
    b, t = 16, 16
    venv = VectorEnv(mgt.make("MiniGrid-MemoryS7-v0", max_steps=4), b, device=CPU)
    obs, st = venv.reset(rng.PRNGKey(30, CPU))
    seq, dones, prev = [], [], torch.zeros(b, dtype=torch.bool)
    for i in range(t):
        seq.append({k: v.numpy() for k, v in obs.items()})
        dones.append(prev.numpy())
        obs, st, _, term, trunc, _ = venv.step(st, rng.randint(rng.PRNGKey(40 + i, CPU),
                                                                 (b,), 0, 3))
        prev = term | trunc
    assert np.stack(dones).any()

    jnet = JRecurrent(num_actions=7, dtype=jdt)
    jcarry = jnet.initialize_carry(b)
    params = jnet.init(jax.random.PRNGKey(9), jcarry, to_jax(seq[0]), jnp.zeros((b,), bool))
    tree = tree_np(params)
    tree["params"]["Dense_0"]["kernel"] = tree["params"]["Dense_0"]["kernel"] * 100
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = recurrent_from_flax(tree, tdt, CPU)
    carry = model.initialize_carry(b, CPU)
    assert carry[0].dtype == tdt
    apply = jax.jit(jnet.apply)
    logits_seq = []
    with torch.no_grad():
        for i in range(t):
            jcarry, (jl, jv) = apply(params, jcarry, to_jax(seq[i]), jnp.asarray(dones[i]))
            carry, (logits, value) = model(carry, to_torch(seq[i]), torch.from_numpy(dones[i]))
            assert_close(logits, jl, dtype_name, f"logits step {i}", BF16_RECURRENT_REL)
            assert_close(value, jv, dtype_name, f"value step {i}", BF16_RECURRENT_REL)
            logits_seq.append(logits)
        assert_close(carry[1], jcarry[1], dtype_name, "h after 16 steps", BF16_RECURRENT_REL)
        stacked = {k: torch.from_numpy(np.stack([s[k] for s in seq])) for k in seq[0]}
        _, (u_logits, _) = model.unroll(model.initialize_carry(b, CPU), stacked,
                                        torch.from_numpy(np.stack(dones)))
    assert_close(u_logits, torch.stack(logits_seq).numpy(), dtype_name, "unroll")


def test_cleared_carry_equals_fresh(obs_sets):
    """``done`` clears the carry before the cell: outputs from a dirty carry
    with done equal those from a fresh carry without (tests/test_rl.py)."""
    obs = to_torch({k: v[:2] for k, v in obs_sets["DoorKey-8x8"].items()})
    model = RecurrentActorCritic(num_actions=7).init(rng.PRNGKey(2, CPU), obs)
    fresh = model.initialize_carry(2, CPU)
    dirty = tuple(c + 1.0 for c in fresh)
    with torch.no_grad():
        _, (l1, v1) = model(dirty, obs, torch.ones(2, dtype=torch.bool))
        _, (l2, v2) = model(fresh, obs, torch.zeros(2, dtype=torch.bool))
    assert torch.equal(l1, l2) and torch.equal(v1, v2)
