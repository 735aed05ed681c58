"""The port's PPO learner against the JAX package's (``minigrid_tpu/rl/ppo.py``).

* ``compute_gae`` against the jitted JAX function and the numpy loop of
  ``tests/test_rl.py``, with and without the truncation bootstrap;
* ``ppo_loss`` and its gradients (float32 network) against
  ``jax.value_and_grad(ppo_loss)``, leaf by leaf through the inverse converter;
* 8 optimizer steps on fixed gradients against optax's
  ``chain(clip_by_global_norm, adam)`` with the linear anneal, below and above
  the clip threshold;
* the one-key batched ``categorical`` against ``jax.random.categorical``,
  exactly, and the per-env form against ``jax.vmap`` of it;
* one whole PPO update on DoorKey-5x5 at a 10-step limit (B=8, T=16, 2
  epochs x 2 minibatches, float32 network), both sides from the JAX init's parameters and one key:
  the trajectory (against a jitted copy of the JAX update's rollout body),
  the runner after the update, the metrics and the parameters;
* the pooled ``refill_period`` update and the episode stats, port only, as
  ``tests/test_rl.py`` checks them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import minigrid_tpu
from minigrid_tpu.rl import ActorCritic as JActorCritic
from minigrid_tpu.rl import PPO as JPPO
from minigrid_tpu.rl import PPOConfig as JPPOConfig
from minigrid_tpu.rl.ppo import EpisodeStats as JEpisodeStats
from minigrid_tpu.rl.ppo import compute_gae as j_compute_gae
from minigrid_tpu.rl.ppo import ppo_loss as j_ppo_loss

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.parallel.vector import VectorEnv
from minigrid_tpu_torch.rl import PPO, ActorCritic, EpisodeStats, PPOConfig, compute_gae, ppo_loss
from minigrid_tpu_torch.rl.ppo import TrainState, linear_schedule, train_step_fn
from minigrid_tpu_torch.utils.convert import actor_critic_from_flax, actor_critic_to_flax

from tests.test_rl import reference_gae
from tests.test_torch_bridge import assert_state_equal
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CPU = torch.device("cpu")
# DoorKey-5x5 at a 10-step limit: truncations in a 16-step rollout
MAX_STEPS = 10
SMALL = dict(num_envs=8, num_steps=16, num_updates=2, num_minibatches=2, update_epochs=2)
# The parameters after one update, JAX against the port.  Adam moves a
# weight by at most about lr = 2.5e-4 a step (4 steps here).  The two sides'
# float32 gradients differ in their last bits (XLA and torch sum in other
# orders); where a gradient entry is near Adam's eps = 1e-5 (a convolution
# kernel's sums of cancelling terms), that moves the normalised step by a few
# percent of lr: 9.1e-6 was the worst seen (Conv_1's kernel).  So every entry
# within a tenth of one step, and each leaf's difference under 1 % of how far
# the update moved it (in L2).
PARAM_ATOL = 0.1 * 2.5e-4
PARAM_REL_L2 = 1e-2
# values and log-probs of the rollout (XLA and torch convolutions sum their
# products in other orders: 1e-7 seen)
VALUE_ATOL = 1e-5


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def max_leaf_diff(a: dict, b: dict) -> float:
    return max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda x, y: float(np.abs(np.asarray(x, np.float64) - y).max()), a, b)))


# -- GAE --------------------------------------------------------------------------------

@pytest.mark.parametrize("with_truncation", [False, True])
def test_gae_matches_jax_and_the_reference_loop(with_truncation):
    """Bitwise the jitted JAX ``compute_gae`` (same expression order, and
    XLA's two fused multiply-adds), and within 1e-5 of the numpy loop."""
    r = np.random.default_rng(3)
    t, b = 23, 9
    rewards = r.normal(size=(t, b)).astype(np.float32)
    values = r.normal(size=(t, b)).astype(np.float32)
    dones = r.random((t, b)) < 0.2
    last = r.normal(size=b).astype(np.float32)
    extra = {}
    if with_truncation:
        trunc = dones & (r.random((t, b)) < 0.5)
        extra = {"truncated": trunc, "trunc_values": r.normal(size=(t, b)).astype(np.float32)}
    jfn = jax.jit(lambda *a, **k: j_compute_gae(*a, 0.99, 0.95, **k))
    want = jfn(*map(jnp.asarray, (rewards, values, dones, last)),
               **{k: jnp.asarray(v) for k, v in extra.items()})
    got = compute_gae(*map(torch.from_numpy, (rewards, values, dones, last)), 0.99, 0.95,
                      **{k: torch.from_numpy(v) for k, v in extra.items()})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if not with_truncation:
        ref = reference_gae(rewards, values, dones, last, 0.99, 0.95)
        for g, w in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


# -- the loss and its gradients ------------------------------------------------------------

@pytest.fixture(scope="module")
def doorkey_batch():
    """64 DoorKey-8x8 observations with numpy-drawn actions, old log-probs,
    values, advantages and targets; a float32 flax ActorCritic on them."""
    env = mgt.make("MiniGrid-DoorKey-8x8-v0")
    venv = VectorEnv(env, 64, device=CPU)
    obs, st = venv.reset(rng.PRNGKey(11, CPU))
    for t in range(6):
        obs, st, *_ = venv.step(st, rng.randint(rng.PRNGKey(20 + t, CPU), (64,), 0, 7))
    r = np.random.default_rng(5)
    batch = {"obs": {k: v.numpy() for k, v in obs.items()},
             "action": r.integers(0, env.num_actions, 64).astype(np.int32),
             "log_prob": (np.log(1 / 8) + 0.05 * r.normal(size=64)).astype(np.float32),
             "value": r.normal(size=64).astype(np.float32),
             "advantage": r.normal(size=64).astype(np.float32),
             "target": r.normal(size=64).astype(np.float32)}
    jnet = JActorCritic(num_actions=env.num_actions, dtype=jnp.float32)
    tree = to_numpy(jnet.init(jax.random.PRNGKey(4), jax.tree_util.tree_map(
        jnp.asarray, batch["obs"])))
    # a policy head far from zero, so that the ratio and the clip are live
    tree["params"]["Dense_1"]["kernel"] = tree["params"]["Dense_1"]["kernel"] * 30
    return env, jnet, tree, batch


def test_ppo_loss_and_gradients_match_jax(doorkey_batch):
    """Loss, its metrics and every gradient leaf in float32 within rtol
    1e-5 (atol 1e-5 of the leaf's largest gradient, for entries near 0)."""
    env, jnet, tree, batch = doorkey_batch
    (jloss, jm), jgrads = jax.value_and_grad(j_ppo_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnet.apply,
        jax.tree_util.tree_map(jnp.asarray, batch), 0.2, 0.01, 0.5)
    model = actor_critic_from_flax(tree, torch.float32, CPU)
    tbatch = {k: ({n: torch.from_numpy(a) for n, a in v.items()} if isinstance(v, dict)
                  else torch.from_numpy(v)) for k, v in batch.items()}
    loss, metrics = ppo_loss(model, tbatch, 0.2, 0.01, 0.5)
    loss.backward()
    assert float(jm["approx_kl"]) > 1e-3  # the ratio moved away from 1
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    got = actor_critic_to_flax({n: p.grad for n, p in model.named_parameters()})
    want = to_numpy(jgrads)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want) == 17
    for path, g in flat_got:
        w = flat_want[path]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


class _Leaves(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.leaves = torch.nn.ParameterList(
            torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays)


@pytest.mark.parametrize("grad_norm", [0.3, 3.0])
def test_optimizer_matches_optax(grad_norm):
    """8 steps of the clip + Adam(eps 1e-5) + linear anneal on fixed
    gradients of global norm 0.3 (no clip) and 3.0 (clipped to 0.5), against
    optax, within one ulp of the parameters a step."""
    r = np.random.default_rng(int(grad_norm * 10))
    shapes = [(5, 3), (7,), (2, 3, 4)]
    params = [r.normal(size=s).astype(np.float32) for s in shapes]
    grads = [r.normal(size=s).astype(np.float32) for s in shapes]
    scale = grad_norm / np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
    grads = [(g * scale).astype(np.float32) for g in grads]
    lr, steps = 2.5e-3, 8

    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     optax.adam(optax.linear_schedule(lr, 0.0, steps), eps=1e-5))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for _ in range(steps):
        updates, state = tx.update([jnp.asarray(g) for g in grads], state)
        jp = optax.apply_updates(jp, updates)

    model = _Leaves(params)
    ts = TrainState.create(model, linear_schedule(lr, steps), 0.5, eps=1e-5)
    fixed = [torch.from_numpy(g) for g in grads]
    for _ in range(steps):
        ts.apply_gradients(sum((p * g).sum() for p, g in zip(model.leaves, fixed)))
    assert ts.step == steps
    for p, w, p0 in zip(model.leaves, jp, params):
        assert not np.array_equal(p.detach().numpy(), p0)
        # each step may round a parameter the other way (Adam's fused
        # addcdiv against optax's update-then-add): an ulp of it a step
        ulps = steps * np.spacing(np.abs(p0).max() + 1.0)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=0, atol=ulps)


def test_linear_schedule_matches_optax():
    sched = optax.linear_schedule(2.5e-4, 0.0, 64)
    mine = linear_schedule(2.5e-4, 64)
    for count in (0, 1, 31, 63, 64, 80):
        np.testing.assert_allclose(mine(count), float(sched(count)), rtol=1e-6, atol=1e-12)


# -- the action draw ------------------------------------------------------------------

def test_one_key_categorical_matches_jax_exactly():
    """``jax.random.categorical(key, logits[256, 7])`` draws (256, 7) Gumbel
    noise from the one key: the port's ``categorical_one_key``, on 64 keys."""
    r = np.random.default_rng(9)
    logits = r.normal(size=(64, 256, 7)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(17), 64)
    want = jax.jit(jax.vmap(jax.random.categorical))(keys, jnp.asarray(logits))
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    got = torch.stack([rng.categorical_one_key(tkeys[i], torch.from_numpy(logits[i]))
                       for i in range(64)])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="one key"):
        rng.categorical_one_key(tkeys[:2], torch.from_numpy(logits[0, :2]))


def test_per_env_categorical_is_unchanged():
    """The per-row form the generators use: one key per row, as
    ``jax.vmap(jax.random.categorical)`` draws it."""
    r = np.random.default_rng(10)
    logits = np.where(r.random((512, 9)) < 0.3, -np.inf, 0.0).astype(np.float32)
    logits[:, 0] = 0.0
    keys = jax.random.split(jax.random.PRNGKey(23), 512)
    want = jax.jit(jax.vmap(jax.random.categorical))(keys, jnp.asarray(logits))
    got = rng.categorical(torch.from_numpy(np.asarray(keys).astype(np.int64)),
                          torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- config and stats ---------------------------------------------------------------------

def test_ppo_config_defaults_match_jax():
    want = {f.name: getattr(JPPOConfig(), f.name) for f in dataclasses.fields(JPPOConfig)}
    got = dataclasses.asdict(PPOConfig())
    assert got == want


def test_episode_stats_update_matches_jax():
    r = np.random.default_rng(12)
    js, ts = JEpisodeStats.zeros(16), EpisodeStats.zeros(16, CPU)
    for _ in range(40):
        reward = np.where(r.random(16) < 0.3, r.random(16), 0.0).astype(np.float32)
        done = r.random(16) < 0.25
        js = js.update(jnp.asarray(reward), jnp.asarray(done))
        ts = ts.update(torch.from_numpy(reward), torch.from_numpy(done))
    for f in dataclasses.fields(ts):
        g, w = getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name))
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


# -- one whole PPO update against the JAX package's --------------------------------------

def jax_rollout(trainer, runner):
    """The rollout body of the JAX update (``minigrid_tpu/rl/ppo.py``,
    ``make_env_step`` with ``bootstrap_truncated``), jitted on its own: the
    JAX update keeps its trajectory inside its program."""
    ts = runner[0]

    def env_step(carry, _):
        env_state, obs, key = carry
        key, k_act = jax.random.split(key)
        logits, value = ts.apply_fn(ts.params, obs)
        action = jax.random.categorical(k_act, logits)
        log_prob = jnp.take_along_axis(jax.nn.log_softmax(logits), action[:, None],
                                       axis=-1).squeeze(-1)
        new_obs, new_state, reward, term, trunc, info = trainer.venv._step(env_state, action)
        _, final_value = ts.apply_fn(ts.params, info["final_obs"])
        return (new_state, new_obs, key), {
            "obs": obs, "action": action, "log_prob": log_prob, "value": value,
            "reward": reward, "done": term | trunc, "truncated": trunc & ~term,
            "trunc_value": final_value}

    def run(env_state, obs, key):
        return jax.lax.scan(env_step, (env_state, obs, key), None,
                            length=trainer.config.num_steps)

    return jax.jit(run)(runner[1], runner[2], runner[3])


@pytest.fixture(scope="module")
def ppo_update_pair():
    """One update on both sides from the JAX init's parameters and one key:
    (JAX rollout, JAX runner and metrics after the update, port trajectory,
    port runner and metrics after the update, parameters before)."""
    jenv = minigrid_tpu.make("MiniGrid-DoorKey-5x5-v0", max_steps=MAX_STEPS)
    jtr = JPPO(jenv, jenv.default_params, JPPOConfig(**SMALL),
               network=JActorCritic(num_actions=jenv.num_actions, dtype=jnp.float32))
    jrunner = jtr.init(jax.random.PRNGKey(0))
    tree = to_numpy(jrunner[0].params)

    env = mgt.make("MiniGrid-DoorKey-5x5-v0", max_steps=MAX_STEPS)
    net = actor_critic_from_flax(tree, torch.float32, CPU)
    net.init = lambda key, obs: net  # start from the JAX init's parameters
    trainer = PPO(env, None, PPOConfig(**SMALL), network=net, device=CPU)
    runner = trainer.init(rng.PRNGKey(0, CPU))
    assert runner.train_state.model is net

    (_, _, jkey), jtraj = jax_rollout(jtr, jrunner)
    _, traj = trainer.rollout(runner)
    jrunner2, jmetrics = jtr.update(jrunner)
    runner2, metrics = trainer.update(runner)
    return {"jtraj": jtraj, "jrunner": jrunner2, "jmetrics": jmetrics, "traj": traj,
            "runner": runner2, "metrics": metrics, "tree": tree}


def test_ppo_rollout_matches_jax(ppo_update_pair):
    """The trajectory: observations, actions, rewards (float32 bits), dones
    and truncations equal; values, log-probs and V(final obs) within 1e-5."""
    jt, t = ppo_update_pair["jtraj"], ppo_update_pair["traj"]
    for k in ("image", "direction", "mission"):
        np.testing.assert_array_equal(t["obs"][k].numpy(), np.asarray(jt["obs"][k]), err_msg=k)
    for k in ("action", "done", "truncated"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(jt[k]), err_msg=k)
    np.testing.assert_array_equal(t["reward"].numpy().view(np.int32),
                                  np.asarray(jt["reward"]).view(np.int32))
    assert int(t["truncated"].sum()) > 0  # the 10-step limit: the bootstrap is live
    for k in ("value", "log_prob", "trunc_value"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(jt[k]), rtol=0,
                                   atol=VALUE_ATOL, err_msg=k)


def test_ppo_update_matches_jax(ppo_update_pair):
    """After the update: env state, observation, key and episode stats
    bitwise; 4 optimizer steps taken; every metric within rtol 1e-4; every
    parameter within ``PARAM_ATOL`` of JAX's and each leaf within
    ``PARAM_REL_L2`` of its move."""
    p = ppo_update_pair
    jr, r = p["jrunner"], p["runner"]
    assert_state_equal(r.env_state, jr[1], "env_state ")
    for k in ("image", "direction", "mission"):
        np.testing.assert_array_equal(r.obs[k].numpy(), np.asarray(jr[2][k]), err_msg=k)
    np.testing.assert_array_equal(r.key.numpy(), np.asarray(jr[3]).astype(np.int64))
    for f in dataclasses.fields(r.stats):
        np.testing.assert_array_equal(getattr(r.stats, f.name).numpy(),
                                      np.asarray(getattr(jr[4], f.name)), err_msg=f.name)
    assert r.train_state.step == int(jr[0].step) == 4
    assert set(p["metrics"]) == set(p["jmetrics"])
    for k, v in p["metrics"].items():
        np.testing.assert_allclose(float(v), float(p["jmetrics"][k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    got = actor_critic_to_flax(r.train_state.model)
    want = to_numpy(jr[0].params)
    assert max_leaf_diff(want, p["tree"]) > 1e-4  # the update moved the parameters
    assert max_leaf_diff(got, want) < PARAM_ATOL
    init = dict(jax.tree_util.tree_leaves_with_path(p["tree"]))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = dict(jax.tree_util.tree_leaves_with_path(got))[path]
        moved = np.linalg.norm((w - init[path]).astype(np.float64))
        assert np.linalg.norm((g - w).astype(np.float64)) < PARAM_REL_L2 * moved, path


# -- port-only checks, as tests/test_rl.py makes them -------------------------------------

def _moved(before: dict, model) -> bool:
    return any(not torch.equal(before[n], p) for n, p in model.named_parameters())


def test_ppo_pooled_refill_period():
    """A pooled env with the bulk refill every 4 steps: the update runs,
    the parameters move, the metrics are finite and the ring's tick is T."""
    env = mgt.make("BabyAI-GoToRedBallGrey-v0")
    cfg = PPOConfig(num_envs=8, num_steps=16, num_updates=1, num_minibatches=2,
                    update_epochs=1, refill_period=4)
    trainer = PPO(env, None, cfg, device=CPU)
    trainer.venv = VectorEnv(env, cfg.num_envs, env.default_params, final_obs=True,
                             reset_strategy="pooled", pool_refill=2, device=CPU)
    runner = trainer.init(rng.PRNGKey(0, CPU))
    before = {n: p.detach().clone() for n, p in runner.train_state.model.named_parameters()}
    runner, metrics = trainer.update(runner)
    assert _moved(before, runner.train_state.model)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert int(runner.env_state.tick) == cfg.num_steps
    bad = PPO(env, None, dataclasses.replace(cfg, refill_period=3), device=CPU)
    bad.venv = trainer.venv
    with pytest.raises(ValueError, match="multiple"):
        bad.rollout(runner)


def test_ppo_stats_accumulate_episodes():
    """Empty-5x5 truncates at 100 steps: 8 envs x 64 steps end episodes,
    and the next update starts its aggregates from zero."""
    env = mgt.make("MiniGrid-Empty-5x5-v0")
    cfg = PPOConfig(num_envs=8, num_steps=64, num_updates=1, num_minibatches=2,
                    update_epochs=1)
    fn, runner = train_step_fn(env, env.default_params, cfg, device=CPU)
    runner, metrics = fn(runner)
    assert int(metrics["episodes"]) > 0
    assert float(metrics["mean_length"]) > 0
    assert 0.0 <= float(metrics["success_rate"]) <= 1.0
    assert int(runner.stats.episode_count) == 0
    assert runner.train_state.step == 2
