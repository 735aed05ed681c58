"""The port's recurrent PPO and behavior cloning against the JAX package's
(``minigrid_tpu/rl/rnn.py``, ``minigrid_tpu/rl/bc.py``), and the training
entry points.

* one ``RecurrentPPO`` update on MemoryS7 at a 6-step limit (B=8, T=16, 2
  epochs x 2 minibatches, float32 network), both sides from the JAX init's
  parameters and one key: the trajectory (against a jitted copy of the JAX
  update's rollout body) and the runner, metrics and parameters after it;
* ``bc_train``'s 20 per-step losses against JAX's from the same parameters
  and key on a numpy dataset (the ``randint`` minibatch indices bitwise),
  and its learning check on oracle demos;
* ``pack_bc_dataset`` against JAX's, ``evaluate_policy`` against JAX's;
* ``tools/train_ppo.py`` and ``tools/train_rnn_ppo.py`` on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu
from minigrid_tpu.rl import ActorCritic as JActorCritic
from minigrid_tpu.rl import PPOConfig as JPPOConfig
from minigrid_tpu.rl import bc as jbc
from minigrid_tpu.rl.rnn import RecurrentActorCritic as JRecurrent
from minigrid_tpu.rl.rnn import RecurrentPPO as JRecurrentPPO
from minigrid_tpu.tools.generate_demos import collect

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.rl import (
    ActorCritic,
    BCConfig,
    PPOConfig,
    RecurrentActorCritic,
    RecurrentPPO,
    bc_train,
    evaluate_policy,
    pack_bc_dataset,
)
from minigrid_tpu_torch.tools import train_ppo, train_rnn_ppo
from minigrid_tpu_torch.utils.convert import actor_critic_from_flax, recurrent_from_flax, recurrent_to_flax

from tests.test_torch_bridge import assert_state_equal
from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)
from tests.test_torch_rl_ppo import PARAM_ATOL, PARAM_REL_L2, VALUE_ATOL, max_leaf_diff, to_numpy

CPU = torch.device("cpu")
# MemoryS7 at a 6-step limit: episodes end, so the done-gated carry clears
MAX_STEPS = 6
SMALL = dict(num_envs=8, num_steps=16, num_updates=2, num_minibatches=2, update_epochs=2)


# -- one recurrent update against the JAX package's ---------------------------------------

def jax_recurrent_rollout(trainer, runner):
    """The rollout body of the JAX recurrent update (``rnn.py``'s
    ``env_step``), jitted on its own."""
    ts = runner[0]

    def env_step(c, _):
        env_state, obs, carry, prev_done, key = c
        key, k_act = jax.random.split(key)
        new_carry, (logits, value) = ts.apply_fn(ts.params, carry, obs, prev_done)
        action = jax.random.categorical(k_act, logits)
        log_prob = jnp.take_along_axis(jax.nn.log_softmax(logits), action[:, None],
                                       axis=-1).squeeze(-1)
        new_obs, new_state, reward, term, trunc, _ = trainer.venv._step(env_state, action)
        done = term | trunc
        return (new_state, new_obs, new_carry, done, key), {
            "obs": obs, "action": action, "log_prob": log_prob, "value": value,
            "reward": reward, "done": done, "prev_done": prev_done}

    def run(*carry):
        return jax.lax.scan(env_step, carry, None, length=trainer.config.num_steps)

    return jax.jit(run)(runner[1], runner[2], runner[3], runner[4], runner[5])


@pytest.fixture(scope="module")
def recurrent_pair():
    jenv = minigrid_tpu.make("MiniGrid-MemoryS7-v0", max_steps=MAX_STEPS)
    jtr = JRecurrentPPO(jenv, jenv.default_params, JPPOConfig(**SMALL),
                        network=JRecurrent(num_actions=jenv.num_actions, dtype=jnp.float32))
    jrunner = jtr.init(jax.random.PRNGKey(0))
    tree = to_numpy(jrunner[0].params)

    env = mgt.make("MiniGrid-MemoryS7-v0", max_steps=MAX_STEPS)
    net = recurrent_from_flax(tree, torch.float32, CPU)
    net.init = lambda key, obs: net  # start from the JAX init's parameters
    trainer = RecurrentPPO(env, None, PPOConfig(**SMALL), network=net, device=CPU)
    runner = trainer.init(rng.PRNGKey(0, CPU))
    assert runner.carry[0].dtype == torch.float32

    _, jtraj = jax_recurrent_rollout(jtr, jrunner)
    _, traj = trainer.rollout(runner)
    jrunner2, jmetrics = jtr.update(jrunner)
    runner2, metrics = trainer.update(runner)
    return {"jtraj": jtraj, "jrunner": jrunner2, "jmetrics": jmetrics, "traj": traj,
            "runner": runner2, "metrics": metrics, "tree": tree}


def test_recurrent_rollout_matches_jax(recurrent_pair):
    """Observations, actions, rewards (float32 bits), dones and the previous
    dones equal; values and log-probs within ``VALUE_ATOL``."""
    jt, t = recurrent_pair["jtraj"], recurrent_pair["traj"]
    for k in ("image", "direction", "mission"):
        np.testing.assert_array_equal(t["obs"][k].numpy(), np.asarray(jt["obs"][k]), err_msg=k)
    for k in ("action", "done", "prev_done"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(jt[k]), err_msg=k)
    np.testing.assert_array_equal(t["reward"].numpy().view(np.int32),
                                  np.asarray(jt["reward"]).view(np.int32))
    assert int(t["prev_done"].sum()) > 0  # the carry was cleared mid-rollout
    for k in ("value", "log_prob"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(jt[k]), rtol=0,
                                   atol=VALUE_ATOL, err_msg=k)


def test_recurrent_update_matches_jax(recurrent_pair):
    """After the update: env state, observation, carry (within
    ``VALUE_ATOL``), done flags, key and stats; 4 optimizer steps; metrics
    within rtol 1e-4; parameters as in the feed-forward update's check."""
    p = recurrent_pair
    jr, r = p["jrunner"], p["runner"]
    assert_state_equal(r.env_state, jr[1], "env_state ")
    for k in ("image", "direction", "mission"):
        np.testing.assert_array_equal(r.obs[k].numpy(), np.asarray(jr[2][k]), err_msg=k)
    for got, want in zip(r.carry, jr[3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=VALUE_ATOL)
    np.testing.assert_array_equal(r.prev_done.numpy(), np.asarray(jr[4]))
    np.testing.assert_array_equal(r.key.numpy(), np.asarray(jr[5]).astype(np.int64))
    for f in dataclasses.fields(r.stats):
        np.testing.assert_array_equal(getattr(r.stats, f.name).numpy(),
                                      np.asarray(getattr(jr[6], f.name)), err_msg=f.name)
    assert r.train_state.step == int(jr[0].step) == 4
    assert set(p["metrics"]) == set(p["jmetrics"])
    for k, v in p["metrics"].items():
        np.testing.assert_allclose(float(v), float(p["jmetrics"][k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert int(p["metrics"]["episodes"]) > 0
    got, want = recurrent_to_flax(r.train_state.model), to_numpy(jr[0].params)
    assert max_leaf_diff(want, p["tree"]) > 1e-4
    assert max_leaf_diff(got, want) < PARAM_ATOL
    init = dict(jax.tree_util.tree_leaves_with_path(p["tree"]))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        moved = np.linalg.norm((w - init[path]).astype(np.float64))
        assert np.linalg.norm((flat_got[path] - w).astype(np.float64)) < PARAM_REL_L2 * moved


def test_recurrent_minibatches_partition_envs():
    env = mgt.make("MiniGrid-MemoryS7-v0")
    with pytest.raises(ValueError, match="partition the env axis"):
        RecurrentPPO(env, None, PPOConfig(num_envs=6, num_minibatches=4), device=CPU)


# -- behavior cloning --------------------------------------------------------------------

def numpy_dataset(n: int, seed: int) -> dict:
    """(obs, action) pairs drawn with numpy: DoorKey-sized 7x7 views."""
    r = np.random.default_rng(seed)
    image = np.stack([r.integers(0, 11, (n, 7, 7)), r.integers(0, 6, (n, 7, 7)),
                      r.integers(0, 3, (n, 7, 7))], axis=-1).astype(np.uint8)
    return {"obs": {"image": image, "direction": r.integers(0, 4, n).astype(np.int32),
                    "mission": r.integers(0, 3, (n, 4)).astype(np.int32)},
            "action": (image[:, 3, 5, 0] % 7).astype(np.int32)}  # learnable labels


def test_bc_train_losses_match_jax():
    """20 steps from the JAX init's parameters and one key: the minibatch
    indices bitwise, each step's loss within rtol 1e-4 (the parameters drift
    apart by Adam's float32 rounding), accuracy equal."""
    data = numpy_dataset(96, 0)
    cfg = BCConfig(batch_size=16, num_steps=20)
    key = jax.random.PRNGKey(3)
    jenv = minigrid_tpu.make("MiniGrid-DoorKey-8x8-v0")
    jnet = JActorCritic(num_actions=jenv.num_actions, dtype=jnp.float32)
    jdata = jax.tree_util.tree_map(jnp.asarray, data)
    _, jm = jbc.bc_train(jenv, jdata, jbc.BCConfig(batch_size=16, num_steps=20), key,
                         network=jnet)
    # the parameters JAX's bc_train starts from: init on its first subkey
    k_init, k_train = jax.random.split(key)
    tree = to_numpy(jnet.init(k_init, jax.tree_util.tree_map(lambda x: x[:1], jdata["obs"])))

    want_idx = np.stack([np.asarray(jax.random.randint(k, (16,), 0, 96))
                         for k in jax.random.split(k_train, 20)])
    tk = torch.from_numpy(np.asarray(k_train).astype(np.int64))
    got_idx = torch.stack([rng.randint(k, (16,), 0, 96) for k in rng.split(tk, 20)])
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)

    net = actor_critic_from_flax(tree, torch.float32, CPU)
    net.init = lambda key, obs: net
    dataset = {"obs": {k: torch.from_numpy(v) for k, v in data["obs"].items()},
               "action": torch.from_numpy(data["action"])}
    model, m = bc_train(mgt.make("MiniGrid-DoorKey-8x8-v0"), dataset, cfg,
                        torch.from_numpy(np.asarray(key).astype(np.int64)), network=net,
                        device=CPU)
    assert model is net
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-4)
    np.testing.assert_array_equal(m["accuracy"].numpy(), np.asarray(jm["accuracy"]))
    assert float(m["loss"][-1]) < float(m["loss"][0])


@pytest.fixture(scope="module")
def demos():
    return collect("ContrastiveTrajectoryDataset-v0", 20, seed=0)


def test_pack_bc_dataset_matches_jax(demos):
    want = jbc.pack_bc_dataset(demos)
    got = pack_bc_dataset(demos, device=CPU)
    for k in ("image", "direction", "mission"):
        g, w = got["obs"][k].numpy(), np.asarray(want["obs"][k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    np.testing.assert_array_equal(got["action"].numpy(), np.asarray(want["action"]))
    assert got["action"].dtype == torch.int32


def test_bc_train_on_oracle_demos(demos):
    """BC over oracle demos, at tests/test_rl.py's size: the loss falls and
    the accuracy rises well above the 1/8 of chance."""
    assert len(demos) >= 10
    ds = pack_bc_dataset(demos, device=CPU)
    env = mgt.make("ContrastiveTrajectoryDataset-v0")
    _, m = bc_train(env, ds, BCConfig(batch_size=32, num_steps=60), rng.PRNGKey(0, CPU),
                    device=CPU)
    assert float(m["loss"][-1]) < float(m["loss"][0])
    assert float(m["accuracy"][-10:].mean()) > 0.4


def test_evaluate_policy_matches_jax():
    """Greedy episodes of Empty-Random-5x5 (a 16-step cap) under a float32
    network whose policy head prefers 'forward': JAX's success rate and mean
    return, and some episodes succeed."""
    jenv = minigrid_tpu.make("MiniGrid-Empty-Random-5x5-v0")
    jnet = JActorCritic(num_actions=jenv.num_actions, dtype=jnp.float32)
    obs, _ = jax.vmap(lambda k: jenv.reset(k, jenv.default_params))(
        jax.random.split(jax.random.PRNGKey(1), 2))
    tree = to_numpy(jnet.init(jax.random.PRNGKey(2), obs))
    tree["params"]["Dense_1"]["kernel"] = tree["params"]["Dense_1"]["kernel"] * 100
    bias = tree["params"]["Dense_1"]["bias"].copy()
    bias[2] = 0.5  # forward, unless the view says otherwise
    tree["params"]["Dense_1"]["bias"] = bias
    key = jax.random.PRNGKey(5)
    want = jbc.evaluate_policy(jenv, jax.tree_util.tree_map(jnp.asarray, tree), key,
                               num_episodes=6, network=jnet, max_steps=16)
    model = actor_critic_from_flax(tree, torch.float32, CPU)
    got = evaluate_policy(mgt.make("MiniGrid-Empty-Random-5x5-v0"), model,
                          torch.from_numpy(np.asarray(key).astype(np.int64)),
                          num_episodes=6, max_steps=16, device=CPU)
    assert got == want
    assert got["success_rate"] > 0


# -- the entry points -------------------------------------------------------------------

@pytest.mark.parametrize("tool", ["train_ppo", "train_rnn_ppo"])
def test_training_entry_points_run_on_the_cpu(tool, capsys):
    main = {"train_ppo": train_ppo.main, "train_rnn_ppo": train_rnn_ppo.main}[tool]
    main(["--env", "MiniGrid-Empty-5x5-v0", "--num-envs", "8", "--num-steps", "8",
          "--num-updates", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("update    1") and out[1].startswith("update    2")
    assert out[-1].startswith("128 env-steps in ")
    assert "through the full PPO loop" in out[-1]


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card the default device raises (it never runs on the CPU
    unasked), for every learner entry point."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = mgt.make("MiniGrid-Empty-5x5-v0")
    for make in (lambda: mgt.rl.PPO(env, None, PPOConfig(num_envs=8)),
                 lambda: RecurrentPPO(env, None, PPOConfig(num_envs=8)),
                 lambda: pack_bc_dataset([]),
                 lambda: bc_train(env, {"action": torch.zeros(1)}),
                 lambda: evaluate_policy(env, ActorCritic(), rng.PRNGKey(0, CPU))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RecurrentActorCritic().initialize_carry(2)
