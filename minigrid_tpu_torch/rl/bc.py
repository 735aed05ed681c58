"""Behavior cloning on oracle demonstrations.

Counterpart of ``minigrid_tpu/rl/bc.py``: a cross-entropy trainer over the
same ``ActorCritic`` network PPO uses, fed from demonstration corpora in the
JAX package's host format (``minigrid_tpu/tools/generate_demos.py``: tuples
of mission, observation dicts, actions, ...)::

    ds = pack_bc_dataset(demos)
    model, metrics = bc_train(env, ds, BCConfig(), rng.PRNGKey(0))

The minibatch indices are ``rng.randint`` draws from ``split(key,
num_steps)``, so they are the JAX package's for the same key; the optimizer
is ``optax.adam(lr)`` (eps 1e-8) as ``torch.optim.Adam``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.rl.networks import ActorCritic
from minigrid_tpu_torch.rl.ppo import TrainState, map_batch


@dataclass(frozen=True)
class BCConfig:
    batch_size: int = 256
    num_steps: int = 500
    lr: float = 1e-3


def pack_bc_dataset(demos, device=None) -> dict:
    """Flatten demos ``(mission, obs dicts, actions, ...)`` into one set of
    (obs, action) pairs on ``device``: ``obs`` a dict of ``[N, ...]``
    tensors in the demos' dtypes, ``action`` int32[N]."""
    dev = resolve_device(device)
    images, directions, missions, actions = [], [], [], []
    for _, obss, acts, *_ in demos:
        for o, a in zip(obss, acts):
            images.append(np.asarray(o["image"]))
            directions.append(np.asarray(o["direction"]))
            missions.append(np.asarray(o["mission"]))
            actions.append(a)

    def tensor(arrays):
        return torch.from_numpy(np.stack(arrays)).to(dev)

    return {
        "obs": {"image": tensor(images), "direction": tensor(directions),
                "mission": tensor(missions)},
        "action": torch.from_numpy(np.asarray(actions, np.int32)).to(dev),
    }


def bc_loss(model, obs: dict, action: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cross-entropy of the dataset's actions, greedy accuracy)."""
    logits, _ = model(obs)
    ce = -F.log_softmax(logits, dim=-1).gather(-1, action.long()[:, None]).mean()
    acc = (torch.argmax(logits, dim=-1) == action).float().mean()
    return ce, acc


def bc_train(env: Env, dataset: dict, config: BCConfig | None = None,
             key: torch.Tensor | None = None, network: ActorCritic | None = None,
             device=None):
    """Train a policy to imitate the dataset; returns (model, metrics) with
    per-step ``loss`` and ``accuracy`` tensors ``[num_steps]``, all on
    ``device`` (CUDA unless named; the dataset is moved there).  ``key``
    defaults to ``PRNGKey(0)``; ``network`` (an unbuilt ``ActorCritic``) is
    copied, built and initialised from it."""
    config = config or BCConfig()
    dev = resolve_device(device)
    dataset = map_batch(lambda x: x.to(dev), dataset)
    key = rng.PRNGKey(0, dev) if key is None else key.to(dev)
    net = network or ActorCritic(num_actions=env.num_actions)

    n = int(dataset["action"].shape[0])
    if n == 0:
        raise ValueError("empty demo dataset")
    k_init, k_train = rng.split(key).unbind(0)
    sample = {k: v[:1] for k, v in dataset["obs"].items()}
    model = copy.deepcopy(net).init(k_init, sample)
    ts = TrainState.create(model, config.lr)

    losses, accs = [], []
    for k in rng.split(k_train, config.num_steps):
        idx = rng.randint(k, (config.batch_size,), 0, n).long()
        loss, acc = bc_loss(model, map_batch(lambda x: x[idx], dataset["obs"]),
                            dataset["action"][idx])
        ts.apply_gradients(loss)
        losses.append(loss.detach())
        accs.append(acc)
    return model, {"loss": torch.stack(losses), "accuracy": torch.stack(accs)}


@torch.no_grad()
def evaluate_policy(env: Env, model, key: torch.Tensor, num_episodes: int = 32,
                    max_steps: int | None = None, device=None) -> dict:
    """Greedy single-env episodes (a batch of one through the batch-first
    ``Env``; episode e resets from the e-th ``key, k = split(key)``);
    returns success rate and mean return as host floats.  ``model`` is a
    built network on ``device``."""
    dev = resolve_device(device)
    params = env.default_params
    limit = max_steps or params.max_steps
    key = key.to(dev)
    successes, returns = 0, 0.0
    for _ in range(num_episodes):
        key, k = rng.split(key).unbind(0)
        obs, state = env.reset(k[None], params, dev)
        total = 0.0
        for _ in range(limit):
            logits, _ = model(obs)
            action = torch.argmax(logits, dim=-1).to(torch.int32)
            obs, state, r, te, tr, _ = env.step(state, action, params)
            total += float(r[0])
            if bool(te[0]) or bool(tr[0]):
                break
        returns += total
        successes += total > 0
    return {"success_rate": successes / num_episodes,
            "mean_return": returns / num_episodes}
