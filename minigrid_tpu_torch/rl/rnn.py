"""Recurrent PPO (LSTM actor-critic) for memory tasks.

Counterpart of ``minigrid_tpu/rl/rnn.py``: an LSTM over the shared
:class:`~minigrid_tpu_torch.rl.networks.ObsEncoder`, its carry cleared on
episode boundaries, and a PPO update that re-runs the network over the
time-major sequences of each minibatch, whose minibatches partition the env
axis so that the carry chains stay whole.

The cell is flax's ``OptimizedLSTMCell``, written out: the input kernels
``ii/if/ig/io`` have no bias and the hidden kernels ``hi/hf/hg/ho`` carry the
biases; ``i, f, g, o = (h W_h + b_h) + x W_i`` split in four, sigmoid on i, f
and o, tanh on g, ``c' = f c + i g``, ``h' = o tanh(c')``, all in ``dtype``
with the carry ``(c, h)`` in that order and dtype.  ``nn.LSTMCell`` returns
``(h, c)`` and runs a fused kernel of its own rounding on a card.  As in the
JAX package, a truncated step is terminal here (zero bootstrap).
"""

from __future__ import annotations

import copy
from typing import Any, NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.state import EnvParams, resolve_device
from minigrid_tpu_torch.core.step import NUM_ACTIONS
from minigrid_tpu_torch.parallel.vector import VectorEnv
from minigrid_tpu_torch.rl.networks import Dense, ObsEncoder, key_generator, lecun_normal_, orthogonal_
from minigrid_tpu_torch.rl.ppo import (
    PPO,
    EpisodeStats,
    PPOConfig,
    TrainState,
    compute_gae,
    draw_actions,
    map_batch,
    mean_metrics,
    ppo_objective,
    ppo_train_state,
    stack_steps,
)


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell(features)``: ``weight_ih`` ``[4H, in]`` (the
    four input kernels, transposed and stacked i, f, g, o), ``weight_hh``
    ``[4H, H]`` and ``bias_hh`` ``[4H]`` likewise."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        self.weight_ih = nn.Parameter(torch.empty(4 * features, in_features))
        self.weight_hh = nn.Parameter(torch.empty(4 * features, features))
        self.bias_hh = nn.Parameter(torch.zeros(4 * features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """flax's per-gate init: each input kernel ``lecun_normal``, each
        hidden kernel ``orthogonal()``, biases zero; drawn in flax's order
        (ii, hi, if, hf, ...)."""
        h = self.features
        with torch.no_grad():
            for g in range(4):
                lecun_normal_(self.weight_ih[g * h:(g + 1) * h], self.weight_ih.shape[1], gen)
                orthogonal_(self.weight_hh[g * h:(g + 1) * h], 1.0, gen)
            self.bias_hh.zero_()

    def forward(self, carry: tuple, x: torch.Tensor, dtype: torch.dtype):
        c, h = carry
        gates = ((F.linear(h.to(dtype), self.weight_hh.to(dtype)) + self.bias_hh.to(dtype))
                 + F.linear(x.to(dtype), self.weight_ih.to(dtype)))
        i, f, g, o = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class RecurrentActorCritic(nn.Module):
    """ObsEncoder -> LSTM -> policy/value heads, with a done-gated carry."""

    def __init__(self, num_actions: int = NUM_ACTIONS, hidden: int = 256,
                 embed_dim: int = 16, conv_features: Sequence[int] = (128, 128),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_actions = num_actions
        self.hidden = hidden
        self.dtype = dtype
        self.encoder = ObsEncoder(embed_dim, conv_features, hidden, dtype)

    def build(self, view_size: int) -> "RecurrentActorCritic":
        """Create the layers (uninitialised, on the CPU) for ``view_size``."""
        self.encoder.build(view_size)
        self.cell = LSTMCell(self.hidden, self.hidden)
        self.policy = Dense(self.hidden, self.num_actions)
        self.value = Dense(self.hidden, 1)
        return self

    def init(self, key: torch.Tensor, obs: dict) -> "RecurrentActorCritic":
        """Build for ``obs``'s view size and draw every parameter from a
        generator seeded from ``key`` (on the CPU), then move to ``obs``'s
        device.  Returns ``self``."""
        self.build(obs["image"].shape[-2])
        gen = key_generator(key)
        self.encoder.reset_parameters(gen)
        self.cell.reset_parameters(gen)
        self.policy.reset_parameters(gen, gain=0.01)
        self.value.reset_parameters(gen, gain=1.0)
        return self.to(obs["image"].device)

    def initialize_carry(self, batch: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Zero ``(c, h)``, ``[batch, hidden]`` each, in ``dtype``."""
        shape = (batch, self.hidden)
        dev = resolve_device(device)
        return (torch.zeros(shape, dtype=self.dtype, device=dev),
                torch.zeros(shape, dtype=self.dtype, device=dev))

    def _heads(self, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        y = y.float()
        return self.policy(y, torch.float32), self.value(y, torch.float32).squeeze(-1)

    def _cell(self, carry: tuple, x: torch.Tensor, done: torch.Tensor):
        keep = ~done[:, None]
        carry = tuple(torch.where(keep, c, torch.zeros_like(c)) for c in carry)
        return self.cell(carry, x, self.dtype)

    def forward(self, carry: tuple, obs: dict, done: torch.Tensor):
        """One time step over a ``[B, ...]`` batch.  ``done`` marks envs whose
        episode ended BEFORE this obs (the auto-reset already swapped in the
        new episode): their memory is cleared.  Returns (carry', (logits
        float32[B, A], value float32[B]))."""
        carry, y = self._cell(carry, self.encoder(obs), done)
        return carry, self._heads(y)

    def unroll(self, carry: tuple, obs: dict, done: torch.Tensor):
        """:meth:`forward` over a time-major sequence: ``obs`` leaves and
        ``done`` ``[T, B, ...]``.  The encoder, which reads no carry, runs
        once over all T*B observations.  Returns (carry', (logits[T, B, A],
        values[T, B]))."""
        t, b = done.shape
        x = self.encoder(map_batch(lambda v: v.reshape((t * b,) + v.shape[2:]), obs))
        x = x.reshape(t, b, -1)
        ys = []
        for i in range(t):
            carry, y = self._cell(carry, x[i], done[i])
            ys.append(y)
        return carry, self._heads(torch.stack(ys))


class RecurrentRunner(NamedTuple):
    """JAX's 7-tuple: the train state, env state, observation, LSTM carry,
    the previous step's done flags, the key and the episode stats."""

    train_state: TrainState
    env_state: Any
    obs: dict
    carry: tuple
    prev_done: torch.Tensor
    key: torch.Tensor
    stats: EpisodeStats


def recurrent_loss(model: RecurrentActorCritic, mb: dict, mb_carry: tuple,
                   cfg: PPOConfig) -> tuple[torch.Tensor, dict]:
    """The clipped PPO objective over a ``[T, mb]`` minibatch, the network
    re-run from the rollout's initial carry; its metrics are the JAX
    package's (no ``approx_kl``)."""
    _, (logits, values) = model.unroll(mb_carry, mb["obs"], mb["prev_done"])
    loss, metrics = ppo_objective(logits, values, mb, cfg.clip_eps, cfg.ent_coef,
                                  cfg.vf_coef)
    del metrics["approx_kl"]
    return loss, metrics


class RecurrentPPO:
    """PPO with an LSTM policy.  API as :class:`minigrid_tpu_torch.rl.PPO`;
    the runner also carries the LSTM carry and the previous done flags."""

    def __init__(self, env: Env, env_params: EnvParams | None = None,
                 config: PPOConfig | None = None,
                 network: RecurrentActorCritic | None = None, device=None):
        self.env = env
        self.env_params = env_params or env.default_params
        self.config = config or PPOConfig()
        if self.config.num_envs % self.config.num_minibatches:
            raise ValueError("recurrent minibatches partition the env axis: "
                             f"num_minibatches={self.config.num_minibatches} must divide "
                             f"num_envs={self.config.num_envs}")
        self.device = resolve_device(device)
        self.network = network or RecurrentActorCritic(num_actions=env.num_actions)
        self.venv = VectorEnv(env, self.config.num_envs, self.env_params, device=self.device)

    def init(self, key: torch.Tensor) -> RecurrentRunner:
        cfg = self.config
        key, k_net, k_env = rng.split(key.to(self.device), 3).unbind(0)
        obs, env_state = self.venv.reset(k_env)
        model = copy.deepcopy(self.network).init(k_net, {k: v[:1] for k, v in obs.items()})
        return RecurrentRunner(
            ppo_train_state(model, cfg), env_state, obs,
            model.initialize_carry(cfg.num_envs, self.device),
            torch.zeros((cfg.num_envs,), dtype=torch.bool, device=self.device), key,
            EpisodeStats.zeros(cfg.num_envs, self.device))

    @torch.no_grad()
    def rollout(self, runner: RecurrentRunner) -> tuple[RecurrentRunner, dict]:
        """T steps; the trajectory has ``obs``, ``action``, ``log_prob``,
        ``value``, ``reward``, ``done`` and ``prev_done``, each ``[T, B, ...]``."""
        model = runner.train_state.model
        env_state, obs, carry = runner.env_state, runner.obs, runner.carry
        prev_done, key, stats = runner.prev_done, runner.key, runner.stats
        steps = []
        for _ in range(self.config.num_steps):
            new_carry, (logits, value) = model(carry, obs, prev_done)
            key, action, log_prob = draw_actions(key, logits)
            new_obs, env_state, reward, term, trunc, _ = self.venv.step(env_state, action)
            done = term | trunc
            stats = stats.update(reward, done)
            steps.append({"obs": obs, "action": action, "log_prob": log_prob,
                          "value": value, "reward": reward, "done": done,
                          "prev_done": prev_done})
            obs, carry, prev_done = new_obs, new_carry, done
        return runner._replace(env_state=env_state, obs=obs, carry=carry,
                               prev_done=prev_done, key=key, stats=stats), stack_steps(steps)

    @torch.no_grad()
    def advantages(self, runner: RecurrentRunner, traj: dict) -> dict:
        """GAE with every done terminal (the JAX package's zero bootstrap on
        truncation); returns the ``[T, B, ...]`` batch."""
        cfg = self.config
        _, (_, last_value) = runner.train_state.model(runner.carry, runner.obs,
                                                      runner.prev_done)
        advantages, targets = compute_gae(traj["reward"], traj["value"], traj["done"],
                                          last_value, cfg.gamma, cfg.gae_lambda)
        return {**traj, "advantage": advantages, "target": targets}

    def optimize(self, runner: RecurrentRunner, batch: dict,
                 initial_carry: tuple) -> tuple[RecurrentRunner, dict]:
        """Epochs of env-axis minibatches, each re-run from ``initial_carry``
        (the carry at the rollout's start)."""
        cfg, ts = self.config, runner.train_state
        env_mb = cfg.num_envs // cfg.num_minibatches
        key, per_step = runner.key, []
        for _ in range(cfg.update_epochs):
            key, k_perm = rng.split(key).unbind(0)
            perm = rng.permutation(k_perm, cfg.num_envs).long()
            for i in range(cfg.num_minibatches):
                idx = perm[i * env_mb:(i + 1) * env_mb]
                mb = map_batch(lambda x: x.index_select(1, idx), batch)
                mb_carry = tuple(c.index_select(0, idx) for c in initial_carry)
                loss, metrics = recurrent_loss(ts.model, mb, mb_carry, cfg)
                ts.apply_gradients(loss)
                per_step.append(metrics)
        episodes, stats = runner.stats.summary()
        return (runner._replace(key=key, stats=stats),
                {**mean_metrics(per_step), **episodes})

    def update(self, runner: RecurrentRunner) -> tuple[RecurrentRunner, dict]:
        initial_carry = runner.carry
        runner, traj = self.rollout(runner)
        return self.optimize(runner, self.advantages(runner, traj), initial_carry)

    train = PPO.train  # ``num_updates`` updates; (runner, stacked metrics)
