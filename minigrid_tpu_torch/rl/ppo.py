"""PPO actor-learner on the port's vectorized env.

Counterpart of ``minigrid_tpu/rl/ppo.py``: PPO with GAE,
where one update is a rollout of T steps of B envs, advantage estimation (a
reverse loop over T), and minibatched clipped-objective SGD over epochs x
minibatches.  The JAX package runs the update as one jitted program; here it
is eager, and its three phases are methods (:meth:`PPO.rollout`,
:meth:`PPO.advantages`, :meth:`PPO.optimize`) so that a caller can time
them.  Nothing is read back to the host inside an update beyond what the
env's reset strategy reads; the metrics stay tensors on the device.

The key stream is JAX's: ``init`` splits its key in three (key, network,
env reset); each rollout step splits off the action key and draws the
actions from it with one batched Gumbel-max (``rng.categorical_one_key``);
each epoch splits off the key of its ``rng.permutation`` of the T*B
transitions.  With the same parameters, the same key and a float32 network
the trajectory is the JAX package's, action for action.

The optimizer is ``optax.chain(clip_by_global_norm(max_grad_norm),
adam(lr, eps=1e-5))`` written out: the global norm is the square root of the
sum of every gradient's squares, and the gradients are rescaled as optax
does (``g / norm * max_norm``) only when the norm reaches ``max_grad_norm``
(``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and always
multiplies); ``torch.optim.Adam`` takes the step, with the learning rate of
step k set before it (optax's ``linear_schedule`` from ``lr`` to 0 over every
optimizer step of the run when ``anneal_lr``).

``PPO(mesh=...)`` runs the update over a ``DeviceMesh`` with a ``dp`` axis
(and a ``tp`` axis for tensor parallelism): each rank steps its rows of the
env batch and the gradient is reduced over ``dp`` once a minibatch, with the
result of the unsharded update up to the order of float sums
(``rl/mesh.py``).  Every rank reports the same metrics.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.state import EnvParams, resolve_device
from minigrid_tpu_torch.parallel.vector import VectorEnv
from minigrid_tpu_torch.rl.mesh import (
    LearnerMesh,
    ShardMean,
    global_grad_norm,
    reduce_gradients,
    shard_model_,
    tp_param_sharding,
)
from minigrid_tpu_torch.rl.networks import ActorCritic
from minigrid_tpu_torch.utils import trace


@dataclass(frozen=True)
class PPOConfig:
    """Hyperparameters, with the JAX package's defaults."""

    num_envs: int = 256
    num_steps: int = 128
    num_updates: int = 64
    update_epochs: int = 4
    num_minibatches: int = 8
    lr: float = 2.5e-4
    anneal_lr: bool = True
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    # Bootstrap truncated-but-not-terminated steps from V(final pre-reset
    # obs) rather than zero: one more observation and network apply a step.
    bootstrap_truncated: bool = True
    # Pooled-strategy envs only: K consume-only steps, then one K-window bulk
    # refill of the level ring.  Must divide num_steps, and
    # refill_period * pool_refill must divide the 2*num_envs ring (or exceed
    # it).  Ignored unless the env resolves to the pooled strategy.
    refill_period: int = 1


@dataclass
class EpisodeStats:
    """Per-env running episode accounting, reduced on the device."""

    running_return: torch.Tensor  # float32[B]
    running_length: torch.Tensor  # int32[B]
    episode_count: torch.Tensor  # int32[]
    return_sum: torch.Tensor  # float32[]
    length_sum: torch.Tensor  # float32[]
    success_count: torch.Tensor  # int32[] — episodes ending with reward > 0

    @staticmethod
    def zeros(num_envs: int, device=None) -> "EpisodeStats":
        dev = resolve_device(device)

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return EpisodeStats(z((num_envs,), torch.float32), z((num_envs,), torch.int32),
                            z((), torch.int32), z((), torch.float32), z((), torch.float32),
                            z((), torch.int32))

    def update(self, reward: torch.Tensor, done: torch.Tensor) -> "EpisodeStats":
        ret = self.running_return + reward
        length = self.running_length + 1
        return EpisodeStats(
            running_return=torch.where(done, 0.0, ret),
            running_length=torch.where(done, 0, length),
            episode_count=self.episode_count + done.sum(dtype=torch.int32),
            return_sum=self.return_sum + torch.where(done, ret, 0.0).sum(),
            length_sum=self.length_sum + torch.where(done, length, 0).float().sum(),
            success_count=self.success_count
            + (done & (reward > 0.0)).sum(dtype=torch.int32),
        )

    def summary(self, group=None) -> tuple[dict, "EpisodeStats"]:
        """(the update's episode metrics, the stats with the episode
        aggregates reset and the per-env running tallies kept).  With a
        process ``group`` (the ``dp`` axis) the aggregates are summed over its
        ranks first, in one collective: each rank tallies its own envs."""
        count, ret, length, success = (self.episode_count, self.return_sum,
                                       self.length_sum, self.success_count)
        if group is not None:
            sums = torch.stack([count.double(), ret.double(), length.double(),
                                success.double()])
            torch.distributed.all_reduce(sums, group=group)
            count, ret, length, success = (
                sums[0].to(count.dtype), sums[1].to(ret.dtype), sums[2].to(length.dtype),
                sums[3].to(success.dtype))
        safe = torch.clamp(count, min=1)
        metrics = {
            "episodes": count,
            "mean_return": ret / safe,
            "mean_length": length / safe,
            "success_rate": success / safe,
        }
        return metrics, dataclasses.replace(
            self, episode_count=torch.zeros_like(self.episode_count),
            return_sum=torch.zeros_like(self.return_sum),
            length_sum=torch.zeros_like(self.length_sum),
            success_count=torch.zeros_like(self.success_count))


def compute_gae(
    rewards: torch.Tensor,  # float32[T, B]
    values: torch.Tensor,  # float32[T, B]
    dones: torch.Tensor,  # bool[T, B] — episode ended AT this step
    last_value: torch.Tensor,  # float32[B]
    gamma: float,
    lam: float,
    truncated: torch.Tensor | None = None,  # bool[T, B] — truncated, NOT terminated
    trunc_values: torch.Tensor | None = None,  # float32[T, B] — V(final pre-reset obs)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation as a reverse loop over T, in the
    JAX package's expression order.  Returns (advantages[T, B], targets[T,
    B]) with targets = advantages + values.

    With ``truncated``/``trunc_values``, a step that hit the time limit
    without terminating bootstraps from the value of its final
    (pre-auto-reset) observation instead of zero; without them every done is
    terminal.

    XLA contracts both multiply-adds of the recursion, ``reward + gamma *
    next_v`` and ``delta + (gamma * lam * nonterminal) * gae``, into fused
    multiply-adds; each is computed here in float64 and rounded once to
    float32 (the product of two float32 values is exact in float64), which
    is the fused result but for double-rounding ties."""
    g = float(np.float32(gamma))  # the float32 constants XLA multiplies by
    gl = float(np.float32(gamma * lam))
    gae = torch.zeros_like(last_value)
    next_value = last_value
    advantages = []
    for t in reversed(range(rewards.shape[0])):
        nonterminal = 1.0 - dones[t].float()
        next_v = next_value * nonterminal
        if truncated is not None:
            next_v = torch.where(truncated[t], trunc_values[t], next_v)
        delta = _fma(next_v, g, rewards[t]) - values[t]
        gae = _fma(gl * nonterminal, gae, delta)
        advantages.append(gae)
        next_value = values[t]
    advantages = torch.stack(advantages[::-1])
    return advantages, advantages + values


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add."""
    return (a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
            + c.double()).float()


def ppo_objective(logits: torch.Tensor, value: torch.Tensor, batch: dict, clip_eps: float,
                  ent_coef: float, vf_coef: float,
                  shard: ShardMean | None = None) -> tuple[torch.Tensor, dict]:
    """The clipped PPO objective of the network's ``logits`` and ``value``
    on a minibatch of transitions (any leading shape: ``[N]``, or ``[T, N]``
    for the recurrent learner); returns (loss, detached metrics).  The
    advantage is normalised by its population standard deviation, as
    ``jnp.std`` computes it.  With ``shard`` the transitions are this rank's
    share of a minibatch split over ``dp``: every mean is this rank's share
    of the minibatch's (the loss and metrics sum to the minibatch's over
    the ranks), and the advantage's mean and deviation are the minibatch's."""
    mean = torch.mean if shard is None else shard.mean
    log_probs = F.log_softmax(logits, dim=-1)
    logp = log_probs.gather(-1, batch["action"].long()[..., None]).squeeze(-1)

    ratio = torch.exp(logp - batch["log_prob"])
    adv = batch["advantage"]
    if shard is None:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    else:
        adv = shard.normalize(adv)
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
    policy_loss = -mean(torch.minimum(pg1, pg2))

    v_clipped = batch["value"] + torch.clamp(value - batch["value"], -clip_eps, clip_eps)
    vf1 = torch.square(value - batch["target"])
    vf2 = torch.square(v_clipped - batch["target"])
    value_loss = 0.5 * mean(torch.maximum(vf1, vf2))

    entropy = -mean((torch.exp(log_probs) * log_probs).sum(-1))

    loss = policy_loss + vf_coef * value_loss - ent_coef * entropy
    metrics = {
        "loss": loss,
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": entropy,
        "approx_kl": mean((ratio - 1.0) - torch.log(ratio)),
    }
    return loss, {k: v.detach() for k, v in metrics.items()}


def draw_actions(key: torch.Tensor, logits: torch.Tensor,
                 rows: tuple[int, int] | None = None, num_rows: int | None = None):
    """The rollout's action draw, as the JAX learner makes it: ``key, k_act
    = split(key)``, then one Gumbel-max over all ``[B, A]`` logits from
    ``k_act`` (the rows ``[lo, hi)`` of a ``[num_rows, A]`` draw with
    ``rows``).  Returns (key, action int32[B], its log-probability)."""
    key, k_act = rng.split(key).unbind(0)
    action = rng.categorical_one_key(k_act, logits, rows, num_rows)
    log_prob = F.log_softmax(logits, dim=-1).gather(-1, action.long()[:, None]).squeeze(-1)
    return key, action, log_prob


def ppo_loss(model: nn.Module, batch: dict, clip_eps: float, ent_coef: float,
             vf_coef: float, shard: ShardMean | None = None) -> tuple[torch.Tensor, dict]:
    """Clipped PPO objective on one minibatch of flattened transitions (this
    rank's share of one with ``shard``); returns (loss, detached metrics)."""
    logits, value = model(batch["obs"])
    return ppo_objective(logits, value, batch, clip_eps, ent_coef, vf_coef, shard)


# -- the optimizer -------------------------------------------------------------------

def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor | None = None) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: the global norm of the
    gradients (``norm`` where the caller has it, as a tensor-parallel run
    does); each rescaled to ``g / norm * max_norm`` where the norm is at
    least ``max_norm``, left as it is below.  Returns the norm."""
    if norm is None:
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def linear_schedule(init_value: float, transition_steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule(init_value, 0.0, transition_steps)``: the
    learning rate of optimizer step ``count``."""
    def schedule(count: int) -> float:
        return init_value * (1.0 - min(count, transition_steps) / transition_steps)
    return schedule


@dataclass
class TrainState:
    """The model and its optimizer: flax's ``TrainState`` for a module whose
    parameters change in place.  ``step`` counts optimizer steps."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    max_grad_norm: float | None = None
    step: int = 0

    @staticmethod
    def create(model: nn.Module, lr: float | Callable[[int], float],
               max_grad_norm: float | None = None, eps: float = 1e-8) -> "TrainState":
        """Adam over ``model``'s parameters (optax's ``adam`` with ``eps``),
        after a global-norm clip when ``max_grad_norm`` is given; ``lr`` a
        float or a schedule of the step count."""
        schedule = lr if callable(lr) else (lambda count, v=float(lr): v)
        optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0),
                                     betas=(0.9, 0.999), eps=eps)
        return TrainState(model, optimizer, schedule, max_grad_norm)

    def apply_gradients(self, loss: torch.Tensor, mesh: LearnerMesh | None = None,
                        extra: dict | None = None) -> dict | None:
        """Backpropagate ``loss`` and take one optimizer step.  With ``mesh``
        the gradients and the scalars of ``extra`` are first summed over its
        ``dp`` axis (one collective) and the clip reads the norm over its
        ``tp`` shards; returns the summed ``extra``."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        params = list(self.model.parameters())
        if mesh is not None:
            extra = reduce_gradients(params, extra or {}, mesh.dp)
        if self.max_grad_norm is not None:
            grads = [p.grad for p in params if p.grad is not None]
            clip_by_global_norm_(grads, self.max_grad_norm,
                                 None if mesh is None else global_grad_norm(params, mesh.tp))
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1
        return extra


def ppo_train_state(model: nn.Module, config: PPOConfig) -> TrainState:
    """The optimizer of both PPO learners: the clip, then Adam with eps 1e-5
    at ``lr``, annealed linearly to 0 over the run's optimizer steps."""
    lr: float | Callable[[int], float] = config.lr
    if config.anneal_lr:
        lr = linear_schedule(config.lr, config.num_updates * config.update_epochs
                             * config.num_minibatches)
    return TrainState.create(model, lr, config.max_grad_norm, eps=1e-5)


def stack_steps(steps: list[dict]) -> dict:
    """Per-step dicts of ``[B, ...]`` tensors (an ``obs`` entry a dict
    itself) -> one dict of ``[T, B, ...]`` tensors."""
    out = {}
    for k, v in steps[0].items():
        if isinstance(v, dict):
            out[k] = stack_steps([s[k] for s in steps])
        else:
            out[k] = torch.stack([s[k] for s in steps])
    return out


def map_batch(fn: Callable, batch: dict) -> dict:
    """``fn`` over every tensor of a (nested) batch dict."""
    return {k: map_batch(fn, v) if isinstance(v, dict) else fn(v) for k, v in batch.items()}


def mean_metrics(per_step: list[dict]) -> dict:
    """The mean of each metric over the update's optimizer steps."""
    return {k: torch.stack([m[k] for m in per_step]).mean() for k in per_step[0]}


class PPORunner(NamedTuple):
    """What JAX's 5-tuple carries: the train state (model, optimizer, step
    count), the env state, the current observation, the key and the episode
    stats."""

    train_state: TrainState
    env_state: Any
    obs: dict
    key: torch.Tensor
    stats: EpisodeStats


class PPO:
    """PPO trainer bound to one env family::

        trainer = PPO(env, env.default_params, PPOConfig(...))
        runner = trainer.init(rng.PRNGKey(0))
        runner, metrics = trainer.train(runner)      # num_updates updates
        runner, metrics = trainer.update(runner)     # or one at a time

    ``network`` is the module to build and train (a float32 ``ActorCritic``
    for parity checks); ``init`` builds a copy of it, so runners are
    independent.  The model, its optimizer state and the rollout buffers live
    on ``device`` (CUDA unless named).

    ``mesh``, a ``DeviceMesh`` with a ``dp`` axis (``multihost.pod_mesh``):
    this rank steps its ``num_envs / dp`` rows of the batch, and every rank
    must call ``init`` with the same key; with a ``tp`` axis the parameters
    are sharded by :func:`tp_param_sharding`.  The runner then holds this
    rank's rows and parameter slices, and the metrics are global."""

    def __init__(self, env: Env, env_params: EnvParams | None = None,
                 config: PPOConfig | None = None, network: ActorCritic | None = None,
                 device=None, mesh=None):
        self.env = env
        self.env_params = env_params or env.default_params
        self.config = config or PPOConfig()
        self.device = resolve_device(device)
        self.network = network or ActorCritic(num_actions=env.num_actions)
        self.mesh = mesh
        self.learner_mesh = None if mesh is None else LearnerMesh.from_mesh(mesh)
        # each parameter's Shard over tp, or None (whole): a checkpoint's
        # placement of the model; None without tp
        self.param_placement: dict | None = None
        shard = None if mesh is None else self.learner_mesh.dp.rows(self.config.num_envs)
        self.venv = VectorEnv(env, self.config.num_envs, self.env_params,
                              final_obs=self.config.bootstrap_truncated, device=self.device,
                              shard=shard)

    # -- setup ---------------------------------------------------------------
    def init(self, key: torch.Tensor) -> PPORunner:
        """The runner: ``key`` split into (key, network, env reset)."""
        key, k_net, k_env = rng.split(key.to(self.device), 3).unbind(0)
        obs, env_state = self.venv.reset(k_env)
        model = copy.deepcopy(self.network).init(k_net, {k: v[:1] for k, v in obs.items()})
        lm = self.learner_mesh
        if lm is not None and lm.tp.size > 1:
            self.param_placement = tp_param_sharding(model, self.mesh)
            shard_model_(model, self.param_placement, lm.tp)
        return PPORunner(ppo_train_state(model, self.config), env_state, obs, key,
                         EpisodeStats.zeros(self.venv.local_envs, self.device))

    # -- one update, in three phases -------------------------------------------
    def refill_period(self) -> int:
        """The bulk-refill period of the rollout: ``config.refill_period`` on
        an auto-resetting pooled env, else 1; checked as the JAX package
        checks it."""
        cfg, venv = self.config, self.venv
        if not (venv.reset_strategy == "pooled" and venv.auto_reset):
            return 1
        k = cfg.refill_period
        if k > 1:
            if cfg.num_steps % k:
                raise ValueError(f"num_steps={cfg.num_steps} is not a multiple of "
                                 f"refill_period={k}")
            ring = 2 * cfg.num_envs
            if ring % min(k * venv.pool_refill, ring):
                raise ValueError(
                    f"refill_period*pool_refill = {k * venv.pool_refill} must divide "
                    f"the pool ring size {ring} (or exceed it); "
                    f"pool_refill={venv.pool_refill}")
        return k

    @torch.no_grad()
    def rollout(self, runner: PPORunner) -> tuple[PPORunner, dict]:
        """T steps of B envs under the current policy.  Returns the runner
        moved on and the trajectory: ``obs`` (a dict), ``action``,
        ``log_prob``, ``value``, ``reward``, ``done`` (and with
        ``bootstrap_truncated`` ``truncated`` and ``trunc_value``), each
        ``[T, B, ...]``."""
        cfg, venv = self.config, self.venv
        model = runner.train_state.model
        env_state, obs, key, stats = runner.env_state, runner.obs, runner.key, runner.stats
        k = self.refill_period()
        steps = []
        rows = None if self.mesh is None else (venv.lo, venv.hi)
        for t in range(cfg.num_steps):
            logits, value = model(obs)
            key, action, log_prob = draw_actions(key, logits, rows, venv.num_envs)
            step = venv.step_nofill if k > 1 else venv.step
            new_obs, env_state, reward, term, trunc, info = step(env_state, action)
            done = term | trunc
            stats = stats.update(reward, done)
            transition = {"obs": obs, "action": action, "log_prob": log_prob,
                          "value": value, "reward": reward, "done": done}
            if cfg.bootstrap_truncated:
                # V(final pre-reset obs); a terminated step keeps the zero
                # bootstrap (term dominates if both flags fire)
                transition["truncated"] = trunc & ~term
                transition["trunc_value"] = model(info["final_obs"])[1]
            if k > 1 and (t + 1) % k == 0:
                env_state = venv.refill(env_state, k)
            steps.append(transition)
            obs = new_obs
        return runner._replace(env_state=env_state, obs=obs, key=key,
                               stats=stats), stack_steps(steps)

    @torch.no_grad()
    def advantages(self, runner: PPORunner, traj: dict) -> dict:
        """GAE over the trajectory, bootstrapped from V(runner.obs); returns
        the flattened ``[T*B, ...]`` batch the epochs draw from."""
        cfg = self.config
        _, last_value = runner.train_state.model(runner.obs)
        advantages, targets = compute_gae(
            traj["reward"], traj["value"], traj["done"], last_value, cfg.gamma,
            cfg.gae_lambda, truncated=traj.get("truncated"),
            trunc_values=traj.get("trunc_value"))
        batch = {"obs": traj["obs"], "action": traj["action"], "log_prob": traj["log_prob"],
                 "value": traj["value"], "advantage": advantages, "target": targets}
        return map_batch(lambda x: x.reshape((-1,) + x.shape[2:]), batch)

    def optimize(self, runner: PPORunner, batch: dict) -> tuple[PPORunner, dict]:
        """``update_epochs`` epochs, each a fresh permutation of the
        transitions cut into ``num_minibatches`` optimizer steps.  Returns
        the runner (its key moved on, the episode aggregates reset) and the
        metrics: means over the steps, plus the rollout's episode stats.

        With a mesh, ``batch`` is this rank's rows and the permutation is of
        the global T*B transitions (global ``t * B + e`` is this rank's
        ``t * b + e - lo``): each minibatch step takes the rank's transitions
        of the global minibatch, and their count is read to the host once an
        epoch."""
        cfg, ts, lm = self.config, runner.train_state, self.learner_mesh
        total = cfg.num_steps * cfg.num_envs
        if total % cfg.num_minibatches:
            raise ValueError(f"num_minibatches={cfg.num_minibatches} does not divide "
                             f"the {total} transitions")
        mb_size = total // cfg.num_minibatches
        key, per_step = runner.key, []
        for _ in range(cfg.update_epochs):
            key, k_perm = rng.split(key).unbind(0)
            perm = rng.permutation(k_perm, total).long()
            if lm is None:
                for i in range(cfg.num_minibatches):
                    idx = perm[i * mb_size:(i + 1) * mb_size]
                    loss, metrics = ppo_loss(ts.model, map_batch(lambda x: x[idx], batch),
                                             cfg.clip_eps, cfg.ent_coef, cfg.vf_coef)
                    ts.apply_gradients(loss)
                    per_step.append(metrics)
                continue
            rows, counts = self._owned_rows(perm.view(cfg.num_minibatches, mb_size))
            for i, count in enumerate(counts):
                # a rank that owns no transition of this minibatch still takes
                # part in its collectives, on one masked row
                idx = rows[i, :count] if count else rows.new_zeros(1)
                weight = None if count else torch.zeros(1, device=self.device)
                shard = ShardMean(lm.dp, mb_size, weight)
                loss, metrics = ppo_loss(ts.model, map_batch(lambda x: x[idx], batch),
                                         cfg.clip_eps, cfg.ent_coef, cfg.vf_coef, shard)
                per_step.append(ts.apply_gradients(loss, lm, metrics))
        episodes, stats = runner.stats.summary(None if lm is None else lm.dp.group)
        return (runner._replace(key=key, stats=stats),
                {**mean_metrics(per_step), **episodes})

    def _owned_rows(self, perm: torch.Tensor) -> tuple[torch.Tensor, list[int]]:
        """This rank's transitions in each minibatch of the global
        permutation ``perm [M, mb]``: (local rows ``[M, mb]``, each row's
        first ``counts[i]`` entries this rank's transitions of minibatch i in
        the permutation's order; the counts, read to the host at once)."""
        venv = self.venv
        env = perm % venv.num_envs
        owned = (env >= venv.lo) & (env < venv.hi)
        local = (perm // venv.num_envs) * venv.local_envs + (env - venv.lo)
        order = torch.sort((~owned).to(torch.uint8), dim=1, stable=True).indices
        return local.gather(1, order), owned.sum(1).tolist()

    def update(self, runner: PPORunner) -> tuple[PPORunner, dict]:
        """One PPO update: rollout, advantages, optimize (the spans
        ``ppo.rollout`` and ``ppo.optimize``, the advantages in the second)."""
        with trace.span("ppo.rollout"):
            runner, traj = self.rollout(runner)
        with trace.span("ppo.optimize"):
            return self.optimize(runner, self.advantages(runner, traj))

    def train(self, runner: PPORunner, num_updates: int | None = None):
        """Run ``num_updates`` updates; returns (runner, stacked metrics)."""
        n = num_updates if num_updates is not None else self.config.num_updates
        history = []
        for _ in range(n):
            runner, metrics = self.update(runner)
            history.append(metrics)
        return runner, {k: torch.stack([m[k] for m in history]) for k in history[0]}


def train_step_fn(env: Env, env_params: EnvParams, config: PPOConfig, mesh=None,
                  device=None):
    """(fn, runner): one PPO update as a function of the runner, and a runner
    from ``PRNGKey(0)`` (this rank's, with ``mesh``)."""
    trainer = PPO(env, env_params, config, device=device, mesh=mesh)
    return trainer.update, trainer.init(rng.PRNGKey(0, trainer.device))
