"""RL learner layer: the counterpart of ``minigrid_tpu/rl/``.

PPO with GAE over the port's vectorized env (feed-forward, with the pooled
``refill_period``), recurrent PPO and behavior cloning, on ``torch.nn``
networks whose parameters carry across to the JAX package's flax trees
(``minigrid_tpu_torch.utils.convert``).  Every entry point runs on CUDA unless
the caller passes ``device="cpu"``.  ``PPO(mesh=...)`` trains data- and
tensor-parallel over a ``torch.distributed`` mesh (``rl/mesh.py``), its
parameters sharded by ``tp_param_sharding``.
"""

from minigrid_tpu_torch.rl.bc import BCConfig, bc_train, evaluate_policy, pack_bc_dataset
from minigrid_tpu_torch.rl.networks import ActorCritic, ObsEncoder
from minigrid_tpu_torch.rl.ppo import (
    PPO,
    EpisodeStats,
    PPOConfig,
    compute_gae,
    ppo_loss,
    tp_param_sharding,
    train_step_fn,
)
from minigrid_tpu_torch.rl.rnn import RecurrentActorCritic, RecurrentPPO

__all__ = [
    "ActorCritic",
    "BCConfig",
    "bc_train",
    "evaluate_policy",
    "pack_bc_dataset",
    "ObsEncoder",
    "PPO",
    "PPOConfig",
    "EpisodeStats",
    "compute_gae",
    "ppo_loss",
    "tp_param_sharding",
    "train_step_fn",
    "RecurrentActorCritic",
    "RecurrentPPO",
]
