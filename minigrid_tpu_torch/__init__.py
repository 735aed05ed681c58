"""minigrid_tpu_torch — the MiniGrid engine of ``minigrid_tpu`` on PyTorch and CUDA.

The port keeps the JAX package's module layout and semantics: packed int32
cell words, a branchless batched step, the egocentric observation (its window
gather a hand-written CUDA kernel), the single-room and multi-room MiniGrid
families, every BabyAI level (on ``BabyAILevel`` or its grammar sampler
``LevelGen``) with the verifier, the five dataset envs (every id of the JAX
registry), the vectorized auto-reset engine with its three reset strategies and ``rollout``,
and ``FusedVectorEnv``, whose whole step (auto-reset and observation
included) is one hand-written CUDA kernel.  Beside them: the 15 observation
and reward wrappers of ``minigrid_tpu_torch.wrappers`` (the exploration
bonuses' count tables ride in the engine's state), the RGB renderer of
``minigrid_tpu_torch.ops.render`` (a texture atlas built once on the host,
full and POV frames as one row gather, ``Env.get_frame``), the timing
tools ``tools/bench.py``, ``tools/benchmark.py`` and ``tools/battery.py``, and
the learner of ``minigrid_tpu_torch.rl`` (PPO with GAE, recurrent PPO and
behavior cloning, driven by ``tools/train_ppo.py`` and
``tools/train_rnn_ppo.py``), and the reference's own surface: seed-exact
levels (``utils/exact.py``), the Gymnasium adapter (``gym_compat.py``, ids
``minigrid_tpu_torch/<id>``, on ``single_env.py``, its core without gymnasium) and ``utils/convert.from_reference``; and the
host tools of ``tools/`` (the BFS oracle and its demos, manual control,
profile, autotune, the battery sweep, the docs and site generators, the
smoke gate).  Entry points run on CUDA unless the caller passes
``device="cpu"``.

    import minigrid_tpu_torch as mgt
    from minigrid_tpu_torch.core import rng

    venv = mgt.make_vec("MiniGrid-DoorKey-8x8-v0", 4096)
    obs, state = venv.reset(rng.PRNGKey(0))

    fused = mgt.FusedVectorEnv(mgt.make("MiniGrid-DoorKey-8x8-v0"), 4096)
    obs, fs = fused.reset(rng.PRNGKey(0))
    obs, fs, reward, terminated, truncated, info = fused.step(fs, actions)

    from minigrid_tpu_torch.wrappers import RGBImgPartialObsWrapper

    pixels = mgt.VectorEnv(RGBImgPartialObsWrapper(mgt.make("MiniGrid-DoorKey-8x8-v0"),
                                                   channels_first=True), 4096)

    from minigrid_tpu_torch.rl import PPO, PPOConfig

    trainer = PPO(mgt.make("MiniGrid-DoorKey-5x5-v0"), config=PPOConfig(num_envs=1024))
    runner, metrics = trainer.train(trainer.init(rng.PRNGKey(0)), num_updates=20)
"""

from __future__ import annotations

from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.state import EnvParams, EnvState
from minigrid_tpu_torch.core.step import NUM_ACTIONS, Actions
from minigrid_tpu_torch.ops.fused_step import FusedVectorEnv
from minigrid_tpu_torch.parallel.vector import VectorEnv, rollout
from minigrid_tpu_torch.registry import make, make_vec, register, registered_ids, spec

import minigrid_tpu_torch.envs  # noqa: F401  (populates the registry)
import minigrid_tpu_torch.babyai  # noqa: F401  (the BabyAI ids)

__all__ = [
    "Actions",
    "Env",
    "EnvParams",
    "EnvState",
    "FusedVectorEnv",
    "NUM_ACTIONS",
    "VectorEnv",
    "make",
    "make_vec",
    "register",
    "registered_ids",
    "rollout",
    "spec",
]
