"""minigrid_tpu_torch — the MiniGrid engine of ``minigrid_tpu`` on PyTorch and CUDA.

The port keeps the JAX package's module layout and semantics: packed int32
cell words, a branchless batched step, the egocentric observation (its window
gather a hand-written CUDA kernel), and the vectorized auto-reset engine.
Entry points run on CUDA unless the caller passes ``device="cpu"``.

    import minigrid_tpu_torch as mgt
    from minigrid_tpu_torch.core import rng

    venv = mgt.make_vec("MiniGrid-DoorKey-8x8-v0", 4096)
    obs, state = venv.reset(rng.PRNGKey(0))
"""

from __future__ import annotations

from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.state import EnvParams, EnvState
from minigrid_tpu_torch.core.step import NUM_ACTIONS, Actions
from minigrid_tpu_torch.parallel.vector import VectorEnv
from minigrid_tpu_torch.registry import make, make_vec, register, registered_ids

import minigrid_tpu_torch.envs  # noqa: F401  (populates the registry)

__all__ = [
    "Actions",
    "Env",
    "EnvParams",
    "EnvState",
    "NUM_ACTIONS",
    "VectorEnv",
    "make",
    "make_vec",
    "register",
    "registered_ids",
]
