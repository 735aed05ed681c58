"""Switching from gym-minigrid to the PyTorch port, three ways.

The port's copy of ``examples/migrate_from_reference.py``.  Run on the card
(``--device cpu`` for the CPU):

    python examples/migrate_from_reference_torch.py

1. **Gymnasium drop-in** — the same `gym.make` + reset/step loop the
   reference README shows, backed by the tensor engine (the port's ids are
   ``minigrid_tpu_torch/<id>``; needs gymnasium).
2. **Keep your seeds** — `exact_seed=True` makes `reset(seed=s)`
   bit-identical to the reference's episode for that seed (the host
   generator replays the reference's np_random call order).  Without
   gymnasium, ``utils.exact.reset_exact`` gives the same episode.
3. **Go wide** — the same family as a 4096-env lockstep batch stepping
   entirely on the card, which is the point of the rewrite.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> None:
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.core.state import resolve_device
    from minigrid_tpu_torch.parallel.vector import VectorEnv

    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="'cpu' to run on the CPU")
    dev = resolve_device(p.parse_args(argv).device)

    try:
        import gymnasium as gym

        from minigrid_tpu_torch.gym_compat import GymEnv, gym_id, register_gym_envs
    except ImportError:
        gym = None

    if gym is not None:
        # -- 1. drop-in Gymnasium usage ---------------------------------
        register_gym_envs()  # the reference fork's own registration raises
        env = gym.make(gym_id("MiniGrid-DoorKey-8x8-v0"), device=dev)
        obs, _ = env.reset(seed=0)
        print("gym obs keys:", sorted(obs), "| mission:", obs["mission"])
        obs, r, term, trunc, _ = env.step(env.action_space.sample())
        env.close()

        # -- 2. reference-identical seeds --------------------------------
        env = GymEnv("MiniGrid-DoorKey-8x8-v0", exact_seed=True, device=dev)
        obs, _ = env.reset(seed=42)
        image = obs["image"]
    else:
        print("gymnasium is not installed: step 1 is skipped, step 2 runs "
              "reset_exact directly")
        from minigrid_tpu_torch.utils.exact import reset_exact

        fenv = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0")
        obs, _ = reset_exact(fenv, 42, fenv.default_params, dev)
        image = obs["image"][0].cpu().numpy()
    # this observation is bit-identical to
    #   minigrid.envs.DoorKeyEnv(size=8).reset(seed=42)
    print("exact-seed obs image checksum:", int(image.sum()))

    # -- 3. the batched path on the card ----------------------------------
    fenv = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0")
    venv = VectorEnv(fenv, num_envs=4096, device=dev)
    key, k_reset = rng.split(rng.PRNGKey(1, dev)).unbind(0)
    obs, state = venv.reset(k_reset)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for k in rng.split(key, 256):
        a = rng.randint(k, (4096,), 0, fenv.num_actions)
        _, state, r, te, tr, _ = venv.step(state, a)
        total += r.sum()
    print("4096 envs x 256 steps on the device; total reward:", float(total))


if __name__ == "__main__":
    main()
