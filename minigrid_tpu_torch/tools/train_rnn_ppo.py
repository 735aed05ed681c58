"""Train recurrent PPO (LSTM) on a memory task with the PyTorch port.

The port's copy of ``examples/train_rnn_ppo.py``: the same flags, defaults
and per-update line (MiniGrid-MemoryS7, 512 envs x 256 steps an update, 4
epochs x 4 minibatches, lr 1e-3, entropy 0.05, gamma 0.95), on CUDA unless
``--device`` names another device; the closing line gives the env-steps/s
through the loop.

    python -m minigrid_tpu_torch.tools.train_rnn_ppo --env MiniGrid-MemoryS7-v0
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env", default="MiniGrid-MemoryS7-v0")
    p.add_argument("--num-envs", type=int, default=512)
    p.add_argument("--num-steps", type=int, default=256)
    p.add_argument("--num-updates", type=int, default=150)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ent-coef", type=float, default=0.05)
    p.add_argument("--gamma", type=float, default=0.95)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)

    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.rl import PPOConfig, RecurrentPPO

    env = minigrid_tpu_torch.make(args.env)
    cfg = PPOConfig(num_envs=args.num_envs, num_steps=args.num_steps,
                    num_updates=args.num_updates, num_minibatches=4,
                    update_epochs=4, lr=args.lr, ent_coef=args.ent_coef,
                    gamma=args.gamma)
    trainer = RecurrentPPO(env, env.default_params, cfg, device=args.device)
    runner = trainer.init(rng.PRNGKey(args.seed, trainer.device))
    t0 = time.perf_counter()
    for u in range(args.num_updates):
        runner, m = trainer.update(runner)
        print(f"update {u + 1:4d}  success={float(m['success_rate']):5.2f}  "
              f"return={float(m['mean_return']):6.3f}  "
              f"len={float(m['mean_length']):6.1f}  "
              f"episodes={int(m['episodes']):6d}", flush=True)
    dt = time.perf_counter() - t0
    steps = args.num_updates * args.num_envs * args.num_steps
    print(f"\n{steps:,} env-steps in {dt:.0f}s "
          f"({steps / dt:,.0f} steps/s through the full PPO loop)")


if __name__ == "__main__":
    main()
