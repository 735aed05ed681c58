"""Train PPO on a MiniGrid env with the PyTorch port, end to end.

The port's copy of ``examples/train_ppo.py``: the same flags, defaults and
per-update line, and the closing "env-steps in ... s" line, on CUDA unless
``--device`` names another device.  The default network is the bf16
``ActorCritic`` (1,850,201 parameters at the 7x7 view).

    python -m minigrid_tpu_torch.tools.train_ppo --env MiniGrid-DoorKey-5x5-v0 \\
        --num-envs 1024 --num-updates 40 [--checkpoint /tmp/ppo.pt]

``--checkpoint`` saves the runner (model, optimizer, env state, key, episode
tallies) after training and ``--resume`` restores one before it
(``utils/checkpoint.py``).  The learning rate anneals over
``--total-updates`` (default ``--num-updates``): give both legs of a broken
run the whole run's count, and 2 updates saved, then resumed for 1, equal 3
updates straight.

Tracing (``utils/trace.py``) is on while the tool trains: each update's line
ends with its host seconds and those of its two halves, the spans
``ppo.rollout`` and ``ppo.optimize`` (the advantages included).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    """Run the tool; returns the final runner and each update's metrics."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env", default="MiniGrid-Empty-8x8-v0")
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--num-steps", type=int, default=128)
    p.add_argument("--num-updates", type=int, default=30)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--total-updates", type=int, default=None,
                   help="updates the learning rate anneals over, resumes included "
                        "(default: --num-updates)")
    p.add_argument("--checkpoint", default=None,
                   help="save the runner here after training")
    p.add_argument("--resume", default=None,
                   help="restore a runner checkpoint before training")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = p.parse_args(argv)

    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.rl import PPO, PPOConfig
    from minigrid_tpu_torch.utils import trace

    env = minigrid_tpu_torch.make(args.env)
    cfg = PPOConfig(num_envs=args.num_envs, num_steps=args.num_steps,
                    num_updates=args.total_updates or args.num_updates, lr=args.lr,
                    ent_coef=args.ent_coef)
    trainer = PPO(env, env.default_params, cfg, device=args.device)
    runner = trainer.init(rng.PRNGKey(args.seed, trainer.device))
    if args.resume:
        from minigrid_tpu_torch.utils.checkpoint import load

        runner = load(args.resume, runner)

    t0 = time.perf_counter()
    history = []
    trace.enable()
    try:
        for u in range(args.num_updates):
            trace.reset()
            t_update = time.perf_counter()
            runner, m = trainer.update(runner)
            history.append(m)
            spans = trace.report()["spans"]
            print(f"update {u + 1:4d}  return={float(m['mean_return']):7.3f}  "
                  f"success={float(m['success_rate']):5.2f}  "
                  f"len={float(m['mean_length']):6.1f}  "
                  f"episodes={int(m['episodes']):6d}  "
                  f"loss={float(m['loss']):8.4f}  "
                  f"time={time.perf_counter() - t_update:6.2f}s "
                  f"(rollout {spans['ppo.rollout']['seconds']:6.2f}s, "
                  f"optimize {spans['ppo.optimize']['seconds']:6.2f}s)", flush=True)
    finally:
        trace.disable()
    dt = time.perf_counter() - t0
    steps = args.num_updates * args.num_envs * args.num_steps
    print(f"\n{steps:,} env-steps in {dt:.0f}s "
          f"({steps / dt:,.0f} steps/s through the full PPO loop)")

    if args.checkpoint:
        from minigrid_tpu_torch.utils.checkpoint import save

        save(args.checkpoint, runner)
        print(f"runner saved to {args.checkpoint}")
    return runner, history


if __name__ == "__main__":
    main()
