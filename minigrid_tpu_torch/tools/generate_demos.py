"""Oracle demo dataset dumper (re-derivation of minigrid/generate_demos.py).

Counterpart of ``minigrid_tpu/tools/generate_demos.py``.  Rolls the BFS
oracle over one env id, filters trajectories by length, and saves torch
tensors — the artifact layout the reference's pipeline produces
(generate_demos.py:63-164): per-demo mission strings, stacked observation
tensors, action/reward tensors, and target cells.  Run on the card:

    python -m minigrid_tpu_torch.tools.generate_demos [--env ID] \
        [--num-demos 100] [--out demos.pt] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.tools.oracle import OracleAgent


def collect(env_id: str, num_demos: int, seed: int = 0,
            max_len: int | None = None, min_len: int = 1, device=None):
    import minigrid_tpu_torch

    dev = resolve_device(device)
    env = minigrid_tpu_torch.make(env_id)
    agent = OracleAgent(env, device=dev)
    demos = agent.generate_demos(rng.PRNGKey(seed, dev), num_demos)
    if max_len is not None:
        demos = [d for d in demos if min_len <= len(d[2]) <= max_len]
    return demos


def pack_demos(demos):
    """Demos -> dict of torch tensors.  Variable-length trajectories are
    padded; lengths are recorded."""
    missions = [d[0] for d in demos]
    lengths = np.asarray([len(d[2]) for d in demos], np.int32)
    max_len = int(lengths.max()) if len(demos) else 0
    n = len(demos)
    if n == 0:
        return {"missions": [], "lengths": torch.from_numpy(lengths)}
    img_shape = demos[0][1][0]["image"].shape
    obss = np.zeros((n, max_len, *img_shape), np.uint8)
    actions = np.zeros((n, max_len), np.int64)
    rewards = np.zeros((n, max_len), np.float32)
    targets = np.zeros((n, 2), np.int64)
    for i, (mission, ob, ac, rw, target, label) in enumerate(demos):
        L = len(ac)
        obss[i, :L] = np.stack([o["image"] for o in ob])
        actions[i, :L] = ac
        rewards[i, :L] = rw
        targets[i] = target
    out = {"missions": missions, "lengths": lengths, "obss": obss,
           "actions": actions, "rewards": rewards, "targets": targets}
    for k in ("lengths", "obss", "actions", "rewards", "targets"):
        out[k] = torch.from_numpy(out[k])
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="MiniGrid-Negated-Simple-v0")
    parser.add_argument("--num-demos", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-len", type=int, default=30)
    parser.add_argument("--out", default="demos.pt")
    parser.add_argument("--device", default=None, help="'cpu' to run on the CPU")
    args = parser.parse_args(argv)

    demos = collect(args.env, args.num_demos, args.seed, args.max_len,
                    device=args.device)
    packed = pack_demos(demos)
    lens = packed["lengths"]
    n = len(demos)
    print(f"collected {n} demos; "
          f"max len {int(max(lens)) if n else 0}, "
          f"avg len {float(np.mean(lens.numpy())) if n else 0:.1f}")
    torch.save(packed, args.out)
    print(f"saved to {args.out}")


if __name__ == "__main__":
    main()
