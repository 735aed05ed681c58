"""Weak-scaling benchmark over ranks (the port's ``tools/bench_sharded.py``).

The env loop is embarrassingly parallel: each rank steps its rows of the
batch and generates their levels from keys every rank holds, so the sharded
program has no collective until its final totals.  The scaling claim should
be measured, not asserted: this tool runs the same per-rank workload on
growing numbers of ranks (one process each, spawned locally) and reports the
aggregate env-steps/s and the weak-scaling efficiency against one rank:

    python -m minigrid_tpu_torch.tools.bench_sharded MiniGrid-DoorKey-8x8-v0 \\
        --envs-per-device 4096 --num-steps 1024 --devices 1,2,4,8

On a host with several cards each rank takes a card of its own (NCCL); a
size larger than the cards is skipped.  ``--device cpu`` runs gloo ranks on
the CPU instead, the counterpart of the JAX package's virtual device farm.
The timed program is ``parallel/sharding.py::sharded_rollout`` (reset, then
T steps of random actions, the observation folded into a checksum every
step, the totals summed over the ranks and fetched to the host); each rank
runs it once to warm up, then again after a barrier, and the slowest rank's
second run is the time.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

import minigrid_tpu_torch
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.parallel.multihost import spawn
from minigrid_tpu_torch.parallel.sharding import sharded_rollout


def _rank_seconds(env_id: str, envs_per_device: int, num_steps: int, seed: int,
                  device: str) -> dict:
    """One rank's part of :func:`measure`: the seconds of the second run,
    and the global totals it returned."""
    env = minigrid_tpu_torch.make(env_id)
    num_envs = envs_per_device * dist.get_world_size()
    sharded_rollout(env, None, rng.PRNGKey(seed, device), num_envs, num_steps, device=device)
    dist.barrier()
    t0 = time.perf_counter()
    steps, reward, dones = sharded_rollout(env, None, rng.PRNGKey(seed + 1, device), num_envs,
                                           num_steps, device=device)
    return {"seconds": time.perf_counter() - t0, "steps": steps, "reward": reward,
            "dones": dones}


def measure(env_id: str, n_devices: int, envs_per_device: int, num_steps: int,
            seed: int = 0, device: str = "cuda") -> float:
    """Aggregate env-steps/s of ``n_devices`` ranks with ``envs_per_device``
    envs each: the global steps over the slowest rank's timed run."""
    ranks = spawn(_rank_seconds, n_devices,
                  (env_id, envs_per_device, num_steps, seed, device),
                  backend="gloo" if device == "cpu" else None)
    if len({(r["steps"], r["reward"], r["dones"]) for r in ranks}) != 1:
        raise AssertionError(f"the ranks disagree on the totals: {ranks}")
    return ranks[0]["steps"] / max(r["seconds"] for r in ranks)


def available(device: str) -> int:
    """How many ranks ``device`` can hold: a card each, or a core each."""
    if device == "cpu":
        return os.cpu_count() or 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def sweep(env_id: str, device_counts, envs_per_device: int, num_steps: int,
          verbose: bool = True, device: str = "cuda") -> list[dict]:
    """:func:`measure` for each rank count that ``device`` can hold; each
    row ``{"n_devices", "steps_per_sec", "efficiency"}``, the efficiency
    against the first row's rate per rank."""
    avail = available(device)
    rows = []
    base = None
    for n in device_counts:
        if n > avail:
            if verbose:
                print(f"  n={n}: skipped (only {avail} devices)", flush=True)
            continue
        sps = measure(env_id, n, envs_per_device, num_steps, device=device)
        base = base if base is not None else sps / n
        eff = sps / (n * base)
        rows.append({"n_devices": n, "steps_per_sec": sps, "efficiency": eff})
        if verbose:
            print(f"  n={n}: {sps / 1e6:9.3f}M steps/s  "
                  f"(weak-scaling efficiency {eff:5.1%})", flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("env_id", nargs="?", default="MiniGrid-DoorKey-8x8-v0")
    p.add_argument("--envs-per-device", type=int, default=4096)
    p.add_argument("--num-steps", type=int, default=1024)
    p.add_argument("--devices", default="1,2,4,8",
                   help="comma-separated rank counts to sweep")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda: a card per rank (NCCL); cpu: gloo ranks on the CPU")
    args = p.parse_args(argv)
    counts = [int(x) for x in args.devices.split(",")]
    print(f"{args.env_id}: {args.envs_per_device} envs/device x "
          f"{args.num_steps} steps on {args.device}")
    sweep(args.env_id, counts, args.envs_per_device, args.num_steps, device=args.device)


if __name__ == "__main__":
    main()
