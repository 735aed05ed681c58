"""Headline benchmark of the port: aggregate env-steps/s, DoorKey-8x8.

The port's copy of the root ``bench.py`` program: 4096 lockstep envs with
auto-reset from the pooled level ring (``pool_refill=64``, one bulk refill
every 8 steps), random actions drawn from the threefry twin, and the symbolic
7x7 observation made every step.  Timing protocol (PERF.md):

* the obs checksum, reward sum and episode-end count fold into ONE running
  device scalar every step, so the observation is consumed, and no [T, B]
  trace is kept;
* the timer stops after that scalar is fetched to the host;
* the fresh fraction of served auto-resets is reported beside the rate.

Prints one JSON line.  Run on the card:

    python -m minigrid_tpu_torch.tools.bench [--steps 4096]
    python -m minigrid_tpu_torch.tools.bench --profile 64

``--profile N`` traces N steady-state steps with ``torch.profiler`` instead
and prints where the time goes: kernel launches per step, device busy time
against wall time, the kernels that take the most device time, and each
layer of the step run on its own (host-synced µs and launches per step).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

import minigrid_tpu_torch
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.parallel.vector import PooledState, VectorEnv

ENV_ID = "MiniGrid-DoorKey-8x8-v0"
NUM_ENVS = 4096
NUM_STEPS = 4096
POOL_REFILL = 64
REFILL_PERIOD = 8


def card() -> dict:
    """The card's name, count and power limit as nvidia-smi reports them."""
    query = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": query}


def make_venv(device=None) -> VectorEnv:
    return minigrid_tpu_torch.make_vec(
        ENV_ID, NUM_ENVS, reset_strategy="pooled", pool_refill=POOL_REFILL,
        device=device)


def run(venv: VectorEnv, key: torch.Tensor, num_steps: int,
        refill_period: int = REFILL_PERIOD, on_step=None
        ) -> tuple[torch.Tensor, PooledState]:
    """Reset, then ``num_steps`` consume-only steps with a bulk refill every
    ``refill_period``.  Returns (running checksum scalar on the device,
    final state).  ``on_step(obs, reward, terminated, truncated)`` sees every
    step when given."""
    key, k_reset = rng.split(key.to(venv.device)).unbind(0)
    _, state = venv.reset(k_reset)
    return loop(venv, state, key, num_steps, refill_period, on_step)


def loop(venv: VectorEnv, state: PooledState, key: torch.Tensor, num_steps: int,
         refill_period: int = REFILL_PERIOD, on_step=None
         ) -> tuple[torch.Tensor, PooledState]:
    """The timed body of :func:`run`, from a given state: ``num_steps``
    steps with actions drawn from ``split(key, num_steps)``."""
    if num_steps % refill_period:
        raise ValueError("num_steps must be a multiple of refill_period")
    keys = rng.split(key, num_steps).view(
        num_steps // refill_period, refill_period, 2)
    acc = torch.zeros((), dtype=torch.float32, device=venv.device)
    for block in keys:
        for k in block:
            action = rng.randint(k, (venv.num_envs,), 0, venv.env.num_actions)
            obs, state, reward, term, trunc, _ = venv.step_nofill(state, action)
            chk = sum(leaf.to(torch.float32).sum() for leaf in obs.values())
            acc += reward.sum() + chk + (term | trunc).sum().to(torch.float32)
            if on_step is not None:
                on_step(obs, reward, term, trunc)
        state = venv.refill(state, refill_period)
    return acc, state


def measure(venv: VectorEnv, num_steps: int, reps: int = 2) -> dict:
    """Warm up, then time ``reps`` runs; the best one counts."""
    float(run(venv, rng.PRNGKey(0, venv.device), 2 * REFILL_PERIOD)[0])
    best, state = None, None
    for i in range(reps):
        t0 = time.perf_counter()
        acc, state = run(venv, rng.PRNGKey(i + 1, venv.device), num_steps)
        float(acc)  # host fetch: the run is over when this returns
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    n_fresh, n_stale = int(state.n_fresh), int(state.n_stale)
    served = n_fresh + n_stale
    return {
        "env_steps_per_sec": venv.num_envs * num_steps / best,
        "us_per_step": best / num_steps * 1e6,
        "seconds": best,
        "num_envs": venv.num_envs,
        "num_steps": num_steps,
        "n_fresh": n_fresh,
        "n_stale": n_stale,
        "fresh_frac": n_fresh / served if served else None,
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches(prof) -> int:
    return sum(e.count for e in prof.key_averages() if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))


def _layers(venv: VectorEnv, state: PooledState, key: torch.Tensor,
            reps: int = 20) -> dict:
    """Each layer of one steady-state step, run on its own: host-synced µs
    and kernel launches per env-step (the refill divided by the period it
    serves)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    b, n_act = venv.num_envs, venv.env.num_actions
    action = rng.randint(key, (b,), 0, n_act)
    nxt, _, term, trunc = venv._step_envs(state.envs, action)
    done = term | trunc
    envs = venv._consume(state.pool, state.fresh, nxt, done)[0]
    obs = venv._obs(envs)
    parts = {
        "actions": (lambda: rng.randint(key, (b,), 0, n_act), 1),
        "step_state": (lambda: venv._step_envs(state.envs, action), 1),
        "consume": (lambda: venv._consume(state.pool, state.fresh, nxt, done), 1),
        "observation": (lambda: venv._obs(envs), 1),
        "checksum": (lambda: sum(x.to(torch.float32).sum() for x in obs.values()), 1),
        "refill": (lambda: venv.refill(state, REFILL_PERIOD), REFILL_PERIOD),
    }
    out = {}
    for name, (fn, per_steps) in parts.items():
        fn()
        _sync(venv.device)
        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            _sync(venv.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(venv.device)
        out[name] = {
            "us_per_step": (time.perf_counter() - t0) / reps / per_steps * 1e6,
            "launches_per_step": _launches(prof) / per_steps,
        }
    return out


def profile(venv: VectorEnv, num_steps: int, top: int = 15) -> dict:
    """Trace ``num_steps`` steady-state steps (reset and a warm-up block
    outside the trace) and summarise the device's side of them."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    key = rng.PRNGKey(0, venv.device)
    k_reset, k_warm, k_run = rng.split(key, 3).unbind(0)
    _, state = venv.reset(k_reset)
    acc, state = loop(venv, state, k_warm, 2 * REFILL_PERIOD)
    float(acc)
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        acc, state = loop(venv, state, k_run, num_steps)
        float(acc)
        wall = time.perf_counter() - t0
    kernels, launches = [], _launches(prof)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels.append((us, e.count, e.key))
    kernels.sort(reverse=True)
    busy_us = sum(us for us, _, _ in kernels)
    return {
        "num_envs": venv.num_envs,
        "num_steps": num_steps,
        "wall_us_per_step": wall / num_steps * 1e6,
        "device_busy_us_per_step": busy_us / num_steps,
        "device_idle_share": 1 - busy_us / (wall * 1e6),
        "launches_per_step": launches / num_steps,
        "device_ops_per_step": sum(n for _, n, _ in kernels) / num_steps,
        "top_kernels": [{"name": name[:120], "us_per_step": us / num_steps,
                         "calls_per_step": n / num_steps}
                        for us, n, name in kernels[:top]],
        "layers": _layers(venv, state, k_run),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=NUM_STEPS)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace N steady-state steps instead of timing")
    args = ap.parse_args(argv)
    venv = make_venv()
    if args.profile:
        print(json.dumps({**profile(venv, args.profile), "device": card()}))
        return
    result = measure(venv, args.steps)
    print(json.dumps({
        "metric": f"env_steps_per_sec ({NUM_ENVS} envs, DoorKey-8x8, "
                  "pooled auto-reset, PyTorch port)",
        "value": result["env_steps_per_sec"],
        "unit": "steps/s",
        **result,
        "device": card(),
    }))


if __name__ == "__main__":
    main()
