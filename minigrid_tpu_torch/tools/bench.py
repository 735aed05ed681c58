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

``--fused`` times the same envs, actions and checksum through
``FusedVectorEnv`` instead, whose step is one kernel launch with the
auto-reset (regeneration from the env's own generator) fused in.  With
``--predrawn`` (always on with ``--fused``) the actions of the whole run come
from one ``randint`` over ``[T, B]`` drawn before the timer starts, so the
two engines compare like with like.

``--env ID`` times another registered env instead (any registered id: a
MiniGrid, a BabyAI or a dataset env, whose action count, 1 for Blocks or 4
for Directions, the random actions follow), through ``VectorEnv.step`` with
the reset strategy and refill window
the family picks by default (a pooled family refills one window a step,
BabyAI best-effort: one unvalidated draw a slot), the actions predrawn; the
strategy, the refill window and the ring's fresh fraction print beside the
rate, with ``--profile N`` too.

Prints one JSON line.  Run on the card:

    python -m minigrid_tpu_torch.tools.bench [--steps 4096] [--predrawn]
    python -m minigrid_tpu_torch.tools.bench --fused [--steps 4096]
    python -m minigrid_tpu_torch.tools.bench [--fused] --profile 64
    python -m minigrid_tpu_torch.tools.bench --env MiniGrid-MultiRoom-N6-v0 \
        [--steps 256 | --profile 16]
    python -m minigrid_tpu_torch.tools.bench --env BabyAI-GoTo-v0 [--profile 4]

``--profile N`` traces N steady-state steps with ``torch.profiler`` instead
and prints where the time goes: kernel launches and top-level torch ops per
step (with ``--env ID --device cpu`` the ops count on the CPU), device busy
time
against wall time, the kernels that take the most device time, and (pooled
engine) each layer of the step run on its own (host-synced µs and launches
per step).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

import minigrid_tpu_torch
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.ops.fused_step import FusedVectorEnv
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


def make_fused(device=None) -> FusedVectorEnv:
    return FusedVectorEnv(minigrid_tpu_torch.make(ENV_ID), NUM_ENVS, device=device)


def draw_actions(key: torch.Tensor, num_steps: int, num_envs: int,
                 num_actions: int) -> torch.Tensor:
    """The actions of a whole run, int32[T, B], in one ``randint``."""
    return rng.randint(key, (num_steps, num_envs), 0, num_actions)


def fold(acc: torch.Tensor, obs, reward: torch.Tensor, term: torch.Tensor,
         trunc: torch.Tensor) -> torch.Tensor:
    """One step into the running checksum: the whole observation (a tensor,
    or a dict of them), the rewards and the episode ends."""
    leaves = obs.values() if isinstance(obs, dict) else (obs,)
    chk = sum(leaf.to(torch.float32).sum() for leaf in leaves)
    return acc + (reward.sum() + chk + (term | trunc).sum().to(torch.float32))


def run(venv: VectorEnv, key: torch.Tensor, num_steps: int,
        refill_period: int = REFILL_PERIOD, on_step=None,
        actions: torch.Tensor | None = None) -> tuple[torch.Tensor, PooledState]:
    """Reset, then ``num_steps`` consume-only steps with a bulk refill every
    ``refill_period``.  Returns (running checksum scalar on the device,
    final state).  ``on_step(obs, reward, terminated, truncated)`` sees every
    step when given."""
    key, k_reset = rng.split(key.to(venv.device)).unbind(0)
    _, state = venv.reset(k_reset)
    return loop(venv, state, key, num_steps, refill_period, on_step, actions)


def loop(venv: VectorEnv, state: PooledState, key: torch.Tensor, num_steps: int,
         refill_period: int = REFILL_PERIOD, on_step=None,
         actions: torch.Tensor | None = None) -> tuple[torch.Tensor, PooledState]:
    """The timed body of :func:`run`, from a given state: ``num_steps``
    steps with actions drawn from ``split(key, num_steps)``, or read from
    ``actions`` int32[T, B] when given."""
    if num_steps % refill_period:
        raise ValueError("num_steps must be a multiple of refill_period")
    acc = torch.zeros((), dtype=torch.float32, device=venv.device)
    for t, action in enumerate(_action_rows(venv, key, num_steps, actions)):
        obs, state, reward, term, trunc, _ = venv.step_nofill(state, action)
        acc = fold(acc, obs, reward, term, trunc)
        if on_step is not None:
            on_step(obs, reward, term, trunc)
        if (t + 1) % refill_period == 0:
            state = venv.refill(state, refill_period)
    return acc, state


def run_fused(fvenv: FusedVectorEnv, key: torch.Tensor, actions: torch.Tensor,
              on_step=None) -> tuple[torch.Tensor, dict]:
    """Reset, then one fused step per row of ``actions`` int32[T, B], with
    the same checksum fold as :func:`loop`.  Returns (checksum, final
    planes)."""
    _, fs = fvenv.reset(key.to(fvenv.device))
    return loop_fused(fvenv, fs, actions, on_step)


def loop_fused(fvenv: FusedVectorEnv, fs: dict, actions: torch.Tensor,
               on_step=None) -> tuple[torch.Tensor, dict]:
    """The timed body of :func:`run_fused`, from given planes."""
    acc = torch.zeros((), dtype=torch.float32, device=fvenv.device)
    for action in actions:
        obs, fs, reward, term, trunc, _ = fvenv.step(fs, action)
        acc = fold(acc, obs, reward, term, trunc)
        if on_step is not None:
            on_step(obs, reward, term, trunc)
    return acc, fs


def loop_steps(venv: VectorEnv, state, actions: torch.Tensor | None = None,
               on_step=None, key: torch.Tensor | None = None,
               num_steps: int | None = None) -> tuple[torch.Tensor, object]:
    """One ``venv.step`` (any reset strategy) per row of ``actions``
    int32[T, B], or without ``actions`` ``num_steps`` steps with actions
    drawn from ``key`` as :func:`loop` draws them, folding the checksum of
    :func:`loop`.  Returns (checksum, final state)."""
    acc = torch.zeros((), dtype=torch.float32, device=venv.device)
    for action in _action_rows(venv, key, num_steps, actions):
        obs, state, reward, term, trunc, _ = venv.step(state, action)
        acc = fold(acc, obs, reward, term, trunc)
        if on_step is not None:
            on_step(obs, reward, term, trunc)
    return acc, state


def _action_rows(venv: VectorEnv, key: torch.Tensor | None, num_steps: int | None,
                 actions: torch.Tensor | None):
    """Each step's actions int32[B]: the rows of ``actions`` when given,
    else one ``randint`` a step from ``split(key, num_steps)``."""
    if actions is not None:
        yield from actions
        return
    for k in rng.split(key, num_steps):
        yield rng.randint(k, (venv.num_envs,), 0, venv.env.num_actions)


def ring_stats(venv: VectorEnv, state) -> dict:
    """The strategy and refill window, and for a pooled ring the auto-resets
    it served fresh and stale and the fresh fraction."""
    out = {"strategy": venv.reset_strategy, "pool_refill": venv.pool_refill}
    if isinstance(state, PooledState):
        n_fresh, n_stale = int(state.n_fresh), int(state.n_stale)
        out.update(n_fresh=n_fresh, n_stale=n_stale,
                   fresh_frac=n_fresh / (n_fresh + n_stale) if n_fresh + n_stale else None)
    return out


def measure_steps(venv: VectorEnv, num_steps: int, reps: int = 2) -> dict:
    """Env-steps/s of :func:`loop_steps`, actions predrawn: the reset and
    the action draw of each rep happen before its timer starts; best of
    ``reps``."""
    _, state = venv.reset(rng.PRNGKey(0, venv.device))
    float(loop_steps(venv, state, _predrawn(venv, 4, 1)[0])[0])  # warm up
    best = None
    for i, actions in enumerate(_predrawn(venv, num_steps, reps)):
        _, state = venv.reset(rng.PRNGKey(i + 1, venv.device))
        _sync(venv.device)
        t0 = time.perf_counter()
        acc, state = loop_steps(venv, state, actions)
        float(acc)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return {**_rate(venv.num_envs, num_steps, best), "predrawn": True,
            **ring_stats(venv, state)}


def _timed(fn, reps: int) -> tuple[float, object]:
    """Best of ``reps`` host-timed runs of ``fn(i)``, which returns
    (checksum, result): -> (seconds, the last result).  Each timer stops
    after its checksum reaches the host."""
    best, out = None, None
    for i in range(reps):
        t0 = time.perf_counter()
        acc, out = fn(i)
        float(acc)  # host fetch: the run is over when this returns
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best, out


def _rate(num_envs: int, num_steps: int, seconds: float) -> dict:
    return {"env_steps_per_sec": num_envs * num_steps / seconds,
            "us_per_step": seconds / num_steps * 1e6, "seconds": seconds,
            "num_envs": num_envs, "num_steps": num_steps}


def _predrawn(venv, num_steps: int, reps: int) -> list[torch.Tensor]:
    """One ``[T, B]`` action draw per rep, made and synced before timing."""
    out = [draw_actions(rng.PRNGKey(1000 + i, venv.device), num_steps,
                        venv.num_envs, venv.env.num_actions) for i in range(reps)]
    _sync(venv.device)
    return out


def measure(venv: VectorEnv, num_steps: int, reps: int = 2,
            predrawn: bool = False) -> dict:
    """Warm up, then time ``reps`` runs; the best one counts.  With
    ``predrawn`` each run's actions are drawn before its timer starts."""
    float(run(venv, rng.PRNGKey(0, venv.device), 2 * REFILL_PERIOD)[0])
    actions = _predrawn(venv, num_steps, reps) if predrawn else [None] * reps
    best, state = _timed(lambda i: run(venv, rng.PRNGKey(i + 1, venv.device),
                                       num_steps, actions=actions[i]), reps)
    n_fresh, n_stale = int(state.n_fresh), int(state.n_stale)
    served = n_fresh + n_stale
    return {**_rate(venv.num_envs, num_steps, best), "predrawn": predrawn,
            "n_fresh": n_fresh, "n_stale": n_stale,
            "fresh_frac": n_fresh / served if served else None}


def measure_fused(fvenv: FusedVectorEnv, num_steps: int, reps: int = 2) -> dict:
    """:func:`measure` for the fused engine, actions always predrawn.  Every
    auto-reset there is a fresh level from the env's generator."""
    warm = _predrawn(fvenv, 2 * REFILL_PERIOD, 1)[0]
    float(run_fused(fvenv, rng.PRNGKey(0, fvenv.device), warm)[0])
    actions = _predrawn(fvenv, num_steps, reps)
    best, _ = _timed(lambda i: run_fused(fvenv, rng.PRNGKey(i + 1, fvenv.device),
                                         actions[i]), reps)
    return {**_rate(fvenv.num_envs, num_steps, best), "predrawn": True,
            "fresh_frac": 1.0}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# the runtime and driver calls that launch a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def _launches(prof, averages=None) -> int:
    """Kernel launches in a trace (``averages``: its ``key_averages()``, if
    already made: summarising a long trace takes seconds)."""
    averages = prof.key_averages() if averages is None else averages
    return sum(e.count for e in averages if e.key in LAUNCH_CALLS)


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


def record(body):
    """Run ``body()`` (work ending in a host fetch) under ``torch.profiler``
    with CPU and CUDA activity: (the profile, the wall seconds of ``body``)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        body()
        wall = time.perf_counter() - t0
    return prof, wall


def _trace(body, num_steps: int, top: int) -> dict:
    """Run ``body()`` (``num_steps`` steps ending in a host fetch) under
    :func:`record` and summarise the device's side of it."""
    prof, wall = record(body)
    averages = prof.key_averages()
    kernels, launches = [], _launches(prof, averages)
    for e in averages:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels.append((us, e.count, e.key))
    kernels.sort(reverse=True)
    busy_us = sum(us for us, _, _ in kernels)
    # the torch ops the host issued (top-level ATen calls): launches on a
    # card, and the stand-in for them on the CPU
    torch_ops = sum(1 for e in prof.events()
                    if e.cpu_parent is None and e.name.startswith("aten::"))
    return {
        "num_steps": num_steps,
        "wall_us_per_step": wall / num_steps * 1e6,
        "device_busy_us_per_step": busy_us / num_steps,
        "device_idle_share": 1 - busy_us / (wall * 1e6),
        "launches_per_step": launches / num_steps,
        "torch_ops_per_step": torch_ops / num_steps,
        "device_ops_per_step": sum(n for _, n, _ in kernels) / num_steps,
        "top_kernels": [{"name": name[:120], "us_per_step": us / num_steps,
                         "calls_per_step": n / num_steps}
                        for us, n, name in kernels[:top]],
    }


def profile(venv: VectorEnv, num_steps: int, top: int = 15) -> dict:
    """Trace ``num_steps`` steady-state steps (reset and a warm-up block
    outside the trace) and summarise the device's side of them."""
    key = rng.PRNGKey(0, venv.device)
    k_reset, k_warm, k_run = rng.split(key, 3).unbind(0)
    _, state = venv.reset(k_reset)
    acc, state = loop(venv, state, k_warm, 2 * REFILL_PERIOD)
    float(acc)

    def body():
        nonlocal state
        acc, state = loop(venv, state, k_run, num_steps)
        float(acc)

    out = _trace(body, num_steps, top)
    return {"num_envs": venv.num_envs, **out,
            "layers": _layers(venv, state, k_run)}


def profile_fused(fvenv: FusedVectorEnv, num_steps: int, top: int = 15) -> dict:
    """:func:`profile` for the fused engine: reset and a warm-up block
    outside the trace, then ``num_steps`` predrawn steps traced."""
    warm, actions = (_predrawn(fvenv, t, 1)[0] for t in (2 * REFILL_PERIOD, num_steps))
    acc, fs = run_fused(fvenv, rng.PRNGKey(0, fvenv.device), warm)
    float(acc)

    def body():
        float(loop_fused(fvenv, fs, actions)[0])

    return {"num_envs": fvenv.num_envs, **_trace(body, num_steps, top)}


def profile_steps(venv: VectorEnv, num_steps: int, top: int = 15) -> dict:
    """:func:`profile` for :func:`loop_steps` (any reset strategy): reset
    and a warm-up block outside the trace, then ``num_steps`` predrawn steps
    traced."""
    warm, actions = (_predrawn(venv, t, 1)[0] for t in (4, num_steps))
    _, state = venv.reset(rng.PRNGKey(0, venv.device))
    acc, state = loop_steps(venv, state, warm)
    float(acc)

    def body():
        nonlocal state
        acc, state = loop_steps(venv, state, actions)
        float(acc)

    out = _trace(body, num_steps, top)
    return {"num_envs": venv.num_envs, **out, **ring_stats(venv, state)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=NUM_STEPS)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace N steady-state steps instead of timing")
    ap.add_argument("--fused", action="store_true",
                    help="time FusedVectorEnv (one kernel a step) instead")
    ap.add_argument("--predrawn", action="store_true",
                    help="draw each run's actions before its timer starts")
    ap.add_argument("--env", metavar="ID",
                    help="time this env id through VectorEnv.step, default strategy")
    ap.add_argument("--num-envs", type=int, default=NUM_ENVS,
                    help="with --env: the batch (default %(default)s)")
    ap.add_argument("--pool-refill", type=int, default=None,
                    help="with --env: the refill window (default: the family's)")
    ap.add_argument("--device", default=None,
                    help="with --env: 'cpu' to count a step's torch ops on the CPU")
    args = ap.parse_args(argv)
    if args.env:
        venv = minigrid_tpu_torch.make_vec(args.env, args.num_envs,
                                           pool_refill=args.pool_refill,
                                           device=args.device)
        where = card() if venv.device.type == "cuda" else {"kind": "cpu"}
        if args.profile:
            print(json.dumps({"env": args.env, **profile_steps(venv, args.profile),
                              "device": where}))
            return
        result = measure_steps(venv, args.steps)
        print(json.dumps({
            "metric": f"env_steps_per_sec ({args.num_envs} envs, {args.env}, "
                      f"{venv.reset_strategy} auto-reset, PyTorch port)",
            "value": result["env_steps_per_sec"], "unit": "steps/s", **result,
            "device": where}))
        return
    if args.fused:
        fvenv = make_fused()
        if args.profile:
            print(json.dumps({**profile_fused(fvenv, args.profile), "device": card()}))
            return
        result, engine = measure_fused(fvenv, args.steps), "fused step kernel"
    else:
        venv = make_venv()
        if args.profile:
            print(json.dumps({**profile(venv, args.profile), "device": card()}))
            return
        result, engine = measure(venv, args.steps, predrawn=args.predrawn), "pooled"
    print(json.dumps({
        "metric": f"env_steps_per_sec ({NUM_ENVS} envs, DoorKey-8x8, "
                  f"{engine} auto-reset, PyTorch port)",
        "value": result["env_steps_per_sec"],
        "unit": "steps/s",
        **result,
        "device": card(),
    }))


if __name__ == "__main__":
    main()
