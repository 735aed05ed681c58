"""Drive the PyTorch port on one CUDA card, check it, and time its kernel.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero without
printing a result:

1. require CUDA and print the card (name, power limit);
2. build every kernel from ``minigrid_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together) and print the build seconds;
3. hold each kernel bitwise against its plain PyTorch version on the card:
   the egocentric-window gather over every direction x pose on random grids,
   and on DoorKey-8x8 states at B=4096 after a random walk (with the whole
   observation checked against the CPU), plus a self-check that the compare
   catches a single flipped bit;
4. drive the main path: ``make_vec("MiniGrid-DoorKey-8x8-v0", 4096,
   reset_strategy="pooled", pool_refill=64)`` through the bench loop of
   ``minigrid_tpu_torch.tools.bench`` (bulk refill every 8 steps) past the
   first truncation wave, with every kernel's launch count zeroed just before
   and read just after; then the same program at B=16 on the card and on the
   CPU, which must agree bitwise step by step and in the final state;
5. time the kernel, its plain version and a one-call library yardstick
   (CUDA events over CUDA-graph replays, median), compute the kernel's bound,
   and time the port's env-steps/s.

It prints one JSON line of kernel records, then the card line as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives it,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

ENV_ID = "MiniGrid-DoorKey-8x8-v0"
NUM_ENVS = 4096
POOL_REFILL = 64
REFILL_PERIOD = 8
MAIN_STEPS = 648  # past DoorKey-8x8's 640-step truncation, a multiple of 8
VIEW = 7
SWEEP_SHAPES = ((8, 8, 7), (9, 5, 7), (6, 9, 5))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and int32 operations/s
# outside the tensor cores (half the 67 TFLOP/s float32 rate: 64 INT32 lanes
# per SM against 128 FP32).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype differ: {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    return int((a != b).sum())


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def gpu_time_ms(fn, per_graph: int = 20, reps: int = 60) -> float:
    """Device time of one ``fn()`` call: ``per_graph`` calls captured in a
    CUDA graph, each replay timed with CUDA events; median over ``reps``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)


# -- phase 3: kernel against plain ----------------------------------------------

def check_gather_sweep(dev, obs_gather) -> int:
    """Every direction x pose on random grids, for each (W, H, V); returns
    the largest |kernel - plain| (0 when bitwise equal)."""
    worst = 0
    gen = torch.Generator().manual_seed(0)
    for w, h, v in SWEEP_SHAPES:
        combos = [(x, y, d) for x in range(w) for y in range(h) for d in range(4)]
        pos = torch.tensor([(x, y) for x, y, _ in combos], dtype=torch.int32)
        dirs = torch.tensor([d for *_, d in combos], dtype=torch.int32)
        n = len(combos)
        cells = torch.stack([torch.randint(0, 34, (n, w, h), generator=gen),
                             torch.randint(0, 11, (n, w, h), generator=gen),
                             torch.randint(0, 3, (n, w, h), generator=gen)], -1)
        grid = (cells[..., 0] | cells[..., 1] << 8 | cells[..., 2] << 16).to(torch.int32)
        grid, pos, dirs = grid.to(dev), pos.to(dev), dirs.to(dev)
        got = obs_gather.gather_view(grid, pos, dirs, v)
        want = obs_gather.gather_view_plain(grid, pos, dirs, v)
        torch.cuda.synchronize()
        bad = mismatches(got, want)
        if bad:
            raise AssertionError(f"obs_gather kernel != plain for W,H,V={w},{h},{v}:"
                                 f" {bad} cells")
        worst = max(worst, max_abs_err(got, want))
        log(f"  sweep W={w} H={h} V={v}: {n} poses, bitwise equal")
    return worst


def doorkey_walk_states(dev, num_envs: int, steps: int = 24):
    """DoorKey-8x8 levels after a random walk (agents scattered over every
    direction, some carrying the key), on ``dev``."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng

    env = minigrid_tpu_torch.make(ENV_ID)
    params = env.default_params
    key = rng.PRNGKey(20260820, dev)
    k_gen, k_act = rng.split(key).unbind(0)
    state = env.generate(rng.split(k_gen, num_envs), params, dev)
    for k in rng.split(k_act, steps):
        action = rng.randint(k, (num_envs,), 0, env.num_actions)
        state = env.step_state(state, action, params)[0]
    return env, params, state


def check_gather_doorkey(dev, obs_gather) -> tuple[int, dict]:
    """Kernel vs plain on B=4096 DoorKey states; the whole observation on
    the card vs the same states on the CPU.  Returns (max error, inputs)."""
    from minigrid_tpu_torch.core.obs import gen_obs_batch
    from minigrid_tpu_torch.core.state import map_fields

    env, params, st = doorkey_walk_states(dev, NUM_ENVS)
    args = (st.grid, st.agent_pos, st.agent_dir, VIEW)
    got = obs_gather.gather_view(*args)
    want = obs_gather.gather_view_plain(*args)
    torch.cuda.synchronize()
    bad = mismatches(got, want)
    if bad:
        raise AssertionError(f"obs_gather kernel != plain on DoorKey states: {bad} cells")
    # self-check: the compare must see a single flipped bit
    flipped = got.clone()
    flipped.view(-1)[12345 % flipped.numel()] ^= 1
    if mismatches(flipped, want) != 1:
        raise AssertionError("the kernel compare missed a flipped bit")
    carrying = int((st.carrying[:, 0] != 1).sum())
    dirs = torch.bincount(st.agent_dir.long(), minlength=4).tolist()
    log(f"  DoorKey-8x8 B={NUM_ENVS}: bitwise equal; dirs {dirs}, "
        f"{carrying} envs carrying; flipped-bit self-check caught")
    obs_gpu = gen_obs_batch(st, params)
    obs_cpu = gen_obs_batch(map_fields(lambda x: x.cpu(), st), params)
    for k in obs_cpu:
        if mismatches(obs_gpu[k].cpu(), obs_cpu[k]):
            raise AssertionError(f"observation {k!r} on the card != on the CPU")
    log("  full observation (gather, occlusion, overlay, encode): card == CPU")
    return max_abs_err(got, want), {"grid": st.grid, "pos": st.agent_pos,
                                    "dir": st.agent_dir}


# -- phase 4: the main path -----------------------------------------------------

def drive_main_path(dev, counters: dict) -> dict:
    """The bench program at full width, counts zeroed just before and read
    just after; checks what comes out."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.tools import bench

    venv = minigrid_tpu_torch.make_vec(ENV_ID, NUM_ENVS, reset_strategy="pooled",
                                       pool_refill=POOL_REFILL, device=dev)
    last = {}

    def keep(obs, reward, term, trunc):
        last.update(obs=obs, reward=reward, term=term, trunc=trunc)

    torch.cuda.synchronize()
    for module in counters.values():
        module.LAUNCHES = 0
    t0 = time.perf_counter()
    acc, state = bench.run(venv, rng.PRNGKey(0, dev), MAIN_STEPS, REFILL_PERIOD,
                           on_step=keep)
    acc = float(acc)
    seconds = time.perf_counter() - t0
    launches = {name: module.LAUNCHES for name, module in counters.items()}

    image = last["obs"]["image"]
    if image.shape != (NUM_ENVS, VIEW, VIEW, 3) or image.dtype != torch.uint8:
        raise AssertionError(f"obs image {tuple(image.shape)} {image.dtype}")
    if not torch.isfinite(torch.tensor(acc)):
        raise AssertionError(f"checksum not finite: {acc}")
    if not bool(((image[..., 0] <= 33)).all()) or not bool(
            ((last["obs"]["direction"] >= 0) & (last["obs"]["direction"] < 4)).all()):
        raise AssertionError("observation fields out of range")
    if not bool(torch.isfinite(last["reward"]).all()):
        raise AssertionError("non-finite reward")
    n_fresh, n_stale = int(state.n_fresh), int(state.n_stale)
    served = n_fresh + n_stale
    if served < NUM_ENVS:  # every env truncates at step 640
        raise AssertionError(f"only {served} auto-resets served in {MAIN_STEPS} steps")
    expected = MAIN_STEPS + 1  # one observation per step, one at reset
    if launches["obs_gather"] != expected:
        raise AssertionError(f"obs_gather launched {launches['obs_gather']} times, "
                             f"expected {expected}")
    log(f"  {ENV_ID} B={NUM_ENVS} pooled {POOL_REFILL}/{REFILL_PERIOD}: "
        f"{MAIN_STEPS} steps in {seconds:.3f} s (first run, unwarmed), "
        f"launches {launches}, auto-resets fresh {n_fresh} stale {n_stale} "
        f"(fresh fraction {n_fresh / served}), checksum {acc}")
    return {"launches": launches, "fresh_frac": n_fresh / served,
            "n_fresh": n_fresh, "n_stale": n_stale}


def card_matches_cpu(dev) -> None:
    """The same pooled program at B=16 on the card and on the CPU: per-step
    obs, reward, terminated, truncated and the final PooledState agree
    bitwise.  max_steps=3 with 4-slot windows refilled every 4 steps, so envs
    finish, consume fresh levels and replay stale ones."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.tools import bench
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    runs = {}
    for d in (dev, torch.device("cpu")):
        venv = minigrid_tpu_torch.make_vec(ENV_ID, 16, reset_strategy="pooled",
                                           pool_refill=4, device=d, max_steps=3)
        steps = []
        _, state = bench.run(
            venv, rng.PRNGKey(7, d), 32, 4,
            on_step=lambda obs, r, te, tr: steps.append(
                [obs["image"].cpu(), obs["direction"].cpu(), obs["mission"].cpu(),
                 r.cpu(), te.cpu(), tr.cpu()]))
        runs[d.type] = (steps, state_to_numpy(state))
    (g_steps, g_state), (c_steps, c_state) = runs["cuda"], runs["cpu"]
    for t, (g, c) in enumerate(zip(g_steps, c_steps)):
        for name, a, b in zip(("image", "direction", "mission", "reward",
                               "terminated", "truncated"), g, c):
            if mismatches(a, b):
                raise AssertionError(f"B=16 step {t}: {name} differs card vs CPU")

    def same(a, b, where=""):
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k], f"{where}{k}.")
            elif (a[k] is None) != (b[k] is None) or (
                    a[k] is not None and not (a[k] == b[k]).all()):
                raise AssertionError(f"B=16 final state {where}{k} differs card vs CPU")

    same(g_state, c_state)
    log(f"  B=16, 32 steps: card == CPU bitwise (n_fresh {int(g_state['n_fresh'])}, "
        f"n_stale {int(g_state['n_stale'])})")
    # a random walk seldom reaches the goal: hold the reward formula itself
    from minigrid_tpu_torch.core.step import goal_reward

    limits = torch.tensor([12.0, 100.0, 250.0, 360.0, 640.0, 2560.0])
    count = torch.arange(1, 2561, dtype=torch.int32).repeat(len(limits))
    limit = limits.repeat_interleave(2560)
    if mismatches(goal_reward(count.to(dev), limit.to(dev)).cpu(),
                  goal_reward(count, limit)):
        raise AssertionError("goal reward differs card vs CPU")
    log(f"  goal reward: card == CPU bitwise over {count.numel()} (step, limit) pairs")


# -- phase 5: times ---------------------------------------------------------------

def gather_bound_ms(inputs: dict) -> tuple[float, str, dict]:
    """Least time for the window gather on these inputs: the larger of the
    bytes it must move (pose read, in-bounds window words read, window
    written) over HBM bandwidth and its integer operations over the int32
    rate."""
    from minigrid_tpu_torch.core.obs import view_world_coords

    grid, pos, dirs = inputs["grid"], inputs["pos"], inputs["dir"]
    b, w, h = grid.shape
    wx, wy = view_world_coords(pos, dirs, VIEW)
    in_bounds = int(((wx >= 0) & (wx < w) & (wy >= 0) & (wy < h)).sum())
    nbytes = b * (2 * 4 + 4) + in_bounds * 4 + b * VIEW * VIEW * 4
    # per view cell: direction selects (4), two coordinates (6), bounds (4),
    # address (2), select (1)
    ops = b * VIEW * VIEW * 17
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), bound_by, {"bytes": nbytes, "int_ops": ops,
                                           "in_bounds_cells": in_bounds}


def time_gather(obs_gather, inputs: dict) -> dict:
    from minigrid_tpu_torch.core.obs import view_world_coords

    grid, pos, dirs = inputs["grid"], inputs["pos"], inputs["dir"]
    b, w, h = grid.shape
    kernel_ms = gpu_time_ms(lambda: obs_gather.gather_view(grid, pos, dirs, VIEW))
    plain_ms = gpu_time_ms(lambda: obs_gather.gather_view_plain(grid, pos, dirs, VIEW))
    # library yardstick: one torch.gather over precomputed flat indices into
    # the grid with a grey-wall word appended per env for out-of-bounds cells
    wx, wy = view_world_coords(pos, dirs, VIEW)
    oob = (wx < 0) | (wx >= w) | (wy < 0) | (wy >= h)
    flat = torch.where(oob, w * h, wx * h + wy).reshape(b, VIEW * VIEW).long()
    padded = torch.cat([grid.reshape(b, w * h),
                        torch.full((b, 1), obs_gather.WALL_PACKED, dtype=torch.int32,
                                   device=grid.device)], dim=1)
    lib = torch.gather(padded, 1, flat).reshape(b, VIEW, VIEW)
    if mismatches(lib, obs_gather.gather_view_plain(grid, pos, dirs, VIEW)):
        raise AssertionError("the library yardstick computes another function")
    library_ms = gpu_time_ms(lambda: torch.gather(padded, 1, flat))
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on a card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("phase 1: card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"  {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.device_count()} device(s)")

    from minigrid_tpu_torch.ops import _build, obs_gather

    log("phase 2: build")
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"  built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  [{name}] {line.strip()}")
    counters = {"obs_gather": obs_gather}

    log("phase 3: kernels against their plain versions on the card")
    err = check_gather_sweep(dev, obs_gather)
    err_dk, inputs = check_gather_doorkey(dev, obs_gather)
    err = max(err, err_dk)

    log("phase 4: the main path")
    main = drive_main_path(dev, counters)
    card_matches_cpu(dev)

    log("phase 5: times")
    times = time_gather(obs_gather, inputs)
    bound_ms, bound_by, work = gather_bound_ms(inputs)
    log(f"  obs_gather B={NUM_ENVS} 8x8 V={VIEW}: kernel {times['ms'] * 1e3:.2f} us, "
        f"plain {times['plain_ms'] * 1e3:.2f} us, torch.gather "
        f"{times['library_ms'] * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us "
        f"({bound_by}; {work}) [{card}]")

    from minigrid_tpu_torch.tools import bench

    venv = bench.make_venv(dev)
    rate = bench.measure(venv, MAIN_STEPS)
    log(f"  port {ENV_ID} B={NUM_ENVS} pooled {POOL_REFILL}/{REFILL_PERIOD}: "
        f"{rate['env_steps_per_sec']:.0f} env-steps/s, "
        f"{rate['us_per_step']:.1f} us/step over {MAIN_STEPS} steps, "
        f"fresh fraction {rate['fresh_frac']} [{card}]")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "obs_gather",
        "route": "cuda",
        "source": "minigrid_tpu_torch/csrc/obs_gather.cu",
        "replaces": "minigrid_tpu/ops/obs_pallas.py:83",
        "launches": main["launches"]["obs_gather"],
        "max_abs_err": err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": times["library_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
