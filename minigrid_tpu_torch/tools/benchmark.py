"""Perf micro-benchmark (re-derivation of minigrid/benchmark.py:12-63).

Counterpart of ``minigrid_tpu/tools/benchmark.py``.  Reports the reference's
three metrics — reset latency, full-render FPS and RGB-partial-obs step FPS,
each on one env — plus the batched one the reference has no analogue for:
env-steps/s of a ``VectorEnv`` with auto-reset.  Run on the card:

    python -m minigrid_tpu_torch.tools.benchmark [--env-name ID] \
        [--num-frames 5000] [--num-envs 4096] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import torch

from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.parallel.vector import VectorEnv
from minigrid_tpu_torch.tools import bench


def timed_rollout(venv: VectorEnv, num_steps: int, refill_period: int = 1,
                  seed: int = 0, unroll: int = 1, with_stats: bool = False):
    """(env-steps/s, first-run seconds): a rollout of random actions from
    the threefry twin, run twice, the second timed, by the port's timing
    protocol (:func:`minigrid_tpu_torch.tools.bench.fold` folds the rewards,
    episode ends and an observation checksum into one device scalar every
    step; the timer stops after it reaches the host).  The first run's
    seconds stand where the JAX package reports its compile.
    ``refill_period=K`` is :func:`~minigrid_tpu_torch.tools.bench.loop`: K
    consume-only steps, then K windows refilled (the pooled strategy only);
    ``refill_period=1`` steps ``venv.step`` with any strategy.  ``unroll`` is
    the JAX ``lax.scan`` knob, accepted and ignored.

    ``with_stats=True`` returns a third element from the timed run:
    ``resets`` (auto-resets served) and ``fresh_frac`` (the fraction served
    a never-used level; 1.0 for the strategies that always regenerate, None
    when no reset occurred)."""
    del unroll
    if refill_period > 1 and venv.reset_strategy != "pooled":
        raise ValueError("refill_period requires the pooled reset strategy")
    if num_steps % refill_period:
        raise ValueError(f"num_steps={num_steps} is not a multiple of "
                         f"refill_period={refill_period}")

    def run(s):
        key = rng.PRNGKey(s, venv.device)
        if refill_period > 1:
            return bench.run(venv, key, num_steps, refill_period)
        key, k_reset = rng.split(key).unbind(0)
        _, state = venv.reset(k_reset)
        return bench.loop_steps(venv, state, key=key, num_steps=num_steps)

    first_s, _ = bench._timed(lambda i: run(seed), 1)
    dt, state = bench._timed(lambda i: run(seed + 1), 1)
    sps = venv.num_envs * num_steps / dt
    if not with_stats:
        return sps, first_s
    stats = bench.ring_stats(venv, state)
    if "n_fresh" not in stats:
        # the other strategies regenerate on every reset: always fresh; they
        # count no resets (0, as the JAX package reports)
        return sps, first_s, {"resets": 0, "fresh_frac": 1.0}
    return sps, first_s, {"resets": stats["n_fresh"] + stats["n_stale"],
                          "fresh_frac": stats["fresh_frac"]}


def benchmark(env_id: str = "MiniGrid-LavaGapS7-v0", num_resets: int = 200,
              num_frames: int = 5000, tile_size: int = 32,
              num_envs: int = 4096, vector_steps: int = 256,
              reset_strategy: str | None = None,
              pool_refill: int | None = None,
              refill_period: int = 1,
              unroll: int = 1, device=None) -> dict:
    """The reference's three numbers on one env (a batch of one) and the
    batched env-steps/s, on ``device`` (CUDA unless named)."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.ops.render import get_atlas, get_frame, pov_render

    env = minigrid_tpu_torch.make(env_id)
    params = env.default_params
    dev = resolve_device(device)
    atlas = get_atlas(tile_size, dev)

    def one_key(i):
        return rng.PRNGKey(i, dev)[None]

    # --- reset latency (benchmark.py:15-21) --------------------------------
    obs, state = env.reset(one_key(0), params, dev)
    bench._sync(dev)
    t0 = time.perf_counter()
    for i in range(num_resets):
        obs, state = env.reset(one_key(i), params, dev)
    bench._sync(dev)
    reset_ms = (time.perf_counter() - t0) * 1000 / num_resets

    # --- full-render FPS (benchmark.py:23-28) ------------------------------
    get_frame(state, params, tile_size=tile_size)
    bench._sync(dev)
    t0 = time.perf_counter()
    for _ in range(num_frames):
        get_frame(state, params, tile_size=tile_size)
    bench._sync(dev)
    render_fps = num_frames / (time.perf_counter() - t0)

    # --- RGB-partial-obs step FPS (benchmark.py:30-42) ----------------------
    actions = [torch.full((1,), i % 3, dtype=torch.int32, device=dev)
               for i in range(3)]
    pov_render(state, params, atlas)
    bench._sync(dev)
    t0 = time.perf_counter()
    for i in range(num_frames):
        obs, state, r, te, tr, _ = env.step(state, actions[i % 3], params)
        pov_render(state, params, atlas)
    bench._sync(dev)
    rgb_step_fps = num_frames / (time.perf_counter() - t0)

    # --- vectorized env-steps/s (no reference analogue) ----------------------
    venv = VectorEnv(env, num_envs, params, reset_strategy=reset_strategy,
                     pool_refill=pool_refill, device=dev)
    vec_sps, _ = timed_rollout(venv, vector_steps, refill_period, unroll=unroll)

    return {
        "reset_ms": reset_ms,
        "render_fps": render_fps,
        "rgb_partial_step_fps": rgb_step_fps,
        "vector_env_steps_per_sec": vec_sps,
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--env-name", default="MiniGrid-LavaGapS7-v0")
    parser.add_argument("--num-resets", type=int, default=200)
    parser.add_argument("--num-frames", type=int, default=5000)
    parser.add_argument("--tile-size", type=int, default=32)
    parser.add_argument("--num-envs", type=int, default=4096)
    parser.add_argument("--reset-strategy", default=None,
                        choices=[None, "fused", "conditional", "pooled"])
    parser.add_argument("--pool-refill", type=int, default=None)
    parser.add_argument("--refill-period", type=int, default=1)
    parser.add_argument("--unroll", type=int, default=1)
    parser.add_argument("--device", default=None, help="'cpu' to run on the CPU")
    args = parser.parse_args(argv)
    out = benchmark(args.env_name, args.num_resets, args.num_frames,
                    args.tile_size, args.num_envs,
                    reset_strategy=args.reset_strategy,
                    pool_refill=args.pool_refill,
                    refill_period=args.refill_period,
                    unroll=args.unroll, device=args.device)
    print(f"reset time (ms)      : {out['reset_ms']:.1f}")
    print(f"full render FPS      : {out['render_fps']:.0f}")
    print(f"RGB partial step FPS : {out['rgb_partial_step_fps']:.0f}")
    print(f"vector env-steps/s   : {out['vector_env_steps_per_sec']:.0f}")


if __name__ == "__main__":
    main()
