"""Bench battery: time a list of env/vector configurations on one device and
print one JSON line per configuration.

Counterpart of ``minigrid_tpu/tools/battery.py``, with its SPEC grammar::

    python -m minigrid_tpu_torch.tools.battery SPEC [SPEC ...]

    SPEC = env_id[:key=val,...]
    keys = num_envs, steps, strategy, refill, strict, period, unroll,
           obs (symbolic|rgb|rgb_chw), tile (rgb tile size, default 8 — the
           reference RGBImgPartialObsWrapper default, wrappers.py:195),
           device (cuda unless named)

``unroll`` is the JAX package's ``lax.scan`` knob: accepted and ignored (the
port's rollout is eager), so the rows do not print it.

Examples::

    python -m minigrid_tpu_torch.tools.battery MiniGrid-DoorKey-8x8-v0
    python -m minigrid_tpu_torch.tools.battery \
        "MiniGrid-DoorKey-8x8-v0:obs=rgb_chw,steps=256"

Each row is :func:`minigrid_tpu_torch.tools.benchmark.timed_rollout` of a
``VectorEnv``; ``obs=rgb`` wraps the env in ``RGBImgPartialObsWrapper``
(HWC frames), ``obs=rgb_chw`` the same with ``channels_first``.  Before any
row, :func:`device_kernel_gate` holds the ``obs_gather`` kernel against its
plain version on the card, and refuses to time a wrong program.
"""

from __future__ import annotations

import json
import sys

import torch

import minigrid_tpu_torch
from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.parallel.vector import VectorEnv
from minigrid_tpu_torch.tools.benchmark import timed_rollout
from minigrid_tpu_torch.utils import trace


def gather_impl(device: torch.device) -> str:
    """What computes the observation's window gather on ``device``."""
    if device.type == "cuda":
        return "cuda:minigrid_tpu_torch/csrc/obs_gather.cu"
    return "plain:ops/obs_gather.py::gather_view_plain"


def device_kernel_gate(env_id: str = "MiniGrid-DoorKey-8x8-v0",
                       num_envs: int = 4096, device=None) -> bool:
    """One batch of walked states through the ``obs_gather`` kernel and its
    plain version on the card; raises on any mismatch or when the kernel did
    not launch.  Returns False (nothing to gate) off the card."""
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.ops import obs_gather

    dev = resolve_device(device)
    if dev.type != "cuda":
        return False
    env = minigrid_tpu_torch.make(env_id)
    params = env.default_params
    k_gen, k_act = rng.split(rng.PRNGKey(20260820, dev)).unbind(0)
    states = env.generate(rng.split(k_gen, num_envs), params, dev)
    # scatter the agents over every direction and pose, edges included
    for k in rng.split(k_act, 6):
        states = env.step_state(states, rng.randint(k, (num_envs,), 0, env.num_actions),
                                params)[0]
    args = (states.grid, states.agent_pos, states.agent_dir, params.agent_view_size)
    before = trace.launches("obs_gather")
    got = obs_gather.gather_view(*args)
    want = obs_gather.gather_view_plain(*args)
    if trace.launches("obs_gather") != before + 1:
        raise AssertionError("the obs_gather kernel did not launch; refusing to bench")
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"the obs_gather kernel disagrees with its plain version "
                             f"on this card ({bad} cells); refusing to bench")
    return True


def run_spec(spec: str) -> dict:
    if ":" in spec:
        env_id, opts_s = spec.split(":", 1)
        opts = dict(kv.split("=") for kv in opts_s.split(","))
    else:
        env_id, opts = spec, {}
    num_envs = int(opts.get("num_envs", 4096))
    steps = int(opts.get("steps", 4096))
    period = int(opts.get("period", 1))
    strategy = opts.get("strategy")
    strict = bool(int(opts.get("strict", 0)))
    refill = int(opts["refill"]) if "refill" in opts else None
    obs_mode = opts.get("obs", "symbolic")
    device = resolve_device(opts.get("device"))
    env = minigrid_tpu_torch.make(env_id)
    if obs_mode in ("rgb", "rgb_chw"):
        # the reference's headline metric is RGB partial-obs step FPS
        # (minigrid/benchmark.py:30-46); this row is its batched analogue
        from minigrid_tpu_torch.wrappers import RGBImgPartialObsWrapper

        env = RGBImgPartialObsWrapper(env, tile_size=int(opts.get("tile", 8)),
                                      channels_first=obs_mode == "rgb_chw")
    elif obs_mode != "symbolic":
        raise ValueError(f"unknown obs mode {obs_mode!r}")
    venv = VectorEnv(env, num_envs, reset_strategy=strategy, pool_refill=refill,
                     strict_refill=strict, device=device)
    sps, first_s, stats = timed_rollout(venv, steps, refill_period=period,
                                        with_stats=True)
    row = {
        "env": env_id, "num_envs": num_envs, "steps": steps,
        "obs": obs_mode, "gather_impl": gather_impl(venv.device),
        "strategy": venv.reset_strategy, "refill_period": period,
        "pool_refill": venv.pool_refill
        if venv.reset_strategy == "pooled" else None, "strict": strict,
        "steps_per_sec": round(sps), "first_run_s": round(first_s, 1),
        # served-distribution accounting (timed run): fraction of auto
        # resets served a FRESH level vs a best-effort stale replay
        "resets": stats["resets"],
        "fresh_frac": (round(stats["fresh_frac"], 4)
                       if stats["fresh_frac"] is not None else None),
        "device": torch.cuda.get_device_name(venv.device)
        if venv.device.type == "cuda" else "cpu",
    }
    print(json.dumps(row), flush=True)
    return row


def main(argv: list[str]) -> None:
    if not argv:
        print(__doc__, file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.is_available() and device_kernel_gate(device="cuda"):
        print("device kernel gate ok", file=sys.stderr)
    for spec in argv:
        run_spec(spec)


if __name__ == "__main__":
    main(sys.argv[1:])
