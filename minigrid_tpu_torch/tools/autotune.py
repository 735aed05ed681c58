"""Auto-tune the vectorized execution config for one env family.

Counterpart of ``minigrid_tpu/tools/autotune.py``.  Which of fused /
conditional / pooled wins, and at what refill window and bulk period, is an
empirical question per family, batch size and device; this tool sweeps the
knobs the batch engine exposes and reports the fastest configuration (the
reference has no analogue; its benchmark is minigrid/benchmark.py:12-48):

    python -m minigrid_tpu_torch.tools.autotune BabyAI-GoToRedBall-v0 \
        --num-envs 4096 --num-steps 1024 [--device cuda]

Each candidate is :func:`minigrid_tpu_torch.tools.benchmark.timed_rollout`:
a first run (its seconds stand where the JAX package reports a compile),
then a timed run.  The JAX package's ``unroll=4`` variants are not swept:
the port's rollout is eager and ignores ``unroll``, so they would time the
same program twice and pick a winner from noise.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

from minigrid_tpu_torch.tools.benchmark import timed_rollout


@dataclass(frozen=True)
class Candidate:
    reset_strategy: str
    pool_refill: int | None = None
    refill_period: int = 1
    strict_refill: bool = False

    def label(self) -> str:
        s = self.reset_strategy
        if self.reset_strategy == "pooled":
            s += f"(C={self.pool_refill or 'auto'},K={self.refill_period}"
            s += ",strict)" if self.strict_refill else ")"
        return s


def candidates(num_envs: int, expensive: bool) -> list[Candidate]:
    """Sweep grid: strategies the family could plausibly want.  An
    expensive generator skips 'fused' (it would regenerate B-wide every
    step — the exact degenerate case the other strategies exist for).
    Pooled windows of B/8 to B/256 levels at bulk periods 1, 8 and 16."""
    out = [] if expensive else [Candidate("fused")]
    out.append(Candidate("conditional"))
    seen = set()
    for frac in (8, 16, 32, 64, 256):
        c = max(1, num_envs // frac)
        while (2 * num_envs) % c:
            c -= 1
        for period in (1, 8, 16):
            if ((2 * num_envs) % min(period * c, 2 * num_envs) == 0
                    and (c, period) not in seen):
                seen.add((c, period))
                out.append(Candidate("pooled", c, period))
    return out


def measure(env_id: str, cand: Candidate, num_envs: int, num_steps: int,
            seed: int = 0, device=None) -> tuple[float, float, dict]:
    """(env-steps/s, first-run seconds, served-level stats) for one
    candidate."""
    import minigrid_tpu_torch
    from minigrid_tpu_torch.parallel.vector import VectorEnv

    env = minigrid_tpu_torch.make(env_id)
    venv = VectorEnv(
        env, num_envs, env.default_params,
        reset_strategy=cand.reset_strategy,
        pool_refill=cand.pool_refill,
        strict_refill=cand.strict_refill,
        device=device,
    )
    return timed_rollout(venv, num_steps, cand.refill_period, seed=seed,
                         with_stats=True)


def autotune(env_id: str, num_envs: int = 4096, num_steps: int = 1024,
             verbose: bool = True, min_fresh: float = 0.9, device=None) -> dict:
    """Sweep all candidates; return the best config as a dict of
    VectorEnv/rollout kwargs plus the measured table."""
    import minigrid_tpu_torch

    env = minigrid_tpu_torch.make(env_id)
    expensive = getattr(env, "expensive_generation", False)
    rows = []
    for cand in candidates(num_envs, expensive):
        try:
            sps, first_s, stats = measure(env_id, cand, num_envs, num_steps,
                                          device=device)
        except Exception as e:  # noqa: BLE001 — report and keep sweeping
            if verbose:
                print(f"  {cand.label():28s} failed: {type(e).__name__}: {e}",
                      flush=True)
            continue
        fresh = stats["fresh_frac"]
        rows.append((cand, sps, first_s, fresh))
        if verbose:
            fs = "  n/a " if fresh is None else f"{fresh:6.1%}"
            print(f"  {cand.label():28s} {sps / 1e6:9.4f}M steps/s"
                  f"  fresh {fs}  (first run {first_s:5.1f}s)", flush=True)
    if not rows:
        raise RuntimeError(f"no candidate succeeded for {env_id}")
    # Headline selection honors the freshness floor: a pooled config that
    # mostly replays stale levels is a different metric, not a faster one.
    # Fall back to the raw max only when no candidate clears the floor (and
    # say so via fresh_frac).
    honest = [r for r in rows if r[3] is None or r[3] >= min_fresh]
    best, sps, _, best_fresh = max(honest or rows, key=lambda r: r[1])
    result = {
        "env_id": env_id,
        "num_envs": num_envs,
        "steps_per_sec": sps,
        "fresh_frac": best_fresh,
        "min_fresh": min_fresh,
        "reset_strategy": best.reset_strategy,
        "pool_refill": best.pool_refill,
        "refill_period": best.refill_period,
        "strict_refill": best.strict_refill,
        "unroll": 1,  # the JAX package's scan knob; the port's rollout is eager
        "table": [(c.label(), s, f) for c, s, _, f in rows],
    }
    if verbose:
        print(f"best: {best.label()} at {sps / 1e6:.4f}M steps/s")
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("env_id")
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--num-steps", type=int, default=1024)
    p.add_argument("--device", default=None, help="'cpu' to run on the CPU")
    args = p.parse_args(argv)
    autotune(args.env_id, args.num_envs, args.num_steps, device=args.device)


if __name__ == "__main__":
    main()
