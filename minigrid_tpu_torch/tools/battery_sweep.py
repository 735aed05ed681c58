"""Full-zoo battery sweep: one measured config per env module.

Counterpart of ``minigrid_tpu/tools/battery_sweep.py``, with its list of
rows: at least one representative config per env module (26 MiniGrid
modules, a BabyAI spread including the structurally heaviest generators,
and the RGB partial-obs row), so a claim about every family rests on a
measurement of every family.  Each row is
:func:`minigrid_tpu_torch.tools.battery.run_spec`; before any row,
:func:`minigrid_tpu_torch.tools.battery.device_kernel_gate` holds the
``obs_gather`` kernel against its plain version on the card.

Resumable: rows already present in the output file are skipped, so an
interrupted sweep costs only the in-flight row.

Usage::

    python -m minigrid_tpu_torch.tools.battery_sweep [outfile] [--quick] \
        [--device DEVICE]
"""

from __future__ import annotations

import json
import os
import sys

# (module, SPEC) — the JAX package's rows, entry for entry: one row per
# reference env module (SURVEY.md §2.2) plus the BabyAI spread.  num_envs
# and steps default to 4096 in battery.run_spec; ``unroll`` is accepted and
# ignored there.
P64 = "strategy=pooled,refill=64,period=8"
SWEEP: list[tuple[str, str]] = [
    ("empty", f"MiniGrid-Empty-8x8-v0:{P64}"),
    ("doorkey", f"MiniGrid-DoorKey-8x8-v0:{P64}"),
    ("crossing", "MiniGrid-LavaCrossingS9N2-v0:strategy=pooled,refill=128,"
              "period=8"),
    ("dynamicobstacles", "MiniGrid-Dynamic-Obstacles-8x8-v0:strategy=pooled,"
                      "refill=1024,period=8"),
    ("fourrooms", f"MiniGrid-FourRooms-v0:{P64}"),
    ("multiroom", "MiniGrid-MultiRoom-N6-v0:strategy=pooled,refill=32,"
                  "period=8,unroll=4"),
    ("fetch", "MiniGrid-Fetch-8x8-N3-v0:strategy=pooled,refill=128,period=8"),
    ("gotodoor", "MiniGrid-GoToDoor-8x8-v0:strategy=fused"),
    ("gotoobject", "MiniGrid-GoToObject-8x8-N2-v0:strategy=fused"),
    ("putnear", "MiniGrid-PutNear-8x8-N3-v0:strategy=pooled,refill=256,"
               "period=8"),
    ("redbluedoors", f"MiniGrid-RedBlueDoors-8x8-v0:{P64}"),
    ("memory", f"MiniGrid-MemoryS13-v0:{P64}"),
    ("lockedroom", f"MiniGrid-LockedRoom-v0:{P64}"),
    ("keycorridor", "MiniGrid-KeyCorridorS3R3-v0:strategy=pooled,refill=64,"
                    "period=8,unroll=1"),
    ("unlock", f"MiniGrid-Unlock-v0:{P64}"),
    ("unlockpickup", f"MiniGrid-UnlockPickup-v0:{P64}"),
    ("blockedunlockpickup", f"MiniGrid-BlockedUnlockPickup-v0:{P64}"),
    ("obstructedmaze", "MiniGrid-ObstructedMaze-Full-v0:strategy=pooled,"
                       "refill=16,period=16"),
    ("lavagap", "MiniGrid-LavaGapS7-v0:strategy=pooled,refill=128,period=8"),
    ("distshift", "MiniGrid-DistShift1-v0:strategy=fused"),
    ("playground", f"MiniGrid-Playground-v0:{P64}"),
    ("negated_goals", "MiniGrid-Negated-Simple-v0:strategy=pooled,"
                    "refill=256,period=8"),
    ("contrastive", "ContrastiveDataset-v0:strategy=fused"),
    ("contrastive_traj", f"ContrastiveTrajectoryDataset-v0:{P64}"),
    ("directions_dataset", "DirectionsDataset-v0:strategy=fused"),
    ("blocks_dataset", "BlocksDataset-v0:strategy=fused"),
    # BabyAI spread (heaviest generators explicitly included)
    ("babyai_goto", "BabyAI-GoToRedBall-v0:strategy=pooled,refill=256,"
                    "period=16"),
    ("babyai_gotoobj", "BabyAI-GoTo-v0:strategy=pooled,refill=16,period=16"),
    ("babyai_pickup", "BabyAI-PickupLoc-v0:strategy=pooled,refill=64,"
                      "period=16"),
    ("babyai_putnext", "BabyAI-PutNextLocalS6N4-v0:strategy=pooled,"
                       "refill=64,period=16"),
    ("babyai_open", "BabyAI-OpenDoorsOrderN4-v0:strategy=pooled,refill=64,"
                    "period=16"),
    ("babyai_unlock", "BabyAI-UnlockPickup-v0:strategy=pooled,refill=64,"
                      "period=16"),
    ("babyai_synth", "BabyAI-Synth-v0:strategy=pooled,refill=8,period=32"),
    ("babyai_synthseq", "BabyAI-SynthSeq-v0:strategy=pooled,refill=8,"
                        "period=32"),
    ("babyai_boss", "BabyAI-BossLevel-v0:strategy=pooled,refill=4,"
                    "period=64"),
    # the reference's own headline metric, vectorized
    ("rgb_partial", f"MiniGrid-DoorKey-8x8-v0:{P64},obs=rgb,tile=8"),
]


def main(argv: list[str]) -> None:
    out_path = argv[0] if argv and not argv[0].startswith("-") else (
        ".bench_logs/battery_sweep_r5.jsonl")
    quick = "--quick" in argv
    device = argv[argv.index("--device") + 1] if "--device" in argv else None
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    done = set()
    if os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["module"])
                except Exception:
                    pass
    from minigrid_tpu_torch.tools.battery import device_kernel_gate, run_spec

    if device_kernel_gate(device=device):
        print("device kernel gate ok", file=sys.stderr)
    else:
        print(f"device kernel gate skipped: no kernel to gate on {device}",
              file=sys.stderr)
    for module, spec in SWEEP:
        if module in done:
            print(f"skip {module} (already measured)", file=sys.stderr)
            continue
        if quick:
            spec += ",num_envs=256,steps=64"
        if device is not None:
            spec += f",device={device}"
        try:
            row = run_spec(spec)
        except Exception as e:  # noqa: BLE001 — log and keep sweeping
            row = {"env": spec.split(":")[0], "error": f"{type(e).__name__}: {e}"}
            print(json.dumps({"module": module, **row}), file=sys.stderr)
        row = {"module": module, **row}
        with open(out_path, "a") as f:
            f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
