"""The readings the limits of ``perfbench/harness/checks.py`` are set from:
for each seed one window of a cell, then the program's checks and the
control's (the reference with its float32 goal reward computed in bfloat16, in the
program's place), in one process.  Not part of a benchmark run.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 10

Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import run as R  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = R.run(args.workload, seed, args.seconds, False, also_control=True)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": {k: v["value"] for k, v in res["checks"].items()},
                          "control": {k: v["value"] for k, v in res["control_checks"].items()},
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()}}),
              flush=True)


if __name__ == "__main__":
    main()
