"""What a run compares with the reference, each number beside its limit.

Every number here is a count or a largest gap of an exact comparison, so
its limit is 0; ``compared`` must reach its floor of 1, so that a run that
compared nothing is not correct.
"""

from __future__ import annotations

import numpy as np

LIMITS = {
    "start_wrong": 0,     # reset levels, ring, key and first observations
    "state_wrong": 0,     # env rows whose state differs after a step
    "obs_wrong": 0,       # env rows whose observation differs
    "reward_ulps": 0,     # largest gap of a reward, in float32 units in the last place
    "done_wrong": 0,      # env rows whose terminated or truncated differs
    "ring_wrong": 0,      # ring slots, flags, counters, tick or key that differ
}
FLOOR = {"compared": 1}   # env-steps compared


class Counts:
    def __init__(self):
        self.values = {k: 0 for k in LIMITS}
        self.compared = 0
        self.failed = 0

    def add(self, name: str, n) -> None:
        self.values[name] += int(n)

    def ulps(self, prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
        """Per-row gap of two float32 arrays in units in the last place; the
        largest goes into ``reward_ulps``."""
        a = prog.astype(np.float32).view(np.int32).astype(np.int64)
        b = ref.astype(np.float32).view(np.int32).astype(np.int64)
        gap = np.abs(a - b)
        if gap.size:
            self.values["reward_ulps"] = max(self.values["reward_ulps"], int(gap.max()))
        return gap

    def step(self, wrong_rows: np.ndarray) -> None:
        """One compared step of B envs, ``wrong_rows`` bool[B]."""
        self.compared += wrong_rows.shape[0]
        self.failed += int(wrong_rows.sum())

    def failures(self) -> int:
        """Env-steps compared that differ anywhere, plus every mismatch of
        the start and the ring."""
        return self.failed + self.values["start_wrong"] + self.values["ring_wrong"]

    def result(self) -> dict:
        out = {k: {"value": v, "limit": LIMITS[k]} for k, v in self.values.items()}
        out["compared"] = {"value": self.compared, "limit": FLOOR["compared"]}
        return out


def correct(checks: dict) -> bool:
    return all(v["value"] >= v["limit"] if k in FLOOR else v["value"] <= v["limit"]
               for k, v in checks.items())


def lines(checks: dict) -> list[str]:
    """One line a number: its name, its value and its limit."""
    return [f"{k} {v['value']} {'>=' if k in FLOOR else '<='} {v['limit']}"
            for k, v in checks.items()]
