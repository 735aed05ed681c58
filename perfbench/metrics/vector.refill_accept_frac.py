"""The share of the traced refills' draws that gave a slot a new level: the
program's counters ``refill.accepted / refill.draws`` (a best-effort refill
keeps a slot's old level where its one draw is invalid)."""

from perfbench.harness.program import ratio


def read(run):
    return ratio("refill.accepted", "refill.draws")
