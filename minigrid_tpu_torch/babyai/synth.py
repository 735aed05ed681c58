"""BabyAI's Synth and Boss levels and GoToSeq, all ``LevelGen`` presets.

Counterpart of ``minigrid_tpu/babyai/synth.py``, class for class and default
for default.
"""

from __future__ import annotations

from minigrid_tpu_torch.babyai.levelgen import LevelGen


class GoToSeq(LevelGen):
    """Sequenced go-to commands."""

    name = "GoToSeq"

    def __init__(self, room_size=8, num_rows=3, num_cols=3, num_dists=18, **kwargs):
        super().__init__(room_size=room_size, num_rows=num_rows, num_cols=num_cols,
                         num_dists=num_dists, action_kinds=["goto"],
                         locked_room_prob=0, locations=False, unblocking=False,
                         **kwargs)


class Synth(LevelGen):
    """Every single instruction."""

    name = "Synth"

    def __init__(self, room_size=8, num_rows=3, num_cols=3, num_dists=18, **kwargs):
        super().__init__(room_size=room_size, num_rows=num_rows, num_cols=num_cols,
                         num_dists=num_dists, instr_kinds=["action"], locations=False,
                         unblocking=True, implicit_unlock=False, **kwargs)


class SynthS5R2(Synth):
    name = "SynthS5R2"

    def __init__(self, **kwargs):
        super().__init__(room_size=5, num_rows=2, num_cols=2, num_dists=7, **kwargs)


class SynthLoc(LevelGen):
    """Synth with location language."""

    name = "SynthLoc"

    def __init__(self, **kwargs):
        super().__init__(instr_kinds=["action"], locations=True, unblocking=True,
                         implicit_unlock=False, **kwargs)


class SynthSeq(LevelGen):
    """SynthLoc with sequenced commands."""

    name = "SynthSeq"

    def __init__(self, **kwargs):
        super().__init__(locations=True, unblocking=True, implicit_unlock=False,
                         **kwargs)


class MiniBossLevel(LevelGen):
    name = "MiniBossLevel"

    def __init__(self, **kwargs):
        super().__init__(num_cols=2, num_rows=2, room_size=5, num_dists=7,
                         locked_room_prob=0.25, **kwargs)


class BossLevel(LevelGen):
    name = "BossLevel"


class BossLevelNoUnlock(LevelGen):
    name = "BossLevelNoUnlock"

    def __init__(self, **kwargs):
        super().__init__(locked_room_prob=0, implicit_unlock=False, **kwargs)
