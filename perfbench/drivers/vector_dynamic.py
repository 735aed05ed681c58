"""Uniform random actions over the configuration's three (left, right,
forward) through ``VectorEnv``'s pooled engine, for a family whose step has
dynamics of its own: Dynamic-Obstacles' balls move every step, and a
forward step into anything but the goal ends the episode.

Blocks, the ring and the check are ``vector_random``'s.  The reference's
step is the task's: the actions mapped into the three, the front cell read,
the balls' moves, the base step on the grid after them, then the collision;
the observation sees through walls.  The check also counts, in the steps it
compares, the collisions, the episodes that ended and the balls that stayed
for want of a free cell (``compared_events``), so a run shows that its
comparison saw the step's dynamics.

Two controls take the program's place in ``check(control)``, each putting
its reward where the program's was: ``True`` or ``"late_collision"``, the
harness's, the reference judging the collision on the grid after the balls
moved; and ``"bf16_reward"``, the float32 goal reward in bfloat16.  Under
uniform random actions no compared step reaches the goal 26 cells away, so
every compared reward is 0 or -1, exact in bfloat16: the precision control
cannot separate under this traffic, and the CPU tests hold it to a
hand-built goal step.
"""

from __future__ import annotations

import sys
from types import SimpleNamespace

import numpy as np

from perfbench.drivers import vector_random as VR
from perfbench.harness import state as S
from perfbench.harness.snapshot import keep
from perfbench.harness.window import Actions, Meter, sync
from perfbench.reference import minigrid as M

CONTROLS = ("late_collision", "bf16_reward")


class Driver(VR.Driver):
    def __init__(self, cfg: dict, wl: dict, seed: int, device, traced: bool = False):
        super().__init__(cfg, wl, seed, device, traced)
        self.num_actions = wl["num_actions"]
        self.control = None
        self.events = {"collisions": 0, "episodes_ended": 0, "stuck": 0}

    def setup(self) -> None:
        key = VR.seed_key(self.seed, self.device)
        obs, state = self.venv.reset(key)
        self.start = keep(SimpleNamespace(key=key, obs=obs, state=state))
        self.state = state
        chunk = self.wl["chunk_steps"]
        self.actions = Actions(self.seed, self.num_envs, self.num_actions, chunk, self.device)
        self.meter = Meter(self.device, chunk)
        for _ in range(self.wl["warmup_blocks"]):
            self.block(sample=False)
        self.meter.warm()
        sync(self.device)

    def check(self, control: bool | str = False):
        """``vector_random``'s check; ``control`` names the control that
        takes the program's place (``True``: the harness's)."""
        if control and control is not True and control not in CONTROLS:
            raise ValueError(f"unknown control {control!r}")
        self.control = CONTROLS[0] if control is True else (control or None)
        self.events = {k: 0 for k in self.events}
        counts = super().check(control=bool(control))
        if not control:
            sys.stderr.write("perfbench: compared_events " + ", ".join(
                f"{k} {v}" for k, v in self.events.items()) + "\n")
        return counts

    def _obs_wrong(self, ref: dict, obs: dict) -> np.ndarray:
        image = self.task.observe(ref, self.venv.params.agent_view_size)
        return (S.rows_differ(image, obs["image"]) | (ref["dir"] != obs["direction"])
                | S.rows_differ(ref["mission"], obs["mission"]))

    def _step(self, cur: dict, a: np.ndarray, limit: int, reward_fn) -> SimpleNamespace:
        """The task's step.  ``vector_random`` asks for the control's reward
        with ``goal_reward_bf16``; under the late-collision control that
        call judges the collision after the moves, at float32."""
        task = self.task
        reference = reward_fn is M.goal_reward
        late = not reference and self.control == "late_collision"
        if late:
            reward_fn = M.goal_reward
        a = task.actions(a)
        moved, ok = task.move_obstacles(cur)
        after, reward, term, trunc, outcome = M.step(moved, a, limit, reward_fn)
        after, reward, term = task.post_step(moved if late else cur, after, a, outcome,
                                             reward, term, self.cfg, reward_fn)
        if reference:
            self.events["collisions"] += int(((a == M.FORWARD) & task.not_clear(cur)).sum())
            self.events["episodes_ended"] += int((term | trunc).sum())
            self.events["stuck"] += int((~ok).sum())
        after = {**after, "terminated": term, "truncated": trunc}
        return SimpleNamespace(after=after, reward=reward, term=term, trunc=trunc)
