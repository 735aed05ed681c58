"""Uniform random actions through ``FusedVectorEnv.step``: one kernel a step,
every finished env regenerated inside it.

Correctness: a sample of the window's steps, drawn from the seed, keeps
copies of the planes before and after and of the step's outputs
(``harness/snapshot.py``: one launch for the planes before, unless the
step before was kept, and one for the rest).  Once the window has closed
the reference recomputes each sampled step from the program's planes before
it; and it checks the reset the run started from.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np

from perfbench.drivers.vector_random import M32, seed_key
from perfbench.harness import state as S
from perfbench.harness.checks import Counts
from perfbench.harness.snapshot import distinct, keep
from perfbench.harness.window import Actions, Meter, Spans, sync
from perfbench.reference import fused as F
from perfbench.reference import minigrid as M

PLANE_FIELDS = ("grid", "pos", "dir", "step_count", "carrying", "spare")


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device, traced: bool = False):
        import minigrid_tpu_torch as mgt

        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.env = mgt.make(cfg["env_id"], **cfg["env_kwargs"])
        self.num_envs = wl["num_envs"]
        self.fused = mgt.FusedVectorEnv(self.env, self.num_envs, device=device)
        self.params = self.fused.params
        self.task = importlib.import_module(f"perfbench.reference.tasks.{cfg['task']}")
        self.spans = Spans(device) if traced else None
        self.pick = np.random.default_rng([seed & M32, seed >> 32, 2])
        self.samples: list = []
        self.last_kept = None  # (the planes the last kept step left, its copy)
        self.kernel_inputs: dict = {"fused_step": []}

    def setup(self) -> None:
        key = seed_key(self.seed, self.device)
        obs, fs = self.fused.reset(key)
        self.start = keep(SimpleNamespace(key=key, obs=obs, fs=fs))
        self.fs = fs
        chunk = self.wl["chunk_steps"]
        self.actions = Actions(self.seed, self.num_envs, self.env.num_actions, chunk,
                               self.device)
        self.meter = Meter(self.device, chunk)
        for _ in range(self.wl["warmup_blocks"]):
            self.block(sample=False)
        self.meter.warm()
        sync(self.device)

    def block(self, sample: bool | None = None) -> int:
        if sample is None:
            sample = (len(self.samples) < self.wl["sample_cap"]
                      and self.pick.random() * self.wl["sample_every"] < 1)
        action = self.actions.next()
        before = self.fs
        if sample:
            last = self.last_kept
            kept_before = ((last[1], True) if last and last[0] is before
                           else (keep(before), False))
        if self.spans is None:
            out = self.fused.step(before, action)
        else:
            out = self.spans("fused.step", self.fused.step, before, action)
        obs, self.fs, reward, term, trunc, _ = out
        self.meter.fold(obs["image"])
        self.meter.end_step()
        if sample:
            rec = keep(SimpleNamespace(obs=obs, after=self.fs, reward=reward, term=term,
                                       trunc=trunc))
            self.last_kept = (self.fs, rec)
            self.samples.append((kept_before, action, rec))
        return 1

    @staticmethod
    def restore(sample) -> SimpleNamespace:
        """A kept step: the planes before it, its action, its outputs."""
        (before, was_after), action, rec = sample
        before = before.restore()
        return SimpleNamespace(before=before.after if was_after else before, action=action,
                               **vars(rec.restore()))

    def mark(self) -> None:
        pass

    def window_counters(self) -> dict:
        return {}

    def profile_body(self):
        """``trace_blocks`` fused steps alone, actions drawn beforehand; each
        step's finished lanes are kept for the kernel's byte count."""
        from torch.profiler import record_function

        n = self.wl["trace_blocks"]
        acts = [self.actions.next() for _ in range(n)]
        sync(self.device)
        ends = []

        def body():
            for a in acts:
                with record_function("fused.step"):
                    _, self.fs, _, term, trunc, _ = self.fused.step(self.fs, a)
                ends.append((term, trunc))
            sync(self.device)

        p = self.params

        def inputs():
            # flags written in place would all read the last step's: then
            # the kernel's bytes are not known, and its roofline is left out
            if not distinct([t for end in ends for t in end]):
                return
            self.kernel_inputs["fused_step"] = [
                (self.num_envs, p.width, p.height, p.agent_view_size,
                 int((S.to_np(term) | S.to_np(trunc)).sum())) for term, trunc in ends]

        return body, n, inputs

    # -- correctness -------------------------------------------------------------
    def check(self, control: bool = False) -> Counts:
        c = Counts()
        self._check_start(c)
        p = self.params
        for sample in self.samples:
            rec = self.restore(sample)
            cur = S.fused(rec.before)
            a = S.to_np(rec.action)
            args = (cur, a, cur["key"], p.width, p.max_steps, p.agent_view_size)
            nxt, image, reward, term, trunc, key = F.step(*args)
            prog_reward = (F.step(*args, F.fused_reward_bf16)[2] if control
                           else S.to_np(rec.reward))
            prog = S.fused(rec.after)
            obs = S.obs(rec.obs)
            nxt["spare"] = np.zeros_like(cur["spare"])
            state_wrong = S.rows_differ({f: nxt[f] for f in PLANE_FIELDS},
                                        {f: prog[f] for f in PLANE_FIELDS})
            obs_wrong = (S.rows_differ(image, obs["image"]) | (nxt["dir"] != obs["direction"])
                         | S.rows_differ(cur["mission"], obs["mission"]))
            done_wrong = (term != S.to_np(rec.term)) | (trunc != S.to_np(rec.trunc))
            reward_wrong = c.ulps(prog_reward, reward) > 0
            c.add("state_wrong", state_wrong.sum()
                  + (prog["key"] != key).any() + (prog["t"] != cur["t"] + 1)
                  + S.rows_differ(prog["mission"], cur["mission"]).sum())
            c.add("obs_wrong", obs_wrong.sum())
            c.add("done_wrong", done_wrong.sum())
            c.step(state_wrong | obs_wrong | done_wrong | reward_wrong)
        return c

    def _check_start(self, c: Counts) -> None:
        n = self.num_envs
        start = self.start.restore()
        key = S.to_np(start.key)
        ref = self.task.generate(M.split(key, n), self.cfg)
        prog = S.fused(start.fs)
        ref["spare"] = np.zeros_like(prog["spare"])
        c.add("start_wrong", S.rows_differ({f: ref[f] for f in PLANE_FIELDS},
                                           {f: prog[f] for f in PLANE_FIELDS}).sum())
        c.add("start_wrong", (prog["key"] != M.fold_in(key, 1)).any() + (prog["t"] != 0)
              + S.rows_differ(ref["mission"], prog["mission"]).sum())
        obs = S.obs(start.obs)
        image = M.observe(ref, self.params.agent_view_size)
        c.add("start_wrong", (S.rows_differ(image, obs["image"])
                              | (ref["dir"] != obs["direction"])).sum())
