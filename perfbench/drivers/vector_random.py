"""Uniform random actions through ``VectorEnv``'s pooled engine.

Each block is ``refill_every`` steps of ``VectorEnv.step_nofill`` and then
one ``VectorEnv.refill(state, refill_every)``: with ``refill_every`` 1 that is
``VectorEnv.step``.  The block's last step ends after its refill.

Correctness: a sample of the window's blocks, drawn from the seed, keeps
copies of the program's states and outputs (``harness/snapshot.py``: one
launch for the block's start, unless it is where the kept block before
ended, and one for each step, the last one with the state after the
refill).  Once the window has closed the reference follows each sampled
block from the program's state at its start: the step and the task, the
ring's serve, the observation, then the refill, every slot of its window
made again from its key; and it checks the reset the run started from,
every level made again from its key.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.harness import state as S
from perfbench.harness.checks import Counts
from perfbench.harness.snapshot import distinct, keep
from perfbench.harness.window import Actions, Meter, Spans, sync
from perfbench.reference import minigrid as M
from perfbench.reference import pooled as P

M32 = 0xFFFFFFFF


def seed_key(seed: int, device) -> torch.Tensor:
    """The run's key: the seed's high and low 32-bit words."""
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64,
                        device=device)


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device, traced: bool = False):
        import minigrid_tpu_torch as mgt

        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.env = mgt.make(cfg["env_id"], **cfg["env_kwargs"])
        self.num_envs = wl["num_envs"]
        self.venv = mgt.VectorEnv(self.env, self.num_envs, reset_strategy="pooled",
                                  pool_refill=wl.get("pool_refill"), device=device)
        self.refill_every = wl["refill_every"]
        self.task = importlib.import_module(f"perfbench.reference.tasks.{cfg['task']}")
        self.spans = Spans(device) if traced else None
        self.pick = np.random.default_rng([seed & M32, seed >> 32, 1])
        self.samples: list = []
        self.last_kept = None  # (the state the last kept block ended on, its copy)
        self.kernel_inputs: dict = {"obs_gather": []}

    # -- the program's calls ----------------------------------------------------
    def _call(self, name: str, fn, *args):
        return fn(*args) if self.spans is None else self.spans(name, fn, *args)

    def setup(self) -> None:
        key = seed_key(self.seed, self.device)
        obs, state = self.venv.reset(key)
        self.start = keep(SimpleNamespace(key=key, obs=obs, state=state))
        self.state = state
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
        steps = [] if sample else None
        if sample:
            last = self.last_kept
            start = (last[1], True) if last and last[0] is self.state else (keep(self.state), False)
        k = self.refill_every
        for t in range(k):
            action = self.actions.next()
            obs, state, reward, term, trunc, _ = self._call(
                "vector.step_nofill", self.venv.step_nofill, self.state, action)
            self.meter.fold(obs["image"])
            self.state = state
            if t == k - 1:
                self.state = self._call("vector.refill", self.venv.refill, state, k)
            self.meter.end_step()
            if steps is not None:
                ring = SimpleNamespace(envs=state.envs, fresh=state.fresh, tick=state.tick,
                                       key=state.key, n_fresh=state.n_fresh,
                                       n_stale=state.n_stale)
                rec = SimpleNamespace(obs=obs, state=ring, reward=reward, term=term,
                                      trunc=trunc)
                steps.append((action, keep(SimpleNamespace(
                    step=rec, end=self.state if t == k - 1 else None))))
        if steps is not None:
            self.last_kept = (self.state, steps[-1][1])
            self.samples.append((start, steps))
        return k

    @staticmethod
    def restore(sample) -> SimpleNamespace:
        """A kept block: the state it started from, its steps, the state it
        ended on."""
        (start, was_end), kept = sample
        steps = [(action, rec.restore()) for action, rec in kept]
        return SimpleNamespace(
            start=start.restore().end if was_end else start.restore(),
            steps=[SimpleNamespace(action=a, **vars(r.step)) for a, r in steps],
            end=steps[-1][1].end)

    # -- the traced run ---------------------------------------------------------
    def mark(self) -> None:
        """The window starts: read the counters it starts from."""
        self.marked = (int(self.state.n_fresh), int(self.state.n_stale))

    def window_counters(self) -> dict:
        """The auto-resets the ring served over the window, fresh and stale
        (read after it closed)."""
        return {"n_fresh": int(self.state.n_fresh) - self.marked[0],
                "n_stale": int(self.state.n_stale) - self.marked[1]}

    def profile_body(self):
        """``trace_blocks`` blocks of the program's calls alone, actions drawn
        beforehand, each call under a named span; each observation's pose is
        kept for the gather's byte count."""
        from torch.profiler import record_function

        k = self.refill_every
        n = self.wl["trace_blocks"]
        acts = [self.actions.next() for _ in range(n * k)]
        sync(self.device)
        w, h = self.venv.params.width, self.venv.params.height
        v = self.venv.params.agent_view_size
        poses = []

        def body():
            for b in range(n):
                for t in range(k):
                    with record_function("vector.step_nofill"):
                        _, state, *_ = self.venv.step_nofill(self.state, acts[b * k + t])
                    poses.append((state.envs.agent_pos, state.envs.agent_dir))
                    self.state = state
                with record_function("vector.refill"):
                    self.state = self.venv.refill(self.state, k)
            sync(self.device)

        def inputs():
            # poses written in place would all read the last one: then the
            # gather's bytes are not known, and its roofline is left out
            if distinct([t for pose in poses for t in pose]):
                self.kernel_inputs["obs_gather"] = [
                    (S.to_np(p), S.to_np(d), w, h, v) for p, d in poses]

        return body, n * k, inputs

    # -- correctness -------------------------------------------------------------
    def check(self, control: bool = False) -> Counts:
        """Compare the sampled blocks and the reset with the reference.
        ``control`` puts the control (the reference with its float32 reward
        computed in bfloat16) in the program's place."""
        c = Counts()
        self._check_start(c)
        for sample in self.samples:
            self._check_block(c, self.restore(sample), control)
        return c

    def _check_start(self, c: Counts) -> None:
        b = self.num_envs
        start = self.start.restore()
        st = start.state
        keys, ring_key = P.reset_keys(S.to_np(start.key), b)
        levels = S.concat(S.env_levels(st.envs), S.env_levels(st.pool))
        ref = self.task.generate(keys, self.cfg)
        c.add("start_wrong", S.rows_differ(self.task.modelled(ref),
                                           self.task.modelled(levels)).sum())
        r = S.ring(st)
        c.add("start_wrong", (~r["fresh"]).sum() + (r["tick"] != 0) + (r["n_fresh"] != 0)
              + (r["n_stale"] != 0) + (r["key"] != ring_key).any())
        envs = S.take_rows(st.envs, np.arange(b))
        c.add("start_wrong", self._obs_wrong(S.env_levels(envs), S.obs(start.obs)).sum())
    def _obs_wrong(self, ref: dict, obs: dict) -> np.ndarray:
        image = M.observe(ref, self.venv.params.agent_view_size)
        return (S.rows_differ(image, obs["image"]) | (ref["dir"] != obs["direction"])
                | S.rows_differ(ref["mission"], obs["mission"]))

    def _check_block(self, c: Counts, blk, control: bool) -> None:
        task, cfg = self.task, self.cfg
        b = self.num_envs
        limit = self.venv.params.max_steps
        ring = S.ring(blk.start)
        flags, n_fresh, n_stale = ring["fresh"], ring["n_fresh"], ring["n_stale"]
        cur = S.env_levels(blk.start.envs)
        for rec in blk.steps:
            a = S.to_np(rec.action)
            ref = self._step(cur, a, limit, M.goal_reward)
            prog_reward = (self._step(cur, a, limit, M.goal_reward_bf16).reward
                           if control else S.to_np(rec.reward))
            idx, slot, fresh, flags = P.serve(flags, ref.term | ref.trunc)
            n_fresh += int(fresh.sum())
            n_stale += int((~fresh).sum())
            envs = ref.after
            if idx.size:
                served = S.env_levels(S.take_rows(blk.start.pool, slot))
                envs = P.put_rows(envs, idx, served)
            prog = S.env_levels(rec.state.envs)
            state_wrong = S.rows_differ(task.modelled(envs), task.modelled(prog))
            obs_wrong = self._obs_wrong(envs, S.obs(rec.obs))
            done_wrong = (ref.term != S.to_np(rec.term)) | (ref.trunc != S.to_np(rec.trunc))
            reward_wrong = c.ulps(prog_reward, ref.reward) > 0
            c.add("state_wrong", state_wrong.sum())
            c.add("obs_wrong", obs_wrong.sum())
            c.add("done_wrong", done_wrong.sum())
            c.step(state_wrong | obs_wrong | done_wrong | reward_wrong)
            r = S.ring(rec.state)
            c.add("ring_wrong", (r["fresh"] != flags).sum() + (r["n_fresh"] != n_fresh)
                  + (r["n_stale"] != n_stale))
            cur = envs
        self._check_refill(c, blk, flags)

    def _step(self, cur: dict, a: np.ndarray, limit: int, reward_fn) -> SimpleNamespace:
        """The reference's step and task over one batch of actions."""
        after, reward, term, trunc, outcome = M.step(cur, a, limit, reward_fn)
        after, reward, term = self.task.post_step(cur, after, a, outcome, reward, term,
                                                  self.cfg, reward_fn)
        after = {**after, "terminated": term, "truncated": trunc}
        return SimpleNamespace(after=after, reward=reward, term=term, trunc=trunc)

    def _check_refill(self, c: Counts, blk, flags: np.ndarray) -> None:
        """The block's refill: every slot of its window holds the level its
        key makes, or, where that draw is not accepted, the level it held;
        the window is fresh, the other slots are as they were, tick and key
        move on."""
        k = self.refill_every
        before, after = S.ring(blk.start), S.ring(blk.end)
        size = 2 * self.num_envs
        off, n = P.refill_block(before["tick"], k, self.venv.pool_refill, size)
        nxt_key, keys = P.refill_keys(before["key"], n)
        window = np.arange(off, off + n)
        drawn, accepted = self.task.attempt(keys, self.cfg)
        old = S.env_levels(S.take_rows(blk.start.pool, window))
        want = P.select_rows(accepted, self.task.modelled(drawn), self.task.modelled(old))
        new = self.task.modelled(S.env_levels(S.take_rows(blk.end.pool, window)))
        c.add("ring_wrong", S.rows_differ(want, new).sum())
        outside = np.setdiff1d(np.arange(size), window)
        c.add("ring_wrong", S.rows_changed(blk.end.pool, blk.start.pool, outside).sum())
        flags = flags.copy()
        flags[window] = True
        c.add("ring_wrong", (after["fresh"] != flags).sum()
              + (after["tick"] != before["tick"] + k) + (after["key"] != nxt_key).any())
