"""One env, uniform random actions, through the Gymnasium adapter's core:
``minigrid_tpu_torch.single_env.SingleEnv``, whose ``reset`` and ``step``
are ``gym_compat.GymEnv``'s (``Env.step`` or ``Env.reset`` on a batch of
one, then one ``utils/convert.to_host`` copy of the outputs), as a
single-env agent, an evaluation loop or interactive play drives the port.
The class needs no gymnasium, so the cell runs the same code on every
machine; a program without it cannot run the cell and exits at once.

The first reset is ``reset(seed=s)``, ``s`` the run's seed folded to 32
bits; every episode that ends, terminated or truncated, is followed by an
unseeded reset, which draws from the adapter's key stream (``key, k =
split(key)`` a reset, from ``PRNGKey(s)``).  Actions are drawn on the host
from the seed, so a step adds no launch of the harness's; the window's
checksum is folded on the host, and a CUDA event marks each step's end.

Correctness: every reset keeps the program's state and first observation,
and every step its action, reward and flags (host values already); a
sample of blocks, drawn from the seed, also keeps the state after each
step (one launch each) and the observation.  The reference replays the
whole run from the first reset: each reset must be the level its key of
the adapter's stream makes, with its observation, and each step's reward
and flags the reference's, the sampled steps' states and observations
too.  ``ring_wrong`` has no ring to compare and stays 0.

Two controls take the program's place in ``check(control)``: ``True`` or
``"reset_key_reuse"``, the harness's, every unseeded reset giving the level
of the key before its own (a key stream that does not advance); and
``"bf16_reward"``, the float32 goal reward in bfloat16.  Uniform random
actions reach DoorKey's goal in about one episode of thirty, so a window
of some 20,000 steps holds a goal step in fewer than half of its seeds;
every other compared reward is 0, exact in bfloat16, so the precision
control separates only in runs with a goal step (the standard error's
``goal_steps``), and the CPU tests hold it to a planned goal step.
"""

from __future__ import annotations

import dataclasses
import importlib
import sys
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.harness import state as S
from perfbench.harness.checks import Counts
from perfbench.harness.snapshot import keep
from perfbench.harness.window import Meter, Spans, sync
from perfbench.reference import minigrid as M

M32 = 0xFFFFFFFF
CONTROLS = ("reset_key_reuse", "bf16_reward")


class HostMeter(Meter):
    """``Meter``'s step-end events (on a card), with the window's checksum
    folded on the host, where the adapter's observations already are."""

    def __init__(self, device):
        super().__init__(device, chunk=1)
        self.total = 0

    def fold(self, image: np.ndarray) -> None:
        self.total += int(image.sum())

    def warm(self) -> None:
        pass

    def _total(self) -> torch.Tensor:
        return torch.tensor(self.total)


def dense(x):
    """A state's tensors under their canonical strides, as views: a batch
    of one has dims of size 1, whose stride is free and which the
    snapshot's byte view of a contiguous tensor refuses."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: dense(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: dense(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if not x.is_contiguous():
        return x
    strides, step = [], 1
    for n in reversed(x.shape):
        strides.append(step)
        step *= n
    return x.as_strided(x.shape, tuple(reversed(strides)), x.storage_offset())


def key_stream(seed32: int, n: int) -> np.ndarray:
    """The keys of the adapter's first ``n`` resets from ``PRNGKey(seed32)``:
    ``key, k = split(key)`` a reset; [n, 2]."""
    key = np.array([0, seed32], np.uint64)
    out = []
    for _ in range(n):
        s = M.split(key)
        key, k = s[0], s[1]
        out.append(k)
    return np.array(out, np.int64).reshape(n, 2)


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device, traced: bool = False):
        import minigrid_tpu_torch as mgt

        try:
            from minigrid_tpu_torch.single_env import SingleEnv
        except ImportError:
            raise SystemExit("perfbench: the program has no minigrid_tpu_torch.single_env, "
                             "the adapter's core this cell drives") from None
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.env = mgt.make(cfg["env_id"], **cfg["env_kwargs"])
        self.params = self.env.default_params
        self.adapter = SingleEnv(self.env, device=device)
        self.num_envs = wl["num_envs"]
        self.seed32 = (seed ^ (seed >> 32)) & M32
        self.task = importlib.import_module(f"perfbench.reference.tasks.{cfg['task']}")
        self.spans = Spans(device) if traced else None
        self.draw = np.random.default_rng([seed & M32, seed >> 32, 2])
        self.pending = iter(())
        self.pick = np.random.default_rng([seed & M32, seed >> 32, 1])
        self.log: list = []          # every step: (action, reward, terminated, truncated)
        self.samples: dict = {}      # sampled step index -> (kept state, observation)
        self.kept_resets: list = []  # every reset: (kept state, observation)
        self.n_sampled = 0
        self.resets = 0
        self.kernel_inputs: dict = {}

    # -- the program's calls ----------------------------------------------------
    def _call(self, name: str, fn, *args, **kwargs):
        if self.spans is None:
            return fn(*args, **kwargs)
        return self.spans(name, lambda: fn(*args, **kwargs))

    def _action(self) -> int:
        a = next(self.pending, None)
        if a is None:
            self.pending = iter(self.draw.integers(0, self.env.num_actions, 4096).tolist())
            a = next(self.pending)
        return a

    def _reset(self, seed: int | None = None) -> dict:
        obs, _ = self._call("one_env.reset", self.adapter.reset, seed=seed)
        self.kept_resets.append((keep(dense(self.adapter._state)), obs))
        self.resets += 1
        return obs

    def setup(self) -> None:
        self._reset(seed=self.seed32)
        self.meter = HostMeter(self.device)
        for _ in range(self.wl["warmup_blocks"]):
            self.block(sample=False)
        sync(self.device)

    def block(self, sample: bool | None = None) -> int:
        if sample is None:
            sample = (self.n_sampled < self.wl["sample_cap"]
                      and self.pick.random() * self.wl["sample_every"] < 1)
        self.n_sampled += bool(sample)
        n = self.wl["block_steps"]
        for _ in range(n):
            a = self._action()
            obs, r, term, trunc, _ = self._call("one_env.step", self.adapter.step, a)
            self.meter.fold(obs["image"])
            if sample:
                self.samples[len(self.log)] = (keep(dense(self.adapter._state)), obs)
            self.log.append((a, r, term, trunc))
            if term or trunc:
                self._reset()
            self.meter.end_step()
        return n

    # -- the traced run ---------------------------------------------------------
    def mark(self) -> None:
        self.marked = self.resets

    def window_counters(self) -> dict:
        """The resets over the window."""
        return {"resets": self.resets - self.marked}

    def profile_body(self):
        """``trace_steps`` steps of the program's calls alone, with the
        resets that follow episode ends, actions drawn beforehand; after
        the logged run, so the check's replay does not reach them."""
        from torch.profiler import record_function

        n = self.wl["trace_steps"]
        acts = [self._action() for _ in range(n)]

        def body():
            for a in acts:
                with record_function("one_env.step"):
                    _, _, term, trunc, _ = self.adapter.step(a)
                if term or trunc:
                    with record_function("one_env.reset"):
                        self.adapter.reset()
            sync(self.device)

        return body, n, lambda: None

    # -- correctness -------------------------------------------------------------
    def check(self, control: bool | str = False) -> Counts:
        """Replay the run from its first reset in the reference and compare
        the kept resets and every step.  ``control`` names the control that
        takes the program's place (``True``: the harness's)."""
        if control and control is not True and control not in CONTROLS:
            raise ValueError(f"unknown control {control!r}")
        control = CONTROLS[0] if control is True else (control or None)
        c = Counts()
        keys = key_stream(self.seed32, len(self.kept_resets) + 1)
        levels: dict = {}

        def level(n: int) -> dict:
            if n not in levels:
                levels[n] = self.task.generate(keys[n:n + 1], self.cfg)
            return levels[n]

        for n, (kept, obs) in enumerate(self.kept_resets):
            if control == "reset_key_reuse" and n > 0:
                prog = level(n - 1)
                obs = self._host_obs(prog)
            else:
                prog = S.env_levels(kept.restore())
            c.add("start_wrong", S.rows_differ(self.task.modelled(level(n)),
                                               self.task.modelled(prog)).sum())
            c.add("start_wrong", self._obs_wrong(level(n), obs).sum())
        limit = self.params.max_steps
        cur, n, goals = level(0), 0, 0
        for i, (a, r, term, trunc) in enumerate(self.log):
            act = np.array([a])
            ref = self._step(cur, act, limit, M.goal_reward)
            prog_reward = np.array([r], np.float32)
            if control == "bf16_reward" and ref.reward[0] != 0:
                prog_reward = self._step(cur, act, limit, M.goal_reward_bf16).reward
            goals += int(ref.reward[0] != 0)
            done_wrong = np.array([(ref.term[0] != term) | (ref.trunc[0] != trunc)])
            wrong = done_wrong | (c.ulps(prog_reward, ref.reward) > 0)
            c.add("done_wrong", done_wrong.sum())
            kept = self.samples.get(i)
            if kept is not None:
                state_wrong = S.rows_differ(self.task.modelled(ref.after),
                                            self.task.modelled(S.env_levels(kept[0].restore())))
                obs_wrong = self._obs_wrong(ref.after, kept[1])
                c.add("state_wrong", state_wrong.sum())
                c.add("obs_wrong", obs_wrong.sum())
                wrong = wrong | state_wrong | obs_wrong
            c.step(wrong)
            # an ended episode goes on from the next reset's level, which
            # the kept resets hold against its key
            if ref.term[0] or ref.trunc[0]:
                n += 1
                cur = level(n)
            else:
                cur = ref.after
        if not control:
            sys.stderr.write(f"perfbench: compared_events steps {len(self.log)}, "
                             f"resets {len(self.kept_resets)}, goal_steps {goals}, "
                             f"sampled_steps {len(self.samples)}\n")
        return c

    def _host_obs(self, ref: dict) -> dict:
        """A reference level's observation as the adapter hands it back."""
        return {"image": M.observe(ref, self.params.agent_view_size)[0],
                "direction": np.int64(ref["dir"][0]), "mission": self.wl["mission"]}

    def _obs_wrong(self, ref: dict, obs: dict) -> np.ndarray:
        image = M.observe(ref, self.params.agent_view_size)[0]
        return np.array([(image != obs["image"]).any() | (ref["dir"][0] != obs["direction"])
                         | (obs["mission"] != self.wl["mission"])])

    def _step(self, cur: dict, a: np.ndarray, limit: int, reward_fn) -> SimpleNamespace:
        after, reward, term, trunc, outcome = M.step(cur, a, limit, reward_fn)
        after, reward, term = self.task.post_step(cur, after, a, outcome, reward, term,
                                                  self.cfg, reward_fn)
        after = {**after, "terminated": term, "truncated": trunc}
        return SimpleNamespace(after=after, reward=reward, term=term, trunc=trunc)
