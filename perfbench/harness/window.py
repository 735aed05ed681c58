"""The measured window: actions drawn by the harness, a checksum of every
observation, a CUDA event at every step's end, whole blocks until the time
is up.

Per step the harness adds one launch (the observation's checksum written
into that step's slot of a device buffer) and one event record; per chunk
of steps one action draw.  The window's rate is all its env-steps over all its
time, the final host fetch included; a step's time is the gap between its
end event and the previous one, read once the window has closed, with no
host sync inside the window.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch


class Actions:
    """Uniform actions in [0, num_actions) for B envs, drawn on the device
    from the harness's own generator in chunks of ``chunk`` steps: one
    launch per chunk, never per step."""

    def __init__(self, seed: int, num_envs: int, num_actions: int, chunk: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.shape = (chunk, num_envs)
        self.num_actions = num_actions
        self.device = device
        self.rows = iter(())

    def chunk(self) -> torch.Tensor:
        return torch.randint(0, self.num_actions, self.shape, generator=self.gen,
                             device=self.device, dtype=torch.int32)

    def next(self) -> torch.Tensor:
        row = next(self.rows, None)
        if row is None:
            self.rows = iter(self.chunk())
            row = next(self.rows)
        return row


class Meter:
    """The per-step checksum and step-end events of a run."""

    def __init__(self, device, chunk: int, spare_events: int = 4096):
        self.device = device
        self.chunk = chunk
        self.bufs: list[torch.Tensor] = []
        self.slot = chunk
        # events on a card only: the CPU tests drive the rest of a run
        self.events = torch.device(device).type == "cuda"
        self.free = ([torch.cuda.Event(enable_timing=True) for _ in range(spare_events)]
                     if self.events else [])
        self.pending: collections.deque = collections.deque()
        self.gaps_ms: list[float] = []
        self.steps = 0
        self.timing = False

    def start(self) -> None:
        """Open the window: the first step's gap starts here."""
        self.gaps_ms.clear()
        self.pending.clear()
        self.steps = 0
        self.timing = self.events
        if self.timing:
            self._record()

    def fold(self, image: torch.Tensor) -> None:
        """The step's observation checksum into its slot of the chunk's
        buffer: one reduction of the observation's bytes read as int64
        words, in their own type, so no cast is launched (a new buffer is
        an allocation, not a launch)."""
        words = image.reshape(-1)
        if words.numel() % 8:
            raise ValueError("the observation's bytes must fill whole int64 words")
        if self.slot == self.chunk:
            self.bufs.append(torch.empty((self.chunk,), dtype=torch.int64,
                                         device=self.device))
            self.slot = 0
        torch.sum(words.view(torch.int64), 0, out=self.bufs[-1][self.slot])
        self.slot += 1

    def warm(self) -> None:
        """The closing sum once outside the window, so that every kernel
        of the loop has run before it."""
        self._total()

    def _total(self) -> torch.Tensor:
        if not self.bufs:
            return torch.zeros((), dtype=torch.int64, device=self.device)
        return torch.cat(self.bufs[:-1] + [self.bufs[-1][:self.slot]]).sum()

    def end_step(self) -> None:
        self.steps += 1
        if self.timing:
            self._record()
            if len(self.pending) > 1024:
                self._harvest()

    def _record(self) -> None:
        ev = self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pending.append(ev)

    def _harvest(self, wait: bool = False) -> None:
        """The gaps between recorded events that the device has passed;
        with ``wait`` (after the window) all of them."""
        while len(self.pending) > 1:
            a, b = self.pending[0], self.pending[1]
            if not wait and not b.query():
                break
            self.gaps_ms.append(a.elapsed_time(b))
            self.free.append(self.pending.popleft())

    def finish(self) -> int:
        """Close the window with a host fetch of the checksum; returns it."""
        value = int(self._total())
        if self.timing:
            self._harvest(wait=True)
        self.timing = False
        return value


def run_window(block, meter: Meter, seconds: float) -> dict:
    """Whole blocks of ``block()`` (which returns the steps it ran) until
    ``seconds`` have passed, then one host fetch.  Returns the steps, the
    elapsed seconds and the step gaps."""
    sync(meter.device)
    t0 = time.perf_counter()
    meter.start()
    steps = 0
    while True:
        steps += block()
        if time.perf_counter() - t0 >= seconds:
            break
    checksum = meter.finish()
    elapsed = time.perf_counter() - t0
    return {"steps": steps, "seconds": elapsed, "gaps_ms": np.asarray(meter.gaps_ms),
            "checksum": checksum}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host-synced spans of the traced run: name -> list of seconds."""

    def __init__(self, device):
        self.device = device
        self.spans: dict[str, list[float]] = collections.defaultdict(list)

    def __call__(self, name: str, fn, *args):
        sync(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        sync(self.device)
        self.spans[name].append(time.perf_counter() - t0)
        return out
