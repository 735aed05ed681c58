"""Keyboard play (re-derivation of minigrid/manual_control.py:12-121).

Counterpart of ``minigrid_tpu/tools/manual_control.py``: drives ``Env.reset``
and ``Env.step`` on a batch of one and shows ``Env.get_frame`` in a
:class:`~minigrid_tpu_torch.utils.window.Window` (matplotlib, imported only
when no window is passed in).  Run on the card:

    python -m minigrid_tpu_torch.tools.manual_control [--env ID] [--seed N] \
        [--tile-size 32] [--device cuda]
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.core.env import Env
from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.core.step import Actions

KEY_TO_ACTION = {
    "left": Actions.left,
    "right": Actions.right,
    "up": Actions.forward,
    " ": Actions.toggle,
    "pageup": Actions.pickup,
    "pagedown": Actions.drop,
    "enter": Actions.done,
}


class ManualControl:
    def __init__(self, env: Env, params=None, seed: int | None = None,
                 tile_size: int = 32, window=None, device=None):
        self.env = env
        self.params = params if params is not None else env.default_params
        self.seed = seed
        self.tile_size = tile_size
        self.device = resolve_device(device)
        if window is None:
            from minigrid_tpu_torch.utils.window import Window

            window = Window("minigrid-tpu-torch")
        self.window = window
        self.window.reg_key_handler(self.key_handler)
        self.state = None

    def start(self):
        self.reset()
        self.window.show(block=True)

    def redraw(self):
        frame = self.env.get_frame(self.state, self.params, tile_size=self.tile_size)
        self.window.show_img(frame[0].cpu().numpy())

    def reset(self):
        import random

        seed = self.seed if self.seed is not None else random.randrange(2**31)
        key = rng.PRNGKey(seed, self.device)[None]
        obs, self.state = self.env.reset(key, self.params, self.device)
        self.window.set_caption(
            self.env.mission_text(self.state.mission[0].cpu().numpy()))
        self.redraw()

    def step(self, action: int):
        a = torch.full((1,), action, dtype=torch.int32, device=self.device)
        obs, self.state, reward, term, trunc, _ = self.env.step(self.state, a, self.params)
        term, trunc = bool(term[0]), bool(trunc[0])
        print(f"step={int(self.state.step_count[0])}, reward={float(reward[0]):.2f}")
        if term or trunc:
            print("terminated!" if term else "truncated!")
            self.reset()
        else:
            self.redraw()

    def key_handler(self, event):
        key = event.key
        if key == "escape":
            self.window.close()
            return
        if key == "backspace":
            self.reset()
            return
        if key in KEY_TO_ACTION:
            self.step(int(KEY_TO_ACTION[key]))


def main(argv=None):
    import argparse

    import minigrid_tpu_torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="MiniGrid-MultiRoom-N6-v0")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--tile-size", type=int, default=32)
    parser.add_argument("--device", default=None, help="'cpu' to run on the CPU")
    args = parser.parse_args(argv)

    env = minigrid_tpu_torch.make(args.env)
    ManualControl(env, seed=args.seed, tile_size=args.tile_size,
                  device=args.device).start()


if __name__ == "__main__":
    main()
