"""The port's ``tools/manual_control.py`` and ``tools/smoke.py`` on the CPU.

``ManualControl`` is driven by fake key events against a fake window (the
reference's only mocked test, ref tests/test_scripts.py:35-73) beside the
JAX package's under the same keys and seed: every caption, frame and printed
line equal.  The smoke gate passes, and refuses a gather that flips one
cell (the port's counterpart of the JAX package's sabotage test).  The
card's side runs in ``tests/test_torch_tools_card.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import minigrid_tpu
from minigrid_tpu.tools.manual_control import ManualControl as JaxManualControl

import minigrid_tpu_torch
from minigrid_tpu_torch.ops import obs_gather
from minigrid_tpu_torch.tools import smoke
from minigrid_tpu_torch.tools.manual_control import KEY_TO_ACTION, ManualControl

from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

ROOT = Path(__file__).resolve().parent.parent
KEYS = ["up", "up", "right", "up", "left", " ", "backspace"]


class FakeEvent:
    def __init__(self, key):
        self.key = key


class FakeWindow:
    def __init__(self):
        self.images = []
        self.captions = []
        self.closed = False
        self.handler = None

    def reg_key_handler(self, h):
        self.handler = h

    def show_img(self, img):
        self.images.append(np.asarray(img))

    def set_caption(self, text):
        self.captions.append(text)

    def show(self, block=True):
        pass

    def close(self):
        self.closed = True


def play(mc_cls, env, keys, capsys, **kwargs) -> tuple[FakeWindow, str]:
    win = FakeWindow()
    mc = mc_cls(env, seed=3, window=win, **kwargs)
    mc.reset()
    for key in keys:
        win.handler(FakeEvent(key))
    return win, capsys.readouterr().out


def jitted_frames(env):
    """The JAX env with its ``get_frame`` jitted (the same values; eager it
    takes seconds a frame)."""
    frame = jax.jit(env.get_frame, static_argnames=("tile_size",))
    env.get_frame = lambda state, params, tile_size: frame(state, params,
                                                          tile_size=tile_size)
    return env


@pytest.mark.parametrize("env_id,keys,ends", [
    ("MiniGrid-Empty-5x5-v0", KEYS, False),
    # east twice, turn south, down twice onto the goal: the episode ends and
    # resets, then one more step
    ("MiniGrid-Empty-5x5-v0", ["up", "up", "right", "up", "up", "left"], True),
])
def test_manual_control_matches_jax(env_id, keys, ends, capsys):
    win, out = play(ManualControl, minigrid_tpu_torch.make(env_id), keys, capsys,
                    device="cpu")
    jwin, jout = play(JaxManualControl, jitted_frames(minigrid_tpu.make(env_id)), keys,
                      capsys)
    assert out == jout
    assert win.captions == jwin.captions and win.captions
    assert len(win.images) == len(jwin.images) > 3
    for got, want in zip(win.images, jwin.images):
        assert got.dtype == want.dtype and got.shape == want.shape == (160, 160, 3)
        np.testing.assert_array_equal(got, want)
    assert ("terminated!" in jout) == ends
    assert len(win.captions) == 1 + ends + keys.count("backspace")


def test_manual_control_with_fake_window(capsys):
    """The port's copy of tests/test_tools.py's manual-control test."""
    env = minigrid_tpu_torch.make("MiniGrid-Empty-5x5-v0")
    win = FakeWindow()
    mc = ManualControl(env, seed=3, window=win, device="cpu")
    mc.reset()
    assert win.images and win.images[-1].shape == (160, 160, 3)
    for key in KEYS:
        win.handler(FakeEvent(key))
    assert len(win.images) > 3
    assert win.captions and isinstance(win.captions[-1], str)
    win.handler(FakeEvent("escape"))
    assert win.closed
    assert set(KEY_TO_ACTION) == {"left", "right", "up", " ", "pageup", "pagedown",
                                  "enter"}


def test_manual_control_imports_no_window_or_gym_when_given_a_window():
    code = (
        "import sys\n"
        "import minigrid_tpu_torch\n"
        "from minigrid_tpu_torch.tools.manual_control import ManualControl\n"
        "class W:\n"
        "    def __getattr__(self, name):\n"
        "        return lambda *a, **k: None\n"
        "mc = ManualControl(minigrid_tpu_torch.make('MiniGrid-Empty-5x5-v0'), seed=0,\n"
        "                   window=W(), device='cpu')\n"
        "mc.reset(); mc.step(2)\n"
        "bad = [m for m in ('matplotlib', 'gymnasium', 'minigrid_tpu_torch.gym_compat',\n"
        "                   'minigrid_tpu_torch.utils.window') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('NO-WINDOW-OK')\n"
    )
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0 and "NO-WINDOW-OK" in done.stdout, (done.stdout, done.stderr)


def test_run_smoke_passes_on_the_cpu(capsys):
    smoke.run_smoke(device="cpu")
    captured = capsys.readouterr()
    assert captured.out.splitlines()[-1] == "SMOKE OK"
    assert "lockstep skipped" in captured.err and "device gate skipped" in captured.err


def test_gather_check_catches_one_flipped_cell(monkeypatch):
    plain = obs_gather.gather_view_plain

    def sabotaged(grid, agent_pos, agent_dir, view_size):
        out = plain(grid, agent_pos, agent_dir, view_size).clone()
        out[-1, 0, 0] ^= 1  # one cell of the last env (direction 3)
        return out

    smoke._check_gather_impls("cpu")
    monkeypatch.setattr(obs_gather, "gather_view_plain", sabotaged)
    with pytest.raises(AssertionError, match="disagrees") as err:
        smoke._check_gather_impls("cpu")
    assert "agent_dir=3" in str(err.value)
    with pytest.raises(AssertionError, match="disagrees"):
        smoke.run_smoke(device="cpu")


def test_reference_view_is_the_plain_gather():
    rng = np.random.default_rng(3)
    w, h, v = 5, 8, 5
    grid = rng.integers(0, 2**20, (w, h)).astype(np.int32)
    for x, y, d in [(0, 0, 0), (4, 7, 1), (2, 3, 2), (1, 6, 3), (3, 1, 3)]:
        want = obs_gather.gather_view_plain(
            torch.from_numpy(grid)[None], torch.tensor([[x, y]], dtype=torch.int32),
            torch.tensor([d], dtype=torch.int32), v)[0].numpy()
        got = smoke._reference_view(grid, x, y, d, v, obs_gather.WALL_PACKED)
        np.testing.assert_array_equal(got, want, err_msg=f"{x} {y} {d}")


def test_lockstep_skips_without_the_reference(monkeypatch):
    monkeypatch.setitem(sys.modules, "minigrid", None)  # import minigrid raises
    assert smoke._lockstep_vs_reference("cpu") is False


def test_device_kernel_gate_is_battery_s_and_skips_off_the_card(monkeypatch):
    from minigrid_tpu_torch.tools import battery

    assert smoke.device_kernel_gate is battery.device_kernel_gate
    assert smoke.device_kernel_gate(device="cpu") is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        smoke.run_smoke()


# -- examples/custom_env_torch.py against examples/custom_env.py --------------------

COURIER = "MiniGrid-LavaCourier-9x9-v0"


def _load_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def couriers():
    """Both examples' LavaCourier envs; the id each registers is taken out of
    both registries again afterwards, so later tests see the stock ids."""
    from minigrid_tpu import registry as jregistry
    from minigrid_tpu_torch import registry

    try:
        yield _load_example("custom_env").LavaCourierEnv, _load_example(
            "custom_env_torch").LavaCourierEnv
    finally:
        jregistry._REGISTRY.pop(COURIER, None)
        registry._REGISTRY.pop(COURIER, None)


def test_custom_env_example_generates_jax_s_levels(couriers):
    from tests.test_torch_bridge import assert_state_equal

    jcls, cls = couriers
    assert minigrid_tpu_torch.spec(COURIER).cls is cls
    jenv, env = jcls(size=9), cls(size=9)
    jkeys = jax.random.split(jax.random.PRNGKey(5), 32)
    want = jax.jit(jax.vmap(lambda k: jenv.generate(k, jenv.default_params)))(jkeys)
    keys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    assert_state_equal(env.generate(keys, env.default_params, "cpu"), want, "LavaCourier: ")
    assert env.mission_text(None) == jenv.mission_text(None)


def test_custom_env_example_steps_in_lockstep_with_jax(couriers):
    """16 envs for 24 steps at max_steps 8 (three waves of auto-resets):
    every observation, reward bit and flag the JAX example's."""
    from minigrid_tpu.parallel.vector import VectorEnv as JVectorEnv

    from minigrid_tpu_torch.parallel.vector import VectorEnv
    from tests.test_torch_zoo_step import lockstep

    jcls, cls = couriers
    jvenv = JVectorEnv(jcls(size=9, max_steps=8), 16)
    venv = VectorEnv(cls(size=9, max_steps=8), 16, device="cpu")
    rewards, ends, _, _ = lockstep(jvenv, venv, 3, 24)
    assert ends >= 16
