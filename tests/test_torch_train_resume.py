"""``tools/train_ppo.py --checkpoint/--resume`` on the CPU.

A run broken after N updates (saved with ``--checkpoint``, restored with
``--resume``) and continued for M more equals N + M updates straight: every
parameter, Adam's state, the env state (``state_hash``), the key, the episode
tallies and the metrics of the updates after the break, bit for bit.  Both
legs give ``--total-updates`` the whole run's count, so the learning rate
anneals over the same schedule.  The runner restored from the file equals
the one saved.  ``utils/checkpoint.py::max_abs_diff`` is the comparison.
"""

from __future__ import annotations

import pytest
import torch

import minigrid_tpu_torch
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.rl import PPO, PPOConfig
from minigrid_tpu_torch.tools import train_ppo
from minigrid_tpu_torch.utils.checkpoint import load, max_abs_diff, state_hash

from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

CPU = torch.device("cpu")
ENV = "MiniGrid-DoorKey-5x5-v0"
SMALL = ["--env", ENV, "--num-envs", "8", "--num-steps", "8", "--device", "cpu",
         "--seed", "3"]


def _metrics(history: list) -> list:
    return [{k: float(v) for k, v in m.items()} for m in history]


@pytest.mark.parametrize("n,m", [(2, 1), (1, 2)])
def test_resume_equals_the_run_without_the_break(tmp_path, capsys, n, m):
    path = str(tmp_path / "runner.pt")
    total = ["--total-updates", str(n + m)]
    first, first_hist = train_ppo.main(SMALL + total + ["--num-updates", str(n),
                                                        "--checkpoint", path])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == f"runner saved to {path}"
    assert first.train_state.step == n * 4 * 8  # updates x epochs x minibatches

    # the file holds the runner that was saved
    env = minigrid_tpu_torch.make(ENV)
    cfg = PPOConfig(num_envs=8, num_steps=8, num_updates=n + m)
    trainer = PPO(env, env.default_params, cfg, device=CPU)
    restored = load(path, trainer.init(rng.PRNGKey(11, CPU)))
    assert max_abs_diff(restored, first) == 0.0
    assert state_hash(restored.env_state) == state_hash(first.env_state)

    resumed, resumed_hist = train_ppo.main(SMALL + total + ["--num-updates", str(m),
                                                            "--resume", path])
    straight, straight_hist = train_ppo.main(SMALL + ["--num-updates", str(n + m)])
    assert max_abs_diff(resumed, straight) == 0.0
    for a, b in zip(resumed.train_state.model.parameters(),
                    straight.train_state.model.parameters()):
        assert torch.equal(a, b)
    assert state_hash(resumed.env_state) == state_hash(straight.env_state)
    assert torch.equal(resumed.key, straight.key)
    assert _metrics(resumed_hist) == _metrics(straight_hist[n:])
    assert _metrics(first_hist) == _metrics(straight_hist[:n])


def test_max_abs_diff_sees_a_change():
    a = {"x": torch.arange(4.0), "n": 3}
    b = {"x": torch.arange(4.0), "n": 3}
    assert max_abs_diff(a, b) == 0.0
    b["x"][2] = 2.5
    assert max_abs_diff(a, b) == 0.5
    b["x"][1] = float("nan")
    assert max_abs_diff(a, b) != max_abs_diff(a, b)  # NaN
    with pytest.raises(ValueError):
        max_abs_diff(a, {"x": torch.arange(5.0), "n": 3})
