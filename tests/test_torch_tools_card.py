"""The port's host tools on a card: ``tools/profile.py``'s trace and
``tools/smoke.py``'s gate.  The CPU side of the tools is held against the
JAX package in ``tests/test_torch_tools_*.py``; this file imports neither
JAX nor the JAX package, so on a machine with a card and without JAX it
runs as

    python -m pytest tests/test_torch_tools_card.py --noconftest -q
"""

from __future__ import annotations

import pytest

from minigrid_tpu_torch.ops import obs_gather

from tests.test_torch_kernels import cuda  # noqa: F401  (skips without a card)


@pytest.mark.gpu
def test_profile_trace_names_the_obs_gather_kernel(cuda, tmp_path):
    """``tools/profile.py``'s trace of a pooled DoorKey rollout on the card:
    the ``obs_gather`` kernel is among the device kernels, once per
    observation (the reset's and each step's), and the launches and idle
    share are read from the same trace."""
    from minigrid_tpu_torch.tools import profile

    res = profile.profile_rollout("MiniGrid-DoorKey-8x8-v0", 256, 16, str(tmp_path),
                                  reset_strategy="pooled", pool_refill=16,
                                  refill_period=8, device=cuda)
    rows = profile.top_kernels(str(tmp_path), None)
    assert res["kernels"] == rows[:15]
    gathers = [calls for name, _, calls in rows if "obs_gather_kernel" in name]
    assert gathers == [16 + 1], rows
    assert res["launches_per_step"] > 1 and 0 <= res["device_idle_share"] < 1


@pytest.mark.gpu
def test_run_smoke_on_the_card(cuda, capsys):
    """``tools/smoke.py`` on the card: the gather check over the plain
    version and the kernel, then the kernel gate at B=4096."""
    from minigrid_tpu_torch.tools import smoke

    before = obs_gather.LAUNCHES
    smoke.run_smoke(device=cuda)
    captured = capsys.readouterr()
    assert captured.out.splitlines()[-1] == "SMOKE OK"
    assert "device kernel gate ok" in captured.err
    assert obs_gather.LAUNCHES == before + 2  # the check's launch and the gate's
