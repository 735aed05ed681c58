"""The port's kernel wrapper, its build, and the port's import hygiene.

The CUDA kernel itself runs only on a card: the tests marked ``gpu`` hold it
against its plain version there and skip elsewhere.  ``chip_smoke.py`` runs
the same comparison at the main path's shapes.  This file imports neither JAX
nor the JAX package, so on a machine with a card and without JAX it runs as

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import minigrid_tpu_torch
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.ops import _build, obs_gather

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "minigrid_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def random_packed(r: np.random.Generator, shape) -> np.ndarray:
    cells = [r.integers(0, 34, shape), r.integers(0, 11, shape), r.integers(0, 3, shape)]
    return (cells[0] | cells[1] << 8 | cells[2] << 16).astype(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    assert path.exists(), path
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "minigrid_tpu"), (path, name)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        minigrid_tpu_torch.make_vec("MiniGrid-DoorKey-8x8-v0", 4)
    with pytest.raises(RuntimeError):
        rng.PRNGKey(0)
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-5x5-v0")
    with pytest.raises(RuntimeError):
        env.generate(torch.zeros((2, 2), dtype=torch.int64), env.default_params)


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    r = np.random.default_rng(0)
    grid = torch.from_numpy(random_packed(r, (5, 8, 8)))
    pos = torch.from_numpy(r.integers(0, 8, (5, 2)).astype(np.int32))
    dirs = torch.from_numpy(r.integers(0, 4, 5).astype(np.int32))
    before = obs_gather.LAUNCHES
    out = obs_gather.gather_view(grid, pos, dirs, 7)
    assert obs_gather.LAUNCHES == before
    assert torch.equal(out, obs_gather.gather_view_plain(grid, pos, dirs, 7))


def test_plain_version_stamps_walls_out_of_bounds():
    """An agent in the corner facing out sees mostly grey wall (0x602);
    facing north (dir 3) the view is the unrotated window."""
    grid = torch.arange(16, dtype=torch.int32).reshape(1, 4, 4) + 100
    pos = torch.tensor([[0, 3]], dtype=torch.int32)
    out = obs_gather.gather_view_plain(grid, pos, torch.tensor([3], dtype=torch.int32), 3)
    # view cell (vi, vj) -> world (x = 0 + vi - 1, y = 3 - (2 - vj))
    want = torch.tensor([[0x602, 0x602, 0x602], [101, 102, 103], [105, 106, 107]],
                        dtype=torch.int32)
    assert torch.equal(out[0], want)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler is an error, never a fallback."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "CUDA_DEFAULT_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()


def test_library_path_follows_source_content(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path(src)
    src.write_text("// two")
    assert _build.library_path(src) != first
    assert first.parent == _build.BUILD_DIR and first.name.startswith("k-")


def test_every_kernel_source_is_built():
    """Each csrc/*.cu has a wrapper module that loads it by name."""
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sources == ["obs_gather"]


# -- on the card ------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("w,h,v", [(8, 8, 7), (9, 5, 7), (6, 9, 5)])
def test_kernel_matches_plain_all_poses(cuda, w, h, v):
    r = np.random.default_rng(w + h + v)
    combos = [(x, y, d) for x in range(w) for y in range(h) for d in range(4)]
    pos = torch.tensor([(x, y) for x, y, _ in combos], dtype=torch.int32)
    dirs = torch.tensor([d for *_, d in combos], dtype=torch.int32)
    grid = torch.from_numpy(random_packed(r, (len(combos), w, h)))
    want = obs_gather.gather_view_plain(grid, pos, dirs, v)
    before = obs_gather.LAUNCHES
    got = obs_gather.gather_view(grid.to(cuda), pos.to(cuda), dirs.to(cuda), v)
    torch.cuda.synchronize()
    assert obs_gather.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_it_does_not_take(cuda):
    grid = torch.zeros((4, 8, 8), dtype=torch.int32, device=cuda)
    pos = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    dirs = torch.zeros((4,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        obs_gather.gather_view(grid.long(), pos, dirs, 7)
    with pytest.raises(ValueError):
        obs_gather.gather_view(grid, pos[:3], dirs, 7)
    with pytest.raises(ValueError):
        obs_gather.gather_view(grid.transpose(1, 2), pos, dirs, 7)
    with pytest.raises(ValueError):
        obs_gather.gather_view(grid, pos.cpu(), dirs, 7)


@pytest.mark.gpu
def test_goal_reward_card_matches_cpu(cuda):
    from minigrid_tpu_torch.core.step import goal_reward

    count = torch.arange(1, 3000, dtype=torch.int32)
    limit = torch.full((2999,), 2999.0)
    assert torch.equal(goal_reward(count.to(cuda), limit.to(cuda)).cpu(),
                       goal_reward(count, limit))


@pytest.mark.gpu
def test_observations_on_the_card_go_through_the_kernel(cuda):
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0")
    p = env.default_params
    keys = rng.split(rng.PRNGKey(0, cuda), 64)
    before = obs_gather.LAUNCHES
    obs, st = env.reset(keys, p, device=cuda)
    assert obs_gather.LAUNCHES == before + 1
    cpu_obs, _ = env.reset(keys.cpu(), p, device="cpu")
    assert torch.equal(obs["image"].cpu(), cpu_obs["image"])
