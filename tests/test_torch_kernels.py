"""The port's kernel wrappers, their build and launch seam, and the port's
import hygiene.

The CUDA kernels themselves run only on a card: the tests marked ``gpu`` hold
them against their plain versions there and skip elsewhere.  ``chip_smoke.py`` runs
the same comparison at the main path's shapes.  This file imports neither JAX
nor the JAX package, so on a machine with a card and without JAX it runs as

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

from __future__ import annotations

import ast
import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import minigrid_tpu_torch
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.ops import _build, descs, distractors, fused_step, obs_gather, threefry
from minigrid_tpu_torch.utils import trace

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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        minigrid_tpu_torch.FusedVectorEnv(env, 4)


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    r = np.random.default_rng(0)
    grid = torch.from_numpy(random_packed(r, (5, 8, 8)))
    pos = torch.from_numpy(r.integers(0, 8, (5, 2)).astype(np.int32))
    dirs = torch.from_numpy(r.integers(0, 4, 5).astype(np.int32))
    before = trace.launches("obs_gather")
    out = obs_gather.gather_view(grid, pos, dirs, 7)
    assert trace.launches("obs_gather") == before
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
    """Each csrc/*.cu has a wrapper whose ``Kernel`` loads it by name."""
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sources == sorted(KERNELS) == ["descs", "distractors", "fused_step", "obs_gather",
                                          "threefry"]


def _fused_inputs(env_id: str, n: int, device, seed: int = 0, walk: int = 12,
                  **overrides):
    """Fused planes after a random walk of ``env_id`` and a step's actions,
    key and index, on ``device``."""
    env = minigrid_tpu_torch.make(env_id, **overrides)
    p = env.default_params
    k_gen, k_walk, k_step = rng.split(rng.PRNGKey(seed, "cpu"), 3).unbind(0)
    st = env.generate(rng.split(k_gen, n), p, "cpu")
    for k in rng.split(k_walk, walk):
        st = env.step_state(st, rng.randint(k, (n,), 0, 8), p)[0]
    fs = fused_step.planes_from_states(st)
    args = (fs["grid"], fs["agent"], rng.randint(k_step, (n,), 0, 8), k_step,
            torch.tensor(3, dtype=torch.int32))
    return tuple(a.to(device) for a in args), fused_step.fused_spec(env, p)


def test_fused_cpu_tensors_take_the_plain_version_and_do_not_count():
    args, spec = _fused_inputs("MiniGrid-DoorKey-8x8-v0", 6, "cpu")
    before = trace.launches("fused_step")
    got = fused_step.fused_step(*args, spec)
    assert trace.launches("fused_step") == before
    want = fused_step.fused_step_plain(*args, spec)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    grid, agent, image, reward, term, trunc, key, t = got
    assert image.dtype == torch.uint8 and image.shape == (6, 7, 7, 3)
    assert agent.shape == (6, 8) and (agent[:, 6:] == 0).all()
    assert reward.dtype == torch.float32 and term.dtype == trunc.dtype == torch.bool
    assert key.dtype == torch.int64 and int(t) == 4


def test_fused_wrapper_rejects_what_it_does_not_take():
    """Checked before the device is looked at, so on the CPU too."""
    (grid, agent, action, key, t), spec = _fused_inputs("MiniGrid-DoorKey-5x5-v0", 4, "cpu")
    fs = fused_step.fused_step
    with pytest.raises(TypeError):
        fs(grid.long(), agent, action, key, t, spec)
    with pytest.raises(TypeError):
        fs(grid, agent, action.long(), key, t, spec)
    with pytest.raises(TypeError):
        fs(grid, agent, action, key.int(), t, spec)
    with pytest.raises(ValueError):
        fs(grid, agent[:, :6].contiguous(), action, key, t, spec)
    with pytest.raises(ValueError):
        fs(grid, agent, action[:3], key, t, spec)
    with pytest.raises(ValueError):
        fs(grid.transpose(1, 2), agent, action, key, t, spec)
    with pytest.raises(ValueError):  # grid of another size than the spec's
        fs(grid[:, :4, :4].contiguous(), agent, action, key, t, spec)
    with pytest.raises(ValueError):
        fs(grid, agent, action, key, t.reshape(1), spec)
    with pytest.raises(ValueError):
        fs(grid[:0], agent[:0], action[:0], key, t, spec)
    for view in (4, 33):
        with pytest.raises(ValueError):
            fs(grid, agent, action, key, t, dataclasses.replace(spec, view=view))


def test_fused_kernel_constants_are_the_tables():
    """csrc/fused_step.cu and the header it shares with obs_gather.cu keep
    their own copy of the type, state and color ids and of the generator
    ids; they must be the port's."""
    src = "\n".join(p.read_text() for p in
                    [_build.CSRC / "fused_step.cu", *sorted(_build.CSRC.glob("*.cuh"))])
    consts = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    T, S, K = C.OBJECT_TO_IDX, C.STATE_TO_IDX, C.COLOR_TO_IDX
    # view_tile.cuh's ``transparent`` is SEE_BEHIND as "every type but the wall"
    assert np.flatnonzero(~C.SEE_BEHIND).tolist() == [T["wall"]]
    want = {"kEmpty": T["empty"], "kWall": T["wall"], "kDoor": T["door"],
            "kKey": T["key"], "kBall": T["ball"], "kGoal": T["goal"],
            "kLava": T["lava"], "kOpen": S["open"], "kLocked": S["locked"],
            "kGreen": K["green"], "kYellow": K["yellow"], "kGrey": K["grey"],
            "kGenDoorKey": fused_step.GEN_DOORKEY,
            "kGenEmptyRandom": fused_step.GEN_EMPTY_RANDOM,
            "kMaxView": fused_step.MAX_VIEW}
    assert {k: consts.get(k) for k in want} == want


def _constants(name: str) -> dict:
    src = (_build.CSRC / f"{name}.cu").read_text()
    return {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_wrappers_know_the_kernels_tiles():
    assert _constants("fused_step")["kTile"] == fused_step.TILE
    assert _constants("obs_gather")["kTile"] == obs_gather.TILE
    consts = _constants("obs_gather")
    assert [consts[k] for k in ("kWindow", "kImage", "kGrid", "kMaxView")] == [
        obs_gather.WINDOW, obs_gather.IMAGE, obs_gather.GRID, obs_gather.MAX_VIEW]
    assert _constants("fused_step")["kAgentWidth"] == fused_step.A_WIDTH
    consts = _constants("distractors")
    assert (consts["kWarps"], consts["kCombos"], consts["kEmpty"]) == (
        distractors.WARPS, distractors.NUM_COMBOS, C.OBJECT_TO_IDX["empty"])
    assert [consts[k] for k in ("kAllUnique", "kDrawI", "kDrawJ", "kOverride")] == [
        distractors.ALL_UNIQUE, distractors.DRAW_I, distractors.DRAW_J, distractors.OVERRIDE]


def test_kernel_ab_phase_lines_are_in_the_sources():
    """tools/kernel_ab.py cuts the current kernels before each phase's
    first line: each must be in its source once."""
    from minigrid_tpu_torch.tools import kernel_ab

    for kernel, phases in kernel_ab.PHASES.items():
        src = (_build.CSRC / f"{kernel}.cu").read_text()
        for line in phases.values():
            assert src.count(line) == 1, (kernel, line)


def _tile_bytes_in_source(name: str):
    """The C expression of ``tile_bytes(WH[, V[, mode]])`` in csrc/<name>.cu,
    as a Python function of (WH, V, mode)."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    body = re.search(r"int tile_bytes\([^)]*\) \{\s*return (.*?);", src, re.S)[1]
    return lambda wh, v, mode=0: eval(  # noqa: S307
        body, {}, {**_constants(name), "WH": wh, "V": v, "mode": mode})


@pytest.mark.parametrize("w,h,v", [(8, 8, 7), (5, 5, 3), (16, 16, 11), (40, 40, 7),
                                   (9, 6, 31)])
def test_wrappers_size_the_tile_as_the_kernels_do(w, h, v):
    """The wrappers' shared-memory sizes are the kernels' own formulas."""
    assert fused_step.fused_tile_bytes(w, h, v) == _tile_bytes_in_source("fused_step")(w * h, v)
    assert obs_gather.gather_tile_bytes(w, h) == _tile_bytes_in_source("obs_gather")(w * h, v)
    assert distractors.tile_bytes(w, h) == _tile_bytes_in_source("distractors")(w * h, v)
    assert descs.tile_bytes(w, h) == _tile_bytes_in_source("descs")(w * h, v)
    assert fused_step.fused_tile_bytes(8, 8, 7) == 8112


@pytest.mark.parametrize("mode", [obs_gather.WINDOW, obs_gather.IMAGE, obs_gather.GRID])
@pytest.mark.parametrize("w,h,v", [(8, 8, 7), (16, 16, 7), (25, 25, 31), (9, 6, 3)])
def test_gather_tile_bytes_counts_each_mode_as_the_kernel_does(mode, w, h, v):
    """The observation modes stage the carried triples and the view's
    column words and output beside the window's tile."""
    got = obs_gather.gather_tile_bytes(w, h, v, mode)
    assert got == _tile_bytes_in_source("obs_gather")(w * h, v, mode)
    extra = {obs_gather.WINDOW: 0, obs_gather.IMAGE: 3 * v * v, obs_gather.GRID: 5 * v * v}[mode]
    window = obs_gather.gather_tile_bytes(w, h)
    assert got == window + (obs_gather.TILE * (4 * v + extra + 3) if mode else 0)
    assert obs_gather.gather_tile_bytes(8, 8, 7, obs_gather.IMAGE) == 8576 + 5696


def test_fused_wrapper_refuses_a_tile_over_shared_memory():
    """A grid whose tile of envs exceeds a block's 227 KB of shared memory,
    or a batch past 32-bit indices, is refused before the device is looked
    at, so on the CPU too."""
    (grid, agent, action, key, t), spec = _fused_inputs("MiniGrid-DoorKey-5x5-v0", 4, "cpu")
    big = dataclasses.replace(spec, width=60, height=60)
    assert fused_step.fused_tile_bytes(60, 60, 7) > _build.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        fused_step.fused_step(torch.zeros((4, 60, 60), dtype=torch.int32), agent, action,
                              key, t, big)
    wide = dataclasses.replace(spec, width=32, height=32)
    n = 2 ** 31 // (32 * 32) + 1
    huge = torch.zeros((1, 32, 32), dtype=torch.int32).expand(n, 32, 32)
    with pytest.raises(ValueError, match="32-bit"):
        fused_step.fused_step(huge, agent, action, key, t, wide)
    # the largest DoorKey that fits still takes the plain version on the CPU
    fits = dataclasses.replace(spec, width=56, height=56)
    assert fused_step.fused_tile_bytes(56, 56, 7) <= _build.MAX_SHARED_BYTES
    (g2, a2, act2, k2, t2), spec2 = _fused_inputs("MiniGrid-DoorKey-8x8-v0", 2, "cpu",
                                                  size=56, max_steps=50)
    assert spec2.width == fits.width
    out = fused_step.fused_step(g2, a2, act2, k2, t2, spec2)
    assert out[0].shape == (2, 56, 56)


# -- the launch seam (ops/_build.py::Kernel) ------------------------------------------

KERNELS = {k.name: k for k in (obs_gather.KERNEL, fused_step.KERNEL, threefry.KERNEL,
                               distractors.KERNEL, descs.KERNEL)}
STREAM = 77  # the stand-in card's current stream handle


@pytest.fixture
def stub_card(monkeypatch):
    """A CUDA device for ``Kernel.launch`` off the card: device 0 is
    current, its stream handle STREAM; the running launch counts are put
    back afterwards.  A test substitutes the C entry."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: STREAM,
                        raising=False)
    monkeypatch.setattr(trace, "_launches", dict(trace._launches))
    return torch.device("cuda", 0)


def _call_on_meta(name: str) -> None:
    """``name``'s wrapper with every tensor on the meta device, where each
    check before the device's passes."""
    if name == "obs_gather":
        pos = torch.zeros((2, 2), dtype=torch.int32, device="meta")
        obs_gather.gather_view(torch.zeros((2, 8, 8), dtype=torch.int32, device="meta"), pos,
                               pos[:, 0].contiguous(), 7)
    elif name == "fused_step":
        args, spec = _fused_inputs("MiniGrid-DoorKey-5x5-v0", 4, "meta")
        fused_step.fused_step(*args, spec)
    elif name == "threefry":
        threefry.split(torch.zeros((4, 2), dtype=torch.int64, device="meta"), 2)
    elif name == "descs":
        args = _descs_args()
        descs.draw(**{k: ({f: t.to("meta") for f, t in v.items()} if k == "b" else
                          v.to("meta") if isinstance(v, torch.Tensor) else v)
                      for k, v in args.items()})
    else:
        args = _distractor_args()
        distractors.place(**{**args, "b": {k: v.to("meta") for k, v in args["b"].items()},
                             "keys": args["keys"].to("meta")})


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_a_device_without_the_kernel_raises(name):
    before = trace.launches(name)
    with pytest.raises(ValueError, match=f"^no {name} kernel for device meta$"):
        _call_on_meta(name)
    assert trace.launches(name) == before


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_a_failed_launch_raises_with_the_kernel_and_its_error(name, stub_card):
    kernel = KERNELS[name]
    before = trace.launches(name)
    with kernel.substituted(lambda *args: 700):
        with pytest.raises(RuntimeError, match=f"^{name} kernel launch failed: CUDA error 700$"):
            kernel.launch(stub_card, 1, 2)
    assert trace.launches(name) == before


def test_kernel_binds_its_entry_with_the_stream_last():
    """``bind`` types the C entry of the kernel's name (the wrapper's
    arguments, then the stream) on any library, as ``tools/kernel_ab.py``
    binds another build; the distractors kernel first checks its ``Args``."""
    class Lib:
        distractors_args_size = staticmethod(lambda: ctypes.sizeof(distractors.Args))

    lib = Lib()
    for name, kernel in KERNELS.items():
        setattr(lib, name, type("Entry", (), {})())
        fn = kernel.bind(lib)
        assert fn is getattr(lib, name) and fn.restype is ctypes.c_int
        assert fn.argtypes == [*kernel.argtypes, ctypes.c_void_p]
    Lib.distractors_args_size = staticmethod(lambda: 4)
    with pytest.raises(RuntimeError, match="Args is 4 bytes"):
        distractors.KERNEL.bind(lib)


# -- the observation modes (ops/obs_gather.py) -------------------------------------

def _observe_inputs(r: np.random.Generator, n: int, w: int, h: int, all_poses: bool = False):
    """grid, agent_pos, agent_dir, carrying on the CPU: walls and doors in
    all three states over random cells, every carried type in turn (empty
    hands first), every pose and direction with ``all_poses``."""
    if all_poses:
        combos = [(x, y, d) for x in range(w) for y in range(h) for d in range(4)]
        n = len(combos)
        pos = np.array([(x, y) for x, y, _ in combos])
        dirs = np.array([d for *_, d in combos])
    else:
        pos = np.stack([r.integers(0, w, n), r.integers(0, h, n)], 1)
        dirs = r.integers(0, 4, n)
    grid = random_packed(r, (n, w, h))
    wall, door = C.OBJECT_TO_IDX["wall"], C.OBJECT_TO_IDX["door"]
    kind = r.random((n, w, h))
    grid = np.where(kind < 0.25, wall | C.COLOR_TO_IDX["grey"] << 8, grid)
    grid = np.where((kind >= 0.25) & (kind < 0.4),
                    door | r.integers(0, 6, (n, w, h)) << 8 | r.integers(0, 3, (n, w, h)) << 16,
                    grid).astype(np.int32)
    types = (np.arange(n) + C.OBJECT_TO_IDX["empty"]) % C.NUM_OBJECT_TYPES
    carrying = np.stack([types, np.where(types == C.OBJECT_TO_IDX["empty"], 0,
                                         r.integers(0, 6, n)),
                         np.zeros(n, dtype=np.int64)], 1).astype(np.uint8)
    return (torch.from_numpy(grid), torch.from_numpy(pos.astype(np.int32)),
            torch.from_numpy(dirs.astype(np.int32)), torch.from_numpy(carrying))


@pytest.mark.parametrize("see_through", [False, True])
def test_observe_cpu_tensors_take_the_plain_path_and_do_not_count(see_through):
    """On the CPU the image and the window with its mask are core/obs.py's
    plain path; neither the launch nor the occlusion counter counts."""
    from minigrid_tpu_torch.core import obs

    args = (*_observe_inputs(np.random.default_rng(3), 9, 8, 8), 7, see_through)
    before = trace.launches("obs_gather")
    trace.reset()
    trace.enable()
    try:
        image = obs_gather.observe_image(*args)
        cells, vis = obs_gather.observe_grid(*args)
        counters = trace.report()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert trace.launches("obs_gather") == before
    assert obs_gather.OCCLUSION_COUNTER not in counters
    want_cells, want_vis = obs.observe_grid_plain(*args)
    assert torch.equal(cells, want_cells) and torch.equal(vis, want_vis)
    assert torch.equal(image, obs.encode_view(want_cells, want_vis))
    if see_through:
        assert bool(vis.all())


def _observe_meta(n: int = 4, w: int = 8, h: int = 8) -> dict:
    meta = torch.device("meta")
    return dict(grid=torch.zeros((n, w, h), dtype=torch.int32, device=meta),
                agent_pos=torch.zeros((n, 2), dtype=torch.int32, device=meta),
                agent_dir=torch.zeros((n,), dtype=torch.int32, device=meta),
                carrying=torch.zeros((n, 3), dtype=torch.uint8, device=meta),
                view_size=7, see_through=False)


@pytest.mark.parametrize("fn", ["observe_image", "observe_grid"])
@pytest.mark.parametrize("what,change,error", [
    ("grid int64", lambda a: dict(grid=a["grid"].long()), TypeError),
    ("grid [B, W]", lambda a: dict(grid=a["grid"][:, :, 0]), ValueError),
    ("grid transposed", lambda a: dict(grid=a["grid"].transpose(1, 2)), ValueError),
    ("agent_pos int64", lambda a: dict(agent_pos=a["agent_pos"].long()), TypeError),
    ("agent_pos [B, 3]", lambda a: dict(agent_pos=torch.zeros((4, 3), dtype=torch.int32,
                                                              device="meta")), ValueError),
    ("agent_dir int64", lambda a: dict(agent_dir=a["agent_dir"].long()), TypeError),
    ("agent_dir on the CPU", lambda a: dict(agent_dir=torch.zeros(4, dtype=torch.int32)),
     ValueError),
    ("carrying int32", lambda a: dict(carrying=a["carrying"].int()), TypeError),
    ("carrying [B - 1, 3]", lambda a: dict(carrying=a["carrying"][:3]), ValueError),
    ("carrying [3, B]", lambda a: dict(carrying=a["carrying"].t()), ValueError),
    ("carrying on the CPU", lambda a: dict(carrying=torch.zeros((4, 3), dtype=torch.uint8)),
     ValueError),
    ("view 0", lambda a: dict(view_size=0), ValueError),
    ("view 32", lambda a: dict(view_size=32), ValueError),
    ("tile over shared memory", lambda a: dict(
        grid=torch.zeros((4, 40, 40), dtype=torch.int32, device="meta"), view_size=31),
     ValueError),
])
def test_observe_wrappers_reject_what_they_do_not_take(fn, what, change, error, stub_card):
    """Forms the kernel does not take are refused before the device is
    looked at, and so before any launch; what it takes reaches the device
    check, which refuses the meta device."""
    def refuse(*args):
        raise AssertionError("a refused call reached the kernel")

    args = _observe_meta()
    before = trace.launches("obs_gather")
    with obs_gather.KERNEL.substituted(refuse):
        with pytest.raises(error):
            getattr(obs_gather, fn)(**{**args, **change(args)})
        with pytest.raises(ValueError, match="no obs_gather kernel for device meta"):
            getattr(obs_gather, fn)(**args)
    assert trace.launches("obs_gather") == before


@pytest.mark.parametrize("fn,mode,outs", [("observe_image", obs_gather.IMAGE, [(5, 7, 7, 3)]),
                                          ("observe_grid", obs_gather.GRID,
                                           [(5, 7, 7), (5, 7, 7)]),
                                          ("gather_view", obs_gather.WINDOW, [(5, 7, 7)])])
@pytest.mark.parametrize("see_through", [False, True])
def test_observe_is_one_launch_that_counts_its_occlusion(fn, mode, outs, see_through,
                                                         stub_card, monkeypatch):
    """Each call is one launch in its mode, with the shapes and flag the C
    entry takes; while tracing, a launch that occluded counts once in
    ``obs.occlusion_kernel``."""
    monkeypatch.setattr(obs_gather.KERNEL, "check_device", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)  # the meta device's index
    calls = []
    args = _observe_meta(n=5, w=9, h=6)
    if fn == "gather_view":
        call = (args["grid"], args["agent_pos"], args["agent_dir"], 7)
    else:
        call = tuple({**args, "see_through": see_through}.values())
    before = trace.launches("obs_gather")
    trace.reset()
    trace.enable()
    try:
        with obs_gather.KERNEL.substituted(lambda *a: calls.append(a) or 0):
            got = getattr(obs_gather, fn)(*call)
        counters = trace.report()["counters"]
    finally:
        trace.disable()
        trace.reset()
    got = got if isinstance(got, tuple) else (got,)
    assert [tuple(t.shape) for t in got] == outs
    assert trace.launches("obs_gather") == before + 1
    (c,) = calls
    assert c[6:] == (5, 9, 6, 7, mode, int(see_through and mode != obs_gather.WINDOW), STREAM)
    assert (c[3] is None) == (mode == obs_gather.WINDOW) and (c[5] is None) == (
        mode != obs_gather.GRID)
    occluded = mode != obs_gather.WINDOW and not see_through
    assert counters.get(obs_gather.OCCLUSION_COUNTER, 0) == int(occluded)


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
    before = trace.launches("obs_gather")
    got = obs_gather.gather_view(grid.to(cuda), pos.to(cuda), dirs.to(cuda), v)
    torch.cuda.synchronize()
    assert trace.launches("obs_gather") == before + 1
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
    before = trace.launches("obs_gather")
    obs, st = env.reset(keys, p, device=cuda)
    assert trace.launches("obs_gather") == before + 1
    cpu_obs, _ = env.reset(keys.cpu(), p, device="cpu")
    assert torch.equal(obs["image"].cpu(), cpu_obs["image"])


@pytest.mark.gpu
@pytest.mark.parametrize("env_id,overrides", [
    ("MiniGrid-DoorKey-8x8-v0", {}),
    ("MiniGrid-DoorKey-8x8-v0", {"max_steps": 12}),  # every lane regenerates
    ("MiniGrid-DoorKey-6x6-v0", {"agent_view_size": 5}),  # the generic-V kernel
    ("MiniGrid-Empty-5x5-v0", {"max_steps": 14}),
    ("MiniGrid-Empty-Random-6x6-v0", {"max_steps": 14}),
    ("MiniGrid-Empty-16x16-v0", {}),
    # a 40x40 tile takes 109 KB of dynamic shared memory
    ("MiniGrid-DoorKey-8x8-v0", {"size": 40, "max_steps": 30}),
])
def test_fused_kernel_matches_plain(cuda, env_id, overrides):
    args, spec = _fused_inputs(env_id, 512, "cpu", seed=len(env_id), **overrides)
    _assert_fused_kernel_is_plain(cuda, args, spec)


def _assert_fused_kernel_is_plain(cuda, args, spec):
    want = fused_step.fused_step_plain(*args, spec)
    before = trace.launches("fused_step")
    got = fused_step.fused_step(*(a.to(cuda) for a in args), spec)
    torch.cuda.synchronize()
    assert trace.launches("fused_step") == before + 1
    for name, g, w in zip(("grid", "agent", "image", "reward", "term", "trunc",
                           "key", "t"), got, want):
        g = g.cpu()
        if w.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), name


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, fused_step.TILE - 1, fused_step.TILE + 1, 4097])
def test_fused_kernel_ragged_batches(cuda, n):
    """The last tile holds fewer envs than a block owns; max_steps 12 sends
    most lanes to regeneration."""
    args, spec = _fused_inputs("MiniGrid-DoorKey-8x8-v0", n, "cpu", seed=n, max_steps=12)
    agent = args[1].clone()
    agent[:, fused_step.A_CNT] = torch.arange(n, dtype=torch.int32) % 14
    _assert_fused_kernel_is_plain(cuda, (args[0], agent, *args[2:]), spec)


@pytest.mark.gpu
@pytest.mark.parametrize("v", [3, 5, 9, 11])
def test_fused_kernel_view_sizes(cuda, v):
    """The generic-V instance, on an 8x8 grid and on Empty-5x5, where the
    view runs past the grid."""
    for env_id in ("MiniGrid-DoorKey-8x8-v0", "MiniGrid-Empty-5x5-v0"):
        args, spec = _fused_inputs(env_id, 77, "cpu", seed=v, agent_view_size=v,
                                   max_steps=14)
        _assert_fused_kernel_is_plain(cuda, args, spec)


@pytest.mark.gpu
def test_fused_kernel_takes_tensors_off_16_byte_alignment(cuda):
    """Contiguous inputs one word into their storage: the tile copies go
    word by word."""
    args, spec = _fused_inputs("MiniGrid-DoorKey-8x8-v0", 33, "cpu", max_steps=12)
    want = fused_step.fused_step_plain(*args, spec)

    def shifted(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        flat[1:] = x.reshape(-1).to(cuda)
        return flat[1:].view(x.shape)

    grid, agent, action = (shifted(a) for a in args[:3])
    assert grid.data_ptr() % 16 and agent.data_ptr() % 16
    got = fused_step.fused_step(grid, agent, action, *(a.to(cuda) for a in args[3:]), spec)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, obs_gather.TILE - 1, obs_gather.TILE + 1, 4097])
def test_gather_kernel_ragged_batches(cuda, n):
    r = np.random.default_rng(n)
    grid = torch.from_numpy(random_packed(r, (n, 5, 5)))  # 25 words a row
    pos = torch.from_numpy(r.integers(-1, 6, (n, 2)).astype(np.int32))
    dirs = torch.from_numpy(r.integers(0, 4, n).astype(np.int32))
    for v in (7, 3):
        want = obs_gather.gather_view_plain(grid, pos, dirs, v)
        got = obs_gather.gather_view(grid.to(cuda), pos.to(cuda), dirs.to(cuda), v)
        assert torch.equal(got.cpu(), want)
        # the same rows one word into their storage: copies go word by word
        flat = torch.empty(grid.numel() + 1, dtype=torch.int32, device=cuda)
        flat[1:] = grid.reshape(-1).to(cuda)
        got = obs_gather.gather_view(flat[1:].view(grid.shape), pos.to(cuda),
                                     dirs.to(cuda), v)
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_gather_kernel_refuses_a_tile_over_shared_memory(cuda):
    grid = torch.zeros((2, 61, 61), dtype=torch.int32, device=cuda)
    pos = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    dirs = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        obs_gather.gather_view(grid, pos, dirs, 7)
    big = torch.from_numpy(random_packed(np.random.default_rng(1), (20, 40, 40)))
    pos = torch.full((20, 2), 20, dtype=torch.int32)
    dirs = torch.arange(20, dtype=torch.int32) % 4
    got = obs_gather.gather_view(big.to(cuda), pos.to(cuda), dirs.to(cuda), 7)
    assert torch.equal(got.cpu(), obs_gather.gather_view_plain(big, pos, dirs, 7))


@pytest.mark.gpu
def test_fused_vector_env_on_the_card_is_one_launch_a_step(cuda):
    from minigrid_tpu_torch.ops.fused_step import FusedVectorEnv

    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0", max_steps=9)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        fv = FusedVectorEnv(env, 64, device=dev)
        _, fs = fv.reset(rng.PRNGKey(1, dev))
        before = trace.launches("fused_step")
        r = np.random.default_rng(0)
        images = []
        for _ in range(20):
            a = torch.from_numpy(r.integers(0, 8, 64).astype(np.int32))
            obs, fs, *_ = fv.step(fs, a)
            images.append(obs["image"].cpu())
        runs[dev.type] = (images, {k: v.cpu() for k, v in fs.items()},
                          trace.launches("fused_step") - before)
    assert runs["cuda"][2] == 20 and runs["cpu"][2] == 0
    for g, c in zip(runs["cuda"][0], runs["cpu"][0]):
        assert torch.equal(g, c)
    for k in runs["cpu"][1]:
        assert torch.equal(runs["cuda"][1][k], runs["cpu"][1][k]), k


# one id per family of the single-room zoo: grids from 5x5 to 25x25, square
# and not (DistShift 9x7, RedBlueDoors 16x8), see-through and not
ZOO_IDS = ["MiniGrid-LavaGapS7-v0", "MiniGrid-DistShift1-v0", "MiniGrid-FourRooms-v0",
           "MiniGrid-RedBlueDoors-8x8-v0", "MiniGrid-MemoryS17Random-v0",
           "MiniGrid-Fetch-8x8-N3-v0", "MiniGrid-GoToDoor-8x8-v0",
           "MiniGrid-GoToObject-8x8-N2-v0", "MiniGrid-PutNear-8x8-N3-v0",
           "MiniGrid-LavaCrossingS11N5-v0", "MiniGrid-Dynamic-Obstacles-16x16-v0",
           "MiniGrid-MultiRoom-N6-v0"]


def _walked_states(env_id: str, n: int, device, steps: int = 8, seed: int = 0):
    env = minigrid_tpu_torch.make(env_id)
    p = env.default_params
    k_gen, k_act = rng.split(rng.PRNGKey(seed, device)).unbind(0)
    st = env.generate(rng.split(k_gen, n), p, device)
    for k in rng.split(k_act, steps):
        st = env.step_state(st, rng.randint(k, (n,), 0, 8), p)[0]
    return env, p, st


@pytest.mark.gpu
@pytest.mark.parametrize("env_id", ZOO_IDS)
def test_gather_kernel_on_zoo_states(cuda, env_id):
    """The kernel against its plain version at each family's (W, H), and
    the whole observation (see-through families included) card == CPU."""
    from minigrid_tpu_torch.core.obs import gen_obs_batch
    from minigrid_tpu_torch.core.state import map_fields

    env, p, st = _walked_states(env_id, 300, cuda)
    args = (st.grid, st.agent_pos, st.agent_dir, p.agent_view_size)
    before = trace.launches("obs_gather")
    got = obs_gather.gather_view(*args)
    assert trace.launches("obs_gather") == before + 1
    cpu = map_fields(lambda x: x.cpu(), st)
    want = obs_gather.gather_view_plain(cpu.grid, cpu.agent_pos, cpu.agent_dir,
                                        p.agent_view_size)
    assert torch.equal(got.cpu(), want)
    obs_gpu, obs_cpu = gen_obs_batch(st, p), gen_obs_batch(cpu, p)
    for k in obs_cpu:
        assert torch.equal(obs_gpu[k].cpu(), obs_cpu[k]), k


@pytest.mark.gpu
def test_gather_kernel_on_a_ragged_25x25_batch(cuda):
    """MultiRoom's 25x25 grid: the tile (80,384 bytes) needs dynamic shared
    memory; B=4097 leaves one env in the last tile."""
    _, p, st = _walked_states("MiniGrid-MultiRoom-N6-v0", 4097, cuda, steps=4)
    assert obs_gather.gather_tile_bytes(25, 25) > 48 * 1024
    got = obs_gather.gather_view(st.grid, st.agent_pos, st.agent_dir, 7)
    want = obs_gather.gather_view_plain(st.grid.cpu(), st.agent_pos.cpu(),
                                        st.agent_dir.cpu(), 7)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("see_through", [False, True])
@pytest.mark.parametrize("v", [3, 5, 7, 11])
@pytest.mark.parametrize("w,h", [(8, 8), (16, 16), (22, 22), (25, 25)])
def test_observe_kernel_matches_the_plain_path(cuda, w, h, v, see_through):
    """The image and the window with its mask, in one launch each, bitwise
    core/obs.py's plain path (gen_obs_batch's and gen_obs_grid_batch's on CPU
    tensors): every pose and direction, then B=1 and a ragged batch; the
    occlusion counter counts each launch that occluded."""
    from minigrid_tpu_torch.core import obs

    r = np.random.default_rng(w * 100 + v)
    for n, all_poses in ((None, True), (1, False), (obs_gather.TILE * 3 + 5, False)):
        cpu = _observe_inputs(r, n, w, h, all_poses)
        args = (*(t.to(cuda) for t in cpu), v, see_through)
        want_cells, want_vis = obs.observe_grid_plain(*cpu, v, see_through)
        before = trace.launches("obs_gather")
        trace.reset()
        trace.enable()
        try:
            image = obs_gather.observe_image(*args)
            assert trace.launches("obs_gather") == before + 1
            cells, vis = obs_gather.observe_grid(*args)
            assert trace.launches("obs_gather") == before + 2
            counters = trace.report()["counters"]
        finally:
            trace.disable()
            trace.reset()
        torch.cuda.synchronize()
        assert counters.get(obs_gather.OCCLUSION_COUNTER, 0) == (0 if see_through else 2)
        assert torch.equal(cells.cpu(), want_cells) and torch.equal(vis.cpu(), want_vis)
        assert torch.equal(image.cpu(), obs.encode_view(want_cells, want_vis))


@pytest.mark.gpu
def test_observe_kernel_takes_tensors_off_16_byte_alignment(cuda):
    """Every input one element into its storage: the tile's copies go word
    by word and byte by byte."""
    from minigrid_tpu_torch.core import obs

    cpu = _observe_inputs(np.random.default_rng(5), 4097, 8, 8)

    def shifted(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        flat[1:] = x.reshape(-1).to(cuda)
        return flat[1:].view(x.shape)

    want_cells, want_vis = obs.observe_grid_plain(*cpu, 7, False)
    image = obs_gather.observe_image(*(shifted(t) for t in cpu), 7, False)
    cells, vis = obs_gather.observe_grid(*(shifted(t) for t in cpu), 7, False)
    assert torch.equal(cells.cpu(), want_cells) and torch.equal(vis.cpu(), want_vis)
    assert torch.equal(image.cpu(), obs.encode_view(want_cells, want_vis))


@pytest.mark.gpu
@pytest.mark.parametrize("env_id", ["MiniGrid-Dynamic-Obstacles-8x8-v0",
                                    "MiniGrid-MultiRoom-N2-S4-v0"])
def test_zoo_vector_env_on_the_card_gathers_every_step(cuda, env_id):
    """The batch engine at its default strategy on the card: one gather
    launch per observation, and the same run as on the CPU."""
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    runs = {}
    for dev in (cuda, torch.device("cpu")):
        venv = minigrid_tpu_torch.make_vec(env_id, 64, device=dev, max_steps=7)
        before = trace.launches("obs_gather")
        obs, st = venv.reset(rng.PRNGKey(3, dev))
        r = np.random.default_rng(0)
        images = []
        for _ in range(16):
            a = torch.from_numpy(r.integers(0, 8, 64).astype(np.int32))
            obs, st, reward, *_ = venv.step(st, a)
            images.append((obs["image"].cpu(), reward.cpu().view(torch.int32)))
        runs[dev.type] = (images, state_to_numpy(st), trace.launches("obs_gather") - before)
    assert runs["cuda"][2] == 17 and runs["cpu"][2] == 0
    for (gi, gr), (ci, cr) in zip(runs["cuda"][0], runs["cpu"][0]):
        assert torch.equal(gi, ci) and torch.equal(gr, cr)
    _assert_same_fields(runs["cuda"][1], runs["cpu"][1])


@pytest.mark.gpu
@pytest.mark.parametrize("env_id", ["BabyAI-GoToObjS4-v0", "BabyAI-OpenRedDoor-v0",
                                    "BabyAI-GoTo-v0"])
def test_babyai_on_the_card_gathers_every_step(cuda, env_id):
    """BabyAI at 4x4, 9x5 and 22x22, pooled with the best-effort refill at
    B=64: one gather launch per observation, and the run of the CPU, the
    verifier state included."""
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    runs = {}
    for dev in (cuda, torch.device("cpu")):
        venv = minigrid_tpu_torch.make_vec(env_id, 64, device=dev, max_steps=7)
        assert venv.reset_strategy == "pooled" and venv.best_effort_refill
        before = trace.launches("obs_gather")
        obs, st = venv.reset(rng.PRNGKey(5, dev))
        r = np.random.default_rng(1)
        steps = []
        for _ in range(16):
            a = torch.from_numpy(r.integers(0, 8, 64).astype(np.int32))
            obs, st, reward, *_ = venv.step(st, a)
            steps.append((obs["image"].cpu(), obs["mission"].cpu(),
                          reward.cpu().view(torch.int32)))
        runs[dev.type] = (steps, state_to_numpy(st), trace.launches("obs_gather") - before)
    assert runs["cuda"][2] == 17 and runs["cpu"][2] == 0
    for g, c in zip(runs["cuda"][0], runs["cpu"][0]):
        assert all(torch.equal(x, y) for x, y in zip(g, c))
    _assert_same_fields(runs["cuda"][1], runs["cpu"][1])


@pytest.mark.gpu
@pytest.mark.parametrize("env_id", ["BabyAI-BossLevel-v0", "BabyAI-KeyInBox-v0",
                                    "BabyAI-PutNextS5N2Carrying-v0",
                                    "BabyAI-MoveTwoAcrossS8N9-v0", "DirectionsDataset-v0",
                                    "BlocksDataset-v0", "MiniGrid-Negated-Simple-v0"])
def test_later_slice_ids_on_the_card_match_the_cpu(cuda, env_id):
    """The level generator's, PutNext's, Unlock's and the dataset envs' ids
    at B=64 at their default strategy (BabyAI pooled with the best-effort
    refill, the dataset envs fused): ``generate`` and 8 steps of the env's
    own actions on the card, one gather launch per observation (Directions'
    3x3 grid at V=3 included), and the CPU's run, the verifier state and
    box planes included."""
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    runs = {}
    for dev in (cuda, torch.device("cpu")):
        venv = minigrid_tpu_torch.make_vec(env_id, 64, device=dev)
        before = trace.launches("obs_gather")
        obs, st = venv.reset(rng.PRNGKey(6, dev))
        steps = [(obs["image"].cpu(), obs["mission"].cpu())]
        for t in range(8):
            a = rng.randint(rng.PRNGKey(300 + t, dev), (64,), 0, venv.env.num_actions)
            obs, st, reward, term, trunc, _ = venv.step(st, a)
            steps.append((obs["image"].cpu(), obs["mission"].cpu(),
                          reward.cpu().view(torch.int32), term.cpu(), trunc.cpu()))
        runs[dev.type] = (steps, state_to_numpy(st), trace.launches("obs_gather") - before)
    assert runs["cuda"][2] == 9 and runs["cpu"][2] == 0
    for g, c in zip(runs["cuda"][0], runs["cpu"][0]):
        assert all(torch.equal(x, y) for x, y in zip(g, c))
    _assert_same_fields(runs["cuda"][1], runs["cpu"][1])


def _assert_same_fields(a: dict, b: dict, where: str = "") -> None:
    assert set(a) == set(b), where
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_fields(a[k], b[k], f"{where}{k}.")
        elif a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, where + k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=where + k)


# -- wrappers and rendering on the card --------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("wrapper,kwargs,gathers", [
    ("RGBImgPartialObsWrapper", {"channels_first": True}, 2),
    ("RGBImgObsWrapper", {}, 2),
    ("ViewSizeWrapper", {"agent_view_size": 11}, 2),
    ("ActionBonus", {}, 1),
    ("OneHotPartialObsWrapper", {}, 1),
])
def test_wrapped_walk_on_the_card_matches_the_cpu(cuda, wrapper, kwargs, gathers):
    """A wrapped DoorKey-8x8 at B=64 through 12 steps of 4-step episodes:
    ``gathers`` launches an observation on the card, none on the CPU, and the
    same observations, rewards (as float32 bits), flags and final state
    (a bonus wrapper's counts included)."""
    from minigrid_tpu_torch import wrappers
    from minigrid_tpu_torch.parallel.vector import VectorEnv
    from minigrid_tpu_torch.utils.convert import state_to_numpy

    runs = {}
    for dev in (cuda, torch.device("cpu")):
        env = getattr(wrappers, wrapper)(
            minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0", max_steps=4), **kwargs)
        venv = VectorEnv(env, 64, device=dev)
        before = trace.launches("obs_gather")
        obs, st = venv.reset(rng.PRNGKey(8, dev))
        steps = []
        for t in range(12):
            a = rng.randint(rng.PRNGKey(400 + t, dev), (64,), 0, 7)
            obs, st, reward, term, trunc, _ = venv.step(st, a)
            steps.append([obs[k].cpu() for k in sorted(obs)]
                         + [reward.cpu().view(torch.int32), term.cpu(), trunc.cpu()])
        runs[dev.type] = (steps, state_to_numpy(st), trace.launches("obs_gather") - before)
    assert runs["cuda"][2] == 13 * gathers and runs["cpu"][2] == 0
    for g, c in zip(runs["cuda"][0], runs["cpu"][0]):
        assert all(torch.equal(x, y) for x, y in zip(g, c))
    _assert_same_fields(runs["cuda"][1], runs["cpu"][1])


@pytest.mark.gpu
@pytest.mark.parametrize("channels_first", [False, True])
def test_pov_render_batch_on_the_card_matches_the_cpu(cuda, channels_first):
    """The atlas gather on a ragged B=4097 of walked DoorKey-8x8 states:
    bitwise the CPU's frames, contiguous, the atlas moved once."""
    from minigrid_tpu_torch.core.state import map_fields
    from minigrid_tpu_torch.ops import render

    _, p, st = _walked_states("MiniGrid-DoorKey-8x8-v0", 4097, cuda, steps=12)
    atlas = render.get_atlas(8, cuda)
    assert render.get_atlas(8, "cuda") is atlas
    got = render.pov_render_batch(st, p, atlas, channels_first)
    cpu = map_fields(lambda x: x.cpu(), st)
    want = render.pov_render_batch(cpu, p, render.get_atlas(8, "cpu"), channels_first)
    assert got.is_contiguous() and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


# -- the threefry kernel on the card --------------------------------------------------

@pytest.mark.gpu
def test_threefry_kernel_matches_plain(cuda):
    """``chip_smoke.py`` phase 3's threefry cases: split, bits and fold_in on
    the card bitwise the plain formula on the CPU, each with the launches it
    must make, and the flipped-bit self-check."""
    assert chip_smoke.check_threefry_kernel(cuda) == 0


@pytest.mark.gpu
def test_draws_on_the_card_never_take_the_eager_hash(cuda, monkeypatch):
    """Every draw of a CUDA tensor hashes in the kernel: the plain formula
    is never called, and each call launches."""
    def refuse(*args):
        raise AssertionError("a CUDA draw took the eager hash")

    monkeypatch.setattr(rng, "threefry2x32", refuse)
    keys = rng.split(rng.PRNGKey(3, cuda), 6)
    before = trace.launches("threefry")
    draws = [rng.bits(keys, (5,)), rng.fold_in(keys, 9),
             rng.fold_in(keys[:, None], torch.arange(4, device=cuda)),
             rng.randint(keys, (3,), 0, 7), rng.uniform(keys, (3,)),
             rng.permutation(keys, 8), rng.categorical(keys, torch.zeros(6, 5, device=cuda)),
             rng.categorical_one_key(keys[0], torch.zeros(6, 5, device=cuda))]
    torch.cuda.synchronize()
    assert all(d.device.type == "cuda" for d in draws)
    assert trace.launches("threefry") - before == 1 + 1 + 1 + 2 + 1 + 2 + 1 + 1


@pytest.mark.gpu
def test_threefry_wrapper_refuses_data_on_another_device(cuda):
    keys = rng.split(rng.PRNGKey(0, cuda), 4)
    with pytest.raises(ValueError, match="fold_in data"):
        threefry.launch(threefry.fold_layout(keys, torch.arange(4)))


# -- the distractors kernel ----------------------------------------------------------

def _distractor_args(n: int = 6, **overrides) -> dict:
    """A GoTo builder after its doors, on the CPU, and the keys and
    arguments of GoTo's sequential call."""
    env = minigrid_tpu_torch.make("BabyAI-GoTo-v0")
    p = env.default_params
    k = rng.split(rng.split(rng.PRNGKey(7, "cpu"), n), 4).unbind(1)
    b = env.connect_all(env.place_agent_any(env.init_rooms(k[0], p), k[1], p), k[2])
    args = dict(b=b, keys=k[3], lattice=(env.num_rows, env.num_cols, env.room_size), i=None,
                j=None, num=18, all_unique=False, enabled=True, color_override=None)
    return {**args, **overrides}


def _with(b: dict, **fields) -> dict:
    return {**b, **fields}


@pytest.mark.parametrize("what,overrides,error", [
    ("keys int32", lambda a: dict(keys=a["keys"].int()), TypeError),
    ("keys [B]", lambda a: dict(keys=a["keys"][:, 0]), TypeError),
    ("grid int64", lambda a: dict(b=_with(a["b"], grid=a["b"]["grid"].long())), TypeError),
    ("obj_mask int32", lambda a: dict(b=_with(a["b"], obj_mask=a["b"]["obj_mask"].int())),
     TypeError),
    ("agent_pos int64", lambda a: dict(b=_with(a["b"], agent_pos=a["b"]["agent_pos"].long())),
     TypeError),
    ("enabled int", lambda a: dict(enabled=torch.ones(6, dtype=torch.int32)), TypeError),
    ("enabled a float", lambda a: dict(enabled=0.5), TypeError),
    ("color_override float", lambda a: dict(color_override=torch.ones(6)), TypeError),
    ("color_override past int32", lambda a: dict(color_override=2**31), ValueError),
    ("i a bool tensor", lambda a: dict(i=torch.ones(6, dtype=torch.bool)), TypeError),
    ("j for 5 of 6 envs", lambda a: dict(j=torch.zeros(5, dtype=torch.int32)), ValueError),
    ("both rooms fixed", lambda a: dict(i=1, j=2), ValueError),
    ("no object", lambda a: dict(num=0), ValueError),
    ("one room", lambda a: dict(lattice=(1, 1, 8)), ValueError),
    ("all_unique an int", lambda a: dict(all_unique=1), TypeError),
])
def test_distractors_wrapper_rejects_what_it_does_not_take(what, overrides, error):
    """Forms and dtypes the kernel does not take are refused before the
    device is looked at, so on the CPU too; what it takes reaches the
    device check, which refuses the CPU."""
    args = _distractor_args()
    with pytest.raises(error):
        distractors.place(**{**args, **overrides(args)})
    with pytest.raises(ValueError, match="no distractors kernel for device cpu"):
        distractors.place(**args)


def test_distractors_cpu_tensors_take_the_plain_loop_and_do_not_count(monkeypatch):
    """On the CPU ``add_distractors``' sequential path is the plain loop:
    the wrapper is never called and nothing counts a launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the distractors kernel")

    monkeypatch.setattr(distractors, "place", refuse)
    args = _distractor_args(enabled=torch.tensor([True, False] * 3), color_override=4)
    env = minigrid_tpu_torch.make("BabyAI-GoTo-v0")
    before = trace.launches("distractors")
    got = env.add_distractors(args["b"], args["keys"], env.default_params, num_distractors=18,
                              all_unique=False, enabled=args["enabled"], color_override=4)
    want = env._add_distractors_plain(args["b"], args["keys"], env.default_params, None, None,
                                      18, False, args["enabled"], 4)
    assert trace.launches("distractors") == before
    for g, w in zip((got[0]["grid"], got[0]["obj_mask"], got[1], got[2]),
                    (want[0]["grid"], want[0]["obj_mask"], want[1], want[2])):
        assert torch.equal(g, w)


def test_distractors_args_are_the_kernels_struct():
    """``ops/distractors.py::Args`` lists csrc/distractors.cu's ``Args``
    fields in order, pointers as pointers and ints as int32, and the
    kernel's tables are the port's (the library holds the size too)."""
    from minigrid_tpu_torch.core.roomgrid import _KIND_IDS

    src = (_build.CSRC / "distractors.cu").read_text()
    body = re.search(r"struct Args \{(.*?)\n\};", src, re.S)[1]
    fields = []
    for decl in re.findall(r"^\s*([^/\n][^;]*);", body, re.M):
        kind = "ptr" if "*" in decl else "int"
        names = decl.split("*")[-1] if kind == "ptr" else decl.split(None, 1)[1]
        fields += [(re.sub(r"\[.*", "", name).strip(), kind) for name in names.split(",")]
    want = [(name, "ptr" if ctype is ctypes.c_void_p else "int")
            for name, ctype in distractors.Args._fields_]
    assert fields == want
    assert list(distractors.KIND_IDS) == list(_KIND_IDS)


@pytest.mark.gpu
def test_distractors_kernel_matches_plain(cuda):
    """``chip_smoke.py`` phase 3's distractors cases: every argument form of
    the sequential path on the card bitwise the plain loop on the CPU, one
    launch each, and the flipped-bit self-check."""
    assert chip_smoke.check_distractors_kernel(cuda) == 0


@pytest.mark.gpu
def test_goto_step_is_one_distractors_launch(cuda):
    """A GoTo ``VectorEnv.step`` at B=4096: one distractors launch and the
    20 threefry launches of the refill's other draws."""
    out = chip_smoke.check_goto_hashes(cuda)
    assert out["distractors_per_step"] == [1, 1, 1] and out["per_step"] == [20, 20, 20]


@pytest.mark.gpu
def test_distractors_kernel_on_goto_and_boss_levels(cuda):
    """Every distractors launch of a B=4096 GoTo and BossLevel reset and
    their 16-level refills, bitwise the plain loop on the CPU."""
    held = chip_smoke.check_distractor_levels(cuda)
    assert 16 in held["BabyAI-GoTo-v0"] and 16 in held["BabyAI-BossLevel-v0"]


# -- the descriptor kernel -----------------------------------------------------------

def _descs_inputs(env_id: str, n: int, seed: int) -> tuple:
    """(env, ``gen_level``'s arguments to ``_rand_objs``) for ``n`` levels
    of ``env_id`` on the CPU."""
    env = minigrid_tpu_torch.make(env_id)
    return env, chip_smoke.descs_inputs(env, rng.split(rng.PRNGKey(seed, "cpu"), n))


def _descs_args(n: int = 6, **overrides) -> dict:
    """BossLevel's arguments to ``descs.draw`` for ``n`` levels, on the CPU."""
    env, (k1, k2, b, _, rect, locked, kinds) = _descs_inputs("BabyAI-BossLevel-v0", n, 3)
    args = dict(key_d1=k1, key_d2=k2, b=b, kinds=kinds, locked_rect=rect, has_locked=locked,
                room_size=env.room_size, locations=True, implicit_unlock=True)
    return {**args, **overrides}


@pytest.mark.parametrize("what,overrides,error", [
    ("key_d1 int32", lambda a: dict(key_d1=a["key_d1"].int()), TypeError),
    ("key_d2 [B]", lambda a: dict(key_d2=a["key_d2"][:, 0]), TypeError),
    ("key_d2 of 5 levels", lambda a: dict(key_d2=a["key_d2"][:5]), TypeError),
    ("keys a list", lambda a: dict(key_d1=a["key_d1"].tolist()), TypeError),
    ("grid int64", lambda a: dict(b=_with(a["b"], grid=a["b"]["grid"].long())), TypeError),
    ("grid [B, W]", lambda a: dict(b=_with(a["b"], grid=a["b"]["grid"][:, 0])), TypeError),
    ("agent_pos int64", lambda a: dict(b=_with(a["b"], agent_pos=a["b"]["agent_pos"].long())),
     TypeError),
    ("agent_dir [B, 1]", lambda a: dict(b=_with(a["b"], agent_dir=a["b"]["agent_dir"][:, None])),
     TypeError),
    ("kinds int64", lambda a: dict(kinds=a["kinds"].long()), TypeError),
    ("kinds of 3 clauses", lambda a: dict(kinds=a["kinds"][:, :3]), TypeError),
    ("locked_rect int32", lambda a: dict(locked_rect=a["locked_rect"].int()), TypeError),
    ("locked_rect of another grid", lambda a: dict(locked_rect=a["locked_rect"][:, 1:]),
     TypeError),
    ("has_locked int32", lambda a: dict(has_locked=a["has_locked"].int()), TypeError),
    ("room_size 1", lambda a: dict(room_size=1), ValueError),
    ("room_size a bool", lambda a: dict(room_size=True), ValueError),
    ("room_size a tensor", lambda a: dict(room_size=torch.tensor(8)), ValueError),
    ("locations an int", lambda a: dict(locations=1), TypeError),
    ("implicit_unlock None", lambda a: dict(implicit_unlock=None), TypeError),
])
def test_descs_wrapper_rejects_what_it_does_not_take(what, overrides, error):
    """Forms and dtypes the kernel does not take are refused before the
    device is looked at, so on the CPU too; what it takes reaches the
    device check, which refuses the CPU."""
    args = _descs_args()
    with pytest.raises(error):
        descs.draw(**{**args, **overrides(args)})
    with pytest.raises(ValueError, match="no descs kernel for device cpu"):
        descs.draw(**args)


def test_descs_wrapper_refuses_a_grid_over_shared_memory():
    """A grid of more cells than a block's shared memory holds is refused
    before the device is looked at."""
    args = _descs_args(2)
    assert descs.tile_bytes(240, 250) > _build.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        descs.draw(**{**args, "b": _with(args["b"], grid=torch.zeros((2, 240, 250),
                                                                     dtype=torch.int32)),
                      "locked_rect": torch.zeros((2, 240, 250), dtype=torch.bool)})


@pytest.mark.parametrize("env_id", ["BabyAI-BossLevel-v0", "BabyAI-SynthS5R2-v0"])
def test_descs_cpu_tensors_take_the_plain_loop_and_do_not_count(env_id, monkeypatch):
    """On the CPU ``_rand_objs`` is the plain loop: the wrapper is never
    called and nothing counts a launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the descs kernel")

    monkeypatch.setattr(descs, "draw", refuse)
    env, inputs = _descs_inputs(env_id, 8, 5)
    before = trace.launches("descs")
    got = env._rand_objs(*inputs)
    want = env._rand_objs_plain(*inputs)
    assert trace.launches("descs") == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("env_id", chip_smoke.LEVELGEN_IDS)
def test_desc_counters_are_the_redraws_max_and_sum(env_id):
    """On the plain loop, over three seeds: the host counters
    ``levelgen.desc_passes`` and ``levelgen.desc_redraws`` are 1 + the most
    redraws of any lane and their sum, the identity the kernel path counts
    by (``levelgen.count_desc_draws``, which reads the same from the
    redraws, and records nothing while tracing is off)."""
    from minigrid_tpu_torch.babyai.levelgen import count_desc_draws

    trace.reset()
    try:
        for seed in range(3):
            env, inputs = _descs_inputs(env_id, 16, 40 + seed)
            trace.enable()
            _, _, redraws = env._rand_objs(*inputs)
            counters = trace.report()["counters"]
            trace.reset()
            assert counters["levelgen.desc_passes"] == 1 + int(redraws.max())
            assert counters.get("levelgen.desc_redraws", 0) == int(redraws.sum())
            count_desc_draws(redraws)
            got = trace.report()["counters"]
            assert {k: got.get(k, 0) for k in counters} == {k: counters.get(k, 0) for k in got}
            trace.reset()
            trace.disable()
            count_desc_draws(redraws)
            assert "levelgen.desc_passes" not in trace.report()["counters"]
    finally:
        trace.disable()
        trace.reset()


def test_descs_kernel_constants_are_the_port_tables():
    """csrc/descs.cu keeps its own copy of the fuel, the clause kinds, the
    flags and the color and type tables; they must be the port's."""
    from minigrid_tpu_torch.babyai import levelgen
    from minigrid_tpu_torch.babyai import verifier as V
    from minigrid_tpu_torch.core.sampling import SORTED_COLOR_IDS

    consts = _constants("descs")
    want = {"kLanes": descs.LANES, "kClauses": descs.CLAUSES, "kFuel": levelgen.DESC_FUEL,
            "kGoTo": V.K_GOTO, "kOpen": V.K_OPEN, "kPutNext": V.K_PUTNEXT,
            "kLocations": descs.LOCATIONS, "kImplicitUnlock": descs.IMPLICIT_UNLOCK}
    assert {k: consts.get(k) for k in want} == want
    src = (_build.CSRC / "descs.cu").read_text()
    tables = {m[0]: [int(v) for v in m[1].split(",")]
              for m in re.findall(r"__constant__ int (k\w+)\[\d+\] = \{([^}]*)\};", src)}
    assert tables == {"kSortedColors": SORTED_COLOR_IDS.tolist(),
                      "kDescTypes": V.DESC_TYPE_IDS.tolist()}


@pytest.mark.gpu
def test_descs_kernel_matches_plain(cuda):
    """``chip_smoke.py`` phase 3's descriptor cases: every LevelGen preset
    at 16 levels on two seeds and at 4,097, BossLevel at 1 level, without
    objects (every lane spends its fuel) and with a column-major grid, on
    the card bitwise the plain loop on the CPU, one launch each, and the
    flipped-bit self-check."""
    assert chip_smoke.check_descs_kernel(cuda) == 0


@pytest.mark.gpu
def test_boss_step_is_one_descs_launch(cuda):
    """A BossLevel ``VectorEnv.step`` at B=4096: one descriptor launch and
    39 threefry launches, and every descriptor call of its reset and three
    refills bitwise the plain loop on the CPU."""
    out = chip_smoke.check_boss_descs(cuda)
    assert out["per_step"] == [(39, 1)] * 3 and 16 in out["levels"]


# -- the learner on the card ----------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ppo", "rnn", "bc"])
def test_learner_on_the_card_matches_the_cpu(cuda, kind):
    """``chip_smoke.py`` phase 4g (a): one small PPO update (DoorKey-8x8),
    RecurrentPPO update (MemoryS7) or ``bc_train`` run on the card and on the
    CPU from one key, float32 networks, TF32 off: the rollouts equal, values,
    metrics and parameters within the CPU tests' tolerances."""
    errs = chip_smoke.learner_card_matches_cpu(cuda, (kind,))[kind]
    assert errs["param"] < 0.1 * 1e-3
