"""Fast correctness smoke gate, run before any benchmark is recorded.

Counterpart of ``minigrid_tpu/tools/smoke.py``.  Benchmarks are only
meaningful for a correct program, so this gate refuses (raises) on any
disagreement.  Checks:

1. The window gather: the plain version (``ops/obs_gather.py``) over every
   agent pose of a random 9x6 grid, edges and out-of-bounds windows
   included, in all 4 directions, against a host reference written
   independently of it (the reference's slice-and-rotate,
   minigrid_env.py:get_view_exts and Grid.slice/rotate_left, in numpy); on
   a CUDA device the ``obs_gather`` kernel too, its launch asserted.
2. Reference lockstep for Empty-5x5 and DoorKey-8x8 (one seed each, 150
   random actions): bitwise obs/reward/terminated/truncated parity with
   the reference object engine (minigrid_env.py:524-651), through
   :func:`minigrid_tpu_torch.utils.convert.from_reference`; skipped with a
   notice when the reference (the ``minigrid`` package) does not import.
3. :func:`device_kernel_gate` (one definition, in ``tools/battery.py``): a
   batch of walked DoorKey states through the kernel and its plain version
   on the card; skipped with a notice off the card.

Run: ``python -m minigrid_tpu_torch.tools.smoke [--device cpu]`` (exit 0 =
pass).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.tools.battery import device_kernel_gate

__all__ = ["device_kernel_gate", "run_smoke"]

GRID_W, GRID_H, VIEW = 9, 6, 7


def _reference_view(grid: np.ndarray, x: int, y: int, d: int, v: int,
                    wall: int) -> np.ndarray:
    """The reference's egocentric window of packed ``grid`` [W, H]: the
    V x V slice at the view's top-left corner (out-of-bounds cells a wall),
    rotated left ``d + 1`` times, indexed [x, y] with the agent at
    (V // 2, V - 1)."""
    w, h = grid.shape
    top_x, top_y = {0: (x, y - v // 2), 1: (x - v // 2, y),
                    2: (x - v + 1, y - v // 2), 3: (x - v // 2, y - v + 1)}[d]
    view = np.full((v, v), wall, dtype=grid.dtype)
    for i in range(v):
        for j in range(v):
            gx, gy = top_x + i, top_y + j
            if 0 <= gx < w and 0 <= gy < h:
                view[i, j] = grid[gx, gy]
    for _ in range(d + 1):
        rotated = np.empty_like(view)
        for i in range(v):
            for j in range(v):
                rotated[j, v - 1 - i] = view[i, j]
        view = rotated
    return view


def _check_gather_impls(device=None) -> None:
    """Every pose x direction of a random 9x6 grid at V=7 through the plain
    gather (and on a CUDA device the kernel) against
    :func:`_reference_view`; raises on any mismatch."""
    from minigrid_tpu_torch.core.grid_ops import pack_np
    from minigrid_tpu_torch.ops import obs_gather

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    w, h, v = GRID_W, GRID_H, VIEW
    grid = pack_np(
        np.stack(
            [
                rng.integers(0, 34, (w, h)),
                rng.integers(0, 10, (w, h)),
                rng.integers(0, 3, (w, h)),
            ],
            axis=-1,
        ).astype(np.uint8)
    )
    combos = [(x, y, d) for d in range(4) for x in range(w) for y in range(h)]
    want = np.stack([_reference_view(grid, x, y, d, v, obs_gather.WALL_PACKED)
                     for x, y, d in combos])
    grids = torch.from_numpy(np.broadcast_to(grid, (len(combos), w, h)).copy()).to(dev)
    pos = torch.tensor([(x, y) for x, y, _ in combos], dtype=torch.int32, device=dev)
    dirs = torch.tensor([d for _, _, d in combos], dtype=torch.int32, device=dev)

    impls = [("gather_view_plain", obs_gather.gather_view_plain)]
    if dev.type == "cuda":
        impls.append(("the obs_gather kernel", obs_gather.gather_view))
    for name, fn in impls:
        before = obs_gather.LAUNCHES
        got = fn(grids, pos, dirs, v).cpu().numpy()
        if fn is obs_gather.gather_view and obs_gather.LAUNCHES != before + 1:
            raise AssertionError("the obs_gather kernel did not launch — refusing to bench")
        for d in range(4):
            rows = [i for i, c in enumerate(combos) if c[2] == d]
            if not np.array_equal(got[rows], want[rows]):
                raise AssertionError(
                    f"{name} disagrees with the reference's slice-and-rotate "
                    f"at agent_dir={d} — obs kernel is WRONG, refusing to bench"
                )


def _lockstep_vs_reference(device=None) -> bool:
    """Returns True if the lockstep ran (reference importable), else False."""
    try:
        from minigrid.envs.doorkey import DoorKeyEnv as RefDoorKey
        from minigrid.envs.empty import EmptyEnv as RefEmpty
    except Exception:
        return False

    from minigrid_tpu_torch.envs.doorkey import DoorKeyEnv
    from minigrid_tpu_torch.envs.empty import EmptyEnv
    from minigrid_tpu_torch.utils.convert import from_reference, to_host

    dev = resolve_device(device)
    for ref_env, env in [
        (RefEmpty(size=5), EmptyEnv(size=5)),
        (RefDoorKey(size=8), DoorKeyEnv(size=8)),
    ]:
        params = env.default_params
        obs_ref, _ = ref_env.reset(seed=0)
        state = from_reference(ref_env, device=dev)
        obs = env.observation(state, params)
        assert np.array_equal(obs_ref["image"], obs["image"][0].cpu().numpy())
        rng = np.random.default_rng(0)
        for t in range(150):
            a = int(rng.integers(0, 8))
            o_r, r_r, term_r, trunc_r, _ = ref_env.step(a)
            action = torch.full((1,), a, dtype=torch.int32, device=dev)
            o, state, r, term, trunc, _ = env.step(state, action, params)
            image, d, r, term, trunc = to_host(
                [o["image"][0], o["direction"][0], r[0], term[0], trunc[0]])
            ok = (
                np.array_equal(o_r["image"], image)
                and o_r["direction"] == int(d)
                and abs(r_r - float(r)) < 1e-6
                and term_r == bool(term)
                and trunc_r == bool(trunc)
            )
            if not ok:
                raise AssertionError(
                    f"lockstep parity broken: {type(env).__name__} t={t} "
                    f"action={a} — refusing to bench a wrong program"
                )
            if term_r or trunc_r:
                break
    return True


def run_smoke(device=None) -> None:
    """All three checks on ``device`` (CUDA unless named); prints SMOKE OK
    when every check that could run agreed, and raises otherwise."""
    dev = resolve_device(device)
    _check_gather_impls(dev)
    if not _lockstep_vs_reference(dev):
        print("smoke: reference not importable — lockstep skipped", file=sys.stderr)
    if device_kernel_gate(device=dev):
        print("smoke: device kernel gate ok", file=sys.stderr)
    else:
        print(f"smoke: no kernel to gate on {dev} — device gate skipped",
              file=sys.stderr)
    print("SMOKE OK")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="the port's correctness smoke gate")
    p.add_argument("--device", default=None, help="'cpu' to run on the CPU")
    run_smoke(p.parse_args(argv).device)


if __name__ == "__main__":
    main()
