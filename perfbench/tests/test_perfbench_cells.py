"""CPU tests of the benchmark: every cell's files, each driver against the
reference at a tiny batch, the faults and the control that must make
``correct`` false, and the contract's names and imports.

    python -m pytest perfbench/tests -q

The test marked ``gpu`` runs a cell on the card; it skips without one.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
sys.path.insert(0, str(ROOT))

from perfbench import run as R  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2**31 + 12345

# per cell: a batch the CPU runs in seconds, and the env's episode limit cut
# so that auto-resets happen inside a short run
TINY = {
    "doorkey-8x8.pooled-random": ({"num_envs": 64, "pool_refill": 8, "warmup_blocks": 1},
                                  {"max_steps": 12}),
    "babyai-goto.pooled-random": ({"num_envs": 64, "warmup_blocks": 1}, {"max_steps": 6}),
    "doorkey-8x8.fused-random": ({"num_envs": 64, "chunk_steps": 16, "warmup_blocks": 4},
                                 {"max_steps": 12}),
}


def tiny_run(cell: str, seconds: float = 0.0, **sample) -> dict:
    wl, env = TINY[cell]
    return R.run(cell, SEED, seconds, False, device="cpu",
                 overrides={**wl, "sample_every": 1, "sample_cap": 8, **sample},
                 env_overrides=env)


# -- the cells' files -------------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    bench, entry, cfg, wl = R.load_cell(cell)
    assert (BENCH / "drivers" / f"{wl['driver']}.py").is_file()
    assert (BENCH / "reference" / "tasks" / f"{cfg['task']}.py").is_file()
    for m in bench["per_layer"]:
        if cell in m["workloads"]:
            assert callable(R.reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_driver_runs_and_agrees_with_reference(cell):
    res = tiny_run(cell, seconds=0.5)
    assert res["correct"], res["checks"]
    assert res["checks"]["compared"]["value"] >= 2 * TINY[cell][0]["num_envs"]
    assert res["failed"] == 0
    assert list(res)[-1] == "checks"


def test_episodes_end_inside_the_compared_steps():
    """The tiny runs compare auto-resets: their episode limit is cut."""
    from perfbench.drivers import vector_random as VR

    ends = []
    orig = VR.Driver._check_block

    def spy(self, c, blk, control):
        ends.extend(int((s.term | s.trunc).sum()) for s in blk.steps)
        return orig(self, c, blk, control)

    VR.Driver._check_block = spy
    try:
        res = tiny_run("doorkey-8x8.pooled-random", seconds=0.5, sample_cap=16)
    finally:
        VR.Driver._check_block = orig
    assert res["correct"] and sum(ends) > 0


# -- faults and the control ---------------------------------------------------------

def _flip_obs(out):
    obs = dict(out[0])
    image = obs["image"].clone()
    image.view(-1)[5] ^= 1
    obs["image"] = image
    return (obs,) + tuple(out[1:])


def _change_reward(out):
    reward = out[2].clone()
    reward[1] += 0.25
    return out[:2] + (reward,) + out[3:]


FAULTS = ("obs_byte", "reward", "state_unchanged", "half_batch", "refill_no_levels")
# the fused engine regenerates inside its one kernel: no refill to break
CASES = [(cell, fault) for cell in CELLS for fault in FAULTS
         if not ("fused" in cell and fault == "refill_no_levels")]


def _broken_vector(fault, orig):
    def step_nofill(self, state, action):
        if fault == "state_unchanged":
            out = orig(self, state, action)
            return out[:1] + (state,) + out[2:]
        if fault == "half_batch":
            half = action.clone()
            half[: action.shape[0] // 2] = 7  # 'stay': half the batch left out
            return orig(self, state, half)
        out = orig(self, state, action)
        return _flip_obs(out) if fault == "obs_byte" else _change_reward(out)
    return step_nofill


def _broken_fused(fault, orig):
    def step(self, fs, action):
        if fault == "state_unchanged":
            out = orig(self, fs, action)
            return out[:1] + (fs,) + out[2:]
        if fault == "half_batch":
            half = action.clone()
            half[: action.shape[0] // 2] = 7
            return orig(self, fs, half)
        out = orig(self, fs, action)
        return _flip_obs(out) if fault == "obs_byte" else _change_reward(out)
    return step


def _refill_no_levels(orig):
    """A refill that moves the tick, the key and the fresh flags on but
    writes no level."""
    def refill(self, state, windows=1):
        return orig(self, state, windows).replace(pool=state.pool)
    return refill


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_correct_false(cell, fault, monkeypatch):
    """The harness's look for a card skipped, the rest of a run driven with
    the timed path broken underneath: ``correct`` comes out false."""
    from minigrid_tpu_torch.ops.fused_step import FusedVectorEnv
    from minigrid_tpu_torch.parallel.vector import VectorEnv

    if "fused" in cell:
        monkeypatch.setattr(FusedVectorEnv, "step", _broken_fused(fault, FusedVectorEnv.step))
    elif fault == "refill_no_levels":
        monkeypatch.setattr(VectorEnv, "refill", _refill_no_levels(VectorEnv.refill))
    else:
        monkeypatch.setattr(VectorEnv, "step_nofill",
                            _broken_vector(fault, VectorEnv.step_nofill))
    res = tiny_run(cell, seconds=0.2)
    assert not res["correct"], (fault, res["checks"])
    assert res["failed"] > 0


@pytest.mark.parametrize("cell", ["doorkey-8x8.pooled-random", "doorkey-8x8.fused-random"])
def test_control_is_not_correct(cell):
    """The control (the reference, its float32 reward in bfloat16, in the
    program's place) fails ``reward_ulps`` where episodes reach the goal: a
    5x5 DoorKey, where random actions do within a short run."""
    wl = {**TINY[cell][0], "num_envs": 256, "sample_every": 1, "sample_cap": 400}
    if "pooled" in cell:
        wl["pool_refill"] = 32
    res = R.run(cell, SEED, 3.0, False, device="cpu", overrides=wl,
                env_overrides={"size": 5}, also_control=True)
    assert res["correct"]
    control = res["control_checks"]
    assert not R.C.correct(control)
    assert control["reward_ulps"]["value"] > 1000
    assert all(v["value"] == 0 for k, v in control.items()
               if k not in ("reward_ulps", "compared"))


def _in_place(orig):
    """The program's outputs written into the same buffers on every call,
    as a replayed CUDA graph writes them."""
    static: dict = {}

    def into(path, x):
        if isinstance(x, torch.Tensor):
            if path not in static:
                static[path] = torch.empty_like(x)
            return static[path].copy_(x)
        if isinstance(x, dict):
            return {k: into(path + (k,), v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(into(path + (i,), v) for i, v in enumerate(x))
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: into(path + (f.name,), getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return x

    def call(self, *args):
        return into((), orig(self, *args))
    return call


@pytest.mark.parametrize("cell", CELLS)
def test_outputs_written_in_place_stay_correct(cell, monkeypatch):
    """The kept samples are copies: a program that writes its outputs into
    the same buffers on every call is still judged correct."""
    from minigrid_tpu_torch.ops.fused_step import FusedVectorEnv
    from minigrid_tpu_torch.parallel.vector import VectorEnv

    if "fused" in cell:
        monkeypatch.setattr(FusedVectorEnv, "step", _in_place(FusedVectorEnv.step))
    else:
        monkeypatch.setattr(VectorEnv, "step_nofill", _in_place(VectorEnv.step_nofill))
    res = tiny_run(cell, seconds=0.5)
    assert res["correct"], res["checks"]
    assert res["checks"]["compared"]["value"] >= 2 * TINY[cell][0]["num_envs"]


def test_goto_levels_made_again_from_their_keys():
    """The reference's GoTo draws are the program's, level for level, at a
    reset (8 draws at most) and at a refill (one draw, and whether it is
    accepted)."""
    import numpy as np

    import minigrid_tpu_torch as mgt
    from perfbench.harness import state as S
    from perfbench.reference.tasks import babyai_goto as T

    _, _, cfg, _ = R.load_cell("babyai-goto.pooled-random")
    env = mgt.make(cfg["env_id"], **cfg["env_kwargs"])
    params = mgt.VectorEnv(env, 2, reset_strategy="pooled", device="cpu").params
    keys = np.stack([np.full(96, SEED >> 32), np.arange(96) * 7919 + 5], 1)
    prog = env.generate(torch.tensor(keys), params, "cpu")
    assert not S.rows_differ(T.modelled(T.generate(keys, cfg)),
                             T.modelled(S.env_levels(prog))).any()
    cand, ok = env.generate_attempt(torch.tensor(keys), params, "cpu")
    drawn, accepted = T.attempt(keys, cfg)
    assert (S.to_np(ok) == accepted).all() and 0 < accepted.sum() < 96
    assert not S.rows_differ(T.modelled(drawn), T.modelled(S.env_levels(cand))).any()


# -- the contract's names, files and imports ----------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]] + CELLS
    names += [w["traffic"] for w in SPEC["workloads"]] + [w["config"] for w in SPEC["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in SPEC["configs"]] + [w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]] + [c["source"] for c in SPEC["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len({m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}) == \
        len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    assert 1 <= SPEC["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        e2e = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(e2e.get("workloads", CELLS))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (BENCH / "workloads" / f"{w['name']}.json").is_file()
    for c in SPEC["configs"]:
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", str(path.relative_to(ROOT))), path


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


def test_no_jax_and_a_reference_of_its_own():
    """Top-level names compared whole: ``minigrid_tpu_torch`` is allowed in
    the harness, ``minigrid_tpu`` nowhere; the reference imports nothing of
    the program and nothing of the harness."""
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "minigrid_tpu"}, path
        assert "bench" not in tops, path
        if "reference" in path.parts:
            assert "minigrid_tpu_torch" not in tops, path
            assert all(m.startswith("perfbench.reference") for m in _imports(path)
                       if m.startswith("perfbench")), path


def test_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_compared_whole(monkeypatch):
    from perfbench.harness import device as D

    monkeypatch.setitem(sys.modules, "minigrid_tpu_torch_lookalike", sys)
    assert "minigrid_tpu" not in D.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "minigrid_tpu.core", sys)
    assert "minigrid_tpu" in D.forbidden_loaded()


# -- on the card -------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(card, cell):
    res = R.run(cell, SEED, 2.0, False)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
