"""The port's tracing (``minigrid_tpu_torch.utils.trace``) on the CPU: off
it records, allocates and reads nothing; on it nests spans, keeps device
counters by reference, and follows a profiler into its chrome trace; the
engine, the GoTo generator, the fused engine, the kernel loader and PPO
record every span and counter they own, in their parents (BossLevel's
LevelGen and composite verifier stages too, none of them in GoTo); and the
tools that read them (``tools/profile.py``'s span table, ``tools/bench.py``'s
``layers``)."""

from __future__ import annotations

import json
import subprocess
import sys
import time
import tracemalloc
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core import rng
from minigrid_tpu_torch.utils import trace

from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)
from tests.test_torch_kernels import KERNELS, STREAM, stub_card  # noqa: F401  (a fixture)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def tracing_restored():
    """Every test starts with tracing off and nothing recorded, and leaves
    the module so for the next test of its worker."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _spans() -> dict:
    return trace.report()["spans"]


def _counters() -> dict:
    return {k: v for k, v in trace.report()["counters"].items()
            if not k.endswith(".launches")}


# -- the module ----------------------------------------------------------------------

def test_off_records_allocates_and_reads_nothing(monkeypatch):
    class NoClock:
        def perf_counter(self):
            raise AssertionError("a span read the clock while tracing was off")

    monkeypatch.setattr(trace, "time", NoClock())
    ok = torch.ones(4, dtype=torch.bool)
    assert trace.span("a") is trace.span("b")  # the one shared no-op context
    for _ in range(10):  # warm, so the measured loop meets no first-call cache
        with trace.span("a"):
            trace.count("n", 3)
            trace.count("t", ok)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with trace.span("a"):
                trace.count("n", 3)
                trace.count("t", ok)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == trace.__file__ and d.size_diff > 0]
    assert grown == []
    rep = trace.report()
    assert rep["spans"] == {} and _counters() == {}


def test_on_follows_enable_and_the_profiler():
    """``on`` is what ``span`` and ``count`` test: off by default, on under
    ``enable`` or a recording profiler."""
    assert trace.on() is False
    trace.enable()
    assert trace.on() is True
    trace.disable()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.on()
    assert trace.on() is False


def test_spans_nest_and_self_time_is_duration_less_children():
    trace.enable()
    with trace.span("outer"):
        time.sleep(0.01)
        with trace.span("inner"):
            time.sleep(0.02)
        with trace.span("inner"):
            with trace.span("leaf"):
                time.sleep(0.005)
    spans = _spans()
    outer, inner, leaf = spans["outer"], spans["inner"], spans["leaf"]
    assert (outer["calls"], inner["calls"], leaf["calls"]) == (1, 2, 1)
    assert (outer["parents"], inner["parents"], leaf["parents"]) == ([], ["outer"], ["inner"])
    assert outer["self_seconds"] == pytest.approx(outer["seconds"] - inner["seconds"])
    assert inner["self_seconds"] == pytest.approx(inner["seconds"] - leaf["seconds"])
    assert leaf["self_seconds"] == leaf["seconds"] >= 0.005
    assert inner["seconds"] >= 0.025 and outer["seconds"] >= 0.035
    assert 0.01 <= outer["self_seconds"] < outer["seconds"]
    trace.disable()
    with trace.span("outer"):
        pass
    assert _spans()["outer"]["calls"] == 1


def test_spans_follow_the_profiler_into_its_chrome_trace(tmp_path):
    x = torch.arange(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            with trace.span("program.outer"):
                with trace.span("program.inner"):
                    (x + 1).sum()
    spans = _spans()
    assert spans["program.inner"]["parents"] == ["program.outer"]
    assert spans["program.outer"]["parents"] == []  # the caller is no program span
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    named = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    caller, outer, inner = named["caller"], named["program.outer"], named["program.inner"]

    def inside(a, b):
        return b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"]

    assert inside(outer, caller) and inside(inner, outer)
    adds = [e for e in events if e["name"] == "aten::add"]
    assert adds and all(inside(e, inner) for e in adds)
    # the profiler stopped: tracing is off again
    with trace.span("program.outer"):
        pass
    assert _spans()["program.outer"]["calls"] == 1


def test_a_device_counter_is_summed_only_when_read(monkeypatch):
    trace.enable()
    masks = [torch.tensor([True, False, True]), torch.tensor([False, False]),
             torch.tensor([1, 2, 3], dtype=torch.int32)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for m in masks:
            trace.count("hits", m)
        trace.count("hits", 4)
    assert not [e for e in prof.events() if e.name.startswith("aten::")]
    assert _counters() == {"hits": 2 + 0 + 6 + 4}
    # past FOLD_AT waiting tensors, they fold into one sum
    monkeypatch.setattr(trace, "FOLD_AT", 4)
    trace.reset()
    for _ in range(11):
        trace.count("hits", torch.ones(5, dtype=torch.bool))
    assert len(trace._pending["hits"]) <= 4
    assert _counters() == {"hits": 55}
    assert _counters() == {"hits": 55}  # reading again reads the same


def test_false_entries_are_counted_without_a_launch(monkeypatch):
    trace.enable()
    masks = [torch.tensor([True, False, True]), torch.tensor([False, False])]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for m in masks:
            trace.count_false("misses", m)
    assert not [e for e in prof.events() if e.name.startswith("aten::")]
    assert _counters() == {"misses": 1 + 2}
    monkeypatch.setattr(trace, "FOLD_AT", 4)
    trace.reset()
    for i in range(11):
        trace.count_false("misses", torch.tensor([True, i % 2 == 0, False]))
    assert len(trace._less["misses"]) <= 4
    assert _counters() == {"misses": 11 + 5}
    assert _counters() == {"misses": 16}
    trace.disable()
    trace.reset()
    trace.count_false("misses", torch.tensor([False]))
    assert _counters() == {}


def test_report_carries_the_kernel_launch_counts():
    counters = trace.report()["counters"]
    for name in KERNELS:
        assert counters[f"{name}.launches"] == trace.launches(name)


def test_report_lists_every_kernel_from_import_and_after_reset():
    """A fresh process's report has each kernel's running count at 0, with
    no ops module imported by the trace; ``reset`` leaves the counts."""
    code = ("import json\n"
            "from minigrid_tpu_torch.utils import trace\n"
            "print(json.dumps(trace.report()['counters']))\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).parent.parent,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert json.loads(done.stdout.splitlines()[-1]) == {f"{n}.launches": 0 for n in KERNELS}
    trace.enable()
    trace.count("hits", 3)
    trace.reset()
    assert trace.report()["counters"] == {f"{n}.launches": trace.launches(n) for n in KERNELS}


@pytest.mark.parametrize("name,counter", [
    ("descs", "levelgen.descs_kernel"), ("distractors", "roomgrid.distractors_kernel"),
    ("fused_step", None), ("obs_gather", None), ("threefry", "rng.threefry")])
def test_a_launch_adds_one_and_its_traced_counter_only_while_tracing(name, counter,
                                                                     stub_card):
    kernel, calls = KERNELS[name], []
    before = trace.launches(name)
    with kernel.substituted(lambda *args: calls.append(args) or 0):
        kernel.launch(stub_card, 5, 6)
        assert trace.launches(name) == before + 1 and _counters() == {}
        trace.enable()
        kernel.launch(stub_card, 5, 6)
    assert calls == [(5, 6, STREAM)] * 2  # the stream handle last
    assert trace.launches(name) == before + 2
    assert _counters() == ({} if counter is None else {counter: 1})


# -- the layers ------------------------------------------------------------------------

def test_pooled_engine_records_its_spans_and_refill_counters():
    venv = mgt.make_vec("MiniGrid-DoorKey-8x8-v0", 64, reset_strategy="pooled",
                        pool_refill=8, device=CPU)
    trace.enable()
    _, state = venv.reset(rng.PRNGKey(0, CPU))
    for t in range(4):
        _, state, *_ = venv.step_nofill(state, rng.randint(rng.PRNGKey(t, CPU), (64,), 0, 7))
    state = venv.refill(state, 4)
    _, state, *_ = venv.step(state, rng.randint(rng.PRNGKey(9, CPU), (64,), 0, 7))
    spans = _spans()
    want = {
        "vector.reset": [],
        "vector.step": [],
        "vector.step_nofill": ["vector.step"],
        "vector.refill": ["vector.step"],
        "vector.transition": ["vector.step_nofill"],
        "vector.consume": ["vector.step_nofill"],
        "vector.observe": ["vector.reset", "vector.step_nofill"],
        "vector.generate": ["vector.refill", "vector.reset"],
    }
    # the direct calls of step_nofill and refill run inside no program span
    assert {k: v["parents"] for k, v in spans.items()} == want
    assert spans["vector.step_nofill"]["calls"] == 5 and spans["vector.refill"]["calls"] == 2
    assert spans["vector.generate"]["calls"] == 3  # the reset's and two refills'
    # a validated generator fills every slot it draws for
    assert _counters() == {"refill.draws": 4 * 8 + 8, "refill.accepted": 4 * 8 + 8}
    for s in spans.values():
        assert 0 <= s["self_seconds"] <= s["seconds"]


def test_goto_records_its_generator_stages_and_accepted_draws(monkeypatch):
    venv = mgt.make_vec("BabyAI-GoTo-v0", 64, device=CPU)
    assert venv.best_effort_refill and venv.pool_refill == 16
    env = type(venv.env)
    drawn, oks = [], []
    gen_level, attempt = env.gen_level, env.generate_attempt

    def counted_gen_level(self, keys, params):
        drawn.append(keys.shape[0])
        return gen_level(self, keys, params)

    def kept_attempt(self, keys, params, device=None):
        cand, ok = attempt(self, keys, params, device)
        oks.append(ok)
        return cand, ok

    monkeypatch.setattr(env, "gen_level", counted_gen_level)
    monkeypatch.setattr(env, "generate_attempt", kept_attempt)
    trace.enable()
    _, state = venv.reset(rng.PRNGKey(3, CPU))
    reset_rows = sum(drawn)
    assert reset_rows >= 3 * 64
    assert _counters() == {"reset.draws": reset_rows}
    trace.reset()
    for t in range(2):
        _, state, *_ = venv.step(state, rng.randint(rng.PRNGKey(t, CPU), (64,), 0, 7))
    spans = _spans()
    stages = ("roomgrid.rooms", "roomgrid.place_agent", "roomgrid.connect",
              "roomgrid.distractors", "babyai.reachable", "babyai.finalize")
    for name in stages:
        assert spans[name]["parents"] == ["vector.generate"], name
        assert spans[name]["calls"] == 2, name
    assert spans["vector.generate"]["parents"] == ["vector.refill"]
    assert spans["babyai.verify"]["parents"] == ["vector.transition"]
    assert spans["vector.transition"]["parents"] == ["vector.step_nofill"]
    assert spans["vector.step_nofill"]["parents"] == ["vector.step"]
    covered = sum(spans[n]["seconds"] for n in stages)
    assert covered <= spans["vector.generate"]["seconds"]
    assert len(oks) == 2 and all(ok.shape == (16,) for ok in oks)
    assert _counters() == {"refill.draws": 32,
                           "refill.accepted": int(sum(int(ok.sum()) for ok in oks))}


BOSS_SPANS = ("levelgen.layout", "levelgen.descs", "levelgen.instr", "babyai.track",
              "babyai.clauses", "babyai.sequence")


def _boss_venv():
    venv = mgt.make_vec("BabyAI-BossLevel-v0", 16, reset_strategy="pooled", pool_refill=16,
                        device=CPU)
    _, state = venv.reset(rng.PRNGKey(7, CPU))
    return venv, state


def test_bosslevel_records_levelgen_and_composite_verifier_stages(monkeypatch):
    """One traced BossLevel ``VectorEnv.step``: LevelGen's three stages
    inside the refill's generator, the composite verifier's three inside
    ``babyai.verify``, and the descriptor loop's passes and redraws."""
    venv, state = _boss_venv()
    env = type(venv.env)
    passes, redrawn = [], []
    match = env._descs_match

    def counted_match(self, b, room_mask, locked_rect, has_locked, env8, descs):
        passes.append(1)
        if len(passes) > 1:
            redrawn.append(int(env8.shape[0]))
        return match(self, b, room_mask, locked_rect, has_locked, env8, descs)

    monkeypatch.setattr(env, "_descs_match", counted_match)
    trace.enable()
    venv.step(state, rng.randint(rng.PRNGKey(1, CPU), (16,), 0, 7))
    spans = _spans()
    for name in ("levelgen.layout", "levelgen.descs"):
        assert spans[name]["calls"] == 1 and spans[name]["parents"] == ["vector.generate"]
    # the clause kinds before the descriptions, the shape and checks after
    assert spans["levelgen.instr"]["calls"] == 2
    assert spans["levelgen.instr"]["parents"] == ["vector.generate"]
    for name in ("babyai.track", "babyai.clauses", "babyai.sequence"):
        assert spans[name]["calls"] == 1 and spans[name]["parents"] == ["babyai.verify"], name
    counters = _counters()
    assert counters["levelgen.desc_passes"] == len(passes) >= 1
    assert counters.get("levelgen.desc_redraws", 0) == sum(redrawn)


def test_bosslevel_records_nothing_with_tracing_off():
    venv, state = _boss_venv()
    venv.step(state, rng.randint(rng.PRNGKey(2, CPU), (16,), 0, 7))
    assert trace.report()["spans"] == {} and _counters() == {}


def test_goto_records_none_of_the_bosslevel_spans():
    """GoTo's one-clause verifier and its generator enter neither LevelGen
    nor the composite path."""
    venv = mgt.make_vec("BabyAI-GoTo-v0", 16, reset_strategy="pooled", pool_refill=16,
                        device=CPU)
    _, state = venv.reset(rng.PRNGKey(4, CPU))
    trace.enable()
    venv.step(state, rng.randint(rng.PRNGKey(5, CPU), (16,), 0, 7))
    spans = _spans()
    assert "babyai.verify" in spans and "vector.generate" in spans
    assert not set(BOSS_SPANS) & set(spans)
    assert not {"levelgen.desc_passes", "levelgen.desc_redraws"} & set(_counters())


def test_fused_engine_and_kernel_loader_record_their_spans(monkeypatch):
    from minigrid_tpu_torch.ops import _build

    fused = mgt.FusedVectorEnv(mgt.make("MiniGrid-DoorKey-8x8-v0"), 16, device=CPU)
    trace.enable()
    _, fs = fused.reset(rng.PRNGKey(0, CPU))
    for t in range(3):
        _, fs, *_ = fused.step(fs, rng.randint(rng.PRNGKey(t, CPU), (16,), 0, 7))
    monkeypatch.setattr(_build, "build_all", lambda: {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    assert _build.load.__wrapped__("obs_gather").endswith(".so")
    spans = _spans()
    assert spans["fused.step"]["calls"] == 3 and spans["fused.step"]["parents"] == []
    assert spans["fused.reset"]["calls"] == 1
    assert spans["ops.load"]["calls"] == 1


def test_ppo_update_records_its_two_halves():
    from minigrid_tpu_torch.rl import PPO, PPOConfig

    env = mgt.make("MiniGrid-Empty-5x5-v0")
    trainer = PPO(env, env.default_params, PPOConfig(num_envs=8, num_steps=4, num_updates=1),
                  device=CPU)
    runner = trainer.init(rng.PRNGKey(0, CPU))
    trace.enable()
    trainer.update(runner)
    spans = _spans()
    assert spans["ppo.rollout"]["calls"] == spans["ppo.optimize"]["calls"] == 1
    assert spans["vector.step"]["parents"] == ["ppo.rollout"]


# -- the tools -------------------------------------------------------------------------

def _event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_span_table_puts_launches_and_gaps_on_the_innermost_span():
    from minigrid_tpu_torch.tools.profile import span_table

    events = [
        _event("user_annotation", "vector.step_nofill", 0, 100),
        _event("user_annotation", "vector.step_nofill", 1, 98),  # a caller's, same name
        _event("user_annotation", "vector.observe", 40, 40),
        _event("cuda_runtime", "cudaLaunchKernel", 10, 5, corr=1),
        _event("cuda_runtime", "cudaLaunchKernel", 50, 5, corr=2),
        _event("cuda_runtime", "cudaMemcpyAsync", 60, 5, corr=3),
        _event("cuda_runtime", "cudaLaunchKernel", 120, 5, corr=4),
        _event("kernel", "add", 20, 10, tid=7, corr=1),
        _event("kernel", "obs_gather_kernel", 70, 10, tid=7, corr=2),
        _event("gpu_memcpy", "copy", 85, 5, tid=7, corr=3),
        _event("kernel", "sum", 130, 10, tid=7, corr=4),
    ]
    rows = {r["span"]: r for r in span_table(events)}
    assert rows["vector.observe"] == {"span": "vector.observe", "calls": 1, "launches": 1,
                                      "self_ms": 0.04, "idle_ms": pytest.approx(0.045)}
    step = rows["vector.step_nofill"]
    assert (step["calls"], step["launches"]) == (2, 1)
    assert step["self_ms"] == pytest.approx((100 - 98 + 98 - 40) / 1e3)
    assert step["idle_ms"] == 0  # the first device op ends no gap
    assert rows["-"]["launches"] == 1 and rows["-"]["idle_ms"] == pytest.approx(0.04)
    assert [r["span"] for r in span_table(events)][0] == "vector.step_nofill"


def test_profile_rollout_reports_the_span_table(tmp_path):
    from minigrid_tpu_torch.tools import profile as tprofile

    res = tprofile.profile_rollout("MiniGrid-Empty-5x5-v0", 4, 8, trace_dir=str(tmp_path),
                                   reset_strategy="pooled", refill_period=8, device="cpu")
    rows = {r["span"]: r for r in res["spans"]}
    assert {"vector.step_nofill", "vector.transition", "vector.consume", "vector.observe",
            "vector.refill", "vector.generate", "vector.reset"} <= set(rows)
    assert rows["vector.step_nofill"]["calls"] == 8 and rows["vector.refill"]["calls"] == 1
    assert all(r["launches"] == 0 and r["idle_ms"] == 0 for r in rows.values())


def test_bench_profile_layers_come_from_the_program_spans():
    from minigrid_tpu_torch.tools import bench

    venv = mgt.make_vec("MiniGrid-DoorKey-8x8-v0", 16, reset_strategy="pooled",
                        pool_refill=2, device=CPU)
    out = bench.profile(venv, 8)
    layers = out["layers"]
    assert layers["vector.step_nofill"]["calls_per_step"] == 1
    assert layers["vector.refill"]["calls_per_step"] == 1 / 8
    assert layers["vector.observe"]["parents"] == ["vector.step_nofill"]
    assert out["counters"]["refill.draws"] == 8 * 2
    # the torch ops the host issued still count inside the program's spans
    assert out["torch_ops_per_step"] > 100
    assert {"wall_us_per_step", "launches_per_step", "top_kernels"} <= set(out)
