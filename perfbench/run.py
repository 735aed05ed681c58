"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration
(``perfbench/configs/<config>.json``); its own file
``perfbench/workloads/<cell>.json`` names the driver
(``perfbench/drivers/<driver>.py``) and the traffic's parameters.  The run
loads the program, resets and warms up every shape the cell uses (all of
that is ``setup_s``), measures for ``--seconds``, then compares a sample of
what the window produced with the plain reference (``perfbench/reference``)
and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number with
its limit (also the last lines of standard error).

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs the
window with host-synced spans around the program's calls, then a short
profiler window, and reports the cell's per-layer metrics, each read by
``perfbench/metrics/<metric>.py``.  A run needs a CUDA card: without one
(or with fewer than the cell asks for) it exits with code 3 and no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import checks as C  # noqa: E402
from perfbench.harness import device as D  # noqa: E402


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(the benchmark, the cell's entry, its configuration, its workload
    file) for the cell ``name``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    wl = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    return bench, cell, cfg, wl


def reader(metric: str):
    """The ``read`` function of ``perfbench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def percentile(values, q: float) -> float | None:
    import numpy as np

    return float(np.percentile(values, q)) if len(values) else None


def run(cell_name: str, seed: int, seconds: float, traced: bool, device=None,
        overrides: dict | None = None, env_overrides: dict | None = None,
        also_control: bool = False) -> dict:
    """One run of a cell: the result object.  ``device``, ``overrides`` (of
    the workload's parameters) and ``env_overrides`` (of the env's) serve
    the CPU tests; ``also_control`` adds the control's checks beside the
    program's (``perfbench/control.py``); a benchmark run takes none of
    them."""
    bench, cell, cfg, wl = load_cell(cell_name)
    wl = {**wl, **(overrides or {})}
    cfg = {**cfg, "env_kwargs": {**cfg["env_kwargs"], **(env_overrides or {})}}
    D.set_cache_dirs()
    import torch

    if device is None:
        D.require_cards(torch, cell["chips"])
        device = torch.device("cuda", 0)
    device = torch.device(device)
    from perfbench.harness.trace import trace
    from perfbench.harness.window import run_window

    driver = importlib.import_module(f"perfbench.drivers.{wl['driver']}").Driver(
        cfg, wl, seed, device, traced=traced)
    driver.setup()
    setup_s = time.perf_counter() - T0
    driver.mark()
    win = run_window(driver.block, driver.meter, seconds)
    t_window = time.perf_counter()
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    summary = None
    if traced:
        body, trace_steps, inputs = driver.profile_body()
        summary = trace(body, device)
        inputs()
    t_check = time.perf_counter()
    counts = driver.check()
    checks = counts.result()
    found = D.forbidden_loaded()
    if found:
        sys.stderr.write(f"perfbench: the run loaded {', '.join(found)}\n")
        raise SystemExit(4)
    timing = {"setup_s": setup_s, "window_s": win["seconds"], "steps": win["steps"],
              "trace_s": t_check - t_window, "check_s": time.perf_counter() - t_check}

    num_envs = wl["num_envs"]
    metrics = {}
    if not traced:
        e2e = {"env_steps_per_s": num_envs * win["steps"] / win["seconds"],
               "step_ms_p95": percentile(win["gaps_ms"], 95),
               "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if cell_name in m.get("workloads", [cell_name]) and e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(spans=dict(driver.spans.spans), counters=driver.window_counters(),
                              trace=summary, trace_steps=trace_steps,
                              kernel_inputs=driver.kernel_inputs, window=win)
        for m in bench["per_layer"]:
            if cell_name not in m.get("workloads", [cell_name]):
                continue
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": cell["chips"], "memory_peak_bytes": peak}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    result = {"correct": C.correct(checks),
              "attempted": num_envs * win["steps"],
              "failed": counts.failures(),
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = summary["breakdown"]
    if also_control:
        result["control_checks"] = driver.check(control=True).result()
    result["timing"] = timing
    result["checks"] = checks
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    import torch

    sys.stderr.write(f"perfbench: {result['device']['kind']} x{result['device']['count']}, "
                     f"{D.power_limit()}, torch {torch.__version__}; "
                     + ", ".join(f"{k} {v:.6g}" for k, v in result["timing"].items()) + "\n")
    for line in C.lines(result["checks"]):
        sys.stderr.write(line + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
