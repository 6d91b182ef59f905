"""The benchmark's frame: finds a cell's files by name, runs its system's
serving loop, reads the per-layer metrics, decides `correct` and prints
the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in files of its own, found by the names in
`BENCHMARK.json`:

    gpubench/configs/<config>.json    the deployment (its "system" names how it is served)
    gpubench/traffic/<mix>.json       the mix's parameters (generator.py reads them)
    gpubench/metrics/<metric>.py      read(run) -> a number, or None when absent
    gpubench/systems/<system>.py      run(ctx) -> Run: how such a system is served
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bng_tpu")  # top-level module names, compared whole
PACKAGE = "bng_tpu_torch"


class Refused(Exception):
    """The run cannot give a result here (no card, a missing package)."""


@dataclass
class Context:
    cell: dict
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str  # "cuda" on the card; the CPU tests pass "cpu"
    t_start: float  # perf_counter at process start
    split: dict = field(default_factory=dict)  # set-up seconds by part

    def note(self, msg: str) -> None:
        print(f"[gpubench {time.strftime('%H:%M:%S')}] {msg}", flush=True)


@dataclass
class Run:
    """What a system's run hands back once the window has closed and the
    reference has judged it."""

    e2e: dict  # end-to-end metric name -> value
    attempted: int
    failed: int
    checks: dict  # number compared -> (value, limit)
    memory_peak_bytes: int
    layer: dict = field(default_factory=dict)  # what the per-layer readers read
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"gpubench: no workload {name!r} in BENCHMARK.json")


def load_cell(name: str, bench: dict | None = None, bench_dir: Path = BENCH_DIR):
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(bench, name)
    cfg = load_json(bench_dir / "configs" / f"{cell['config']}.json")
    mix = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, cfg, mix


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def device_block(ctx: Context, run: Run) -> dict:
    import torch

    if ctx.device == "cpu":
        kind, count = "cpu", 1
    else:
        kind, count = torch.cuda.get_device_name(0), int(ctx.cell["chips"])
    block = {"platform": "gpu" if ctx.device != "cpu" else "cpu", "kind": kind,
             "count": count, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if ctx.trace and run.busy_s is not None:
        block["busy_s"], block["window_s"] = run.busy_s, run.window_s
    return block


def result(ctx: Context, bench: dict, run: Run) -> dict:
    name = ctx.cell["name"]
    if ctx.trace:
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, name):
                v = metric_reader(m["name"])(run)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(run.e2e[m["name"]]), "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, name) and m["name"] in run.e2e}
    out = {"correct": run.correct, "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": device_block(ctx, run)}
    if ctx.trace and run.breakdown is not None:
        out["breakdown"] = run.breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out


def clean_environment(cfg: dict) -> None:
    """The program's switches come from the configuration alone: every
    BNG_* variable of the caller's environment is dropped, then the
    configuration's own are set (before the program is imported)."""
    for k in [k for k in os.environ if k.startswith("BNG_")]:
        del os.environ[k]
    for k, v in cfg.get("environment", {}).items():
        os.environ[k] = str(v)


def execute(ctx: Context, bench: dict) -> dict:
    """Run one cell on `ctx.device` and return its result line."""
    clean_environment(ctx.cfg)
    system = importlib.import_module(f"gpubench.systems.{ctx.cfg['system']}")
    run = system.run(ctx)
    bad = forbidden_modules()
    if bad:
        raise Refused(f"modules of the JAX package or JAX were loaded: {', '.join(bad)}")
    return result(ctx, bench, run)


def print_result(line: dict) -> None:
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="gpubench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        if not (ROOT / PACKAGE).is_dir():
            raise Refused(f"the package under test, {PACKAGE}/, is not in {ROOT}")
        bench, cell, cfg, mix = load_cell(args.workload)
        import torch

        want = int(cell["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < want:
            raise Refused(f"{args.workload} needs {want} CUDA card(s); "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        ctx = Context(cell=cell, cfg=cfg, mix=mix, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda", t_start=t_start)
        line = execute(ctx, bench)
    except Refused as e:
        print(f"gpubench: {e}", file=sys.stderr, flush=True)
        return 3
    print_result(line)
    return 0
