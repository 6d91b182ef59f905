"""Test settings of the benchmark's own tests (`pytest gpubench/tests`).

The `card` marker names tests that need a CUDA card; their `card` fixture
decides, when the test runs, whether one is there, and skips otherwise.
`tiny` shrinks a cell's configuration and mix so that a whole run fits
the CPU in seconds, with every table and lane kind still present."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CFG = {"subscribers": 4096, "nat_subscribers": 1024, "flows": 4096, "qos_policies": 64,
            "antispoof_bindings": 64, "batch": 256, "nat_public_ips": 2, "table_stash": 64}
TINY_SHARDED = {"shards": 2, "nat_public_ips": 2, "nat_public_ips_per_shard": 1}
TINY_MIX = {"pool_batches": 4, "trace_batches": 2, "discover_rate_per_s": 200.0,
            "flow_rate_per_s": 2000.0, "trace_seconds": 1.0}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")


def spec() -> dict:
    """BENCHMARK.json with the entries of the cells held out of it
    (`gpubench/held/*.json`) added, so their serving loops stay tested."""
    from gpubench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for path in sorted((ROOT / "gpubench" / "held").glob("*.json")):
        held = harness.load_json(path)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + held[key]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in held.get("reported_by_cell", []):
                m["workloads"] = m["workloads"] + [w["name"] for w in held["workloads"]]
    return bench


def tiny_context(cell: str, seed: int = 12345678901, seconds: float = 2.0, trace: bool = False):
    from gpubench import harness

    bench, c, cfg, mix = harness.load_cell(cell, spec())
    cfg = dict(cfg, **{k: v for k, v in TINY_CFG.items() if k in cfg})
    if "shards" in cfg:
        cfg.update(TINY_SHARDED)
    if "scheduler" in cfg:
        cfg["scheduler"] = dict(cfg["scheduler"], bulk_batch=TINY_CFG["batch"])
    mix = dict(mix, **{k: v for k, v in TINY_MIX.items() if k in mix})
    ctx = harness.Context(cell=c, cfg=cfg, mix=mix, seed=seed, seconds=seconds, trace=trace,
                          device="cpu", t_start=time.perf_counter())
    return bench, ctx


@pytest.fixture
def tiny():
    return tiny_context
