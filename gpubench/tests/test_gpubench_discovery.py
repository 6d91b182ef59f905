"""The harness finds a cell's configuration, traffic mix and per-layer
metrics by name, so a later change adds them as files and entries alone."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest

from gpubench import harness
from gpubench.conftest import TINY_CFG, TINY_MIX, spec

BENCH = Path(__file__).resolve().parents[1]
SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_every_cell_has_its_files(cell):
    bench, c, cfg, mix = harness.load_cell(cell, spec())
    assert cfg["name"] == c["config"]
    assert (BENCH / "systems" / f"{cfg['system']}.py").is_file()
    entry = next(x for x in bench["configs"] if x["name"] == c["config"])
    assert (harness.ROOT / entry["file"]).is_file() and len(entry["source"]) <= 200


@pytest.mark.parametrize("metric", [m["name"] for m in spec()["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(harness.metric_reader(metric))


def test_benchmark_json_keeps_to_its_schema():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = ([c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", [])) <= {w["name"] for w in
                                                                      SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        reported = [m for m in SPEC["end_to_end"] if harness.applies(m, w["name"])]
        assert len(reported) >= 2 and any(harness.applies(m, w["name"]) for m in SPEC["per_layer"])


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    """Copies of the benchmark's files with a dummy of each added: the
    harness reads them by the names a new BENCHMARK.json entry gives."""
    root = tmp_path / "gpubench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((root / "configs" / "ipoe_1m.json").read_text())
    cfg["name"] = "dummy_cfg"
    (root / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "mix_80_20.json").read_text())
    mix["discover_share"] = 0.5
    (root / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (root / "metrics" / "dummy.metric.py").write_text(
        "def read(run):\n    return run.layer.get('dummy')\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "dummy_cfg", "source": "x", "file": "gpubench/configs/dummy_cfg.json",
                            "reduced": []})
    spec["workloads"].append({"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg",
                              "traffic": "dummy_mix", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "dummy.metric", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "x", "moves": "setup_s",
                              "workloads": ["dummy_cfg.dummy_mix"]})
    _, cell, cfg2, mix2 = harness.load_cell("dummy_cfg.dummy_mix", spec, root)
    assert cfg2["name"] == "dummy_cfg" and mix2["discover_share"] == 0.5
    read = harness.metric_reader("dummy.metric", root)
    run = harness.Run(e2e={}, attempted=1, failed=0, checks={}, memory_peak_bytes=0,
                      layer={"dummy": 2.5})
    assert read(run) == 2.5
    run.layer.clear()
    assert read(run) is None


@pytest.mark.parametrize("name, change", [
    ("zipf_flows", {"subscriber_pick": {"dist": "zipf", "s": 1.1},
                    "flow_pick": {"dist": "zipf", "s": 1.1}}),
    ("small_frames", {"flow_frame_len": 64}),
])
def test_a_new_mix_is_data_alone(name, change, tmp_path):
    """A Zipf-skewed mix and a mix of 64-byte flow frames, each added as a
    new mix file and nothing else, run through the whole harness on the
    CPU and come out correct against the reference."""
    root = tmp_path / "gpubench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    mix = json.loads((root / "traffic" / "mix_80_20.json").read_text())
    (root / "traffic" / f"{name}.json").write_text(json.dumps(dict(mix, **change)))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": f"ipoe_1m.{name}", "config": "ipoe_1m", "traffic": name,
                              "chips": 1, "why": "x"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and "ipoe_1m.mix_80_20" in m["workloads"]:
            m["workloads"].append(f"ipoe_1m.{name}")
    bench, cell, cfg, mix = harness.load_cell(f"ipoe_1m.{name}", spec, root)
    cfg = dict(cfg, **{k: v for k, v in TINY_CFG.items() if k in cfg})
    mix = dict(mix, **{k: v for k, v in TINY_MIX.items() if k in mix})
    ctx = harness.Context(cell=cell, cfg=cfg, mix=mix, seed=98765432101, seconds=2.0,
                          trace=False, device="cpu", t_start=time.perf_counter())
    line = harness.execute(ctx, bench)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
