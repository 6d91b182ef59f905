"""Time the `ops` lap of the `cgnat_port_exhaustion` storm in both packages.

The storm times its churn phase as one `ops` lap against a 5 s budget whose
verdict is part of the report; this prints that lap's wall time for the
port and for the JAX package, from the same seed and scale, on the CPU with
one torch thread (the tier-1 tests' setting). A host figure, not a device
one.

    JAX_PLATFORMS=cpu python tests/storm_lap.py [--repeats 3] [--scale 0.05]
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def lap_seconds(package: str, seed: int, scale: float) -> float:
    storms = importlib.import_module(f"{package}.chaos.storms")
    seen = []
    real = storms.check_budget

    def spy(tracer, lines):
        seen.append(tracer.breakdown()["ops"]["mean_us"] / 1e6)
        return real(tracer, lines)

    storms.check_budget = spy
    try:
        storms.cgnat_port_exhaustion(seed, scale=scale)
    finally:
        storms.check_budget = real
    return seen[-1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--packages", default="bng_tpu_torch,bng_tpu")
    a = ap.parse_args()
    import torch
    torch.set_num_threads(1)
    out = {}
    for pkg in a.packages.split(","):
        out[pkg] = [round(lap_seconds(pkg, a.seed, a.scale), 4) for _ in range(a.repeats)]
    print(json.dumps({"storm": "cgnat_port_exhaustion", "scale": a.scale,
                      "ops_lap_s": out}))


if __name__ == "__main__":
    main()
