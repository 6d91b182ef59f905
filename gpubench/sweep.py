#!/usr/bin/env python3
"""Find the highest rates the serving stack sustains, once, on the card.

    python3 gpubench/sweep.py --workload serving_1m.offer_under_load --seed <n> \
        --seconds 8 --flow-rates 20000,40000,... --discover-rates 1000,2000,...

Builds the cell's serving stack once, then offers its open loop at each
rate for `--seconds`: first established flows alone (the bulk lane), then
cached DISCOVERs beside flows at `--flow-share` of the highest flow rate
sustained (or at `--flow-rate`). A rate is sustained when every frame due
in the window has retired within half a second of its close and the
latency of the window's last quarter is at most twice that of its first
quarter (no growing backlog). Prints one line per rate and the highest
sustained of each stream; the cell's mix file holds the rates chosen from
them. The cell is read from `gpubench/held/` while it is held out of
`BENCHMARK.json`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

SETTLE_S = 15.0  # how long a rate's backlog may take to retire before it is not sustained


def offer(generator, ds, loop, mix, seed, seconds):
    """One rate for `seconds`, its backlog retired (or given up after
    SETTLE_S) before the next rate starts."""
    import numpy as np

    traffic = generator.open_loop(mix, ds, seed, seconds)
    r = loop.run(traffic, seconds, np.zeros(len(traffic), dtype=bool))
    loop.settle(r, SETTLE_S)
    settle_s = time.perf_counter() - r.t_close
    loop.sched.quiesce(loop.clock())
    loop.take()
    done = r.verdict[:r.submitted] >= 0
    due = traffic.due[:r.submitted][done]
    lat = (r.done_t[:r.submitted][done] - (r.t_open + due)) * 1e3
    q1, q4 = lat[due < seconds / 4], lat[due >= 3 * seconds / 4]
    disc = traffic.kind[:r.submitted][done] == 0
    row = {
        "frames": r.submitted, "retired": int(done.sum()), "settle_s": settle_s,
        "p50_ms": float(np.percentile(lat, 50)) if len(lat) else None,
        "p95_ms": float(np.percentile(lat, 95)) if len(lat) else None,
        "p95_q1_ms": float(np.percentile(q1, 95)) if len(q1) else None,
        "p95_q4_ms": float(np.percentile(q4, 95)) if len(q4) else None,
        "offer_p95_ms": float(np.percentile(lat[disc], 95)) if disc.any() else None,
        "lag_p99_ms": float(np.percentile(r.lag, 99)) * 1e3 if r.lag else None,
    }
    row["sustained"] = bool(done.all() and settle_s < 0.5 and row["p95_q4_ms"] is not None
                            and row["p95_q4_ms"] <= 2 * row["p95_q1_ms"] + 1.0)
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--flow-rates", required=True)
    ap.add_argument("--discover-rates", required=True)
    ap.add_argument("--flow-share", type=float, default=0.5)
    ap.add_argument("--flow-rate", type=float, default=None,
                    help="take this flow rate for the DISCOVER sweep instead of the sweep's")
    args = ap.parse_args()
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    import numpy as np

    from gpubench import generator, harness
    from gpubench.systems import scheduler as S

    held = harness.load_json(harness.BENCH_DIR / "held" / f"{args.workload}.json")
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + held[key]
    bench, cell, cfg, mix = harness.load_cell(args.workload, bench)
    harness.clean_environment(cfg)
    ctx = harness.Context(cell=cell, cfg=cfg, mix=dict(mix), seed=args.seed, seconds=1.0,
                          trace=False, device="cuda", t_start=T_START)
    ds, warm, _, tables, eng, sched, clock = S.build(ctx)
    loop = S.OpenLoop(sched, clock)
    loop.settle(loop.run(warm, S.WARM_S, np.zeros(len(warm), dtype=bool)), S.DRAIN_S)
    best_flow = 0.0
    for k, r in enumerate(float(x) for x in args.flow_rates.split(",")):
        row = offer(generator, ds, loop, dict(mix, flow_rate_per_s=r, discover_rate_per_s=0.0),
                    args.seed + k, args.seconds)
        print(json.dumps({"stream": "flows", "rate": r, **row}), flush=True)
        if row["sustained"]:
            best_flow = r
    flows = args.flow_rate if args.flow_rate is not None else args.flow_share * best_flow
    best_disc = 0.0
    for k, r in enumerate(float(x) for x in args.discover_rates.split(",")):
        row = offer(generator, ds, loop, dict(mix, flow_rate_per_s=flows, discover_rate_per_s=r),
                    args.seed + 100 + k, args.seconds)
        print(json.dumps({"stream": "discovers", "rate": r, "flow_rate": flows, **row}),
              flush=True)
        if row["sustained"]:
            best_disc = r
    print(json.dumps({"highest_flow_rate": best_flow, "highest_discover_rate": best_disc,
                      "beside_flows": flows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
