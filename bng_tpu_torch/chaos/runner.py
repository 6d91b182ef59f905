"""Scenario/soak driver — the engine behind `chaos run` (copy of
`bng_tpu/chaos/runner.py`).

Two entry points:

- `run_scenarios(seed)` — every scripted scenario and storm
  (chaos/scenarios.py, chaos/storms.py), each with a seed derived
  deterministically from the top-level one. The seven that build device
  state run on `device` (None = the card).
- `soak(seed, epochs)` — interleaves DORA/renew/release traffic through
  an inline fleet with a seed-GENERATED FaultPlan over the instrumented
  points, and runs the cross-authority audit every epoch (the
  "traffic + faults + audit every epoch" loop, as a harness rather than
  a hand-written list).

Both produce JSON-safe dicts with no wallclock, paths or object ids;
`canonical_json()` is the byte-deterministic serialization compared
across runs (`chaos run --seed S` twice, or on the card and on the CPU ->
identical bytes, equal to the reference's).

The catalog is the reference's 23 entries, so each scenario's seed (its
index in the sorted catalog) is the reference's.
"""

from __future__ import annotations

import json
import random

from bng_tpu_torch.chaos.faults import FaultPlan, SimClock, armed
from bng_tpu_torch.chaos.invariants import audit_invariants
from bng_tpu_torch.chaos.scenarios import (SCENARIOS, _mac, _release, _renew,
                                     build_fleet, dora_with_retries)
from bng_tpu_torch.chaos.storms import STORMS

REPORT_SCHEMA = 1

# the full catalog: scripted fault scenarios + the storm suite. Storm
# callables take (seed, scale); everything else takes (seed); the ones in
# ON_DEVICE also take device.
ALL_SCENARIOS = {**SCENARIOS, **STORMS}

# the entries that build an engine, a scheduler or a sharded cluster
ON_DEVICE = frozenset({
    "engine_swap_crash_rollback", "sharded_swap_crash_rollback",
    "intercept_tap_live", "route_flap_rewrite", "devloop_storm",
    "coa_policy_flap", "production_day"})


def scenario_catalog() -> list[tuple[str, str]]:
    """[(name, one-line description)] — the `chaos run --list` payload,
    sourced from each scenario's docstring so the catalog can never
    drift from the code."""
    out = []
    for name in sorted(ALL_SCENARIOS):
        doc = (ALL_SCENARIOS[name].__doc__ or "").strip()
        first = " ".join(doc.split(".")[0].split()) if doc else ""
        out.append((name, first[:120]))
    return out

# the soak generator draws faults only over points its stack actually
# visits — scheduling a fault on a point that never fires would make
# "faults injected" quietly read lower than the plan promises
SOAK_POINTS = ("fleet.scatter", "admission.admit", "dhcp.expire",
               "pool.allocate")


def _sub_seed(seed: int, idx: int) -> int:
    """Stable per-scenario seed derivation (documented so reports can be
    reproduced scenario-by-scenario with `--scenario NAME`)."""
    return seed * 1000 + idx


def run_scenarios(seed: int = 1, names: list[str] | None = None,
                  metrics=None, storm_scale: float = 1.0,
                  device=None) -> dict:
    """Run the scripted scenarios + storm suite; a scenario that
    *raises* is reported as failed (ok=False) rather than aborting the
    sweep — chaos tooling that dies on the failure it was hunting is
    useless. `storm_scale` scales the storm scenarios' subscriber
    counts (1.0 = the published storms, flash crowd at 100k). `device`
    is where the ON_DEVICE entries build their state (None = the card).
    Naming an unknown entry raises ValueError before any scenario runs."""
    picked = sorted(names) if names else sorted(ALL_SCENARIOS)
    unknown = [n for n in picked if n not in ALL_SCENARIOS]
    if unknown:
        raise ValueError(f"unknown scenario(s) {unknown}; "
                         f"have {sorted(ALL_SCENARIOS)}")
    out: dict = {"schema": REPORT_SCHEMA, "seed": seed, "scenarios": {}}
    if storm_scale != 1.0 and any(n in STORMS for n in picked):
        # the scale changes storm subscriber counts, hence the report
        # bytes — stamp it so two reports only ever compare like-for-like
        out["storm_scale"] = storm_scale
    for idx, name in enumerate(sorted(ALL_SCENARIOS)):
        if name not in picked:
            continue
        sub = _sub_seed(seed, idx)
        kw = {"device": device} if name in ON_DEVICE else {}
        try:
            if name in STORMS:
                result = STORMS[name](sub, scale=storm_scale, **kw)
            else:
                result = ALL_SCENARIOS[name](sub, **kw)
        except Exception as e:  # noqa: BLE001 — the failure IS the result
            result = {"name": name, "seed": sub, "ok": False,
                      "error": f"{type(e).__name__}: {e}"[:200]}
        out["scenarios"][name] = result
        if metrics is not None:
            metrics.chaos_scenarios.inc(
                result="ok" if result.get("ok") else "failed")
    out["ok"] = all(r.get("ok", False) for r in out["scenarios"].values())
    return out


def soak(seed: int = 1, epochs: int = 4, n_macs: int = 24,
         workers: int = 3, n_faults: int = 6, metrics=None) -> dict:
    """Seeded fault soak: churn DHCP traffic through an inline fleet
    under a generated FaultPlan, audit every epoch. Faults may cost
    service (lost shards, shed frames, skew-expired leases — all of
    which the next epoch's retransmits re-acquire where a worker still
    owns the shard); every epoch's audit must be clean."""
    clock = SimClock()
    fleet, pools, fastpath = build_fleet(workers, clock)
    plan = FaultPlan.generate(seed, points=SOAK_POINTS, n_faults=n_faults,
                              max_hit=epochs * workers * 2)
    rng = random.Random(seed ^ 0x5A5A)
    macs = [_mac(7000 + i) for i in range(n_macs)]
    epochs_out = []
    with armed(plan, metrics=metrics, log=False) as inj:
        for ep in range(epochs):
            leased = dora_with_retries(fleet, macs, clock, rounds=4)
            # churn: renew a deterministic subset, release another
            items, kind = [], {}
            for i, m in enumerate(macs):
                if m not in leased:
                    continue
                r = rng.random()
                if r < 0.25:
                    items.append((len(items), _release(m, leased[m],
                                                       9000 + i)))
                    kind[m] = "release"
                elif r < 0.75:
                    items.append((len(items), _renew(m, leased[m],
                                                     8000 + i)))
            if items:
                fleet.handle_batch(items, now=clock())
            clock.advance(30.0)
            fleet.expire(int(clock()))  # visits dhcp.expire per worker
            audit = audit_invariants(
                pools=pools, fleet=fleet, fastpath=fastpath,
                check_roundtrip=(ep == epochs - 1),
                metrics=metrics, epoch=ep)
            epochs_out.append({
                "epoch": ep,
                "leased": len(leased),
                "released": sum(1 for k in kind.values()
                                if k == "release"),
                "faults_so_far": len(inj.injected),
                "worker_failures": fleet.worker_failures,
                "shed": dict(sorted(
                    fleet.admission.stats.shed.items())),
                "audit_ok": audit.ok,
                "violations": audit.violations_by_kind(),
            })
    return {
        "schema": REPORT_SCHEMA, "seed": seed,
        "plan": plan.to_dict(),
        "injected": inj.stats_snapshot(),
        "epochs": epochs_out,
        "ok": all(e["audit_ok"] for e in epochs_out),
    }


def run_report(seed: int = 1, names: list[str] | None = None,
               soak_epochs: int = 0, metrics=None,
               storm_scale: float = 1.0, device=None) -> dict:
    """The `chaos run` payload: scenarios + storms (+ optional soak)."""
    report = run_scenarios(seed, names=names, metrics=metrics,
                           storm_scale=storm_scale, device=device)
    if soak_epochs > 0:
        report["soak"] = soak(seed, epochs=soak_epochs, metrics=metrics)
        report["ok"] = report["ok"] and report["soak"]["ok"]
    return report


def bench_lines(report: dict) -> list[dict]:
    """One diffable ledger line per scenario: the
    scenario/shed/degraded triple the loadtest BenchmarkResult also
    carries, so storm runs and load runs diff with the same tooling.
    (Wallclock stamps are the appender's job — these lines stay
    deterministic.)"""
    lines = []
    for name, r in sorted(report.get("scenarios", {}).items()):
        degraded = {}
        for key, label in (("counted_block", "nat_block"),
                           ("counted_port", "nat_port"),
                           ("blocks_refused", "nat_block_refused")):
            if r.get(key):
                degraded[label] = r[key]
        line = {
            "metric": "storm", "scenario": name,
            "ok": bool(r.get("ok", False)),
            "seed": r.get("seed"),
            "shed": dict(r.get("shed", {})),
            "degraded": degraded,
            "violations": dict(r.get("violations", {})),
        }
        # the SLO verdict (telemetry/slo.py check_budget) rides every
        # storm bench line so the perf gate's consumers see WHICH stage
        # blew its envelope, not just a boolean
        if isinstance(r.get("budget"), dict):
            line["slo"] = {"ok": bool(r["budget"].get("ok", False)),
                           "breaches": list(r["budget"].get("breaches", ()))}
        lines.append(line)
    return lines


def canonical_json(report: dict) -> str:
    """Byte-deterministic serialization (sorted keys, fixed separators)
    — the string two same-seed runs are compared on."""
    return json.dumps(report, sort_keys=True, indent=2,
                      separators=(",", ": "))
