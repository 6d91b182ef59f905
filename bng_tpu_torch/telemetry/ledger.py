"""Perf-regression ledger — bench_runs.jsonl promoted from a pile of

The port's copy of `bng_tpu/telemetry/ledger.py`. Its one change:
`environment_fingerprint` reads torch, CUDA and the card (name, power
limit), never jax, so a port line classes as `gpu` (`backend_class`) and
never shares a cohort with a TPU or CPU line.
schema-less lines to a schema'd, append-only, machine-gated artifact.

Three bench rounds shipped CPU numbers as TPU headlines before the
`backend_fallback` fencing caught it (VERDICT r5), and the cure has two
halves: record WHAT actually served the run (backend identity,
environment fingerprint) on every line, and refuse to compare lines
across that identity. This module is both halves plus the trend gate:

- **Schema** (``append``): every new line carries ``schema_version``,
  a ``run_id``, a wallclock ``ts`` and — from the emitters — an ``env``
  fingerprint (device kind, jaxlib version, hostname) next to the
  existing geometry keys (batch/subscribers/flows). Legacy lines are
  normalized on read (``normalize_legacy``) and tagged
  ``schema_version: 0`` so the gate can include or exclude them
  explicitly (`--no-legacy`).
- **Cohorts** (``cohort_key``): two runs are comparable only when
  metric, backend class, device kind and batch geometry all match. A
  CPU-fallback run therefore has NO TPU cohort — asking the gate to
  score one against the other is the rc=3 refusal class, never a
  silent comparison (the Gray Failure lesson: record what served the
  request BEFORE comparing anything).
- **Gate** (``gate``): robust trend regression detection for the
  newest line against its last-K comparable predecessors — median/MAD
  per gated quantity, covering EVERY stage in ``stage_breakdown`` (p99
  per stage — Dapper: the ungated stage is where the regression
  hides), the headline ``value`` (direction inferred from the unit)
  and ``offer_device_only_p99_us``. The regression threshold is
  ``median + clamp(max(K_MAD * 1.4826 * MAD, REL_FLOOR * median),
  <= HARD_CAP * median)``: the MAD term absorbs run-to-run noise, the
  relative floor keeps a near-zero-MAD cohort from flagging jitter,
  and the hard cap guarantees a 2x regression can NEVER hide inside a
  noisy cohort (PERF_NOTES §12). A stage every cohort line carries but
  the candidate dropped is a coverage regression, flagged by name.

rc contract (`bng perf gate` / `bench.py --gate`):
  0 clean (or vacuous: cohort smaller than --min-cohort)
  1 regression — stderr names the regressed stage(s)/key(s)
  2 internal error (unreadable ledger, error-line candidate)
  3 incomparable cohort — history exists for this metric+geometry but
    only on a different backend class

Stdlib-only on the gate path (no jax import): `bng perf gate` runs in
tens of milliseconds, cold, anywhere — the same discipline as bngcheck.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time
import uuid
from dataclasses import dataclass, field

SCHEMA_VERSION = 1

GATE_OK = 0
GATE_REGRESSION = 1
GATE_INTERNAL = 2
GATE_INCOMPARABLE = 3

# robust-threshold constants (PERF_NOTES §12). MAD is scaled by 1.4826
# (consistent sigma estimate under normality); the hard cap bounds the
# tolerated excess at 90% of the median so a 2x regression always trips
# regardless of cohort noise.
K_MAD = 4.0
REL_FLOOR = 0.35
HARD_CAP = 0.9
HARD_CAP_VALUE = 0.45  # higher-is-better keys: a 2x slowdown halves value

# geometry keys that define a cohort (present-only: legacy lines missing
# a key match other lines missing it). `depth` is the autotune sweep's
# pipeline-depth knob — two points differing only in depth are different
# operating points, not a trend (a depth-2 point gated against depth-8
# history would read as a fabricated 2-4x regression).
GEOMETRY_KEYS = ("batch", "subscribers", "flows", "depth")

# headline keys gated besides per-stage p99s; direction by unit/name
LOWER_BETTER_KEYS = ("offer_device_only_p99_us",)


def environment_fingerprint(device=None) -> dict:
    """Host/toolchain identity for a bench line: torch and CUDA versions,
    and for a run on the card (`device` a CUDA device) the platform
    `gpu`, the card's name, its power limit and the probe route (`cuda`:
    K1 and K2 launch their CUDA kernels there). A CPU run records the
    platform `cpu` and the route `plain`. The host path and the wire pump
    ride along once their modules are loaded. Never imports jax."""
    import torch

    env: dict = {"host": socket.gethostname(), "torch": torch.__version__,
                 "cuda": torch.version.cuda or ""}
    if device is not None and torch.device(device).type == "cuda":
        from bng_tpu_torch.utils.devenv import power_limit

        env["platform"] = "gpu"
        env["device_kind"] = torch.cuda.get_device_name(torch.device(device))
        env["power_limit"] = power_limit()
        env["table_impl"] = "cuda"
    else:
        env["platform"] = "cpu"
        env["device_kind"] = "cpu"
        env["table_impl"] = "plain"
    # the wire pump (scalar | vector): a batch-pump run never trends
    # against per-frame pump history (cohort_key keys on it)
    wp = sys.modules.get("bng_tpu_torch.runtime.xsk")
    if wp is not None:
        env["wire_pump"] = wp.current_wire_pump_label()
    return env


# ---------------------------------------------------------------------------
# line identity
# ---------------------------------------------------------------------------

def _device_str(line: dict) -> str:
    env = line.get("env") or {}
    return str(line.get("device") or env.get("device_kind") or "")


def backend_class(line: dict) -> str:
    """cpu | tpu | gpu | host — what actually served the run. The
    explicit fallback flag wins (a fallback line IS a cpu line even if
    other fields look healthy), then the env platform, then the device
    string; lines with no device at all (config-1 pure-host runs) are
    their own `host` class."""
    if line.get("backend_fallback"):
        return "cpu"
    env = line.get("env") or {}
    plat = env.get("platform")
    if plat:
        return str(plat)
    dev = _device_str(line)
    low = dev.lower()
    if "tpu" in low:
        return "tpu"
    if "cpu" in low:
        return "cpu"
    if "gpu" in low or "cuda" in low or "rocm" in low:
        return "gpu"
    return "host"


def device_kind(line: dict) -> str:
    """Device identity minus the ordinal (TFRT_CPU_0 -> TFRT_CPU): two
    chips of one kind are comparable, a v5e and a v4 are not. The
    `device` string is preferred over env.device_kind: both legacy and
    new bench lines carry it in the same format, while the jax
    Device.device_kind spelling differs ('cpu' vs the legacy-derived
    'TFRT_CPU') — keying on env first would silently split new runs
    from their legacy cohort and void the trend gate until new-schema
    history accumulates."""
    dev = str(line.get("device") or "")
    if dev:
        return dev.rstrip("0123456789").rstrip("_:")
    env = line.get("env") or {}
    return str(env.get("device_kind") or "")


def geometry(line: dict) -> tuple:
    return tuple((k, line[k]) for k in GEOMETRY_KEYS
                 if line.get(k) is not None)


def table_impl(line: dict) -> str:
    """Which table-probe implementation served the run: the
    top-level stamp wins (bench records the resolved choice on every
    line), then the env fingerprint. Legacy/unstamped lines predate the
    Pallas kernel and are, by construction, `xla` — defaulting keeps
    them one cohort instead of voiding all existing history.

    Host-class lines (config-1 pure control-plane runs, no device) never
    probe a device table, so their stamp is identity noise: a
    BNG_TABLE_IMPL=pallas config-1 run must keep gating against its
    host history, not void it behind an rc=3 refusal for a knob that
    cannot affect the metric."""
    if backend_class(line) == "host":
        return "xla"
    env = line.get("env") or {}
    return str(line.get("table_impl") or env.get("table_impl") or "xla")


def express_path(line: dict) -> str:
    """Which express-lane architecture served the run:
    `aot-express` (minimal AOT program + host template patch-in) vs
    `jit-full` (the full `_dhcp_jit` device program). Unstamped lines
    predate the AOT path and measured the full program — defaulting to
    `jit-full` keeps existing scheduler/OFFER history one cohort
    instead of voiding it. The two architectures are different
    programs: the gate must never trend one against the other (rc=3
    refusal, same discipline as table_impl)."""
    v = line.get("express_path")
    return str(v) if v else "jit-full"


def express_loop(line: dict) -> str:
    """Which express SERVING LOOP drove the dispatches:
    `per-batch` (one device touch per admission batch — both the
    jit-full and aot-express architectures) vs `devloop` (the k-slot
    descriptor-ring megakernel, one device touch per k batches).
    Unstamped lines predate the ring and dispatched per batch —
    defaulting to `per-batch` keeps ALL existing express history
    (jit-full and aot-express cohorts alike) one loop cohort. The loop
    changes what a "dispatch" stage lap even measures (one batch vs an
    amortized ring share): a trend across loops is an architecture
    comparison, not a regression signal (rc=3 refusal, the express_path
    discipline)."""
    v = line.get("express_loop")
    return str(v) if v else "per-batch"


def host_path(line: dict) -> str:
    """Which HOST serving path staged the run: `scalar` (the
    per-frame ring/admission/pack loops, the port's only host path) vs
    `vector` (the reference package's batch-native SoA path, which
    recorded lines may carry). The top-level stamp wins
    (`bench.py --host-ab` records it per cohort), then the env
    fingerprint. Unstamped lines ran the per-frame loops — defaulting
    to `scalar` keeps that history one cohort. The two paths do the same work with different host
    machinery: a host-stage trend across them is an architecture
    comparison, not a regression signal (rc=3 refusal, the table_impl
    discipline)."""
    v = line.get("host_path")
    if v:
        return str(v)
    env = line.get("env") or {}
    return str(env.get("host_path") or "scalar")


def wire_pump(line: dict) -> str:
    """Which wire-pump implementation moved the run's frames: `scalar`
    (the per-frame ctypes loop) vs `vector` (the batch verbs behind
    BNG_WIRE_PUMP). The top-level stamp wins (`bench.py
    --wire-ab` records it per cohort), then the env fingerprint.
    Unstamped lines predate the vector pump (or never touched a wire
    loop) and ran — if anything — the per-frame pump: defaulting to
    `scalar` keeps existing history one cohort. A wire-stage trend
    across the two pumps is an architecture comparison, not a
    regression signal (rc=3 refusal, the host_path discipline)."""
    v = line.get("wire_pump")
    if v:
        return str(v)
    env = line.get("env") or {}
    return str(env.get("wire_pump") or "scalar")


def n_shards(line: dict) -> int:
    """How many dataplane shards served the run: the
    top-level stamp wins (`bench.py --shards` records it on every
    line), then the legacy spelling `devices` (the config-5 sharded
    bench always recorded its mesh width there), then the env
    fingerprint. Unstamped lines are single-device by construction —
    defaulting to 1 keeps existing history one cohort. An aggregate
    8-shard Mpps line must never trend against single-device history:
    the cohort keys on this."""
    v = line.get("n_shards")
    if v is None:
        v = line.get("devices")
    if v is None:
        v = (line.get("env") or {}).get("n_shards")
    try:
        return int(v) if v is not None else 1
    except (TypeError, ValueError):
        return 1


def n_instances(line: dict) -> int:
    """How many cluster instances served the run: the
    top-level stamp wins (`bng cluster` benches record it per line),
    then the env fingerprint. Unstamped lines are single-instance by
    construction — defaulting to 1 keeps existing history one cohort.
    An aggregate 4-instance cluster number must never trend against
    single-process history: the cohort keys on this."""
    v = line.get("n_instances")
    if v is None:
        v = (line.get("env") or {}).get("n_instances")
    try:
        return int(v) if v is not None else 1
    except (TypeError, ValueError):
        return 1


def n_hosts(line: dict) -> int:
    """How many HOSTS the cluster's carve spanned: the plan
    host axis interleaves blocks across hosts, and a multi-host run's
    numbers carry cross-host fabric overhead a single-host run never
    pays. Same accessor discipline as n_instances — top-level stamp,
    then env fingerprint, legacy default 1 (every pre-fabric line ran
    on one host by construction)."""
    v = line.get("n_hosts")
    if v is None:
        v = (line.get("env") or {}).get("n_hosts")
    try:
        return int(v) if v is not None else 1
    except (TypeError, ValueError):
        return 1


def cohort_key(line: dict) -> tuple:
    return (line.get("metric"), backend_class(line), device_kind(line),
            table_impl(line), n_shards(line), n_instances(line),
            n_hosts(line), express_path(line), express_loop(line),
            host_path(line), wire_pump(line), geometry(line))


def _gateable(line: dict) -> bool:
    """Error lines and schema-less non-bench lines never gate (and never
    serve as cohort history): a failed run is not a trend point."""
    return (isinstance(line, dict) and "metric" in line
            and "error" not in line)


def newest_gateable_index(lines: list[dict]) -> int | None:
    """Index of the line gate() would pick as candidate — callers that
    must tie a verdict to a specific run (bench.py --gate) compare this
    against the pre-run line count, so a run that appended nothing (or
    only an error line) can never get a CLEAN verdict about stale
    history."""
    for i in range(len(lines) - 1, -1, -1):
        if _gateable(lines[i]):
            return i
    return None


# ---------------------------------------------------------------------------
# schema append / read / legacy import
# ---------------------------------------------------------------------------

def append(path: str, line: dict, run_id: str | None = None,
           ts: str | None = None) -> dict:
    """Append one schema'd line. The stamp (ts/schema_version/run_id)
    happens HERE, in the appender — deterministic producers (chaos
    reports, storm bench lines) stay byte-comparable because their
    compared payloads never contain the stamp."""
    stamped = {
        "ts": ts or time.strftime("%Y-%m-%dT%H:%M:%S"),
        "schema_version": line.get("schema_version", SCHEMA_VERSION),
        "run_id": run_id or line.get("run_id") or uuid.uuid4().hex[:12],
        **{k: v for k, v in line.items()
           if k not in ("ts", "schema_version", "run_id")},
    }
    with open(path, "a") as f:
        f.write(json.dumps(stamped) + "\n")
    return stamped


def read(path: str) -> list[dict]:
    """All parseable lines, in file order. A corrupt line is skipped
    (recorded under the `_corrupt` count on the returned list's last
    resort — callers that care use gate(), which reports it)."""
    out = []
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            try:
                out.append(json.loads(raw))
            except ValueError:
                out.append({"_corrupt": raw[:80]})
    return out


def normalize_legacy(line: dict, idx: int = 0) -> dict:
    """Best-effort migration of a pre-schema line: schema_version 0 tag
    (the gate's include-or-exclude handle), a stable legacy run_id, and
    an env fingerprint recovered from the fields the old emitters did
    write (`device`). Idempotent: an already-schema'd line is returned
    unchanged."""
    if "schema_version" in line:
        return line
    env = {}
    dev = line.get("device")
    if dev:
        env["device_kind"] = str(dev).rstrip("0123456789").rstrip("_:")
    out = {
        "ts": line.get("ts", ""),
        "schema_version": 0,
        "run_id": f"legacy-{idx:03d}",
        **{k: v for k, v in line.items() if k != "ts"},
    }
    if env:
        out["env"] = env
    return out


def import_legacy(lines: list[dict]) -> list[dict]:
    """`bng perf import`: the one-shot normalizer over a whole ledger."""
    return [normalize_legacy(ln, i) for i, ln in enumerate(lines)
            if "_corrupt" not in ln]


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

@dataclass
class GateReport:
    rc: int = GATE_OK
    candidate: dict = field(default_factory=dict)
    cohort_n: int = 0
    checked: list = field(default_factory=list)
    regressions: list = field(default_factory=list)
    notes: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.rc == GATE_OK

    def to_dict(self) -> dict:
        return {
            "rc": self.rc, "ok": self.ok,
            "candidate": self.candidate, "cohort_n": self.cohort_n,
            "checked": list(self.checked),
            "regressions": list(self.regressions),
            "notes": list(self.notes),
        }

    def format_text(self) -> str:
        lines = []
        cand = self.candidate
        head = (f"perf gate: {cand.get('metric', '?')} "
                f"[{cand.get('run_id', cand.get('ts', '?'))}] "
                f"vs cohort n={self.cohort_n}")
        lines.append(head)
        for note in self.notes:
            lines.append(f"  note: {note}")
        for r in self.regressions:
            lines.append(
                f"  REGRESSION {r['key']}: {r['candidate']} vs "
                f"median {r['median']} (threshold {r['threshold']}, "
                f"MAD {r['mad']})" if "median" in r
                else f"  REGRESSION {r['key']}: {r['detail']}")
        lines.append({GATE_OK: "verdict: CLEAN (rc=0)",
                      GATE_REGRESSION: "verdict: REGRESSION (rc=1)",
                      GATE_INTERNAL: "verdict: INTERNAL ERROR (rc=2)",
                      GATE_INCOMPARABLE:
                      "verdict: INCOMPARABLE COHORT (rc=3)"}[self.rc])
        return "\n".join(lines)


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def _mad(vals: list[float], med: float) -> float:
    return _median([abs(v - med) for v in vals])


def _check_lower(key, cand, vals, regressions, checked):
    """Lower-is-better quantity (latencies): flag candidate above the
    robust threshold. The hard cap bounds tolerated excess at
    HARD_CAP * median — a 2x regression trips it in ANY cohort.
    `checked` records only quantities that actually evaluated (a
    zero-median cohort cannot be trended — claiming it was checked
    would overstate the report's coverage)."""
    med = _median(vals)
    if med <= 0:
        return
    checked.append(key)
    madn = _mad(vals, med) * 1.4826
    excess = min(max(K_MAD * madn, REL_FLOOR * med), HARD_CAP * med)
    threshold = med + excess
    if cand > threshold:
        regressions.append({
            "key": key, "candidate": round(cand, 2),
            "median": round(med, 2), "mad": round(madn, 2),
            "threshold": round(threshold, 2), "direction": "lower-better",
        })


def _check_higher(key, cand, vals, regressions, checked):
    """Higher-is-better quantity (Mpps, req/s): flag candidate below
    the robust floor; cap at HARD_CAP_VALUE so a halved value (= 2x
    slowdown) always trips."""
    med = _median(vals)
    if med <= 0:
        return
    checked.append(key)
    madn = _mad(vals, med) * 1.4826
    deficit = min(max(K_MAD * madn, REL_FLOOR * med), HARD_CAP_VALUE * med)
    threshold = med - deficit
    if cand < threshold:
        regressions.append({
            "key": key, "candidate": round(cand, 2),
            "median": round(med, 2), "mad": round(madn, 2),
            "threshold": round(threshold, 2), "direction": "higher-better",
        })


def _stage_p99(line: dict, stage: str) -> float | None:
    sb = line.get("stage_breakdown")
    if not isinstance(sb, dict):
        return None
    s = sb.get(stage)
    if not isinstance(s, dict):
        return None
    v = s.get("p99_us")
    return float(v) if isinstance(v, (int, float)) else None


def gate(lines: list[dict], last_k: int = 8, min_cohort: int = 3,
         include_legacy: bool = True, metric: str = "") -> GateReport:
    """Gate the newest gateable line against its comparable history.

    ``metric`` narrows candidacy to one metric's newest line; the
    default gates whatever run landed last (the `bench.py --gate`
    posture: you just appended a line, is it a regression?)."""
    rep = GateReport()
    corrupt = sum(1 for ln in lines if "_corrupt" in ln)
    if corrupt:
        rep.notes.append(f"{corrupt} corrupt ledger line(s) skipped")
    pool = [ln for ln in lines if _gateable(ln)]
    if metric:
        pool = [ln for ln in pool if ln.get("metric") == metric]
    if not include_legacy:
        pool = [ln for ln in pool
                if ln.get("schema_version", 0) >= SCHEMA_VERSION]
    if not pool:
        rep.notes.append("nothing to gate (no gateable lines)")
        return rep
    # legacy lines normalize in-memory so cohort identity is uniform
    pool = [normalize_legacy(ln, i) for i, ln in enumerate(pool)]
    cand = pool[-1]
    rep.candidate = {k: cand.get(k) for k in
                     ("metric", "run_id", "ts", "schema_version")}
    rep.candidate["backend"] = backend_class(cand)
    key = cohort_key(cand)
    history = pool[:-1]
    cohort = [ln for ln in history if cohort_key(ln) == key][-last_k:]
    rep.cohort_n = len(cohort)
    if len(cohort) < min_cohort:
        # ZERO same-cohort history while same-metric/geometry history
        # exists on a DIFFERENT backend class or table impl is the
        # cross-identity refusal class (a CPU-fallback run must never
        # score against TPU runs; a Pallas run must never score against
        # XLA history — the kernels are different programs). A merely
        # YOUNG same-identity cohort (1..min_cohort-1 lines) is not:
        # after a backend/impl migration the trend gate passes
        # vacuously while its new history accumulates.
        relaxed = [ln for ln in history
                   if ln.get("metric") == cand.get("metric")
                   and geometry(ln) == geometry(cand)
                   and (backend_class(ln) != backend_class(cand)
                        or table_impl(ln) != table_impl(cand)
                        or n_shards(ln) != n_shards(cand)
                        or n_instances(ln) != n_instances(cand)
                        or n_hosts(ln) != n_hosts(cand)
                        or express_path(ln) != express_path(cand)
                        or express_loop(ln) != express_loop(cand)
                        or host_path(ln) != host_path(cand)
                        or wire_pump(ln) != wire_pump(cand))]
        if not cohort and len(relaxed) >= min_cohort:
            others = sorted({
                f"{backend_class(ln)}/{table_impl(ln)}"
                f"/shards={n_shards(ln)}"
                f"/instances={n_instances(ln)}"
                f"/hosts={n_hosts(ln)}"
                f"/express={express_path(ln)}"
                f"/loop={express_loop(ln)}"
                f"/host={host_path(ln)}/wire={wire_pump(ln)}"
                for ln in relaxed})
            rep.rc = GATE_INCOMPARABLE
            rep.notes.append(
                f"candidate ran as {backend_class(cand)!r}/"
                f"{table_impl(cand)!r}/shards={n_shards(cand)}"
                f"/instances={n_instances(cand)}"
                f"/hosts={n_hosts(cand)}"
                f"/express={express_path(cand)!r}"
                f"/loop={express_loop(cand)!r}"
                f"/host={host_path(cand)!r}"
                f"/wire={wire_pump(cand)!r} (device "
                f"{device_kind(cand) or 'none'!r}) with no same-identity "
                f"history for this metric+geometry — the existing history "
                f"is on {others}: refusing the cross-identity comparison "
                f"(an aggregate sharded number never trends against a "
                f"different shard count's cohort, the AOT express "
                f"architecture never trends against the jit full-program "
                f"path, the devloop ring never trends against per-batch "
                f"dispatch, the vectorized host path never trends against "
                f"the scalar per-frame path, and the vector wire pump "
                f"never trends against the scalar pump)")
            return rep
        rep.notes.append(
            f"cohort too small (n={len(cohort)} < {min_cohort}): trend "
            f"gate passes vacuously")
        return rep

    # headline value, direction by unit
    unit = str(cand.get("unit", ""))
    vals = [float(ln["value"]) for ln in cohort
            if isinstance(ln.get("value"), (int, float))]
    if isinstance(cand.get("value"), (int, float)) and len(vals) >= min_cohort:
        if unit in ("us", "ms", "s"):
            _check_lower("value", float(cand["value"]), vals,
                         rep.regressions, rep.checked)
        else:
            _check_higher("value", float(cand["value"]), vals,
                          rep.regressions, rep.checked)

    # explicit lower-better headline keys (the paper-target quantity)
    for k in LOWER_BETTER_KEYS:
        cv = cand.get(k)
        vals = [float(ln[k]) for ln in cohort
                if isinstance(ln.get(k), (int, float)) and float(ln[k]) > 0]
        if isinstance(cv, (int, float)) and cv > 0 and len(vals) >= min_cohort:
            _check_lower(k, float(cv), vals, rep.regressions, rep.checked)

    # EVERY stage, not the headline: per-stage p99 trend
    cand_sb = cand.get("stage_breakdown") or {}
    cohort_stages: dict[str, list[float]] = {}
    for ln in cohort:
        sb = ln.get("stage_breakdown")
        if not isinstance(sb, dict):
            continue
        for stage in sb:
            v = _stage_p99(ln, stage)
            if v is not None and v > 0:
                cohort_stages.setdefault(stage, []).append(v)
    if not cand_sb and cohort_stages:
        # an entirely untraced candidate (loadtest without --trace)
        # cannot be trended per stage — note the coverage gap loudly
        # instead of fabricating a per-stage regression for every
        # stage the traced cohort carries
        rep.notes.append(
            "candidate carries no stage_breakdown: per-stage trend "
            "not evaluated (cohort has "
            f"{sorted(cohort_stages)})")
        cohort_stages = {}
    for stage in sorted(set(cand_sb) | set(cohort_stages)):
        vals = cohort_stages.get(stage, [])
        cv = _stage_p99(cand, stage)
        if cv is None:
            # coverage regression: a stage EVERY cohort line carries
            # vanished from the candidate — the Dapper failure mode
            # (the uninstrumented stage is where the regression hides)
            sb_lines = sum(1 for ln in cohort
                           if isinstance(ln.get("stage_breakdown"), dict))
            if sb_lines >= min_cohort and len(vals) == sb_lines:
                rep.regressions.append({
                    "key": f"stage:{stage}",
                    "detail": f"stage {stage!r} present in all "
                              f"{sb_lines} cohort lines but missing "
                              f"from the candidate (coverage hole)"})
            continue
        if len(vals) >= min_cohort:
            _check_lower(f"stage:{stage}", cv, vals,
                         rep.regressions, rep.checked)

    if not rep.checked and not rep.regressions:
        rep.notes.append("no gateable quantities shared with the cohort")
    if rep.regressions:
        rep.rc = GATE_REGRESSION
    return rep


def gate_file(path: str, **kw) -> GateReport:
    """gate() over a ledger file; rc=2 on an unreadable file."""
    rep = GateReport()
    try:
        lines = read(path)
    except OSError as e:
        rep.rc = GATE_INTERNAL
        rep.notes.append(f"cannot read ledger {path}: {e}")
        return rep
    try:
        return gate(lines, **kw)
    except Exception as e:  # noqa: BLE001 — rc=2 is the contract
        rep.rc = GATE_INTERNAL
        rep.notes.append(f"gate internal error: {type(e).__name__}: {e}")
        return rep


def default_ledger_path() -> str:
    """$BNG_BENCH_LOG, or bench_runs.jsonl at the repo root (next to
    bench.py). The ONE resolution rule — bench._persist, `bench.py
    --gate` and `bng perf` all call this, so they can never gate a
    different file than the run appended to."""
    envp = os.environ.get("BNG_BENCH_LOG")
    if envp:
        return envp
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "bench_runs.jsonl")
