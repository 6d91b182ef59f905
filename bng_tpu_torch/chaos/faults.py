"""Seeded, deterministic fault injection: the `fault_point()` hook API (copy
of `bng_tpu/chaos/faults.py`).

1. **Disarmed cost ~ zero.** Every instrumented call site pays one
   function call, one module-global load and one `is None` compare when
   no injector is armed: no lock, no dict lookup, no allocation.
2. **Bit-deterministic.** A `FaultPlan` is written out (a list of
   `FaultSpec`s) or generated from a seed with `random.Random`: one seed
   gives one schedule, the reference's, since `POINT_KINDS` keeps the
   reference's whole registry. The injector's record of what fired is
   part of a scenario's report.
3. **Faults are requests, not actions.** `fault_point("name")` returns
   the matching `FaultSpec` (or None); the call site honours the kinds it
   understands and ignores the rest. The injector never reaches into a
   subsystem.

The points the port carries, and the kinds each site honours:

    pool.allocate     exhaust  (control/pool.py Pool.allocate)
    dhcp.expire       skew     (control/dhcp_server.py cleanup_expired)
    engine.dispatch   fail | delay  (runtime/engine.py: every device
                               dispatch of the fused step, the DHCP-only
                               program, the express program and a
                               devloop ring)
    engine.slow_drain fail     (runtime/engine.py: a slow-lane batch)
    devloop.dispatch  fail     (devloop/host.py: the ring's staged slots
                               re-dispatch per batch, loudly)
    nat.expire        skew     (control/nat.py NATManager.expire_sessions:
                               the expiry clock jumps by `arg` seconds)

The reference's other points (the fleet, admission, checkpoints, HA,
blue/green swaps) wait for the modules that carry them.
Chaos events log through the rate-limited logger (`utils/structlog.py`)
and count into a `metrics` sink when one is given.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from bng_tpu_torch.utils.structlog import RateLimiter, get_logger

# fault kinds (call sites honor the subset that makes sense for them)
KILL = "kill"
DROP_BATCH = "drop_batch"
DUP_BATCH = "dup_batch"
REORDER = "reorder"
FORCE_SHED = "force_shed"
TRUNCATE = "truncate"
BITFLIP = "bitflip"
IO_ERROR = "io_error"
FAIL = "fail"
DELAY = "delay"
DROP_DELTA = "drop_delta"
SKEW = "skew"
EXHAUST = "exhaust"

# point -> kinds the soak generator may draw for it (the full registry;
# explicit plans can use any (point, kind) pair their call site honors)
POINT_KINDS: dict[str, tuple[str, ...]] = {
    "fleet.scatter": (KILL, DROP_BATCH, DUP_BATCH, REORDER),
    "admission.admit": (FORCE_SHED,),
    "ckpt.write": (TRUNCATE, BITFLIP, IO_ERROR),
    "ckpt.read": (TRUNCATE, BITFLIP, IO_ERROR),
    "engine.dispatch": (FAIL, DELAY),
    "engine.slow_drain": (FAIL,),
    "devloop.dispatch": (FAIL,),
    "ha.push": (DROP_DELTA,),
    "ha.connect": (FAIL,),
    "nat.expire": (SKEW,),
    "dhcp.expire": (SKEW,),
    "pool.allocate": (EXHAUST,),
    "fleet.resize": (KILL, FAIL),
    "fleet.restart": (KILL, FAIL),
    "ops.swap": (FAIL,),
    "ops.snapshot": (IO_ERROR,),
}


class FaultInjectedError(RuntimeError):
    """Raised by call sites that honor `fail`/`io_error` kinds — the
    scenario runner catches it and counts the work unit as lost (the
    client-retransmit failure mode)."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire at the `at_hit`-th visit (1-based) of
    `point`, for `count` consecutive visits. `arg` is kind-specific:
    truncate = bytes to cut, bitflip = byte offset, delay = seconds,
    skew = signed seconds added to the expiry clock."""

    point: str
    kind: str
    at_hit: int = 1
    count: int = 1
    arg: float = 0.0

    def to_dict(self) -> dict:
        return {"point": self.point, "kind": self.kind,
                "at_hit": self.at_hit, "count": self.count,
                "arg": self.arg}


@dataclass
class FaultPlan:
    """A deterministic schedule of faults. Either hand-written
    (scenarios pin exact faults) or generated from a seed (the soak
    runner's randomized-but-reproducible sweep)."""

    seed: int = 0
    specs: list[FaultSpec] = field(default_factory=list)

    @staticmethod
    def generate(seed: int, points: tuple[str, ...] | None = None,
                 n_faults: int = 8, max_hit: int = 32) -> "FaultPlan":
        """Seeded plan over `points` (default: every registered point).
        random.Random is stable across platforms and Python versions for
        the methods used here, so the schedule is bit-reproducible."""
        rng = random.Random(seed)
        points = tuple(points if points is not None else sorted(POINT_KINDS))
        specs = []
        for _ in range(n_faults):
            point = rng.choice(points)
            kind = rng.choice(POINT_KINDS[point])
            arg = 0.0
            if kind == TRUNCATE:
                arg = float(rng.randrange(1, 64))
            elif kind == BITFLIP:
                arg = float(rng.randrange(0, 1 << 16))
            elif kind == DELAY:
                arg = rng.randrange(1, 10) / 1000.0
            elif kind == SKEW:
                arg = float(rng.choice((-7200, -3600, 3600, 7200)))
            specs.append(FaultSpec(point=point, kind=kind,
                                   at_hit=rng.randrange(1, max_hit + 1),
                                   arg=arg))
        return FaultPlan(seed=seed, specs=specs)

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "specs": [s.to_dict() for s in self.specs]}


class FaultInjector:
    """Armed runtime of one FaultPlan: counts visits per point, decides
    which visits fire, and records the schedule that actually executed
    (the deterministic half of the scenario report)."""

    def __init__(self, plan: FaultPlan, metrics=None, log: bool = True):
        self.plan = plan
        self.metrics = metrics
        self.hits: dict[str, int] = {}
        self.injected: list[tuple[str, str, int]] = []  # (point, kind, hit)
        self._by_point: dict[str, list[FaultSpec]] = {}
        for spec in plan.specs:
            self._by_point.setdefault(spec.point, []).append(spec)
        self._log = get_logger("chaos") if log else None
        self._log_limit = RateLimiter(rate=2.0, burst=5)

    # -- the decision ----------------------------------------------------

    def check(self, point: str) -> FaultSpec | None:
        h = self.hits.get(point, 0) + 1
        self.hits[point] = h
        for spec in self._by_point.get(point, ()):
            if spec.at_hit <= h < spec.at_hit + spec.count:
                self._record(spec, h)
                return spec
        return None

    def mutate(self, point: str, data: bytes) -> bytes:
        """Byte-corrupting points (the checkpoint writer/reader). The
        returned bytes replace `data`; io_error raises instead."""
        spec = self.check(point)
        if spec is None:
            return data
        if spec.kind == IO_ERROR:
            raise OSError(f"chaos: injected I/O error at {point}")
        if spec.kind == TRUNCATE:
            cut = int(spec.arg) or max(1, len(data) // 4)
            return data[: max(0, len(data) - cut)]
        if spec.kind == BITFLIP:
            if not data:
                return data
            pos = int(spec.arg) % len(data)
            bit = 1 << (int(spec.arg) % 8)
            return data[:pos] + bytes([data[pos] ^ bit]) + data[pos + 1:]
        return data

    def _record(self, spec: FaultSpec, hit: int) -> None:
        self.injected.append((spec.point, spec.kind, hit))
        if self.metrics is not None:
            try:
                self.metrics.chaos_faults.inc(point=spec.point,
                                              kind=spec.kind)
            except Exception:  # noqa: BLE001 — metrics must never fault
                pass
        if self._log is not None:
            ok, suppressed = self._log_limit.allow()
            if ok:
                self._log.warning("fault injected", point=spec.point,
                                  kind=spec.kind, hit=hit, arg=spec.arg,
                                  suppressed=suppressed)

    def stats_snapshot(self) -> dict:
        by_kind: dict[str, int] = {}
        for _p, kind, _h in self.injected:
            by_kind[kind] = by_kind.get(kind, 0) + 1
        return {"hits": dict(sorted(self.hits.items())),
                "injected": [list(t) for t in self.injected],
                "by_kind": dict(sorted(by_kind.items()))}


# ---------------------------------------------------------------------------
# the hot-path hook (module-level no-op when disarmed)
# ---------------------------------------------------------------------------

_ACTIVE: FaultInjector | None = None


def any_armed() -> bool:
    """Is ANY fault plan armed? The vector wire pump checks this once
    per round and falls back to its per-frame scalar twin when chaos is
    live: fault plans count per-call hits, so a
    batched path that skipped N-1 of N fault_point() visits would
    silently shift every later hit in the plan. Disarmed (production):
    one global load + None compare, same contract as fault_point."""
    return _ACTIVE is not None


def fault_point(name: str) -> FaultSpec | None:
    """The instrumentation hook. Disarmed (the production state) this is
    a global load + None compare — nothing else. Armed, it asks the
    injector whether this visit fires and returns the FaultSpec for the
    call site to interpret."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.check(name)


def mutate_point(name: str, data: bytes) -> bytes:
    """Byte-corrupting variant for the checkpoint writer/reader: returns
    `data` untouched when disarmed."""
    if _ACTIVE is None:
        return data
    return _ACTIVE.mutate(name, data)


def arm(injector: FaultInjector) -> FaultInjector:
    global _ACTIVE
    _ACTIVE = injector
    return injector


def disarm() -> None:
    global _ACTIVE
    _ACTIVE = None


class armed:
    """Context manager: arm a plan (or a prebuilt injector) for the
    block, disarm on exit — exceptions included, so a failed scenario
    can never leak an armed injector into the next one."""

    def __init__(self, plan: FaultPlan | FaultInjector, metrics=None,
                 log: bool = True):
        self.injector = (plan if isinstance(plan, FaultInjector)
                         else FaultInjector(plan, metrics=metrics, log=log))

    def __enter__(self) -> FaultInjector:
        return arm(self.injector)

    def __exit__(self, *exc) -> None:
        disarm()


class SimClock:
    """Deterministic logical clock for scenarios. Reports built on it
    contain no wallclock, so two runs with one seed emit identical
    JSON. The epoch is arbitrary but fixed."""

    def __init__(self, start: float = 1_700_000_000.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t
