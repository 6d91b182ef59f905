"""The serving stack `bng run` builds, fed in an open loop.

`DHCPServer` behind the engine's PASS lanes, `Engine` over the
deployment's tables, and `TieredScheduler` over the engine: the express
lane (cached DISCOVERs, the express program at its configured batch and
deadline) over the bulk lane (everything else, the fused step). One card:
the express lane shares it.

Arrivals come at the mix's two fixed rates. Each frame is submitted once
it is due and `poll` runs between submissions; every completion is taken
as it retires. A DISCOVER's latency runs from when it was due (so a stall
also delays the ones behind it) to when its OFFER was drained. Once the
window has closed no frame is added, and the loop polls until every frame
due in the window has retired (a minute at most): an answer that comes
late counts its wait, one that never comes is `unanswered`.
"""

from __future__ import annotations

import time

import numpy as np

from gpubench import check, dataset, deploy, devtrace, generator, roofline
from gpubench.dataset import ip
from gpubench.harness import Context, Run
from gpubench.reference.bng import DROP, FWD, KIND_DISCOVER, PASS, TX, Reference

DRAIN_S = 60.0  # how long after the window a due frame may still retire
WARM_S = 1.0  # seconds of the mix's own arrivals run before the window
VERDICTS = {"tx": TX, "fwd": FWD, "drop": DROP, "slow": PASS}
SAMPLE = 1 << 14  # frames of each run whose bytes are compared, drawn from the seed
RUN_BITS = 40  # a completion's tag: the run's number above these bits, the frame's below


class Clock:
    """The deployment's clock: its epoch plus the host's seconds."""

    def __init__(self, base: float):
        self.base, self.t0 = base, time.perf_counter()

    def __call__(self) -> float:
        return self.base + (time.perf_counter() - self.t0)


def build(ctx: Context):
    import torch

    from bng_tpu_torch import kernels
    from bng_tpu_torch.control.dhcp_server import DHCPServer
    from bng_tpu_torch.control.pool import Pool, PoolManager
    from bng_tpu_torch.runtime.engine import Engine
    from bng_tpu_torch.runtime.scheduler import SchedulerConfig, TieredScheduler

    cfg, split = ctx.cfg, ctx.split
    t0 = time.perf_counter()
    ds = dataset.build(cfg, ctx.seed)
    warm = generator.open_loop(ctx.mix, ds, ctx.seed ^ 0x5A5A5A5A, WARM_S)
    traffic = generator.open_loop(ctx.mix, ds, ctx.seed, ctx.seconds)
    split["data_s"] = time.perf_counter() - t0
    tables = deploy.build_tables(ds, split)
    cuda = ctx.device != "cpu"
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        kernels.entry("probe")
        kernels.entry("seg_prefix")
    split["kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    clock = Clock(float(ds.now0 + 60))
    sp = cfg["slow_path_pool"]
    pools = PoolManager(tables["fastpath"])
    net = ip(sp["network"])
    pools.add_pool(Pool(pool_id=int(sp["id"]), network=net, prefix_len=int(sp["prefix_len"]),
                        gateway=net + 1, dns_primary=ip(cfg["pool_dns"][0]),
                        dns_secondary=ip(cfg["pool_dns"][1]), lease_time=int(cfg["lease_s"])))
    server = DHCPServer(ds.server_mac.to_bytes(6, "big"), ds.server_ip, pools,
                        fastpath_tables=tables["fastpath"], clock=clock)
    eng = Engine(tables["fastpath"], tables["nat"], tables["qos"], tables["antispoof"],
                 batch_size=int(cfg["batch"]), pkt_slot=int(cfg["pkt_slot"]),
                 slow_path=server.handle_frame, clock=clock, device=ctx.device)
    sched = TieredScheduler(eng, SchedulerConfig(**cfg["scheduler"]), clock=clock)
    if cuda:
        torch.cuda.synchronize()
    split["upload_s"] = time.perf_counter() - t0
    return ds, warm, traffic, tables, eng, sched, clock


class Record:
    """The outcome of every frame of one run of arrivals, kept in arrays:
    when it retired, its verdict, and the bytes of the frames sampled."""

    def __init__(self, traffic, keep: np.ndarray):
        n = len(traffic)
        self.traffic = traffic
        self.done_t = np.full(n, np.nan)
        self.verdict = np.full(n, -1, dtype=np.int8)
        self.keep = keep
        self.frames: dict[int, bytes | None] = {}
        self.submitted = 0
        self.t_open = self.t_close = 0.0
        self.lag: list[float] = []

    def answered(self) -> int:
        return int((self.verdict[:self.submitted] >= 0).sum())


class OpenLoop:
    def __init__(self, sched, clock):
        self.sched, self.clock = sched, clock
        self.records: list[Record] = []
        self.bulk: list = []  # (tags, now) of every bulk dispatch
        orig = sched._dispatch_bulk

        def rec(pend, now, reason):
            self.bulk.append(([p.tag for p in pend], now))
            return orig(pend, now, reason)

        sched._dispatch_bulk = rec

    def run(self, traffic, seconds: float, keep: np.ndarray) -> Record:
        """Submit `traffic` on its schedule for `seconds`, polling between
        submissions; arrivals the loop had no turn for before the close
        were due in the window all the same, and go in then, late."""
        r = Record(traffic, keep)
        rid = len(self.records)
        self.records.append(r)
        s, clock = self.sched, self.clock
        due, rows, lens = traffic.due, traffic.rows, traffic.lens
        n = len(due)
        base = rid << RUN_BITS
        i = 0
        r.t_open = time.perf_counter()
        t_end = r.t_open + seconds
        while True:
            t = time.perf_counter()
            if t >= t_end:
                break
            rel = t - r.t_open
            while i < n and due[i] <= rel:
                s.submit(rows[i, :lens[i]].tobytes(), True, now=clock(), tag=base + i)
                if i % 64 == 0:
                    r.lag.append(rel - due[i])
                i += 1
            s.poll(clock())
            self.take()
        while i < n:
            s.submit(rows[i, :lens[i]].tobytes(), True, now=clock(), tag=base + i)
            i += 1
        r.submitted = i
        r.t_close = time.perf_counter()
        return r

    def take(self) -> None:
        t = time.perf_counter()
        for c in self.sched.drain_completions():
            r = self.records[c.tag >> RUN_BITS]
            i = c.tag & ((1 << RUN_BITS) - 1)
            r.done_t[i] = t
            r.verdict[i] = VERDICTS[c.verdict]
            if r.keep[i]:
                r.frames[i] = c.frame

    def settle(self, r: Record, limit_s: float) -> None:
        """Flush (closing partial batches) until every frame of `r` is in."""
        t_stop = time.perf_counter() + limit_s
        while r.answered() < r.submitted and time.perf_counter() < t_stop:
            self.sched.flush(self.clock())
            self.take()


def sample_mask(n: int, seed: int, salt: int) -> np.ndarray:
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, salt])
    keep = np.zeros(n, dtype=bool)
    keep[rng.choice(n, min(SAMPLE, n), replace=False)] = True
    return keep


def run(ctx: Context) -> Run:
    import torch

    cuda = ctx.device != "cpu"
    ds, warm, traffic, tables, eng, sched, clock = build(ctx)
    loop = OpenLoop(sched, clock)
    t0 = time.perf_counter()
    wr = loop.run(warm, WARM_S, sample_mask(len(warm), ctx.seed, 0x5A3))
    loop.settle(wr, DRAIN_S)
    if cuda:
        torch.cuda.synchronize()
    ctx.split["warmup_s"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - ctx.t_start
    ctx.note("set-up " + ", ".join(f"{k} {v:.3f}" for k, v in ctx.split.items())
             + f"; setup_s {setup_s:.3f}")

    tracer = None
    if ctx.trace:
        from bng_tpu_torch.telemetry import spans as tele

        tracer = tele.arm(tele.Tracer(keep_events=1 << 20))
    r = loop.run(traffic, ctx.seconds, sample_mask(len(traffic), ctx.seed, 0x5A4))
    loop.settle(r, DRAIN_S)
    if tracer is not None:
        from bng_tpu_torch.telemetry import spans as tele

        tele.disarm()
    if cuda:
        torch.cuda.synchronize()
    peak_mem = torch.cuda.max_memory_allocated() if cuda else 0

    disc = (traffic.kind == KIND_DISCOVER) & (r.verdict >= 0)
    lat = (r.done_t[disc] - (r.t_open + traffic.due[disc])) * 1e3
    e2e = {"setup_s": setup_s}
    if len(lat):
        e2e["offer_p95_ms"] = float(np.percentile(lat, 95))
    layer = {"tracer": tracer, "lag": r.lag, "offer_ms": lat}
    ctx.note(f"window {r.t_close - r.t_open:.3f} s: {r.submitted} frames due, "
             f"{int((traffic.kind == KIND_DISCOVER).sum())} DISCOVERs, offer p50 "
             f"{np.percentile(lat, 50) if len(lat) else float('nan'):.3f} ms; generator lag p99 "
             f"{np.percentile(r.lag, 99) * 1e3 if r.lag else 0:.3f} ms")

    checks = serve_checks(Reference(ds), loop, eng, tables)
    prof = None
    if ctx.trace:
        extra = generator.open_loop(ctx.mix, ds, ctx.seed ^ 0x7ACE, float(ctx.mix["trace_seconds"]))
        prof = profile_slice(ctx, loop, eng, sched, extra, layer)
    return Run(e2e=e2e, attempted=r.submitted, failed=r.submitted - r.answered(),
               checks=checks, memory_peak_bytes=peak_mem, layer=layer,
               busy_s=prof.busy_s if prof else None, window_s=prof.window_s if prof else None,
               breakdown=prof.breakdown() if prof else None)


def serve_checks(ref, loop: OpenLoop, eng, tables) -> dict:
    """Every frame's verdict, a seeded sample's bytes, and the table words
    after replaying every bulk batch the scheduler ran (its batches and
    their `now`, recorded at dispatch), over every run so far."""
    recs = loop.records
    offs = np.cumsum([0] + [len(x.traffic) for x in recs])
    kind = np.concatenate([x.traffic.kind for x in recs])
    refs = np.concatenate([x.traffic.ref for x in recs])
    xid = np.concatenate([x.traffic.xid for x in recs])
    lens = np.concatenate([x.traffic.lens for x in recs])
    sent = np.concatenate([np.arange(len(x.traffic)) < x.submitted for x in recs])
    got = np.concatenate([x.verdict for x in recs])
    mask = (1 << RUN_BITS) - 1
    order, hist, g = [], [], 0
    for tags, now in loop.bulk:
        t = np.asarray(tags, dtype=np.int64)
        pos = offs[t >> RUN_BITS] + (t & mask)
        order.append(pos)
        hist.append((g, len(pos), now))
        g += len(pos)
    pos_bulk = np.concatenate(order) if order else np.zeros(0, dtype=np.int64)
    exp = ref.run(kind[pos_bulk], refs[pos_bulk], lens[pos_bulk], hist)
    want = np.full(len(kind), TX, dtype=np.int8)  # DISCOVERs: the express lane answers
    want[pos_bulk] = exp["verdict"]
    answered = sent & (got >= 0)
    checks = {"unanswered": int((sent & (got < 0)).sum()),
              "verdicts_off": int((answered & (got != want)).sum()), "bytes_off": 0}
    for k, x in enumerate(recs):
        idx = np.array(sorted(x.frames), dtype=np.int64)
        if not len(idx):
            continue
        p = offs[k] + idx
        ok = want[p] != DROP
        checks["bytes_off"] += bytes_off(ref, kind[p[ok]], refs[p[ok]], xid[p[ok]], lens[p[ok]],
                                         [x.frames[i] for i in idx[ok]])
    checks.update(check.table_checks(ref, exp, check.read_tables(eng, tables)))
    return {k: (int(v), check.LIMITS[k]) for k, v in checks.items()}


def bytes_off(ref, kind, refs, xid, lens, frames) -> int:
    """Frames among `frames` that differ from the reference's."""
    off = 0
    for kd in (KIND_DISCOVER, 1):
        sel = np.nonzero(kind == kd)[0]
        if not len(sel):
            continue
        er, el = (ref.offer_rows(refs[sel], xid[sel]) if kd == KIND_DISCOVER
                  else ref.snat_rows(refs[sel], lens[sel]))
        for r, j in enumerate(sel):
            f = frames[j]
            off += f is None or len(f) != el[r] or bytes(er[r, :el[r]]) != f
    return off


def profile_slice(ctx: Context, loop: OpenLoop, eng, sched, traffic, layer: dict):
    """`traffic` (`trace_seconds` more of the mix) under the profiler (its
    backlog retires after the slice), each express program call's
    descriptors kept for the K1 bytes."""
    from bng_tpu_torch.runtime import engine as engine_mod

    descs = []
    orig = engine_mod.ExpressProgram.__call__

    def call_rec(prog, desc, now):
        descs.append(np.array(desc, dtype=np.uint32))
        return orig(prog, desc, now)

    undo = [devtrace.annotate(sched, "_dispatch_express_direct", "express_dispatch"),
            devtrace.annotate(sched, "_retire_express", "express_retire"),
            devtrace.annotate(sched, "_retire_bulk", "bulk_retire"),
            devtrace.annotate(sched, "submit", "submit")]
    engine_mod.ExpressProgram.__call__ = call_rec
    try:
        with devtrace.profiled(ctx.device != "cpu") as holder:
            r = loop.run(traffic, float(ctx.mix["trace_seconds"]), np.zeros(len(traffic), bool))
    finally:
        engine_mod.ExpressProgram.__call__ = orig
        for u in undo:
            u()
    loop.settle(r, DRAIN_S)
    prof = holder[0]
    layer["profile"] = prof
    layer["card"] = roofline.DEFAULT_CARD if ctx.device == "cpu" else torch_card()
    graph = prof.graph_kernels()
    layer["graph"] = (sum(e["dur"] for e in graph) / 1e6, len(prof.graph_corr))
    t = eng.tables.dhcp
    host = [(x.krows.cpu().numpy().view(np.uint32), x.stash_rows.cpu().numpy().view(np.uint32),
             x.vals.shape[1]) for x in (t.vlan, t.cid, t.sub)]
    nbytes = 0
    for d in descs:
        for (kr, sr, V), cols in zip(host, (slice(3, 4), slice(8, 16), slice(1, 3))):
            nbytes += roofline.k1_bytes(kr, sr, V, d[:, cols])
    k1 = [e["dur"] / 1e6 for e in graph if "probe_kernel" in e["name"]]
    layer["k1_express"] = (nbytes, sum(k1), 3 * len(descs), len(k1))
    return prof


def torch_card() -> str:
    import torch

    return torch.cuda.get_device_name(0)
