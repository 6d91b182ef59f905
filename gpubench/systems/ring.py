"""The IPoE box fed by its packet ring, in a closed loop.

The benchmark stands where the wire would: it writes each batch of frames
into the ring's frame area and submits them (the AF_XDP verbs), calls
`Engine.process_ring_pipelined` with the batch's `now`, and drains the TX
and FWD rings as the previous batch retires. A new batch goes in as one
retires, so the ring stays full. `flush_pipeline` retires the last batch
once the window has closed.

Every frame's verdict is kept; every output frame of the batches the
seed samples is copied out. Once the window has closed the reference
replays every batch the program ran, with the same `now`, and the two are
compared (`gpubench/check.py`).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from gpubench import check, dataset, deploy, devtrace, generator, roofline
from gpubench.harness import Context, Run
from gpubench.reference.bng import DROP, FWD, PASS, TX, Reference

FROM_ACCESS = 1  # the ring descriptor's from-access flag
SAMPLE_EVERY = 8  # one batch in SAMPLE_EVERY has every output frame compared
KEEP = 352  # bytes kept of a sampled output frame (the longest frame is 342)
WARM_BATCHES = 4


def pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def sample_offset(seed: int) -> int:
    return int(np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32]).integers(SAMPLE_EVERY))


class RingLoop:
    """The closed loop over one ring. `process(ring, now)` dispatches the
    batch just pushed and retires the one before (returns the frames
    retired); `flush(ring)` retires the last.

    Each frame's verdict is read off the ring: an output frame's chunk
    says which input frame it was (the program rewrites TX and FWD frames
    in place), a frame the program takes off the slow ring is a PASS, and
    the rest of the batch was dropped, as the ring's counts confirm."""

    def __init__(self, process, flush, ring, traffic, batch: int, now_fn, sample_offset: int):
        self.process, self.flush = process, flush
        self.ring, self.t, self.B, self.now_fn = ring, traffic, batch, now_fn
        self.fs = ring.frame_size
        self.umem = ring.umem_view().reshape(-1, self.fs)
        cap = 2 * batch
        self.addrs = np.zeros(cap, dtype=np.uint64)
        self.chunks = np.zeros(batch, dtype=np.int64)
        self.out_addrs = np.zeros(cap, dtype=np.uint64)
        self.out_lens = np.zeros(cap, dtype=np.uint32)
        self.ok = np.zeros(cap, dtype=np.uint8)
        self.lens32 = traffic.lens.astype(np.uint32)
        self.pos_of_chunk = np.full(len(self.umem), -1, dtype=np.int64)  # send position
        self.lane = np.arange(batch, dtype=np.int64)
        self.g = 0  # next position of the send order
        self.nb = 0  # batches pushed
        self.pending: deque = deque()
        self.batches: list[dict] = []  # retired, in order
        self.sample_offset = sample_offset
        self.stats0 = ring.stats()
        self.slow_frames: list[bytes] = []
        slow_pop = ring.slow_pop

        def tap():
            got = slow_pop()
            if got is not None:
                self.slow_frames.append(got[0])
            return got

        ring.slow_pop = tap

    def push(self) -> tuple[int, int]:
        """Reserve a batch of frames, copy the pool's next rows in and
        submit them. The pool holds whole batches, so the rows are one
        slice and the copy is one scatter, row by row, into the chunks."""
        n, P = self.B, len(self.t)
        p0 = self.g % P
        if p0 + n > P:
            raise RuntimeError("ring: the pool is not a whole number of batches")
        a = self.addrs[:n]
        if self.ring.rx_reserve_batch(a) != n:
            raise RuntimeError("ring: no free frames for a batch")
        np.floor_divide(a, np.uint64(self.fs), out=self.chunks, casting="unsafe")
        self.umem[self.chunks] = self.t.rows[p0:p0 + n, :self.fs]
        self.pos_of_chunk[self.chunks] = self.g + self.lane[:n]
        if self.ring.rx_submit_batch(a, self.lens32[p0:p0 + n], FROM_ACCESS, self.ok, n) != n:
            raise RuntimeError("ring: a batch was refused")
        g0 = self.g
        self.g += n
        self.nb += 1
        return g0, n

    def step(self) -> int:
        g0, n = self.push()
        now = self.now_fn()
        t_push = time.perf_counter()
        self.slow_frames.clear()
        retired = self.process(self.ring, now)
        self.pending.append({"b": self.nb - 1, "g0": g0, "n": n, "now": now, "t_push": t_push})
        if retired:
            self.egress(retired)
        return retired

    def finish(self) -> int:
        self.slow_frames.clear()
        retired = self.flush(self.ring)
        if retired:
            self.egress(retired)
        return retired

    def egress(self, n_retired: int) -> None:
        rec = self.pending.popleft()
        n, g0 = rec["n"], rec["g0"]
        if n != n_retired:
            raise RuntimeError(f"ring: batch of {n} retired as {n_retired}")
        n_tx = self.ring.tx_pending()
        k = self.ring.out_pop_desc_batch(self.out_addrs, self.out_lens, len(self.out_addrs))
        s = self.ring.stats()
        a = self.out_addrs[:k]
        chunk = (a // np.uint64(self.fs)).astype(np.int64)
        g = self.pos_of_chunk[chunk]
        out_v = np.full(k, FWD, dtype=np.int8)
        out_v[:n_tx] = TX
        mine = (g >= g0) & (g < g0 + n) & (a % np.uint64(self.fs) == 0)
        verdict = np.full(n, DROP, dtype=np.int8)
        verdict[g[mine] - g0] = out_v[mine]
        extra = int((~mine).sum())
        if self.slow_frames:
            extra += self.mark_slow(g0, verdict)
        # the ring's own counts of the batch's drops and PASSes must agree
        drop, slow = s["drop"] - self.stats0["drop"], s["slow"] - self.stats0["slow"]
        extra += abs(int((verdict == DROP).sum()) - drop) + abs(int((verdict == PASS).sum()) - slow)
        rec.update(t_done=time.perf_counter(), verdict=verdict, extra=extra)
        self.stats0 = s
        if (rec["b"] + self.sample_offset) % SAMPLE_EVERY == 0:
            rec["out_pos"], rec["out_verdict"] = g[mine], out_v[mine]
            rec["out_rows"] = self.umem[chunk[mine], :KEEP].copy()
            rec["out_lens"] = self.out_lens[:k][mine].astype(np.int64)
        self.pos_of_chunk[chunk] = -1  # these frames go back to the ring's pool
        self.ring.frame_free_batch(self.out_addrs, k)
        self.batches.append(rec)

    def mark_slow(self, g0: int, verdict: np.ndarray) -> int:
        """Mark PASS the frames the program took off the slow ring (whole,
        unchanged, in lane order), each matched by its bytes to a frame of
        the batch not yet given a verdict; returns the frames matching none."""
        free: dict[bytes, deque] = {}
        P = len(self.t)
        for r in np.nonzero(verdict == DROP)[0]:
            q = (g0 + int(r)) % P
            free.setdefault(self.t.rows[q, :self.t.lens[q]].tobytes(), deque()).append(r)
        unmatched = 0
        for f in self.slow_frames:
            lanes = free.get(bytes(f))
            if lanes:
                verdict[lanes.popleft()] = PASS
            else:
                unmatched += 1
        return unmatched


def build(ctx: Context):
    """Set-up: the data, the tables, the engine and the ring."""
    import torch

    from bng_tpu_torch import kernels
    from bng_tpu_torch.runtime.engine import Engine
    from bng_tpu_torch.runtime.ring import NativeRing

    cfg, split = ctx.cfg, ctx.split
    B = int(cfg["batch"])
    t0 = time.perf_counter()
    ds = dataset.build(cfg, ctx.seed)
    traffic = generator.closed_loop(ctx.mix, ds, B, ctx.seed)
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
    eng = Engine(tables["fastpath"], tables["nat"], tables["qos"], tables["antispoof"],
                 batch_size=B, pkt_slot=int(cfg["pkt_slot"]), device=ctx.device)
    if cuda:
        torch.cuda.synchronize()
    split["upload_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ring = NativeRing(nframes=pow2(4 * B), frame_size=pow2(int(cfg["pkt_slot"])),
                      depth=pow2(2 * B))
    split["ring_s"] = time.perf_counter() - t0
    return ds, traffic, tables, eng, ring


def run(ctx: Context) -> Run:
    import torch

    cuda = ctx.device != "cpu"
    ds, traffic, tables, eng, ring = build(ctx)
    B = int(ctx.cfg["batch"])
    t_built = time.perf_counter()
    base = float(ds.now0 + 60)
    loop = RingLoop(lambda r, now: eng.process_ring_pipelined(r, now=now), eng.flush_pipeline,
                    ring, traffic, B, lambda: base + (time.perf_counter() - t_built),
                    sample_offset=sample_offset(ctx.seed))
    t0 = time.perf_counter()
    for _ in range(WARM_BATCHES):
        loop.step()
    loop.finish()
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
    first = len(loop.batches)
    t_open = time.perf_counter()
    t_close = t_open + ctx.seconds
    retired = 0
    while time.perf_counter() < t_close:
        retired += loop.step()
    t_end = time.perf_counter()
    if tracer is not None:
        from bng_tpu_torch.telemetry import spans as tele

        tele.disarm()
    in_window = loop.batches[first:]
    sent = sum(b["n"] for b in in_window) + sum(b["n"] for b in loop.pending)
    layer = {"batches": in_window, "tracer": tracer}
    prof = None
    if ctx.trace:
        prof = profile_slice(ctx, loop, eng, ring, layer)
    loop.finish()
    if cuda:
        torch.cuda.synchronize()
    peak_mem = torch.cuda.max_memory_allocated() if cuda else 0
    window = t_end - t_open
    done = np.array([b["t_done"] - t_open for b in in_window])
    sixths = np.histogram(done, bins=6, range=(0.0, window))[0] * B / (window / 6)
    ctx.note("frames/s by sixth of the window: " + " ".join(f"{x:.0f}" for x in sixths))

    checks = check.ring_checks(Reference(ds), traffic, loop.batches,
                               check.read_tables(eng, tables))
    e2e = {"throughput": retired / window, "setup_s": setup_s}
    return Run(e2e=e2e, attempted=sent, failed=checks["unanswered"][0], checks=checks,
               memory_peak_bytes=peak_mem, layer=layer,
               busy_s=prof.busy_s if prof else None, window_s=prof.window_s if prof else None,
               breakdown=prof.breakdown() if prof else None)


def profile_slice(ctx: Context, loop: RingLoop, eng, ring, layer: dict):
    """`trace_batches` more batches under the profiler (the configuration's
    number where it gives one, else the mix's), each layer's call in a
    `bench::` range and every kernel call's inputs kept."""
    from bng_tpu_torch.ops import qos as qos_mod
    from bng_tpu_torch.ops import table as table_mod

    calls = {"probe": [], "seg": []}
    orig_probe, orig_seg = table_mod.probe, qos_mod.seg_prefix_total

    def probe_rec(krows, stash_rows, vals, query, nb, stash):
        calls["probe"].append((krows, stash_rows, vals.shape[1], query))
        return orig_probe(krows, stash_rows, vals, query, nb, stash)

    def seg_rec(slot, vec, compute="both"):
        calls["seg"].append((int(slot.shape[0]), compute))
        return orig_seg(slot, vec, compute)

    undo = [devtrace.annotate(ring, "assemble", "assemble"),
            devtrace.annotate(ring, "complete", "complete"),
            devtrace.annotate(eng, "_dispatch_ring_batch", "dispatch"),
            devtrace.annotate(loop, "push", "push"),
            devtrace.annotate(ring, "rx_reserve_batch", "reserve"),
            devtrace.annotate(ring, "rx_submit_batch", "submit"),
            devtrace.annotate(loop, "egress", "egress")]
    table_mod.probe, qos_mod.seg_prefix_total = probe_rec, seg_rec
    n0 = len(loop.batches)
    try:
        with devtrace.profiled(ctx.device != "cpu") as holder:
            for _ in range(int(ctx.cfg.get("trace_batches", ctx.mix["trace_batches"]))):
                loop.step()
    finally:
        table_mod.probe, qos_mod.seg_prefix_total = orig_probe, orig_seg
        for u in undo:
            u()
    prof = holder[0]
    layer["profile"] = prof
    layer["slice_batches"] = len(loop.batches) - n0
    card = roofline.DEFAULT_CARD
    if ctx.device != "cpu":
        import torch

        card = torch.cuda.get_device_name(0)
    layer["card"] = card
    layer["k1"] = k1_pairs(prof, calls["probe"])
    layer["k2"] = (sum(roofline.k2_bytes(b, c) for b, c in calls["seg"]),
                   sum(prof.kernel_time_s("seg_")), len(calls["seg"]),
                   len(prof.kernel_time_s("seg_")))
    return prof


def k1_pairs(prof, probe_calls) -> tuple[int, float, int, int]:
    """(bytes, seconds, calls, kernel launches seen) of the slice's K1 calls."""
    host = {}
    nbytes = 0
    for krows, stash_rows, V, query in probe_calls:
        key = (krows.data_ptr(), stash_rows.data_ptr())
        if key not in host:
            host[key] = (krows.cpu().numpy().view(np.uint32),
                         stash_rows.cpu().numpy().view(np.uint32))
        kr, sr = host[key]
        nbytes += roofline.k1_bytes(kr, sr, V, query.cpu().numpy().view(np.uint32))
    times = prof.kernel_time_s("probe_kernel")
    return nbytes, sum(times), len(probe_calls), len(times)
