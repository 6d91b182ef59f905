"""The PPPoE-over-QinQ box fed by its packet ring, in a closed loop.

As `systems/ring.py` serves the IPoE box: the benchmark writes each batch
of frames into the ring's frame area and submits them, calls
`Engine.process_ring_pipelined` with the batch's `now`, and drains the
output as the previous batch retires, the ring kept full. The box has two
ports, so a batch interleaves access-side frames (upstream session data
and LCP on the subscribers' lines) and core-side frames (downstream data)
as its RX would: each frame is submitted with its own direction.

The engine runs the fused step with its PPPoE stages (`Engine(pppoe=...)`)
over the session tables, every session bound to its QinQ line. Once the
window has closed the reference (`gpubench/reference/pppoe.py`) replays
every batch with the same `now`, and the two are compared
(`gpubench/pppoe_check.py`).
"""

from __future__ import annotations

import time

import numpy as np

from gpubench import deploy, pppoe_check, pppoe_data
from gpubench.dataset import ip
from gpubench.harness import Context, Run
from gpubench.reference.pppoe import DROP, FWD, PASS, TX, Reference
from gpubench.systems.ring import (SAMPLE_EVERY, WARM_BATCHES, RingLoop, pow2, profile_slice,
                                   sample_offset)

PST_DECAP, PST_ENCAP = 0, 1  # bng_tpu_torch.ops.pppoe's stats


class TwoPortLoop(RingLoop):
    """`RingLoop` with a direction a frame (the traffic's `flags`), each
    frame's live bytes alone written into the ring, and the first `keep`
    bytes of a sampled output frame kept (the engine's slot: the longest
    frame it can give)."""

    def __init__(self, *args, keep: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.keep = keep
        # every batch of the pool holds the same number of frames of each
        # length: per length, each batch's lanes and their rows cut to it
        nb = len(self.t) // self.B
        by_batch = self.t.lens.reshape(nb, self.B)
        self.widths = []
        for w in np.unique(by_batch):
            lanes = np.nonzero(by_batch == w)[1].reshape(nb, -1)
            rows = self.t.rows.reshape(nb, self.B, -1)[np.arange(nb)[:, None], lanes, :w]
            self.widths.append((int(w), lanes, rows))

    def push(self) -> tuple[int, int]:
        n, P = self.B, len(self.t)
        p0 = self.g % P
        if p0 + n > P:
            raise RuntimeError("ring: the pool is not a whole number of batches")
        a = self.addrs[:n]
        if self.ring.rx_reserve_batch(a) != n:
            raise RuntimeError("ring: no free frames for a batch")
        np.floor_divide(a, np.uint64(self.fs), out=self.chunks, casting="unsafe")
        for w, lanes, rows in self.widths:
            self.umem[self.chunks[lanes[p0 // n]], :w] = rows[p0 // n]
        self.pos_of_chunk[self.chunks] = self.g + self.lane[:n]
        if self.ring.rx_submit_batch(a, self.lens32[p0:p0 + n], self.t.flags[p0:p0 + n],
                                     self.ok, n) != n:
            raise RuntimeError("ring: a batch was refused")
        g0 = self.g
        self.g += n
        self.nb += 1
        return g0, n

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
        drop, slow = s["drop"] - self.stats0["drop"], s["slow"] - self.stats0["slow"]
        extra += (abs(int((verdict == DROP).sum()) - drop)
                  + abs(int((verdict == PASS).sum()) - slow))
        rec.update(t_done=time.perf_counter(), verdict=verdict, extra=extra)
        self.stats0 = s
        if (rec["b"] + self.sample_offset) % SAMPLE_EVERY == 0:
            rec["out_pos"], rec["out_verdict"] = g[mine], out_v[mine]
            rec["out_rows"] = self.umem[chunk[mine], :self.keep]
            rec["out_lens"] = self.out_lens[:k][mine].astype(np.int64)
        self.pos_of_chunk[chunk] = -1  # these frames go back to the ring's pool
        self.ring.frame_free_batch(self.out_addrs, k)
        self.batches.append(rec)


def build_tables(ds: pppoe_data.Dataset, split: dict) -> dict:
    """{"fastpath", "nat", "qos", "antispoof", "pppoe"}: the port's host
    tables, installed through its host API. The session tables go first:
    a program that cannot bind a session to its line stops here."""
    from bng_tpu_torch.control.nat import NATManager
    from bng_tpu_torch.runtime.engine import AntispoofTables, QoSTables
    from bng_tpu_torch.runtime.tables import FastPathTables, PPPoEFastPathTables

    cfg = ds.cfg
    stash = int(cfg["table_stash"])
    t0 = time.perf_counter()
    nb = deploy.nbuckets_for(ds.n_sessions)
    pppoe = PPPoEFastPathTables(nbuckets=nb, stash=stash,
                                server_mac=ds.ac_mac.to_bytes(6, "big"))
    pppoe.bulk_sessions_up(ds.session_ids, ds.sub_macs, ds.sub_ips.astype(np.uint32),
                           s_tags=ds.s_tags, c_tags=ds.c_tags)
    fp = FastPathTables(sub_nbuckets=1 << 10, vlan_nbuckets=1 << 10, cid_nbuckets=1 << 10,
                        max_pools=64, stash=stash)
    fp.set_server_config(int(cfg["dhcp_server_mac"], 16).to_bytes(6, "big"),
                         ip(cfg["dhcp_server_ip"]))
    split["pppoe_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lo, hi = cfg["nat_port_range"]
    nat = NATManager(public_ips=[int(x) for x in ds.nat_public_ips],
                     ports_per_subscriber=int(cfg["nat_ports_per_subscriber"]),
                     port_range=(int(lo), int(hi)),
                     sessions_nbuckets=deploy.nbuckets_for(ds.n_flows), sub_nat_nbuckets=nb,
                     stash=stash)
    src = ds.sub_ips[ds.flow_session].astype(np.uint32)
    made = nat.bulk_allocate_nat(ds.sub_ips.astype(np.uint32), ds.now0)
    _, _, ok = nat.bulk_flows(src, ds.flow_dst.astype(np.uint32), ds.flow_sport.astype(np.uint32),
                              ds.flow_dport.astype(np.uint32), np.uint32(17), 100, ds.now0)
    if made != ds.n_sessions or not bool(ok.all()):
        raise RuntimeError(f"NAT build: {made} blocks, {int(ok.sum())} of {len(ok)} flows")
    split["nat_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    qos = QoSTables(nbuckets=nb)
    over, std = cfg["qos_over_quota"], cfg["qos_standard"]
    ips = ds.sub_ips.astype(np.uint32)
    qos.bulk_set_subscribers(ips[ds.over_quota], down_bps=over["rate_bps"],
                             up_bps=over["rate_bps"], down_burst=over["burst"],
                             up_burst=over["burst"])
    qos.bulk_set_subscribers(ips[~ds.over_quota], down_bps=std["down_bps"],
                             up_bps=std["up_bps"], down_burst=std["down_burst"],
                             up_burst=std["up_burst"])
    spoof = AntispoofTables(nbuckets=1 << 10, stash=64)
    spoof.set_config(deploy.MODE_LOOSE, False)
    net, plen = cfg["antispoof_loose_range"]
    spoof.add_allowed_range(ip(net), int(plen))
    split["qos_antispoof_s"] = time.perf_counter() - t0
    return {"fastpath": fp, "nat": nat, "qos": qos, "antispoof": spoof, "pppoe": pppoe}


def build(ctx: Context):
    """Set-up: the data, the tables, the engine and the ring."""
    import torch

    from bng_tpu_torch import kernels
    from bng_tpu_torch.runtime.engine import Engine
    from bng_tpu_torch.runtime.ring import NativeRing

    cfg, split = ctx.cfg, ctx.split
    B, L = int(cfg["batch"]), int(cfg["pkt_slot"])
    t0 = time.perf_counter()
    ds = pppoe_data.build(cfg, ctx.seed)
    traffic = pppoe_data.closed_loop(ctx.mix, ds, B, ctx.seed, L)
    split["data_s"] = time.perf_counter() - t0
    tables = build_tables(ds, split)
    cuda = ctx.device != "cpu"
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        kernels.entry("probe")
        kernels.entry("seg_prefix")
    split["kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = Engine(tables["fastpath"], tables["nat"], tables["qos"], tables["antispoof"],
                 pppoe=tables["pppoe"], batch_size=B, pkt_slot=L, device=ctx.device)
    if cuda:
        torch.cuda.synchronize()
    split["upload_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ring = NativeRing(nframes=pow2(4 * B), frame_size=pow2(L), depth=pow2(2 * B))
    split["ring_s"] = time.perf_counter() - t0
    return ds, traffic, tables, eng, ring


def run(ctx: Context) -> Run:
    import torch

    cuda = ctx.device != "cpu"
    ds, traffic, tables, eng, ring = build(ctx)
    B = int(ctx.cfg["batch"])
    t_built = time.perf_counter()
    base = float(ds.now0 + 60)
    loop = TwoPortLoop(lambda r, now: eng.process_ring_pipelined(r, now=now),
                       eng.flush_pipeline, ring, traffic, B,
                       lambda: base + (time.perf_counter() - t_built),
                       sample_offset=sample_offset(ctx.seed), keep=int(ctx.cfg["pkt_slot"]))
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
    pppoe0 = eng.stats.pppoe.copy()
    t_open = time.perf_counter()
    t_close = t_open + ctx.seconds
    retired = 0
    while time.perf_counter() < t_close:
        retired += loop.step()
    t_end = time.perf_counter()
    pppoe1 = eng.stats.pppoe.copy()
    if tracer is not None:
        from bng_tpu_torch.telemetry import spans as tele

        tele.disarm()
    in_window = loop.batches[first:]
    sent = sum(b["n"] for b in in_window) + sum(b["n"] for b in loop.pending)
    # the window's lanes the device decapsulated or encapsulated, and its lanes
    dev = pppoe1 - pppoe0
    layer = {"batches": in_window, "tracer": tracer,
             "pppoe_lanes": (int(dev[PST_DECAP]), int(dev[PST_ENCAP]),
                             sum(b["n"] for b in in_window))}
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

    checks = pppoe_check.ring_checks(Reference(ds), traffic, loop.batches,
                                     pppoe_check.read_tables(eng, tables))
    e2e = {"throughput": retired / window, "setup_s": setup_s}
    return Run(e2e=e2e, attempted=sent, failed=checks["unanswered"][0], checks=checks,
               memory_peak_bytes=peak_mem, layer=layer,
               busy_s=prof.busy_s if prof else None, window_s=prof.window_s if prof else None,
               breakdown=prof.breakdown() if prof else None)
