"""The sharded box (the reference's multichip layout) fed by its steering
ring, in a closed loop.

`ShardedCluster` with `shards` logical shards of `batch / shards` lanes
each, placed over the visible cards by the program (`place_shards`: shard
i on card i mod cards), its lookups' rows crossing cards through its
exchange. The DHCP tables are sharded by the hash of the key; NAT, QoS
and antispoof state lives on each subscriber's affinity shard, whose
public addresses it carves from. The benchmark feeds the cluster's own
steering ring as it feeds the single box's (`systems/ring.py`), one
region of each batch a shard, and calls
`ShardedCluster.process_ring_pipelined` with each batch's `now`.
"""

from __future__ import annotations

import time

import numpy as np

from gpubench import check, dataset, deploy, generator
from gpubench.dataset import ip, ip_shard
from gpubench.deploy import MODE_LOOSE, nbuckets_for
from gpubench.systems.ring import WARM_BATCHES, RingLoop, pow2, profile_slice, sample_offset
from gpubench.harness import Context, Run
from gpubench.reference.bng import M32, Reference


def build_cluster(ds, cfg: dict, device: str, split: dict):
    """The sharded deployment through the cluster's host API (a data-driven
    copy of `chip_smoke.build_sharded`)."""
    from bng_tpu_torch.parallel.sharded import ShardedCluster

    n = int(cfg["shards"])
    k = int(cfg["nat_public_ips_per_shard"])
    t0 = time.perf_counter()
    cl = ShardedCluster(
        n, batch_per_shard=int(cfg["batch"]) // n, sub_nbuckets=nbuckets_for(ds.n_subs // n),
        vlan_nbuckets=1 << 10, cid_nbuckets=1 << 10, max_pools=64,
        nat_sessions_nbuckets=nbuckets_for(ds.n_flows // n),
        nat_ports_per_subscriber=int(cfg["nat_ports_per_subscriber"]),
        nat_sub_nbuckets=nbuckets_for(int(cfg["nat_subscribers"]) // n),
        qos_nbuckets=nbuckets_for(len(ds.qos_ips)), spoof_nbuckets=nbuckets_for(len(ds.bind_ips)),
        public_ips=[int(x) for x in ds.nat_public_ips], public_ips_per_shard=k,
        garden_enabled=bool(cfg["garden_enabled"]), device=device)
    cl.set_server_config_all(ds.server_mac.to_bytes(6, "big"), ds.server_ip)
    for pool in deploy.pools(ds):
        cl.add_pool_all(*pool)
    cl.add_subscribers_bulk(ds.sub_macs, pool_ids=ds.sub_pools.astype(np.uint32),
                            ips=ds.sub_ips.astype(np.uint32),
                            lease_expiries=np.uint32(ds.now0 + int(cfg["lease_s"])))
    split["dhcp_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    shard = ip_shard(ds.flow_src, n)
    for s in range(n):
        m = shard == s
        src = ds.flow_src[m].astype(np.uint32)
        cl.nat[s].bulk_allocate_nat(np.unique(src), ds.now0)
        _, _, ok = cl.nat[s].bulk_flows(src, ds.flow_dst[m].astype(np.uint32),
                                        ds.flow_sport[m].astype(np.uint32),
                                        ds.flow_dport[m].astype(np.uint32), np.uint32(17), 100,
                                        ds.now0)
        if not bool(ok.all()):
            raise RuntimeError(f"shard {s}: {int((~ok).sum())} flows got no NAT session")
    split["nat_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    pol, gen = cfg["qos_policed"], cfg["qos_generous"]
    q_sh, b_sh = ip_shard(ds.qos_ips, n), ip_shard(ds.bind_ips, n)
    net, plen = cfg["antispoof_loose_range"]
    for s in range(n):
        q = q_sh == s
        cl.qos[s].bulk_set_subscribers(ds.qos_ips[q & ds.qos_policed].astype(np.uint32),
                                       down_bps=pol["rate_bps"], up_bps=pol["rate_bps"],
                                       down_burst=pol["burst"], up_burst=pol["burst"])
        cl.qos[s].bulk_set_subscribers(ds.qos_ips[q & ~ds.qos_policed].astype(np.uint32),
                                       down_bps=gen["down_bps"], up_bps=gen["up_bps"],
                                       down_burst=gen["down_burst"], up_burst=gen["up_burst"])
        cl.spoof[s].set_config(MODE_LOOSE, False)
        cl.spoof[s].add_allowed_range(ip(net), int(plen))
        cl.spoof[s].bindings.bulk_insert(*deploy.binding_rows(ds, b_sh == s))
    split["qos_antispoof_s"] = time.perf_counter() - t0
    return cl


def read_tables(cl) -> check.Tables:
    """Every shard's NAT sessions and upstream QoS rows, one after another."""
    import torch

    for e in cl.engines:
        e.quiesce()
    for dev in dict.fromkeys(cl.shard_devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    nat = cl.nat
    return check.Tables(
        np.concatenate([m.sessions.keys for m in nat]),
        np.concatenate([m.sessions.used != 0 for m in nat]),
        np.concatenate([e.fetch_session_vals() for e in cl.engines]),
        np.concatenate([e.tables.qos_up.rows.cpu().numpy().view(np.uint32)
                        for e in cl.engines]))


def run(ctx: Context) -> Run:
    import torch

    from bng_tpu_torch import kernels

    cfg, split = ctx.cfg, ctx.split
    cuda = ctx.device != "cpu"
    B = int(cfg["batch"])
    t0 = time.perf_counter()
    ds = dataset.build(cfg, ctx.seed)
    traffic = generator.closed_loop(ctx.mix, ds, B, ctx.seed)
    split["data_s"] = time.perf_counter() - t0
    cl = build_cluster(ds, cfg, ctx.device, split)
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.init()  # the allocator's per-card stats need CUDA up
        for d in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(d)
        kernels.entry("probe")
        kernels.entry("seg_prefix")
    split["kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cl.sync_tables()
    for d in range(torch.cuda.device_count() if cuda else 0):
        torch.cuda.synchronize(d)
    split["upload_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fs = pow2(int(cfg["pkt_slot"]))
    # the output rings take a whole batch: depth is every ring's, per shard too
    ring = cl.make_ring(nframes=pow2(4 * B), frame_size=fs, depth=pow2(2 * B))
    split["ring_s"] = time.perf_counter() - t0

    t_built = time.perf_counter()
    base = float(ds.now0 + 60)

    calls: list[float] = []  # seconds of each process_ring_pipelined call

    def process(r, now):
        t = time.perf_counter()
        got = cl.process_ring_pipelined(r, int(now) & M32, int(now * 1e6) & M32, pkt_slot=fs)
        calls.append(time.perf_counter() - t)
        return got

    loop = RingLoop(process, lambda r: cl.flush_pipeline(), ring, traffic, B,
                    lambda: base + (time.perf_counter() - t_built), sample_offset(ctx.seed))
    t0 = time.perf_counter()
    for _ in range(WARM_BATCHES):
        loop.step()
    loop.finish()
    for d in range(torch.cuda.device_count() if cuda else 0):
        torch.cuda.synchronize(d)
    split["warmup_s"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - ctx.t_start
    ctx.note("set-up " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
             + f"; setup_s {setup_s:.3f}")

    first = len(loop.batches)
    calls.clear()
    t_open = time.perf_counter()
    t_close = t_open + ctx.seconds
    retired = 0
    while time.perf_counter() < t_close:
        retired += loop.step()
    t_end = time.perf_counter()
    in_window = loop.batches[first:]
    sent = sum(b["n"] for b in in_window) + sum(b["n"] for b in loop.pending)
    layer = {"batches": in_window, "call_s": list(calls), "tracer": None}
    prof = None
    if ctx.trace:
        prof = profile_slice(ctx, loop, cl, ring, layer)
    loop.finish()
    for d in range(torch.cuda.device_count() if cuda else 0):
        torch.cuda.synchronize(d)
    peak_mem = max(torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count())) \
        if cuda else 0
    checks = check.ring_checks(Reference(ds), traffic, loop.batches, read_tables(cl))
    missteers = int(cl.telemetry.missteers.sum())
    checks["missteered"] = (missteers, 0)
    e2e = {"throughput": retired / (t_end - t_open), "setup_s": setup_s}
    return Run(e2e=e2e, attempted=sent, failed=checks["unanswered"][0], checks=checks,
               memory_peak_bytes=peak_mem, layer=layer, busy_s=prof.busy_s if prof else None,
               window_s=prof.window_s if prof else None,
               breakdown=prof.breakdown() if prof else None)
