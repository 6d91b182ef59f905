"""Install a dataset into the program through its own host API.

A data-driven copy of `chip_smoke.build_deployment`: the same tables, the
same bulk calls, sized by the configuration file. Returns the host tables
the program serves from; the system's module builds its engine over them.
"""

from __future__ import annotations

import time

import numpy as np

from gpubench.dataset import Dataset, flow_mac, ip

MODE_STRICT, MODE_LOOSE = 1, 2  # bng_tpu_torch.ops.antispoof's modes
AB_IPV4, AB_VALIDS, AB_MODE, VALID_V4 = 0, 5, 6, 1


def nbuckets_for(n: int) -> int:
    """Power-of-two bucket count holding n keys at about 50% of 4 ways."""
    return 1 << max(10, (n * 2 // 4).bit_length())


def pools(ds: Dataset) -> list[tuple]:
    """add_pool's arguments for each /prefix pool the subscribers fill."""
    cfg = ds.cfg
    plen = int(cfg["pool_prefix_len"])
    dns1, dns2 = (ip(x) for x in cfg["pool_dns"])
    base = int(ds.sub_ips[0]) & ~((1 << (32 - plen)) - 1)
    return [(pid, (base + ((pid - 1) << (32 - plen))) & 0xFFFFFFFF, plen,
             ip(cfg["pool_gateway"]), dns1, dns2, int(cfg["lease_s"]))
            for pid in range(1, int(ds.sub_pools.max()) + 1)]


def binding_rows(ds: Dataset, sel=slice(None)) -> tuple[np.ndarray, np.ndarray]:
    """(keys, rows) of the strict antispoof bindings `sel` picks: each
    bound address's flow MAC to that address."""
    ips = ds.bind_ips[sel]
    macs = flow_mac(ips)
    keys = np.stack([(macs >> np.uint64(32)), macs & np.uint64(0xFFFFFFFF)],
                    axis=1).astype(np.uint32)
    rows = np.zeros((len(macs), 8), dtype=np.uint32)
    rows[:, AB_IPV4], rows[:, AB_VALIDS], rows[:, AB_MODE] = ips, VALID_V4, MODE_STRICT
    return keys, rows


def build_tables(ds: Dataset, split: dict) -> dict:
    """{"fastpath", "nat", "qos", "antispoof"}: the port's host tables.
    `split` receives the seconds of each part of the build."""
    from bng_tpu_torch.control.nat import NATManager
    from bng_tpu_torch.runtime.engine import AntispoofTables, QoSTables
    from bng_tpu_torch.runtime.tables import FastPathTables

    cfg = ds.cfg
    t0 = time.perf_counter()
    stash = int(cfg["table_stash"])
    sub_nb = nbuckets_for(ds.n_subs)
    fp = FastPathTables(sub_nbuckets=sub_nb, vlan_nbuckets=1 << 10, cid_nbuckets=1 << 10,
                        max_pools=max(64, int(ds.sub_pools.max()) + 1), stash=stash)
    fp.set_server_config(ds.server_mac.to_bytes(6, "big"), ds.server_ip)
    for pool in pools(ds):
        fp.add_pool(*pool)
    fp.add_subscribers_bulk(ds.sub_macs, pool_ids=ds.sub_pools.astype(np.uint32),
                            ips=ds.sub_ips.astype(np.uint32),
                            lease_expiries=np.uint32(ds.now0 + int(cfg["lease_s"])))
    split["dhcp_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lo, hi = cfg["nat_port_range"]
    nat = NATManager(public_ips=[int(x) for x in ds.nat_public_ips],
                     ports_per_subscriber=int(cfg["nat_ports_per_subscriber"]),
                     port_range=(int(lo), int(hi)),
                     sessions_nbuckets=nbuckets_for(ds.n_flows), sub_nat_nbuckets=sub_nb,
                     stash=stash)
    src = ds.flow_src.astype(np.uint32)
    made = nat.bulk_allocate_nat(np.unique(src), ds.now0)
    _, _, ok = nat.bulk_flows(src, ds.flow_dst.astype(np.uint32),
                              ds.flow_sport.astype(np.uint32), ds.flow_dport.astype(np.uint32),
                              np.uint32(17), 100, ds.now0)
    if made != int(cfg["nat_subscribers"]) or not bool(ok.all()):
        raise RuntimeError(f"NAT build: {made} blocks, {int(ok.sum())} of {len(ok)} flows")
    split["nat_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    qos = QoSTables(nbuckets=nbuckets_for(len(ds.qos_ips)))
    pol, gen = cfg["qos_policed"], cfg["qos_generous"]
    qos.bulk_set_subscribers(ds.qos_ips[ds.qos_policed].astype(np.uint32),
                             down_bps=pol["rate_bps"], up_bps=pol["rate_bps"],
                             down_burst=pol["burst"], up_burst=pol["burst"])
    qos.bulk_set_subscribers(ds.qos_ips[~ds.qos_policed].astype(np.uint32),
                             down_bps=gen["down_bps"], up_bps=gen["up_bps"],
                             down_burst=gen["down_burst"], up_burst=gen["up_burst"])

    spoof = AntispoofTables(nbuckets=nbuckets_for(2 * len(ds.bind_ips)), stash=64)
    spoof.set_config(MODE_LOOSE, False)
    net, plen = cfg["antispoof_loose_range"]
    spoof.add_allowed_range(ip(net), int(plen))
    spoof.bindings.bulk_insert(*binding_rows(ds))
    split["qos_antispoof_s"] = time.perf_counter() - t0
    return {"fastpath": fp, "nat": nat, "qos": qos, "antispoof": spoof}
