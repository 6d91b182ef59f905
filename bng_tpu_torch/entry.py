"""The port's entry points, the counterparts of `__graft_entry__`, built
through the port's own host API. Everything lands on the card unless
`device="cpu"` is passed.

- `entry(device=None)` returns `(fn, args)`: the fused step with the PPPoE
  stage compiled in and an example batch holding a DISCOVER from a cached
  subscriber, an established NAT44 flow and a PPPoE session DATA frame
  that decaps before NAT in the same step. `fn(*args)` runs one step and
  returns its `PipelineResult` (the tables in `args` are updated in
  place).
- `dryrun_multichip(n, ...)` drives a `ShardedCluster` of n shards and
  makes every assert of the reference's dryrun; it prints the
  `MULTICHIP-TELEMETRY` line last and returns its payload.
"""

from __future__ import annotations

from types import SimpleNamespace

import json

import numpy as np
import torch

from bng_tpu_torch import frames as F
from bng_tpu_torch import resolve_device
from bng_tpu_torch.control.nat import NATManager
from bng_tpu_torch.ops.pipeline import PipelineGeom, PipelineTables, pipeline_step
from bng_tpu_torch.ops.pppoe import PPP_IPV4
from bng_tpu_torch.ops.table import to_device, words_to_device
from bng_tpu_torch.runtime.engine import AntispoofTables, QoSTables
from bng_tpu_torch.runtime.tables import FastPathTables, PPPoEFastPathTables
from bng_tpu_torch.utils.net import ip_to_u32

B, L = 32, 512
NOW = 1_753_000_000
SERVER_MAC = bytes.fromhex("02aabbccdd01")
SUB_MAC = bytes.fromhex("02deadbeef42")
PPPOE_MAC = bytes.fromhex("02c0ffee0007")
PPPOE_SESSION = SimpleNamespace(session_id=0x42, client_mac=PPPOE_MAC,
                                assigned_ip=ip_to_u32("10.0.0.77"))


def example_frames() -> list[bytes]:
    """A cached DISCOVER, a NAT-able flow, a PPPoE session DATA frame."""
    disc = F.build_request(SUB_MAC, F.DISCOVER)
    disc.options.append((F.OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 51, 54])))
    f0 = F.udp_packet(SUB_MAC, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67,
                      disc.encode().ljust(320, b"\x00"))
    f1 = F.udp_packet(SUB_MAC, SERVER_MAC, ip_to_u32("10.0.0.123"),
                      ip_to_u32("93.184.216.34"), 40000, 443, b"payload")
    inner = F.udp_packet(PPPOE_MAC, SERVER_MAC, PPPOE_SESSION.assigned_ip,
                         ip_to_u32("8.8.8.8"), 41000, 53, b"q" * 24)[14:]
    f2 = F.pppoe_session_frame(SERVER_MAC, PPPOE_MAC, PPPOE_SESSION.session_id, PPP_IPV4, inner)
    return [f0, f1, f2]


def _build(device):
    fastpath = FastPathTables(sub_nbuckets=256, vlan_nbuckets=64, cid_nbuckets=64, max_pools=16)
    fastpath.set_server_config(SERVER_MAC, ip_to_u32("10.0.0.1"))
    fastpath.add_pool(1, ip_to_u32("10.0.0.0"), 24, ip_to_u32("10.0.0.1"),
                      ip_to_u32("1.1.1.1"), ip_to_u32("8.8.8.8"), 3600)
    fastpath.add_subscriber(SUB_MAC, pool_id=1, ip=ip_to_u32("10.0.0.123"),
                            lease_expiry=NOW + 900)
    nat = NATManager(public_ips=[ip_to_u32("203.0.113.1")], sessions_nbuckets=256,
                     sub_nat_nbuckets=64)
    nat.allocate_nat(ip_to_u32("10.0.0.123"), NOW)
    qos = QoSTables(nbuckets=256)
    qos.set_subscriber(ip_to_u32("10.0.0.123"), down_bps=100_000_000, up_bps=20_000_000)
    spoof = AntispoofTables(nbuckets=256)
    pppoe = PPPoEFastPathTables(nbuckets=64, server_mac=SERVER_MAC)
    pppoe.session_up(PPPOE_SESSION)
    nat.allocate_nat(PPPOE_SESSION.assigned_ip, NOW)

    geom = PipelineGeom(dhcp=fastpath.geom, nat=nat.geom, qos=qos.geom, spoof=spoof.geom,
                        pppoe=pppoe.geom)
    tables = PipelineTables(
        dhcp=fastpath.device_tables(device),
        nat=nat.device_tables(device),
        qos_up=qos.up.device_state(device),
        qos_down=qos.down.device_state(device),
        spoof=spoof.bindings.device_state(device),
        spoof_ranges=words_to_device(spoof.ranges, device),
        spoof_config=words_to_device(spoof.config, device),
        pppoe_by_sid=pppoe.by_sid.device_state(device),
        pppoe_by_ip=pppoe.by_ip.device_state(device),
        pppoe_server_mac=words_to_device(pppoe.server_mac, device),
    )
    pkt = np.zeros((B, L), dtype=np.uint8)
    length = np.zeros((B,), dtype=np.int64)
    for i, f in enumerate(example_frames()):
        pkt[i, : len(f)] = np.frombuffer(f, dtype=np.uint8)
        length[i] = len(f)

    def fn(tables, pkt, length, from_access, now_s, now_us):
        return pipeline_step(tables, pkt, length, from_access, geom, now_s, now_us)

    args = (tables, to_device(pkt, device), to_device(length, device),
            torch.ones((B,), dtype=torch.bool, device=device),
            torch.full((), NOW, dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.int64, device=device))
    return fn, args


def entry(device=None):
    """(fn, example_args): the fused step with PPPoE and its example batch."""
    return _build(resolve_device(device))


def _discover(mac: bytes) -> bytes:
    p = F.build_request(mac, F.DISCOVER)
    p.options.append((F.OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 51, 54])))
    return F.udp_packet(mac, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67, p.encode().ljust(320, b"\x00"))


def dryrun_multichip(n: int, device=None, nbuckets: int = 256, frames_per_shard: int = 16) -> dict:
    """Drive the sharded step over n shards and check the reference's
    `__graft_entry__.dryrun_multichip` asserts: DHCP replies from every
    shard with summed hits; NAT forwards 2 and QoS drops 1 on the owner
    shard; a subscriber added after the first step answered by every
    shard through the drain; the DHCP-only lane; the ring-steered owner
    shard's [SNAT, SNAT, drop, DNAT]; PASS on a wrong shard; the
    pipelined two-window loop. `nbuckets` sizes every per-shard table,
    `frames_per_shard` the per-shard batch (floors keep the lane layout
    valid). Returns the telemetry snapshot it prints."""
    from bng_tpu_torch.ops.dhcp import ST_HIT
    from bng_tpu_torch.parallel.sharded import ShardedCluster
    from bng_tpu_torch.runtime.ring import FLAG_FROM_ACCESS

    now = 1_753_000_000
    nb = max(64, int(nbuckets))
    cl = ShardedCluster(n, batch_per_shard=max(8, int(frames_per_shard)), sub_nbuckets=nb,
                        vlan_nbuckets=max(64, nb // 4), cid_nbuckets=max(64, nb // 4),
                        nat_sessions_nbuckets=nb, qos_nbuckets=nb, spoof_nbuckets=nb,
                        device=resolve_device(device))
    cl.set_server_config_all(SERVER_MAC, ip_to_u32("10.0.0.1"))
    cl.add_pool_all(1, ip_to_u32("10.0.0.0"), 24, ip_to_u32("10.0.0.1"), lease_time=3600)
    macs = [bytes.fromhex(f"02c0ffee00{i:02x}") for i in range(2 * n)]
    for i, mac in enumerate(macs):
        cl.add_subscriber(mac, pool_id=1, ip=ip_to_u32(f"10.0.0.{50 + i}"), lease_expiry=now + 600)

    # NAT and QoS state on the subscriber's affinity shard, where the ring
    # steers its frames
    nat_sub_ip = ip_to_u32("10.0.0.50")
    owner, alloc = cl.allocate_nat(nat_sub_ip, now)
    assert alloc is not None
    _, (nat_pub_ip, nat_pub_port) = cl.handle_new_flow(nat_sub_ip, ip_to_u32("1.2.3.4"),
                                                       40000, 443, 17, 600, now)
    cl.set_qos(nat_sub_ip, down_bps=8_000, up_bps=8_000, down_burst=1000, up_burst=1000)
    cl.sync_tables()

    b = cl.b
    Bt = n * b
    pkt = np.zeros((Bt, L), dtype=np.uint8)
    length = np.zeros((Bt,), dtype=np.uint32)

    def put(p, ln, row, f):
        p[row, : len(f)] = np.frombuffer(f, dtype=np.uint8)
        ln[row] = len(f)

    for i, mac in enumerate(macs):
        put(pkt, length, (i % n) * b + (i // n), _discover(mac))
    # owner-shard data lanes: 2 x 500 B pass the bucket, the third drops;
    # all three match the established NAT flow
    data = F.udp_packet(macs[0], SERVER_MAC, nat_sub_ip, ip_to_u32("1.2.3.4"), 40000, 443,
                        b"d" * (500 - 42))
    data_rows = [owner * b + 4 + j for j in range(3)]
    for row in data_rows:
        put(pkt, length, row, data)

    out = cl.step(pkt, length, np.ones((Bt,), dtype=bool), now, 0)
    n_tx = int((out["verdict"] == 2).sum())
    assert n_tx == len(macs), f"sharded DHCP replies: {n_tx}/{len(macs)}"
    assert int(out["dhcp_stats"][ST_HIT]) == len(macs)
    vd = out["verdict"][data_rows]
    assert list(vd) == [3, 3, 1], f"NAT/QoS lanes: {list(vd)}"
    assert int(out["qos_stats"][1]) == 1, out["qos_stats"]  # QST_PKTS_DROPPED

    # a subscriber added after the first step reaches every shard's
    # lookups through the bounded drain
    late = _discover(bytes.fromhex("02c0ffeeff99"))
    cl.add_subscriber(bytes.fromhex("02c0ffeeff99"), pool_id=1, ip=ip_to_u32("10.0.0.199"),
                      lease_expiry=now + 600)
    pkt2 = np.zeros((Bt, L), dtype=np.uint8)
    length2 = np.zeros((Bt,), dtype=np.uint32)
    for shard in range(n):  # every shard asks; the owner answers all
        put(pkt2, length2, shard * b, late)
    out2 = cl.step(pkt2, length2, np.ones((Bt,), dtype=bool), now + 1, 100)
    n_tx2 = int((out2["verdict"] == 2).sum())
    assert n_tx2 == n, f"late-subscriber replies: {n_tx2}/{n}"

    # the sharded DHCP-only lane answers the same DISCOVERs over the same tables
    out3 = cl.dhcp_step(pkt2, length2, now + 2)
    n_tx3 = int(out3["is_reply"].sum())
    assert n_tx3 == n, f"fast-lane replies: {n_tx3}/{n}"

    # ring steering: a subscriber's frames go to its affinity shard, the
    # only shard whose NAT/QoS state for it is consulted
    ring = cl.make_ring(nframes=1024, frame_size=2048, depth=256)
    down = F.udp_packet(SERVER_MAC, macs[0], ip_to_u32("1.2.3.4"), nat_pub_ip, 443,
                        nat_pub_port, b"r" * 32)
    for _ in range(3):  # upstream: by FNV-1a32 of the private source IP
        assert ring.rx_push(data, from_access=True)
    assert ring.rx_push(down, from_access=False)  # downstream: by public-IP owner
    rpkt = np.zeros((Bt, L), dtype=np.uint8)
    rlen = np.zeros((Bt,), dtype=np.uint32)
    rfl = np.zeros((Bt,), dtype=np.uint32)
    got = ring.assemble_sharded(rpkt, rlen, rfl)
    assert got == 4, f"ring staged {got}/4 frames"
    base = owner * b
    assert list(rlen[base: base + 4]) == [len(data)] * 3 + [len(down)], (
        owner, list(rlen.nonzero()[0]))
    assert all(rfl[base + j] & FLAG_FROM_ACCESS for j in range(3))
    assert not (rfl[base + 3] & FLAG_FROM_ACCESS)
    # +100 s on the microsecond clock refills the bucket: 2 x 500 B pass again
    out4 = cl.step(rpkt, rlen, (rfl & FLAG_FROM_ACCESS) != 0, now + 100, 100_000_000)
    v4 = out4["verdict"][base: base + 4]
    assert list(v4) == [3, 3, 1, 3], f"owner-shard ring lanes (SNAT, SNAT, drop, DNAT): {list(v4)}"
    ring.complete(out4["verdict"].astype(np.uint8), np.ascontiguousarray(out4["out_pkt"]),
                  out4["out_len"].astype(np.uint32), Bt)
    rs = ring.stats()
    assert rs["fwd"] == 3 and rs["drop"] == 1, rs

    # the same frame on a wrong shard is neither translated nor shaped there:
    # it punts to the slow path (PASS)
    wrong = (owner + 1) % n
    wpkt = np.zeros((Bt, L), dtype=np.uint8)
    wlen = np.zeros((Bt,), dtype=np.uint32)
    put(wpkt, wlen, wrong * b, data)
    out5 = cl.step(wpkt, wlen, np.ones((Bt,), dtype=bool), now + 101, 101_000_000)
    assert int(out5["verdict"][wrong * b]) == 0, (
        f"wrong-shard lane must PASS, got {int(out5['verdict'][wrong * b])}")

    # the double-buffered loop: dispatch window k+1 before retiring k
    assert ring.rx_push(data, from_access=True)
    assert cl.process_ring_pipelined(ring, now + 102, 102_000_000) == 0
    assert ring.rx_push(data, from_access=True)
    retired = cl.process_ring_pipelined(ring, now + 103, 103_000_000)
    assert retired == 1, f"pipelined retire: {retired}"
    assert cl.flush_pipeline() == 1
    rs2 = ring.stats()
    assert rs2["fwd"] == rs["fwd"] + 2, (rs, rs2)

    print(f"dryrun_multichip({n}): OK — {n_tx} DHCP replies (summed hits "
          f"{int(out['dhcp_stats'][ST_HIT])}), NAT fwd=2 qos_drop=1 cross-shard, update drain "
          f"answered {n_tx2}/{n} shards, dhcp fast lane {n_tx3}/{n}, ring-steered owner shard "
          f"{owner} [SNAT,SNAT,drop,DNAT] ok, wrong-shard punt ok, pipelined 2-window loop ok")
    tsnap = cl.telemetry.snapshot()
    assert tsnap["psum_dhcp_hits"] >= len(macs), tsnap["psum_dhcp_hits"]
    assert tsnap["merged_stages"], "per-shard histograms recorded nothing"
    tsnap["device"] = str(cl.device)
    print("MULTICHIP-TELEMETRY " + json.dumps(tsnap))
    return tsnap
