"""The port's flagship program: `entry(device=None)` returns `(fn, args)`,
the fused step with the PPPoE stage compiled in and an example batch,
the counterpart of `__graft_entry__.entry()` built through the port's
own host API.

The batch holds a DISCOVER from a cached subscriber, an established
NAT44 flow and a PPPoE session DATA frame that decaps before NAT in the
same step. `fn(*args)` runs one step and returns its `PipelineResult`
(the tables in `args` are updated in place). Everything lands on the
card unless `device="cpu"` is passed.
"""

from __future__ import annotations

from types import SimpleNamespace

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
