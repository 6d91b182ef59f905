"""The port's express OFFER path against the JAX package's.

- `parse_express` over a frame corpus (untagged, 802.1Q, QinQ, option 82
  at every scanned position, relayed, the broadcast flag, wrong message
  types, truncated and non-DHCP frames) gives the reference's descriptors.
- `express_verdicts` on the CPU gives the JAX `express_verdicts` block and
  stats (under its `xla` probe and its Pallas probe in interpret mode) for
  VLAN, circuit-ID and MAC hits, an expired lease, an invalid pool and a
  miss; the engine's express program (`compile_express_aot` /
  `run_express_aot`) gives the same as a direct call.
- The express lane's reply bytes equal the port's own DHCP-only program
  (`process_dhcp`) TX bytes on the same frames.

Tolerance: bit-exact (the same words, counts and bytes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bng_tpu.ops import express as j_ex
from bng_tpu.ops import table as j_table
from bng_tpu.runtime.tables import FastPathTables as JFastPath
from bng_tpu_torch import frames as F
from bng_tpu_torch.control import dhcp_codec as codec
from bng_tpu_torch.control.nat import NATManager
from bng_tpu_torch.ops import express as t_ex
from bng_tpu_torch.runtime.engine import Engine
from bng_tpu_torch.runtime.scheduler import SchedulerConfig, TieredScheduler
from bng_tpu_torch.runtime.tables import FastPathTables as TFastPath
from bng_tpu_torch.utils.net import ip_to_u32

pytestmark = pytest.mark.torch_port

SERVER_MAC = bytes.fromhex("02aabbccdd01")
SERVER_IP = ip_to_u32("10.0.0.1")
NOW = 1_700_000_000
CID = b"port-7/0/1"


def mac(i: int) -> bytes:
    return (0x02B0 << 32 | i).to_bytes(6, "big")


def dhcp_frame(m, msg_type, vlans=None, giaddr=0, ciaddr=0, broadcast=False, circuit_id=b"",
               src_ip=0, raw_options=None, pad=320):
    p = codec.build_request(m, msg_type, giaddr=giaddr, ciaddr=ciaddr, broadcast=broadcast,
                            circuit_id=circuit_id)
    if not circuit_id:
        p.options.append((codec.OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 15, 51, 54])))
    payload = p.encode()
    if raw_options is not None:
        payload = payload[:240] + raw_options
    return F.udp_packet(m, b"\xff" * 6, src_ip, 0xFFFFFFFF, 68, 67, payload.ljust(pad, b"\x00"),
                        vlans=vlans)


def opt82_at(p: int, msg_type=codec.DISCOVER) -> bytes:
    """Options with option 53 first and option 82 (circuit-ID CID) at offset p."""
    head = bytes([53, 1, msg_type])
    if p > 3:
        head += bytes([12, p - 5]) + b"h" * (p - 5)  # a hostname option as filler
    sub = bytes([1, len(CID)]) + CID
    return head + bytes([82, len(sub)]) + sub + bytes([255])


def corpus() -> list[bytes]:
    frames = [
        dhcp_frame(mac(0), codec.DISCOVER),
        dhcp_frame(mac(1), codec.REQUEST, broadcast=True),
        dhcp_frame(mac(2), codec.DISCOVER, vlans=[100]),
        dhcp_frame(mac(3), codec.DISCOVER, vlans=[200, 30]),
        dhcp_frame(mac(4), codec.DISCOVER, circuit_id=CID),
        dhcp_frame(mac(5), codec.REQUEST, giaddr=ip_to_u32("10.9.9.9")),
        dhcp_frame(mac(6), codec.REQUEST, ciaddr=ip_to_u32("10.0.0.50"), src_ip=ip_to_u32("10.0.0.50")),
        dhcp_frame(mac(7), codec.RELEASE),  # wrong type
        dhcp_frame(mac(7), codec.INFORM),  # wrong type
        dhcp_frame(mac(8), codec.DISCOVER)[:250],  # truncated BOOTP
        dhcp_frame(mac(8), codec.DISCOVER)[:30],  # truncated L3
        F.udp_packet(mac(9), b"\xff" * 6, 0, 0xFFFFFFFF, 68, 53, b"x" * 300),  # not port 67
        F.eth_header(b"\xff" * 6, mac(9), 0x88A8, [5]) + dhcp_frame(mac(9), 1)[12:],  # 88a8 outer only
        dhcp_frame(mac(10), codec.DISCOVER, pad=290),  # too short for the option-82 window
    ]
    frames += [dhcp_frame(mac(20 + p), codec.DISCOVER, raw_options=opt82_at(p)) for p in
               [3] + list(range(12, 21))]  # position A, 12..19, and 20 (not scanned)
    return frames


def test_parse_express_matches_reference():
    got = [t_ex.parse_express(f) for f in corpus()]
    want = [j_ex.parse_express(f) for f in corpus()]
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), k
        if g is not None:
            assert np.array_equal(g.words, w.words), k
            assert g[1:] == w[1:], k
    flags = [None if g is None else int(g.words[t_ex.XD_FLAGS]) for g in got]
    assert flags[7:11] == [None] * 4 and flags[11] is None
    assert sum(f is not None and f & t_ex.XF_CID != 0 for f in flags) == 10  # 4, A and 12..19
    assert flags[-1] is not None and not flags[-1] & t_ex.XF_CID


def build_fp(cls):
    """Three pools (the third then invalidated) and subscribers for every
    tier, one expired and one in a pool id past the table."""
    fp = cls(sub_nbuckets=256, vlan_nbuckets=64, cid_nbuckets=64, max_pools=8)
    fp.set_server_config(SERVER_MAC, SERVER_IP)
    fp.add_pool(1, ip_to_u32("10.0.0.0"), 24, SERVER_IP, ip_to_u32("8.8.8.8"),
                ip_to_u32("8.8.4.4"), 3600)
    fp.add_pool(2, ip_to_u32("10.1.0.0"), 16, ip_to_u32("10.1.0.1"), ip_to_u32("1.1.1.1"), 0, 7200)
    fp.add_pool(3, ip_to_u32("10.2.0.0"), 20, ip_to_u32("10.2.0.1"), 0, 0, 600)
    fp.remove_pool(3)
    fp.add_subscriber(mac(0), 1, ip_to_u32("10.0.0.50"), NOW + 600)
    fp.add_subscriber(mac(1), 2, ip_to_u32("10.1.0.60"), NOW + 600)
    fp.add_subscriber(mac(2), 3, ip_to_u32("10.2.0.70"), NOW + 600)  # invalid pool
    fp.add_subscriber(mac(5), 1, ip_to_u32("10.0.0.55"), NOW + 600)
    fp.add_subscriber(mac(6), 1, ip_to_u32("10.0.0.56"), NOW + 600)
    fp.add_subscriber(mac(11), 9, ip_to_u32("10.0.0.57"), NOW + 600)  # pool id past max_pools
    fp.add_subscriber(mac(12), 1, ip_to_u32("10.0.0.44"), NOW - 5)  # expired
    fp.add_vlan_subscriber(100, 0, 1, ip_to_u32("10.0.0.80"), NOW + 600)
    fp.add_vlan_subscriber(200, 30, 2, ip_to_u32("10.1.0.90"), NOW + 600)
    fp.add_circuit_id_subscriber(CID, 1, ip_to_u32("10.0.0.99"), NOW + 600)
    return fp


def verdict_frames() -> list[bytes]:
    return [
        dhcp_frame(mac(0), codec.DISCOVER),  # MAC hit
        dhcp_frame(mac(1), codec.REQUEST),  # MAC hit, pool 2
        dhcp_frame(mac(2), codec.DISCOVER),  # invalid pool (removed)
        dhcp_frame(mac(3), codec.DISCOVER, vlans=[100]),  # VLAN hit
        dhcp_frame(mac(4), codec.DISCOVER, vlans=[200, 30]),  # QinQ hit
        dhcp_frame(mac(5), codec.DISCOVER, circuit_id=CID),  # circuit-ID before MAC
        dhcp_frame(mac(6), codec.REQUEST, giaddr=ip_to_u32("10.9.9.9")),  # relayed
        dhcp_frame(mac(12), codec.DISCOVER),  # expired
        dhcp_frame(mac(11), codec.DISCOVER),  # pool id past the table
        dhcp_frame(mac(13), codec.DISCOVER),  # miss
        dhcp_frame(mac(0), codec.REQUEST, ciaddr=ip_to_u32("10.0.0.50"), src_ip=ip_to_u32("10.0.0.50")),
    ]


def descriptors(frames, B):
    desc = np.zeros((B, t_ex.XD_WORDS), dtype=np.uint32)
    for i, f in enumerate(frames):
        d = t_ex.parse_express(f)
        if d is not None:
            desc[i] = d.words
    return desc


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_express_verdicts_match_reference(impl):
    frames = verdict_frames()
    desc = descriptors(frames, 16)
    jfp, tfp = build_fp(JFastPath), build_fp(TFastPath)
    jt = jfp.device_tables()
    with j_table.forced_impl(impl):
        jr = j_ex.express_verdicts(jt, jnp.asarray(desc.copy()), jfp.geom, jnp.uint32(NOW))
    tt = tfp.device_tables("cpu")
    tr = t_ex.express_verdicts(tt, torch.from_numpy(desc.view(np.int32).copy()), tfp.geom,
                               torch.tensor(NOW, dtype=torch.int64))
    block = tr.block.numpy().view(np.uint32)
    assert np.array_equal(block, np.asarray(jr.block))
    assert np.array_equal(tr.stats.numpy(), np.asarray(jr.stats).astype(np.int64))
    assert block[:11, t_ex.VB_VERDICT].tolist() == [1, 1, 0, 1, 1, 1, 1, 0, 0, 0, 1]
    assert block[5, t_ex.VB_YIADDR] == ip_to_u32("10.0.0.99")  # the circuit-ID tier won

    # the engine's express program (a plain call on the CPU) gives the same
    eng = Engine(tfp, NATManager(public_ips=[ip_to_u32("203.0.113.1")], sessions_nbuckets=64,
                                 sub_nat_nbuckets=64), batch_size=16, pkt_slot=512, device="cpu")
    prog = eng.compile_express_aot(16)
    assert eng.compile_express_aot(16) is prog and eng.express_captures == 1
    assert eng.express_aot(16) is prog and eng.express_aot(8) is None
    res = eng.run_express_aot(prog, desc, NOW)
    assert np.array_equal(res.block.numpy().view(np.uint32), block)
    assert torch.equal(res.dhcp_stats, tr.stats)


def test_express_replies_equal_the_dhcp_only_program():
    frames = verdict_frames()
    nat = NATManager(public_ips=[ip_to_u32("203.0.113.1")], sessions_nbuckets=64, sub_nat_nbuckets=64)
    full = Engine(build_fp(TFastPath), nat, batch_size=16, pkt_slot=512, device="cpu",
                  clock=lambda: float(NOW))
    want = full.process_dhcp(frames, now=NOW, batch=16)
    nat2 = NATManager(public_ips=[ip_to_u32("203.0.113.1")], sessions_nbuckets=64, sub_nat_nbuckets=64)
    eng = Engine(build_fp(TFastPath), nat2, batch_size=16, pkt_slot=512, device="cpu",
                 clock=lambda: float(NOW))
    sched = TieredScheduler(eng, SchedulerConfig(express_batch=16, bulk_batch=16))
    got = sched.process(frames, now=NOW)
    assert got["tx"] == want["tx"]
    assert [i for i, _ in got["slow"]] == [i for i, _ in want["slow"]] == [2, 7, 8, 9]
    assert sched.stats_snapshot()["express"]["aot_dispatches"] == 1
    assert np.array_equal(eng.stats.dhcp[[0, 1, 3, 4, 5, 7, 8, 9]],
                          full.stats.dhcp[[0, 1, 3, 4, 5, 7, 8, 9]])  # not ST_MISS/ABSENT
