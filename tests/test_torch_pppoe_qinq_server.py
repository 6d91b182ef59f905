"""The port's PPPoE server publishes each session's access line.

Two clients (the reference's `SimClient`) negotiate CHAP sessions over
802.1ad lines: every frame a client sends gets its line's S- and C-tags
on the way to the server, and every reply must come back on that line.
The server records the PADR's tags on the session, and `session_up` (its
on_open hook) binds the published row to them: the device's decap then
takes each session's data from its own line only, and its encap writes
the line's tags. Tolerance: exact (table words, bytes, counts).
"""

import struct

import numpy as np
import pytest
import torch

from bng_tpu_torch import frames as F
from bng_tpu_torch.control.pppoe import auth as t_auth, server as t_server
from bng_tpu_torch.control.pppoe import codec
from bng_tpu_torch.ops import pppoe as tp
from bng_tpu_torch.ops.parse import eth_vlan
from bng_tpu_torch.runtime.tables import PPPoEFastPathTables
from bng_tpu_torch.utils.net import ip_to_u32

from test_pppoe import SimClient

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
AC_MAC = bytes.fromhex("02aabbccdd01")
LINES = {bytes.fromhex("02cc00000001"): (101, 5), bytes.fromhex("02cc00000002"): (102, 5)}
REMOTE = ip_to_u32("93.184.216.34")
L = 256


class Line:
    """A subscriber's access line in front of the server: the client's
    frames get the line's tags, the server's replies must carry them."""

    def __init__(self, srv, s_tag: int, c_tag: int):
        self.srv, self.tags = srv, struct.pack(">HHHH", 0x88A8, s_tag, 0x8100, c_tag)
        self.config = srv.config

    def handle_frame(self, frame, now):
        replies = self.srv.handle_frame(frame[:12] + self.tags + frame[12:], now)
        assert all(r[12:20] == self.tags for r in replies)
        return [r[:12] + r[20:] for r in replies]


def serve():
    tables = PPPoEFastPathTables(nbuckets=64, stash=8, update_slots=16, server_mac=AC_MAC)
    cfg = t_server.PPPoEServerConfig(auth_proto=codec.PROTO_CHAP, our_ip=0x0A000001,
                                     dns_primary=0x01010101, server_mac=AC_MAC,
                                     cookie_secret=b"k" * 16)
    ips = {}
    srv = t_server.PPPoEServer(
        cfg, t_auth.LocalVerifier({"alice": b"secret123"}),
        lambda user, mac: ips.setdefault(mac, ip_to_u32("100.64.0.1") + len(ips)),
        on_open=tables.session_up, on_close=tables.session_down,
        magic_source=lambda: 0xDEADBEEF, challenge_source=lambda: b"c" * 16)
    clients = {}
    for mac, (s, c) in LINES.items():
        cli = SimClient(Line(srv, s, c), mac=mac)
        cli.connect(now=1000.0)
        assert cli.session_id and cli.ipcp_done
        clients[mac] = cli
    return srv, tables, clients


def _batch(frames):
    pkt = np.zeros((len(frames), L), dtype=np.uint8)
    for i, f in enumerate(frames):
        pkt[i, :len(f)] = np.frombuffer(f, dtype=np.uint8)
    return torch.from_numpy(pkt), torch.tensor([len(f) for f in frames], dtype=torch.int64)


def test_open_sessions_are_bound_to_their_lines():
    srv, tables, clients = serve()
    for mac, (s, c) in LINES.items():
        sess = srv.sessions.get(clients[mac].session_id)
        assert sess.vlans == [s, c]
        for t in (tables.by_sid, tables.by_ip):
            row = t.vals[(t.used != 0) & (t.vals[:, tp.PS_SESSION_ID] == sess.session_id)][0]
            assert row[[tp.PS_FLAGS, tp.PS_S_TAG, tp.PS_C_TAG]].tolist() == [tp.PSF_LINE, s, c]


def test_device_takes_each_session_from_its_own_line():
    srv, tables, clients = serve()
    (ma, ca), (mb, cb) = clients.items()
    frames = []
    for cli, vlans in ((ca, LINES[ma]), (ca, LINES[mb]), (cb, LINES[mb]), (cb, None)):
        inner = F.udp_packet(cli.mac, AC_MAC, cli.ip, REMOTE, 40000, 443, b"q" * 40)[14:]
        frames.append(F.pppoe_session_frame(AC_MAC, cli.mac, cli.session_id, F.PROTO_IPV4,
                                            inner, vlans=list(vlans) if vlans else None))
    pkt, length = _batch(frames)
    vo, et = eth_vlan(pkt)
    dec = tp.pppoe_decap(pkt, length, vo, et, tables.by_sid.device_state(CPU), tables.geom)
    assert dec.done.tolist() == [True, False, True, False]
    assert dec.line_stats.tolist() == [2, 0, 2] and int(dec.stats[tp.PST_MISS]) == 2
    for i in (0, 2):  # tags and PPPoE gone: the inner IPv4 right after the MACs
        out = bytes(dec.out_pkt[i, :int(dec.out_len[i])].numpy())
        assert out == frames[i][:12] + b"\x08\x00" + frames[i][30:]

    down = [F.udp_packet(b"\x04" * 6, b"\x06" * 6, REMOTE, cli.ip, 443, 40000, b"r" * 60)
            for cli in (ca, cb)]
    pkt, length = _batch(down)
    vo, et = eth_vlan(pkt)
    enc = tp.pppoe_encap(pkt, length, vo, et, torch.tensor([ca.ip, cb.ip]),
                         tables.by_ip.device_state(CPU), tables.geom,
                         torch.from_numpy(tables.server_mac.view(np.int32)))
    assert enc.line_stats.tolist() == [0, 2, 0]
    for i, (cli, mac) in enumerate(((ca, ma), (cb, mb))):
        out = bytes(enc.out_pkt[i, :int(enc.out_len[i])].numpy())
        want = F.pppoe_session_frame(mac, AC_MAC, cli.session_id, F.PROTO_IPV4, down[i][14:],
                                     vlans=list(LINES[mac]))
        assert out == want
