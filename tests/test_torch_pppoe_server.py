"""The port's PPPoE server against `bng_tpu.control.pppoe`, frame for frame.

Both packages' `PPPoEServer` sit behind one handle: every frame a
simulated client sends (the reference's `SimClient`) goes to both, and
the reply lists must be byte-equal before the client reacts to them. The
same holds for `tick()` and `terminate()`. Randomness is passed in: one
cookie secret, one magic number and one seeded challenge sequence per
package. After each scenario the `on_open`/`on_close` calls, the stats,
the live sessions and each package's device session tables (written by
`session_up`/`session_down` from those hooks) must match.

Scenarios: CHAP and PAP sessions, a bad password, keepalive with and
without echo replies (carrier loss), PADT, admin terminate, the session
limit, the auth rate limit, an unknown session, a redial, half-open
reclaim and a QinQ-tagged line. An OPEN session's data frame then decaps
the same through both packages' device stage.

Tolerance: exact (bytes, dicts, table words).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bng_tpu.control.pppoe import auth as j_auth, server as j_server
from bng_tpu.control.pppoe.session import TerminateCause
from bng_tpu.runtime.tables import PPPoEFastPathTables as JPPPoE
from bng_tpu_torch import frames as F
from bng_tpu_torch.control.pppoe import auth as t_auth, server as t_server
from bng_tpu_torch.control.pppoe import codec
from bng_tpu_torch.ops import pppoe as tp
from bng_tpu_torch.ops.parse import eth_vlan as t_eth_vlan
from bng_tpu_torch.runtime.tables import PPPoEFastPathTables as TPPPoE
from bng_tpu_torch.utils.net import ip_to_u32

from test_pppoe import CLIENT_MAC, SimClient
from test_torch_pppoe import _batch, _both, _decap, j_eth_vlan
from test_torch_stages import assert_tuple_equal

pytestmark = pytest.mark.torch_port

PKGS = (SimpleNamespace(name="jax", auth=j_auth, server=j_server, Tables=JPPPoE),
        SimpleNamespace(name="port", auth=t_auth, server=t_server, Tables=TPPPoE))
AC_MAC = bytes.fromhex("02aabbccdd01")


def _build(p, auth_proto, seed, **kw):
    rng = np.random.default_rng(seed)
    cfg = p.server.PPPoEServerConfig(auth_proto=auth_proto, our_ip=0x0A000001,
                                     dns_primary=0x01010101, echo_interval_s=30.0,
                                     server_mac=AC_MAC, cookie_secret=b"k" * 16, **kw)
    allocs = {}
    log = SimpleNamespace(open=[], close=[], released=[],
                          tables=p.Tables(nbuckets=64, stash=8, update_slots=16, server_mac=AC_MAC))

    def allocate_ip(username, mac):
        allocs[mac] = 0x0A000064 + len(allocs)
        return allocs[mac]

    def on_open(s):
        log.open.append((s.session_id, s.client_mac, s.assigned_ip, s.username, s.phase.value))
        log.tables.session_up(s)

    def on_close(e):
        log.close.append((e.session.session_id, int(e.cause), e.at, e.session_time_s))
        log.tables.session_down(e)

    srv = p.server.PPPoEServer(
        cfg, p.auth.LocalVerifier({"alice": b"secret123"}), allocate_ip,
        release_ip=lambda ip, mac: log.released.append((ip, mac)),
        on_open=on_open, on_close=on_close, magic_source=lambda: 0xDEADBEEF,
        challenge_source=lambda: rng.integers(0, 256, 16, dtype=np.uint8).tobytes())
    return srv, log


class Pair:
    """Both packages' servers behind one handle; each call's frames must match."""

    def __init__(self, auth_proto=codec.PROTO_CHAP, seed=0, **kw):
        built = [_build(p, auth_proto, seed, **kw) for p in PKGS]
        self.srv = [b[0] for b in built]
        self.log = [b[1] for b in built]
        self.config = self.srv[1].config

    def _both(self, verb, *args):
        out = [getattr(s, verb)(*args) for s in self.srv]
        assert out[1] == out[0], verb
        return out[1]

    def handle_frame(self, frame, now):
        return self._both("handle_frame", frame, now)

    def tick(self, now):
        return self._both("tick", now)

    def terminate(self, sid, cause, now):
        return self._both("terminate", sid, cause, now)

    def check(self):
        """Hook calls, stats, live sessions and table words agree."""
        j, t = self.log
        assert (t.open, t.close, t.released) == (j.open, j.close, j.released)
        assert dataclasses.asdict(self.srv[1].stats) == dataclasses.asdict(self.srv[0].stats)
        assert ([(s.session_id, s.client_mac, s.phase.value, s.assigned_ip)
                 for s in self.srv[1].sessions.all()]
                == [(s.session_id, s.client_mac, s.phase.value, s.assigned_ip)
                    for s in self.srv[0].sessions.all()])
        for name in ("by_sid", "by_ip"):
            a, b = getattr(j.tables, name), getattr(t.tables, name)
            for field in ("keys", "vals", "used"):
                assert np.array_equal(getattr(a, field), getattr(b, field)), (name, field)
        return self.srv[1].stats


def _padr_only(pair, mac, now):
    padi = F.pppoe_padi_frame(mac)
    pado = codec.PPPoEPacket.decode(codec.parse_eth(pair.handle_frame(padi, now)[0])[3])
    cookie = codec.find_tag(codec.parse_tags(pado.payload), codec.TAG_AC_COOKIE)
    padr = codec.PPPoEPacket(codec.CODE_PADR, 0, codec.serialize_tags([cookie]))
    return pair.handle_frame(codec.eth_frame(AC_MAC, mac, codec.ETH_PPPOE_DISCOVERY,
                                             padr.encode()), now)


def _chap(pair):
    SimClient(pair).connect()
    assert pair.check().sessions_opened == 1


def _pap(pair):
    cli = SimClient(pair)
    cli.connect()
    cli._pump([cli.pap_request()], 1001.0)
    opts = [codec.CPOption(3, b"\x00" * 4)]
    cli._pump([cli._ppp(codec.PROTO_IPCP,
                        codec.CPPacket(codec.CP_CONF_REQ, 1, options=opts).encode())], 1001.0)
    assert cli.ipcp_done and pair.check().sessions_opened == 1


def _bad_password(pair):
    cli = SimClient(pair)
    cli.password = b"wrong"
    cli.connect()
    assert pair.check().auth_failure == 1


def _carrier_loss(pair):
    SimClient(pair).connect(now=1000.0)
    for i in range(1, 6):  # the client never answers the echoes
        pair.tick(1000.0 + 31.0 * i)
    assert pair.log[1].close[0][1] == TerminateCause.LOST_CARRIER


def _echo_kept(pair):
    cli = SimClient(pair)
    cli.connect(now=1000.0)
    for i in range(1, 6):
        now = 1000.0 + 31.0 * i
        for f in pair.tick(now):
            _, _, etype, payload = codec.parse_eth(f)
            if etype == codec.ETH_PPPOE_SESSION:
                proto, body = codec.parse_ppp(codec.PPPoEPacket.decode(payload).payload)
                if proto == codec.PROTO_LCP and body[0] == codec.CP_ECHO_REQ:
                    cli._pump(cli._lcp(body, now), now)
    assert pair.log[1].close == [] and len(pair.srv[1].sessions) == 1


def _padt(pair):
    cli = SimClient(pair)
    cli.connect()
    padt = codec.PPPoEPacket(codec.CODE_PADT, cli.session_id, b"")
    pair.handle_frame(codec.eth_frame(AC_MAC, CLIENT_MAC, codec.ETH_PPPOE_DISCOVERY,
                                      padt.encode()), 2000.0)
    assert pair.log[1].released == [(0x0A000064, CLIENT_MAC)]


def _admin_terminate(pair):
    cli = SimClient(pair)
    cli.connect()
    assert len(pair.terminate(cli.session_id, TerminateCause.ADMIN_RESET, 1500.0)) == 2


def _session_limit(pair):
    for i in range(3):
        SimClient(pair, mac=bytes([2, 0, 0, 0, 0, 10 + i])).connect()
    assert len(pair.srv[1].sessions) == 2


def _rate_limit(pair):
    for i in range(7):
        cli = SimClient(pair)
        cli.password = b"wrong"
        cli.connect(now=1000.0 + i)
    SimClient(pair).connect(now=1005.0)  # a right password inside the window
    assert len(pair.srv[1].sessions) == 0


def _unknown_session(pair):
    pkt = codec.PPPoEPacket(codec.CODE_SESSION, 999,
                            codec.ppp_frame(codec.PROTO_LCP, b"\x09\x01\x00\x04"))
    out = pair.handle_frame(codec.eth_frame(AC_MAC, CLIENT_MAC, codec.ETH_PPPOE_SESSION,
                                            pkt.encode()), 0.0)
    assert codec.PPPoEPacket.decode(out[0][14:]).code == codec.CODE_PADT


def _redial(pair):
    SimClient(pair).connect()
    SimClient(pair).connect(now=1010.0)
    assert len(pair.log[1].close) == 1 and len(pair.srv[1].sessions) == 1


def _half_open(pair):
    for i in range(5):
        _padr_only(pair, bytes([2, 0, 0, 0, 1, i]), 0.0)
    pair.tick(61.0)
    assert len(pair.srv[1].sessions) == 0 and pair.log[1].close == []


def _qinq_line(pair):
    padi = F.pppoe_padi_frame(CLIENT_MAC, host_uniq=b"hu", vlans=[100, 42])
    assert pair.handle_frame(padi, 0.0)[0][12:14] == b"\x88\xa8"


SCENARIOS = {
    "chap": (codec.PROTO_CHAP, {}, _chap),
    "pap": (codec.PROTO_PAP, {}, _pap),
    "bad_password": (codec.PROTO_CHAP, {}, _bad_password),
    "carrier_loss": (codec.PROTO_CHAP, {}, _carrier_loss),
    "echo_kept": (codec.PROTO_CHAP, {}, _echo_kept),
    "padt": (codec.PROTO_CHAP, {}, _padt),
    "admin_terminate": (codec.PROTO_CHAP, {}, _admin_terminate),
    "session_limit": (codec.PROTO_CHAP, {"max_sessions": 2}, _session_limit),
    "rate_limit": (codec.PROTO_CHAP, {}, _rate_limit),
    "unknown_session": (codec.PROTO_CHAP, {}, _unknown_session),
    "redial": (codec.PROTO_CHAP, {}, _redial),
    "half_open": (codec.PROTO_CHAP, {}, _half_open),
    "qinq_line": (codec.PROTO_PAP, {}, _qinq_line),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_server_matches_reference(name):
    auth_proto, kw, run = SCENARIOS[name]
    pair = Pair(auth_proto, seed=len(name), **kw)
    run(pair)
    pair.check()


def test_open_session_decaps_the_same_on_both_stages():
    """Three CHAP sessions open through both servers; their `session_up`
    rows drive both device stages, and one is torn down by PADT."""
    pair = Pair(codec.PROTO_CHAP, seed=7)
    clients = [SimClient(pair, mac=bytes([2, 0xCC, 0, 0, 0, k])) for k in range(3)]
    for k, cli in enumerate(clients):
        cli.connect(now=1000.0 + k)
    padt = codec.PPPoEPacket(codec.CODE_PADT, clients[1].session_id, b"")
    pair.handle_frame(codec.eth_frame(AC_MAC, clients[1].mac, codec.ETH_PPPOE_DISCOVERY,
                                      padt.encode()), 1100.0)
    pair.check()
    frames = [F.pppoe_session_frame(AC_MAC, cli.mac, cli.session_id, F.PROTO_IPV4,
                                    F.udp_packet(b"\x00" * 6, b"\x00" * 6, cli.ip,
                                                 ip_to_u32("93.184.216.34"), 40000 + k, 53,
                                                 b"q" * 20)[14:])
              for k, cli in enumerate(clients)]
    jpkt, jlen, tpkt, tlen = _both(*_batch(frames))
    jt, tt = pair.log[0].tables, pair.log[1].tables
    jvo, jet = j_eth_vlan(jpkt)
    tvo, tet = t_eth_vlan(tpkt)
    ref = _decap(jpkt, jlen, jvo, jet, jt.by_sid.device_state(), jt.geom)
    got = tp.pppoe_decap(tpkt, tlen, tvo, tet, tt.by_sid.device_state(torch.device("cpu")),
                         tt.geom)
    assert_tuple_equal(got, ref, "decap")
    st = np.asarray(ref.stats)
    assert st[tp.PST_DECAP] == 2 and st[tp.PST_MISS] == 1  # the PADT'd session misses
