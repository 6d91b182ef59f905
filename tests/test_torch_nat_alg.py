"""The port's NAT ALGs (`bng_tpu_torch/control/nat_alg.py`) against the JAX
package's.

- The reference's own cases run on the port (`port_twin`):
  `tests/test_nat_alg_logging.py::TestFTPALG`, `TestSIPALG` and
  `TestALGHandler`.
- Seeded FTP (PORT, EPRT, 227 PASV, 229 EPSV) and SIP (INVITE with SDP,
  200 OK) payloads through both packages' `ALGHandler`, both ways: the
  same bytes, mapper calls and stats.
- Through the fused step (plain kernels on the CPU): with FTP and SIP ALGs
  on (`NATManager.add_alg_port` and the ALG flags), an FTP control packet
  and a SIP INVITE from NAT'd subscribers are punted by the NAT44 ALG
  trigger (`NST_ALG`, a slow lane); `ALGHandler.process` rewrites the
  punted payloads while its mapper pre-installs the data connections
  through `NATManager.handle_new_flow` (the reference has no production
  mapper: the test builds the same one for both packages); after the
  drain, the FTP server's first data packet is translated on the step
  (reverse-row hit, DNAT to the client). Every batch's outputs, the stats
  and the updated table words equal the JAX engine's.

Tolerance: exact.
"""

import jax
import numpy as np
import pytest

import test_nat_alg_logging as ref_alg
from bng_tpu.control import nat_alg as j_alg
from bng_tpu.ops.nat44 import FLAG_ALG_FTP as J_FLAG_FTP
from bng_tpu.ops.nat44 import FLAG_ALG_SIP as J_FLAG_SIP
from bng_tpu.runtime.engine import Engine as JEngine
from bng_tpu_torch import convert
from bng_tpu_torch import frames as F
from bng_tpu_torch.control import nat_alg as t_alg
from bng_tpu_torch.ops.nat44 import FLAG_ALG_FTP, FLAG_ALG_SIP, NST_ALG
from bng_tpu_torch.runtime.engine import Engine as TEngine
from bng_tpu_torch.utils.net import ip_to_u32, u32_to_ip

from test_torch_deviceauth import reference_cases, run_on_port
from test_torch_stages import JAX_PKG, NOW, PORT_PKG, assert_tuple_equal, deploy, mac

pytestmark = pytest.mark.torch_port

CASES = reference_cases(ref_alg, ("TestFTPALG", "TestSIPALG", "TestALGHandler"))


@pytest.mark.parametrize("case", CASES)
def test_reference_case_holds_on_the_port(case, request):
    run_on_port(ref_alg, case, request)


def test_alg_flags_and_ports_are_the_references():
    assert (FLAG_ALG_FTP, FLAG_ALG_SIP) == (J_FLAG_FTP, J_FLAG_SIP)
    assert (t_alg.FTP_PORT, t_alg.SIP_PORT) == (j_alg.FTP_PORT, j_alg.SIP_PORT) == (21, 5060)


# ---- seeded payloads through both handlers --------------------------------

def _hostport(ip, port):
    return ",".join(ip.split(".")) + f",{port >> 8},{port & 0xFF}"


def seeded_payloads(seed: int, priv: str, n: int = 40):
    """(dst_port, payload, outbound) triples from a seed."""
    rng = np.random.default_rng(seed)
    other = "10.9.9.9"
    out = []
    for _ in range(n):
        kind = int(rng.integers(0, 7))
        ip = priv if rng.random() < 0.8 else other
        port = int(rng.integers(1024, 65535))
        if kind == 0:
            out.append((21, f"USER u{port}\r\nPORT {_hostport(ip, port)}\r\n".encode(), True))
        elif kind == 1:
            out.append((21, f"EPRT |1|{ip}|{port}|\r\n".encode(), True))
        elif kind == 2:
            out.append((21, f"227 Entering Passive Mode ({_hostport(ip, port)})\r\n".encode(),
                        False))
        elif kind == 3:
            out.append((21, f"229 Entering Extended Passive Mode (|||{port}|)\r\n".encode(),
                        False))
        elif kind == 4:
            out.append((5060, (f"INVITE sip:bob@example.com SIP/2.0\r\nVia: SIP/2.0/UDP "
                               f"{ip}:5060\r\nContact: <sip:alice@{ip}:5060>\r\n\r\n"
                               f"o=- 1 1 IN IP4 {ip}\r\nc=IN IP4 {ip}\r\n"
                               f"m=audio {port} RTP/AVP 0\r\n").encode(), True))
        elif kind == 5:
            out.append((5060, b"SIP/2.0 200 OK\r\nContact: <sip:bob@203.0.113.1:5060>\r\n",
                        False))
        else:
            out.append((80, b"GET / HTTP/1.1\r\n", True))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_payloads_rewrite_the_same_bytes(seed):
    res = []
    for alg in (j_alg, t_alg):
        calls = []

        def mapper(ip, port, calls=calls):
            calls.append((ip, port))
            return None if port % 17 == 0 else ("203.0.113.1", (port * 7) % 60000 + 1024)

        conn = alg.ALGConnection(private_ip="100.64.0.5", private_port=21,
                                 public_ip="203.0.113.1", public_port=2021)
        h = alg.ALGHandler(mapper)
        outs = [h.process(conn, dport, data, outbound)
                for dport, data, outbound in seeded_payloads(seed, "100.64.0.5")]
        res.append((outs, calls, h.get(21).stats, h.get(5060).stats))
    assert res[0] == res[1]
    assert res[1][2]["port_rewrites"] + res[1][2]["eprt_rewrites"] > 0


# ---- through the fused step ------------------------------------------------

SERVER = "198.51.100.7"
FTP_SUB, SIP_SUB = "10.0.0.11", "10.0.0.10"


def alg_deploy(pkg, flags):
    d = deploy(pkg)
    d.nat.flags |= flags
    d.nat.add_alg_port(21, 6)
    d.nat.add_alg_port(5060, 17)
    return d


def nat_mapper(nat, server_ip, server_port, proto, now, calls):
    """(private ip, port) -> (public ip, port): the data connection's
    session and reverse row, installed through the NAT manager."""
    def mapper(ip, port):
        calls.append((ip, port))
        got = nat.handle_new_flow(ip_to_u32(ip), ip_to_u32(server_ip), port, server_port,
                                  proto, 64, now)
        return None if got is None else (u32_to_ip(got[0]), int(got[1]))
    return mapper


def _control_conn(pkg_alg, nat, src, sport, dport, proto):
    key = nat._key(ip_to_u32(src), ip_to_u32(SERVER), sport, dport, proto)
    row = nat.sessions.lookup(key)
    assert row is not None  # the punt created the control connection's session
    return pkg_alg.ALGConnection(private_ip=src, private_port=sport,
                                 public_ip=u32_to_ip(int(row[0])), public_port=int(row[1]),
                                 protocol=proto)


def run_alg_path(pkg, pkg_alg, engine_cls, flags, **eng_kw):
    d = alg_deploy(pkg, flags)
    eng = engine_cls(d.fp, d.nat, d.qos, d.spoof, batch_size=16, pkt_slot=512, **eng_kw)
    ftp_ctl = F.tcp_packet(mac(0x11), b"\x04" * 6, ip_to_u32(FTP_SUB), ip_to_u32(SERVER),
                           40001, 21, b"PORT " + _hostport(FTP_SUB, 5001).encode() + b"\r\n")
    invite = F.udp_packet(mac(0x10), b"\x04" * 6, ip_to_u32(SIP_SUB), ip_to_u32(SERVER),
                          5060, 5060, (f"INVITE sip:bob@example.com SIP/2.0\r\nVia: SIP/2.0/UDP "
                                       f"{SIP_SUB}:5060\r\n\r\nc=IN IP4 {SIP_SUB}\r\n"
                                       f"m=audio 49170 RTP/AVP 0\r\n").encode())
    frames = [ftp_ctl, invite]
    o1 = eng.process(frames, now=NOW + 1)
    alg_hits = int(eng.stats.nat[NST_ALG])
    calls = []
    ftp_conn = _control_conn(pkg_alg, d.nat, FTP_SUB, 40001, 21, 6)
    sip_conn = _control_conn(pkg_alg, d.nat, SIP_SUB, 5060, 5060, 17)
    ftp_h = pkg_alg.ALGHandler(nat_mapper(d.nat, SERVER, 20, 6, NOW + 1, calls))
    sip_h = pkg_alg.ALGHandler(nat_mapper(d.nat, SERVER, 5060, 17, NOW + 1, calls))
    rewritten = []
    for lane, _ in o1["slow"]:  # a punted lane's frame is the host's to handle
        dec = F.decode(frames[lane])
        conn, h = (ftp_conn, ftp_h) if dec.dst_port == 21 else (sip_conn, sip_h)
        rewritten.append(h.process(conn, dec.dst_port, dec.payload, True))
    # the server's first data packet toward the mapped public port
    pub = d.nat.handle_new_flow(ip_to_u32(FTP_SUB), ip_to_u32(SERVER), 5001, 20, 6, 64, NOW + 1)
    data = F.tcp_packet(b"\x04" * 6, mac(0x11), ip_to_u32(SERVER), pub[0], 20, pub[1],
                        b"220 data")
    o2 = eng.process([data], from_access=False, now=NOW + 2)
    return dict(d=d, eng=eng, o1=o1, o2=o2, alg_hits=alg_hits, rewritten=rewritten,
                calls=calls, pub=pub)


def test_alg_punts_rewrite_and_data_connection_equal_the_reference():
    j = run_alg_path(JAX_PKG, j_alg, JEngine, J_FLAG_FTP | J_FLAG_SIP)
    t = run_alg_path(PORT_PKG, t_alg, TEngine, FLAG_ALG_FTP | FLAG_ALG_SIP, device="cpu")
    assert t["o1"] == j["o1"] and t["o2"] == j["o2"]
    # both control packets punted by the ALG trigger: two slow lanes, no fwd
    assert t["alg_hits"] == j["alg_hits"] == 2
    assert sorted(i for i, _ in t["o1"]["slow"]) == [0, 1] and t["o1"]["fwd"] == []
    assert t["rewritten"] == j["rewritten"] and t["calls"] == j["calls"]
    pub_ip = u32_to_ip(t["pub"][0])
    ftp_out = t["rewritten"][0]
    assert ftp_out == (b"PORT " + _hostport(pub_ip, t["pub"][1]).encode() + b"\r\n")
    assert FTP_SUB.encode() not in ftp_out and SIP_SUB.encode() not in t["rewritten"][1]
    assert t["calls"] == [(FTP_SUB, 5001), (SIP_SUB, 49170)]
    # the data connection's first packet: translated on the step (DNAT)
    (lane, out), = t["o2"]["fwd"]
    dec = F.decode(out)
    assert (u32_to_ip(dec.dst_ip), dec.dst_port) == (FTP_SUB, 5001) and F.l4_checksum_ok(out)
    for f in ("dhcp", "nat", "qos", "spoof"):
        assert np.array_equal(getattr(t["eng"].stats, f), getattr(j["eng"].stats, f)), f
    jt = jax.tree_util.tree_map(lambda a: np.array(a), j["eng"].tables)
    assert_tuple_equal(convert.tables_to_numpy(t["eng"].tables), jt, "engine tables")
