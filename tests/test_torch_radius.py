"""The port's RADIUS codec, client, accounting and CoA against
`bng_tpu.control.radius`, byte for byte.

Request authenticators come from one seeded source: each package's
`packet.new_request_authenticator` is replaced by a generator of the same
seed, so both send the same bytes. Clocks are held.

- Codec: password hiding, request and response authenticators, the
  Message-Authenticator and decode give the same bytes and values.
- Client: against the reference's `FakeRadiusServer`, accept (with
  attributes), reject, timeout, a retry, a failover, CHAP, accounting and
  the rate limit give the same requests on the wire, the same results
  and the same stats.
- Accounting: start, interim and stop give the same records; the offline
  spool and its retry, and orphan recovery from a spool file, the same
  records and the same spool file contents.
- CoA: a policy change, an unknown policy, an unknown session, a
  disconnect (by session id, IP and MAC) and a bad authenticator give the
  same replies and stats.

Tolerance: exact (bytes, dicts).
"""

import dataclasses
import hashlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

from bng_tpu.control.pppoe import auth as j_pauth
from bng_tpu.control.radius import accounting as j_acct, client as j_client, coa as j_coa
from bng_tpu.control.radius import packet as j_rp, policy as j_policy
from bng_tpu_torch.control.pppoe import auth as t_pauth
from bng_tpu_torch.control.radius import accounting as t_acct, client as t_client, coa as t_coa
from bng_tpu_torch.control.radius import packet as t_rp, policy as t_policy

from test_radius import SECRET, FakeRadiusServer

pytestmark = pytest.mark.torch_port

PKGS = (SimpleNamespace(name="jax", rp=j_rp, client=j_client, acct=j_acct, coa=j_coa,
                        policy=j_policy, pauth=j_pauth),
        SimpleNamespace(name="port", rp=t_rp, client=t_client, acct=t_acct, coa=t_coa,
                        policy=t_policy, pauth=t_pauth))
rp = j_rp
NOW = 1_753_000_000.0


@pytest.fixture(autouse=True)
def seeded_authenticators(monkeypatch):
    """Each package draws request authenticators from its own generator of
    one seed."""
    for p in PKGS:
        rng = np.random.default_rng(99)
        monkeypatch.setattr(p.rp, "new_request_authenticator",
                            lambda rng=rng: rng.integers(0, 256, 16, dtype=np.uint8).tobytes())


class Wire:
    """A transport that records every request's bytes before passing it on."""

    def __init__(self, inner):
        self.inner, self.sent = inner, []

    def __call__(self, data, host, port, timeout):
        self.sent.append((data, host, port))
        return self.inner(data, host, port, timeout)


def _client(p, inner, servers=(("10.0.0.5", 2),), **kw):
    wire = Wire(inner)
    c = p.client.RadiusClient([p.client.RadiusServerConfig(h, secret=SECRET, timeout_s=0.01,
                                                           retries=r) for h, r in servers],
                              transport=wire, clock=lambda: NOW, **kw)
    return c, wire


def test_codec_matches_reference():
    auth = bytes(range(16))
    got = []
    for p in PKGS:
        out = [p.rp.encrypt_password(pw, SECRET, auth)
               for pw in (b"short", b"exactly16bytes!!", b"a password longer than one block")]
        out.append(p.rp.decrypt_password(out[-1], SECRET, auth))
        req = p.rp.RadiusPacket(p.rp.ACCESS_REQUEST, 42, auth)
        req.add(p.rp.USER_NAME, "alice")
        req.add(p.rp.NAS_PORT, 7)
        req.add(p.rp.FRAMED_IP_ADDRESS, 0x0A000042)
        out.append(req.encode(SECRET, sign_message_authenticator=True))
        acct = p.rp.RadiusPacket(p.rp.ACCOUNTING_REQUEST, 9)
        acct.add(p.rp.ACCT_SESSION_ID, "sess-1")
        raw = acct.encode(SECRET)
        out += [raw, p.rp.RadiusPacket.decode(raw).verify_request(SECRET, raw),
                p.rp.RadiusPacket.decode(raw[:-1] + b"\x00").verify_request(SECRET, raw)]
        resp = p.rp.RadiusPacket(p.rp.ACCESS_ACCEPT, 42)
        resp.add(p.rp.FILTER_ID, "gold")
        rraw = resp.encode(SECRET, request_auth=auth)
        back = p.rp.RadiusPacket.decode(out[4])
        out += [rraw, p.rp.RadiusPacket.decode(rraw).verify_response(SECRET, auth, rraw),
                back.attributes, back.get_int(p.rp.NAS_PORT), back.get_str(p.rp.USER_NAME),
                p.rp.new_request_authenticator()]
        got.append(out)
    assert got[1] == got[0]


def _accept_attrs():
    return {"alice": {"password": "pw123", "attrs": [
        (rp.FRAMED_IP_ADDRESS, 0x0A000042), (rp.SESSION_TIMEOUT, 3600),
        (rp.FILTER_ID, "residential-100mbps")]}, "a": {"password": "p"}}


def _failover(data, host, port, timeout):
    return None if host == "10.0.0.5" else FakeRadiusServer(users=_accept_attrs())(
        data, host, port, timeout)


CLIENT_CASES = {
    "accept": (lambda: FakeRadiusServer(users=_accept_attrs()), {},
               lambda c: [c.authenticate("alice", "pw123", mac=bytes.fromhex("02deadbeef01"),
                                         circuit_id=b"port-7")]),
    "reject": (lambda: FakeRadiusServer(users=_accept_attrs()), {},
               lambda c: [c.authenticate("alice", b"wrong")]),
    "timeout": (lambda: (lambda *a: None), {}, lambda c: [c.authenticate("alice", "pw")]),
    "retry": (lambda: FakeRadiusServer(users=_accept_attrs(), drop_first=1), {},
              lambda c: [c.authenticate("a", "p")]),
    "failover": (lambda: _failover, {"servers": (("10.0.0.5", 2), ("10.0.0.6", 2))},
                 lambda c: [c.authenticate("a", "p"), c.authenticate_chap(
                     "a", 3, b"Z" * 16, hashlib.md5(b"\x03p" + b"Z" * 16).digest())]),
    "chap": (lambda: FakeRadiusServer(users=_accept_attrs()), {},
             lambda c: [c.authenticate_chap("alice", 7, b"C" * 16, hashlib.md5(
                 b"\x07pw123" + b"C" * 16).digest(), mac=b"\x02" * 6),
                 c.authenticate_chap("alice", 7, b"C" * 16, b"x" * 16)]),
    "accounting": (lambda: FakeRadiusServer(), {},
                   lambda c: [c.send_accounting("sess-1", rp.ACCT_START, username="a",
                                                framed_ip=1, mac=b"\x02" * 6),
                              c.send_accounting("sess-1", rp.ACCT_STOP, session_time=10,
                                                input_octets=1 << 33, output_octets=2000,
                                                input_packets=5, output_packets=6,
                                                terminate_cause=rp.TERM_USER_REQUEST)]),
    "rate_limited": (lambda: FakeRadiusServer(users=_accept_attrs()),
                     {"max_requests_per_second": 1.0},
                     lambda c: [c.authenticate("a", "p"), c.authenticate("a", "p")]),
}


def _result(r):
    return dataclasses.asdict(r) if dataclasses.is_dataclass(r) else r


@pytest.mark.parametrize("case", list(CLIENT_CASES))
def test_client_matches_reference(case):
    make, kw, run = CLIENT_CASES[case]
    got = []
    for p in PKGS:
        c, wire = _client(p, make(), **kw)
        got.append(([_result(r) for r in run(c)], wire.sent, dict(c.stats)))
    assert got[1] == got[0]
    assert got[1][1]  # something went on the wire


def test_radius_verifier_matches_reference():
    got = []
    for p in PKGS:
        users = {"bob": {"password": "s3cret", "attrs": [(rp.SESSION_TIMEOUT, 1800)]}}
        c, wire = _client(p, FakeRadiusServer(users=users))
        v = p.pauth.RadiusVerifier(c, mac_source=lambda: b"\x02\x00\x00\x00\x00\x09")
        ch = b"Z" * 16
        res = [v.verify_pap("bob", b"s3cret"), v.verify_pap("bob", b"wrong"),
               v.verify_chap("bob", 3, ch, p.pauth.chap_md5(3, b"s3cret", ch)),
               v.verify_chap("bob", 3, ch, b"n" * 16)]
        c.transport = Wire(lambda *a: None)
        res.append(v.verify_chap("x", 1, ch, b"r" * 16))
        got.append(([dataclasses.asdict(r) for r in res], wire.sent))
    assert got[1] == got[0]


def _acct_run(p, tmp_path, case):
    t = [NOW]
    up = [case != "offline"]
    real = FakeRadiusServer()
    c, wire = _client(p, lambda *a: real(*a) if up[0] else None)
    c.clock = lambda: t[0]
    spool = str(tmp_path / f"{p.name}.json") if case != "interim" else None
    m = p.acct.AccountingManager(c, interim_interval_s=300, spool_path=spool,
                                 clock=lambda: t[0])
    out = [m.start("s1", "alice", 0x0A000001, mac="02-AA"), m.start("s2", "bob", 0x0A000002),
           m.interim_tick()]
    t[0] += 301
    m.update_counters("s1", 111, 222, 3, 4)
    out.append(m.interim_tick())
    t[0] += 100
    out.append(m.stop("s2", terminate_cause=rp.TERM_ADMIN_RESET))
    if case == "offline":
        up[0] = True
        out.append(m.retry_tick())
    files = []
    if case == "orphans":
        files.append(json.loads(open(spool).read()))
        m2 = p.acct.AccountingManager(c, spool_path=spool, clock=lambda: t[0])
        out += [[dataclasses.asdict(r) for r in m2.pending], m2.retry_tick()]
        files.append(json.loads(open(spool).read()))
    return out, [dataclasses.asdict(s) for s in m.sessions.values()], wire.sent, files


@pytest.mark.parametrize("case", ["interim", "offline", "orphans"])
def test_accounting_matches_reference(case, tmp_path):
    got = [_acct_run(p, tmp_path, case) for p in PKGS]
    assert got[1] == got[0]
    assert len(got[1][2]) >= 4


def _coa_proc(p, log):
    sessions = {"sess-1": SimpleNamespace(ip=0x0A000001, mac="02-AA")}
    return p.coa.CoAProcessor(
        find_by_session_id=sessions.get,
        find_by_ip=lambda ip: next((s for s in sessions.values() if s.ip == ip), None),
        find_by_mac=lambda m: next((s for s in sessions.values() if s.mac == m), None),
        qos_update=lambda ip, pol: log.append(("qos", ip, pol)) or True,
        disconnect=lambda s: log.append(("disc", s.ip)) or True,
        policy_manager=p.policy.PolicyManager())


def _coa_requests():
    out = []
    for code, attrs, secret in (
            (rp.COA_REQUEST, [(rp.ACCT_SESSION_ID, "sess-1"), (rp.FILTER_ID, "business-100mbps")],
             SECRET),
            (rp.COA_REQUEST, [(rp.ACCT_SESSION_ID, "sess-1"), (rp.FILTER_ID, "no-such-policy")],
             SECRET),
            (rp.COA_REQUEST, [(rp.FRAMED_IP_ADDRESS, 0x0A0000FF), (rp.FILTER_ID, "gold")], SECRET),
            (rp.COA_REQUEST, [(rp.FRAMED_IP_ADDRESS, 0x0A000001),
                              (rp.FILTER_ID, "business-1gbps")], SECRET),
            (rp.DISCONNECT_REQUEST, [(rp.ACCT_SESSION_ID, "sess-1")], SECRET),
            (rp.DISCONNECT_REQUEST, [(rp.CALLING_STATION_ID, "02-AA")], SECRET),
            (rp.DISCONNECT_REQUEST, [(rp.CALLING_STATION_ID, "02-BB")], SECRET),
            (rp.COA_REQUEST, [(rp.ACCT_SESSION_ID, "sess-1")], b"wrong-secret"),
            (rp.ACCESS_REQUEST, [(rp.USER_NAME, "x")], SECRET)):
        req = rp.RadiusPacket(code, len(out) + 5)
        for t, v in attrs:
            req.add(t, v)
        out.append(req.encode(secret))
    return out + [b"\x2b\x01"]


def test_coa_matches_reference():
    got = []
    for p in PKGS:
        log = []
        srv = p.coa.CoAServer(SECRET, _coa_proc(p, log))
        replies = [srv.handle_raw(raw) for raw in _coa_requests()]
        got.append((replies, log, dict(srv.stats), dict(srv.processor.stats)))
    assert got[1] == got[0]
    replies, log, stats, pstats = got[1]
    codes = [None if r is None else r[0] for r in replies]
    assert codes == [rp.COA_ACK, rp.COA_NAK, rp.COA_NAK, rp.COA_ACK, rp.DISCONNECT_ACK,
                     rp.DISCONNECT_ACK, rp.DISCONNECT_NAK, None, None, None]
    assert stats == {"bad_auth": 1, "bad_packet": 2, "handled": 7}
