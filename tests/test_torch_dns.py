"""The port's DNS resolver and wire (`bng_tpu_torch/control/{dns,dns_wire}.py`),
`run`'s DNS listener with the walled garden (`cli.py` step 2b and the
resolver half of the garden sync) and `BNGMetrics.collect_dns`, against the
JAX package's.

- The reference's own cases run on the port (rebound by
  `test_torch_deviceauth.port_twin`): the resolver (forwarding, cache, TTL
  clamp, negative cache, intercept rules, the garden redirect, DNS64, the
  rate limit, LRU eviction), the codec (round trips, compression
  pointers, the bounded pointer walk, MX/TXT pass-through), and
  `UDPForwarder`/`DNSServer` against a loopback fake upstream (failover,
  the walled-garden answer path, the deadline under a mismatch flood, a
  wrong question echo refused).
- The codec across packages: seeded queries and responses (A, AAAA,
  CNAME, rcodes) encode byte-equal; seeded random datagrams decode to the
  same result or the same error.
- The resolver across packages: a seeded stream of queries over a static
  upstream, intercept rules, garden clients, DNS64 and a rate limit at
  one clock gives the same answers, flags and stats.
- `run --dns-enabled` on a reference app and a port app (`device="cpu"`):
  the garden sync puts a gardened lease's IP in the resolver and the
  device gate, a release takes it out, a grant applies the garden state
  of a MAC gardened before its lease and a lease stop scrubs it; the same
  resolver client sets, the same garden host-table words, and the port's
  device garden tables after the drain equal the reference's uploaded
  from its host mirror. Queries over each app's socket get the same
  answers, and `collect_dns` gives the same `bng_dns_*` exposition.

Tolerance: exact.
"""

import socket
import types

import jax
import numpy as np
import pytest

import test_garden_dns as ref_gd
from test_torch_deviceauth import run_on_port

from bng_tpu import cli as j_cli
from bng_tpu.control import dns as j_dns
from bng_tpu.control import dns_wire as j_wire
from bng_tpu.control import metrics as j_metrics
from bng_tpu_torch import cli as t_cli
from bng_tpu_torch import convert
from bng_tpu_torch.control import dns as t_dns
from bng_tpu_torch.control import dns_wire as t_wire
from bng_tpu_torch.control import metrics as t_metrics
from bng_tpu_torch.runtime import engine as t_engine
from bng_tpu_torch.utils.net import mac_to_u64

pytestmark = pytest.mark.torch_port

PKGS = [types.SimpleNamespace(dns=j_dns, wire=j_wire, cli=j_cli, metrics=j_metrics, kw={}),
        types.SimpleNamespace(dns=t_dns, wire=t_wire, cli=t_cli, metrics=t_metrics,
                              kw={"device": "cpu"})]


# ---- the reference's cases on the port ------------------------------------

def _cases(cls, skip=()):
    return [f"{cls}::{m}" for m in vars(getattr(ref_gd, cls))
            if m.startswith("test_") and m not in skip]


CASES = (_cases("TestDNSResolver") + _cases("TestDNSWireCodec")
         # the app cases build a BNGApp with no device argument (a card);
         # they run on both packages' apps below, on the CPU
         + _cases("TestUDPForwarderAndServer", skip=("test_cli_wires_dns_and_garden_sync",))
         + _cases("TestDNSWireReviewFixes", skip=("test_garden_before_dhcp_lease_still_enforced",
                                                  "test_build_failure_runs_cleanup"))
         + _cases("TestForwarderDeadline"))


@pytest.mark.parametrize("case", CASES)
def test_reference_dns_case_holds_on_the_port(case, request):
    run_on_port(ref_gd, case, request)


# ---- the codec across packages --------------------------------------------

def _records(dns, rng, name):
    out = []
    for k in rng.integers(0, 3, int(rng.integers(0, 4))):
        if k == 0:
            out.append(dns.Record(name=name, rtype=dns.TYPE_A, ttl=int(rng.integers(1, 9999)),
                                  ipv4=".".join(str(int(b)) for b in rng.integers(0, 256, 4))))
        elif k == 1:
            out.append(dns.Record(name=name, rtype=dns.TYPE_AAAA, ttl=60,
                                  ipv6=f"2001:db8::{int(rng.integers(1, 0xFFFF)):x}"))
        else:
            out.append(dns.Record(name=name, rtype=dns.TYPE_CNAME, ttl=300,
                                  target=f"edge{int(rng.integers(99))}.example.net"))
    return out


def _outcome(fn):
    try:
        return ("ok", repr(fn()))
    except Exception as e:  # noqa: BLE001 — the error type is the observable
        return ("raised", type(e).__name__)


def test_codec_encodes_byte_equal_and_decodes_equal():
    got = []
    for p in PKGS:
        rng = np.random.default_rng(23)
        enc, dec = [], []
        for i in range(64):
            labels = [f"l{int(x)}" for x in rng.integers(0, 999, int(rng.integers(1, 5)))]
            name = ".".join(labels) + ".example"
            q = p.dns.Query(name=name, qtype=int(rng.choice([p.dns.TYPE_A, p.dns.TYPE_AAAA])))
            r = p.dns.Response(query=q, rcode=int(rng.choice([0, 0, 0, 2, 3, 5])),
                               answers=_records(p.dns, rng, name))
            eq, er = p.wire.encode_query(q, i), p.wire.encode_response(r, 0x1000 + i)
            enc.append((eq, er))
            dec.append((_outcome(lambda eq=eq: p.wire.decode_query(eq)),
                        _outcome(lambda er=er: p.wire.decode_response(er))))
        junk = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
                for n in rng.integers(0, 64, 96)]
        junk += [e[1][:int(k)] for e, k in zip(enc, rng.integers(0, 40, 64))]
        dec += [(_outcome(lambda b=b: p.wire.decode_query(b)),
                 _outcome(lambda b=b: p.wire.decode_response(b))) for b in junk]
        got.append((enc, dec))
    assert got[1][0] == got[0][0]
    assert got[1][1] == got[0][1]


# ---- the resolver across packages -----------------------------------------

def _resolver_stream(p):
    dns = p.dns
    clk = ref_gd.FakeClock()
    table = {}
    for i in range(12):
        table[(f"h{i}.test", dns.TYPE_A)] = [dns.Record(
            name=f"h{i}.test", rtype=dns.TYPE_A, ttl=30 * (i + 1), ipv4=f"192.0.2.{i + 1}")]
    table[("v4only.test", dns.TYPE_A)] = [dns.Record(name="v4only.test", rtype=dns.TYPE_A,
                                                     ttl=60, ipv4="192.0.2.33")]

    def fwd(q):
        key = (q.name.rstrip("."), q.qtype)
        if key in table:
            return dns.Response(query=q, answers=table[key])
        if q.name.rstrip(".") == "v4only.test":
            return dns.Response(query=q, rcode=dns.RCODE_SUCCESS)
        return dns.Response(query=q, rcode=dns.RCODE_NAME_ERROR)

    r = dns.Resolver(dns.DNSConfig(cache_size=8, min_ttl=20, dns64_enabled=True,
                                   rate_limit_qps=1, rate_limit_burst=4),
                     forwarder=fwd, clock=clk)
    r.add_intercept_rule(dns.InterceptRule(domain="ads.test", action=dns.InterceptAction.BLOCK))
    r.add_intercept_rule(dns.InterceptRule(domain="portal.test", action=dns.InterceptAction.REDIRECT,
                                           redirect_ip="10.0.0.80"))
    r.add_intercept_rule(dns.InterceptRule(domain="old.test", exact=True,
                                           action=dns.InterceptAction.CNAME, cname="new.test"))
    names = ([f"h{i}.test" for i in range(14)] + ["x.ads.test", "portal.test", "old.test",
                                                   "a.old.test", "v4only.test"])
    rng = np.random.default_rng(29)
    out = []
    for k in range(400):
        src = f"10.0.0.{int(rng.integers(1, 9))}"
        if k % 50 == 0:
            r.add_walled_garden_client(src)
        if k % 70 == 0:
            r.remove_walled_garden_client(f"10.0.0.{int(rng.integers(1, 9))}")
        q = dns.Query(name=str(rng.choice(names)), source=src,
                      qtype=int(rng.choice([dns.TYPE_A, dns.TYPE_A, dns.TYPE_AAAA])))
        resp = r.resolve(q)
        out.append((resp.rcode, resp.cached,
                    [(a.rtype, a.ipv4, a.ipv6, a.target, a.ttl) for a in resp.answers]))
        clk.advance(float(rng.integers(0, 3)) * 0.1)
    return out, r.stats(), r.cache.stats(), sorted(r._walled_clients)


def test_resolver_stream_matches_reference():
    ref, got = (_resolver_stream(p) for p in PKGS)
    assert got == ref
    rcodes = {rc for rc, _c, _a in got[0]}
    assert {0, 3, 5} <= rcodes and any(c for _rc, c, _a in got[0])


# ---- run --dns-enabled on both apps ----------------------------------------

def _garden_words(app, p):
    eng = app.components["engine"]
    g = eng.garden.subscribers
    host = [g.keys.tolist(), g.vals.tolist(), g.used.tolist(), eng.garden.allowed.tolist()]
    if p is PKGS[1]:
        t_engine._apply_all_updates(eng.tables, eng._drain_updates())
        t = convert.tables_to_numpy(eng.tables)
    else:
        t = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), eng._device_tables())
    dev = [np.asarray(x).view(np.uint32).tolist() for x in (*t.garden, t.garden_allowed)]
    return host, dev


def _ask(addr, names):
    c = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    c.settimeout(3.0)
    out = []
    try:
        for i, name in enumerate(names):
            c.sendto(t_wire.encode_query(t_dns.Query(name=name, qtype=t_dns.TYPE_A), i),
                     (addr[0], addr[1]))
            data, _ = c.recvfrom(4096)
            txid, _q, resp = t_wire.decode_response(data)
            out.append((txid, resp.rcode, [a.ipv4 for a in resp.answers]))
    finally:
        c.close()
    return out


def _dns_app_drive(p):
    up = ref_gd._fake_upstream({("ok.example.com", t_dns.TYPE_A): "192.0.2.88",
                                ("cdn.example.com", t_dns.TYPE_A): "192.0.2.99"})
    app = None
    try:
        app = p.cli.BNGApp(p.cli.BNGConfig(dns_enabled=True, dns_listen="127.0.0.1:0",
                                           dns_upstreams=[up.addr]), **p.kw)
        c = app.components
        dhcp, garden, resolver = c["dhcp"], c["walledgarden"], c["dns_resolver"]
        out = []
        # a lease, then the garden transition and its release
        mac = "02:00:00:00:00:31"
        lease = types.SimpleNamespace(ip=0x0A00002A, mac=bytes.fromhex(mac.replace(":", "")),
                                      session_id="s31")
        dhcp.leases[mac_to_u64(mac)] = lease
        garden.add_to_walled_garden(mac)
        out.append((sorted(resolver._walled_clients), _garden_words(app, p)))
        # the loopback client is a gardened subscriber: the portal for any name
        resolver.add_walled_garden_client("127.0.0.1")
        out.append(_ask(c["dns_server"].addr, ["anything.example.org", "ok.example.com"]))
        resolver.remove_walled_garden_client("127.0.0.1")
        out.append(_ask(c["dns_server"].addr, ["ok.example.com", "ok.example.com",
                                               "cdn.example.com", "nope.example.com"]))
        garden.release_from_walled_garden(mac)
        out.append((sorted(resolver._walled_clients), _garden_words(app, p)))
        # gardened before its lease: the grant applies it, the stop scrubs it
        mac2 = "02:00:00:00:00:41"
        garden.add_to_walled_garden(mac2)
        lease2 = types.SimpleNamespace(ip=0x0A00005B, mac=bytes.fromhex(mac2.replace(":", "")),
                                       session_id="s41")
        dhcp.leases[mac_to_u64(mac2)] = lease2
        dhcp.accounting_hook("start", lease2, "s41")
        out.append((sorted(resolver._walled_clients), _garden_words(app, p)))
        dhcp.accounting_hook("stop", lease2, "s41")
        out.append((sorted(resolver._walled_clients), _garden_words(app, p)))
        c["collector"].collect_once()
        out.append(sorted(ln for ln in c["metrics"].expose().splitlines()
                          if ln.startswith("bng_dns_")))
        out.append(sorted(up.seen))
        return out
    finally:
        if app is not None:
            app.close()
        up.close()


def test_run_dns_and_garden_sync_match_reference():
    ref, got = (_dns_app_drive(p) for p in PKGS)
    assert got == ref
    assert got[0][0] == ["10.0.0.42"] and got[3][0] == []
    assert got[4][0] == ["10.0.0.91"] and got[5][0] == []
    assert got[1][0][2] == ["10.255.255.1"] and got[2][0][2] == ["192.0.2.88"]
    assert got[0][1] != got[3][1]  # the device gate took the gardened IP, then dropped it
    assert any('outcome="served"' in ln for ln in got[6])


def test_collect_dns_exposition_matches_reference():
    rng = np.random.default_rng(31)
    rows = []
    for _ in range(6):
        srv = {k: int(v) for k, v in zip(("served", "bad_packets", "server_errors",
                                          "overloaded"), rng.integers(0, 10_000, 4))}
        res = {"queries": int(rng.integers(0, 9_000)), "cache_hits": int(rng.integers(0, 900))}
        rows.append((srv, res))
    rows.append(({}, {"queries": 0, "cache_hits": 0}))
    got = []
    for p in PKGS:
        m = p.metrics.BNGMetrics()
        exp = []
        for srv, res in rows:
            m.collect_dns(srv, res)
            exp.append([ln for ln in m.expose().splitlines() if "bng_dns_" in ln])
        got.append(exp)
    assert got[1] == got[0]
    assert any("bng_dns_cache_hit_rate" in ln for ln in got[0][0])
