"""TLS and mutual TLS on the port's cluster wire, and its ETSI TLS delivery
sink (`bng_tpu_torch/control/{ztp_tls,cluster_http,intercept}.py`), with
live handshakes against certificates that `openssl` makes at test time,
as the reference's `tests/test_cluster_tls.py` does.

- The reference's handshake cases on the port: HA full sync and an SSE
  delta over a pinned TLS listener; a wrong pin refused before any request
  (`CertificateValidationError`); a plain client refused by a TLS
  listener; mTLS that refuses a client with no identity and serves one
  with it; the store's anti-entropy over TLS.
- Across the packages: a port standby syncs from a reference active's TLS
  listener and the other way round, with the same pins.
- `run` over TLS: a port active with `--cluster-tls-cert/--cluster-tls-key`
  and a port standby with `--cluster-tls-pins` pair on `--device cpu`.
- ETSI delivery: `TLSDeliverySink` delivers an HI2 PDU over pinned TLS (the
  same PDU bytes as the reference's sink), delivers nothing to a wrong pin,
  buffers through an outage and flushes, and heals on its own thread.

Every wait has its own deadline.

Tolerance: exact (session dicts, PDU bytes).
"""

import os
import socket
import ssl
import struct
import subprocess
import threading
import time
from types import SimpleNamespace

import pytest

from bng_tpu.control import cluster_http as j_http
from bng_tpu.control import ha as j_ha
from bng_tpu.control import intercept as j_li
from bng_tpu.control import ztp_tls as j_tls
from bng_tpu_torch import cli as t_cli
from bng_tpu_torch.control import cluster_http as t_http
from bng_tpu_torch.control import crdt as t_crdt
from bng_tpu_torch.control import ha as t_ha
from bng_tpu_torch.control import intercept as t_li
from bng_tpu_torch.control import ztp_tls as t_tls

pytestmark = pytest.mark.torch_port

JAX = SimpleNamespace(name="jax", http=j_http, ha=j_ha, tls=j_tls, li=j_li)
PORT = SimpleNamespace(name="port", http=t_http, ha=t_ha, tls=t_tls, li=t_li)


def wait_until(pred, timeout=15.0, step=0.02):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(step)
    return False


def _selfsigned(tmp, cn):
    key = os.path.join(tmp, f"{cn}.key")
    crt = os.path.join(tmp, f"{cn}.crt")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", key,
         "-out", crt, "-days", "365", "-subj", f"/CN={cn}",
         "-addext", f"subjectAltName=DNS:{cn},IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60)
    with open(crt) as f:
        pem = f.read()
    der = t_tls.pem_to_der(pem)[0]
    return {"key": key, "crt": crt, "pem": pem, "der": der, "pin": t_tls.cert_fingerprint(der)}


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_cluster_tls"))
    return {"server": _selfsigned(tmp, "active.cluster.test"),
            "client": _selfsigned(tmp, "standby.cluster.test"),
            "lea": _selfsigned(tmp, "lea.collector.test")}


def _client_cfg(pk, certs, pin=None, mtls=False):
    cfg = pk.tls.TLSConfig(pinned_certs=[pin or certs["server"]["pin"]],
                           require_valid_chain=False)
    if mtls:
        cfg.client_cert_file = certs["client"]["crt"]
        cfg.client_key_file = certs["client"]["key"]
    return cfg


def _tls_server(pk, certs, request, client_ca=False):
    srv = pk.http.ClusterServer(tls=pk.tls.ServerTLSConfig(
        cert_file=certs["server"]["crt"], key_file=certs["server"]["key"],
        client_ca_file=certs["client"]["crt"] if client_ca else ""))
    request.addfinalizer(srv.close)
    return srv


def test_pins_and_fingerprints_equal_reference(certs):
    for c in certs.values():
        assert t_tls.pem_to_der(c["pem"]) == j_tls.pem_to_der(c["pem"])
        assert t_tls.cert_fingerprint(c["der"]) == j_tls.cert_fingerprint(c["der"]) == c["pin"]


@pytest.mark.parametrize("act_p,sb_p", [(PORT, PORT), (JAX, PORT), (PORT, JAX)],
                         ids=["port-port", "jax-active", "jax-standby"])
def test_ha_full_sync_and_sse_over_pinned_tls(act_p, sb_p, certs, request):
    active = act_p.ha.ActiveSyncer(act_p.ha.InMemorySessionStore())
    srv = _tls_server(act_p, certs, request).mount_ha(active).start()
    assert srv.url.startswith("https://")
    active.push_change(act_p.ha.SessionState("s1", mac="02:00:00:00:00:01", ip=0x0A000001))
    store = sb_p.ha.InMemorySessionStore()
    standby = sb_p.ha.StandbySyncer(store, transport=lambda: sb_p.http.HTTPActiveProxy(
        srv.url, on_stream_end=lambda: standby.disconnect(), tls=_client_cfg(sb_p, certs)))
    standby.tick(now=0.0)
    assert standby.connected and len(store) == 1  # the full sync over TLS
    active.push_change(act_p.ha.SessionState("s2", ip=0x0A000002))
    assert wait_until(lambda: store.get("s2") is not None)
    assert sorted(sorted(s.to_dict().items()) for s in store.all()) == \
        sorted(sorted(s.to_dict().items()) for s in active.store.all())


def test_wrong_pin_refused_before_any_request(certs, request):
    srv = _tls_server(PORT, certs, request).mount_ha(
        t_ha.ActiveSyncer(t_ha.InMemorySessionStore())).start()
    with pytest.raises(t_tls.CertificateValidationError):
        t_http.HTTPActiveProxy(srv.url, tls=_client_cfg(PORT, certs, pin="ab" * 32))


def test_plaintext_client_cannot_reach_tls_listener(certs, request):
    srv = _tls_server(PORT, certs, request).mount_ha(
        t_ha.ActiveSyncer(t_ha.InMemorySessionStore())).start()
    with pytest.raises(ConnectionError):
        t_http.HTTPActiveProxy(f"http://{srv.host}:{srv.port}")


def test_mtls_requires_client_identity(certs, request):
    active = t_ha.ActiveSyncer(t_ha.InMemorySessionStore())
    srv = _tls_server(PORT, certs, request, client_ca=True).mount_ha(active).start()
    with pytest.raises((ConnectionError, ssl.SSLError, t_tls.CertificateValidationError)):
        t_http.HTTPActiveProxy(srv.url, tls=_client_cfg(PORT, certs))
    proxy = t_http.HTTPActiveProxy(srv.url, tls=_client_cfg(PORT, certs, mtls=True))
    active.push_change(t_ha.SessionState("m1", ip=1))
    sessions, _seq = proxy.full_sync()
    assert [s.session_id for s in sessions] == ["m1"]


def test_crdt_anti_entropy_over_tls(certs, request):
    a = t_crdt.DistributedStore("a", mode=t_crdt.MODE_WRITE)
    b = t_crdt.DistributedStore("b", mode=t_crdt.MODE_WRITE)
    srv_b = _tls_server(PORT, certs, request).mount_store(b).start()
    a.add_peer(t_http.HTTPStorePeer(srv_b.url, tls=_client_cfg(PORT, certs)))
    a.put("sub/1", b"ip=10.0.0.1")
    b.put("sub/2", b"\x00\x01\xff")
    a.tick()
    assert a.get("sub/2") == b"\x00\x01\xff" and b.get("sub/1") == b"ip=10.0.0.1"


def test_run_pair_over_tls(certs):
    base = dict(dhcpv6_enabled=False, slaac_enabled=False, metrics_enabled=False,
                coa_enabled=False, walled_garden_enabled=False, batch_size=16)
    act = t_cli.BNGApp(t_cli.BNGConfig(
        ha_role="active", cluster_listen="127.0.0.1:0", node_id="a",
        cluster_tls_cert=certs["server"]["crt"], cluster_tls_key=certs["server"]["key"],
        **base), device="cpu")
    try:
        url = act.components["cluster_server"].url
        assert url.startswith("https://")
        act.components["ha"].push_change(t_ha.SessionState("s1", ip=7))
        sb = t_cli.BNGApp(t_cli.BNGConfig(
            ha_role="standby", ha_peer=url, node_id="b",
            cluster_tls_pins=[certs["server"]["pin"]], **base), device="cpu")
        try:
            tls = sb._cluster_client_tls()
            assert tls.pinned_certs == [certs["server"]["pin"]] and not tls.require_valid_chain
            sb.tick(0.0)
            ha_b = sb.components["ha"]
            assert ha_b.connected and ha_b.store.get("s1").ip == 7
            act.components["ha"].push_change(t_ha.SessionState("s2", ip=8))
            assert wait_until(lambda: ha_b.store.get("s2") is not None)
        finally:
            sb.close()
    finally:
        act.close()


class _LEACollector:
    """A TLS collector: accepts connections, reads 4-byte-length-framed
    PDUs, records them."""

    def __init__(self, certs):
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(certs["lea"]["crt"], certs["lea"]["key"])
        self._ctx = ctx
        self._raw = socket.create_server(("127.0.0.1", 0))
        self.port = self._raw.getsockname()[1]
        self.pdus: list[bytes] = []
        self.accepting = True
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                raw, _ = self._raw.accept()
            except OSError:
                return
            if not self.accepting:
                raw.close()
                continue
            try:
                conn = self._ctx.wrap_socket(raw, server_side=True)
                conn.settimeout(5.0)
                while True:
                    hdr = self._read_n(conn, 4)
                    if hdr is None:
                        break
                    body = self._read_n(conn, struct.unpack(">I", hdr)[0])
                    if body is None:
                        break
                    self.pdus.append(body)
            except (ssl.SSLError, OSError):
                continue

    @staticmethod
    def _read_n(conn, n):
        buf = b""
        while len(buf) < n:
            try:
                got = conn.recv(n - len(buf))
            except (TimeoutError, OSError):
                return None
            if not got:
                return None
            buf += got
        return buf

    def close(self):
        self._raw.close()


def _record(li):
    return li.InterceptRecord(
        id="r1", liid="LIID-7", warrant_id="w1", timestamp=1000.0, record_type="IRI",
        event_type="session-start", session_id="sess-1", subscriber_id="sub-9",
        source_ip="10.0.0.5", dest_ip="8.8.8.8", source_port=40000, dest_port=53, protocol=17,
        direction="up", payload=b"pkt")


def _lea_cfg(pk, certs, pin=None):
    return pk.tls.TLSConfig(pinned_certs=[pin or certs["lea"]["pin"]], require_valid_chain=False)


def test_hi2_pdu_delivered_over_pinned_tls(certs, request):
    got = []
    for pk in (JAX, PORT):
        lea = _LEACollector(certs)
        request.addfinalizer(lea.close)
        sink = pk.li.TLSDeliverySink("127.0.0.1", lea.port, _lea_cfg(pk, certs))
        request.addfinalizer(sink.close)
        pk.li.ETSIExporter(sink, country_code="GB").deliver_iri(_record(pk.li))
        assert wait_until(lambda: len(lea.pdus) == 1)
        parsed = pk.li.parse_etsi_pdu(lea.pdus[0])
        assert parsed["liid"] == "LIID-7" and parsed["handover"] == pk.li.ETSIExporter.HI2
        assert sink.stats["delivered"] == 1
        got.append(lea.pdus[0])
    assert got[1] == got[0]


def test_wrong_pin_delivers_nothing(certs, request):
    lea = _LEACollector(certs)
    request.addfinalizer(lea.close)
    sink = t_li.TLSDeliverySink("127.0.0.1", lea.port, _lea_cfg(PORT, certs, pin="cd" * 32))
    request.addfinalizer(sink.close)
    t_li.ETSIExporter(sink).deliver_iri(_record(t_li))
    assert sink.stats["connect_failures"] == 1 and sink.stats["delivered"] == 0
    assert lea.pdus == []  # no HI byte left the box


def test_outage_buffers_then_flushes(certs, request):
    t = [1000.0]
    lea = _LEACollector(certs)
    request.addfinalizer(lea.close)
    lea.accepting = False  # the collector is down
    sink = t_li.TLSDeliverySink("127.0.0.1", lea.port, _lea_cfg(PORT, certs),
                                clock=lambda: t[0], auto_flush=False)
    request.addfinalizer(sink.close)
    exporter = t_li.ETSIExporter(sink)
    exporter.deliver_iri(_record(t_li))
    exporter.deliver_cc(_record(t_li))
    assert sink.stats["delivered"] == 0 and len(sink._buffer) == 2
    lea.accepting = True
    t[0] += 10.0
    assert sink.flush()
    assert wait_until(lambda: len(lea.pdus) == 2)
    assert sink.stats["delivered"] == 2
    assert t_li.parse_etsi_pdu(lea.pdus[1])["handover"] == t_li.ETSIExporter.HI3


def test_auto_flush_self_heals_after_outage(certs, request):
    lea = _LEACollector(certs)
    request.addfinalizer(lea.close)
    lea.accepting = False
    sink = t_li.TLSDeliverySink("127.0.0.1", lea.port, _lea_cfg(PORT, certs),
                                reconnect_backoff_s=0.2)
    request.addfinalizer(sink.close)
    t_li.ETSIExporter(sink).deliver_iri(_record(t_li))
    assert sink.stats["delivered"] == 0
    lea.accepting = True  # the collector recovers; nobody calls flush()
    assert wait_until(lambda: sink.stats["delivered"] == 1, timeout=15.0)
    assert wait_until(lambda: len(lea.pdus) == 1, timeout=15.0)
