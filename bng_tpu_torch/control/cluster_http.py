"""Real HTTP/SSE transports for the distributed control plane.

The port's copy of `bng_tpu/control/cluster_http.py` (jax-free), its
imports renamed; the wire format is the reference's, so either package's
standby syncs from the other's active.

HA sync, peer pool and the Nexus allocator
had injectable-callable transports only — two `bng-tpu run` processes
could not talk. This module gives each its wire, stdlib-only (the
environment pins dependencies):

  server (ClusterServer, one listener per node):
    GET  /health                       liveness
    GET  /ha/sessions                  HA full sync  (pkg/ha/sync.go:231)
    GET  /ha/replay?since=N            HA delta replay (410 = gap, resync)
    GET  /ha/stream?since=N            HA SSE delta stream (sync.go:304)
    POST /pool/allocate {subscriber_id}   peer pool     (pkg/pool/peer.go:633)
    POST /pool/release  {subscriber_id}
    GET  /pool/get?subscriber_id=
    GET  /pool/status
    POST /crdt/digest                  CLSet anti-entropy (control/crdt.py)
    POST /crdt/entries {keys}
    POST /crdt/merge  {entries}
    POST /api/v1/allocate              Nexus allocator (nexus/http_allocator.go)
    GET  /api/v1/allocations/<id>
    DELETE /api/v1/allocations/<id>
    GET  /api/v1/pools

  client proxies, shaped exactly like the in-process objects the
  consumers already accept:
    HTTPActiveProxy   -> StandbySyncer transport   (full_sync/replay/subscribe)
    HTTPPeerProxy     -> PeerPool transport        (_allocate_local/.../status)
    HTTPStorePeer     -> DistributedStore.add_peer (digest/entries/merge)
    http_nexus_transport(url) -> HTTPAllocator transport callable

Every proxy raises ConnectionError on transport failure, which is the
signal the consumers' failover paths already handle (backoff reconnect,
ranked failover, skipped anti-entropy round).
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import ssl
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.parse import parse_qs, urlparse

from bng_tpu_torch.control.ha import ActiveSyncer, HAChange, SessionState
from bng_tpu_torch.control.ztp_tls import CertificateValidationError
from bng_tpu_torch.utils.structlog import ErrorLog
from bng_tpu_torch.control.peerpool import PeerPool, PeerPoolError

__all__ = [
    "ClusterServer", "HTTPActiveProxy", "HTTPPeerProxy", "HTTPStorePeer",
    "http_nexus_transport",
]

_TIMEOUT = 3.0


def _b64(v: bytes | None) -> str | None:
    return None if v is None else base64.b64encode(v).decode()


def _unb64(v: str | None) -> bytes | None:
    return None if v is None else base64.b64decode(v)


def _change_dict(ch: HAChange) -> dict:
    return {
        "op": ch.op, "seq": ch.seq, "session_id": ch.session_id,
        "session": ch.session.to_dict() if ch.session is not None else None,
    }


def _change_from(d: dict) -> HAChange:
    sess = d.get("session")
    return HAChange(d["op"],
                    session=SessionState.from_dict(sess) if sess else None,
                    session_id=d.get("session_id", ""), seq=d["seq"])


class ClusterServer:
    """One node's control-plane listener. Mount the services the node runs;
    unmounted paths 404. start() binds (port=0 picks a free port)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, tls=None):
        """tls: ztp_tls.ServerTLSConfig — the listener speaks TLS
        (+ mutual TLS when the config carries a client CA). Plaintext
        when None. Parity: pkg/ha/sync.go:151-185's TLS/mTLS modes on
        the session-replication wire."""
        self.host = host
        self.port = port
        self.tls = tls
        self.ha: ActiveSyncer | None = None
        self.pool: PeerPool | None = None
        self.store = None  # CLSetStore / DistributedStore
        self.allocator = None  # object with allocate/lookup/release/pool_info
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._closing = threading.Event()  # terminates live SSE streams

    # ---- service mounting ----
    def mount_ha(self, active: ActiveSyncer) -> "ClusterServer":
        self.ha = active
        return self

    def mount_pool(self, pool: PeerPool) -> "ClusterServer":
        self.pool = pool
        return self

    def mount_store(self, store) -> "ClusterServer":
        from bng_tpu_torch.control.crdt import DistributedStore

        self.store = store.store if isinstance(store, DistributedStore) else store
        return self

    def mount_allocator(self, allocator) -> "ClusterServer":
        """allocator: .allocate(subscriber_id, pool_hint) -> ip_str | None,
        .lookup(id) -> ip_str | None, .release(id) -> bool,
        .pool_info() -> dict."""
        self.allocator = allocator
        return self

    # ---- lifecycle ----
    def start(self) -> "ClusterServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            daemon_threads = True

            def log_message(self, *a):  # quiet
                pass

            # -- helpers --
            def _json(self, status: int, body: dict) -> None:
                data = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0) or 0)
                if n == 0:
                    return {}
                return json.loads(self.rfile.read(n) or b"{}")

            # -- routes --
            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                try:
                    if u.path == "/health":
                        return self._json(200, {"ok": True})
                    if u.path == "/ha/sessions" and outer.ha:
                        sessions, seq = outer.ha.full_sync()
                        return self._json(200, {
                            "sessions": [s.to_dict() for s in sessions],
                            "seq": seq})
                    if u.path == "/ha/replay" and outer.ha:
                        since = int(q.get("since", ["0"])[0])
                        replay = outer.ha.replay_since(since)
                        if replay is None:
                            return self._json(410, {"error": "gap"})
                        return self._json(200, {
                            "changes": [_change_dict(c) for c in replay]})
                    if u.path == "/ha/stream" and outer.ha:
                        return self._stream(int(q.get("since", ["0"])[0]))
                    if u.path == "/pool/get" and outer.pool:
                        # local-slice read only (peer.go /get): the CALLER
                        # does the owner-chasing; answering with pool.get()
                        # here could recurse across peers
                        sid = q.get("subscriber_id", [""])[0]
                        return self._json(
                            200, {"value": outer.pool.by_subscriber.get(sid)})
                    if u.path == "/pool/status" and outer.pool:
                        return self._json(200, outer.pool.status())
                    if u.path.startswith("/api/v1/allocations/") and outer.allocator:
                        ip = outer.allocator.lookup(u.path.rsplit("/", 1)[1])
                        if ip is None:
                            return self._json(404, {})
                        return self._json(200, {"ip": ip})
                    if u.path == "/api/v1/pools" and outer.allocator:
                        return self._json(200, outer.allocator.pool_info())
                    if (u.path.startswith("/api/v1/allocation-by-ip/")
                            and outer.allocator):
                        # heal-time conflict detection asks who the
                        # CENTRAL store thinks owns an IP
                        # (conflict_detector.go:121-233's central view)
                        fn = getattr(outer.allocator, "lookup_by_ip", None)
                        if fn is None:
                            return self._json(404, {})
                        got = fn(u.path.rsplit("/", 1)[1])
                        if got is None:
                            return self._json(404, {})
                        sid, at = got
                        return self._json(200, {"subscriber_id": sid,
                                                "allocated_at": at})
                    return self._json(404, {"error": "not found"})
                except BrokenPipeError:
                    raise
                except Exception as e:  # route errors become 500s, not crashes
                    return self._json(500, {"error": f"{type(e).__name__}: {e}"})

            def do_POST(self):
                u = urlparse(self.path)
                try:
                    body = self._body()
                    if u.path == "/pool/allocate" and outer.pool:
                        try:
                            ip = outer.pool._allocate_local(body["subscriber_id"])
                            return self._json(200, {"value": ip})
                        except PeerPoolError as e:
                            return self._json(409, {"error": str(e)})
                    if u.path == "/pool/release" and outer.pool:
                        ok = outer.pool._release_local(body["subscriber_id"])
                        return self._json(200, {"ok": ok})
                    if u.path == "/crdt/digest" and outer.store:
                        return self._json(200, {"digest": {
                            k: list(v) for k, v in outer.store.digest().items()}})
                    if u.path == "/crdt/entries" and outer.store:
                        ent = outer.store.entries_for(body.get("keys", []))
                        return self._json(200, {"entries": {
                            k: [cl, ts, node, _b64(val)]
                            for k, (cl, ts, node, val) in ent.items()}})
                    if u.path == "/crdt/merge" and outer.store:
                        entries = {
                            k: (cl, ts, node, _unb64(val))
                            for k, (cl, ts, node, val) in body.get("entries", {}).items()}
                        return self._json(200, {
                            "changed": outer.store.merge_entries(entries)})
                    if u.path == "/api/v1/allocate" and outer.allocator:
                        ip = outer.allocator.allocate(body.get("subscriber_id", ""),
                                                      body.get("pool", ""))
                        if ip is None:
                            return self._json(404, {})
                        return self._json(200, {"ip": ip})
                    return self._json(404, {"error": "not found"})
                except BrokenPipeError:
                    raise
                except Exception as e:
                    return self._json(500, {"error": f"{type(e).__name__}: {e}"})

            def do_DELETE(self):
                u = urlparse(self.path)
                try:
                    if u.path.startswith("/api/v1/allocations/") and outer.allocator:
                        ok = outer.allocator.release(u.path.rsplit("/", 1)[1])
                        return self._json(200 if ok else 404, {"ok": ok})
                    return self._json(404, {"error": "not found"})
                except Exception as e:
                    return self._json(500, {"error": f"{type(e).__name__}: {e}"})

            # -- SSE (sync.go:304 handleSessionStream) --
            def _stream(self, since: int) -> None:
                ha = outer.ha
                # ORDER MATTERS: subscribe FIRST, take the replay snapshot
                # SECOND. A delta pushed between the two lands in the live
                # queue (and possibly also in the replay); the seq filter
                # below dedups the overlap. Snapshot-then-subscribe would
                # silently lose exactly that window.
                ch_q: "queue.Queue[HAChange]" = queue.Queue(maxsize=4096)
                overflow = threading.Event()

                def enqueue(ch: HAChange) -> None:
                    # NEVER raise into the active's push_change: a stalled
                    # standby loses its stream (it will reconnect and
                    # resync), the active keeps serving
                    try:
                        ch_q.put_nowait(ch)
                    except queue.Full:
                        overflow.set()

                cancel = ha.subscribe(enqueue)
                # everything from here runs under the finally that cancels
                # the subscription — a client that dies during the header
                # write must not leak its callback on the active
                last_seq = since
                idle = 0.0
                try:
                    # always consult replay — even at since=0: a standby
                    # that full-synced a FRESH active (seq 0) must still
                    # receive deltas from the sync-to-connect window
                    replay = ha.replay_since(since)
                    if replay is None:
                        return self._json(410, {"error": "gap"})
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    for ch in replay or []:
                        self._emit(ch)
                        last_seq = max(last_seq, ch.seq)
                    # poll at 1s so server close() ends the stream promptly
                    # (shutdown() only stops the accept loop — live handler
                    # threads would otherwise hold their sockets open and
                    # standbys would never see the active die)
                    while not outer._closing.is_set() and not overflow.is_set():
                        try:
                            ch = ch_q.get(timeout=1.0)
                        except queue.Empty:
                            idle += 1.0
                            if idle >= 15.0:
                                self.wfile.write(b": keepalive\n\n")
                                self.wfile.flush()
                                idle = 0.0
                            continue
                        if ch.seq <= last_seq:
                            continue
                        self._emit(ch)
                        last_seq = ch.seq
                        idle = 0.0
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass  # client went away
                finally:
                    cancel()

            def _emit(self, ch: HAChange) -> None:
                data = json.dumps(_change_dict(ch))
                self.wfile.write(f"data: {data}\n\n".encode())
                self.wfile.flush()

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        if self.tls is not None:
            from bng_tpu_torch.control.ztp_tls import build_server_ssl_context

            ctx = build_server_ssl_context(self.tls)
            # handshake OFF the accept loop: with do_handshake_on_connect
            # a half-open client (no ClientHello) would block accept()
            # forever and wedge the whole control plane; deferred, the
            # handshake runs in the per-connection handler thread on the
            # first read (ThreadingHTTPServer), one thread per client
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name=f"cluster-http-{self.port}")
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        scheme = "https" if self.tls is not None else "http"
        return f"{scheme}://{self.host}:{self.port}"

    def close(self) -> None:
        self._closing.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


# ---------------------------------------------------------------------------
# client-side proxies
# ---------------------------------------------------------------------------
def _make_pinned_https_connection(tls_cfg, ssl_ctx):
    """An http.client.HTTPSConnection subclass whose connect() runs
    ztp_tls verification on the presented chain BEFORE any request bytes
    are sent (the VerifyPeerCertificate role, tls.go:208-275) and
    performs SNI against cfg.server_name when set (peer dialed by IP,
    cert names a host)."""
    import http.client
    import socket as _socket

    from bng_tpu_torch.control.ztp_tls import verify_wrapped_socket

    class Conn(http.client.HTTPSConnection):
        def connect(self):
            sock = _socket.create_connection(
                (self.host, self.port), self.timeout)
            if self._tunnel_host:  # pragma: no cover — no proxies here
                self.sock = sock
                self._tunnel()
                sock = self.sock
            sn = tls_cfg.server_name or self.host
            self.sock = ssl_ctx.wrap_socket(sock, server_hostname=sn)
            verify_wrapped_socket(self.sock, tls_cfg)  # raises pre-request

    return Conn


def make_cluster_opener(tls_cfg) -> "urllib.request.OpenerDirector":
    """An urllib opener whose https connections enforce the cluster TLS
    config (pinning + optional mTLS client identity). Used for every
    proxy request AND the SSE stream, so no wire path escapes the
    verification."""
    from bng_tpu_torch.control.ztp_tls import build_ssl_context

    ctx = build_ssl_context(tls_cfg)
    conn_cls = _make_pinned_https_connection(tls_cfg, ctx)

    class Handler(urllib.request.HTTPSHandler):
        def https_open(self, req):
            return self.do_open(conn_cls, req)

    return urllib.request.build_opener(Handler())


def _req(method: str, url: str, body: dict | None = None,
         timeout: float = _TIMEOUT, opener=None) -> tuple[int, dict]:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    open_ = opener.open if opener is not None else urllib.request.urlopen
    try:
        with open_(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read() or b"{}")
        except Exception:
            return e.code, {}
    except CertificateValidationError:
        # already a ConnectionError (by design) AND carries the why —
        # don't flatten it into a generic transport failure
        raise
    except (urllib.error.URLError, TimeoutError, ConnectionError, OSError,
            ssl.SSLError) as e:
        # urllib wraps OSError-derived refusals (CertificateValidation-
        # Error included) into URLError(reason=...): unwrap so the why
        # survives to callers that assert on it
        reason = getattr(e, "reason", None)
        if isinstance(reason, CertificateValidationError):
            raise reason
        raise ConnectionError(f"{method} {url}: {e}") from e


class HTTPActiveProxy:
    """StandbySyncer transport target: the active node over HTTP+SSE.

    full_sync/replay_since are plain GETs; subscribe() opens the SSE
    stream in a reader thread and invokes the callback per delta. When
    the stream drops, on_stream_end fires (wire it to standby.disconnect
    so the tick loop reconnects with backoff)."""

    def __init__(self, url: str, on_stream_end: Callable[[], None] | None = None,
                 tls=None):
        """tls: ztp_tls.TLSConfig — verify (and pin) the active's cert on
        every request including the SSE stream; carries our client
        identity when the active demands mTLS."""
        self.url = url.rstrip("/")
        self.on_stream_end = on_stream_end
        self._opener = make_cluster_opener(tls) if tls is not None else None
        self._stream_err_log = ErrorLog(
            "cluster", "SSE stream died; standby will reconnect")
        self._seen_seq = 0  # high-water mark from full_sync/replay_since
        # fail fast like an in-process transport: unreachable = raise now
        status, _ = self._req("GET", f"{self.url}/health")
        if status != 200:
            raise ConnectionError(f"active unhealthy: {status}")

    def _req(self, method, url, body=None, timeout=_TIMEOUT):
        return _req(method, url, body, timeout, opener=self._opener)

    def full_sync(self):
        status, body = self._req("GET", f"{self.url}/ha/sessions")
        if status != 200:
            raise ConnectionError(f"full_sync {status}")
        self._seen_seq = body["seq"]
        return ([SessionState.from_dict(d) for d in body["sessions"]], body["seq"])

    def replay_since(self, seq: int):
        status, body = self._req("GET", f"{self.url}/ha/replay?since={seq}")
        if status == 410:
            return None
        if status != 200:
            raise ConnectionError(f"replay {status}")
        changes = [_change_from(d) for d in body["changes"]]
        self._seen_seq = max([seq] + [c.seq for c in changes])
        return changes

    def subscribe(self, cb: Callable[[HAChange], None]) -> Callable[[], None]:
        stop = threading.Event()
        since = self._seen_seq

        def reader():
            from bng_tpu_torch.analysis.sanitize import ctx_enter

            ctx_enter("ha-sync")
            try:
                # since = the snapshot's high-water seq: the server replays
                # anything newer into the stream, so the window between the
                # sync GET and this connect cannot drop deltas
                req = urllib.request.Request(f"{self.url}/ha/stream?since={since}")
                open_ = (self._opener.open if self._opener is not None
                         else urllib.request.urlopen)
                with open_(req, timeout=60.0) as r:
                    for raw in r:
                        if stop.is_set():
                            return
                        line = raw.decode().strip()
                        if line.startswith("data: "):
                            cb(_change_from(json.loads(line[6:])))
            except Exception as e:  # noqa: BLE001 — any stream failure
                # means reconnect; the reason still matters (TLS reject
                # vs timeout vs bad payload diagnose very differently)
                self._stream_err_log.report(e, since=since)
            finally:
                if not stop.is_set() and self.on_stream_end is not None:
                    self.on_stream_end()

        t = threading.Thread(target=reader, daemon=True, name="ha-sse-reader")
        t.start()

        def cancel():
            stop.set()

        return cancel


class _RemoteBySubscriber:
    """Read-only mapping shim: PeerPool.get() reads
    `transport(node).by_subscriber.get(sid)` on the in-process transport;
    over HTTP that dict access becomes one GET."""

    def __init__(self, proxy: "HTTPPeerProxy"):
        self._proxy = proxy

    def get(self, subscriber_id: str):
        return self._proxy.get(subscriber_id)


class HTTPPeerProxy:
    """PeerPool transport target: a remote peer's local pool slice."""

    def __init__(self, url: str, tls=None):
        self.url = url.rstrip("/")
        self._opener = make_cluster_opener(tls) if tls is not None else None
        self.by_subscriber = _RemoteBySubscriber(self)

    def _req(self, method, url, body=None, timeout=_TIMEOUT):
        return _req(method, url, body, timeout, opener=self._opener)

    def _allocate_local(self, subscriber_id: str) -> int:
        status, body = self._req("POST", f"{self.url}/pool/allocate",
                            {"subscriber_id": subscriber_id})
        if status == 200:
            return body["value"]
        if status == 409:
            raise PeerPoolError(body.get("error", "allocate failed"))
        raise ConnectionError(f"allocate {status}")

    def _release_local(self, subscriber_id: str) -> bool:
        status, body = self._req("POST", f"{self.url}/pool/release",
                            {"subscriber_id": subscriber_id})
        if status != 200:
            raise ConnectionError(f"release {status}")
        return body["ok"]

    def get(self, subscriber_id: str):
        # ids are free-form operator strings (circuit IDs etc.) — quote them
        sid = urllib.parse.quote(subscriber_id, safe="")
        status, body = self._req("GET", f"{self.url}/pool/get?subscriber_id={sid}")
        if status != 200:
            raise ConnectionError(f"get {status}")
        return body["value"]

    def status(self) -> dict:
        status, body = self._req("GET", f"{self.url}/pool/status")
        if status != 200:
            raise ConnectionError(f"status {status}")
        return body


class HTTPStorePeer:
    """DistributedStore.add_peer target: remote CLSet over HTTP."""

    def __init__(self, url: str, tls=None):
        self.url = url.rstrip("/")
        self._opener = make_cluster_opener(tls) if tls is not None else None

    def _req(self, method, url, body=None, timeout=_TIMEOUT):
        return _req(method, url, body, timeout, opener=self._opener)

    def digest(self):
        status, body = self._req("POST", f"{self.url}/crdt/digest", {})
        if status != 200:
            raise ConnectionError(f"digest {status}")
        return {k: tuple(v) for k, v in body["digest"].items()}

    def entries_for(self, keys):
        status, body = self._req("POST", f"{self.url}/crdt/entries",
                            {"keys": list(keys)})
        if status != 200:
            raise ConnectionError(f"entries {status}")
        return {k: (cl, ts, node, _unb64(val))
                for k, (cl, ts, node, val) in body["entries"].items()}

    def merge_entries(self, entries) -> int:
        wire = {k: [cl, ts, node, _b64(val)]
                for k, (cl, ts, node, val) in entries.items()}
        status, body = self._req("POST", f"{self.url}/crdt/merge", {"entries": wire})
        if status != 200:
            raise ConnectionError(f"merge {status}")
        return body["changed"]


def http_nexus_transport(url: str, tls=None) -> Callable:
    """HTTPAllocator-shaped transport: (method, path, body) -> (status, body)."""
    base = url.rstrip("/")
    opener = make_cluster_opener(tls) if tls is not None else None

    def transport(method: str, path: str, body: dict | None):
        return _req(method, f"{base}{path}", body, opener=opener)

    return transport
