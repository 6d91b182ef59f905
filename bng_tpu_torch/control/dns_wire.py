"""DNS wire transport: message codec, UDP upstream forwarder, UDP server.

The port's copy of `bng_tpu/control/dns_wire.py` (jax-free).

The network half of control/dns.py: the reference forwards queries over
the network and serves subscribers (pkg/dns/resolver.go:116-210 — forward
at :173-186), where the resolver alone is a library with an injectable
forwarder and no socket. This module supplies:

- a compact DNS message codec (header/question/A/AAAA/CNAME answers,
  compression-pointer-safe parsing with a bounded jump count — the same
  bounded-walk discipline the fast-path parsers use);
- ``UDPForwarder``: ``Callable[[Query], Response]`` over UDP with
  per-upstream timeout and multi-upstream failover, drop-in for
  ``Resolver(forwarder=...)`` (parity: resolver.go:173-186, upstream
  rotation on failure);
- ``DNSServer``: a UDP listener serving ``Resolver`` to subscribers —
  the walled-garden answer path end-to-end (query in, portal IP out).

Everything is real-socket but loopback-testable: the tests run a fake
upstream on 127.0.0.1 and resolve through the full stack.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

from bng_tpu_torch.control.dns import (
    CLASS_IN,
    RCODE_NAME_ERROR,
    RCODE_SERVER_FAILURE,
    RCODE_SUCCESS,
    Query,
    Record,
    Resolver,
    Response,
    TYPE_A,
    TYPE_AAAA,
    TYPE_CNAME,
    TYPE_MX,
    TYPE_NS,
    TYPE_PTR,
    TYPE_SRV,
)

MAX_NAME_JUMPS = 16  # bounded compression-pointer walk (loop safety)
MAX_UDP = 4096


class WireError(ValueError):
    pass


# ---------------------------------------------------------------------------
# names
# ---------------------------------------------------------------------------

def _encode_name(name: str) -> bytes:
    out = bytearray()
    for label in name.rstrip(".").split("."):
        if not label:
            continue
        raw = label.encode("idna") if not label.isascii() else label.encode()
        if len(raw) > 63:
            raise WireError(f"label too long: {label!r}")
        out.append(len(raw))
        out += raw
    out.append(0)
    return bytes(out)


def _decode_name(data: bytes, off: int) -> tuple[str, int]:
    """Returns (name, next_offset). Follows compression pointers with a
    bounded jump count; next_offset is past the FIRST pointer (or the
    terminating zero when uncompressed)."""
    labels = []
    jumps = 0
    next_off = None  # set at the first pointer
    while True:
        if off >= len(data):
            raise WireError("name runs past buffer")
        length = data[off]
        if length & 0xC0 == 0xC0:  # pointer
            if off + 2 > len(data):
                raise WireError("truncated pointer")
            if next_off is None:
                next_off = off + 2
            off = ((length & 0x3F) << 8) | data[off + 1]
            jumps += 1
            if jumps > MAX_NAME_JUMPS:
                raise WireError("compression loop")
            continue
        if length > 63:
            raise WireError("bad label length")
        off += 1
        if length == 0:
            break
        if off + length > len(data):
            raise WireError("label runs past buffer")
        labels.append(data[off : off + length].decode("ascii", "replace"))
        off += length
    return ".".join(labels), (next_off if next_off is not None else off)


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

def encode_query(query: Query, txid: int, recursion_desired: bool = True) -> bytes:
    flags = 0x0100 if recursion_desired else 0
    hdr = struct.pack("!HHHHHH", txid, flags, 1, 0, 0, 0)
    return hdr + _encode_name(query.name) + struct.pack(
        "!HH", query.qtype, query.qclass)


def decode_query(data: bytes) -> tuple[int, Query]:
    if len(data) < 12:
        raise WireError("short header")
    txid, flags, qd, _an, _ns, _ar = struct.unpack("!HHHHHH", data[:12])
    if flags & 0x8000:
        raise WireError("not a query")
    if qd < 1:
        raise WireError("no question")
    name, off = _decode_name(data, 12)
    if off + 4 > len(data):
        raise WireError("truncated question")
    qtype, qclass = struct.unpack("!HH", data[off : off + 4])
    return txid, Query(name=name, qtype=qtype, qclass=qclass)


def _encodable(rec: Record) -> bool:
    if rec.rtype == TYPE_A:
        return bool(rec.ipv4)
    if rec.rtype == TYPE_AAAA:
        return bool(rec.ipv6)
    if rec.rtype in (TYPE_CNAME, TYPE_NS, TYPE_PTR):
        return bool(rec.target)
    return bool(rec.rdata)


def _encode_record(rec: Record) -> bytes:
    if rec.rtype == TYPE_A:
        rdata = socket.inet_aton(rec.ipv4)
    elif rec.rtype == TYPE_AAAA:
        rdata = socket.inet_pton(socket.AF_INET6, rec.ipv6)
    elif rec.rtype in (TYPE_CNAME, TYPE_NS, TYPE_PTR):
        rdata = _encode_name(rec.target)
    elif rec.rdata:
        # decompressed verbatim rdata captured by decode_response (TXT,
        # MX, SRV, ...) — re-emitted as-is
        rdata = rec.rdata
    else:
        raise WireError(f"unsupported rtype {rec.rtype}")
    return (_encode_name(rec.name)
            + struct.pack("!HHIH", rec.rtype, rec.rclass, rec.ttl, len(rdata))
            + rdata)


def encode_response(resp: Response, txid: int) -> bytes:
    # QR=1, RD+RA set (we are a recursive forwarder), rcode in low bits
    flags = 0x8180 | (resp.rcode & 0xF)
    answers = [r for r in resp.answers if _encodable(r)]
    hdr = struct.pack("!HHHHHH", txid, flags, 1, len(answers), 0, 0)
    body = _encode_name(resp.query.name) + struct.pack(
        "!HH", resp.query.qtype, resp.query.qclass)
    for rec in answers:
        body += _encode_record(rec)
    return hdr + body


def decode_response(data: bytes) -> tuple[int, Query, Response]:
    if len(data) < 12:
        raise WireError("short header")
    txid, flags, qd, an, _ns, _ar = struct.unpack("!HHHHHH", data[:12])
    if not flags & 0x8000:
        raise WireError("not a response")
    rcode = flags & 0xF
    off = 12
    name, qtype, qclass = "", TYPE_A, CLASS_IN
    for _ in range(qd):
        name, off = _decode_name(data, off)
        if off + 4 > len(data):
            raise WireError("truncated question")
        qtype, qclass = struct.unpack("!HH", data[off : off + 4])
        off += 4
    query = Query(name=name, qtype=qtype, qclass=qclass)
    answers = []
    for _ in range(an):
        rname, off = _decode_name(data, off)
        if off + 10 > len(data):
            raise WireError("truncated answer")
        rtype, rclass, ttl, rdlen = struct.unpack("!HHIH", data[off : off + 10])
        off += 10
        if off + rdlen > len(data):
            raise WireError("rdata runs past buffer")
        rdata = data[off : off + rdlen]
        rec = Record(name=rname, rtype=rtype, rclass=rclass, ttl=ttl)
        if rtype == TYPE_A and rdlen == 4:
            rec.ipv4 = socket.inet_ntoa(rdata)
        elif rtype == TYPE_AAAA and rdlen == 16:
            rec.ipv6 = socket.inet_ntop(socket.AF_INET6, rdata)
        elif rtype in (TYPE_CNAME, TYPE_NS, TYPE_PTR):
            rec.target, _ = _decode_name(data, off)
        elif rtype == TYPE_MX and rdlen >= 3:
            # preference + exchange name: decompress so the copy can be
            # re-emitted outside the original message
            name, _ = _decode_name(data, off + 2)
            rec.rdata = rdata[:2] + _encode_name(name)
        elif rtype == TYPE_SRV and rdlen >= 7:
            name, _ = _decode_name(data, off + 6)
            rec.rdata = rdata[:6] + _encode_name(name)
        else:
            # name-free rdata (TXT, A6, CAA, ...) is position-independent
            # and passes through verbatim. (Name-bearing types beyond the
            # handled set — e.g. SOA in an answer section — would need
            # their own decompression; they are not served to subscribers
            # by this forwarder.)
            rec.rdata = rdata
        answers.append(rec)
        off += rdlen
    return txid, query, Response(query=query, answers=answers, rcode=rcode)


# ---------------------------------------------------------------------------
# upstream forwarder
# ---------------------------------------------------------------------------

class UDPForwarder:
    """Default upstream forwarder: UDP query with timeout + failover.

    Parity: resolver.go:173-186 — try each configured upstream in order,
    per-upstream timeout, first good answer wins; every upstream failing
    raises (the resolver maps that to SERVFAIL). Transaction IDs are
    random per query and verified on the reply, and replies are received
    on a connected socket so only the queried upstream can answer."""

    def __init__(self, upstreams: list[str], timeout: float = 2.0):
        if not upstreams:
            raise ValueError("need at least one upstream")
        self.upstreams = [self._parse(u) for u in upstreams]
        self.timeout = timeout
        self.stats = {"sent": 0, "failovers": 0, "timeouts": 0}

    @staticmethod
    def _parse(u: str) -> tuple[str, int]:
        host, _, port = u.partition(":")
        return host, int(port or 53)

    def __call__(self, query: Query) -> Response:
        last_err: Exception | None = None
        for i, addr in enumerate(self.upstreams):
            if i:
                self.stats["failovers"] += 1
            txid = int.from_bytes(os.urandom(2), "big")
            pkt = encode_query(query, txid)
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                s.settimeout(self.timeout)
                s.connect(addr)  # replies restricted to this upstream
                s.send(pkt)
                self.stats["sent"] += 1
                # per-upstream DEADLINE (advisor r4): re-arming the full
                # timeout per stale reply would let a mismatch flood hold
                # this upstream far past its budget
                deadline = time.monotonic() + self.timeout
                while True:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(f"upstream {addr} deadline")
                    s.settimeout(remaining)
                    data = s.recv(MAX_UDP)
                    try:
                        rtxid, rq, resp = decode_response(data)
                    except WireError:
                        # an UNDECODABLE datagram is the same off-path
                        # noise as a wrong txid: keep waiting for the
                        # real answer, don't abandon a live upstream
                        continue
                    if rtxid != txid:
                        continue  # stale/spoofed id: keep waiting
                    # the echoed question must match what we asked
                    # (RFC 5452 §4.2 entropy checks: id AND question;
                    # a qdcount=0 reply decodes to name="" and fails here)
                    if (rq.name.rstrip(".").lower()
                            != query.name.rstrip(".").lower()
                            or rq.qtype != query.qtype):
                        continue
                    resp.query = query
                    return resp
            except (TimeoutError, socket.timeout) as e:
                self.stats["timeouts"] += 1
                last_err = e
            except (OSError, WireError) as e:
                last_err = e
            finally:
                s.close()
        raise RuntimeError(f"all upstreams failed: {last_err!r}")


# ---------------------------------------------------------------------------
# UDP server
# ---------------------------------------------------------------------------

class DNSServer:
    """UDP listener serving a Resolver to subscribers.

    Receive loop on one thread; resolution runs on a bounded worker pool
    so a slow upstream head-of-line blocks ONE query, not every
    subscriber's DNS (cache hits and garden answers stay fast while a
    cache miss waits on the wire). Saturation drops queries (counted) —
    DNS clients retry, and a bounded drop beats an unbounded queue.
    The client's source IP becomes Query.source so walled-garden and
    rate-limit policy apply per subscriber. Close via stop(). Malformed
    packets are dropped (counted), resolver errors answer SERVFAIL — the
    listener must never die to a bad packet."""

    def __init__(self, resolver: Resolver, host: str = "0.0.0.0",
                 port: int = 53, workers: int = 8,
                 max_inflight: int = 256):
        import concurrent.futures

        self.resolver = resolver
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.addr = self.sock.getsockname()
        self.stats = {"served": 0, "bad_packets": 0, "server_errors": 0,
                      "overloaded": 0}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="bng-dns-worker")
        self._inflight = threading.BoundedSemaphore(max_inflight)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="bng-dns-udp")
        self._thread.start()

    def _serve(self) -> None:
        self.sock.settimeout(0.25)
        while not self._stop.is_set():
            try:
                data, client = self.sock.recvfrom(MAX_UDP)
            except (TimeoutError, socket.timeout):
                continue
            except OSError:
                break
            try:
                txid, query = decode_query(data)
            except WireError:
                self.stats["bad_packets"] += 1
                continue
            query.source = client[0]
            if not self._inflight.acquire(blocking=False):
                self.stats["overloaded"] += 1
                continue
            try:
                self._pool.submit(self._answer, txid, query, client)
            except RuntimeError:  # pool shut down mid-stop
                self._inflight.release()
                break

    def _answer(self, txid: int, query: Query, client) -> None:
        try:
            try:
                resp = self.resolver.resolve(query)
            except Exception:  # resolver bug must not kill the worker
                self.stats["server_errors"] += 1
                resp = Response(query=query, rcode=RCODE_SERVER_FAILURE)
            try:
                self.sock.sendto(encode_response(resp, txid), client)
                self.stats["served"] += 1
            except (OSError, WireError):
                self.stats["server_errors"] += 1
        finally:
            self._inflight.release()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._pool.shutdown(wait=False)
        self.sock.close()


__all__ = [
    "DNSServer",
    "UDPForwarder",
    "WireError",
    "decode_query",
    "decode_response",
    "encode_query",
    "encode_response",
    "RCODE_NAME_ERROR",
    "RCODE_SUCCESS",
]
