"""ZTP TLS hardening: cert pinning, expiry checks, chain validation.

The port's copy of `bng_tpu/control/ztp_tls.py` (jax-free), its imports
renamed.

Parity: pkg/ztp/tls.go:20-527 — the reference's bootstrap
client authenticates Nexus with CA validation, SHA-256 certificate
pinning (TOFU for bootstrap, where no CA is provisioned yet), minimum TLS
version, chain checks, and expiry warnings. This is the build's
equivalent for control/ztp.py's BootstrapClient.

Implementation notes (Python stdlib only — no `cryptography` package in
the image):
- ``build_ssl_context`` maps the config onto ``ssl.SSLContext`` (CA file/
  PEM, min version, hostname handling).
- Pinning and expiry run POST-handshake on the peer's DER cert
  (``verify_peer``): Python's ssl module has no per-cert verify hook, so
  the transport calls ``verify_peer`` after connecting and aborts on
  mismatch — the same enforcement point as tls.go's
  VerifyPeerCertificate callback (tls.go:208-229).
- Certificate fields (serial, validity, subject/issuer CN, SAN, isCA)
  come from a minimal DER/ASN.1 walker (``parse_certificate``): X.509's
  TBSCertificate layout is fixed, and the walker is bounds-checked and
  fuzz-tested like every other parser in this codebase.
"""

from __future__ import annotations

import hashlib
import ssl
from dataclasses import dataclass, field
from datetime import datetime, timezone
from urllib.parse import urlparse


# ---------------------------------------------------------------------------
# config (tls.go:20-71)
# ---------------------------------------------------------------------------

@dataclass
class TLSConfig:
    enabled: bool = True
    ca_cert_file: str = ""
    ca_cert_pem: str = ""
    pinned_certs: list[str] = field(default_factory=list)  # hex SHA256 of DER
    server_name: str = ""
    min_version: str = "1.2"  # "1.2" | "1.3"
    insecure_skip_verify: bool = False
    cert_expiry_warning_days: int = 30
    require_valid_chain: bool = True
    # our client identity, presented when the server demands mTLS
    # (sync.go:151-185's mutual-TLS mode on the HA wire)
    client_cert_file: str = ""
    client_key_file: str = ""


@dataclass
class ServerTLSConfig:
    """Listener-side TLS (the sync.go:151-185 server role): cert/key to
    present; set client_ca_* to REQUIRE verified client certificates
    (mutual TLS). Used by control.cluster_http.ClusterServer."""

    cert_file: str = ""
    key_file: str = ""
    client_ca_file: str = ""
    client_ca_pem: str = ""
    min_version: str = "1.2"


def build_server_ssl_context(cfg: ServerTLSConfig) -> ssl.SSLContext:
    if not cfg.cert_file or not cfg.key_file:
        raise ValueError("server TLS needs cert_file and key_file")
    if cfg.min_version not in ("1.2", "1.3"):
        raise ValueError(f"min_version {cfg.min_version!r}: expected 1.2/1.3")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = (ssl.TLSVersion.TLSv1_3 if cfg.min_version == "1.3"
                           else ssl.TLSVersion.TLSv1_2)
    ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    if cfg.client_ca_file or cfg.client_ca_pem:
        if cfg.client_ca_pem:
            ctx.load_verify_locations(cadata=cfg.client_ca_pem)
        else:
            ctx.load_verify_locations(cafile=cfg.client_ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


class CertificateValidationError(ConnectionError):
    # A ConnectionError subclass ON PURPOSE: a pin/validity refusal is a
    # failed connection to every failover path (HA standby backoff, peer
    # pool ranking, CRDT round skip) — the node stays up and retries,
    # while callers that care about the WHY can still catch this type.

    def __init__(self, reason: str, subject: str = "", underlying=None):
        self.reason = reason
        self.subject = subject
        self.underlying = underlying
        msg = (f"certificate validation failed for {subject}: {reason}"
               if subject else f"certificate validation failed: {reason}")
        super().__init__(msg)


@dataclass
class CertificateInfo:
    subject: str = ""
    issuer: str = ""
    serial_number: str = ""
    not_before: datetime | None = None
    not_after: datetime | None = None
    fingerprint: str = ""
    is_ca: bool = False
    dns_names: list[str] = field(default_factory=list)
    ip_addresses: list[str] = field(default_factory=list)


@dataclass
class TLSValidationResult:
    valid: bool = False
    server_name: str = ""
    certificate_chain: list[CertificateInfo] = field(default_factory=list)
    pinning_verified: bool = False
    warnings: list[str] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)


def validate_tls_config(cfg: TLSConfig) -> None:
    """Config sanity (tls.go:277-315): reject contradictory settings
    before they silently weaken the connection."""
    if not cfg.enabled:
        return
    if cfg.min_version not in ("1.2", "1.3"):
        raise ValueError(f"min_version {cfg.min_version!r}: expected 1.2/1.3")
    if cfg.insecure_skip_verify and cfg.pinned_certs:
        raise ValueError(
            "insecure_skip_verify with pinned_certs: pinning implies you "
            "want verification — pick one")
    if not cfg.require_valid_chain and not cfg.pinned_certs:
        raise ValueError(
            "require_valid_chain=false needs pinned_certs: a self-signed "
            "cert with no pin authenticates nobody")
    for fp in cfg.pinned_certs:
        n = normalize_fingerprint(fp)
        if len(n) != 64 or any(c not in "0123456789abcdef" for c in n):
            raise ValueError(f"pinned cert {fp!r} is not a hex SHA-256")


# ---------------------------------------------------------------------------
# fingerprints (tls.go:466-506)
# ---------------------------------------------------------------------------

def normalize_fingerprint(fp: str) -> str:
    return fp.replace(":", "").replace(" ", "").lower()


def cert_fingerprint(der: bytes) -> str:
    """Hex SHA-256 of the DER-encoded certificate (tls.go:487-501)."""
    return hashlib.sha256(der).hexdigest()


def pem_to_der(pem: str | bytes) -> list[bytes]:
    """All certificates in a PEM bundle, DER-decoded."""
    import base64

    text = pem.decode() if isinstance(pem, bytes) else pem
    ders = []
    lines: list[str] | None = None
    for line in text.splitlines():
        line = line.strip()
        if line == "-----BEGIN CERTIFICATE-----":
            lines = []
        elif line == "-----END CERTIFICATE-----":
            if lines is not None:
                ders.append(base64.b64decode("".join(lines)))
            lines = None
        elif lines is not None:
            lines.append(line)
    return ders


# ---------------------------------------------------------------------------
# minimal DER/X.509 parser (bounds-checked; fuzz-tested)
# ---------------------------------------------------------------------------

class _Der:
    def __init__(self, data: bytes, off: int = 0, end: int | None = None):
        self.d = data
        self.off = off
        self.end = len(data) if end is None else end

    def _tlv(self) -> tuple[int, int, int]:
        """Returns (tag, content_start, content_end); advances nothing."""
        d, i = self.d, self.off
        if i + 2 > self.end:
            raise ValueError("DER: truncated TLV")
        tag = d[i]
        ln = d[i + 1]
        i += 2
        if ln & 0x80:
            n = ln & 0x7F
            if n == 0 or n > 4 or i + n > self.end:
                raise ValueError("DER: bad long-form length")
            ln = int.from_bytes(d[i : i + n], "big")
            i += n
        if i + ln > self.end:
            raise ValueError("DER: content past end")
        return tag, i, i + ln

    def next(self) -> tuple[int, "_Der"]:
        tag, start, end = self._tlv()
        inner = _Der(self.d, start, end)
        self.off = end
        return tag, inner

    def skip(self) -> None:
        _, _, end = self._tlv()
        self.off = end

    def bytes(self) -> bytes:
        return self.d[self.off : self.end]

    def has_more(self) -> bool:
        return self.off < self.end


_OID_CN = bytes.fromhex("550403")  # 2.5.4.3
_OID_BASIC_CONSTRAINTS = bytes.fromhex("551d13")  # 2.5.29.19
_OID_SAN = bytes.fromhex("551d11")  # 2.5.29.17


def _parse_time(tag: int, content: bytes) -> datetime:
    s = content.decode("ascii", "replace")
    if tag == 0x17:  # UTCTime YYMMDDHHMMSSZ
        year = int(s[:2])
        year += 2000 if year < 50 else 1900
        s = f"{year}{s[2:]}"
    return datetime.strptime(s.rstrip("Z"), "%Y%m%d%H%M%S").replace(
        tzinfo=timezone.utc)


def _parse_name(name: _Der) -> str:
    """RDNSequence -> 'CN=x' (CN only; enough for logs/pins)."""
    cn = ""
    while name.has_more():
        tag, rdn_set = name.next()  # SET
        if tag != 0x31:
            continue
        while rdn_set.has_more():
            tag, atv = rdn_set.next()  # SEQ { OID, value }
            if tag != 0x30:
                continue
            tag, oid = atv.next()
            if tag == 0x06 and oid.bytes() == _OID_CN and atv.has_more():
                _, val = atv.next()
                cn = val.bytes().decode("utf-8", "replace")
    return f"CN={cn}" if cn else ""


def parse_certificate(der: bytes) -> CertificateInfo:
    """Extract the fields tls.go's CertificateInfo carries (tls.go:94-105)."""
    info = CertificateInfo(fingerprint=cert_fingerprint(der))
    tag, cert = _Der(der).next()  # Certificate SEQ
    if tag != 0x30:
        raise ValueError("X.509: not a SEQUENCE")
    tag, tbs = cert.next()  # TBSCertificate SEQ
    if tag != 0x30:
        raise ValueError("X.509: bad TBSCertificate")
    # [0] version (optional)
    t, start, end = tbs._tlv()
    if t == 0xA0:
        tbs.off = end
    # serialNumber INTEGER
    tag, serial = tbs.next()
    if tag == 0x02:
        info.serial_number = serial.bytes().hex()
    tbs.skip()  # signature AlgorithmIdentifier
    tag, issuer = tbs.next()
    info.issuer = _parse_name(issuer)
    tag, validity = tbs.next()  # SEQ { notBefore, notAfter }
    t1, nb = validity.next()
    info.not_before = _parse_time(t1, nb.bytes())
    t2, na = validity.next()
    info.not_after = _parse_time(t2, na.bytes())
    tag, subject = tbs.next()
    info.subject = _parse_name(subject)
    tbs.skip()  # SubjectPublicKeyInfo
    # optional [1]/[2] unique ids, then [3] extensions
    while tbs.has_more():
        t, ext_wrap = tbs.next()
        if t != 0xA3:
            continue
        _, exts = ext_wrap.next()  # SEQ OF Extension
        while exts.has_more():
            _, ext = exts.next()  # SEQ { oid, [critical], OCTET STRING }
            t, oid = ext.next()
            if t != 0x06:
                continue
            t, nxt = ext.next()
            if t == 0x01 and ext.has_more():  # critical BOOLEAN: skip
                t, nxt = ext.next()
            if t != 0x04:
                continue
            body = _Der(nxt.bytes())
            if oid.bytes() == _OID_BASIC_CONSTRAINTS:
                t, bc = body.next()  # SEQ { [cA BOOLEAN], ... }
                if t == 0x30 and bc.has_more():
                    t, ca = bc.next()
                    info.is_ca = (t == 0x01 and ca.bytes() != b"\x00"
                                  and len(ca.bytes()) > 0)
            elif oid.bytes() == _OID_SAN:
                t, names = body.next()  # SEQ OF GeneralName
                if t == 0x30:
                    while names.has_more():
                        t, gn = names.next()
                        if t == 0x82:  # dNSName [2] IA5String
                            info.dns_names.append(
                                gn.bytes().decode("ascii", "replace"))
                        elif t == 0x87:  # iPAddress [7]
                            b = gn.bytes()
                            if len(b) == 4:
                                info.ip_addresses.append(
                                    ".".join(str(x) for x in b))
    return info


# ---------------------------------------------------------------------------
# validation (tls.go:208-275, 317-464, 508-522)
# ---------------------------------------------------------------------------

def is_certificate_expiring_soon(der: bytes, within_days: float,
                                 now: datetime | None = None
                                 ) -> tuple[bool, float]:
    """(expiring, remaining_days) — tls.go:508-522."""
    info = parse_certificate(der)
    now = now or datetime.now(timezone.utc)
    remaining = (info.not_after - now).total_seconds() / 86400.0
    return remaining <= within_days, remaining


def verify_peer(der_chain: list[bytes], cfg: TLSConfig,
                now: datetime | None = None) -> TLSValidationResult:
    """Post-handshake verification: pinning + validity window + expiry
    warnings over the presented chain (the VerifyPeerCertificate role,
    tls.go:208-275). Raises CertificateValidationError on failure,
    returns the result (with warnings) on success."""
    res = TLSValidationResult(server_name=cfg.server_name)
    if not der_chain:
        raise CertificateValidationError("no peer certificates presented")
    now = now or datetime.now(timezone.utc)
    for der in der_chain:
        try:
            res.certificate_chain.append(parse_certificate(der))
        except ValueError as e:
            raise CertificateValidationError(
                f"unparseable certificate: {e}") from e

    leaf = res.certificate_chain[0]
    if cfg.pinned_certs:
        pins = {normalize_fingerprint(p) for p in cfg.pinned_certs}
        chain_fps = {c.fingerprint for c in res.certificate_chain}
        if not (pins & chain_fps):
            raise CertificateValidationError(
                "no presented certificate matches a pinned fingerprint",
                subject=leaf.subject)
        res.pinning_verified = True

    for info in res.certificate_chain:
        if info.not_before and now < info.not_before:
            raise CertificateValidationError(
                "certificate not yet valid", subject=info.subject)
        if info.not_after and now > info.not_after:
            raise CertificateValidationError(
                "certificate expired", subject=info.subject)
        remaining = ((info.not_after - now).total_seconds() / 86400.0
                     if info.not_after else float("inf"))
        if remaining <= cfg.cert_expiry_warning_days:
            res.warnings.append(
                f"{info.subject or info.fingerprint[:16]} expires in "
                f"{remaining:.1f} days")
    res.valid = True
    return res


def build_ssl_context(cfg: TLSConfig) -> ssl.SSLContext:
    """ssl.SSLContext from the config (the BuildTLSConfig role,
    tls.go:125-206). Pinning/expiry still require verify_peer post-
    handshake — ssl has no per-cert hook."""
    validate_tls_config(cfg)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = (ssl.TLSVersion.TLSv1_3 if cfg.min_version == "1.3"
                           else ssl.TLSVersion.TLSv1_2)
    if cfg.client_cert_file and cfg.client_key_file:
        # our identity for servers demanding mutual TLS (loaded before the
        # early returns: mTLS composes with every verification mode)
        ctx.load_cert_chain(cfg.client_cert_file, cfg.client_key_file)
    if cfg.insecure_skip_verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return ctx
    if not cfg.require_valid_chain:
        # self-signed + pinning (tls.go:59-61): the chain check is off but
        # verify_peer's pin match is mandatory (validate_tls_config
        # enforces pins exist)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return ctx
    if cfg.ca_cert_pem:
        ctx.load_verify_locations(cadata=cfg.ca_cert_pem)
    elif cfg.ca_cert_file:
        ctx.load_verify_locations(cafile=cfg.ca_cert_file)
    else:
        ctx.load_default_certs()
    if cfg.server_name:
        # hostname checked against server_name by the caller's connect
        ctx.check_hostname = True
    return ctx


def verify_wrapped_socket(tls_sock, cfg: TLSConfig) -> TLSValidationResult:
    """Post-handshake pin/validity verification of an ssl-wrapped socket
    — the one shared implementation for every TLS dial path
    (https_get_json, the cluster proxies, the ETSI delivery sink).

    Chain note: Python < 3.13 exposes only the leaf certificate
    (no SSLSocket.get_unverified_chain), so pins must cover the LEAF
    there; on 3.13+ a pinned intermediate/CA anywhere in the presented
    chain also matches (the tls.go:208-229 rawCerts behavior)."""
    chain: list[bytes] = []
    if hasattr(tls_sock, "get_unverified_chain"):  # Python 3.13+
        for c in tls_sock.get_unverified_chain() or []:
            if hasattr(c, "public_bytes"):
                # ssl.Certificate.public_bytes takes an _ssl encoding
                # enum: DER == 2 (PEM == 1 — a str, which would break
                # the DER parser and the fingerprint hash)
                chain.append(c.public_bytes(2))
            else:
                chain.append(c)
    if not chain:
        der = tls_sock.getpeercert(binary_form=True)
        chain = [der] if der else []
    return verify_peer(chain, cfg)


def extract_server_name_from_url(url: str) -> str:
    """tls.go:524-527."""
    host = urlparse(url).hostname
    return host or ""


def https_get_json(url: str, cfg: TLSConfig, timeout: float = 10.0,
                   method: str = "GET", body: bytes | None = None,
                   headers: dict | None = None):
    """Pinning-enforcing HTTPS helper for the bootstrap client.

    Dials the URL's host but performs SNI + hostname verification against
    cfg.server_name when set (the tls.go ServerName role: Nexus reached
    by IP while the cert names a host), runs verify_peer on the presented
    chain BEFORE any request bytes are sent, then performs the request.
    Returns (status, parsed-json-or-None, warnings).

    Chain note: Python < 3.13 exposes only the leaf certificate
    (no SSLSocket.get_unverified_chain), so pins must cover the LEAF
    there; on 3.13+ a pinned intermediate/CA anywhere in the presented
    chain also matches (the tls.go:208-229 rawCerts behavior)."""
    import http.client
    import json
    import socket as _socket

    sn = cfg.server_name or extract_server_name_from_url(url)
    u = urlparse(url)
    ctx = build_ssl_context(cfg)
    raw = _socket.create_connection((u.hostname, u.port or 443),
                                    timeout=timeout)
    tls = None
    try:
        tls = ctx.wrap_socket(raw, server_hostname=sn)
        res = verify_wrapped_socket(tls, cfg)
        path = u.path or "/"
        if u.query:
            path += "?" + u.query
        req = [f"{method} {path} HTTP/1.1", f"Host: {sn}",
               "Connection: close"]
        if body is not None:
            req.append(f"Content-Length: {len(body)}")
        for k, v in (headers or {}).items():
            req.append(f"{k}: {v}")
        tls.sendall(("\r\n".join(req) + "\r\n\r\n").encode()
                    + (body or b""))
        resp = http.client.HTTPResponse(tls, method=method)
        resp.begin()
        data = resp.read()
        try:
            parsed = json.loads(data) if data else None
        except ValueError:
            parsed = None
        return resp.status, parsed, res.warnings
    finally:
        if tls is not None:
            tls.close()
        else:
            raw.close()
