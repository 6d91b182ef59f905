"""Device -> Nexus authentication: none / PSK(HMAC) / mTLS.

The port's copy of `bng_tpu/control/deviceauth.py` (jax-free).

Parity: pkg/deviceauth — Authenticator interface + mode dispatch
(types.go:194, authenticator.go:16-40), DeviceIdentity read from DMI//sys
(authenticator.go:137-259), NoneAuthenticator (authenticator.go:42-134),
PSKAuthenticator with HMAC-SHA256 signed headers + server-side verify with
timestamp-skew check (psk.go:35-301), MTLSAuthenticator with cert loading,
fingerprinting, expiry checks and rotation reload (mtls.go:20-418),
AuthenticatedTransport header injection (transport.go:8-110).

The mTLS cert expiry check uses a minimal DER walk (stdlib has no X.509
parser); CSR generation shells out to the openssl binary the way the
reference drives FRR via vtysh.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import re
import subprocess
import threading
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum

MAX_TIMESTAMP_SKEW = 300.0  # psk.go MaxTimestampSkew
PSK_TIMESTAMP_HEADER = "X-Device-Timestamp"
PSK_SIGNATURE_HEADER = "X-Device-Signature"


class AuthMode(str, Enum):
    NONE = "none"
    PSK = "psk"
    MTLS = "mtls"


@dataclass
class DeviceIdentity:
    """types.go:122-147."""

    device_id: str = ""
    serial: str = ""
    mac: str = ""
    model: str = ""
    firmware: str = ""


@dataclass
class AuthResult:
    success: bool
    mode: AuthMode
    identity: DeviceIdentity | None = None
    error: str = ""


def sanitize_id(s: str) -> str:
    """authenticator.go:251-259: keep [a-zA-Z0-9-_], lowercase."""
    return re.sub(r"[^a-zA-Z0-9_-]", "-", s).lower()


def generate_device_id(serial: str, mac: str) -> str:
    """authenticator.go:233-249: stable ID from serial+mac."""
    if serial:
        return "dev-" + sanitize_id(serial)
    if mac:
        return "dev-" + sanitize_id(mac.replace(":", ""))
    return "dev-" + uuid.uuid4().hex[:12]


def read_device_identity(sys_root: str = "/") -> DeviceIdentity:
    """Detect serial/MAC/model from DMI + sysfs (authenticator.go:137-231).
    sys_root is injectable so tests provide a fake /sys tree."""
    def _read(path: str) -> str:
        try:
            with open(os.path.join(sys_root, path.lstrip("/"))) as f:
                return f.read().strip()
        except OSError:
            return ""

    serial = (_read("/sys/class/dmi/id/product_serial")
              or _read("/sys/class/dmi/id/board_serial")
              or _read("/etc/machine-id"))
    model = _read("/sys/class/dmi/id/product_name")
    mac = ""
    net_dir = os.path.join(sys_root, "sys/class/net")
    try:
        for iface in sorted(os.listdir(net_dir)):
            if iface == "lo":
                continue
            addr = _read(f"/sys/class/net/{iface}/address")
            if addr and addr != "00:00:00:00:00:00":
                mac = addr
                break
    except OSError:
        pass
    return DeviceIdentity(device_id=generate_device_id(serial, mac),
                          serial=serial, mac=mac, model=model)


class NoneAuthenticator:
    """Pass-through: identity headers only (authenticator.go:42-134)."""

    def __init__(self, identity: DeviceIdentity | None = None):
        self.identity = identity or DeviceIdentity(
            device_id=generate_device_id("", ""))

    @property
    def mode(self) -> AuthMode:
        return AuthMode.NONE

    def authenticate(self) -> AuthResult:
        return AuthResult(True, self.mode, self.identity)

    def http_headers(self) -> dict[str, str]:
        h = {"X-Device-ID": self.identity.device_id}
        if self.identity.serial:
            h["X-Device-Serial"] = self.identity.serial
        return h

    def tls_config(self):
        return None

    def close(self) -> None:
        pass


class PSKAuthenticator:
    """HMAC-SHA256 pre-shared-key auth (psk.go:35-301).

    Headers carry a signature over "device_id:timestamp", never the PSK.
    The server derives the same signature from the shared key.
    """

    def __init__(self, psk: str | bytes = "", psk_file: str = "",
                 identity: DeviceIdentity | None = None, clock=time.time):
        if psk_file:
            with open(psk_file) as f:
                psk = f.read().strip()
        if isinstance(psk, str):
            psk = psk.encode()
        if len(psk) < 16:
            raise ValueError("PSK must be at least 16 characters")
        self._psk = psk
        self._clock = clock
        self._lock = threading.Lock()
        self.identity = identity or DeviceIdentity(
            device_id=generate_device_id("", ""))

    @property
    def mode(self) -> AuthMode:
        return AuthMode.PSK

    def authenticate(self) -> AuthResult:
        return AuthResult(True, self.mode, self.identity)

    def sign_message(self, message: str) -> str:
        with self._lock:
            return hmac.new(self._psk, message.encode(), hashlib.sha256).hexdigest()

    @staticmethod
    def _fmt_ts(t: float) -> str:
        return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))

    def http_headers(self) -> dict[str, str]:
        """psk.go:192-227."""
        h = {"X-Device-ID": self.identity.device_id}
        if self.identity.serial:
            h["X-Device-Serial"] = self.identity.serial
        if self.identity.mac:
            h["X-Device-MAC"] = self.identity.mac
        ts = self._fmt_ts(self._clock())
        h[PSK_TIMESTAMP_HEADER] = ts
        h[PSK_SIGNATURE_HEADER] = self.sign_message(
            f"{self.identity.device_id}:{ts}")
        return h

    def verify_signature(self, device_id: str, timestamp: str,
                         signature: str) -> None:
        """Server side (psk.go:266-291). Raises ValueError on failure."""
        try:
            ts = time.mktime(time.strptime(timestamp, "%Y-%m-%dT%H:%M:%SZ")) \
                - time.timezone
        except ValueError as e:
            raise ValueError(f"invalid timestamp format: {e}") from e
        if abs(self._clock() - ts) > MAX_TIMESTAMP_SKEW:
            raise ValueError("timestamp skew too large")
        expected = self.sign_message(f"{device_id}:{timestamp}")
        if not hmac.compare_digest(signature, expected):
            raise ValueError("signature mismatch")

    def rotate_psk(self, new_psk: str) -> None:
        if len(new_psk) < 16:
            raise ValueError("new PSK must be at least 16 characters")
        with self._lock:
            self._psk = new_psk.encode()

    def tls_config(self):
        return None

    def close(self) -> None:
        self._psk = b"\x00" * len(self._psk)  # zero like psk.go Close


# -- minimal X.509 DER helpers (expiry + subject CN) --------------------

def _pem_to_der(pem: str) -> bytes:
    body = re.search(r"-----BEGIN CERTIFICATE-----(.*?)-----END CERTIFICATE-----",
                     pem, re.S)
    if not body:
        raise ValueError("no certificate in PEM")
    return base64.b64decode("".join(body.group(1).split()))


def _der_iter(data: bytes, off: int = 0):
    """Yield (tag, start, end) for each TLV at one DER level."""
    while off < len(data):
        tag = data[off]
        length = data[off + 1]
        off += 2
        if length & 0x80:
            n = length & 0x7F
            length = int.from_bytes(data[off:off + n], "big")
            off += n
        yield tag, off, off + length
        off += length


def cert_not_after(pem: str) -> float:
    """Extract notAfter from an X.509 PEM (mtls.go:322-341 role)."""
    der = _pem_to_der(pem)
    # Certificate ::= SEQUENCE { tbsCertificate, sigAlg, sig }
    _, s, e = next(_der_iter(der))
    cert_body = der[s:e]
    _, ts0, te0 = next(_der_iter(cert_body))  # tbsCertificate
    tbs = cert_body[ts0:te0]
    tbs_fields = list(_der_iter(tbs))
    # tbs: [0] version?, serial, sigAlg, issuer, validity(SEQ), subject, ...
    idx = 0
    if tbs_fields and tbs_fields[0][0] == 0xA0:
        idx = 1
    validity = tbs_fields[idx + 3]  # serial, sigAlg, issuer, then validity
    vdata = tbs[validity[1]:validity[2]]
    times = list(_der_iter(vdata))
    tag, ts, te = times[1]  # notAfter
    raw = vdata[ts:te].decode()
    if tag == 0x17:  # UTCTime YYMMDDHHMMSSZ
        year = int(raw[:2])
        year += 2000 if year < 50 else 1900
        raw = f"{year}{raw[2:]}"
    return time.mktime(time.strptime(raw, "%Y%m%d%H%M%SZ")) - time.timezone


def cert_fingerprint(pem: str) -> str:
    return hashlib.sha256(_pem_to_der(pem)).hexdigest()


class MTLSAuthenticator:
    """Mutual-TLS device auth with rotation reload (mtls.go:20-418)."""

    def __init__(self, cert_file: str, key_file: str, ca_file: str = "",
                 identity: DeviceIdentity | None = None, clock=time.time):
        self.cert_file = cert_file
        self.key_file = key_file
        self.ca_file = ca_file
        self._clock = clock
        self._lock = threading.Lock()
        self._fingerprint = ""
        self._not_after = 0.0
        self._mtime = 0.0
        self.identity = identity or DeviceIdentity()
        self.reload_certificates()
        if not self.identity.device_id:
            cn = self._subject_cn()
            self.identity.device_id = generate_device_id(cn, "")

    @property
    def mode(self) -> AuthMode:
        return AuthMode.MTLS

    def reload_certificates(self) -> None:
        """mtls.go:86-123, :343-360."""
        with open(self.cert_file) as f:
            pem = f.read()
        with self._lock:
            self._fingerprint = cert_fingerprint(pem)
            self._not_after = cert_not_after(pem)
            self._mtime = os.path.getmtime(self.cert_file)

    def _subject_cn(self) -> str:
        try:
            out = subprocess.run(
                ["openssl", "x509", "-in", self.cert_file, "-noout", "-subject"],
                capture_output=True, text=True, timeout=10, check=True).stdout
            m = re.search(r"CN\s*=\s*([^,/\n]+)", out)
            return m.group(1).strip() if m else ""
        except Exception:
            return ""

    def maybe_rotate(self) -> bool:
        """Rotation watcher body (mtls.go:287-320): reload on file change."""
        try:
            if os.path.getmtime(self.cert_file) != self._mtime:
                self.reload_certificates()
                return True
        except OSError:
            pass
        return False

    def authenticate(self) -> AuthResult:
        if self.expires_within(0):
            return AuthResult(False, self.mode, self.identity,
                              error="certificate expired")
        return AuthResult(True, self.mode, self.identity)

    def expires_within(self, seconds: float) -> bool:
        """mtls.go:408-417."""
        with self._lock:
            return self._clock() + seconds >= self._not_after

    @property
    def fingerprint(self) -> str:
        with self._lock:
            return self._fingerprint

    def http_headers(self) -> dict[str, str]:
        return {"X-Device-ID": self.identity.device_id,
                "X-Device-Cert-Fingerprint": self.fingerprint}

    def tls_config(self):
        """Build an ssl.SSLContext loaded with the client pair."""
        import ssl
        ctx = ssl.create_default_context(
            cafile=self.ca_file or None,
            purpose=ssl.Purpose.SERVER_AUTH)
        ctx.load_cert_chain(self.cert_file, self.key_file)
        return ctx

    def generate_csr(self, cn: str, out_dir: str) -> tuple[str, str]:
        """CSR + fresh key via openssl (mtls.go:362-406). Returns paths."""
        key = os.path.join(out_dir, "device.key")
        csr = os.path.join(out_dir, "device.csr")
        subprocess.run(
            ["openssl", "req", "-new", "-newkey", "ec", "-pkeyopt",
             "ec_paramgen_curve:P-256", "-nodes", "-keyout", key,
             "-subj", f"/CN={cn}", "-out", csr],
            capture_output=True, timeout=30, check=True)
        return csr, key

    def close(self) -> None:
        pass


def new_authenticator(mode: AuthMode | str, **kw):
    """Dispatch like authenticator.go:16-40."""
    mode = AuthMode(mode)
    if mode == AuthMode.NONE:
        return NoneAuthenticator(**kw)
    if mode == AuthMode.PSK:
        return PSKAuthenticator(**kw)
    return MTLSAuthenticator(**kw)


class AuthenticatedTransport:
    """Header-injecting request wrapper (transport.go:8-110). Wraps any
    transport callable (method, url, headers, body) -> response."""

    def __init__(self, base, authenticator):
        self._base = base
        self._auth = authenticator

    def __call__(self, method: str, url: str, headers: dict | None = None,
                 body: bytes | None = None):
        h = dict(headers or {})
        h.update(self._auth.http_headers())
        return self._base(method, url, h, body)
