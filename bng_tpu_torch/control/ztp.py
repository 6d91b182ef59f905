"""Zero-touch provisioning: Nexus discovery + bootstrap registration.

The port's copy of `bng_tpu/control/ztp.py` (jax-free).

Parity: pkg/ztp — DHCP-based Nexus discovery via Option 224 (simple
string) then Option 43 Type-1 vendor TLV (client.go:50-143),
BootstrapClient.Bootstrap / registerAndWait poll loop with exponential
backoff and pending->configured states (bootstrap.go:103-338), serial/MAC/
model detection from DMI //sys (bootstrap.go:340-448), TLS cert pinning
(tls.go:20-527, fingerprint pinning here via deviceauth.cert_fingerprint).

Transport is a pluggable callable (so tests run hermetically); the real
one POSTs JSON to https://nexus/api/v1/bootstrap.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from bng_tpu_torch.control.deviceauth import DeviceIdentity, read_device_identity
from bng_tpu_torch.utils.structlog import ErrorLog

OPTION_NEXUS_URL = 224  # private-use simple string
OPTION_VENDOR = 43  # vendor TLV; sub-type 1 = Nexus URL


def extract_nexus_url(options: dict[int, bytes]) -> str:
    """client.go:101-117: Option 224 first, then 43/Type-1."""
    raw = options.get(OPTION_NEXUS_URL)
    if raw:
        return raw.decode(errors="replace")
    vendor = options.get(OPTION_VENDOR)
    if vendor:
        return parse_vendor_options(vendor)
    return ""


def parse_vendor_options(data: bytes) -> str:
    """client.go:122-141: TLV walk; sub-type 1 carries the URL."""
    i = 0
    while i + 2 <= len(data):
        sub_type, sub_len = data[i], data[i + 1]
        i += 2
        if i + sub_len > len(data):
            break
        if sub_type == 1:
            return data[i:i + sub_len].decode(errors="replace")
        i += sub_len
    return ""


def build_vendor_option(nexus_url: str) -> bytes:
    """Server-side helper: encode the Option 43 TLV the probe parses."""
    url = nexus_url.encode()
    return bytes([1, len(url)]) + url


@dataclass
class ZTPResult:
    """client.go Result: the lease + discovered URL."""

    ip: str = ""
    mask: str = ""
    gateway: str = ""
    dns: list[str] = field(default_factory=list)
    lease_time: int = 0
    nexus_url: str = ""


def discover_from_lease(ip: str = "", mask: str = "", gateway: str = "",
                        dns: list[str] | None = None, lease_time: int = 0,
                        options: dict[int, bytes] | None = None) -> ZTPResult:
    """Assemble a discovery result from a decoded DHCP ACK
    (client.go:50-99; the wire exchange itself runs through
    bng_tpu_torch.control.dhcp_codec in the composition root)."""
    return ZTPResult(ip=ip, mask=mask, gateway=gateway, dns=list(dns or []),
                     lease_time=lease_time,
                     nexus_url=extract_nexus_url(options or {}))


@dataclass
class BootstrapConfig:
    """bootstrap.go:23-48."""

    nexus_url: str = ""
    initial_backoff: float = 1.0
    max_backoff: float = 60.0
    max_retries: int = 0  # 0 = wait forever
    poll_interval: float = 5.0
    pin_fingerprint: str = ""  # expected server cert SHA-256 (tls.go pinning)
    tls: "object | None" = None  # ztp_tls.TLSConfig (None = plaintext/dev)


def make_https_transport(config: BootstrapConfig):
    """Pinning-enforcing HTTPS transport for BootstrapClient (the
    bootstrap.go:449-464 POST through tls.go's BuildTLSConfig channel).

    Uses config.tls (a ztp_tls.TLSConfig) when set; a bare
    pin_fingerprint becomes the classic TOFU bootstrap config
    (self-signed Nexus, no CA yet, SHA-256 pin mandatory)."""
    import json as _json

    from bng_tpu_torch.control import ztp_tls

    tls_cfg = config.tls
    if tls_cfg is None:
        if not config.pin_fingerprint:
            raise ValueError("https transport needs tls config or a pin")
        tls_cfg = ztp_tls.TLSConfig(require_valid_chain=False,
                                    pinned_certs=[config.pin_fingerprint])

    def transport(req: BootstrapRequest) -> dict:
        body = _json.dumps({"serial": req.serial, "mac": req.mac,
                            "model": req.model,
                            "firmware": req.firmware}).encode()
        status, parsed, _warnings = ztp_tls.https_get_json(
            config.nexus_url.rstrip("/") + "/api/v1/bootstrap/register",
            tls_cfg, method="POST", body=body,
            headers={"Content-Type": "application/json"})
        # anything but 200/201 is an error (bootstrap.go:327): a 403
        # "unknown serial" must surface, not masquerade as pending
        if status not in (200, 201) or parsed is None:
            detail = ""
            if isinstance(parsed, dict):
                detail = f": {parsed.get('error') or parsed.get('message', '')}"
            raise ConnectionError(f"nexus bootstrap HTTP {status}{detail}")
        return parsed

    return transport


@dataclass
class BootstrapRequest:
    serial: str
    mac: str
    model: str = ""
    firmware: str = ""


@dataclass
class DeviceConfig:
    """bootstrap.go:92-101: what an approved device receives."""

    node_id: str = ""
    site_id: str = ""
    role: str = ""
    partner: dict = field(default_factory=dict)
    pools: list[dict] = field(default_factory=list)
    cluster: dict = field(default_factory=dict)
    timestamp: float = 0.0


class BootstrapPending(Exception):
    def __init__(self, retry_after: float = 0.0, message: str = ""):
        super().__init__(message or "registration pending approval")
        self.retry_after = retry_after


class BootstrapClient:
    """Registration poll loop (bootstrap.go:103-338).

    transport: Callable[[BootstrapRequest], dict] posting to Nexus and
    returning the decoded response. Expected keys: status
    ("configured"|"pending"), node_id, site_id, role, partner, pools,
    cluster, retry_after. Raises on network failure.
    """

    def __init__(self, config: BootstrapConfig, transport,
                 identity: DeviceIdentity | None = None,
                 sys_root: str = "/", clock=time.time, sleep=time.sleep):
        self.config = config
        self._transport = transport
        self._clock = clock
        self._sleep = sleep
        self.identity = identity or read_device_identity(sys_root)
        self.attempts = 0
        self._bootstrap_err_log = ErrorLog(
            "ztp", "bootstrap attempt failed; backing off")

    def detect_system_info(self) -> BootstrapRequest:
        """bootstrap.go:181-217."""
        ident = self.identity
        return BootstrapRequest(serial=ident.serial, mac=ident.mac,
                                model=ident.model, firmware=ident.firmware)

    def register_once(self) -> DeviceConfig:
        """One registration attempt (bootstrap.go:449-464)."""
        resp = self._transport(self.detect_system_info())
        self.attempts += 1
        if resp.get("status") == "configured":
            return DeviceConfig(
                node_id=resp.get("node_id", ""), site_id=resp.get("site_id", ""),
                role=resp.get("role", ""), partner=resp.get("partner", {}),
                pools=resp.get("pools", []), cluster=resp.get("cluster", {}),
                timestamp=self._clock())
        raise BootstrapPending(retry_after=float(resp.get("retry_after", 0)),
                               message=resp.get("message", ""))

    def bootstrap(self, deadline: float | None = None) -> DeviceConfig:
        """Register and wait for approval (bootstrap.go:155-338):
        network errors retry with exponential backoff; 'pending' retries
        after the server-suggested delay; backoff resets after any
        successful exchange."""
        backoff = self.config.initial_backoff
        retries = 0
        while True:
            if deadline is not None and self._clock() >= deadline:
                raise TimeoutError("bootstrap deadline exceeded")
            try:
                return self.register_once()
            except BootstrapPending as pending:
                retries += 1
                if self.config.max_retries and retries >= self.config.max_retries:
                    raise TimeoutError(
                        f"max retries ({self.config.max_retries}) exceeded "
                        "waiting for configuration") from pending
                self._sleep(pending.retry_after or backoff)
                backoff = self.config.initial_backoff  # reset after contact
            except TimeoutError:
                raise
            except Exception as e:
                # transient bootstrap failure: visible per retry (ZTP
                # hangs are diagnosed from exactly these lines), then
                # backed off and retried
                self._bootstrap_err_log.report(e, backoff_s=backoff)
                self._sleep(backoff)
                backoff = min(backoff * 2, self.config.max_backoff)
