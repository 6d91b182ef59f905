"""NAT ALGs: FTP and SIP payload rewriting for punted flows.

Parity: pkg/nat/alg.go — ALGHandler registry keyed by well-known port
(alg.go:1-136), FTPALG with PORT / EPRT outbound rewrite and PASV / EPSV
inbound handling + data-connection pre-mapping (alg.go:138-351), SIPALG
line-based Via/Contact/SDP address rewrite (alg.go:353-441).

Device side: the NAT44 kernel detects control-protocol ports and punts
those packets (bpf/nat44.c:616-641 -> ops.nat44 ALG trigger verdict); the
host rewrites payloads here and pre-installs data-connection mappings via
the NATManager before re-injecting.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable

FTP_PORT = 21
SIP_PORT = 5060


@dataclass
class ALGConnection:
    """One NAT'd control connection (alg.go ALGConnection)."""

    private_ip: str
    private_port: int
    public_ip: str
    public_port: int
    protocol: int = 6


# mapper: (private_ip, private_port) -> (public_ip, public_port) or None
Mapper = Callable[[str, int], "tuple[str, int] | None"]


class FTPALG:
    """alg.go:138-351."""

    # PORT h1,h2,h3,h4,p1,p2
    PORT_RE = re.compile(r"(?i)(PORT)\s+(\d+),(\d+),(\d+),(\d+),(\d+),(\d+)")
    # 227 Entering Passive Mode (h1,h2,h3,h4,p1,p2)
    PASV_RE = re.compile(r"(227\s+[^(]*)\((\d+),(\d+),(\d+),(\d+),(\d+),(\d+)\)")
    # EPRT |1|ip|port|
    EPRT_RE = re.compile(r"(?i)(EPRT)\s+\|1\|([^|]+)\|(\d+)\|")
    # 229 Entering Extended Passive Mode (|||port|)
    EPSV_RE = re.compile(r"229\s+[^(]*\(\|\|\|(\d+)\|\)")

    name = "FTP"

    def __init__(self, mapper: Mapper):
        self._map = mapper
        self.stats = {"port_rewrites": 0, "pasv_rewrites": 0,
                      "eprt_rewrites": 0, "epsv_mappings": 0, "failures": 0}

    def process_outbound(self, conn: ALGConnection, data: bytes) -> bytes:
        """Client->server: rewrite announced private endpoints to public."""
        text = data.decode("latin-1")
        lines = text.split("\r\n")
        modified = False
        for i, line in enumerate(lines):
            m = self.PORT_RE.search(line)
            if m:
                new = self._rewrite_port(conn, m)
                if new is not None:
                    lines[i] = new
                    modified = True
                continue
            m = self.EPRT_RE.search(line)
            if m:
                new = self._rewrite_eprt(conn, m)
                if new is not None:
                    lines[i] = new
                    modified = True
        return "\r\n".join(lines).encode("latin-1") if modified else data

    def process_inbound(self, conn: ALGConnection, data: bytes) -> bytes:
        """Server->client: rewrite 227 PASV bodies that leak the private
        address (NAT'd FTP server case); pre-map 229 EPSV data ports."""
        text = data.decode("latin-1")
        lines = text.split("\r\n")
        modified = False
        for i, line in enumerate(lines):
            m = self.PASV_RE.search(line)
            if m:
                new = self._rewrite_pasv(conn, m)
                if new is not None:
                    lines[i] = new
                    modified = True
                continue
            m = self.EPSV_RE.search(line)
            if m:
                # EPSV carries no IP; just pre-map the data port.
                if self._map(conn.private_ip, int(m.group(1))):
                    self.stats["epsv_mappings"] += 1
        return "\r\n".join(lines).encode("latin-1") if modified else data

    @staticmethod
    def _decode_hostport(groups) -> tuple[str, int]:
        h = ".".join(groups[:4])
        return h, int(groups[4]) * 256 + int(groups[5])

    @staticmethod
    def _encode_hostport(ip: str, port: int) -> str:
        return ",".join(ip.split(".")) + f",{port >> 8},{port & 0xFF}"

    def _rewrite_port(self, conn: ALGConnection, m: re.Match) -> str | None:
        ip, port = self._decode_hostport(m.groups()[1:])
        if ip != conn.private_ip:
            return None
        mapped = self._map(ip, port)
        if mapped is None:
            self.stats["failures"] += 1
            return None
        self.stats["port_rewrites"] += 1
        return m.string[:m.start()] + \
            f"{m.group(1)} {self._encode_hostport(*mapped)}" + \
            m.string[m.end():]

    def _rewrite_eprt(self, conn: ALGConnection, m: re.Match) -> str | None:
        ip, port = m.group(2), int(m.group(3))
        if ip != conn.private_ip:
            return None
        mapped = self._map(ip, port)
        if mapped is None:
            self.stats["failures"] += 1
            return None
        self.stats["eprt_rewrites"] += 1
        return m.string[:m.start()] + \
            f"{m.group(1)} |1|{mapped[0]}|{mapped[1]}|" + m.string[m.end():]

    def _rewrite_pasv(self, conn: ALGConnection, m: re.Match) -> str | None:
        ip, port = self._decode_hostport(m.groups()[1:])
        if ip != conn.private_ip:
            return None
        mapped = self._map(ip, port)
        if mapped is None:
            self.stats["failures"] += 1
            return None
        self.stats["pasv_rewrites"] += 1
        return m.string[:m.start()] + \
            f"{m.group(1)}({self._encode_hostport(*mapped)})" + \
            m.string[m.end():]


class SIPALG:
    """alg.go:353-441: rewrite private<->public addresses in SIP headers
    (Via/Contact/From/To) and SDP bodies (c=/o=/m= lines)."""

    name = "SIP"

    def __init__(self, mapper: Mapper | None = None):
        self._map = mapper
        self.stats = {"rewrites": 0, "media_mappings": 0}

    _SDP_MEDIA_RE = re.compile(r"^m=(audio|video)\s+(\d+)\s", re.M)

    def _rewrite(self, conn: ALGConnection, data: bytes,
                 old_ip: str, new_ip: str) -> bytes:
        text = data.decode("latin-1")
        if old_ip not in text:
            return data
        out = text.replace(old_ip, new_ip)
        self.stats["rewrites"] += out.count(new_ip)
        return out.encode("latin-1")

    def process_outbound(self, conn: ALGConnection, data: bytes) -> bytes:
        out = self._rewrite(conn, data, conn.private_ip, conn.public_ip)
        # Pre-map announced RTP media ports so inbound audio flows.
        if self._map is not None:
            for m in self._SDP_MEDIA_RE.finditer(out.decode("latin-1")):
                if self._map(conn.private_ip, int(m.group(2))):
                    self.stats["media_mappings"] += 1
        return out

    def process_inbound(self, conn: ALGConnection, data: bytes) -> bytes:
        return self._rewrite(conn, data, conn.public_ip, conn.private_ip)


class ALGHandler:
    """Registry + dispatch (alg.go:1-136). mapper pre-installs data-path
    mappings through the NAT manager (the single writer)."""

    def __init__(self, mapper: Mapper):
        self._algs: dict[int, object] = {
            FTP_PORT: FTPALG(mapper),
            SIP_PORT: SIPALG(mapper),
        }

    def register(self, port: int, alg) -> None:
        self._algs[port] = alg

    def ports(self) -> list[int]:
        return sorted(self._algs)

    def get(self, port: int):
        return self._algs.get(port)

    def process(self, conn: ALGConnection, dst_port: int, data: bytes,
                outbound: bool) -> bytes:
        alg = self._algs.get(dst_port if outbound else conn.private_port) \
            or self._algs.get(dst_port)
        if alg is None:
            return data
        if outbound:
            return alg.process_outbound(conn, data)
        return alg.process_inbound(conn, data)
