"""Bitmap IP allocator (IPv4 + IPv6 prefixes).

The port's copy of `bng_tpu/control/allocator/bitmap.py` (jax-free).

Parity: pkg/allocator/bitmap.go (IPAllocator, :46-427; JSON snapshot
:428-497). numpy bool bitmap instead of Go's []uint64; IPv6 handled with
python big-int offset math like the reference's big.Int.
"""

from __future__ import annotations

import ipaddress
import json

import numpy as np


class BitmapExhaustedError(Exception):
    pass


class IPAllocator:
    """Allocates offsets within one CIDR prefix via a bitmap."""

    def __init__(self, cidr: str, reserve_network: bool = True,
                 reserve_broadcast: bool = True, max_size: int = 1 << 22):
        self.net = ipaddress.ip_network(cidr, strict=False)
        total = self.net.num_addresses
        self.size = min(total, max_size)
        self.bitmap = np.zeros(self.size, dtype=bool)
        self.owners: dict[int, str] = {}
        self._next = 0
        self.allocated_count = 0
        if self.net.version == 4 and reserve_network and total > 2:
            self._reserve(0)
        if self.net.version == 4 and reserve_broadcast and total > 2 and total <= self.size:
            self._reserve(total - 1)

    def _reserve(self, off: int) -> None:
        if not self.bitmap[off]:
            self.bitmap[off] = True
            self.allocated_count += 1
            self.owners[off] = "__reserved__"

    def ip_at(self, offset: int):
        return self.net.network_address + offset

    def offset_of(self, ip) -> int:
        addr = ipaddress.ip_address(ip) if isinstance(ip, (str, int)) else ip
        off = int(addr) - int(self.net.network_address)
        if off < 0 or off >= self.size:
            raise ValueError(f"{addr} not in {self.net}")
        return off

    def allocate(self, owner: str = ""):
        """Next-free scan from a moving cursor (parity: bitmap.go:100-180)."""
        if self.allocated_count >= self.size:
            raise BitmapExhaustedError(str(self.net))
        free = np.nonzero(~self.bitmap[self._next :])[0]
        if len(free) == 0:
            free = np.nonzero(~self.bitmap[: self._next])[0]
            if len(free) == 0:
                raise BitmapExhaustedError(str(self.net))
            off = int(free[0])
        else:
            off = self._next + int(free[0])
        self.bitmap[off] = True
        self.owners[off] = owner
        self.allocated_count += 1
        self._next = (off + 1) % self.size
        return self.ip_at(off)

    def allocate_specific(self, ip, owner: str = "") -> bool:
        off = self.offset_of(ip)
        if self.bitmap[off]:
            return self.owners.get(off) == owner and owner != ""
        self.bitmap[off] = True
        self.owners[off] = owner
        self.allocated_count += 1
        return True

    def allocate_at(self, offset: int, owner: str = "") -> bool:
        if offset < 0 or offset >= self.size or self.bitmap[offset]:
            return False
        self.bitmap[offset] = True
        self.owners[offset] = owner
        self.allocated_count += 1
        return True

    def is_free(self, offset: int) -> bool:
        return 0 <= offset < self.size and not self.bitmap[offset]

    def release(self, ip) -> bool:
        off = self.offset_of(ip)
        if not self.bitmap[off] or self.owners.get(off) == "__reserved__":
            return False
        self.bitmap[off] = False
        self.owners.pop(off, None)
        self.allocated_count -= 1
        return True

    def owner_of(self, ip) -> str | None:
        return self.owners.get(self.offset_of(ip))

    def utilization(self) -> float:
        return self.allocated_count / self.size if self.size else 1.0

    # -- snapshot (parity: bitmap.go:428-497 JSON round-trip) --
    def to_json(self) -> str:
        return json.dumps({
            "cidr": str(self.net),
            "next": self._next,
            "allocated": {str(off): owner for off, owner in self.owners.items()},
        })

    @classmethod
    def from_json(cls, data: str) -> "IPAllocator":
        d = json.loads(data)
        a = cls(d["cidr"], reserve_network=False, reserve_broadcast=False)
        for off_s, owner in d["allocated"].items():
            off = int(off_s)
            a.bitmap[off] = True
            a.owners[off] = owner
            a.allocated_count += 1
        a._next = d.get("next", 0)
        return a
