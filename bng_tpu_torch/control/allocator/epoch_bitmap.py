"""Epoch-bitmap allocator: 2-bit generation tags, O(1) lease expiry.

The port's copy of `bng_tpu/control/allocator/epoch_bitmap.py` (jax-free).

Parity: pkg/allocator/epoch_bitmap.go (:10-358; snapshot
:372-428). Every entry carries a 2-bit generation tag; a whole epoch of
leases expires with a single counter bump (AdvanceEpoch, :225) and stale
entries are reclaimed lazily on allocation — no per-lease timers.

Tag encoding (2 bits): 0 = free; {1, 2, 3} = allocated in generation g.
Generations cycle 1 -> 2 -> 3 -> 1. With current generation c, an entry is
live iff tag == c or tag == prev(c); anything else is expired (lazy free).
Memory: one uint8 per address here (the reference packs 4/byte — 16KB per
/16; packing is a numpy view detail, not semantics).

TPU note (SURVEY.md §2.3): these tags are designed to colocate with HBM
table entries — the device lease check `now > lease_expiry`
(dhcp_fastpath.c:690) can become `tag is live`, making "expire a million
leases" a scalar broadcast instead of a table rewrite.
"""

from __future__ import annotations

import ipaddress
import json

import numpy as np


def _next_gen(g: int) -> int:
    return g % 3 + 1


def _prev_gen(g: int) -> int:
    return (g - 2) % 3 + 1


class EpochBitmapAllocator:
    def __init__(self, cidr: str, max_size: int = 1 << 22):
        self.net = ipaddress.ip_network(cidr, strict=False)
        self.size = min(self.net.num_addresses, max_size)
        self.tags = np.zeros(self.size, dtype=np.uint8)
        self.owners: dict[int, str] = {}
        self.current_gen = 1
        self.epoch = 0
        self._next = 0

    # -- generation liveness --
    def _live_mask(self) -> np.ndarray:
        return (self.tags == self.current_gen) | (self.tags == _prev_gen(self.current_gen))

    def is_live(self, offset: int) -> bool:
        t = int(self.tags[offset])
        return t != 0 and (t == self.current_gen or t == _prev_gen(self.current_gen))

    def advance_epoch(self) -> int:
        """O(1): everything allocated 2 epochs ago silently expires.

        Parity: AdvanceEpoch (epoch_bitmap.go:225). Returns the new epoch.
        """
        self.current_gen = _next_gen(self.current_gen)
        self.epoch += 1
        return self.epoch

    def allocate(self, owner: str = ""):
        """Allocate a free-or-expired slot; refreshes tag to current gen."""
        live = self._live_mask()
        order = np.concatenate([np.arange(self._next, self.size), np.arange(self._next)])
        free_positions = order[~live[order]]
        if len(free_positions) == 0:
            raise RuntimeError(f"epoch allocator {self.net} exhausted")
        off = int(free_positions[0])
        # lazy reclaim of an expired entry
        if self.tags[off] != 0:
            self.owners.pop(off, None)
        self.tags[off] = self.current_gen
        self.owners[off] = owner
        self._next = (off + 1) % self.size
        return self.net.network_address + off

    def touch(self, ip) -> bool:
        """Renew a lease into the current generation (keeps it live for
        two more epochs)."""
        off = self._offset(ip)
        if not self.is_live(off):
            return False
        self.tags[off] = self.current_gen
        return True

    def release(self, ip) -> bool:
        off = self._offset(ip)
        if self.tags[off] == 0:
            return False
        self.tags[off] = 0
        self.owners.pop(off, None)
        return True

    def owner_of(self, ip) -> str | None:
        off = self._offset(ip)
        return self.owners.get(off) if self.is_live(off) else None

    def _offset(self, ip) -> int:
        addr = ipaddress.ip_address(ip) if isinstance(ip, (str, int)) else ip
        off = int(addr) - int(self.net.network_address)
        if off < 0 or off >= self.size:
            raise ValueError(f"{addr} not in {self.net}")
        return off

    def live_count(self) -> int:
        return int(self._live_mask().sum())

    def utilization(self) -> float:
        return self.live_count() / self.size if self.size else 1.0

    # -- snapshot (parity: epoch_bitmap.go:372-428) --
    def to_json(self) -> str:
        live = self._live_mask()
        return json.dumps({
            "cidr": str(self.net),
            "epoch": self.epoch,
            "current_gen": self.current_gen,
            "entries": {
                str(off): {"tag": int(self.tags[off]), "owner": self.owners.get(off, "")}
                for off in np.nonzero(self.tags)[0]
                if live[off]
            },
        })

    @classmethod
    def from_json(cls, data: str) -> "EpochBitmapAllocator":
        d = json.loads(data)
        a = cls(d["cidr"])
        a.epoch = d["epoch"]
        a.current_gen = d["current_gen"]
        for off_s, e in d["entries"].items():
            off = int(off_s)
            a.tags[off] = e["tag"]
            if e["owner"]:
                a.owners[off] = e["owner"]
        return a
