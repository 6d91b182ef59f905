"""QinQ (802.1ad) S-tag/C-tag helpers and subscriber<->VLAN registry.

Parity: pkg/qinq — VLANPair model (qinq.go:18-44), VLANRange (:68-86),
Mapper registry with bidirectional index (:100-210). Kernel-side QinQ
parsing lives in the device packet parser (bng_tpu_torch.ops.parse), mirroring
how the reference parses 802.1ad in bpf/dhcp_fastpath.c:352-428.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


@dataclass(frozen=True)
class VLANPair:
    """An S-tag (outer, 802.1ad) + C-tag (inner, 802.1Q) pair.

    0 means "no tag" on that level, like the reference (qinq.go:18-44).
    """

    s_tag: int = 0
    c_tag: int = 0

    def __post_init__(self):
        for name, v in (("s_tag", self.s_tag), ("c_tag", self.c_tag)):
            if not 0 <= v <= 4095:
                raise ValueError(f"{name} out of range: {v}")

    def __str__(self) -> str:
        if self.is_double_tagged:
            return f"{self.s_tag}.{self.c_tag}"
        if self.is_single_tagged:
            return str(self.c_tag)
        return "untagged"

    @property
    def is_double_tagged(self) -> bool:
        return self.s_tag != 0 and self.c_tag != 0

    @property
    def is_single_tagged(self) -> bool:
        return self.s_tag == 0 and self.c_tag != 0

    @property
    def is_untagged(self) -> bool:
        return self.s_tag == 0 and self.c_tag == 0

    def key(self) -> int:
        """Pack to the u32 {s_tag,c_tag} device-table key (ops.parse layout)."""
        return (self.s_tag << 16) | self.c_tag


@dataclass(frozen=True)
class VLANRange:
    """Inclusive VID range (qinq.go:68-86)."""

    start: int
    end: int

    def contains(self, vid: int) -> bool:
        return self.start <= vid <= self.end

    def size(self) -> int:
        return max(0, self.end - self.start + 1)


@dataclass
class QinQConfig:
    """Valid tag ranges for registration (qinq.go:47-98)."""

    s_tag_range: VLANRange = field(default_factory=lambda: VLANRange(1, 4094))
    c_tag_range: VLANRange = field(default_factory=lambda: VLANRange(1, 4094))
    allow_single_tagged: bool = True
    allow_untagged: bool = False


class QinQMapper:
    """Bidirectional VLANPair <-> subscriber-ID registry (qinq.go:100-210).

    The registry is the control-plane source of truth; activation writes the
    pair into the device vlan_subscriber table (runtime.tables) so the
    fast path can do the 3-tier lookup the reference does in
    bpf/dhcp_fastpath.c:653-681.
    """

    def __init__(self, config: QinQConfig | None = None):
        self.config = config or QinQConfig()
        self._lock = threading.Lock()
        self._by_vlan: dict[VLANPair, str] = {}
        self._by_subscriber: dict[str, VLANPair] = {}

    def register(self, vlan: VLANPair, subscriber_id: str) -> None:
        cfg = self.config
        if vlan.is_untagged and not cfg.allow_untagged:
            raise ValueError("untagged registration not allowed")
        if vlan.s_tag != 0 and vlan.c_tag == 0:
            raise ValueError("s-tag-only pair is invalid (outer without inner tag)")
        if vlan.is_single_tagged:
            if not cfg.allow_single_tagged:
                raise ValueError("single-tagged registration not allowed")
            if not cfg.c_tag_range.contains(vlan.c_tag):
                raise ValueError(f"c_tag {vlan.c_tag} outside allowed range")
        if vlan.is_double_tagged:
            if not cfg.s_tag_range.contains(vlan.s_tag):
                raise ValueError(f"s_tag {vlan.s_tag} outside allowed range")
            if not cfg.c_tag_range.contains(vlan.c_tag):
                raise ValueError(f"c_tag {vlan.c_tag} outside allowed range")
        with self._lock:
            existing = self._by_vlan.get(vlan)
            if existing is not None and existing != subscriber_id:
                raise ValueError(f"VLAN {vlan} already registered to {existing}")
            old = self._by_subscriber.get(subscriber_id)
            if old is not None and old != vlan:
                del self._by_vlan[old]
            self._by_vlan[vlan] = subscriber_id
            self._by_subscriber[subscriber_id] = vlan

    def unregister(self, vlan: VLANPair) -> None:
        with self._lock:
            sub = self._by_vlan.pop(vlan, None)
            if sub is not None and self._by_subscriber.get(sub) == vlan:
                del self._by_subscriber[sub]

    def unregister_subscriber(self, subscriber_id: str) -> None:
        with self._lock:
            vlan = self._by_subscriber.pop(subscriber_id, None)
            if vlan is not None:
                self._by_vlan.pop(vlan, None)

    def get_subscriber(self, vlan: VLANPair) -> str | None:
        with self._lock:
            return self._by_vlan.get(vlan)

    def get_vlan(self, subscriber_id: str) -> VLANPair | None:
        with self._lock:
            return self._by_subscriber.get(subscriber_id)

    def stats(self) -> dict:
        with self._lock:
            double = sum(1 for v in self._by_vlan if v.is_double_tagged)
            return {
                "total_mappings": len(self._by_vlan),
                "double_tagged": double,
                "single_tagged": len(self._by_vlan) - double,
            }
