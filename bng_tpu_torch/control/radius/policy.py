"""QoS policy registry driven by RADIUS attributes.

The port's copy of `bng_tpu/control/radius/policy.py` (jax-free).

Parity: pkg/radius/policy.go — PolicyManager (:18), DefaultPolicies
(:100-136: residential-100mbps etc.), attribute -> policy resolution.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class QoSPolicy:
    name: str
    download_bps: int
    upload_bps: int
    priority: int = 0
    burst_factor: float = 1.25  # burst = rate/8 * factor


def _mbps(n: float) -> int:
    return int(n * 1_000_000)


DEFAULT_POLICIES = [
    QoSPolicy("residential-100mbps", _mbps(100), _mbps(20), priority=0),
    QoSPolicy("residential-500mbps", _mbps(500), _mbps(100), priority=0),
    QoSPolicy("residential-1gbps", _mbps(1000), _mbps(200), priority=0),
    QoSPolicy("business-100mbps", _mbps(100), _mbps(100), priority=2),
    QoSPolicy("business-1gbps", _mbps(1000), _mbps(1000), priority=2),
    QoSPolicy("lite-25mbps", _mbps(25), _mbps(5), priority=0),
]


class PolicyManager:
    def __init__(self, policies: list[QoSPolicy] | None = None):
        self._by_name: dict[str, QoSPolicy] = {}
        for p in policies if policies is not None else DEFAULT_POLICIES:
            self.add(p)

    def add(self, policy: QoSPolicy) -> None:
        self._by_name[policy.name] = policy

    def get(self, name: str) -> QoSPolicy | None:
        return self._by_name.get(name)

    def names(self) -> list[str]:
        return sorted(self._by_name)

    def from_radius_attributes(self, filter_id: str | None = None,
                               vendor_rate_down: int | None = None,
                               vendor_rate_up: int | None = None) -> QoSPolicy | None:
        """Resolve a policy from an Access-Accept: Filter-Id names a
        registered policy; explicit vendor rate attrs build an ad-hoc one."""
        if filter_id:
            p = self.get(filter_id.strip())
            if p is not None:
                return p
        if vendor_rate_down or vendor_rate_up:
            return QoSPolicy(
                name=f"radius-{vendor_rate_down or 0}-{vendor_rate_up or 0}",
                download_bps=vendor_rate_down or 0,
                upload_bps=vendor_rate_up or 0,
            )
        return None
