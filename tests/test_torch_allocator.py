"""The port's allocators (`bng_tpu_torch/control/allocator/`) against the
JAX package's: the cases of `tests/test_allocator.py`, each run on both
packages from the same inputs, must give the same addresses, owners,
errors, JSON snapshots and reconcile results; and the reference test's
own cases, rebound onto the port (`test_torch_deviceauth.port_twin`),
hold there.

- `IPAllocator`: allocate/release cycles on a /29, specific addresses and
  owners, an IPv6 prefix, the JSON round trip, out-of-range offsets.
- `EpochBitmapAllocator`: O(1) epoch expiry, touch, lazy reclaim, the
  snapshot.
- `DistributedAllocator`: hashring agreement across nodes, forward
  probing, expiry, `sync_from_store`; and 256 seeded subscribers on a
  /22 shared by two nodes.
- `HybridAllocator`: partition fallback and reconcile.

Tolerance: exact.
"""

import json

import numpy as np
import pytest

import test_allocator as ref_alloc
from test_torch_deviceauth import reference_cases, run_on_port

from bng_tpu.control import allocator as j_alloc
from bng_tpu.control.allocator import bitmap as j_bitmap
from bng_tpu_torch.control import allocator as t_alloc
from bng_tpu_torch.control.allocator import bitmap as t_bitmap

pytestmark = pytest.mark.torch_port

PKGS = [(j_alloc, j_bitmap), (t_alloc, t_bitmap)]


def _err(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the error type is the observable
        return ("raised", type(e).__name__)


def bitmap_cycle(a, b):
    x = a.IPAllocator("192.168.1.0/29")
    ips = [str(x.allocate(f"s{i}")) for i in range(6)]
    full = _err(lambda: x.allocate("s7"))
    return ips, full[0], full[1] if full[0] == "raised" else None, x.release("192.168.1.3"), \
        str(x.allocate("s8")), b.BitmapExhaustedError.__name__


def bitmap_specific(a, b):
    x = a.IPAllocator("10.1.0.0/24")
    return (x.allocate_specific("10.1.0.50", "alice"), x.allocate_specific("10.1.0.50", "bob"),
            x.allocate_specific("10.1.0.50", "alice"), x.owner_of("10.1.0.50"))


def bitmap_ipv6(a, b):
    x = a.IPAllocator("2001:db8::/120")
    ip = x.allocate("v6sub")
    return str(ip), x.release(ip), x.allocated_count


def bitmap_json(a, b):
    x = a.IPAllocator("10.2.0.0/24")
    x.allocate("x")
    x.allocate("y")
    y = a.IPAllocator.from_json(x.to_json())
    return x.to_json(), y.allocated_count, y.owners


def bitmap_out_of_range(a, b):
    return _err(lambda: a.IPAllocator("10.3.0.0/24").offset_of("10.4.0.1"))


def epoch_expiry(a, b):
    x = a.EpochBitmapAllocator("10.5.0.0/28")
    ip1 = x.allocate("s1")
    out = [str(ip1), x.owner_of(ip1)]
    x.advance_epoch()
    out.append(x.owner_of(ip1))
    x.advance_epoch()
    return out + [x.owner_of(ip1)]


def epoch_touch(a, b):
    x = a.EpochBitmapAllocator("10.5.1.0/28")
    ip = x.allocate("s1")
    out = []
    for _ in range(5):
        x.advance_epoch()
        out.append(x.touch(ip))
    return str(ip), out, x.owner_of(ip)


def epoch_reclaim(a, b):
    x = a.EpochBitmapAllocator("10.5.2.0/30")
    ips = [str(x.allocate(f"s{i}")) for i in range(4)]
    over = _err(lambda: x.allocate("overflow"))
    x.advance_epoch()
    x.advance_epoch()
    ip = x.allocate("fresh")
    return ips, over, str(ip), x.owner_of(ip), x.live_count()


def epoch_snapshot(a, b):
    x = a.EpochBitmapAllocator("10.5.3.0/28")
    ip = x.allocate("s1")
    x.advance_epoch()
    y = a.EpochBitmapAllocator.from_json(x.to_json())
    return x.to_json(), y.owner_of(ip), y.epoch


def dist_agreement(a, b):
    store = a.MemoryAllocationStore()
    n1 = a.DistributedAllocator("10.6.0.0/24", store, node_id="n1")
    n2 = a.DistributedAllocator("10.6.0.0/24", store, node_id="n2")
    return n1.allocate("sub-42"), n2.allocate("sub-42")


def dist_probe(a, b):
    x = a.DistributedAllocator("10.6.1.0/24", a.MemoryAllocationStore(), clock=lambda: 1000.0)
    return [x.allocate("sub-A")] + [x.allocate(f"sub-B{i}") for i in range(50)]


def dist_expiry(a, b):
    t = [1000.0]
    x = a.DistributedAllocator("10.6.2.0/29", a.MemoryAllocationStore(), lease_seconds=60,
                               clock=lambda: t[0])
    ips = [x.allocate(f"s{i}") for i in range(6)]
    late = x.allocate("s-late")
    t[0] += 3600
    return ips, late, x.allocate("s-late")


def dist_sync(a, b):
    store = a.MemoryAllocationStore()
    a.DistributedAllocator("10.6.3.0/24", store, clock=lambda: 5.0).allocate("s1")
    y = a.DistributedAllocator("10.6.3.0/24", store, node_id="n2", clock=lambda: 5.0)
    return y.sync_from_store(), y.bitmap.to_json()


def dist_seeded(a, b):
    """256 seeded subscribers (some repeated) on a /22 shared by two
    nodes, a third of them released: the same addresses and store."""
    rng = np.random.default_rng(13)
    store = a.MemoryAllocationStore()
    nodes = [a.DistributedAllocator("10.8.0.0/22", store, node_id=f"n{i}",
                                    clock=lambda: 2000.0) for i in range(2)]
    subs = [f"sub-{int(v):08x}" for v in rng.integers(0, 1 << 32, 256, dtype=np.uint64)]
    subs += subs[:32]
    out = [nodes[int(k)].allocate(s) for s, k in zip(subs, rng.integers(0, 2, len(subs)))]
    rel = [nodes[0].release(s) for s in subs[::3]]
    recs = sorted((r.ip, r.subscriber_id, r.node_id, r.expires_at) for r in store.list_all())
    return out, rel, recs, nodes[1].sync_from_store()


class FlakyPrimary:
    """A primary allocator with a controllable health switch."""

    def __init__(self, a):
        self.healthy = True
        self.inner = a.LocalAllocator("10.7.0.0/24")

    def allocate(self, sid):
        if not self.healthy:
            raise ConnectionError("nexus unreachable")
        return self.inner.allocate(sid)

    def release(self, sid):
        if not self.healthy:
            raise ConnectionError("nexus unreachable")
        return self.inner.release(sid)


def hybrid(a, b):
    primary = FlakyPrimary(a)
    h = a.HybridAllocator(primary, "100.64.0.0/24", failure_threshold=2)
    out = [h.allocate("s1"), h.is_partition_active()]
    primary.healthy = False
    out += [h.allocate("s2"), h.allocate("s3"), h.is_partition_active(),
            [(f.subscriber_id, f.ip) for f in h.fallback_allocations]]
    primary.healthy = True
    migrated, renumbered = h.reconcile()
    return out + [migrated, [(f.subscriber_id, f.ip, ip) for f, ip in renumbered],
                  h.is_partition_active()]


CASES = [bitmap_cycle, bitmap_specific, bitmap_ipv6, bitmap_json, bitmap_out_of_range,
         epoch_expiry, epoch_touch, epoch_reclaim, epoch_snapshot, dist_agreement, dist_probe,
         dist_expiry, dist_sync, dist_seeded, hybrid]


def _norm(v):
    """JSON strings compare as parsed documents (key order is the
    serializer's, the content is the allocator's)."""
    if isinstance(v, str) and v[:1] in "{[":
        return json.loads(v)
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return v


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_allocator_case_matches_reference(case):
    ref, got = (case(*p) for p in PKGS)
    assert got == ref
    assert _norm(got) == _norm(ref)


REF_CASES = reference_cases(ref_alloc, ("TestBitmap", "TestEpochBitmap", "TestDistributed",
                                        "TestHybrid"))


@pytest.mark.parametrize("case", REF_CASES)
def test_reference_allocator_case_holds_on_the_port(case, request):
    """The reference test's own cases, rebound onto the port's modules."""
    run_on_port(ref_alloc, case, request)
