"""The port's invariant auditor against the JAX package's.

On the reference's swap stack (a DHCP server behind the engine, five
DORAs, NAT blocks from the server's hook, an edge stage), built in each
package by the same host calls, `audit_invariants` gives the same report
(`to_dict()`: checks, violations by kind, findings) on the clean stack and
on each injected fault:

- one device table word flipped (the port's tensor and the JAX state's
  array written alike);
- one host row deleted without a drain;
- a NAT block with no owner;
- a lease with no fast-path row (legal: a miss the slow path answers) and
  a fast-path row with no lease (a finding);
- on a two-shard cluster, a DHCP row resident on a shard that does not
  own its key;
- the NAT clauses over live sessions (the port runs them as numpy passes,
  the reference row by row): a reverse row deleted, a block with live
  sessions dropped, an EIM refcount off, a session outside its block;
- with a tracer armed, each audit that finds a violation asks its
  recorder for one dump, as in the reference; a clean one does not.

- the DHCPv6 clause over a served v6 book: clean, then a binding
  dropped from its pool, an allocation with no binding, an address both
  free and allocated, and one address bound to two clients.

The HA pair and the cluster of BNGs audit nothing when None or empty,
as the reference's do (their clauses: test_torch_ha.py,
test_torch_cluster.py). With `metrics`,
`audit_invariants` and `audit_app` record the same bng_invariant_*
families (audits, violations by kind, the last audit's count and epoch).

Tolerance: exact (the same report dicts).
"""

import numpy as np
import pytest

from bng_tpu.chaos import invariants as j_inv
from bng_tpu.telemetry import spans as j_spans
from bng_tpu_torch.chaos import invariants as t_inv
from bng_tpu_torch.telemetry import spans as t_spans
from bng_tpu_torch.utils.net import ip_to_u32, mac_to_u64

from test_torch_checkpoint import JAX, PKGS, cluster, mac
from test_torch_swap import engine_stack

pytestmark = pytest.mark.torch_port

INV = {"jax": j_inv, "port": t_inv}


def _flip_device_word(p, eng, slot):
    if p is JAX:
        d = eng.tables.dhcp
        vals = d.sub.vals.at[slot, 1].set(d.sub.vals[slot, 1] ^ 1)
        eng.tables = eng.tables._replace(dhcp=d._replace(sub=d.sub._replace(vals=vals)))
    else:
        eng.tables.dhcp.sub.vals[slot, 1] ^= 1


def _inject(p, case, st):
    clock, server, pools, fp, nat, eng, leased = st
    m = sorted(leased)[1]
    mk = mac_to_u64(m)
    slot = fp.sub._find_slot(np.asarray([mk >> 32, mk & 0xFFFFFFFF], dtype=np.uint32))
    if case == "device_word":
        _flip_device_word(p, eng, slot)
    elif case == "host_row_deleted":
        fp.sub.used[slot] = 0
        fp.sub.keys[slot] = 0
        fp.sub.vals[slot] = 0
        fp.sub.count -= 1
    elif case == "nat_block_orphan":
        nat.blocks.pop(leased[m])
    elif case == "lease_without_row":
        fp.remove_subscriber(m)
    elif case == "row_without_lease":
        fp.add_subscriber(mac(0x77), pool_id=1, ip=ip_to_u32("10.0.0.200"),
                          lease_expiry=int(clock()) + 600)


class _Recorder:
    """A flight recorder that keeps the dumps it is asked for."""

    def __init__(self):
        self.dumps = []
        self.meta = {}

    def trigger(self, reason, detail=""):
        self.dumps.append((reason, detail))
        return f"dump{len(self.dumps)}"

    def push(self, *a):
        pass

    def note_shed(self, n):
        pass


@pytest.mark.parametrize("case,kinds", [
    ("clean", {}),
    ("device_word", {"mirror-mismatch": 1}),
    ("host_row_deleted", {"mirror-mismatch": 2}),  # the bucket row and the value row
    ("nat_block_orphan", {"nat-block-accounting": 1, "nat-subnat-count": 1}),
    ("lease_without_row", {}),
    ("row_without_lease", {"fastpath-stale-row": 1}),
])
def test_audit_matches_reference(case, kinds):
    got = []
    for p in PKGS:
        st = engine_stack(p, edge=True)
        clock, server, pools, fp, nat, eng, leased = st
        _inject(p, case, st)
        rec = _Recorder()
        with (j_spans if p is JAX else t_spans).armed(recorder=rec):
            rep = INV[p.name].audit_invariants(engine=eng, pools=pools, dhcp=server, nat=nat)
        got.append((rep.to_dict(), rec.dumps))
    assert got[1] == got[0]
    rep, dumps = got[1]
    assert rep["violations_by_kind"] == kinds
    assert rep["checks"]["leases"] == 5 and rep["checks"]["edge_tap_rows"] == 1
    assert dumps == ([("invariant_violation", str(kinds))] if kinds else [])


@pytest.mark.parametrize("case", ["clean", "misplaced_row"])
def test_sharded_audit_matches_reference(case):
    got = []
    for p in PKGS:
        cl = cluster(p, 2)
        if case == "misplaced_row":
            m = mac(0x99)
            wrong = 1 - cl.dhcp_sub_shard(m)
            cl.fastpath[wrong].add_subscriber(m, pool_id=1, ip=ip_to_u32("10.0.9.9"),
                                              lease_expiry=1_753_000_900)
        rep = INV[p.name].audit_invariants(cluster=cl)
        got.append(rep.to_dict())
    assert got[1] == got[0]
    kinds = set(got[1]["violations_by_kind"])
    assert kinds == (set() if case == "clean" else {"shard-misplaced-row"})
    assert got[1]["checks"]["shards"] == 2 and got[1]["checks"]["shard_rows.sub"] >= 24


def _nat_fault(nat, case):
    from bng_tpu_torch.ops.nat44 import SV_NAT_PORT

    occ = np.nonzero(nat.sessions.used)[0]
    s = int(occ[0])
    if case == "reverse_deleted":
        k, v = nat.sessions.keys[s], nat.sessions.vals[s]
        nat.reverse.delete(nat._key(int(k[1]), int(v[0]), int(k[2]) & 0xFFFF, int(v[1]),
                                    int(k[3])))
    elif case == "session_orphan":
        nat.blocks.pop(int(nat.sessions.keys[s][0]))
    elif case == "eim_refcount":
        next(iter(nat.eim.values()))[2] += 3
    elif case == "outside_block":
        nat.sessions.vals[s, SV_NAT_PORT] = 7


@pytest.mark.parametrize("case,kinds", [
    ("clean", {}),
    ("reverse_deleted", {"nat-missing-reverse": 1, "nat-reverse-count": 1}),
    ("session_orphan", {"nat-block-accounting": 1, "nat-eim-orphan": 2,  # two sessions
                        "nat-session-orphan": 2, "nat-subnat-count": 1}),
    ("eim_refcount", {"nat-eim-refcount": 1}),
    ("outside_block", {"nat-missing-reverse": 1, "nat-session-outside-block": 1}),
])
def test_nat_session_audit_matches_reference(case, kinds):
    """The NAT clauses over live sessions (the port checks them in numpy
    passes, the reference row by row): the same report on each fault."""
    from test_torch_checkpoint import drive, stack

    got = []
    for p in PKGS:
        st = stack(p)
        drive(st)
        _nat_fault(st.nat, case)
        got.append(INV[p.name].audit_invariants(nat=st.nat).to_dict())
    assert got[1] == got[0]
    assert got[1]["violations_by_kind"] == kinds and got[1]["checks"]["nat_sessions"] == 3


@pytest.mark.parametrize("name", ["ha_pair", "bng_cluster"])
def test_absent_components_audit_nothing_and_refuse_a_value(name):
    rep = t_inv.audit_invariants(**{name: None})
    assert rep.ok and rep.to_dict() == j_inv.audit_invariants(**{name: None}).to_dict()
    if name == "ha_pair":
        # the HA pair is ported: a pair with no connected standby audits
        # nothing, as the reference's does (its clauses: test_torch_ha.py)
        from bng_tpu_torch.control.ha import ActiveSyncer, InMemorySessionStore, StandbySyncer

        pair = (ActiveSyncer(InMemorySessionStore()),
                StandbySyncer(InMemorySessionStore(), transport=lambda: None))
        assert t_inv.audit_invariants(ha_pair=pair, check_roundtrip=False).ok
        return
    # the cluster of BNGs is ported: a coordinator with no members has no
    # plan and audits nothing, as the reference's does (its clauses:
    # test_torch_cluster.py)
    from bng_tpu.cluster import ClusterCoordinator as JCoord
    from bng_tpu_torch.cluster import ClusterCoordinator as TCoord

    got = t_inv.audit_invariants(bng_cluster=TCoord(mode="inline"), check_roundtrip=False)
    assert got.ok and got.to_dict() == j_inv.audit_invariants(
        bng_cluster=JCoord(mode="inline"), check_roundtrip=False).to_dict()


def _v6_book(case):
    """Both packages' DHCPv6 servers, six clients served the same, then the
    case's fault injected into each alike."""
    from test_torch_v6 import PKGS as V6_PKGS, _msg, _other_duid, _v6_server

    from bng_tpu.control.dhcpv6 import protocol as p6

    out = []
    for pk in V6_PKGS:
        srv = _v6_server(pk, lambda: 1_753_000_000.0)
        for i in range(6):
            srv.handle_message(_msg(p6.SOLICIT, i, duid=_other_duid(i), server=False, na=[1],
                                    pd=[1] if i % 2 else [], rapid=True))
        keys = sorted(srv.leases)
        if case == "lease_not_allocated":
            srv.addr_pool._allocated.pop(srv.leases[keys[0]].address)
        elif case == "alloc_orphan":
            srv.addr_pool.allocate()
        elif case == "free_allocated_overlap":
            srv.addr_pool._free.append(next(iter(srv.addr_pool._allocated.values())))
        elif case == "double_lease":
            na = [k for k in keys if not k[2]]
            srv.leases[na[1]].address = srv.leases[na[0]].address
        out.append(srv)
    return out


@pytest.mark.parametrize("case", ["clean", "lease_not_allocated", "alloc_orphan",
                                  "free_allocated_overlap", "double_lease"])
def test_dhcpv6_clause_matches_reference(case):
    j_srv, t_srv = _v6_book(case)
    ref = j_inv.audit_invariants(dhcpv6=j_srv).to_dict()
    got = t_inv.audit_invariants(dhcpv6=t_srv).to_dict()
    assert got == ref
    assert got["checks"]["v6_leases_na"] >= 5 and got["checks"]["v6_leases_pd"] == 3
    assert got["ok"] == (case == "clean")


def _invariant_samples(met) -> dict:
    return dict(line.rsplit(" ", 1) for line in met.expose().splitlines()
                if line.startswith("bng_invariant_"))


@pytest.mark.parametrize("case", ["lease_without_row", "row_without_lease", "nat_block_orphan"])
def test_audit_metrics_and_epoch_match_reference(case):
    """`audit_invariants(..., metrics, epoch)` and `audit_app(app, metrics,
    epoch)` record the same bng_invariant_* families as the reference: the
    audit count, violations by kind, the last audit's violations and its
    epoch (the audit counter when no epoch is given)."""
    from types import SimpleNamespace

    from bng_tpu.control.metrics import BNGMetrics as JMetrics
    from bng_tpu_torch.control.metrics import BNGMetrics as TMetrics

    got = []
    for p, metrics in zip(PKGS, (JMetrics(), TMetrics())):
        st = engine_stack(p, edge=True)
        clock, server, pools, fp, nat, eng, leased = st
        _inject(p, case, st)
        INV[p.name].audit_invariants(engine=eng, pools=pools, dhcp=server, nat=nat,
                                     metrics=metrics, epoch=7)
        app = SimpleNamespace(components={"engine": eng, "pools": pools, "dhcp": server,
                                          "nat": nat, "metrics": metrics})
        rep = INV[p.name].audit_app(app)  # the app's own metrics, the audit counter as epoch
        got.append((rep.violations_by_kind(), _invariant_samples(metrics)))
    assert got[1] == got[0]
    kinds, samples = got[1]
    assert samples["bng_invariant_audits_total"] == "2"
    assert samples["bng_invariant_last_audit_epoch"] == "2"
    for kind, n in kinds.items():
        assert samples[f'bng_invariant_violations_total{{kind="{kind}"}}'] == str(2 * n)
