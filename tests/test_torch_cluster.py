"""The port's cluster of BNGs (`bng_tpu_torch/cluster/`: plan, instance,
coordinator, member, handoff; `cluster run|status`, `_audit_cluster`, the
checkpoint's `cluster_plan` component, `record_cluster`, `record_member`)
against the JAX package's.

- The reference's own cases (tests/test_cluster.py and
  tests/test_multibox.py: the carve-plan law, coordinator lifecycle, HA
  failover, the planted audit violations, checkpoint interop, the instance,
  the handoff corruption and resume cases, the multi-box join and host
  loss over the SimTransport, the join backoff and the metrics), rebound
  onto the port (`test_torch_deviceauth.port_twin`).
- Across packages: the carve and every replan equal; a coordinator's
  status, its handoff checkpoint bytes and its `cluster_plan` checkpoint
  equal, each restoring into the other package's coordinator; the audit's
  report on a clean cluster and on each planted violation equal; `cluster
  run --once` (inline) and `cluster status --from-checkpoint` print the
  same text; `record_cluster`'s exposition equal.

The cluster is host code: no instance builds an engine, so nothing here
launches a kernel. Tolerance: exact.
"""

import json
import types

import pytest

import test_cluster as ref_cl
import test_multibox as ref_mb
from test_torch_deviceauth import run_on_port

from bng_tpu import cli as j_cli
from bng_tpu import cluster as j_cluster
from bng_tpu.chaos import faults as j_faults
from bng_tpu.chaos import invariants as j_inv
from bng_tpu.chaos import scenarios as j_sc
from bng_tpu.cluster import handoff as j_handoff
from bng_tpu.control.metrics import BNGMetrics as JMetrics
from bng_tpu.runtime import checkpoint as j_ck
from bng_tpu_torch import cli as t_cli
from bng_tpu_torch import cluster as t_cluster
from bng_tpu_torch.chaos import faults as t_faults
from bng_tpu_torch.chaos import invariants as t_inv
from bng_tpu_torch.chaos import scenarios as t_sc
from bng_tpu_torch.cluster import handoff as t_handoff
from bng_tpu_torch.control.metrics import BNGMetrics as TMetrics
from bng_tpu_torch.runtime import checkpoint as t_ck
from bng_tpu_torch.utils.net import ip_to_u32

pytestmark = pytest.mark.torch_port

JAX = types.SimpleNamespace(cl=j_cluster, faults=j_faults, inv=j_inv, sc=j_sc, ck=j_ck,
                            cli=j_cli, Metrics=JMetrics, handoff=j_handoff)
PORT = types.SimpleNamespace(cl=t_cluster, faults=t_faults, inv=t_inv, sc=t_sc, ck=t_ck,
                             cli=t_cli, Metrics=TMetrics, handoff=t_handoff)
PKGS = (JAX, PORT)
SPACE = ip_to_u32("10.64.0.0")
NOW = 1_753_000_000.0


# ---- the reference's cases on the port ------------------------------------

def _cases(module, cls, skip=()):
    return [f"{cls}::{m}" for m in vars(getattr(module, cls))
            if m.startswith("test_") and m not in skip]


CLUSTER_CASES = (_cases(ref_cl, "TestPlan") + _cases(ref_cl, "TestCoordinator")
                 + _cases(ref_cl, "TestFailover") + _cases(ref_cl, "TestAuditCluster")
                 + _cases(ref_cl, "TestChaosIntegration") + _cases(ref_cl, "TestInstance")
                 + _cases(ref_cl, "TestClusterMetrics"))
MULTIBOX_CASES = (_cases(ref_mb, "TestHandoffCorruption") + _cases(ref_mb, "TestHandoffOverSimFabric")
                  + _cases(ref_mb, "TestMultiboxSimFlow") + _cases(ref_mb, "TestJoinBackoff")
                  + _cases(ref_mb, "TestMultiboxMetrics"))


@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_reference_cluster_case_holds_on_the_port(case, request):
    run_on_port(ref_cl, case, request)


@pytest.mark.parametrize("case", MULTIBOX_CASES)
def test_reference_multibox_case_holds_on_the_port(case, request):
    run_on_port(ref_mb, case, request)


# ---- across packages -------------------------------------------------------

def _coord(m, **kw):
    kw.setdefault("clock", m.faults.SimClock())
    kw.setdefault("space_network", SPACE)
    kw.setdefault("space_prefix_len", 16)
    kw.setdefault("sub_nbuckets", 0)
    kw.setdefault("slice_size", 64)
    return m.cl.ClusterCoordinator(**kw)


def _plan_dict(plan):
    return json.dumps(plan.to_dict(), sort_keys=True)


@pytest.mark.parametrize("hosts", [False, True], ids=["one-host", "host-axis"])
def test_carve_and_replans_equal_reference(hosts):
    got = []
    for m in PKGS:
        kw = {"hosts": {"a": "h1", "b": "h2", "c": "h1", "d": "h2"}} if hosts else {}
        plan = m.cl.initial_plan(SPACE, 16, ["a", "b", "c"], **kw)
        steps = [_plan_dict(plan)]
        for members in (["a", "b", "c", "d"], ["a", "c", "d"], ["a", "c", "d", "e"], ["c"]):
            plan = m.cl.replan(plan, members, **kw)
            steps.append(_plan_dict(plan))
        macs = [bytes([2, 0, 0, 0, i >> 8, i & 0xFF]) for i in range(64)]
        steps.append([m.cl.instance_for_mac(mac, ["a", "c", "d", "e"]) for mac in macs])
        steps.append(m.cl.elect_carver(["d", "b", "c"]))
        got.append(steps)
    assert got[1] == got[0]


def _driven(m, n=24):
    """A three-instance coordinator after a DORA wave through its front
    door (and the renewals of half of it)."""
    clock = m.faults.SimClock()
    coord = _coord(m, clock=clock)
    coord.add_instances(["bng-a", "bng-b", "bng-c"])
    macs = [m.sc._mac(0x400 + i) for i in range(n)]
    leased = m.sc.dora_with_retries(coord, macs, clock)
    return coord, leased


def _handoff_components(coord, iid):
    m = coord.members[iid]
    return {"cluster_plan": coord.plan.to_dict(),
            "member": {"instance_id": iid,
                       "sessions": [s.to_dict() for s in m.store.all()] if m.store else []}}


def test_status_handoff_and_plan_checkpoints_equal_and_cross_restore():
    coords = [_driven(m) for m in PKGS]
    try:
        (jc, jl), (tc, tl) = coords
        assert tl == jl and len(tl) == 24
        assert json.dumps(tc.status(), sort_keys=True, default=str) == \
            json.dumps(jc.status(), sort_keys=True, default=str)
        # each member's carve handoff (the plan and its mirrored HA
        # sessions, as the coordinator streams it): the same bytes, and
        # each package parses the other's
        for iid in sorted(jc.members):
            a, b = (m.handoff.build_handoff_checkpoint(c.plan.epoch, _handoff_components(c, iid))
                    for m, c in ((JAX, jc), (PORT, tc)))
            assert a == b
            assert PORT.handoff.parse_handoff_checkpoint(a) == \
                JAX.handoff.parse_handoff_checkpoint(b) == _handoff_components(jc, iid)
        # the cluster_plan component: byte-equal, each restoring the other's
        blobs = [m.ck.encode_checkpoint(m.ck.build_checkpoint(1, NOW, cluster_plan=c))
                 for m, (c, _l) in zip(PKGS, coords)]
        assert blobs[0] == blobs[1]
        rows = []
        for dst, blob in ((PORT, blobs[0]), (JAX, blobs[1])):
            fresh = _coord(dst)
            try:
                rows.append(dst.ck.restore_checkpoint(dst.ck.decode_checkpoint(blob),
                                                      cluster_coord=fresh))
                rows.append(_plan_dict(fresh.plan))
            finally:
                fresh.close()
        assert rows[0] == rows[2] and rows[1] == rows[3] == _plan_dict(tc.plan)
    finally:
        for c, _l in coords:
            c.close()


def _plant(kind, coord, sc):
    inst = coord.members["bng-a"].instance
    book = inst.fleet._inline[0].server.leases
    lease = next(iter(book.values()))
    if kind == "foreign-ip":
        lease.ip = ip_to_u32("192.168.7.7")
    elif kind == "double-ownership":
        other = coord.members["bng-b"].instance.fleet._inline[0].server.leases
        o = next(iter(other.values()))
        lease.ip = o.ip
    elif kind == "missteer":
        # the lease moves to a member its MAC never steers to, inside that
        # member's carve, so only the steering clause fires
        ids = coord.member_ids()
        wrong = next(i for i in ids if i != "bng-a")
        del book[next(iter(book))]
        lease.ip = coord.plan.members[wrong].blocks[0].network + 9
        coord.members[wrong].instance.fleet._inline[0].server.leases[0xFEED] = lease
    elif kind == "no-plan":
        coord.plan = None


@pytest.mark.parametrize("kind", ["clean", "foreign-ip", "double-ownership", "missteer",
                                  "no-plan"])
def test_audit_cluster_reports_equal_reference(kind):
    reps = []
    for m in PKGS:
        coord, _l = _driven(m, n=12)
        try:
            _plant(kind, coord, m.sc)
            reps.append(m.inv.audit_invariants(bng_cluster=coord,
                                               check_roundtrip=False).to_dict())
        finally:
            coord.close()
    assert reps[1] == reps[0]
    assert reps[1]["ok"] == (kind == "clean")
    if kind != "clean":
        assert any(k.startswith("cluster-") for k in reps[1]["violations_by_kind"])


def test_record_cluster_exposition_equals_reference():
    texts = []
    for m in PKGS:
        coord, _l = _driven(m, n=12)
        try:
            met = m.Metrics()
            met.record_cluster(coord.status())
            coord.remove_instance("bng-c", force=True)
            met.record_cluster(coord.status())
            texts.append(met.expose())
        finally:
            coord.close()
    assert texts[1] == texts[0]
    assert 'bng_cluster_instances{state="up"}' in texts[1]


def test_cli_cluster_run_once_and_status_print_the_references_text(tmp_path, capsys, monkeypatch):
    import time

    monkeypatch.setattr(time, "time", lambda: NOW)  # the checkpoint's stamp
    out = []
    for m in PKGS:
        ck = str(tmp_path / f"{m is PORT}.ckpt")
        assert m.cli.main(["cluster", "run", "--instances", "4", "--subscribers", "256",
                           "--once", "--checkpoint-out", ck]) == 0
        run_text = capsys.readouterr().out.replace(ck, "CKPT")
        assert m.cli.main(["cluster", "status", "--from-checkpoint", ck]) == 0
        out.append((run_text, capsys.readouterr().out, open(ck, "rb").read()))
    assert out[1] == out[0]
    wave = json.loads(out[1][0])["wave"]
    assert wave == {"subscribers": 256, "leased": 256, "unique_ips": 256, "shed": 0, "ok": True}
    assert json.loads(out[1][1])["blocks"] == 4
    # the port reads the reference's checkpoint and the other way round
    assert t_cli.main(["cluster", "status", "--from-checkpoint",
                       str(tmp_path / "False.ckpt")]) == 0
    assert capsys.readouterr().out == out[0][1]
    assert t_cli.main(["cluster", "status"]) == 2
    assert "required" in capsys.readouterr().err


def test_process_child_imports_no_torch():
    """A `--mode process` member's child runs the instance loop without
    torch (its spawn start re-imports the cluster package and the fleet)."""
    import subprocess
    import sys

    code = ("import sys\n"
            "from bng_tpu_torch.cluster.instance import InlineInstance, InstanceSpec\n"
            "from bng_tpu_torch.cluster.plan import initial_plan\n"
            "plan = initial_plan(0x0A400000, 16, ['a'])\n"
            "spec = InstanceSpec.from_plan(plan.members['a'], plan, server_mac=bytes(6),\n"
            "                              server_ip=0x0A400001)\n"
            "inst = InlineInstance(spec, clock=lambda: 0.0)\n"
            "print(inst.status()['leases'], 'torch' in sys.modules)\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert got.returncode == 0, got.stderr
    assert got.stdout.split() == ["0", "False"]
