"""The port's cluster control fabric (`bng_tpu_torch/cluster/fabric/`:
`UDPTransport`, `SimTransport`, `FabricMessage`, `FailureDetector`, the peer
states; `collect_fabric`, `collect_handoff`) against the JAX package's.

- The reference's own cases (tests/test_fabric.py: the signed UDP lane,
  the seeded SimTransport, the partition-aware detector, the plan's host
  axis, the RADIUS fan-out and spool across failover, the probe's wall
  time, the bng_fabric_* families and the two fabric chaos scenarios),
  rebound onto the port (`test_torch_deviceauth.port_twin`); the
  two-process SIGKILL case stays in the reference's slow tier.
- Across packages, under one fake clock: a seeded SimTransport's
  delivery pattern through drops, delays and partial and one-way
  partitions; a FailureDetector mesh's state transitions and status
  through a partial partition, a heal, a gray stall and a member's
  death; the signed datagram bytes of one beat; `collect_fabric` and
  `collect_handoff` expositions.

Tolerance: exact.
"""

import json
import types

import pytest

import test_fabric as ref_fb
from test_torch_deviceauth import run_on_port

from bng_tpu.cluster import fabric as j_fabric
from bng_tpu.control.deviceauth import PSKAuthenticator as JPSK
from bng_tpu.control.metrics import BNGMetrics as JMetrics
from bng_tpu_torch.cluster import fabric as t_fabric
from bng_tpu_torch.control.deviceauth import PSKAuthenticator as TPSK
from bng_tpu_torch.control.metrics import BNGMetrics as TMetrics

pytestmark = pytest.mark.torch_port

JAX = types.SimpleNamespace(fabric=j_fabric, PSK=JPSK, Metrics=JMetrics)
PORT = types.SimpleNamespace(fabric=t_fabric, PSK=TPSK, Metrics=TMetrics)
PKGS = (JAX, PORT)


def _cases(cls, skip=()):
    return [f"{cls}::{m}" for m in vars(getattr(ref_fb, cls))
            if m.startswith("test_") and m not in skip]


CASES = (_cases("TestUDPTransport") + _cases("TestSimTransport")
         + _cases("TestFailureDetector") + _cases("TestPlanHostAxis")
         + _cases("TestRadiusFanout") + _cases("TestAccountingSpoolFailover")
         + _cases("TestResilienceProbeWallTime") + _cases("TestFabricMetrics")
         + _cases("TestFabricChaosScenarios"))


@pytest.mark.parametrize("case", CASES)
def test_reference_fabric_case_holds_on_the_port(case, request):
    run_on_port(ref_fb, case, request)


class FakeClock:
    def __init__(self, now=1_700_000_000.0):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def _sim_pattern(m, seed):
    clock = FakeClock()
    hub = m.fabric.SimTransport(clock, seed=seed)
    eps = {n: hub.endpoint(n) for n in ("a", "b", "c")}
    for n, ep in eps.items():
        for p in eps:
            if p != n:
                ep.add_peer(p)
    hub.set_drop("a", "b", 0.4)
    hub.set_delay("c", "a", 1.5)
    log = []
    for step in range(40):
        if step == 10:
            hub.partition("b", "c")
        if step == 20:
            hub.heal("b", "c")
            hub.partition_oneway("a", "c")
        if step == 30:
            hub.heal_all()
        for src in sorted(eps):
            for dst in sorted(eps[src].peers):
                eps[src].send(dst, "beat", {"step": step, "src": src})
        clock.advance(0.5)
        for n in sorted(eps):
            log.append((step, n, [(msg.src, msg.seq, msg.ts, msg.kind, msg.body["step"])
                                  for msg in eps[n].poll()]))
    return log, dict(hub.stats), {n: dict(ep.stats) for n, ep in eps.items()}


@pytest.mark.parametrize("seed", [0, 11, 12])
def test_sim_transport_delivery_equals_reference(seed):
    got = _sim_pattern(PORT, seed)
    assert got == _sim_pattern(JAX, seed)
    assert 0 < got[1]["dropped"] and got[1]["cut"] > 0


def _detector_mesh(m):
    """Three detectors over one SimTransport (the reference tests' mesh):
    a partial partition n0<->n1 and its heal, n1's serving word stalling
    (gray), then n2 going silent (down by quorum). Each round's states,
    verdict transitions and the final status."""
    clock = FakeClock()
    hub = m.fabric.SimTransport(clock, seed=3)
    ids = ["n0", "n1", "n2"]
    dets = {}
    for nid in ids:
        ep = hub.endpoint(nid)
        for p in ids:
            if p != nid:
                ep.add_peer(p)
        dets[nid] = m.fabric.FailureDetector(nid, ep, clock=clock, beat_interval_s=0.5,
                                             suspicion_threshold=3, gray_beats=4,
                                             startup_grace_s=0.0)
    for nid in ids:
        for p in ids:
            if p != nid:
                dets[nid].watch(p, now=clock())
    trace = []
    for rnd in range(48):
        if rnd == 4:
            hub.partition("n0", "n1")
        if rnd == 14:
            hub.heal_all()
        for nid, d in dets.items():
            if nid == "n2" and rnd >= 36:
                continue  # n2 died
            served = 8 * rnd if not (nid == "n1" and 22 <= rnd < 32) else 8 * 22
            d.beat(served=served, work=8 * rnd)
        moved = {nid: d.tick(clock()) for nid, d in dets.items()}
        clock.advance(0.5)
        trace.append(({n: {p: v.state for p, v in sorted(d.views.items())}
                       for n, d in dets.items()}, repr(moved)))
    return trace, {n: json.dumps(d.status(), sort_keys=True, default=str)
                   for n, d in dets.items()}


def test_failure_detector_transitions_equal_reference():
    got = _detector_mesh(PORT)
    assert got == _detector_mesh(JAX)
    seen = {s for states, _m in got[0] for views in states.values() for s in views.values()}
    assert {"up", "suspect", "gray", "down"} <= seen


def test_signed_datagram_equals_reference():
    """The signed string and its signature, and a verified round trip over
    loopback UDP from one package's endpoint to the other's."""
    from bng_tpu.cluster.fabric import transport as j_tr
    from bng_tpu_torch.cluster.fabric import transport as t_tr

    body = {"served": 3, "work": 4, "accuse": ["bng-b"], "backlog": False}
    psk = "fabric-test-psk-0123456789"
    sig = [(m_tr._canonical("node-a", 7, 1_700_000_000.25, "beat", body),
            m.PSK(psk=psk).sign_message(m_tr._canonical("node-a", 7, 1_700_000_000.25,
                                                         "beat", body)))
           for m, m_tr in ((JAX, j_tr), (PORT, t_tr))]
    assert sig[1] == sig[0]
    clock = FakeClock()
    a = t_fabric.UDPTransport("node-a", TPSK(psk=psk), clock=clock)
    b = j_fabric.UDPTransport("node-b", JPSK(psk=psk), clock=clock)
    try:
        a.add_peer("node-b", b.addr)
        b.add_peer("node-a", a.addr)
        assert a.send("node-b", "beat", body) and b.send("node-a", "beat", body)
        got = []
        for ep in (b, a):
            for _ in range(100):
                msgs = ep.poll()
                if msgs:
                    got.append([(x.src, x.seq, x.kind, x.body) for x in msgs])
                    break
                import time
                time.sleep(0.01)
        assert got == [[("node-a", 1, "beat", body)], [("node-b", 1, "beat", body)]]
    finally:
        a.close()
        b.close()


def test_fabric_and_handoff_expositions_equal_reference():
    status = ref_fb.TestFabricMetrics()._status(state="gray", accusers=("coordinator",))
    status["handoff"] = {"tx_chunks": 9, "retx_chunks": 2, "rx_chunks": 7, "rx_corrupt": 1,
                         "rx_dup": 3, "rx_orphan": 0, "completed": 2, "rejects": 1,
                         "resumes": 1}
    texts = []
    for m in PKGS:
        met = m.Metrics()
        met.collect_fabric(status)
        met.collect_fabric({**status, "peers": {}})  # the departed member's labels drop
        met.record_member({"join_retries": 4, "handoff": status["handoff"]})
        texts.append(met.expose())
    assert texts[1] == texts[0]
    assert 'bng_handoff_chunks_total{disposition="retx"} 2' in texts[1]
