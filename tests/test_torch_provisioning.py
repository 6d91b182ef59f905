"""The port's PON and direct-auth modules (`bng_tpu_torch/control/{pon,
direct}.py`) and its `demo` verb against the JAX package's.

- The reference's own cases run on the port (`port_twin`):
  `tests/test_provisioning.py::TestPON` and `TestDirectAuth`, and
  `tests/test_cli.py::TestDemo` with `TestMain::test_demo_command`.
- Seeded ONT discoveries, approvals and disconnects through both
  packages' `PONManager`, and seeded lookups (Nexus cascade, cache, TTL,
  the BSS fallback) through both `DirectAuthenticator`s under one fake
  clock: the same results, states, Nexus records and stats.
- `run_demo` gives the reference's lines and `results` for the same
  subscriber count and clock, and `python -m bng_tpu_torch demo` prints
  them (a host path: no card, no `--device`).

Tolerance: exact.
"""

import dataclasses
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import test_cli as ref_cli
import test_provisioning as ref_prov
from bng_tpu import cli as j_cli
from bng_tpu.control import direct as j_direct
from bng_tpu.control import nexus as j_nexus
from bng_tpu.control import pon as j_pon
from bng_tpu.control import subscriber as j_sub
from bng_tpu_torch import cli as t_cli
from bng_tpu_torch.control import direct as t_direct
from bng_tpu_torch.control import nexus as t_nexus
from bng_tpu_torch.control import pon as t_pon
from bng_tpu_torch.control import subscriber as t_sub

from test_torch_deviceauth import reference_cases, run_on_port

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]

CASES = ([(ref_prov, c) for c in reference_cases(ref_prov, ("TestPON", "TestDirectAuth"))]
         + [(ref_cli, "TestDemo::test_demo_lifecycle"),
            (ref_cli, "TestMain::test_demo_command")])


@pytest.mark.parametrize("module,case", CASES, ids=[f"{m.__name__}::{c}" for m, c in CASES])
def test_reference_case_holds_on_the_port(module, case, request):
    run_on_port(module, case, request)


class Clock:
    def __init__(self, t=1_700_000_000.0):
        self.t = t

    def __call__(self):
        return self.t


def _plain(v):
    if dataclasses.is_dataclass(v):
        return {k: _plain(x) for k, x in dataclasses.asdict(v).items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return getattr(v, "value", v)


def pon_trace(pon, nexus, seed: int):
    rng = np.random.default_rng(seed)
    clk = Clock()
    n = nexus.NexusClient(clock=clk)
    vlans = nexus.VLANAllocator(s_tag_range=(100, 104), c_tag_range=(1, 6))
    m = pon.PONManager(pon.PONConfig(require_approval=bool(seed % 2)), n, vlans, clock=clk)
    log = []
    m.on_provisioned = lambda r: log.append(("provisioned", _plain(r)))
    m.on_disconnected = lambda s: log.append(("disconnected", s))
    serials = [f"ONT-{i:03d}" for i in range(40)]
    for step in range(120):
        clk.t += float(rng.integers(1, 30))
        s = serials[int(rng.integers(0, len(serials)))]
        op = int(rng.integers(0, 4))
        if op == 0:
            if rng.random() < 0.4:
                n.ntes.put(s, nexus.NTEEntity(id=s, serial=s, approved=bool(rng.random() < 0.5)))
            log.append(("discover", s, _plain(m.handle_discovery(pon.DiscoveryEvent(serial=s)))))
        elif op == 1 and n.ntes.get(s) is not None:
            nte = n.ntes.get(s)
            nte.approved = True
            n.ntes.put(s, nte)
        elif op == 2:
            m.handle_disconnect(s)
        log.append(("state", s, _plain(m.get_state(s))))
    log.append(("connected", m.list_connected()))
    log.append(("pending", _plain(m.list_pending())))
    log.append(("stats", _plain(m.get_stats())))
    log.append(("ntes", sorted((k, _plain(v)) for k, v in n.ntes.list().items())))
    return log


@pytest.mark.parametrize("seed", [1, 2])
def test_pon_manager_seeded_trace_equals_reference(seed):
    assert pon_trace(t_pon, t_nexus, seed) == pon_trace(j_pon, j_nexus, seed)


def direct_trace(direct, nexus, sub, seed: int):
    rng = np.random.default_rng(seed)
    clk = Clock()
    n = nexus.NexusClient(clock=clk)
    for i in range(12):
        n.subscribers.put(f"s{i}", nexus.SubscriberEntity(
            id=f"s{i}", mac=f"02:aa:bb:cc:dd:{i:02x}", circuit_id=f"olt1/1/{i}",
            nte_id=f"ONT{i}", isp_id=f"isp-{i % 3}", qos_policy="residential-100mbps"))
        if i % 2:
            n.ntes.put(f"ONT{i}", nexus.NTEEntity(id=f"ONT{i}", serial=f"ONT{i}",
                                                  s_tag=100 + i, c_tag=i))
    bss = direct.StubBSSClient([direct.ONTMapping(ont_serial=f"BSS{i}", circuit_id=f"bss/{i}",
                                                  subscriber_id=f"b{i}", isp_id="isp-b",
                                                  enabled=bool(i % 4))
                                for i in range(8)])
    auth = direct.DirectAuthenticator(nexus=n, bss=bss, clock=clk)
    mgr = sub.SubscriberManager(authenticator=auth, clock=clk)
    log = []
    for _ in range(150):
        clk.t += float(rng.integers(0, 120))
        i = int(rng.integers(0, 16))
        op = int(rng.integers(0, 5))
        if op == 0:
            log.append(_plain(auth.lookup(circuit_id=f"olt1/1/{i}")))
        elif op == 1:
            log.append(_plain(auth.lookup(serial=f"BSS{i % 9}")))
        elif op == 2:
            log.append(_plain(auth.lookup(mac=f"02:aa:bb:cc:dd:{i:02x}")))
        elif op == 3:
            s = mgr.create_session(sub.SessionKind.IPOE, mac=f"02:aa:bb:cc:dd:{i:02x}",
                                   circuit_id=f"olt1/1/{i}")
            log.append((mgr.authenticate(s.id), s.subscriber_id, s.walled,
                        sorted(s.attributes.items())))
        else:
            auth.invalidate_cache(circuit_id=f"olt1/1/{i}")
    log.append(auth.sync_from_bss())
    log.append(dict(auth.stats))
    log.append([_plain(e) for e in bss.events])
    return log


@pytest.mark.parametrize("seed", [3, 4])
def test_direct_authenticator_seeded_trace_equals_reference(seed):
    assert (direct_trace(t_direct, t_nexus, t_sub, seed)
            == direct_trace(j_direct, j_nexus, j_sub, seed))


@pytest.mark.parametrize("n", [1, 4, 9, 16])
def test_run_demo_lines_and_results_equal_reference(n):
    outs = []
    for cli in (j_cli, t_cli):
        buf = io.StringIO()
        res = cli.run_demo(subscriber_count=n, out=buf, clock=Clock())
        outs.append((buf.getvalue(), res))
    assert outs[0] == outs[1]
    assert outs[1][1]["provisioned"] == n and outs[1][1]["active"] == (n + 1) // 2


def test_demo_verb_prints_the_references_lines():
    ref = io.StringIO()
    j_cli.run_demo(subscriber_count=5, out=ref)
    out = subprocess.run([sys.executable, "-m", "bng_tpu_torch", "demo", "--subscribers", "5"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == ref.getvalue()
