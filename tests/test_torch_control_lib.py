"""The port's WiFi gateway, state store and audit modules
(`bng_tpu_torch/control/{wifi,state,audit}.py`) against the JAX package's.

- The reference's own cases run on the port (`port_twin`):
  `tests/test_garden_dns.py::TestWiFiGateway`,
  `tests/test_control_plane.py::TestStateStore` and `TestStateStoreDepth`
  (they stop every background sweep they start) and
  `tests/test_intercept_audit_metrics.py::TestAudit`.
- Seeded operation traces through both packages under one fake clock: the
  WiFi sessions, indexes and stats; the store's records, indexes, sweeps
  and stats. `uuid4` is drawn where the reference draws it (`wifi.py`,
  `audit.py`); the test patches it with the same seeded sequence for each
  package in turn.
- The audit exporters give the same bytes from the same events: RFC 5424
  syslog lines, the 32-byte binary NAT records, JSON lines, and the
  rotated gzip files (names and bytes; gzip's header clock patched the
  same way). The async logger's worker stores and exports in the same
  order as the reference's.
- The state store's background sweep thread starts once and stops on
  `stop()` in both packages.

Tolerance: exact.
"""

import gzip
import types
import uuid

import numpy as np
import pytest

import test_control_plane as ref_cp
import test_garden_dns as ref_gd
import test_intercept_audit_metrics as ref_iam
from bng_tpu.control import audit as j_audit
from bng_tpu.control import state as j_state
from bng_tpu.control import wifi as j_wifi
from bng_tpu_torch.control import audit as t_audit
from bng_tpu_torch.control import state as t_state
from bng_tpu_torch.control import wifi as t_wifi

from test_torch_deviceauth import reference_cases, run_on_port
from test_torch_provisioning import Clock, _plain

pytestmark = pytest.mark.torch_port

CASES = ([(ref_gd, c) for c in reference_cases(ref_gd, ("TestWiFiGateway",))]
         + [(ref_cp, c) for c in reference_cases(ref_cp, ("TestStateStore",
                                                           "TestStateStoreDepth"))]
         + [(ref_iam, c) for c in reference_cases(ref_iam, ("TestAudit",))])


@pytest.mark.parametrize("module,case", CASES, ids=[f"{m.__name__}::{c}" for m, c in CASES])
def test_reference_case_holds_on_the_port(module, case, request):
    run_on_port(module, case, request)


def seeded_uuid4(monkeypatch, seed: int):
    """uuid.uuid4 -> a seeded sequence (both packages call `uuid.uuid4`)."""
    rng = np.random.default_rng(seed)
    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID(int=int.from_bytes(rng.bytes(16), "big"), version=4))


# ---- WiFi ------------------------------------------------------------------

def wifi_trace(wifi, seed: int, olt: bool):
    rng = np.random.default_rng(seed)
    clk = Clock()
    cfg = wifi.default_olt_bng_config() if olt else wifi.default_wifi_config()
    m = wifi.WiFiGatewayManager(cfg, clock=clk)
    log = []
    m.on_session_expire = lambda s: log.append(("expired", s.mac))
    macs = [f"02:aa:00:00:00:{i:02x}" for i in range(24)]
    for _ in range(200):
        clk.t += float(rng.integers(0, 400))
        mac = macs[int(rng.integers(0, len(macs)))]
        op = int(rng.integers(0, 7))
        if op == 0:
            ip = f"10.1.0.{int(rng.integers(2, 60))}" if rng.random() < 0.7 else ""
            log.append(_plain(m.create_session(mac, hostname=f"h{op}", ip=ip)))
        elif op == 1 and m.get_session(mac) is not None:
            m.renew_session(mac)
        elif op == 2 and m.get_session(mac) is not None:
            m.authenticate_session(mac, "portal", f"user-{mac[-2:]}")
        elif op == 3 and m.get_session(mac) is not None:
            m.update_traffic_stats(mac, int(rng.integers(0, 1 << 20)),
                                   int(rng.integers(0, 1 << 20)), 1, 1)
        elif op == 4:
            m.release_session(mac)
        elif op == 5:
            log.append(("expire", m.expire_sessions()))
        log.append((m.is_in_grace_period(mac), m.needs_authentication(mac)))
    log.append(_plain(sorted(m.list_sessions(), key=lambda s: s.mac)))
    log.append(m.stats())
    return log


@pytest.mark.parametrize("seed,olt", [(1, False), (2, False), (3, True)])
def test_wifi_seeded_trace_equals_reference(seed, olt, monkeypatch):
    seeded_uuid4(monkeypatch, seed)
    ref = wifi_trace(j_wifi, seed, olt)
    seeded_uuid4(monkeypatch, seed)
    assert wifi_trace(t_wifi, seed, olt) == ref


# ---- the state store -------------------------------------------------------

def state_trace(state, seed: int):
    rng = np.random.default_rng(seed)
    clk = Clock()
    st = state.Store(clock=clk, session_idle_s=900.0)
    log = []
    for p in range(4):
        st.put_pool(state.PoolRecord(id=f"p{p}", cidr=f"10.{p}.0.0/{16 + 4 * p}",
                                     name=f"pool-{p}", client_class=p % 2,
                                     isp_id=f"isp-{p % 2}"))
    for _ in range(300):
        clk.t += float(rng.integers(0, 240))
        i = int(rng.integers(0, 20))
        sid, mac, ip = f"s{i}", f"02:bb:00:00:00:{i:02x}", f"10.0.{i}.{int(rng.integers(1, 9))}"
        op = int(rng.integers(0, 10))
        if op == 0:
            st.put_subscriber(state.Subscriber(id=sid, mac=mac, circuit_id=f"c{i}",
                                               nte_id=f"n{i % 5}", client_class=i % 2,
                                               isp_id=f"isp-{i % 2}"))
        elif op == 1:
            st.put_lease(state.LeaseRecord(ip=ip, subscriber_id=sid, mac=mac,
                                           expires_at=clk.t + float(rng.integers(60, 3600))))
        elif op == 2:
            st.put_session(state.SessionRecord(id=f"x{i}", subscriber_id=sid, ip=ip, mac=mac,
                                               started_at=clk.t, last_seen=clk.t))
        elif op == 3:
            st.update_session_activity(f"x{i}", bytes_in=int(rng.integers(0, 9999)))
        elif op == 4:
            st.put_nat_binding(state.NATBinding(private_ip=ip, public_ip=f"203.0.113.{i % 3}",
                                                port_start=1024 + 64 * i,
                                                port_end=1024 + 64 * i + 63, subscriber_id=sid))
        elif op == 5:
            log.append(("sweep", st.cleanup_expired_leases(), st.cleanup_idle_sessions(900.0)))
        elif op == 6:
            log.append(("del", st.delete_subscriber(sid), st.delete_lease(ip),
                        st.delete_nat_binding(ip)))
        elif op == 7:
            s = st.get_subscriber(sid)
            if s is not None:
                s.isp_id = "isp-moved"
                st.update_subscriber(s)
            log.append(_plain(st.find_pool_for_subscriber(s)) if s else None)
        elif op == 8:
            st.renew_lease(ip, 600.0)
        log.append((_plain(st.subscriber_by_mac(mac)), _plain(st.lease_by_mac(mac)),
                    _plain(st.session_by_ip(ip)), _plain(st.nat_binding(ip)),
                    _plain(st.nat_binding_by_public(f"203.0.113.{i % 3}", 1024 + 64 * i + 5)),
                    len(st.subscribers_by_nte(f"n{i % 5}"))))
    log.append(_plain(st.list_subscribers()))
    log.append(_plain(st.list_leases()))
    log.append(_plain(st.list_sessions()))
    log.append(st.stats())
    return log


@pytest.mark.parametrize("seed", [5, 6])
def test_state_store_seeded_trace_equals_reference(seed):
    assert state_trace(t_state, seed) == state_trace(j_state, seed)


def test_state_sweep_threads_start_once_and_stop():
    for pkg in (j_state, t_state):
        st = pkg.Store(lease_sweep_interval=0.01)
        st.start()
        th = st._thread
        st.start()  # a second start keeps the one sweeper
        assert st._thread is th and th.is_alive() and th.name == "bng-state-sweep"
        st.stop()
        assert st._thread is None and not th.is_alive()


# ---- audit -----------------------------------------------------------------

def audit_events(audit, seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    kinds = list(audit.EventType)
    out = []
    for i in range(n):
        et = kinds[int(rng.integers(0, len(kinds)))]
        if rng.random() < 0.3:
            et = audit.EventType.NAT_MAPPING if rng.random() < 0.6 else audit.EventType.NAT_EXPIRY
        out.append(audit.Event(
            event_type=et, severity=audit.Severity(int(rng.choice([s.value for s in
                                                                   audit.Severity]))),
            subscriber_id=f"s{int(rng.integers(0, 9))}" if rng.random() < 0.8 else "",
            session_id=f"x{i}", mac=f"02:cc:00:00:00:{i % 256:02x}",
            ip=f"100.64.{i % 7}.{int(rng.integers(1, 250))}",
            nat_public_ip="203.0.113.1" if rng.random() < 0.7 else "",
            nat_public_port=int(rng.integers(1024, 65535)),
            nat_private_port=int(rng.integers(1024, 65535)), protocol=int(rng.choice([6, 17, 1])),
            message=f"event {i}", details={"k": int(rng.integers(0, 99))} if i % 3 else {}))
    return out


def audit_run(audit, seed, tmp, monkeypatch, async_mode: bool):
    seeded_uuid4(monkeypatch, seed)
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1_700_000_000.0))
    clk = Clock()
    sinks = {"syslog": [], "ipfix": [], "json": []}
    log = audit.AuditLogger(min_severity=audit.Severity.INFO, clock=clk, async_mode=async_mode)
    log.add_exporter(audit.SyslogAuditExporter(sinks["syslog"].append))
    log.add_exporter(audit.IPFIXAuditExporter(sinks["ipfix"].append))
    log.add_exporter(audit.JSONAuditExporter(sinks["json"].append))
    rot = audit.RotatingFileExporter(str(tmp / "audit.log"), max_bytes=600, max_files=3,
                                     clock=clk)
    log.add_exporter(rot)
    log.start()
    for i, ev in enumerate(audit_events(audit, seed)):
        clk.t += 1.5
        if async_mode:
            # the worker draws uuid4 at each rotation: ids drawn here as
            # well would interleave with it by thread timing
            ev.id = f"ev-{i}"
        log.log_event(ev)
    if not async_mode:
        log.log_auth(False, username="bob")
        log.log_suspicious("dhcp_starvation", 80, mac="02:00:00:00:00:09")
    log.stop()
    rot.close()
    files = {p.name: (gzip.decompress(p.read_bytes()) if p.suffix == ".gz" else None,
                      p.read_bytes())
             for p in sorted(tmp.iterdir())}
    stored = [(e.id, e.event_type.value, e.timestamp)
              for e in log.storage.query(audit.AuditQuery())]
    return sinks, files, stored, dict(log.stats)


@pytest.mark.parametrize("seed,async_mode", [(7, False), (8, True)])
def test_audit_exports_equal_reference_bytes(seed, async_mode, tmp_path, monkeypatch):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    ref = audit_run(j_audit, seed, tmp_path / "j", monkeypatch, async_mode)
    got = audit_run(t_audit, seed, tmp_path / "t", monkeypatch, async_mode)
    assert got == ref
    sinks, files, stored, stats = got
    assert sinks["ipfix"] and all(len(r) == t_audit.IPFIXAuditExporter.RECORD.size
                                  for r in sinks["ipfix"])
    assert sinks["syslog"][0].startswith(b"<") and b"[bng@32473 " in sinks["syslog"][0]
    assert len([n for n in files if n.endswith(".gz")]) == 3  # rotated and capped
    assert stats["logged"] == len(stored) and stats["filtered"] > 0
