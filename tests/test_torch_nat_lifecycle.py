"""The NAT lifecycle of the port against the JAX package, bit for bit.

- `NATManager.expire_sessions` under the same flows and clocks, with and
  without a `nat.expire` skew plan, and `Engine.expire` over the device
  rows after a step has refreshed some sessions: the same sessions
  expire, and the session, reverse and sub_nat tables, the EIM mappings,
  the external-port index, the blocks, the `NATLogEntry` stream and
  `subscriber_octets` are equal.
- `release_nat` followed by a new subscriber on the recycled block: the
  same tables in both packages and no stale reverse row.
- `NATComplianceLogger`: the same event stream gives the same lines in
  json, syslog, csv and nel, the same bulk block records, LEA answers,
  rotated archives and age cleanup (the corpus of
  tests/test_nat_alg_logging.py's TestComplianceLogging).
- CGNAT exhaustion: a burst of 200 refused blocks is counted 200 times
  and logged as many `bng.cgnat` records as the reference logs.

Tolerance: bit-exact (the same words, entries and bytes).
"""

import dataclasses
import gzip
import logging
import os

import numpy as np
import pytest

from bng_tpu.chaos import faults as j_faults
from bng_tpu.control.nat import NATManager as JNAT
from bng_tpu.control import nat as j_nat_mod
from bng_tpu.control.nat_logging import NATComplianceLogger as JLogger
from bng_tpu.control.nat_logging import NATLoggerConfig as JConfig
from bng_tpu.runtime.engine import Engine as JEngine
from bng_tpu.runtime.engine import QoSTables as JQoS
from bng_tpu.runtime.tables import FastPathTables as JFastPath
from bng_tpu_torch import frames as F
from bng_tpu_torch.chaos import faults as t_faults
from bng_tpu_torch.control import nat as t_nat_mod
from bng_tpu_torch.control.nat import NATManager as TNAT
from bng_tpu_torch.control.nat_logging import NATComplianceLogger as TLogger
from bng_tpu_torch.control.nat_logging import NATLoggerConfig as TConfig
from bng_tpu_torch.ops.nat44 import NAT_STATE_ESTABLISHED, SV_PROTO, SV_STATE
from bng_tpu_torch.runtime.engine import Engine as TEngine
from bng_tpu_torch.runtime.engine import QoSTables as TQoS
from bng_tpu_torch.runtime.tables import FastPathTables as TFastPath
from bng_tpu_torch.utils.net import ip_to_u32

pytestmark = pytest.mark.torch_port

NOW = 1_753_000_000
PUB = ip_to_u32("203.0.113.1")
REMOTE = ip_to_u32("93.184.216.34")
SUBS = [ip_to_u32(f"100.64.0.{i}") for i in (5, 6, 7, 8)]
SERVER_MAC = bytes.fromhex("02aabbccdd01")

# (sub index, remote, src port, dst port, proto): two UDP flows share an
# EIM endpoint, a TCP flow, an ICMP echo, a flow per other subscriber
FLOWS = [(0, REMOTE, 40000, 443, 17), (0, REMOTE + 1, 40000, 53, 17), (0, REMOTE, 40001, 443, 6),
         (1, REMOTE, 7, 0, 1), (1, REMOTE + 2, 5000, 5000, 17), (2, REMOTE, 41000, 80, 6),
         (3, REMOTE + 3, 42000, 123, 17)]


def _nat(mod_nat, log):
    nat = mod_nat(public_ips=[PUB], ports_per_subscriber=64, sessions_nbuckets=64,
                  sub_nat_nbuckets=16, stash=8, update_slots=32, log_sink=log.append)
    for ip in SUBS:
        nat.allocate_nat(ip, NOW)
    for sub, dst, sp, dp, proto in FLOWS:
        assert nat.handle_new_flow(SUBS[sub], dst, sp, dp, proto, 100, NOW) is not None
    return nat


def _state(nat):
    """Every piece of NAT state the lifecycle touches, as comparable values."""
    tabs = {t: (getattr(nat, t).keys.copy(), getattr(nat, t).vals.copy(),
                getattr(nat, t).used.copy()) for t in ("sessions", "reverse", "sub_nat")}
    return tabs, dict(nat.eim), dict(nat._ext_ports), dict(nat.blocks), \
        {k: list(v) for k, v in nat._free_blocks.items()}


def _assert_same_nat(t, j):
    (tt, *trest), (jt, *jrest) = _state(t), _state(j)
    for name in tt:
        for a, b in zip(tt[name], jt[name]):
            assert np.array_equal(a, b), name
    assert trest == jrest


def _entries(log):
    return [dataclasses.astuple(e) for e in log]


@pytest.mark.parametrize("skew", [None, 200, -200])
def test_expire_sessions_matches_reference(skew):
    logs = ([], [])
    t, j = _nat(TNAT, logs[0]), _nat(JNAT, logs[1])
    # one TCP flow established (7200 s), the other transient (240 s)
    for nat in (t, j):
        tcp = np.nonzero(nat.sessions.used & (nat.sessions.vals[:, SV_PROTO] == 6))[0]
        nat.sessions.vals[tcp[0], SV_STATE] = NAT_STATE_ESTABLISHED
    counts = []
    for nat, faults in ((t, t_faults), (j, j_faults)):
        plan = faults.FaultPlan(1, [faults.FaultSpec("nat.expire", "skew", at_hit=2,
                                                     arg=skew)] if skew else [])
        with faults.armed(plan, log=False):
            counts.append([nat.expire_sessions(NOW + dt) for dt in (50, 100, 130, 250, 8000)])
    assert counts[0] == counts[1] and sum(counts[0]) == len(FLOWS)
    _assert_same_nat(t, j)
    assert _entries(logs[0]) == _entries(logs[1])
    assert t.subscriber_octets() == j.subscriber_octets()


def test_release_then_reuse_has_no_stale_reverse_row():
    logs = ([], [])
    t, j = _nat(TNAT, logs[0]), _nat(JNAT, logs[1])
    new_ip = ip_to_u32("100.64.1.1")
    for nat in (t, j):
        block = dict(nat.blocks[SUBS[0]])
        assert nat.release_nat(SUBS[0], NOW + 5) and not nat.release_nat(SUBS[0], NOW + 5)
        again = nat.allocate_nat(new_ip, NOW + 6)
        assert again["port_start"] == block["port_start"]
        flow = nat.handle_new_flow(new_ip, REMOTE, 40000, 443, 17, 60, NOW + 7)
        # the recycled port maps the new subscriber only
        rkey = nat._key(REMOTE, flow[0], 443, flow[1], 17)
        assert nat.reverse.lookup(rkey)[0] == new_ip
        assert not any(int(k[0]) == SUBS[0] for k, u in zip(nat.sessions.keys, nat.sessions.used)
                       if u)
    _assert_same_nat(t, j)
    assert _entries(logs[0]) == _entries(logs[1])


def _engine_stack(pkg_fp, pkg_nat, pkg_qos, engine, log, **kw):
    fp = pkg_fp(sub_nbuckets=64, vlan_nbuckets=16, cid_nbuckets=16, max_pools=4)
    nat = _nat(pkg_nat, log)
    return engine(fp, nat, pkg_qos(nbuckets=64), batch_size=16, pkt_slot=512, **kw)


def _flow_frame(sub, dst, sp, dp, proto, payload=b"x" * 60):
    mac = bytes([2, 0, 0, 0, 0, sub])
    if proto == 6:
        return F.tcp_packet(mac, SERVER_MAC, SUBS[sub], dst, sp, dp, payload)
    return F.udp_packet(mac, SERVER_MAC, SUBS[sub], dst, sp, dp, payload)


def test_engine_expire_matches_reference():
    """A step refreshes three flows' last_seen on the device; the sweep
    reads the device rows, so only the others expire."""
    logs = ([], [])
    te = _engine_stack(TFastPath, TNAT, TQoS, TEngine, logs[0], device="cpu")
    je = _engine_stack(JFastPath, JNAT, JQoS, JEngine, logs[1])
    frames = [_flow_frame(*FLOWS[k]) for k in (0, 2, 6)]
    for e in (te, je):
        out = e.process(frames, now=NOW + 100)
        assert [i for i, _ in out["fwd"]] == [0, 1, 2]
    tv, jv = te.fetch_session_vals(), je.fetch_session_vals()
    assert tv.dtype == np.uint32 and np.array_equal(tv, np.asarray(jv))
    assert te.nat.subscriber_octets(tv) == je.nat.subscriber_octets(np.asarray(jv))
    got = [(te.expire(NOW + 150), je.expire(NOW + 150)),
           (te.expire(NOW + 300), je.expire(NOW + 300))]
    assert got[0][0] == got[0][1] == 3 and got[1][0] == got[1][1] == 3
    _assert_same_nat(te.nat, je.nat)
    assert _entries(logs[0]) == _entries(logs[1])
    # the deletions reach both devices with the next step's drain
    for e in (te, je):
        e.process([], now=NOW + 301)
    assert np.array_equal(te.fetch_session_vals(), np.asarray(je.fetch_session_vals()))


def _entry(mod, event, t=1000, priv_port=5000, pub_port=4096, dest_port=443):
    return mod.NATLogEntry(timestamp=t, event_type=event, subscriber_id=7,
                           private_ip=ip_to_u32("100.64.0.5"), public_ip=PUB,
                           private_port=priv_port, public_port=pub_port,
                           dest_ip=REMOTE, dest_port=dest_port, protocol=6)


def _stream(mod):
    """A lifecycle's event stream: the NAT manager's own (assign, create,
    expire, release) and the corpus entries."""
    log = []
    nat = _nat(getattr(mod, "NATManager"), log)
    nat.expire_sessions(NOW + 400)
    nat.release_nat(SUBS[1], NOW + 401)
    log += [_entry(mod, mod.LOG_SESSION_CREATE), _entry(mod, mod.LOG_SESSION_DELETE, t=1100),
            _entry(mod, 5), _entry(mod, 6, pub_port=1), _entry(mod, 9)]
    return log


@pytest.mark.parametrize("fmt", ["json", "syslog", "csv", "nel"])
@pytest.mark.parametrize("bulk", [False, True])
def test_compliance_lines_match_reference(tmp_path, fmt, bulk):
    out = []
    for pkg, (logger, config, mod) in (("t", (TLogger, TConfig, t_nat_mod)),
                                       ("j", (JLogger, JConfig, j_nat_mod))):
        path = str(tmp_path / pkg / "nat.log")
        log = logger(config(file_path=path, fmt=fmt, buffer_size=4, bulk_logging=bulk),
                     clock=lambda: 5000.0)
        for e in _stream(mod):
            log.log_device_event(e)
        log.log_allocation(7, "100.64.0.5", "203.0.113.1", 4096, 5119)
        log.log_session("100.64.0.5", 5000, "203.0.113.1", 4097, "1.1.1.1", 53, 17, end=True)
        log.close()
        out.append((open(path, "rb").read(), log.get_stats()))
    assert out[0] == out[1] and out[0][0]


def test_lea_queries_match_reference():
    answers = []
    for logger, config, mod in ((TLogger, TConfig, t_nat_mod), (JLogger, JConfig, j_nat_mod)):
        clk = [1000.0]
        log = logger(config(), clock=lambda: clk[0])
        blocks = logger(config(bulk_logging=True), clock=lambda: clk[0])
        for e in _stream(mod):
            log.log_device_event(e)
            blocks.log_device_event(e)
        blocks.log_allocation(7, "100.64.0.5", "203.0.113.1", 4096, 5119)
        clk[0] = 3000.0
        blocks.log_allocation(7, "100.64.0.5", "203.0.113.1", 4096, 5119, release=True)
        answers.append([q.query_by_public_endpoint(ip, port, t)
                        for q in (log, blocks)
                        for ip, port, t in (("203.0.113.1", 4096, 1050),
                                            ("203.0.113.1", 4096, 1500),
                                            ("203.0.113.1", 4500, 2000),
                                            ("203.0.113.1", 4500, 3500),
                                            ("203.0.113.1", 1024, NOW + 1),
                                            ("203.0.113.1", 9999, 1500))])
    assert answers[0] == answers[1] and any(answers[0])


def test_rotation_and_age_cleanup_match_reference(tmp_path):
    got = []
    for pkg, (logger, config, mod) in (("t", (TLogger, TConfig, t_nat_mod)),
                                       ("j", (JLogger, JConfig, j_nat_mod))):
        d = tmp_path / pkg
        path = str(d / "nat.log")
        clk = [1000.0]
        log = logger(config(file_path=path, buffer_size=1, max_file_size=200, max_age=100.0),
                     clock=lambda: clk[0])
        for i in range(10):
            log.log_device_event(_entry(mod, mod.LOG_SESSION_CREATE, t=1000 + i))
        log.close()
        archives = sorted(f for f in os.listdir(d) if f.endswith(".gz"))
        bodies = [gzip.open(d / f).read() for f in archives]
        for f in archives:
            os.utime(d / f, (500, 500))
        clk[0] = 1_000_000.0
        got.append((len(archives), bodies, log.get_stats()["rotations"], log.clean_old_logs(),
                    open(path, "rb").read()))
    assert got[0] == got[1] and got[0][0] >= 1


def test_cgnat_exhaustion_is_rate_limited_like_reference():
    """One public IP of 64512 ports per subscriber: the first subscriber
    takes the only block, 200 more are refused."""
    records = []

    class Count(logging.Handler):
        def emit(self, record):
            records.append(record.name)

    lg = logging.getLogger("bng.cgnat")
    handler, level = Count(), lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.DEBUG)
    try:
        counts = []
        for mod_nat in (TNAT, JNAT):
            records.clear()
            nat = mod_nat([0x64400001], ports_per_subscriber=64512)
            got = [nat.allocate_nat(0x0A000000 + i) for i in range(201)]
            assert got[0] is not None and all(g is None for g in got[1:])
            assert nat.exhausted["block"] == 200
            counts.append(len(records))
    finally:
        lg.removeHandler(handler)
        lg.setLevel(level)
    assert counts[0] == counts[1]
    assert 1 <= counts[0] < 200
