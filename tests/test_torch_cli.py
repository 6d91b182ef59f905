"""The port's composition root and command line against the JAX package's.

- Config: `BNGConfig` has the reference's fields and defaults; the run
  flags parse the same argv to the same config, and the YAML overlay
  fills what the command line did not set (the command line wins).
- The app, scheduler off and on: both packages' `BNGApp` over a `PyRing`
  at one held clock serve a DORA (DISCOVER and REQUEST to the slow path),
  a renewal answered on the device, and a new UDP flow punted to NAT,
  with the same reply bytes on the TX ring and the same `stats()` for
  the components both have; then `tick()` past the lease and the NAT
  idle timeout ages out the lease and the session in both.
- The protocol servers: both packages' `BNGApp` with PPPoE (local CHAP
  users), DHCPv6 and SLAAC on, scheduler off and on, over a `PyRing` at
  one held clock: a PPPoE session negotiated through the ring (PADI to
  IPCP, the demux's pending frames drained by `drive_once`), its data
  decapped and SNAT'd on the device and a downstream reply encapped, a
  DHCPv6 rapid-commit SOLICIT and a router solicitation answered through
  the demux, then `tick()` past the keepalive and the leases: the same TX
  and FWD bytes, the same `stats()` for the shared components (with the
  `pppoe` block) and the same session tables and lease books after.
- RADIUS: both apps with a RADIUS server (the reference's fake on the
  client's transport) authenticate PPPoE through `RadiusVerifier` and a
  DHCP subscriber through the authenticator, send the same accounting
  records, and answer the same CoA-Request and Disconnect-Requests on the
  CoA listener's socket.
- The audit: `audit_app` passes on the composed app with its DHCPv6 and
  PPPoE clauses and reports what the reference's reports, and
  `checkpoint restore --audit` exits 0.
- Refusal: a config that turns on subsystems the port lacks raises one
  error that names each of them and the flag that turns it off; metrics
  is the only one the reference's defaults turn on.
- `main(["--device", "cpu", "run", "--once", "--no-metrics-enabled"])`
  exits 0; with no card and no `--device cpu` it exits non-zero, and
  `BNGApp` raises.

Tolerance: exact (bytes, dicts).
"""

import argparse
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bng_tpu import cli as j_cli
from bng_tpu.runtime.ring import PyRing as JRing
from bng_tpu_torch import cli as t_cli
from bng_tpu_torch import frames as F
from bng_tpu_torch.runtime.ring import PyRing as TRing
from bng_tpu_torch.utils.net import ip_to_u32

pytestmark = pytest.mark.torch_port

NOW = 1_753_000_000
JAX = SimpleNamespace(name="jax", cli=j_cli, Ring=JRing, kw={})
PORT = SimpleNamespace(name="port", cli=t_cli, Ring=TRing, kw={"device": "cpu"})
# what the port refuses, off: the reference builds the same stack then
WORKING = dict(metrics_enabled=False)
WORKING_FLAGS = ["--no-metrics-enabled"]


def _defaults(cls):
    out = []
    for f in dataclasses.fields(cls):
        d = f.default if f.default is not dataclasses.MISSING else f.default_factory()
        out.append((f.name, f.type, d))
    return out


def test_config_fields_and_defaults_match():
    assert _defaults(t_cli.BNGConfig) == _defaults(j_cli.BNGConfig)


def _parse(m, argv):
    p = argparse.ArgumentParser()
    m._add_run_flags(p)
    return m._config_from_args(p.parse_args(argv))


def test_flags_and_yaml_overlay_match(tmp_path):
    f = tmp_path / "bng.yaml"
    f.write_text("server-ip: 10.9.0.1\nlease-time: 600\nnat-enabled: false\n"
                 "bogus-key: 1\npools:\n  - cidr: 10.1.0.0/24\n    lease_time: 300\n")
    argv = ["--server-ip", "10.1.1.1", "--batch-size", "64", "--scheduler-enabled",
            "--nat-public-ips", "203.0.113.7", "203.0.113.8", "--no-qos-enabled",
            "--sched-express-max-wait-us", "50", "--config", str(f)]
    got = [dataclasses.asdict(_parse(m, argv)) for m in (j_cli, t_cli)]
    assert got[1] == got[0]
    cfg = got[1]
    assert cfg["server_ip"] == "10.1.1.1" and cfg["lease_time"] == 600  # CLI wins, YAML fills
    assert cfg["nat_enabled"] is False and cfg["pools"][0]["cidr"] == "10.1.0.0/24"
    assert t_cli.resolve_secret("inline", "") == "inline"


def _client(mac, msg_type, **kw):
    p = F.build_request(mac, msg_type, **kw)
    p.options.append((F.OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 51, 54])))
    return F.udp_packet(mac, b"\xff" * 6, kw.get("ciaddr", 0),
                        0xFFFFFFFF if not kw.get("ciaddr") else ip_to_u32("10.0.0.1"),
                        68, 67, p.encode().ljust(320, b"\x00"))


def _beat(app, ring, clk, frames, beats=3):
    """Push frames, drive until they are served (the held clock steps 5 ms a
    beat, past the bulk lane's deadline), return the TX frames."""
    for f in frames:
        assert ring.rx_push(f, from_access=True)
    for _ in range(beats):
        clk[0] += 0.005
        app.drive_once()
    if "scheduler" in app.components:  # retire what is in flight, then one beat injects it
        app.components["scheduler"].flush()
        app.drive_once()
    else:
        app.components["engine"].flush_pipeline(ring)
    out = []
    while (got := ring.tx_pop()) is not None:
        out.append(bytes(got[0]) if isinstance(got, tuple) else bytes(got))
    return out


def _stats_shared(st):
    return {k: st[k] for k in ("version", "node_id", "engine", "dhcp", "pools", "nat")}


def _serve(m, scheduler: bool):
    clk = [float(NOW)]
    cfg = m.cli.BNGConfig(pool_cidr="10.50.0.0/24", lease_time=600, batch_size=32,
                          scheduler_enabled=scheduler, sched_express_batch=8,
                          sched_express_max_wait_us=0.0, **WORKING)
    app = m.cli.BNGApp(cfg, clock=lambda: clk[0], **m.kw)
    try:
        ring = app.components["ring"] = m.Ring(256, 2048, 128)
        mac = bytes.fromhex("02deadbeef01")
        steps = [_beat(app, ring, clk, [_client(mac, F.DISCOVER, xid=0x1234)])]
        offer = F.decode_dhcp(F.decode(steps[0][0]).payload)
        steps.append(_beat(app, ring, clk, [_client(mac, F.REQUEST, xid=0x1235,
                                               requested_ip=offer.yiaddr,
                                               server_id=ip_to_u32("10.0.0.1"))]))
        ack = F.decode_dhcp(F.decode(steps[1][0]).payload)
        clk[0] += 30
        steps.append(_beat(app, ring, clk, [_client(mac, F.REQUEST, xid=0x1236,
                                               ciaddr=ack.yiaddr)]))
        flow = F.udp_packet(mac, b"\x02\x00\x00\x00\x00\x01", ack.yiaddr,
                            ip_to_u32("93.184.216.34"), 40000, 53, b"q" * 40)
        steps.append(_beat(app, ring, clk, [flow]))
        dhcp, nat = app.components["dhcp"], app.components["nat"]
        before = (len(dhcp.leases), nat.sessions.count, dhcp.stats.ack)
        st = _stats_shared(app.stats())
        clk[0] += 10_000  # past the lease (600 s) and the UDP idle timeout
        app.tick(clk[0])
        after = (len(dhcp.leases), nat.sessions.count)
        return steps, offer.yiaddr, before, st, after
    finally:
        app.close()


@pytest.mark.parametrize("scheduler", [False, True], ids=["engine", "scheduler"])
def test_dora_renewal_flow_and_tick_match_reference(scheduler):
    ref, got = _serve(JAX, scheduler), _serve(PORT, scheduler)
    assert got == ref
    steps, yiaddr, before, st, after = got
    assert all(len(s) == 1 for s in steps[:3])  # OFFER, ACK, the renewal's ACK
    assert before == (1, 1, 1) and after == (0, 0)  # the renewal ACK came from the device
    assert st["dhcp"]["discover"] == 1 and st["nat"] == {"sessions": 1, "blocks": 1}


def test_refusal_names_every_unported_subsystem():
    on = dict(ha_role="active",
              cluster_listen="127.0.0.1:0", slowpath_workers=2, wire_if="eth9", shards=2,
              telemetry_enabled=True, checkpoint_dir="/nonexistent", dns_enabled=True,
              bgp_enabled=True, nexus_url="http://nexus", peer_pool_cidr="10.9.0.0/24",
              peer_pool_nodes=[{"node": "bng0", "url": "http://x"}], device_auth_method="psk")
    cfg = t_cli.BNGConfig(**on)
    with pytest.raises(t_cli.UnportedSubsystemError) as e:
        t_cli.BNGApp(cfg, device="cpu")
    msg = str(e.value)
    assert len(t_cli.unported(cfg)) == len(t_cli.UNPORTED)
    for _on, what, flag in t_cli.UNPORTED:
        assert what in msg and flag in msg
    assert t_cli.UNPORTED[0][1] == "metrics"  # the one the defaults turn on
    for flag in WORKING_FLAGS:
        assert flag in str(pytest.raises(t_cli.UnportedSubsystemError,
                                         t_cli.BNGApp, t_cli.BNGConfig(), device="cpu").value)
    assert t_cli.unported(t_cli.BNGConfig(**WORKING)) == []
    ported = t_cli.BNGConfig(radius_server="127.0.0.1:1812", pppoe_enabled=True, **WORKING)
    assert t_cli.unported(ported) == []


def test_main_run_once_on_cpu(capsys):
    assert t_cli.main(["--device", "cpu", "run", "--once"] + WORKING_FLAGS) == 0
    assert '"device": "cpu"' in capsys.readouterr().out
    assert t_cli.main(["--device", "cpu", "run", "--once"]) == 2  # the defaults refuse
    assert "--no-metrics-enabled" in capsys.readouterr().err
    assert t_cli.main(["version"]) == 0


def test_main_and_app_need_a_card_unless_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_cli.main(["run", "--once"] + WORKING_FLAGS) != 0
    assert "device='cpu'" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cli.BNGApp(t_cli.BNGConfig(**WORKING))
    assert t_cli.main(["loadtest", "--duration", "0.1"]) != 0


# ---- the protocol servers behind `run`: PPPoE, DHCPv6, SLAAC, RADIUS, CoA ----

PPPOE_USERS = [{"username": "alice", "password": "secret123"}]
WAN = ip_to_u32("8.8.8.8")


def _seed_pppoe(app):
    """The PPPoE server's randomness, the same in both packages."""
    srv = app.components["pppoe"]
    srv.config.cookie_secret = b"k" * 16
    srv._magic = lambda: 0xDEADBEEF
    srv.chap._mkchallenge = lambda: b"C" * 16


def _ring_client(app, ring, clk, log):
    """The reference's simulated PPPoE client, its frames through the ring;
    every TX frame is kept in `log`."""
    from test_pppoe import SimClient

    class RingClient(SimClient):
        def _pump(cli, frames, now):
            pending = list(frames)
            while pending:
                out = _beat(app, ring, clk, pending)
                log.extend(out)
                pending = [r for f in out if f[12:14] in (b"\x88\x63", b"\x88\x64")
                           for r in cli._react(f, now)]

    return RingClient(app.components["pppoe"], mac=bytes.fromhex("02cc00000007"))


def _fwd(ring):
    out = []
    while (got := ring.fwd_pop()) is not None:
        out.append(bytes(got[0]))
    return out


def _serve_protocols(m, scheduler: bool):
    from test_v6 import solicit
    from test_torch_v6 import _rs

    clk = [float(NOW)]
    cfg = m.cli.BNGConfig(pool_cidr="10.50.0.0/24", lease_time=600, batch_size=32,
                          scheduler_enabled=scheduler, sched_express_batch=8,
                          sched_express_max_wait_us=0.0, pppoe_enabled=True,
                          pppoe_users=PPPOE_USERS, **WORKING)
    app = m.cli.BNGApp(cfg, clock=lambda: clk[0], **m.kw)
    try:
        assert app.components["engine"].slow_path is app.components["slowpath"]
        _seed_pppoe(app)
        ring = app.components["ring"] = m.Ring(256, 2048, 128)
        tx, fwd = [], []
        cli = _ring_client(app, ring, clk, tx)
        cli.connect(now=clk[0])
        assert cli.ipcp_done and cli.ip
        up = F.pppoe_session_frame(
            app.components["pppoe"].config.server_mac, cli.mac, cli.session_id, F.PROTO_IPV4,
            F.udp_packet(cli.mac, b"\x00" * 6, cli.ip, WAN, 40000, 53, b"q" * 24)[14:])
        # the first punts (the NAT session), the second forwards; the
        # scheduler's retire puts forwarded frames on the TX ring too
        for _ in range(2):
            tx += _beat(app, ring, clk, [up])
            fwd += _fwd(ring)
        data = [f for f in tx + fwd if f[12:14] == b"\x08\x00" and F.decode(f).dst_port == 53]
        snat = F.decode(data[-1])
        down = F.udp_packet(b"\x02\x47\x57\x00\x00\x01", b"\x02\xaa\xbb\xcc\xdd\x01", WAN,
                            snat.src_ip, 53, snat.src_port, b"r" * 24)
        assert ring.rx_push(down, from_access=False)
        tx += _beat(app, ring, clk, [])
        fwd += _fwd(ring)
        # the downstream reply, encapped: a PPPoE session frame carrying IPv4
        data += [f for f in tx + fwd if f[12:14] == b"\x88\x64" and f[20:22] == b"\x00\x21"]
        mac6 = bytes.fromhex("02d600000001")
        ll = bytes.fromhex("fe80000000000000") + mac6[:3] + b"\xff\xfe" + mac6[3:]
        sol = F.udp6_packet(mac6, bytes.fromhex("333300010002"), ll,
                            bytes.fromhex("ff020000000000000000000000010002"), 546, 547,
                            solicit(rapid=True).encode())
        tx += _beat(app, ring, clk, [sol, _rs(mac6)])
        st = app.stats()
        shared = {k: st[k] for k in ("engine", "dhcp", "pools", "nat", "pppoe")}
        clk[0] += 31  # past the keepalive interval: an echo, and SLAAC's periodic RA
        app.tick(clk[0])
        tx += _beat(app, ring, clk, [])
        clk[0] += 10_000  # past the v6 lease and the PPPoE echo budget
        for k in range(6):
            app.tick(clk[0] + 31 * k)
        tx += _beat(app, ring, clk, [])
        c = app.components
        after = (len(c["pppoe"].sessions), len(c["dhcpv6"].leases),
                 [(t, int(np.asarray(getattr(c["pppoe_tables"], t).used).sum()))
                  for t in ("by_sid", "by_ip")], c["slowpath"].stats)
        return tx, fwd, data, shared, after
    finally:
        app.close()


@pytest.mark.parametrize("scheduler", [False, True], ids=["engine", "scheduler"])
def test_protocol_servers_through_the_app_match_reference(scheduler):
    ref, got = _serve_protocols(JAX, scheduler), _serve_protocols(PORT, scheduler)
    assert got == ref
    tx, fwd, data, shared, after = got
    # both upstream frames decap (the first then punts for its NAT session)
    assert shared["pppoe"]["opened"] == 1 and shared["pppoe"]["device"] == {"decap": 2,
                                                                            "encap": 1}
    assert len(data) == 2 and F.decode(data[0]).src_ip == ip_to_u32("203.0.113.1")
    assert F.l4_checksum_ok(data[0])
    assert any(f[12:14] == b"\x86\xdd" and f[62] == 7 for f in tx)  # the DHCPv6 REPLY
    assert any(f[12:14] == b"\x86\xdd" and f[54] == 134 for f in tx)  # an RA
    assert after[0] == 0 and after[1] == 0 and after[2] == [("by_sid", 0), ("by_ip", 0)]


def _coa_send(app, raw):
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.settimeout(5.0)
        s.sendto(raw, ("127.0.0.1", app.components["coa"].addr[1]))
        return s.recvfrom(4096)[0]
    finally:
        s.close()


def _serve_radius(m, monkeypatch):
    from test_radius import FakeRadiusServer
    from test_torch_radius import PKGS as RADIUS_PKGS, Wire

    from bng_tpu.control.radius import packet as rp

    pkg = RADIUS_PKGS[0 if m is JAX else 1]
    rng = np.random.default_rng(5)
    monkeypatch.setattr(pkg.rp, "new_request_authenticator",
                        lambda: rng.integers(0, 256, 16, dtype=np.uint8).tobytes())
    clk = [float(NOW)]
    cfg = m.cli.BNGConfig(pool_cidr="10.50.0.0/24", lease_time=600, batch_size=32,
                          pppoe_enabled=True, radius_server="10.0.0.5:1812",
                          radius_secret="s3cr3t", coa_listen="127.0.0.1:0", **WORKING)
    app = m.cli.BNGApp(cfg, clock=lambda: clk[0], **m.kw)
    try:
        c = app.components
        _seed_pppoe(app)
        wire = Wire(FakeRadiusServer(secret=b"s3cr3t", users={
            "alice": {"password": "secret123", "attrs": [(rp.FILTER_ID, "residential-100mbps")]},
            "": {"password": ""}}))  # the DHCP subscribers' MAC authentication
        c["radius"].transport, c["radius"].clock = wire, lambda: clk[0]
        ring = c["ring"] = m.Ring(256, 2048, 128)
        tx = []
        cli = _ring_client(app, ring, clk, tx)
        cli.connect(now=clk[0])
        assert cli.ipcp_done
        mac = bytes.fromhex("02deadbeef01")
        tx += _beat(app, ring, clk, [_client(mac, F.DISCOVER, xid=0x1234)])
        offer = F.decode_dhcp(F.decode(tx[-1]).payload)
        tx += _beat(app, ring, clk, [_client(mac, F.REQUEST, xid=0x1235,
                                             requested_ip=offer.yiaddr,
                                             server_id=ip_to_u32("10.0.0.1"))])
        coa = rp.RadiusPacket(rp.COA_REQUEST, 9)
        coa.add(rp.FRAMED_IP_ADDRESS, offer.yiaddr)
        coa.add(rp.FILTER_ID, "business-100mbps")
        bad = rp.RadiusPacket(rp.COA_REQUEST, 10)
        bad.add(rp.FRAMED_IP_ADDRESS, offer.yiaddr)
        bad.add(rp.FILTER_ID, "no-such-policy")
        disc_pppoe = rp.RadiusPacket(rp.DISCONNECT_REQUEST, 11)
        disc_pppoe.add(rp.FRAMED_IP_ADDRESS, cli.ip)
        disc_dhcp = rp.RadiusPacket(rp.DISCONNECT_REQUEST, 12)
        disc_dhcp.add(rp.CALLING_STATION_ID, "02-DE-AD-BE-EF-01")
        replies = [_coa_send(app, p.encode(b"s3cr3t")) for p in (coa, bad)]
        row = c["qos"].down.lookup(offer.yiaddr)
        replies += [_coa_send(app, p.encode(b"s3cr3t")) for p in (disc_pppoe, disc_dhcp)]
        tx += _beat(app, ring, clk, [])  # the PADT and LCP teardown leave with the next beat
        st = app.stats()
        return (tx, replies, row, wire.sent, {k: st[k] for k in ("engine", "dhcp", "nat", "coa")},
                len(c["pppoe"].sessions), len(c["dhcp"].leases), c["accounting"].sessions)
    finally:
        app.close()


def test_radius_accounting_and_coa_through_the_app_match_reference(monkeypatch):
    from bng_tpu.control.radius import packet as rp

    ref = _serve_radius(JAX, monkeypatch)
    got = _serve_radius(PORT, monkeypatch)
    assert got == ref
    tx, replies, row, sent, st, n_pppoe, n_leases, acct = got
    assert [r[0] for r in replies] == [rp.COA_ACK, rp.COA_NAK, rp.DISCONNECT_ACK,
                                       rp.DISCONNECT_ACK]
    assert row["rate_bps"] == 100_000_000 and (n_pppoe, n_leases, acct) == (0, 0, {})
    codes = [rp.RadiusPacket.decode(d).code for d, _, _ in sent]
    assert codes.count(rp.ACCESS_REQUEST) == 2 and codes.count(rp.ACCOUNTING_REQUEST) == 4
    assert any(f[12:14] == b"\x88\x63" and f[15] == F.CODE_PADT for f in tx)


def test_audit_app_and_restore_audit(tmp_path, capsys):
    """`audit_app` on an app holding a PPPoE session and DHCPv6 leases, both
    packages; then `checkpoint save` and `restore --audit` through `main`."""
    from test_v6 import solicit

    from bng_tpu.chaos import invariants as j_inv
    from bng_tpu.control.dhcpv6 import protocol as p6
    from bng_tpu_torch.chaos import invariants as t_inv

    reports = []
    for m, inv in ((JAX, j_inv), (PORT, t_inv)):
        clk = [float(NOW)]
        app = m.cli.BNGApp(m.cli.BNGConfig(pool_cidr="10.50.0.0/24", batch_size=32,
                                           pppoe_enabled=True, pppoe_users=PPPOE_USERS,
                                           **WORKING), clock=lambda: clk[0], **m.kw)
        try:
            _seed_pppoe(app)
            ring = app.components["ring"] = m.Ring(256, 2048, 128)
            _ring_client(app, ring, clk, []).connect(now=clk[0])
            v6 = app.components["dhcpv6"]
            for k in range(3):
                msg = solicit(iaid=k + 1, rapid=True)
                if k == 2:
                    msg.options = [(t, v) for t, v in msg.options if t != p6.OPT_CLIENTID]
                    msg.add(p6.OPT_CLIENTID, p6.generate_duid_ll(b"\x02\x00\x00\x00\x00\x05")
                            .encode())
                v6.handle_message(msg.encode())
            reports.append(inv.audit_app(app).to_dict())
        finally:
            app.close()
    assert reports[1] == reports[0]
    assert reports[1]["ok"] and reports[1]["checks"]["v6_leases_na"] == 3
    assert reports[1]["checks"]["pppoe_sessions"] == 1
    flags = ["--checkpoint-dir", str(tmp_path), "--pppoe-enabled", *WORKING_FLAGS]
    assert t_cli.main(["--device", "cpu", "checkpoint", "save", *flags]) == 0
    assert t_cli.main(["--device", "cpu", "checkpoint", "restore", "--audit", *flags]) == 0
    assert '"ok": true' in capsys.readouterr().out
