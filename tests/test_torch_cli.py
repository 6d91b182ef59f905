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
- Refusal: a config that turns on subsystems the port lacks raises one
  error that names each of them and the flag that turns it off.
- `main(["--device", "cpu", "run", "--once", ...])` exits 0; with no card
  and no `--device cpu` it exits non-zero, and `BNGApp` raises.

Tolerance: exact (bytes, dicts).
"""

import argparse
import dataclasses
from types import SimpleNamespace

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
WORKING = dict(dhcpv6_enabled=False, slaac_enabled=False, metrics_enabled=False,
               coa_enabled=False)
WORKING_FLAGS = ["--no-dhcpv6-enabled", "--no-slaac-enabled", "--no-metrics-enabled",
                 "--no-coa-enabled"]


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
    on = dict(radius_server="127.0.0.1:1812", pppoe_enabled=True, ha_role="active",
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
    for flag in WORKING_FLAGS:
        assert flag in str(pytest.raises(t_cli.UnportedSubsystemError,
                                         t_cli.BNGApp, t_cli.BNGConfig(), device="cpu").value)
    assert t_cli.unported(t_cli.BNGConfig(**WORKING)) == []


def test_main_run_once_on_cpu(capsys):
    assert t_cli.main(["--device", "cpu", "run", "--once"] + WORKING_FLAGS) == 0
    assert '"device": "cpu"' in capsys.readouterr().out
    assert t_cli.main(["--device", "cpu", "run", "--once"]) == 2  # the defaults refuse
    assert "--no-dhcpv6-enabled" in capsys.readouterr().err
    assert t_cli.main(["version"]) == 0


def test_main_and_app_need_a_card_unless_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_cli.main(["run", "--once"] + WORKING_FLAGS) != 0
    assert "device='cpu'" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cli.BNGApp(t_cli.BNGConfig(**WORKING))
    assert t_cli.main(["loadtest", "--duration", "0.1"]) != 0
