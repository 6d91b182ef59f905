"""The port's DHCP load harness against the JAX package's.

Both packages' `DHCPBenchmark` drive the stack `loadtest` builds (a
fast-path table sized for the MACs, a /24 pool, a DHCP server as the slow
path, the engine; with `--scheduler` a tiered scheduler over it) at 64
MACs and batch 16, under one injected fake clock (each read advances it
1 ms) and a sleep that advances it: the warmup's DORAs, then the measured
DISCOVER/renewal mix. The counts are equal: requests, responses, errors,
batches, fast-path and slow-path hits, the leases the warmup made, the
program that served. Time fields are not compared. With a tracer armed
around the run (what `loadtest --trace` does) both record the same stage
sample counts; `loadtest --trace --json --bench-log` on the CPU reports
the stage breakdown and its SLO verdict, in its JSON and its ledger line,
and leaves no tracer armed. Also the `StormFrameFactory` frames equal the
reference's byte for byte.

Tolerance: exact.
"""

import dataclasses
import ipaddress
from types import SimpleNamespace

import pytest

from bng_tpu import loadtest as j_lt
from bng_tpu.control.dhcp_server import DHCPServer as JServer
from bng_tpu.control.nat import NATManager as JNAT
from bng_tpu.control.pool import Pool as JPool
from bng_tpu.control.pool import PoolManager as JPools
from bng_tpu.runtime.engine import Engine as JEngine
from bng_tpu.runtime.scheduler import SchedulerConfig as JConfig
from bng_tpu.runtime.scheduler import TieredScheduler as JSched
from bng_tpu.runtime.tables import FastPathTables as JFast
from bng_tpu_torch import loadtest as t_lt
from bng_tpu_torch.control.dhcp_server import DHCPServer as TServer
from bng_tpu_torch.control.nat import NATManager as TNAT
from bng_tpu_torch.control.pool import Pool as TPool
from bng_tpu_torch.control.pool import PoolManager as TPools
from bng_tpu_torch.runtime.engine import Engine as TEngine
from bng_tpu_torch.runtime.scheduler import SchedulerConfig as TConfig
from bng_tpu_torch.runtime.scheduler import TieredScheduler as TSched
from bng_tpu_torch.runtime.tables import FastPathTables as TFast
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_telemetry import split_stages

pytestmark = pytest.mark.torch_port

JAX = SimpleNamespace(lt=j_lt, Fast=JFast, Pools=JPools, Pool=JPool, NAT=JNAT, Server=JServer,
                      Engine=JEngine, Sched=JSched, Config=JConfig, kw={})
PORT = SimpleNamespace(lt=t_lt, Fast=TFast, Pools=TPools, Pool=TPool, NAT=TNAT, Server=TServer,
                       Engine=TEngine, Sched=TSched, Config=TConfig, kw={"device": "cpu"})
MACS, BATCH = 64, 16
TIMES = {"duration_s", "rps", "latency_p50_us", "latency_p95_us", "latency_p99_us",
         "latency_p999_us", "latency_min_us", "latency_max_us", "request_p50_us",
         "request_p99_us", "request_p999_us", "request_mean_us", "est_fastpath_hits",
         "est_cache_hit_rate", "fastpath_p99_us"}


class FakeClock:
    """Each read advances 1 ms; sleep advances by what it is asked."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 0.001
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def stack(m, scheduler: bool):
    net = ipaddress.ip_network("10.0.0.0/24")
    server_ip, server_mac = int(net.network_address + 1), bytes.fromhex("02aabbccdd01")
    fp = m.Fast(sub_nbuckets=1 << 10, vlan_nbuckets=64, cid_nbuckets=64, max_pools=16,
                stash=64, update_slots=max(256, 2 * BATCH))
    fp.set_server_config(server_mac, server_ip)
    pools = m.Pools(fp)
    pools.add_pool(m.Pool(pool_id=1, network=int(net.network_address), prefix_len=net.prefixlen,
                          gateway=server_ip, dns_primary=ip_to_u32("1.1.1.1"), lease_time=86400))
    nat = m.NAT(public_ips=[ip_to_u32("203.0.113.1")], sessions_nbuckets=256, sub_nat_nbuckets=64)
    server = m.Server(server_mac, server_ip, pools, fastpath_tables=fp)
    eng = m.Engine(fp, nat, batch_size=BATCH, slow_path=server.handle_frame, **m.kw)
    return m.Sched(eng, m.Config(bulk_batch=BATCH)) if scheduler else eng


def bench(m, scheduler: bool):
    clk = FakeClock()
    cfg = m.lt.BenchmarkConfig(batch_size=BATCH, duration_s=0.3, warmup_s=0.2,
                               unique_macs=MACS, renewal_ratio=0.5)
    b = m.lt.DHCPBenchmark(stack(m, scheduler), cfg, clock=clk, sleep=clk.sleep)
    res = dataclasses.asdict(b.run())
    return {k: v for k, v in res.items() if k not in TIMES}, dict(b._leased)


@pytest.mark.parametrize("scheduler", [False, True], ids=["engine", "scheduler"])
def test_counts_match_reference_under_one_fake_clock(scheduler):
    ref, got = bench(JAX, scheduler), bench(PORT, scheduler)
    assert got == ref
    res, leased = got
    assert len(leased) == MACS and res["errors"] == 0 and res["responses"] == res["requests"]
    assert res["fastpath_hits"] > 0 and res["batches"] > 0
    assert res["program"] == ("tiered_scheduler" if scheduler else "dhcp_fastpath")


def test_storm_frames_match_reference():
    jf, tf = j_lt.harness.StormFrameFactory(ip_to_u32("10.0.0.1")), \
        t_lt.StormFrameFactory(ip_to_u32("10.0.0.1"))
    mac = bytes.fromhex("02b000000007")
    for f in ("discover", "request", "renew"):
        args = (mac, 0x1234) if f == "discover" else (mac, ip_to_u32("10.0.0.9"), 0x1234)
        assert getattr(tf, f)(*args) == getattr(jf, f)(*args)


@pytest.mark.parametrize("scheduler", [False, True], ids=["engine", "scheduler"])
def test_traced_run_matches_reference(scheduler):
    """`loadtest --trace` arms the tracer around the run: under one fake
    clock both packages record the same stage sample counts, and the SLO
    verdict over the breakdown has the same shape."""
    from bng_tpu.telemetry import slo as j_slo
    from bng_tpu.telemetry import spans as j_sp
    from bng_tpu_torch.telemetry import slo as t_slo
    from bng_tpu_torch.telemetry import spans as t_sp

    got = []
    for m, sp, slo in ((JAX, j_sp, j_slo), (PORT, t_sp, t_slo)):
        with sp.armed() as tr:
            res, _ = bench(m, scheduler)
        bd = tr.breakdown()
        got.append((res, {s: v["count"] for s, v in bd.items()}, sorted(slo.evaluate(bd))))
    stages, own = split_stages(got[1][1])
    assert (got[1][0], stages, got[1][2]) == got[0]
    # every dispatch laps the port's own parts: the engine's DHCP-only
    # program its drain, upload, issue, collect and stages, the express
    # program its drain, upload and issue
    parts = ("drain", "upload", "issue") + (() if scheduler else
                                            ("collect", "parse", "dhcp", "verdict"))
    assert own == {s: stages["dispatch"] for s in parts}
    assert {"dispatch", "device_wait", "reply", "total"} <= set(stages)
    assert stages["total"] > got[1][0]["batches"]  # the warmup's batches too
    assert got[1][2] == ["breaches", "ok"]


def test_cli_loadtest_trace_on_cpu(tmp_path, capsys):
    import json

    from bng_tpu_torch import cli
    from bng_tpu_torch.telemetry import ledger

    log = str(tmp_path / "bench.jsonl")
    rc = cli.main(["--device", "cpu", "loadtest", "--duration", "0.3", "--warmup", "0.2",
                   "--macs", "64", "--batch-size", "16", "--json", "--trace",
                   "--bench-log", log])
    assert rc == 0
    res = json.loads(capsys.readouterr().out)
    assert set(res["slo"]) == {"ok", "breaches"} and "dispatch" in res["stage_breakdown"]
    assert res["stage_breakdown"]["total"]["count"] == res["served"]["dispatches"] > 0
    line = ledger.read(log)[-1]
    assert line["slo"] == res["slo"] and line["stage_breakdown"] == res["stage_breakdown"]
    assert t_sp_disarmed()


def t_sp_disarmed() -> bool:
    from bng_tpu_torch.telemetry import spans

    return spans.tracer() is None
