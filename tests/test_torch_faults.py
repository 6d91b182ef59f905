"""The port's chaos fault points against the JAX package's.

- `FaultPlan.generate` gives the same schedule from the same seed in both
  packages, and the same visits give the same fired record and stats.
- The hook API: disarmed no-op, `armed` scoping (exceptions included),
  `any_armed`, the byte mutations.
- Each point the port carries fires and has its effect, the same in both
  packages: `pool.allocate` exhaustion (a new client gets no OFFER),
  `dhcp.expire` skew (an early reap), `engine.dispatch` fail (the batch
  raises before the drain, so no table delta is lost) and delay,
  `engine.slow_drain` fail (the slow batch is lost and counted). The
  devloop's `devloop.dispatch` is held in tests/test_torch_devloop.py.

Tolerance: bit-exact.
"""

import dataclasses

import numpy as np
import pytest

from bng_tpu.chaos import faults as jf
from bng_tpu_torch import frames as F
from bng_tpu_torch.chaos import faults as tf
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_scheduler import JAX, PORT, SERVER_IP, T0, FakeClock, build_stack, dhcp, mac

pytestmark = pytest.mark.torch_port

PORT_POINTS = ("pool.allocate", "dhcp.expire", "engine.dispatch", "engine.slow_drain",
               "devloop.dispatch")


def _both(mods_fn):
    return [(jf, mods_fn(JAX)), (tf, mods_fn(PORT))]


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_seeded_plans_and_fired_records_match(seed):
    for points in (None, PORT_POINTS):
        plans = [m.FaultPlan.generate(seed, points=points, n_faults=12, max_hit=8)
                 for m in (jf, tf)]
        assert plans[1].to_dict() == plans[0].to_dict()
    rng = np.random.default_rng(seed)
    visits = [PORT_POINTS[int(i)] for i in rng.integers(len(PORT_POINTS), size=80)]
    rec = []
    for m in (jf, tf):
        plan = m.FaultPlan.generate(seed, points=PORT_POINTS, n_faults=12, max_hit=8)
        with m.armed(plan, log=False) as inj:
            assert m.any_armed()
            fired = [(None if (s := m.fault_point(p)) is None else s.to_dict()) for p in visits]
        assert not m.any_armed() and m.fault_point(visits[0]) is None
        rec.append((fired, inj.injected, inj.stats_snapshot()))
    assert rec[1] == rec[0]
    assert rec[1][1]  # the plan fired


def test_hook_api_matches_reference():
    for m in (jf, tf):
        assert m.fault_point("pool.allocate") is None
        with pytest.raises(ZeroDivisionError):
            with m.armed(m.FaultPlan(1, [m.FaultSpec("p", m.KILL)]), log=True):
                1 / 0
        assert not m.any_armed()
    data = bytes(range(200))
    out = []
    for m in (jf, tf):
        plan = m.FaultPlan(1, [m.FaultSpec("w", m.TRUNCATE, at_hit=1, arg=7),
                               m.FaultSpec("w", m.BITFLIP, at_hit=2, arg=333),
                               m.FaultSpec("w", m.IO_ERROR, at_hit=3)])
        with m.armed(plan, log=False):
            got = [m.mutate_point("w", data), m.mutate_point("w", data)]
            with pytest.raises(OSError):
                m.mutate_point("w", data)
            got.append(m.mutate_point("w", data))
        clock = m.SimClock()
        out.append((got, clock(), clock.advance(2.5)))
    assert out[1] == out[0] and out[1][0][0] == data[:-7] and out[1][0][2] == data


def _stacks():
    return [(m, build_stack(mods, FakeClock())) for m, mods in ((jf, JAX), (tf, PORT))]


def test_pool_allocate_exhaust_and_dhcp_expire_skew():
    got = []
    newcomer = mac(0x51)
    for m, (sched, server, fp) in _stacks():
        rec = []
        plan = m.FaultPlan(1, [m.FaultSpec("pool.allocate", m.EXHAUST, at_hit=1)])
        with m.armed(plan, log=False) as inj:
            rec.append(server.handle_frame(dhcp(newcomer, F.DISCOVER, 0x10)))  # no address
            offer = server.handle_frame(dhcp(newcomer, F.DISCOVER, 0x11))
        rec += [offer, inj.injected]
        yiaddr = F.decode_dhcp(F.decode(offer).payload).yiaddr
        rec.append(server.handle_frame(dhcp(newcomer, F.REQUEST, 0x12, requested_ip=yiaddr,
                                            server_id=SERVER_IP)))
        rec.append(server.cleanup_expired(int(T0) + 60))  # nothing due yet
        plan = m.FaultPlan(1, [m.FaultSpec("dhcp.expire", m.SKEW, arg=7200.0)])
        with m.armed(plan, log=False) as inj:
            rec.append(server.cleanup_expired(int(T0) + 60))  # the skewed clock reaps the lease
        rec += [inj.injected, server.export_leases(), dataclasses.asdict(server.stats),
                fp.dirty_count()]
        got.append(rec)
    assert got[1] == got[0]
    assert got[1][0] is None and got[1][1] is not None and got[1][4] == 0 and got[1][5] == 1


def test_engine_dispatch_and_slow_drain_faults():
    got = []
    frames = [dhcp(mac(0), F.DISCOVER, 0x20), dhcp(mac(0x61), F.DISCOVER, 0x21)]
    for m, (sched, server, fp) in _stacks():
        eng = sched.engine
        fp.add_subscriber(mac(0x62), 1, ip_to_u32("10.0.0.162"), int(T0) + 900)  # a dirty row
        rec = []
        plan = m.FaultPlan(1, [m.FaultSpec("engine.dispatch", m.FAIL, at_hit=1),
                               m.FaultSpec("engine.dispatch", m.DELAY, at_hit=2, arg=0.001),
                               m.FaultSpec("engine.slow_drain", m.FAIL, at_hit=1)])
        with m.armed(plan, log=False) as inj:
            with pytest.raises(m.FaultInjectedError):
                eng.process_dhcp(frames, now=T0)
            rec.append(fp.dirty_count())  # the failed dispatch drained nothing
            rec.append(eng.process_dhcp(frames, now=T0))  # delayed; its slow batch is lost
            rec.append(eng.process_dhcp(frames, now=T0))  # clean
        rec += [inj.injected, eng.stats.slow_errors, eng.stats.batches, fp.dirty_count(),
                eng.stats.dhcp.tolist()]
        got.append(rec)
    assert got[1] == got[0]
    assert got[1][0] == 1 and got[1][1]["slow"] == [(1, None)] and got[1][2]["slow"][0][1]
    assert got[1][4] == 1 and got[1][6] == 0
