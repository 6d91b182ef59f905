"""The port's storm suite (`bng_tpu_torch/chaos/storms.py`) against the JAX
package's.

Each of the seven storms (the cluster of BNGs' `cluster_scale_storm`
among them) runs in both packages from the same seed at the reduced scale
the reference's own tests use (`tests/test_storms.py`, and
`tests/test_edge.py` for `production_day`),
on the CPU, and gives the same canonical report bytes, `ok` included. The
two storms that build an engine run it on `device="cpu"`.

The reference's flash crowd feeds its autoscaler the fleet's live busy
reading, which is wall time (`FleetWorker.busy_s`): after a resize resets
the per-worker stats, whether the next look re-baselines or decides turns
on the host's speed, so its worker count can read 5 or 6 from one seed.
The port's storm pins that reading at 0 (`storms._ShedSignal`), and the
reference is held to the same pinned reading here
(`SlowPathFleet.busy_seconds_total`); no report field is left out.

Tolerance: exact (canonical JSON bytes).
"""

import json

import pytest
import torch

from bng_tpu.chaos import runner as j_runner
from bng_tpu.control import fleet as j_fleet
from bng_tpu_torch.chaos import runner as t_runner
from bng_tpu_torch.chaos import storms as t_storms

pytestmark = pytest.mark.torch_port

SEED = 123
# the reference tests' scales
SCALES = {"flash_crowd_reconnect": 0.01, "lease_expiry_avalanche": 0.02,
          "cgnat_port_exhaustion": 0.05, "coa_policy_flap": 0.05,
          "dual_stack_bringup": 0.1, "cluster_scale_storm": 0.01, "production_day": 0.5}


@pytest.fixture
def pinned_busy(monkeypatch):
    monkeypatch.setattr(j_fleet.SlowPathFleet, "busy_seconds_total", lambda self: 0.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The storms' stage budgets read wall time, and the port's CPU engine
    issues many small torch ops: with every test process of a parallel run
    on all cores' intra-op threads, the oversubscribed host slows each op
    by orders of magnitude. One thread per process (restored after) keeps
    the budgets' margin; the budgets themselves are unchanged."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_six_storms_are_ported():
    assert sorted(t_storms.STORMS) == sorted(SCALES)
    assert set(SCALES) <= set(j_runner.STORMS)


@pytest.mark.parametrize("name", sorted(SCALES))
def test_storm_report_equals_reference(name, pinned_busy):
    scale = SCALES[name]
    ref = j_runner.canonical_json(j_runner.run_scenarios(SEED, names=[name], storm_scale=scale))
    got = t_runner.canonical_json(t_runner.run_scenarios(SEED, names=[name], storm_scale=scale,
                                                         device="cpu"))
    assert got == ref
    assert json.loads(got)["ok"], got[:2000]


def test_flash_crowd_scaler_reads_no_wall_time(monkeypatch):
    """The port's flash crowd decides on the shed signal alone: a busy
    reading that jumps about (as wall time does across a resize) leaves
    the report unchanged."""
    from bng_tpu_torch.control import fleet as t_fleet

    base = t_storms.flash_crowd_reconnect(7, scale=0.01)
    ticks = iter(range(10_000))
    monkeypatch.setattr(t_fleet.SlowPathFleet, "busy_seconds_total",
                        lambda self: float((next(ticks) * 7919) % 13))
    assert t_storms.flash_crowd_reconnect(7, scale=0.01) == base
    assert base["workers_final"] > 4 and base["ok"]
