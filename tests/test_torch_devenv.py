"""The port's device guard, profiler and sanitizer against the reference's.

- `resolve_device`: the CPU when asked, the card otherwise; with no card
  it raises and names device='cpu'. `probe_cuda` in a subprocess answers
  with a reason where there is no card.
- The profiler on the CPU: `profile_step_durations` keeps one host-clock
  duration per call (`source="host"`) with the reference's
  `StepDurations` fields and percentiles (held against numpy);
  `profile_op_times` returns the reference's `ProfileReport` shape and
  `format_report` prints it; asked for the card with none, it raises.
- `sanitized()`: the reference's debug-NaN flag raises FloatingPointError
  on a NaN its program makes; the port's NaN check raises the same error
  on a NaN in a QoS token word the step wrote, and passes clean tables.
- `@owned_by` armed (BNG_SANITIZE=1, in a subprocess): the same
  cross-context write raises OwnershipViolation in both packages and the
  same write under the guard passes; the port's `Engine`, `BNGApp` and
  `OpsController` carry the reference's ownership stamps.

Tolerance: exact; percentiles to float64 rounding (1e-9 relative).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bng_tpu.analysis import sanitize as j_sanitize
from bng_tpu.utils import profiling as j_profiling
from bng_tpu_torch.analysis import sanitize as t_sanitize
from bng_tpu_torch.runtime.engine import QoSTables
from bng_tpu_torch.utils import devenv
from bng_tpu_torch.utils import profiling as t_profiling

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parent.parent


def test_resolve_device_and_probe(monkeypatch):
    assert devenv.resolve_device("cpu") == torch.device("cpu")
    probe = devenv.probe_cuda(timeout_s=120)
    if not torch.cuda.is_available():
        assert set(probe) == {"error"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(devenv.NoCardError, match="device='cpu'"):
        devenv.resolve_device(None)


def test_step_durations_on_the_cpu(monkeypatch):
    calls = []
    d = t_profiling.profile_step_durations(lambda: calls.append(1), iters=7, device="cpu")
    assert d.source == "host" and len(d.us) == 7 and len(calls) == 7
    assert [f.name for f in dataclasses.fields(d)] == \
        [f.name for f in dataclasses.fields(j_profiling.StepDurations)]
    ref = j_profiling.StepDurations(list(d.us), "cpu-exec")
    for q in (0, 50, 99, 100):
        assert d.percentile(q) == pytest.approx(float(np.percentile(d.us, q)), rel=1e-9)
        assert d.percentile(q) == ref.percentile(q)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_profiling.profile_step_durations(lambda: None, iters=1)


def test_op_times_report_shape():
    x = torch.ones((64, 64))
    rep = t_profiling.profile_op_times(lambda: (x @ x).sum(), iters=3)
    assert [f.name for f in dataclasses.fields(rep)] == \
        [f.name for f in dataclasses.fields(j_profiling.ProfileReport)]
    assert rep.ops and rep.host_total_us > 0 and rep.trace_dir == "(discarded)"
    assert all(a.us_per_iter >= b.us_per_iter for a, b in zip(rep.ops, rep.ops[1:]))
    text = t_profiling.format_report(rep, top=3)
    assert text.startswith("device:") and len(text.splitlines()) == 1 + min(3, len(rep.ops))


def test_nan_guard_raises_where_the_reference_does():
    with pytest.raises(FloatingPointError):
        with j_sanitize.sanitized():
            jnp.log(-jnp.ones(2)).block_until_ready()
    qos = QoSTables(nbuckets=16)
    qos.set_subscriber(0x0A000002, down_bps=8_000_000, up_bps=8_000_000)
    table = qos.up.device_state("cpu")
    with t_sanitize.sanitized(qos_tables=(table,)):
        pass  # clean token words pass
    with pytest.raises(FloatingPointError):
        with t_sanitize.sanitized(qos_tables=(table,)):
            slot = int(np.nonzero(qos.up.rows[:, 1])[0][0])
            table.rows[slot, 6] = torch.tensor(np.float32(np.nan)).view(torch.int32)


_ARMED = r"""
import threading
from bng_tpu.analysis import sanitize as js
from bng_tpu_torch.analysis import sanitize as ts

def run(mod, hold):
    @mod.owned_by("loop", guard="_ctl")
    class W:
        def __init__(self):
            self._ctl = threading.Lock()
            self.x = 0
    w, box = W(), {}
    def rogue():
        mod.ctx_enter("ctl")
        try:
            if hold:
                with w._ctl:
                    w.x = 1
            else:
                w.x = 1
        except mod.OwnershipViolation as e:
            box["err"] = str(e)
    t = threading.Thread(target=rogue); t.start(); t.join(10)
    return box.get("err"), w.x

for hold in (False, True):
    (je, jx), (te, tx) = run(js, hold), run(ts, hold)
    assert (je is None, jx) == (te is None, tx), (hold, je, te)
    assert (te is None) == hold and "owned by 'loop'" in (te or "owned by 'loop'")
from bng_tpu.cli import BNGApp as JApp
from bng_tpu.control.opsctl import OpsController as JOps
from bng_tpu.runtime.engine import Engine as JEngine
from bng_tpu_torch.cli import BNGApp as TApp
from bng_tpu_torch.control.opsctl import OpsController as TOps
from bng_tpu_torch.runtime.engine import Engine as TEngine
for j, t in ((JApp, TApp), (JOps, TOps), (JEngine, TEngine)):
    assert t.__bng_owned__ == j.__bng_owned__, (t, t.__bng_owned__, j.__bng_owned__)
print("ok")
"""


def test_owned_by_armed_raises_where_the_reference_does():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA", "PYTHON"))}
    env.update(BNG_SANITIZE="1", JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _ARMED], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]
