"""The port's structured logging (`bng_tpu_torch/utils/structlog.py`) and
`run`'s log lines against the JAX package's.

- Both formatters render the same record the same way: a JSON object
  (`ts`, `level`, `logger`, `msg`, the bound fields, `exc`) and a console
  line, with the timestamp masked; `setup` keeps the first explicit
  configuration and only adjusts the level on a repeat call.
- `ErrorLog` / `SlowPathErrorLog`: the same rate-limited lines, with the
  traceback and the suppressed count.
- `run --once` writes the reference's log lines on stderr: JSON objects by
  default and console lines under `--log-format console`. The port's
  `engine built` line names its device (`device=cpu`); the reference's
  has no such field, so that one field is dropped before comparing.

Tolerance: exact (strings, dicts) with `ts` masked.
"""

import io
import json
import logging
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bng_tpu.utils import structlog as j_log
from bng_tpu_torch.utils import structlog as t_log

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parent.parent


def _record(name, exc=False):
    rec = logging.LogRecord(f"bng.{name}", logging.WARNING, __file__, 1, "pool %s", ("low",),
                            None)
    rec.created, rec.msecs = 1_753_000_000.25, 250.0
    rec.bng_fields = {"component": "dhcp", "pool": 1, "mac": "02:00:00:00:00:01"}
    if exc:
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            rec.exc_info = sys.exc_info()
    return rec


@pytest.mark.parametrize("exc", [False, True], ids=["plain", "exc"])
def test_formatters_match_reference(exc):
    for fmt in ("JSONFormatter", "ConsoleFormatter"):
        got = getattr(t_log, fmt)().format(_record("dhcp", exc))
        ref = getattr(j_log, fmt)().format(_record("dhcp", exc))
        assert got == ref
    line = json.loads(t_log.JSONFormatter().format(_record("dhcp", exc)))
    assert list(line)[:4] == ["ts", "level", "logger", "msg"]
    assert line["msg"] == "pool low" and line["pool"] == 1 and ("exc" in line) == exc


def _capture(mod, fn):
    """Run `fn(mod)` with the `bng` logger writing to a buffer in `mod`'s
    JSON format; restore the logger after."""
    root = logging.getLogger("bng")
    saved = (root.handlers[:], root.level, root.propagate, mod._CONFIGURED)
    buf = io.StringIO()
    try:
        mod.setup("info", "json", stream=buf, force=True)
        fn(mod)
    finally:
        root.handlers[:], root.level, root.propagate = saved[:3]
        mod._CONFIGURED = saved[3]
    return [{k: v for k, v in json.loads(x).items() if k != "ts"}
            for x in buf.getvalue().splitlines()]


def test_bound_logger_and_error_logs_match_reference():
    def drive(mod):
        log = mod.get_logger("app", node_id="bng0").bind(shard=2)
        log.info("engine built", batch_size=256)
        log.debug("not shown")
        t = [0.0]
        el = mod.SlowPathErrorLog("engine", rate=1.0, burst=2, clock=lambda: t[0])
        for i in range(5):
            try:
                raise ValueError(f"bad frame {i}")
            except ValueError as e:
                el.report(e, lane=i)
        t[0] += 3.0
        el.report(KeyError("late"), lane=9)
        mod.ErrorLog("dhcp-pool", "pool exhausted", level="warning", pool=1).report(
            OSError("dry"))

    got, ref = _capture(t_log, drive), _capture(j_log, drive)
    assert got == ref
    assert [x["msg"] for x in got] == ["engine built"] + ["slow-path handler failed"] * 3 + [
        "pool exhausted"]
    assert got[3]["suppressed"] == 3 and got[3]["component"] == "engine"


def test_setup_first_configuration_wins():
    root = logging.getLogger("bng")
    saved = (root.handlers[:], root.level, root.propagate, t_log._CONFIGURED)
    try:
        buf = io.StringIO()
        t_log.setup("info", "console", stream=buf, force=True)
        t_log.setup("debug", "json")  # a repeat: the level only
        t_log.get_logger("x").debug("hello", k=1)
        assert re.fullmatch(r"\d\d:\d\d:\d\d DEBUG bng\.x: hello k=1\n", buf.getvalue())
    finally:
        root.handlers[:], root.level, root.propagate = saved[:3]
        t_log._CONFIGURED = saved[3]


def _run_once(module, fmt, extra=()):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", module, *extra, "run", "--once", "--log-format", fmt,
           "--synthetic-subs", "4"]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return [ln for ln in out.stderr.splitlines() if ln.strip()]


def test_run_once_log_lines_match_reference():
    """The JSON default and `--log-format console`, from both packages'
    `run --once`."""
    for fmt in ("json", "console"):
        ref = _run_once("bng_tpu.cli", fmt)
        got = _run_once("bng_tpu_torch", fmt, ("--device", "cpu"))
        if fmt == "json":
            ref = [{k: v for k, v in json.loads(x).items() if k != "ts"} for x in ref]
            got = [{k: v for k, v in json.loads(x).items() if k not in ("ts", "device")}
                   for x in got]
            assert {x["logger"] for x in got} == {"bng.app"}
        else:
            ref = [x[9:] for x in ref]
            got = [x[9:].replace(" device=cpu", "") for x in got]
            assert all(x.startswith("INFO  bng.app: ") for x in got)
        assert got == ref and len(got) >= 2, (got, ref)
