"""Runtime operations control: the `ctl` wire and the fleet autoscaler
(port of `bng_tpu/control/opsctl.py`).

A running `run` process owns a dataplane loop that must never be raced
by an operator thread — every zero-downtime transition has to execute at
a batch boundary under the app's control lock:

- `OpsController` — a bounded queue of requested transitions. HTTP
  handler threads (and anything else) `submit()` and block on a result;
  the run loop calls `run_pending()` once per beat, executing each op
  through the BNGApp's locked transition methods (fleet resize, rolling
  worker restart, blue/green engine swap).

- `OpsServer` — a tiny loopback HTTP listener (`run --ctl-listen`):
  POST /ops/fleet/resize {"n": N}, POST /ops/fleet/rolling-restart,
  POST /ops/engine/swap, GET /ops/status. OPT-IN and unauthenticated:
  `run` starts no listener unless --ctl-listen is given.

- `FleetAutoscaler` — the watermark hook for live elasticity: scale up
  when the admission controller sheds or mean worker busy-fraction
  crosses the high watermark; scale down only after the busy-fraction
  sits under the low watermark for `hold` consecutive looks. Driven from
  App.tick; acts through the same resize verb the operator uses.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass

from bng_tpu_torch.analysis.sanitize import ctx_enter, owned_by
from bng_tpu_torch.utils.structlog import get_logger

# ops the controller will route to a BNGApp (name -> app method)
OPS = {
    "fleet/resize": "fleet_resize",
    "fleet/rolling-restart": "fleet_rolling_restart",
    "engine/swap": "engine_swap",
}


@owned_by(None, guard="_stats_lock", attrs=("executed", "rejected"))
class OpsController:
    """Bounded transition queue, drained at the batch boundary.

    Counter ownership (BNG_SANITIZE): executed/rejected are bumped from
    both the ctl threads and the loop drain — always under _stats_lock;
    the @owned_by stamp raises if a future edit drops the lock."""

    def __init__(self, app, max_queue: int = 8):
        self.app = app
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self.executed = 0
        self.rejected = 0
        # counters are bumped from BOTH the ctl (HTTP handler) threads
        # and the loop's drain — a bare `+= 1` is a read-modify-write
        # that loses updates across contexts
        self._stats_lock = threading.Lock()
        self._log = get_logger("ops")

    def submit(self, op: str, args: dict | None = None,
               timeout_s: float = 60.0) -> dict:
        """Enqueue one op and block until the run loop executes it.
        Returns the transition report, or an error report when the op is
        unknown, the queue is full, or nothing drained the queue in time
        (no run loop driving — e.g. `run --once`)."""
        method = OPS.get(op)
        if method is None:
            with self._stats_lock:
                self.rejected += 1
            return {"op": op, "outcome": "rejected",
                    "error": f"unknown op {op!r} (have {sorted(OPS)})"}
        done = threading.Event()
        box: dict = {}
        try:
            self._q.put_nowait((method, args or {}, done, box))
        except queue.Full:
            with self._stats_lock:
                self.rejected += 1
            return {"op": op, "outcome": "rejected",
                    "error": "ops queue full: a transition is already "
                             "pending"}
        if not done.wait(timeout_s):
            # cancel, don't abandon: a queued-but-timed-out op must not
            # fire later (the operator will retry — executing both would
            # double a rolling restart, or land a stale resize target
            # after a newer one). The claim is ATOMIC (GIL-atomic
            # dict.setdefault), so exactly one side wins: a
            # check-then-act flag here would let the loop pass the check
            # just before the deadline and execute an op we reported as
            # 'timeout'. Losing the claim means the loop is executing it
            # NOW — wait out the run and return the real report instead
            # of a lie the operator would retry on.
            if box.setdefault("owner", "client") == "client":
                return {"op": op, "outcome": "timeout",
                        "error": f"no run loop drained the op within "
                                 f"{timeout_s:.0f}s — is `run` "
                                 f"driving?"}
            # the loop owns the claim: the transition is executing now
            # and completes in bounded time — a fixed grace, not the
            # client deadline that already expired
            if not done.wait(60.0):
                return {"op": op, "outcome": "unknown",
                        "error": "op claimed by the run loop but no "
                                 "report within grace — check "
                                 "bng_ops_transitions_total before "
                                 "retrying"}
        return box.get("report", {"op": op, "outcome": "failed"})

    def run_pending(self) -> int:
        """Execute every queued op (run-loop thread, between batches).
        An op that raises reports 'failed' to its requester and never
        takes the loop down."""
        n = 0
        while True:
            try:
                method, args, done, box = self._q.get_nowait()
            except queue.Empty:
                return n
            if box.setdefault("owner", "loop") != "loop":
                # the requester timed out and won the claim: cancelled
                with self._stats_lock:
                    self.rejected += 1
                done.set()
                continue
            try:
                box["report"] = getattr(self.app, method)(**args)
            except Exception as e:  # noqa: BLE001 — the report IS the error
                self._log.error("ops transition failed", op=method,
                                error=f"{type(e).__name__}: {e}")
                box["report"] = {"op": method, "outcome": "failed",
                                 "error": f"{type(e).__name__}: {e}"[:300]}
            finally:
                with self._stats_lock:
                    self.executed += 1
                done.set()
                n += 1

    def stats_snapshot(self) -> dict:
        return {"executed": self.executed, "rejected": self.rejected,
                "pending": self._q.qsize()}


class OpsServer:
    """Loopback HTTP listener for OpsController (`run --ctl-listen`)."""

    def __init__(self, controller: OpsController, host: str = "127.0.0.1",
                 port: int = 0):
        import http.server

        ctl = controller

        class Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, code: int, doc: dict) -> None:
                body = json.dumps(doc, indent=2, sort_keys=True).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                ctx_enter("ctl")
                if self.path != "/ops/status":
                    self._reply(404, {"error": "unknown path"})
                    return
                self._reply(200, ctl.app.ops_status())

            def do_POST(self):  # noqa: N802
                ctx_enter("ctl")
                if not self.path.startswith("/ops/"):
                    self._reply(404, {"error": "unknown path"})
                    return
                op = self.path[len("/ops/"):]
                n = int(self.headers.get("Content-Length") or 0)
                args: dict = {}
                if n:
                    try:
                        args = json.loads(self.rfile.read(n) or b"{}")
                    except ValueError:
                        self._reply(400, {"error": "bad JSON body"})
                        return
                report = ctl.submit(op, args)
                ok = report.get("outcome") in ("ok", "noop")
                self._reply(200 if ok else 409, report)

            def log_message(self, *a):
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.addr = self._httpd.server_address

    def start(self) -> "OpsServer":
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def ctl_request(addr: str, op: str, args: dict | None = None,
                timeout_s: float = 90.0) -> tuple[int, dict]:
    """`ctl` client: (http_status, report) from a live process's ops
    listener. GETs /ops/status for op='status', POSTs everything else."""
    import urllib.error
    import urllib.request

    url = f"http://{addr}/ops/{op}"
    if op == "status":
        req = urllib.request.Request(url)
    else:
        req = urllib.request.Request(
            url, data=json.dumps(args or {}).encode(),
            headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except ValueError:
            return e.code, {"error": f"HTTP {e.code}"}


@dataclass
class AutoscaleConfig:
    min_workers: int = 1
    max_workers: int = 8
    busy_hi: float = 0.75  # mean busy-fraction that triggers scale-up
    busy_lo: float = 0.20  # ... under which scale-down hysteresis counts
    hold: int = 3  # consecutive calm looks before scaling down
    cooldown_s: float = 30.0  # min seconds between transitions


class FleetAutoscaler:
    """Watermark-driven target-size recommender over a live fleet."""

    def __init__(self, fleet, cfg: AutoscaleConfig | None = None,
                 clock=time.time):
        self.fleet = fleet
        self.cfg = cfg or AutoscaleConfig()
        self.clock = clock
        self._last_shed = fleet.admission.shed_total()
        self._last_busy = fleet.busy_seconds_total()
        self._last_look: float | None = None
        self._last_change = 0.0
        self._calm = 0
        self.decisions = 0

    def target(self, now: float | None = None) -> int | None:
        """The recommended worker count, or None for no change. Call on
        a steady cadence (App.tick); busy fraction is measured between
        consecutive calls."""
        now = now if now is not None else self.clock()
        cfg = self.cfg
        shed = self.fleet.admission.shed_total()
        busy = self.fleet.busy_seconds_total()
        if self._last_look is None:
            self._last_look, self._last_shed = now, shed
            self._last_busy = busy
            return None
        if busy < self._last_busy:
            # a resize/rolling restart reset the per-worker stats the
            # busy counter sums over — this look's delta is meaningless.
            # Re-baseline and decide nothing: a negative delta must not
            # credit a "calm" hysteresis look while the fleet may in
            # fact be saturated.
            self._last_look, self._last_shed = now, shed
            self._last_busy = busy
            return None
        dt = now - self._last_look
        shed_delta = shed - self._last_shed
        busy_frac = ((busy - self._last_busy)
                     / (dt * max(1, self.fleet.n))) if dt > 0 else 0.0
        self._last_look, self._last_shed = now, shed
        self._last_busy = busy
        if now - self._last_change < cfg.cooldown_s:
            return None
        n = self.fleet.n
        if (shed_delta > 0 or busy_frac >= cfg.busy_hi) \
                and n < cfg.max_workers:
            self._calm = 0
            self._last_change = now
            self.decisions += 1
            return min(cfg.max_workers, n + 1)
        if busy_frac <= cfg.busy_lo and shed_delta == 0:
            self._calm += 1
            if self._calm >= cfg.hold and n > cfg.min_workers:
                self._calm = 0
                self._last_change = now
                self.decisions += 1
                return max(cfg.min_workers, n - 1)
        else:
            self._calm = 0
        return None
