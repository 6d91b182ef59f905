"""Structured logging (copy of `bng_tpu/utils/structlog.py`).

Machine-parseable lines with bound fields (component, subscriber, mac,
...) over stdlib logging:

    log = get_logger("dhcp", component="dhcp-server")
    log.info("lease allocated", mac="02:..:42", ip="10.0.0.9", pool=1)

  -> {"ts": "2026-07-30T00:00:00.123Z", "level": "info",
      "logger": "bng.dhcp", "msg": "lease allocated",
      "component": "dhcp-server", "mac": "02:..:42", ...}

`setup(level=..., fmt="json"|"console")` configures the `bng` logger once
(`run`'s --log-level/--log-format); libraries call get_logger() and never
configure handlers themselves. `RateLimiter`, `ErrorLog` and
`SlowPathErrorLog` keep a per-frame failure under a flood of malformed
packets neither silent nor a firehose: one line (traceback and the count
suppressed since the last line) per `rate` per second, after a burst.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import IO

_CONFIGURED = False


class JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        line = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        line.update(getattr(record, "bng_fields", {}))
        if record.exc_info:
            line["exc"] = self.formatException(record.exc_info)
        return json.dumps(line)


class ConsoleFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        fields = getattr(record, "bng_fields", {})
        tail = "".join(f" {k}={v}" for k, v in fields.items())
        return (f"{time.strftime('%H:%M:%S', time.gmtime(record.created))} "
                f"{record.levelname:<5} {record.name}: "
                f"{record.getMessage()}{tail}")


class BoundLogger:
    """A logger with bound fields; per-call kwargs become JSON fields."""

    def __init__(self, logger: logging.Logger, fields: dict):
        self._logger = logger
        self._fields = fields

    def bind(self, **fields) -> "BoundLogger":
        return BoundLogger(self._logger, {**self._fields, **fields})

    def _log(self, level: int, msg: str, kw: dict) -> None:
        if self._logger.isEnabledFor(level):
            exc_info = kw.pop("exc_info", None)
            self._logger.log(level, msg, exc_info=exc_info,
                             extra={"bng_fields": {**self._fields, **kw}})

    def debug(self, msg: str, **kw) -> None:
        self._log(logging.DEBUG, msg, kw)

    def info(self, msg: str, **kw) -> None:
        self._log(logging.INFO, msg, kw)

    def warning(self, msg: str, **kw) -> None:
        self._log(logging.WARNING, msg, kw)

    def error(self, msg: str, **kw) -> None:
        self._log(logging.ERROR, msg, kw)


def setup(level: str = "info", fmt: str = "json",
          stream: IO | None = None, force: bool = False) -> None:
    """Configure the root 'bng' logger.

    First explicit configuration wins (the zap discipline: the operator's
    sink is not clobbered by a library's later convenience call) — a
    repeat call without `stream`/`force` only adjusts the level.
    """
    global _CONFIGURED
    root = logging.getLogger("bng")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    if _CONFIGURED and not force and stream is None:
        return
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JSONFormatter() if fmt == "json" else ConsoleFormatter())
    root.handlers[:] = [handler]
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str, **fields) -> BoundLogger:
    """Namespaced logger under 'bng.'; safe before setup() (lazy default)."""
    if not _CONFIGURED:
        setup()
    return BoundLogger(logging.getLogger(f"bng.{name}"), fields)


class RateLimiter:
    """Token-bucket guard for hot-path log sites (zap's sampler role).

    A per-frame slow-path failure under a malformed-packet flood must not
    turn the dataplane into a log firehose, but it must not be silent
    either (the reference logs every DHCP handler error,
    pkg/dhcp/server.go:330 — it can afford to; a batch engine cannot).
    allow() grants up to `burst` events immediately and refills at `rate`
    per second; each grant reports how many events were suppressed since
    the previous grant, so the emitted line carries the loss count.
    """

    def __init__(self, rate: float = 1.0, burst: int = 5,
                 clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._suppressed = 0

    def allow(self) -> tuple[bool, int]:
        """-> (granted, events suppressed since the last grant)."""
        now = self.clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            suppressed, self._suppressed = self._suppressed, 0
            return True, suppressed
        self._suppressed += 1
        return False, self._suppressed


class ErrorLog:
    """Rate-limited exception reporter for background/maintenance paths:
    a broad `except` reports here — one line per `rate`/s with a
    suppressed-count, traceback included, never raising into the path it
    guards."""

    def __init__(self, name: str, message: str, rate: float = 1.0,
                 burst: int = 5, clock=time.monotonic, level: str = "warning",
                 **bound):
        self._log = get_logger(name, **bound)
        self._message = message
        self._level = level
        self._limit = RateLimiter(rate=rate, burst=burst, clock=clock)

    def report(self, exc: BaseException, **fields) -> bool:
        """Log `exc` (with traceback) unless rate-limited; returns
        whether the line was emitted. Never raises — a logging failure
        must not take down the path it guards."""
        try:
            ok, suppressed = self._limit.allow()
            if not ok:
                return False
            getattr(self._log, self._level)(
                self._message,
                error=f"{type(exc).__name__}: {exc}",
                suppressed=suppressed,
                exc_info=(type(exc), exc, exc.__traceback__),
                **fields)
            return True
        except Exception:  # pragma: no cover - defensive
            return False


class SlowPathErrorLog(ErrorLog):
    """Rate-limited exception reporter for the slow-path drains (the
    fleet's and the engines'): the traceback beside the `slow_errors`
    counter. One instance per owner, so a single poisoned flood cannot log
    more than `rate`/s whichever drain it enters through."""

    def __init__(self, component: str, rate: float = 1.0, burst: int = 5,
                 clock=time.monotonic):
        super().__init__("slowpath", "slow-path handler failed",
                         rate=rate, burst=burst, clock=clock,
                         level="error", component=component)
