"""Rate-limited error reporting (the part of `bng_tpu/utils/structlog.py`
that the DHCP server, the engine and the chaos injector use:
`get_logger`, `RateLimiter` and `ErrorLog`).

A per-frame failure under a flood of malformed packets must be neither
silent nor a log firehose: `ErrorLog.report` writes one line (with the
traceback and the count of lines suppressed since the last one) per
`rate` per second, after a burst of `burst`, to the stdlib logger
`bng.<name>`. The reference's JSON/console formatters and `setup()` are
not ported; the port leaves handler configuration to the caller.
"""

from __future__ import annotations

import logging
import time


class BoundLogger:
    """A stdlib logger with bound fields: each call's keyword arguments join
    them, ride on the record as `bng_fields` and are appended to the message
    as `key=value` pairs."""

    def __init__(self, logger: logging.Logger, fields: dict):
        self._logger = logger
        self._fields = fields

    def bind(self, **fields) -> "BoundLogger":
        return BoundLogger(self._logger, {**self._fields, **fields})

    def _log(self, level: int, msg: str, kw: dict) -> None:
        if self._logger.isEnabledFor(level):
            exc_info = kw.pop("exc_info", None)
            fields = {**self._fields, **kw}
            tail = "".join(f" {k}={v}" for k, v in fields.items())
            self._logger.log(level, "%s%s", msg, tail, exc_info=exc_info,
                             extra={"bng_fields": fields})

    def debug(self, msg: str, **kw) -> None:
        self._log(logging.DEBUG, msg, kw)

    def info(self, msg: str, **kw) -> None:
        self._log(logging.INFO, msg, kw)

    def warning(self, msg: str, **kw) -> None:
        self._log(logging.WARNING, msg, kw)

    def error(self, msg: str, **kw) -> None:
        self._log(logging.ERROR, msg, kw)


def get_logger(name: str, **fields) -> BoundLogger:
    """The logger `bng.<name>` with `fields` bound."""
    return BoundLogger(logging.getLogger(f"bng.{name}"), fields)


class RateLimiter:
    """Token bucket: `allow()` grants up to `burst` events at once and
    refills at `rate` per second; each grant reports how many events were
    suppressed since the previous grant."""

    def __init__(self, rate: float = 1.0, burst: int = 5, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._suppressed = 0

    def allow(self) -> tuple[bool, int]:
        """-> (granted, events suppressed since the last grant)."""
        now = self.clock()
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            suppressed, self._suppressed = self._suppressed, 0
            return True, suppressed
        self._suppressed += 1
        return False, self._suppressed


class ErrorLog:
    """Rate-limited exception reporter for a path that must keep running."""

    def __init__(self, name: str, message: str, rate: float = 1.0, burst: int = 5,
                 clock=time.monotonic, level: str = "warning", **bound):
        self._log = logging.getLogger(f"bng.{name}")
        self._message = message
        self._level = getattr(logging, level.upper())
        self._bound = bound
        self._limit = RateLimiter(rate=rate, burst=burst, clock=clock)

    def report(self, exc: BaseException, **fields) -> bool:
        """Log `exc` with its traceback unless rate-limited; returns whether
        a line was written. Never raises into the path it guards."""
        try:
            ok, suppressed = self._limit.allow()
            if not ok:
                return False
            tail = " ".join(f"{k}={v}" for k, v in {**self._bound, **fields}.items())
            self._log.log(self._level, "%s: %s: %s (%s, suppressed=%d)", self._message,
                          type(exc).__name__, exc, tail, suppressed,
                          exc_info=(type(exc), exc, exc.__traceback__))
            return True
        except Exception:  # noqa: BLE001 — a logging failure must not break the caller
            return False
