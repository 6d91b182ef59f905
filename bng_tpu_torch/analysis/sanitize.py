"""Runtime sanitizer mode (BNG_SANITIZE=1), the port's counterpart of
`bng_tpu/analysis/sanitize.py`.

`sanitized()` arms, for the enclosed block:

* ``torch.cuda.set_sync_debug_mode("error")`` — the device-to-host
  guard: a call that synchronises the host with the card (an implicit
  copy of a device value to the host, `.item()`, a blocking `.cpu()`)
  raises instead of silently waiting. It is the counterpart of the
  reference's ``jax.transfer_guard_device_to_host("disallow")``. The
  mode exists only where there is a card: on the CPU the guard has
  nothing to watch and is not armed (the reference's d2h guard is inert
  on XLA:CPU too).
* No NaN flag: torch has no counterpart of ``jax.debug_nans`` for the
  port's programs. The values that can become NaN are the QoS token
  words the fused step writes back (f32 bit patterns in the QoS rows),
  so on exit the block checks them: given `qos_tables` (the device QoS
  tables, e.g. an engine's ``tables.qos_up`` and ``tables.qos_down``),
  a NaN in any token word raises FloatingPointError.
* No host-to-device guard: torch has no implicit host-to-device
  transfer into a program (every upload is an explicit copy).

**Ownership assertions** — copied from the reference unchanged.
`@owned_by("loop", guard="_ctl")` stamps a class whose mutable state
belongs to one execution context. Disarmed (BNG_SANITIZE unset) the
decorator returns the class untouched — zero overhead, zero behavior
change. Armed:

* threads announce their context with `ctx_enter("ctl")` /
  `with context("scrape"):`;
* every attribute write on a stamped object from a *named* context
  other than the owner raises OwnershipViolation — unless the thread
  holds the object's guard lock (the instance's `guard` attribute is
  transparently wrapped in a hold-tracking proxy at construction);
* writes from unnamed threads (construction, unit tests that don't
  set a context) stay free, so arming the sanitizer never breaks
  single-threaded tests;
* with `owner=None` the first named-context writer stamps the owner
  per attribute — "records the owning context at first write".
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager

SANITIZE_ENV = "BNG_SANITIZE"


def enabled() -> bool:
    """Is sanitizer mode requested? ("1", "true", "strict" accept)."""
    return os.environ.get(SANITIZE_ENV, "").lower() in ("1", "true",
                                                        "strict")


def strict() -> bool:
    """BNG_SANITIZE=strict also disallows implicit host->device
    transfers — only viable for code whose inputs are staged with
    explicit jnp.asarray/device_put end to end."""
    return os.environ.get(SANITIZE_ENV, "").lower() == "strict"


@contextmanager
def sanitized(qos_tables=()):
    """Arm the device-to-host guard for the block (on a card), and check
    the QoS token words of `qos_tables` for NaN on exit. Imports torch
    lazily so the ownership half never pays for it."""
    import torch

    armed = torch.cuda.is_available()
    if armed:
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        if armed:
            torch.cuda.set_sync_debug_mode(prev)
    for t in qos_tables:
        check_qos_tokens(t)


def check_qos_tokens(table) -> None:
    """Raise FloatingPointError if a token word of a device QoS table
    (a `QTableState`) holds NaN."""
    import torch

    from bng_tpu_torch.ops.qtable import QW_TOKENS

    tokens = table.rows[:, QW_TOKENS].contiguous().view(torch.float32)
    if bool(torch.isnan(tokens).any()):
        raise FloatingPointError("NaN in a QoS token word the step wrote")


# ===========================================================================
# ownership assertions: @owned_by + context stamps
# ===========================================================================

class OwnershipViolation(AssertionError):
    """An unlocked cross-context mutation of owned state, caught at
    runtime."""


_TLS = threading.local()


def current_context() -> str | None:
    return getattr(_TLS, "ctx", None)


def ctx_enter(name: str) -> None:
    """Stamp the calling thread's execution context (sticky). No-op
    when the sanitizer is disarmed — callers may invoke unconditionally
    from thread mains; the armed check is one env-cached bool."""
    if _ARMED:
        _TLS.ctx = name


@contextmanager
def context(name: str):
    """Scoped context stamp (tests; request-scoped handler threads)."""
    if not _ARMED:
        yield
        return
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = name
    try:
        yield
    finally:
        _TLS.ctx = prev


class GuardedLock:
    """Lock proxy that knows whether the *current thread* holds it —
    what `@owned_by` needs to distinguish a locked cross-context write
    (legal) from an unlocked one (violation). Wraps the instance's
    guard attribute at construction time when armed."""

    def __init__(self, inner):
        self._inner = inner
        self._holds: dict[int, int] = {}  # thread ident -> depth

    def acquire(self, *a, **k) -> bool:
        got = self._inner.acquire(*a, **k)
        if got:
            me = threading.get_ident()
            self._holds[me] = self._holds.get(me, 0) + 1
        return got

    def release(self) -> None:
        me = threading.get_ident()
        depth = self._holds.get(me, 0) - 1
        if depth <= 0:
            self._holds.pop(me, None)
        else:
            self._holds[me] = depth
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def held_by_me(self) -> bool:
        return self._holds.get(threading.get_ident(), 0) > 0

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def owned_by(owner: str | None, guard: str | None = None,
             attrs: tuple[str, ...] | None = None):
    """Class decorator: assert the context-ownership discipline on
    every attribute write (armed only; disarmed returns cls as-is).

    owner  — the context that may mutate freely ("loop"); None infers
             it from the first named-context write, per attribute.
    guard  — name of the instance's lock attribute; a thread HOLDING
             that lock may mutate from any context (that is the whole
             point of the `_ctl` discipline).
    attrs  — restrict checking to these attributes (None = all).
    """

    def deco(cls):
        if not _ARMED:
            return cls

        orig_setattr = cls.__setattr__
        orig_init = cls.__init__

        def __init__(self, *a, **k):
            orig_init(self, *a, **k)
            if guard is not None:
                g = self.__dict__.get(guard)
                if g is not None and not isinstance(g, GuardedLock):
                    self.__dict__[guard] = GuardedLock(g)

        def __setattr__(self, name, value):
            ctx = getattr(_TLS, "ctx", None)
            if ctx is None or (attrs is not None and name not in attrs):
                return orig_setattr(self, name, value)
            owners = self.__dict__.setdefault("__bng_owners__", {})
            own = owners.setdefault(name, owner if owner is not None
                                    else ctx)
            if ctx != own:
                g = self.__dict__.get(guard) if guard is not None else None
                if not (isinstance(g, GuardedLock) and g.held_by_me()):
                    raise OwnershipViolation(
                        f"{type(self).__name__}.{name} is owned by "
                        f"{own!r} but mutated from context {ctx!r} "
                        f"without holding "
                        f"{guard if guard else '<no guard declared>'} — "
                        f"the BNG060 race class, live")
            return orig_setattr(self, name, value)

        cls.__init__ = __init__
        cls.__setattr__ = __setattr__
        cls.__bng_owned__ = (owner, guard, attrs)
        return cls

    return deco


# computed once at import: the decorator and the ctx stamps read it on
# hot paths (thread mains, per-request handlers) — one global load
_ARMED = enabled()
