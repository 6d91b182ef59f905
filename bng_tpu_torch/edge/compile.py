"""The edge compile layer's warrant predicate (from `bng_tpu/edge/compile.py`).

The invariant audit's tap clauses ask whether a warrant is ACTIVE and
inside its validity window right now. The warrant-to-row and routing
programs themselves (`InterceptTapProgram`, `RouteProgram`, `MirrorPump`)
are not ported; a caller passes its own to `audit_invariants`.
"""

from __future__ import annotations

WARRANT_ACTIVE = "active"  # the intercept manager's WarrantStatus.ACTIVE value


def _active_in_window(w, now: float) -> bool:
    return w.status == WARRANT_ACTIVE and w.valid_from <= now < w.valid_until
