"""RADIUS policy (the port holds `policy.py` only; the client,
accounting and CoA are not ported)."""
