"""K1's share of its roofline on the ring path: the bytes its calls in the
profiled slice need (gpubench/roofline.py), over the card's bandwidth,
against the profiler's K1 time."""

from gpubench import roofline


def read(run):
    k1 = run.layer.get("k1")
    if not k1:
        return None
    nbytes, secs, calls, launches = k1
    if not calls or calls != launches:
        return None
    return roofline.share_pct(nbytes, secs, run.layer["card"])
