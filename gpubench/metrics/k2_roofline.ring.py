"""K2's share of its roofline on the ring path (bytes of seg_bound_ms)."""

from gpubench import roofline


def read(run):
    k2 = run.layer.get("k2")
    if not k2:
        return None
    nbytes, secs, calls, launches = k2
    if not calls or calls != launches:
        return None
    return roofline.share_pct(nbytes, secs, run.layer["card"])
