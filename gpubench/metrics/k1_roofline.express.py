"""K1's share of its roofline inside the express graph: the bytes of its
three probes a replay (the VLAN, circuit-ID and MAC keys of the
descriptors sent), over the card's bandwidth, against the profiler's K1
time in the graph's launches."""

from gpubench import roofline


def read(run):
    k1 = run.layer.get("k1_express")
    if not k1:
        return None
    nbytes, secs, calls, launches = k1
    if not calls or calls != launches:
        return None
    return roofline.share_pct(nbytes, secs, run.layer["card"])
