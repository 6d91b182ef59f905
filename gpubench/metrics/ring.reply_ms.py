"""Mean host `reply` span a ring batch: the verdicts applied to the ring
(`NativeRing.complete`) and the slow ring drained."""


def read(run):
    tr = run.layer.get("tracer")
    bd = tr.breakdown() if tr is not None else {}
    return bd["reply"]["mean_us"] / 1e3 if "reply" in bd else None
