"""Mean host `nat44` span a fused step: the NAT44 stage's ops issued,
inside `issue` (`tele.region(NAT44)`)."""


def read(run):
    tr = run.layer.get("tracer")
    bd = tr.breakdown() if tr is not None else {}
    return bd["nat44"]["mean_us"] / 1e3 if "nat44" in bd else None
