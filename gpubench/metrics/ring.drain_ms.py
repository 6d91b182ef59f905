"""Mean host `drain` span a ring batch: inside `dispatch`, the DHCP chain's
placement, the update drain and its apply (`tele.region(DRAIN)`)."""


def read(run):
    tr = run.layer.get("tracer")
    bd = tr.breakdown() if tr is not None else {}
    return bd["drain"]["mean_us"] / 1e3 if "drain" in bd else None
