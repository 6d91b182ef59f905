"""Mean host `dhcp` span a ring batch: the DHCP responder's ops issued,
inside `issue`, in the fused step and the DHCP-only program alike
(`tele.region(DHCP)`)."""


def read(run):
    tr = run.layer.get("tracer")
    bd = tr.breakdown() if tr is not None else {}
    return bd["dhcp"]["mean_us"] / 1e3 if "dhcp" in bd else None
