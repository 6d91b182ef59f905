"""Mean host `issue` span a ring batch: the device program's ops issued
from Python, the fused step or the DHCP-only program (`tele.region(ISSUE)`)."""


def read(run):
    tr = run.layer.get("tracer")
    bd = tr.breakdown() if tr is not None else {}
    return bd["issue"]["mean_us"] / 1e3 if "issue" in bd else None
