"""Mean host `dispatch` span a ring batch (telemetry/spans, armed for the window)."""


def read(run):
    tr = run.layer.get("tracer")
    bd = tr.breakdown() if tr is not None else {}
    return bd["dispatch"]["mean_us"] / 1e3 if "dispatch" in bd else None
