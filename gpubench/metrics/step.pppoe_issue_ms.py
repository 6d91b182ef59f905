"""Mean host time of a fused step's PPPoE stages: its `pppoe_decap` and
`pppoe_encap` spans (`tele.region(PPPOE_DECAP)`, `tele.region(PPPOE_ENCAP)`,
inside `issue`), each the mean over the window's steps, summed."""


def read(run):
    tr = run.layer.get("tracer")
    bd = tr.breakdown() if tr is not None else {}
    if "pppoe_decap" not in bd or "pppoe_encap" not in bd:
        return None
    return (bd["pppoe_decap"]["mean_us"] + bd["pppoe_encap"]["mean_us"]) / 1e3
