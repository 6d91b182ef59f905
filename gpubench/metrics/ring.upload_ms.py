"""Mean host `upload` span a ring batch: inside `dispatch`, the staged
frames, lengths, lane flags and `now` onto the card (`tele.region(UPLOAD)`)."""


def read(run):
    tr = run.layer.get("tracer")
    bd = tr.breakdown() if tr is not None else {}
    return bd["upload"]["mean_us"] / 1e3 if "upload" in bd else None
