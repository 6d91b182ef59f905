"""Share of the window's ring batches whose frames moved by descriptor
(%): the program's `ring_dma` spans (the zero-copy loop's gather, inside
`upload`) over its `upload` spans. None where the program has no such
stage, or no traced window."""


def read(run):
    tr = run.layer.get("tracer")
    if tr is None:
        return None
    from bng_tpu_torch.telemetry.spans import STAGE_NAMES

    bd = tr.breakdown()
    if "ring_dma" not in STAGE_NAMES or "upload" not in bd:
        return None
    return 100.0 * bd.get("ring_dma", {"count": 0})["count"] / bd["upload"]["count"]
