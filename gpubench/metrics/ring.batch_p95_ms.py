"""95th percentile, over the window's batches, of the time from a batch's
push into the ring to its verdicts drained from the ring (host clock)."""

import numpy as np


def read(run):
    b = [x for x in run.layer.get("batches", []) if "t_done" in x]
    if len(b) < 20:
        return None
    return float(np.percentile([(x["t_done"] - x["t_push"]) * 1e3 for x in b], 95))
