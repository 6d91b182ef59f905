"""Mean `lane_wait` observation of the express lane: how long the oldest
frame of each express batch waited in the lane before its dispatch."""

import numpy as np

LANE_WAIT, LANE_EXPRESS = 2, 1  # telemetry/spans: the stage and the lane ids


def read(run):
    tr = run.layer.get("tracer")
    if tr is None or tr.events is None:
        return None
    d = [e[3] for e in tr.events if e[0] == LANE_WAIT and e[1] == LANE_EXPRESS]
    return float(np.mean(d)) / 1e6 if d else None
