"""Mean host `dispatch` span of the express lane (drain, descriptor
upload, graph replay)."""

import numpy as np

DISPATCH, LANE_EXPRESS = 3, 1  # telemetry/spans: the stage and the lane ids


def read(run):
    tr = run.layer.get("tracer")
    if tr is None or tr.events is None:
        return None
    d = [e[3] for e in tr.events if e[0] == DISPATCH and e[1] == LANE_EXPRESS]
    return float(np.mean(d)) / 1e6 if d else None
