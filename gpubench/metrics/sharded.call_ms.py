"""Mean time of one `ShardedCluster.process_ring_pipelined` call in the
window (the benchmark's own span around it: the cluster records none)."""

import numpy as np


def read(run):
    c = run.layer.get("call_s")
    return float(np.mean(c)) * 1e3 if c else None
