"""`ring.zero_copy_share`: the share of a traced window's ring batches whose
frames moved by descriptor, from the program's `ring_dma` and `upload`
spans; nothing from an untraced run."""

from bng_tpu_torch.telemetry import spans as tele
from gpubench import harness


class Tracer:
    def __init__(self, counts: dict):
        self.counts = counts

    def breakdown(self) -> dict:
        return {stage: {"count": n} for stage, n in self.counts.items() if n}


def share(layer: dict):
    run = harness.Run(e2e={}, attempted=1, failed=0, checks={}, memory_peak_bytes=0, layer=layer)
    return harness.metric_reader("ring.zero_copy_share")(run)


def test_share_of_uploads_that_moved_by_descriptor():
    assert "ring_dma" in tele.STAGE_NAMES
    assert share({"tracer": Tracer({"upload": 40, "ring_dma": 40})}) == 100.0
    assert share({"tracer": Tracer({"upload": 40, "ring_dma": 10})}) == 25.0
    assert share({"tracer": Tracer({"upload": 40})}) == 0.0  # the copying path
    assert share({"tracer": Tracer({})}) is None
    assert share({"tracer": None}) is None
