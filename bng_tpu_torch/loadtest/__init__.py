"""DHCP load harness (`harness.py`)."""

from bng_tpu_torch.loadtest.harness import (  # noqa: F401
    BenchmarkConfig,
    BenchmarkResult,
    DHCPBenchmark,
    StormFrameFactory,
    WireLoopTarget,
    result_json,
)
