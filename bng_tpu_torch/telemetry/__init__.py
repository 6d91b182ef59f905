"""Telemetry: the mergeable latency histograms (`hist.py`) and the span hooks (`spans.py`)."""
