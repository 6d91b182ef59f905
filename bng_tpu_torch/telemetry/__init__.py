"""Telemetry: the mergeable latency histograms (`hist.py`)."""
