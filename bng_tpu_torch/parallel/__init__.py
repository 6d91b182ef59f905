"""Sharded serving: N logical shards of the dataplane (`sharded.py`) and
the data movement of their hash-sharded lookups (`exchange.py`)."""
