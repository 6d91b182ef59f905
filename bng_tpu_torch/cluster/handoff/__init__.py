"""Fabric state handoff: chunked, signed, resumable checkpoint transfer.

The carve-handoff lane for true multi-box deployment (copy of
`bng_tpu/cluster/handoff/`): a joiner hydrates its carved blocks, a replan moves block state, and a
standby bootstraps across hosts — all by streaming checkpoint bytes
over the same authenticated fabric transport the membership beats ride.
"""

from .protocol import (DEFAULT_CHUNK_SIZE, HandoffError, HandoffManager,
                       StateReceiver, StateSender, build_handoff_checkpoint,
                       parse_handoff_checkpoint)

__all__ = [
    "DEFAULT_CHUNK_SIZE", "HandoffError", "HandoffManager",
    "StateReceiver", "StateSender", "build_handoff_checkpoint",
    "parse_handoff_checkpoint",
]
