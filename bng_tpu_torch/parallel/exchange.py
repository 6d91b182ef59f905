"""The data movement of a sharded lookup (`ops/table.py:sharded_lookup`).

The reference exchanges keys and results between chips with two
`lax.all_to_all` collectives (`bng_tpu/ops/table.py:228-287`). Here each
shard of a `ShardedCluster` sits on a device of the cluster's
shard-to-device map, and an exchange object moves a source shard's
per-destination request rows to their owners and the owners' packed
results back. It is the only part of the sharded lookup that knows
where shards live, so placing shards on several cards replaces this
object alone.
"""

from __future__ import annotations

import torch


class DeviceLocalExchange:
    """Every shard on one device: the exchange is a view, not a copy.

    `send(src, req)` takes shard `src`'s [N, C, K] request rows and
    returns the [C, K] rows each owner probes; `receive(src, resp)` takes
    each owner's [C, V+2] packed results and returns the [N, C, V+2]
    block that shard `src` reads its lanes' cells from."""

    def __init__(self, devices):
        devices = [torch.device(d) for d in devices]
        if len(set(devices)) != 1:
            raise NotImplementedError(
                f"shards on several devices ({sorted(set(map(str, devices)))}) need an "
                "exchange that copies between them; this one keeps every shard on one device")
        self.devices = devices

    def send(self, src: int, req: torch.Tensor) -> list[torch.Tensor]:
        return list(req.unbind(0))

    def receive(self, src: int, resp: list[torch.Tensor]) -> torch.Tensor:
        return torch.stack(resp)
