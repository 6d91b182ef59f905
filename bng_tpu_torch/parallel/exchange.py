"""The data movement of a sharded lookup (`ops/table.py:sharded_lookup`).

The reference exchanges keys and results between chips with two
`lax.all_to_all` collectives (`bng_tpu/ops/table.py:228-287`). Here each
shard of a `ShardedCluster` sits on the device its shard-to-device map
gives it (`parallel/sharded.place_shards`), and an exchange object moves a
source shard's per-destination request rows to their owners and the
owners' packed results back:

- `DeviceLocalExchange`, every shard on one device: a view, no copy;
- `CopyingExchange`, shards on several cards: `send` copies each owner
  its [C, K] request rows onto the owner's card, `receive` copies the
  owners' [C, V+2] packed results back onto the source shard's card.

A copy between two cards (`Tensor.to`) is queued on the source card's
stream behind an event recorded on the destination card's stream, and
the destination card's stream waits on an event recorded after it: the
two cards' streams are ordered by events, and the host waits for
neither. On one device the copies are plain copies on its stream, so
the copying exchange can be driven (and held bit-equal to the local one)
on one card or on the CPU.

The exchange moves only the lookup's rows. The rest of what knows where
shards live is `ShardedCluster`: each shard's lanes and `now` go up to
its card, and `sharded_step` gathers the lanes and sums the stats on the
home card, shard 0's.
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
            raise ValueError(
                f"shards on several devices ({sorted(set(map(str, devices)))}): a view "
                "cannot reach another device's rows; use CopyingExchange")
        self.devices = devices

    def send(self, src: int, req: torch.Tensor) -> list[torch.Tensor]:
        return list(req.unbind(0))

    def receive(self, src: int, resp: list[torch.Tensor]) -> torch.Tensor:
        return torch.stack(resp)


class CopyingExchange:
    """Shards on the devices `devices[i]` (any list, one per shard): the
    request rows travel to their owners' cards and the results back, each
    as a copy ordered by events between the two cards' streams."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]

    def send(self, src: int, req: torch.Tensor) -> list[torch.Tensor]:
        return [rows.to(self.devices[o], non_blocking=True, copy=True)
                for o, rows in enumerate(req.unbind(0))]

    def receive(self, src: int, resp: list[torch.Tensor]) -> torch.Tensor:
        home = self.devices[src]
        return torch.stack([r.to(home, non_blocking=True, copy=True) for r in resp])


def exchange_for(devices):
    """The exchange a shard-to-device map takes: the view for one device,
    the copying exchange for several."""
    devices = [torch.device(d) for d in devices]
    return DeviceLocalExchange(devices) if len(set(devices)) == 1 else CopyingExchange(devices)
