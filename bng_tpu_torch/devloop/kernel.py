"""The devloop's ring program (port of `bng_tpu/devloop/kernel.py`).

One program drains up to k descriptor-ring slots per dispatch: for each
slot it runs the express probe cascade (`ops/express.express_verdicts`,
the per-batch express program's own function, which stays the identity
oracle and the fallback), sums the slots' stats, and advances the cursor
words (tail = n, seq += n, epoch += 1). The reference's `lax.scan` over
the slots becomes, on the card, one CUDA graph per (k, batch, key): k
copies of `express_verdicts` over the slots of a static [k, B, XD_WORDS]
ring buffer (3k K1 launches), captured when the scheduler starts and
never on the dispatch path. A replay adds the graph's captured launches
to `kernels.LAUNCHES`, as `runtime/engine.ExpressProgram` does. On the
CPU it is a plain loop over the slots.

Unfilled slots and lanes are zero rows: no XF_VALID flag, verdict 0, no
stats, so one program serves partial rings.

The program reads its own copy of the DHCP tables, the *leading* copy,
which holds the deltas of every ring dispatched so far. The engine's
published tables (`engine.tables.dhcp`) get a ring's deltas only when the
ring retires (`Engine.adopt_devloop_chain`), as the reference publishes
each ring's output chain at retire: a bulk-lane replica refresh taken
while a ring is in flight reads the tables without that ring's leases in
both packages. `seed` copies the published tables into the leading copy
in place (the graph keeps its addresses), whenever nothing is in flight
and the two may differ (first dispatch, after a per-batch fallback or a
resync).

A CUDA graph, not a persistent kernel: the choice between them waits on
an H100 measurement of the graph's device time per replay.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bng_tpu_torch import kernels
from bng_tpu_torch.devloop.ring import CUR_EPOCH, CUR_SEQ, CUR_TAIL, CUR_WORDS
from bng_tpu_torch.ops.express import XD_WORDS, express_verdicts
from bng_tpu_torch.ops.hashing import MASK32
from bng_tpu_torch.ops.table import to_device
from bng_tpu_torch.runtime.tables import clone_dhcp, copy_dhcp_


class DevloopResult(NamedTuple):
    """One ring dispatch's outputs: the program's own buffers, rewritten by
    the next replay (take them with the engine's `_InFlight` first)."""

    blocks: torch.Tensor      # [k, B, XD_WORDS] int32 words (VB_* columns)
    cursors: torch.Tensor     # [CUR_WORDS] int64 (uint32 values)
    dhcp_stats: torch.Tensor  # [NSTATS] int64, summed across the slots


class DevloopProgram:
    """The ring program for one (k, batch) over one engine's DHCP tables."""

    def __init__(self, eng, k: int, batch: int):
        self.k, self.batch = k, batch
        dev = eng.device
        self.geom = eng.geom.dhcp
        self.tables = clone_dhcp(eng.tables.dhcp)  # the leading copy
        self.ring = torch.zeros((k, batch, XD_WORDS), dtype=torch.int32, device=dev)
        self.n = torch.zeros((), dtype=torch.int64, device=dev)
        self.now = torch.zeros((), dtype=torch.int64, device=dev)
        self.cursors = torch.zeros((CUR_WORDS,), dtype=torch.int64, device=dev)
        self.graph, self.launches = None, {}
        if dev.type == "cuda":
            self._capture(dev)

    def _run(self) -> DevloopResult:
        blocks, stats = [], None
        for s in range(self.k):
            res = express_verdicts(self.tables, self.ring[s], self.geom, self.now)
            blocks.append(res.block)
            stats = res.stats if stats is None else (stats + res.stats) & MASK32
        cur = self.cursors
        seq, epoch = (cur[CUR_SEQ] + self.n) & MASK32, (cur[CUR_EPOCH] + 1) & MASK32
        cur[CUR_TAIL] = self.n
        cur[CUR_SEQ] = seq
        cur[CUR_EPOCH] = epoch
        return DevloopResult(torch.stack(blocks), cur, stats)

    def _capture(self, dev) -> None:
        # warm on a side stream first (loads K1, fills the caching
        # allocator), as CUDA graph capture asks
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._run()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = self._run()
        # the capture recorded these launches; they run at each replay
        self.launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        kernels.LAUNCHES.update(before)
        self.graph = graph
        self.cursors.zero_()  # the warm-up advanced them

    def seed(self, dhcp_tables) -> None:
        """Leading copy <- the engine's published tables (in place)."""
        copy_dhcp_(self.tables, dhcp_tables)

    def seed_cursors(self, cursors) -> None:
        """Cursor words <- a ring's (host zeros or another program's)."""
        if cursors is self.cursors:
            return
        if not isinstance(cursors, torch.Tensor):
            cursors = to_device(np.asarray(cursors, dtype=np.int64), self.cursors.device)
        self.cursors.copy_(cursors)

    def __call__(self, stage, n_slots: int, now: float) -> DevloopResult:
        """Run one ring staged in `stage` (an `ops/table.PinnedStage`)."""
        stage.upload_into(self.ring)
        self.n.fill_(int(n_slots))
        self.now.fill_(int(now) & MASK32)
        if self.graph is None:
            return self._run()
        self.graph.replay()
        for k, n in self.launches.items():
            kernels.LAUNCHES[k] += n
        return self.out


def devloop_key(engine, k: int, batch: int, device=None) -> tuple:
    """What the program bakes in: the table and update shapes, k, the batch
    and the device. (No resync count: a resync re-seeds the leading copy in
    place, which keeps the graph's addresses.)"""
    return (engine.fastpath.geom, len(engine.fastpath.pools), engine.fastpath.update_slots,
            k, batch, str(engine._express_device(device)))


def get_compiled(engine, k: int, batch: int, device=None) -> DevloopProgram | None:
    """The ring program for this geometry, or None: a None is the geometry
    miss the pump falls back from, loudly. It never captures."""
    return engine._devloop_programs.get(devloop_key(engine, k, batch, device))


def compile_devloop(engine, k: int, batch: int, device=None) -> DevloopProgram:
    """Build the ring program for one geometry (on the card: capture its
    graph), at scheduler init or engine adoption, never on the dispatch
    path. Kept per key, so a second call builds nothing new."""
    key = devloop_key(engine, k, batch, device)
    prog = engine._devloop_programs.get(key)
    if prog is None:
        prog = engine._devloop_programs[key] = DevloopProgram(engine, k, batch)
        engine.devloop_captures += 1
    return prog
