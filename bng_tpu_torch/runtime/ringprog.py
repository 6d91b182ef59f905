"""The ring loops' device programs, replayed from a tape of CUDA graphs.

A ring batch runs one of the engine's two device programs
(`runtime/engine.py`): the fused step (`ops/pipeline.pipeline_step`) or
the DHCP-only program (`engine.dhcp_program`). Issued from Python they
are some 3,200 and 1,700 small ATen ops around their 8 (12 with every
stage) K1 and 4 K2 launches, or 3 K1, and the host takes longer to issue
them than the card takes to run them. A `RingProgram` issues one
program over one set of table tensors as a tape recorded once on the
card:

- a captured CUDA graph for each run of ATen ops;
- an eager call for each K1 (`ops/table.probe`) or K2
  (`ops/qos.seg_prefix_total`) launch, looked up in its module at call
  time as the program's own code looks it up, so the wrappers check,
  count and launch the kernels at each replay as they do for the eager
  program; their outputs are copied into the tensors the next graph was
  captured to read (three copies a K1 call, two a K2 call);
- the bounds of every stage region (`telemetry/spans.region`), where a
  segment also ends: a replay re-enters each stage's region around its
  graphs and kernel calls, so the stage spans, the `bng::<stage>`
  profiler ranges and the idle gaps they label read as for the eager
  program, less the host time that replay saves.

Recording (`Tape.record`): the program runs once more inside a capture
on its card, while the kernel entries and the region hook are listened
to. At each kernel call or region bound the capture ends, the graph just
captured is replayed once (so a kernel reads computed inputs, never
stale pool memory), the kernel runs eagerly, and the next capture opens.
Every tensor a graph writes is allocated inside a capture, from the
program's one private pool, and every segment's inputs and outputs stay
referenced for the program's life. A capture that holds no work (two
bounds with no op between them) is left out of the tape but kept alive
(`Tape._end`). On the CPU no program is built: the engine runs the plain
call.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import warnings

import numpy as np
import torch

from bng_tpu_torch import kernels
from bng_tpu_torch.ops import qos as qos_mod
from bng_tpu_torch.ops import table as table_mod
from bng_tpu_torch.ops import umem as umem_ops
from bng_tpu_torch.ops.hashing import MASK32
from bng_tpu_torch.ops.table import upload_into
from bng_tpu_torch.telemetry import spans as tele

GRAPH, KERNEL, ENTER, EXIT = range(4)  # the kinds of a tape's entries

# the kernel entries a device program calls, by module attribute: where the
# program's code finds them, and where a caller may wrap them
KERNEL_SITES = ((table_mod, "probe"), (qos_mod, "seg_prefix_total"))


def _card(dev: torch.device):
    """`dev` made the current card for the block (nothing on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


# what torch warns when a capture holds no work (a segment between two
# bounds with no op in it): such a graph is left out of the tape
_EMPTY_GRAPH = "The CUDA Graph is empty"


class Tape:
    """A device program recorded on one card as graphs, kernel calls and
    stage bounds, in the order it ran (`record`), and replayed in that
    order on the card's current stream (`replay`)."""

    def __init__(self, dev: torch.device):
        self.device = dev
        self.ops: list[tuple] = []
        self.out = None
        self.pool = None  # the segments' one private pool, made at the first capture
        self._stream = None  # the captures' stream
        self._stream_ctx = None
        self._graph = None  # the segment being captured
        self._empty: list = []  # captures that held no work
        self._thread = None

    # -- recording --
    def record(self, run):
        """Run `run()` once, recording it; returns its outputs (the
        program's output buffers from now on)."""
        self._thread = threading.get_ident()
        sites = [(mod, name, getattr(mod, name)) for mod, name in KERNEL_SITES]
        for mod, name, fn in sites:
            setattr(mod, name, self._kernel_call(mod, name, fn))
        tele.listen(self)
        # no garbage is collected mid-capture: a cycle freed there could
        # release pinned memory or an event, a call the capture refuses
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with _card(self.device):
                self._begin()
                out = run()
                self._cut()
        finally:
            if gc_on:
                gc.enable()
            tele.listen(None)
            for mod, name, fn in sites:
                setattr(mod, name, fn)
            if self._graph is not None:  # the run failed mid-capture
                with contextlib.suppress(RuntimeError):  # the run's own error is raised
                    self._end()
        self.out = out
        return out

    def _begin(self) -> None:
        """Open a capture on the card: every op the program issues from
        here to the next bound is captured, and every tensor it allocates
        comes from the program's pool."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        self._stream_ctx = torch.cuda.stream(self._stream)
        self._stream_ctx.__enter__()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self._graph = graph

    def _end(self):
        """Close the open capture; returns its graph, or None when it holds
        no work."""
        graph, self._graph = self._graph, None
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                graph.capture_end()
        finally:
            self._stream_ctx.__exit__(None, None, None)
        empty = False
        for w in seen:
            if str(w.message).startswith(_EMPTY_GRAPH):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        if empty:
            # never replayed, but kept: each capture into the shared pool counts
            # one use of it until its graph is freed. Freeing an empty graph (a
            # program that opens a region at once makes its first capture one)
            # took the pool's count to 0, and the next capture into it failed
            # torch's `use_count > 0` assert in the caching allocator. The card
            # test `test_empty_segments_between_bounds` pins this and the
            # warning's text.
            self._empty.append(graph)
            return None
        return graph

    def _cut(self) -> None:
        """End the open capture, and replay its graph once (a kernel after
        it reads what the graph computed)."""
        graph = self._end()
        if graph is not None:
            graph.replay()
            self.ops.append((GRAPH, graph))

    def _kernel_call(self, mod, name: str, fn):
        def call(*args, **kwargs):
            if threading.get_ident() != self._thread:
                return fn(*args, **kwargs)
            self._cut()
            outs = fn(*args, **kwargs)  # eager, its outputs the next graph's inputs
            self.ops.append((KERNEL, mod, name, args, kwargs, tuple(outs)))
            self._begin()
            return outs

        return call

    def _bound(self, kind: int, stage: int) -> None:
        if threading.get_ident() == self._thread:
            self._cut()
            self.ops.append((kind, stage))
            self._begin()

    def enter(self, stage: int) -> None:
        self._bound(ENTER, stage)

    def exit(self, stage: int) -> None:
        self._bound(EXIT, stage)

    # -- replay --
    def replay(self):
        """Queue the program once more; returns its output buffers."""
        regions = []
        try:
            with _card(self.device):
                for op in self.ops:
                    kind = op[0]
                    if kind == GRAPH:
                        op[1].replay()
                    elif kind == KERNEL:
                        _, mod, name, args, kwargs, outs = op
                        for dst, src in zip(outs, getattr(mod, name)(*args, **kwargs)):
                            dst.copy_(src)
                    elif kind == ENTER:
                        region = tele.region(op[1])
                        region.__enter__()
                        regions.append(region)
                    else:
                        regions.pop().__exit__(None, None, None)
        except BaseException as e:
            while regions:  # a failed region is not timed
                regions.pop().__exit__(type(e), e, e.__traceback__)
            raise
        return self.out


class RingProgram:
    """One device program of the ring loops on its card: its static inputs
    (`pkt` [B, L], `length`, `fa` (the fused step's alone), `now_s`,
    `now_us` (the fused step's alone)), its tape and its output buffers.

    Built on the first ring batch of its program (`Engine._ring_program`): over
    a batch of empty lanes (length 0) the program runs `WARMUPS` times
    (every kernel loaded, every constant row that a graph reads by address
    uploaded), then is recorded, with the table tensors it writes
    (`writes`) saved before and restored after: building it leaves every
    table word as it was, and its launches count none
    (`kernels.recording`).

    A dispatch writes the staged batch into the static inputs (`upload`),
    or, in the zero-copy ring loop, its descriptors into `desc` and the
    frames straight from the ring's mapped UMEM into the inputs
    (`upload_desc`, `ops/umem.gather`), and replays the tape
    (`replay`), which returns the program's own output buffers; the
    zero-copy loop then writes the TX/FWD lanes' bytes back over their
    frames (`scatter`) before it takes the outputs. The next replay
    rewrites them, so the caller queues
    their copies to the host (`engine._InFlight`) right after the replay,
    on the same stream, before it dispatches again: the pipelined ring
    loop's next replay then runs behind those copies. The table tensors
    are baked in by address: in-place drains keep them, and new tensors (a
    resync) drop the program (`Engine._rebind`)."""

    WARMUPS = 2

    def __init__(self, dev: torch.device, run, writes: list[torch.Tensor],
                 batch: int, slot: int, fused: bool):
        self.device = dev
        self.pkt = torch.zeros((batch, slot), dtype=torch.uint8, device=dev)
        self.length = torch.zeros((batch,), dtype=torch.int64, device=dev)
        self.fa = torch.zeros((batch,), dtype=torch.bool, device=dev) if fused else None
        self.now_s = torch.zeros((), dtype=torch.int64, device=dev)
        self.now_us = torch.zeros((), dtype=torch.int64, device=dev) if fused else None
        self.desc = torch.zeros((umem_ops.DESC_BYTES * batch,), dtype=torch.uint8, device=dev)
        self.tape = Tape(dev)
        saved = [t.clone() for t in writes]
        try:
            with kernels.recording():
                for _ in range(self.WARMUPS):
                    run(self)
                self.out = self.tape.record(lambda: run(self))
        finally:
            for t, s in zip(writes, saved):
                t.copy_(s)

    def upload(self, pkt: np.ndarray, length: np.ndarray, fa: np.ndarray | None,
               now: float) -> None:
        upload_into(pkt, self.pkt)
        upload_into(length, self.length)
        if self.fa is not None:
            upload_into(fa, self.fa)
        self.now_s.fill_(int(now) & MASK32)
        if self.now_us is not None:
            self.now_us.fill_(int(now * 1e6) & MASK32)

    def upload_desc(self, desc: umem_ops.DescStage, umem: umem_ops.Umem, n: int,
                    now: float) -> None:
        """A ring batch by descriptor: its descriptors into `desc` and its n
        frames from the mapped UMEM into `pkt`, `length` and `fa`, and
        `now`: one gather call, a copy and a launch (the `ring_dma` region)."""
        with tele.region(tele.RING_DMA):
            umem_ops.gather(umem, desc, self.desc, n, self.pkt, self.length, self.fa, self.now_s,
                            int(now) & MASK32, self.now_us, int(now * 1e6) & MASK32)

    def scatter(self, umem: umem_ops.Umem, n: int, res) -> None:
        """The TX/FWD lanes of `res`, the last replay's outputs, written back
        over their frames (queued behind it; the descriptors are the last
        `upload_desc`'s)."""
        umem_ops.scatter(umem, umem_ops.desc_addrs(self.desc, self.pkt.shape[0]), n,
                         res.verdict, res.out_pkt, res.out_len)

    def replay(self):
        return self.tape.replay()
