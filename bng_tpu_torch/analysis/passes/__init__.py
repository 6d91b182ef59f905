"""The bngcheck pass registry — one module per discipline."""

from __future__ import annotations

from bng_tpu_torch.analysis.passes.concurrency import ConcurrencyPass
from bng_tpu_torch.analysis.passes.fencing import FencingPass
from bng_tpu_torch.analysis.passes.gather import NarrowGatherPass
from bng_tpu_torch.analysis.passes.handlers import HandlerAuditPass
from bng_tpu_torch.analysis.passes.hotpath import HotPathPass
from bng_tpu_torch.analysis.passes.jit_discipline import JitDisciplinePass
from bng_tpu_torch.analysis.passes.registry import RegistryPass
from bng_tpu_torch.analysis.passes.single_writer import SingleWriterPass

ALL_PASSES = (HotPathPass, JitDisciplinePass, HandlerAuditPass,
              RegistryPass, SingleWriterPass, FencingPass,
              ConcurrencyPass, NarrowGatherPass)


def all_codes() -> dict[str, str]:
    """{BNG0xx -> description} over every registered pass."""
    out: dict[str, str] = {}
    for cls in ALL_PASSES:
        out.update(cls.codes)
    return dict(sorted(out.items()))


def build(select: set[str] | None = None):
    """Instantiate passes, optionally filtered by pass name or by a
    finding code the pass owns."""
    out = []
    for cls in ALL_PASSES:
        if select and cls.name not in select and not (
                select & set(cls.codes)):
            continue
        out.append(cls())
    return out
