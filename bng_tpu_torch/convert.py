"""Carry device state between the JAX package and the port.

`tables_from_numpy` turns a `PipelineTables` of the JAX package whose
leaves were fetched with `np.asarray` (uint32 words) into the port's
`PipelineTables` of int32 word tensors on `device`, every stage's leaves
included (garden, PPPoE, edge; a stage left out stays None);
`tables_to_numpy` goes back to uint32 numpy for comparison. The
structures are matched by NamedTuple class and field names, so this
module needs nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from bng_tpu_torch.ops.dhcp import DHCPTables
from bng_tpu_torch.ops.nat44 import NATTables
from bng_tpu_torch.ops.pipeline import PipelineTables
from bng_tpu_torch.ops.qtable import QTableState
from bng_tpu_torch.ops.table import TableState

_PORT_TYPES = {cls.__name__: cls for cls in
               (PipelineTables, DHCPTables, NATTables, TableState, QTableState)}


def _leaf_to_tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        raise TypeError(f"table leaf of dtype {a.dtype}: expected uint32 words")
    return torch.from_numpy(a.copy()).to(device)


def tables_from_numpy(tables, device) -> PipelineTables:
    """JAX-package PipelineTables (numpy uint32 leaves) -> the port's tensors."""
    def conv(x):
        cls = _PORT_TYPES.get(type(x).__name__)
        if cls is None:
            return _leaf_to_tensor(x, device)
        return cls(**{f: conv(getattr(x, f)) for f in cls._fields
                      if getattr(x, f, None) is not None})

    return conv(tables)


def tables_to_numpy(tables):
    """The port's tables -> the same NamedTuples with uint32 numpy leaves."""
    if isinstance(tables, torch.Tensor):
        a = tables.detach().cpu().numpy()
        return a.view(np.uint32) if a.dtype == np.int32 else a
    if tables is None:
        return None
    return type(tables)(*(tables_to_numpy(v) for v in tables))
