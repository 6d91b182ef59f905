"""Descriptor ring for the devloop (port of `bng_tpu/devloop/ring.py`).

One ring = k slots x B lanes x XD_WORDS uint32: k closed express batches
staged as one [k, B, XD_WORDS] block that crosses to the device once.
The host stages into `depth + 2` cycling buffers, so the slots of ring
i+1 fill a different buffer than the (up to `depth`) rings in flight. On
the card the buffers are pinned and each one's upload is an async copy
guarded by the event recorded behind it (`ops/table.PinnedStage`): a
buffer is rewritten only after the copy that read it has run.

The cursor words ([CUR_WORDS]: tail, seq, epoch) live on the device, in
the ring program (`devloop/kernel.py`), which advances them at each
replay; the host's only cursor writers are `fill_slot` (the host head)
and `adopt_cursors` at retire. Reading them (`read_cursors`) is legal
only with nothing in flight, the quiesce barrier's state.
"""

from __future__ import annotations

import numpy as np
import torch

from bng_tpu_torch.ops.express import XD_WORDS
from bng_tpu_torch.ops.table import PinnedStage

# device cursor layout ([CUR_WORDS] words, padded for alignment)
CUR_TAIL = 0   # slots drained by the LAST replay
CUR_SEQ = 1    # total slots drained since the ring program was built
CUR_EPOCH = 2  # replays since the ring program was built
CUR_WORDS = 4


class DescriptorRing:
    """Host half of one device ring: staging buffers, slot occupancy, the
    cursor handle, and the per-slot retire metadata (pending-frame lists,
    fill times) that never reaches the device."""

    def __init__(self, k: int, batch: int, depth: int = 2, device="cpu"):
        if k < 1:
            raise ValueError(f"devloop ring needs k >= 1 slots, got {k}")
        self.k = k
        self.batch = batch
        self.depth = max(1, depth)
        self._bufs = [PinnedStage((k, batch, XD_WORDS), np.uint32, device)
                      for _ in range(self.depth + 2)]
        self._buf_i = 0
        self.head = 0  # filled slots in the CURRENT (staging) ring
        self._slot_pend: list[list] = [[] for _ in range(k)]
        self._slot_fill_t: list[float] = [0.0] * k
        # the cursor words: host zeros until a retire adopts the program's
        # device tensor
        self.cursors = np.zeros((CUR_WORDS,), dtype=np.uint32)
        # occupancy accounting
        self.rings_taken = 0
        self.slots_taken = 0

    # -- host-side mutators ------------------------------------------------

    def fill_slot(self, rows: list, idxs: list, pend: list, now: float) -> int:
        """Stage one closed express batch's descriptor rows into the next free
        slot of the staging ring (unused lanes stay zero, so the program's
        validity mask skips them). Returns the slot index."""
        if self.head >= self.k:
            raise IndexError("devloop ring overfilled: dispatch before "
                             f"filling slot {self.head} of {self.k}")
        s = self.head
        stage = self._bufs[self._buf_i]
        # the first slot of a ring takes the buffer back from its last upload
        desc = (stage.acquire() if s == 0 else stage.host)[s]
        desc[:] = 0
        if rows:
            desc[idxs] = rows
        self._slot_pend[s] = pend
        self._slot_fill_t[s] = now
        self.head = s + 1
        return s

    def take(self) -> tuple:
        """Close the staging ring for dispatch: returns (buffer, n_slots,
        slots) and rotates to the next staging buffer with head
        reset. Slots beyond n_slots are zeroed in the returned buffer, so
        the program drains them as empty."""
        n = self.head
        stage = self._bufs[self._buf_i]
        if 0 < n < self.k:
            stage.host[n:] = 0  # an earlier occupancy must not resurface
        slots = self._slot_pend[:n]
        self._buf_i = (self._buf_i + 1) % len(self._bufs)
        self.head = 0
        self._slot_pend = [[] for _ in range(self.k)]
        self._slot_fill_t = [0.0] * self.k
        self.rings_taken += 1
        self.slots_taken += n
        return stage, n, slots

    def adopt_cursors(self, handle) -> None:
        """Take the ring program's cursor tensor (at retire)."""
        self.cursors = handle

    # -- queries -------------------------------------------------------------

    @property
    def oldest_fill_t(self) -> float | None:
        """Enqueue time of the oldest staged slot (the deadline close)."""
        return self._slot_fill_t[0] if self.head else None

    @property
    def fill_times(self) -> list[float]:
        """Fill time of each staged slot, oldest first."""
        return self._slot_fill_t[: self.head]

    @property
    def staging_waits(self) -> int:
        """Slot fills that had to wait for their buffer's last upload."""
        return sum(st.waits for st in self._bufs)

    def occupancy_avg(self) -> float:
        """Mean slots per dispatched ring over k (1.0: every ring full)."""
        if not self.rings_taken:
            return 0.0
        return self.slots_taken / (self.rings_taken * self.k)

    def read_cursors(self) -> np.ndarray:
        """The live cursor words as uint32. Only legal with nothing in flight
        (the quiesce barrier); on the card it waits for the stream."""
        cur = self.cursors
        if isinstance(cur, torch.Tensor):
            cur = cur.cpu().numpy()
        return np.asarray(cur).astype(np.uint32)
