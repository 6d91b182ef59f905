"""Checkpoint files and the background cadence (port of
`bng_tpu/control/statestore.py`).

`runtime/checkpoint.py` owns what a snapshot holds and its bytes; this
module owns the files around it:

- `CheckpointStore`: a directory of versioned `ckpt-<seq>.bngckpt` files.
  A save writes a temporary file in the same directory, fsyncs it and
  lands it with one atomic `os.replace` (a crash mid-write never shadows
  the last good file); a load walks newest first and skips files the
  decoder rejects, so a torn newest file falls back to the one before.
  Chaos points `ckpt.write` and `ckpt.read` (truncate, bitflip,
  io_error) corrupt or refuse the bytes on their way.

- `PeriodicCheckpointer`: the cadence around a snapshot function, with
  retention, stats and a rate-limited failure log. A failing background
  save is counted and logged and never raises into the loop it rides on.

HA standby hydration is not ported: a checkpoint carrying an HA session
store is refused by the restore, as when the component is absent.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Callable, NamedTuple

from bng_tpu_torch.chaos.faults import mutate_point
from bng_tpu_torch.runtime.checkpoint import (Checkpoint, CheckpointError, decode_checkpoint,
                                              encode_checkpoint, verify_checkpoint_bytes)
from bng_tpu_torch.utils.structlog import RateLimiter, get_logger

CKPT_SUFFIX = ".bngckpt"
_CKPT_PREFIX = "ckpt-"


class CheckpointInfo(NamedTuple):
    """One store entry. list() fully validates each file (header CRC +
    payload CRC) — the inventory's error column is trustworthy, at the
    cost of reading the kept files (bounded by the retention policy)."""

    path: str
    seq: int
    created_at: float
    node_id: str
    bytes: int
    error: str | None  # non-None: file exists but would be rejected


class CheckpointStore:
    """Versioned, atomically-replaced checkpoint files in one directory.

    Single-writer by design: seq assignment (next_seq at save time) and
    the atomic replace assume one process snapshots into a directory; a
    second writer would put its (staler) state under the newest seq."""

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path_for(self, seq: int) -> Path:
        return self.root / f"{_CKPT_PREFIX}{seq:012d}{CKPT_SUFFIX}"

    def _candidates(self) -> list[Path]:
        """Checkpoint files, newest seq first (name-encoded, zero-padded
        so lexical order IS seq order). Files whose name doesn't parse
        as a seq are ignored — a stray `ckpt-latest.bngckpt` copy must
        not shadow the real newest or collapse next_seq."""
        return sorted((p for p in
                       self.root.glob(f"{_CKPT_PREFIX}*{CKPT_SUFFIX}")
                       if self._seq_of(p) >= 0), reverse=True)

    @staticmethod
    def _seq_of(path: Path) -> int:
        try:
            return int(path.name[len(_CKPT_PREFIX) : -len(CKPT_SUFFIX)])
        except ValueError:
            return -1

    def has_checkpoints(self) -> bool:
        """Any candidate files on disk — a zero-read cold-start probe
        (whether the newest is restorable is load_latest's call)."""
        return bool(self._candidates())

    def next_seq(self) -> int:
        """Monotonic sequence number for the next save (max on disk + 1,
        so restarts never reuse a seq even after a restore)."""
        cands = self._candidates()
        return (self._seq_of(cands[0]) + 1) if cands else 1

    def save(self, ckpt: Checkpoint) -> Path:
        """Encode + write atomically; returns the final path."""
        # chaos hook: truncation/bit-flip corrupts the bytes that land
        # on disk (the decoder must reject them later); io_error raises
        # before any file exists (the failure-counter path)
        data = mutate_point("ckpt.write", encode_checkpoint(ckpt))
        final = self._path_for(ckpt.seq)
        tmp = self.root / f".tmp-{final.name}.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        finally:
            if tmp.exists():  # failed before the rename
                tmp.unlink(missing_ok=True)
        # fsync the directory so the rename itself survives power loss
        # (best effort: not every filesystem supports O_DIRECTORY opens)
        try:
            dfd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        return final

    def load(self, path: str | os.PathLike) -> Checkpoint:
        """Decode one specific file (CheckpointError on any corruption)."""
        try:
            # chaos hook: read-side corruption (bad disk / torn page) —
            # the decoder's CRC gates must reject, never half-hydrate
            data = mutate_point("ckpt.read", Path(path).read_bytes())
        except OSError as e:
            raise CheckpointError(f"cannot read checkpoint {path}: {e}") from e
        return decode_checkpoint(data)

    def load_latest(self) -> tuple[Checkpoint, Path]:
        """Newest restorable checkpoint. A corrupt newer file is skipped
        (with its error collected) in favor of an older good one; raises
        CheckpointError when the store holds nothing restorable."""
        errors = []
        for path in self._candidates():
            try:
                return self.load(path), path
            except CheckpointError as e:
                errors.append(f"{path.name}: {e}")
        if errors:
            raise CheckpointError(
                "no restorable checkpoint in "
                f"{self.root}: {'; '.join(errors)}")
        raise CheckpointError(f"no checkpoints in {self.root}")

    def list(self) -> list[CheckpointInfo]:
        """Inventory, newest first (the `checkpoint info` feed): headers
        plus the checksum gate, no array materialization. Corrupt files
        appear with their rejection reason."""
        out = []
        for path in self._candidates():
            size = 0
            try:
                size = path.stat().st_size
                header, _ = verify_checkpoint_bytes(path.read_bytes())
                meta = header.get("meta", {})
                out.append(CheckpointInfo(
                    str(path), int(meta.get("seq", self._seq_of(path))),
                    float(meta.get("created_at", 0.0)),
                    str(meta.get("node_id", "")), size, None))
            except (CheckpointError, OSError) as e:
                # vanished mid-listing (concurrent prune) or unreadable:
                # flag it, never crash the inventory
                out.append(CheckpointInfo(str(path), self._seq_of(path),
                                          0.0, "", size, str(e)))
        return out

    def prune(self, keep: int = 3) -> int:
        """Drop all but the newest `keep` checkpoints; returns removed
        count. Corrupt files older than the cut go too."""
        removed = 0
        for path in self._candidates()[max(keep, 1):]:
            path.unlink(missing_ok=True)
            removed += 1
        return removed


class PeriodicCheckpointer:
    """Cadence + bookkeeping around a snapshot function.

    `snapshot_fn(seq, now) -> Checkpoint` is the caller's closure (it
    quiesces the scheduler and collects the components); this class owns
    when it runs, the retention policy, the stats, and the rate-limited
    failure log.
    """

    def __init__(self, store: CheckpointStore,
                 snapshot_fn: Callable[[int, float], Checkpoint],
                 interval_s: float = 0.0, keep: int = 3,
                 clock: Callable[[], float] = time.time):
        self.store = store
        self.snapshot_fn = snapshot_fn
        self.interval_s = float(interval_s)
        self.keep = keep
        self.clock = clock
        # staleness origin before the FIRST success: an unwritable dir
        # from boot must read as a GROWING age, not a perpetually-fresh 0
        self.started_at = clock()
        self._last_attempt = 0.0
        self._log = get_logger("checkpoint")
        self._err_limit = RateLimiter(rate=1 / 30.0, burst=3)
        self.stats = {"saves": 0, "failures": 0, "last_success_t": 0.0,
                      "last_bytes": 0, "last_duration_s": 0.0,
                      "last_seq": 0, "last_error": ""}

    def due(self, now: float) -> bool:
        return (self.interval_s > 0
                and now - self._last_attempt >= self.interval_s)

    def tick(self, now: float | None = None) -> Path | None:
        """Background-cadence entry (the 1 Hz app tick): save when due,
        NEVER raise — a checkpoint failure must not take down the
        dataplane loop it rides on. Failures count + rate-limited log."""
        now = now if now is not None else self.clock()
        if not self.due(now):
            return None
        self._last_attempt = now
        try:
            return self.save_now(reason="interval")
        except Exception as e:  # noqa: BLE001 — disk/encode faults land here
            self._on_failure(e)
            return None

    def save_now(self, reason: str = "manual") -> Path:
        """Snapshot + write + prune (exceptions propagate: an explicit save
        wants the error; tick() wraps this)."""
        t0 = self.clock()
        seq = self.store.next_seq()
        ckpt = self.snapshot_fn(seq, t0)
        path = self.store.save(ckpt)
        dt = self.clock() - t0
        size = path.stat().st_size
        s = self.stats
        s["saves"] += 1
        s["last_success_t"] = t0
        s["last_bytes"] = size
        s["last_duration_s"] = dt
        s["last_seq"] = seq
        s["last_error"] = ""
        self._log.info("checkpoint saved", seq=seq, reason=reason,
                       bytes=size, duration_ms=round(dt * 1e3, 1))
        self.store.prune(self.keep)
        return path

    def _on_failure(self, exc: Exception) -> None:
        self.stats["failures"] += 1
        self.stats["last_error"] = f"{type(exc).__name__}: {exc}"
        ok, suppressed = self._err_limit.allow()
        if ok:
            self._log.error("background checkpoint failed",
                            error=self.stats["last_error"],
                            failures=self.stats["failures"],
                            suppressed=suppressed,
                            exc_info=(type(exc), exc, exc.__traceback__))
