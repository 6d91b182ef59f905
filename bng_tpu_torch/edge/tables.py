"""Host side of the edge-protection tables (port of `bng_tpu/edge/tables.py`).

`EdgeTables` is the single writer for the tap-match and next-hop route
tables: numpy mirrors of the device cuckoo tables plus the dense tap
filter and config arrays, drained through the engine's update tail as
(tap delta, filters, config, route delta). `tap_rows` / `route_rows` are
the audit and re-shard walk surface; `checkpoint_state` / `restore_state`
the checkpoint component.
"""

from __future__ import annotations

import numpy as np

from bng_tpu_torch.edge.ops import (
    ROUTE_WORDS, RW_CLASS, RW_FLAG, RW_MAC_HI, RW_MAC_LO, RW_TABLE, TAP_CONFIG_WORDS,
    TAP_FILTER_COLS, TAP_WORDS, TC_ARMED, TF_PEER, TF_PORT, TF_PROTO, TF_WID, TW_FLAG, TW_WID,
)
from bng_tpu_torch.ops.table import HostTable, TableGeom, words_to_device

MAX_TAP_FILTERS = 64


class EdgeTables:
    """Both tables key on the subscriber IPv4 (one word)."""

    def __init__(self, nbuckets: int = 1 << 10, stash: int = 64, update_slots: int = 64,
                 max_filters: int = MAX_TAP_FILTERS):
        self.tap = HostTable(nbuckets, key_words=1, val_words=TAP_WORDS, stash=stash,
                             name="edge_tap")
        self.route = HostTable(nbuckets, key_words=1, val_words=ROUTE_WORDS, stash=stash,
                               name="edge_route")
        self.tap_filters = np.zeros((max_filters, TAP_FILTER_COLS), dtype=np.uint32)
        self.tap_config = np.zeros((TAP_CONFIG_WORDS,), dtype=np.uint32)
        self.geom = TableGeom(nbuckets, stash)
        self.update_slots = update_slots
        self._armed = 0  # live tap rows (the TC_ARMED word)

    # -- taps --
    def arm_tap(self, subscriber_ip: int, wid: int,
                filters: list[tuple[int, int, int]] | tuple = ()) -> None:
        """Arm (or replace) the tap row of `subscriber_ip` under warrant
        `wid`; `filters` are (port, proto, peer_ip) rows, 0 = wildcard."""
        if wid <= 0:
            raise ValueError("warrant id must be positive (0 = free row)")
        prior = self.tap.lookup([subscriber_ip])
        row = np.zeros((TAP_WORDS,), dtype=np.uint32)
        row[TW_FLAG] = 1
        row[TW_WID] = wid
        self.tap.insert([subscriber_ip], row)
        if prior is None:
            self._armed += 1
        self.set_tap_filters(wid, filters)
        self.tap_config[TC_ARMED] = self._armed

    def disarm_tap(self, subscriber_ip: int) -> bool:
        """Remove the tap row; the warrant's filter rows stay (harmless once
        no row carries its wid)."""
        ok = self.tap.delete([subscriber_ip])
        if ok:
            self._armed -= 1
            self.tap_config[TC_ARMED] = self._armed
        return ok

    def get_tap(self, subscriber_ip: int):
        return self.tap.lookup([subscriber_ip])

    def set_tap_filters(self, wid: int, filters: list[tuple[int, int, int]] | tuple) -> int:
        """Replace warrant `wid`'s filter rows; returns the rows written
        (truncated at the dense array's capacity)."""
        fw = self.tap_filters[:, TF_WID]
        rows = self.tap_filters[(fw != 0) & (fw != np.uint32(wid))]
        self.tap_filters[:] = 0
        self.tap_filters[:len(rows)] = rows
        free = len(self.tap_filters) - len(rows)
        wrote = 0
        for port, proto, peer in tuple(filters)[:free]:
            r = self.tap_filters[len(rows) + wrote]
            r[TF_WID] = wid
            r[TF_PORT] = port
            r[TF_PROTO] = proto
            r[TF_PEER] = peer
            wrote += 1
        return wrote

    # -- routes --
    def set_route(self, subscriber_ip: int, nh_mac: bytes, table_id: int, klass: int = 0) -> None:
        """Install or replace the next-hop row of `subscriber_ip`."""
        self.route.insert([subscriber_ip], self.route_row(nh_mac, table_id, klass))

    @staticmethod
    def route_row(nh_mac: bytes, table_id: int, klass: int = 0) -> np.ndarray:
        row = np.zeros((ROUTE_WORDS,), dtype=np.uint32)
        row[RW_FLAG] = 1
        row[RW_MAC_HI] = int.from_bytes(nh_mac[:2], "big")
        row[RW_MAC_LO] = int.from_bytes(nh_mac[2:6], "big")
        row[RW_TABLE] = table_id
        row[RW_CLASS] = klass
        return row

    def clear_route(self, subscriber_ip: int) -> bool:
        return self.route.delete([subscriber_ip])

    def get_route(self, subscriber_ip: int):
        return self.route.lookup([subscriber_ip])

    # -- row walks (the audit and the re-shard surface) --
    def tap_rows(self) -> list[tuple[int, np.ndarray]]:
        """[(subscriber_ip, row)] of every live tap row, by IP."""
        return self._rows(self.tap)

    def route_rows(self) -> list[tuple[int, np.ndarray]]:
        return self._rows(self.route)

    @staticmethod
    def _rows(table: HostTable) -> list[tuple[int, np.ndarray]]:
        out = [(int(table.keys[s, 0]), table.vals[s].copy()) for s in np.nonzero(table.used)[0]]
        out.sort(key=lambda kv: kv[0])
        return out

    # -- device sync --
    def make_updates(self, device):
        """(tap delta, filters, config, route delta): the edge tail of the
        engine's update batch."""
        return (self.tap.make_update(self.update_slots, device),
                words_to_device(self.tap_filters, device),
                words_to_device(self.tap_config, device),
                self.route.make_update(self.update_slots, device))

    def empty_updates(self, device):
        """No-op deltas that leave dirty tracking alone (the scheduler's bulk
        lane); the dense arrays are re-read, since they apply wholesale."""
        return (self.tap.empty_update(self.update_slots, device),
                words_to_device(self.tap_filters, device),
                words_to_device(self.tap_config, device),
                self.route.empty_update(self.update_slots, device))

    def dirty_count(self) -> int:
        return self.tap.dirty_count() + self.route.dirty_count()

    # -- checkpoint (runtime/checkpoint.py) --
    def checkpoint_state(self) -> tuple[dict, dict]:
        meta = {"geom": {"tap": self.tap.checkpoint_geom(), "route": self.route.checkpoint_geom()},
                "max_filters": len(self.tap_filters)}
        arrays = {f"{t}.{k}": v
                  for t in ("tap", "route")
                  for k, v in getattr(self, t).checkpoint_arrays().items()}
        arrays["tap_filters"] = self.tap_filters
        arrays["tap_config"] = self.tap_config
        return meta, arrays

    def restore_state(self, meta: dict, arrays: dict) -> dict[str, int]:
        """Hydrate both tables and the dense arrays; the armed predicate is
        re-armed from the restored tap row count."""
        rows = {}
        for t in ("tap", "route"):
            rows[t] = getattr(self, t).restore_arrays(
                {k: arrays[f"{t}.{k}"] for k in ("keys", "vals", "used")}, meta["geom"][t])
        if arrays["tap_filters"].shape != self.tap_filters.shape:
            raise ValueError(f"checkpoint tap_filters shape {arrays['tap_filters'].shape} != "
                             f"{self.tap_filters.shape}")
        self.tap_filters[:] = arrays["tap_filters"]
        self.tap_config[:] = arrays["tap_config"]
        self._armed = rows["tap"]
        self.tap_config[TC_ARMED] = self._armed
        return rows
