"""Host runtime engine for the fused IPoE step (port of the `process` path
of `bng_tpu/runtime/engine.py`).

`Engine.process` packs frames into a [B, L] uint8 batch, drains the
bounded host->device table updates, runs one `pipeline_step` and demuxes
the verdicts: TX/FWD frames out, DROP counted, PASS lanes to the slow
path, and new NAT flows punted to `NATManager.handle_new_flow`.

The engine owns its device tensors and updates them IN PLACE: applied
host updates, NAT session counters and QoS token rows (the JAX engine
rebinds new arrays returned by a donated step). When no host table is
dirty the drain ships nothing (the dense config arrays are re-sent only
when they changed). The engine runs on the card unless the caller asks
for the CPU with `device="cpu"`.

Telemetry spans, the scheduler, express/devloop lanes, the packet ring
and checkpoints belong to later slices of the port.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from bng_tpu_torch import frames as F
from bng_tpu_torch import resolve_device
from bng_tpu_torch.control.nat import NATManager, apply_nat_updates
from bng_tpu_torch.ops.antispoof import (
    AB_IPV4, AB_MODE, AB_V6_0, AB_VALIDS, ANTISPOOF_NSTATS, ANTISPOOF_WORDS, MODE_DISABLED,
    VALID_V4, VALID_V6,
)
from bng_tpu_torch.ops.dhcp import NSTATS as DHCP_NSTATS
from bng_tpu_torch.ops.nat44 import NAT_NSTATS
from bng_tpu_torch.ops.pipeline import (
    VERDICT_DROP, VERDICT_FWD, VERDICT_TX, PipelineGeom, PipelineResult, PipelineTables,
    pipeline_step,
)
from bng_tpu_torch.ops.qos import QOS_NSTATS
from bng_tpu_torch.ops.qtable import HostQTable, QTableGeom, apply_qupdate
from bng_tpu_torch.ops.table import HostTable, TableGeom, words_to_device, apply_update
from bng_tpu_torch.runtime.tables import FastPathTables, apply_fastpath_updates
from bng_tpu_torch.utils.net import mac_to_u64, split_u64

log = logging.getLogger(__name__)

PKT_SLOT = 1536  # default per-lane packet slot (full MTU + encap headroom)


@dataclass
class EngineStats:
    dhcp: np.ndarray = field(default_factory=lambda: np.zeros(DHCP_NSTATS, dtype=np.uint64))
    nat: np.ndarray = field(default_factory=lambda: np.zeros(NAT_NSTATS, dtype=np.uint64))
    qos: np.ndarray = field(default_factory=lambda: np.zeros(QOS_NSTATS, dtype=np.uint64))
    spoof: np.ndarray = field(default_factory=lambda: np.zeros(ANTISPOOF_NSTATS, dtype=np.uint64))
    batches: int = 0
    tx: int = 0
    fwd: int = 0
    dropped: int = 0
    passed: int = 0
    slow_errors: int = 0


def _mac_key(mac) -> list[int]:
    key = mac_to_u64(mac) if not isinstance(mac, int) else mac
    lo, hi = split_u64(key)
    return [hi, lo]


class QoSTables:
    """Host side of the two QoS maps."""

    def __init__(self, nbuckets: int = 1 << 12, update_slots: int = 128):
        self.up = HostQTable(nbuckets, name="qos_ingress")
        self.down = HostQTable(nbuckets, name="qos_egress")
        self.geom = QTableGeom(nbuckets)
        self.update_slots = update_slots

    def set_subscriber(self, ip: int, down_bps: int, up_bps: int,
                       down_burst: int | None = None, up_burst: int | None = None,
                       priority: int = 0) -> None:
        # burst default: 1.25 s at rate/8 bytes, at least one MTU
        down_burst = down_burst if down_burst is not None else max(int(down_bps / 8 * 1.25), 1500)
        up_burst = up_burst if up_burst is not None else max(int(up_bps / 8 * 1.25), 1500)
        self.down.insert(ip, down_bps, down_burst, priority)
        self.up.insert(ip, up_bps, up_burst, priority)

    def bulk_set_subscribers(self, ips, down_bps: int, up_bps: int,
                             down_burst: int | None = None, up_burst: int | None = None) -> None:
        """Vectorized install for large table builds."""
        ips = np.asarray(ips, dtype=np.uint32)
        down_burst = down_burst if down_burst is not None else max(int(down_bps / 8 * 1.25), 1500)
        up_burst = up_burst if up_burst is not None else max(int(up_bps / 8 * 1.25), 1500)
        n = len(ips)
        self.down.bulk_insert(ips, np.full(n, down_bps, np.uint64), np.full(n, down_burst, np.uint32))
        self.up.bulk_insert(ips, np.full(n, up_bps, np.uint64), np.full(n, up_burst, np.uint32))

    def remove_subscriber(self, ip: int) -> None:
        self.down.delete(ip)
        self.up.delete(ip)


class AntispoofTables:
    """Host side of antispoof (MAC -> binding table, ranges, config)."""

    def __init__(self, nbuckets: int = 1 << 12, stash: int = 64, update_slots: int = 128):
        self.bindings = HostTable(nbuckets, 2, ANTISPOOF_WORDS, stash=stash,
                                  name="subscriber_bindings")
        self.ranges = np.zeros((256, 2), dtype=np.uint32)
        self.config = np.array([MODE_DISABLED, 0], dtype=np.uint32)
        self.geom = TableGeom(nbuckets, stash)
        self.update_slots = update_slots

    def set_config(self, default_mode: int, log_violations: bool) -> None:
        self.config[0] = default_mode
        self.config[1] = 1 if log_violations else 0

    def add_binding(self, mac, ipv4: int, mode: int) -> None:
        row = np.zeros((ANTISPOOF_WORDS,), dtype=np.uint32)
        row[AB_IPV4] = ipv4
        row[AB_VALIDS] = VALID_V4
        row[AB_MODE] = mode
        self.bindings.insert(_mac_key(mac), row)

    def add_binding_v6(self, mac, ipv6_words: list[int], mode: int) -> None:
        existing = self.bindings.lookup(_mac_key(mac))
        row = existing if existing is not None else np.zeros((ANTISPOOF_WORDS,), dtype=np.uint32)
        row[AB_V6_0: AB_V6_0 + 4] = np.asarray(ipv6_words, dtype=np.uint32)
        row[AB_VALIDS] |= VALID_V6
        row[AB_MODE] = mode
        self.bindings.insert(_mac_key(mac), row)

    def remove_binding(self, mac) -> bool:
        return self.bindings.delete(_mac_key(mac))

    def add_allowed_range(self, network: int, prefix_len: int) -> None:
        free = np.nonzero(self.ranges[:, 0] == 0)[0]
        if len(free) == 0:
            raise RuntimeError("allowed-ranges table full")
        self.ranges[free[0]] = (prefix_len, network)


class Engine:
    def __init__(self, fastpath: FastPathTables, nat: NATManager,
                 qos: QoSTables | None = None, antispoof: AntispoofTables | None = None,
                 batch_size: int = 256, pkt_slot: int = PKT_SLOT,
                 slow_path: Callable[[bytes], bytes | None] | None = None,
                 violation_sink: Callable[[int, bytes], None] | None = None,
                 clock: Callable[[], float] = time.time, device=None):
        self.device = resolve_device(device)
        self.fastpath = fastpath
        self.nat = nat
        self.qos = qos or QoSTables()
        self.antispoof = antispoof or AntispoofTables()
        self.B = batch_size
        self.L = pkt_slot
        self.slow_path = slow_path
        self.violation_sink = violation_sink
        self.clock = clock
        self.stats = EngineStats()
        self.geom = PipelineGeom(dhcp=fastpath.geom, nat=nat.geom, qos=self.qos.geom,
                                 spoof=self.antispoof.geom)
        self.tables: PipelineTables = self._device_tables()

    # -- device state --
    def _dense_host(self) -> dict[str, np.ndarray]:
        """The small dense config arrays the device copies wholesale."""
        return {"pools": self.fastpath.pools, "server": self.fastpath.server,
                "hairpin": self.nat.hairpin, "alg": self.nat.alg,
                "nat_config": self.nat.config_array(),
                "spoof_ranges": self.antispoof.ranges, "spoof_config": self.antispoof.config}

    def _device_tables(self) -> PipelineTables:
        self._dense_sent = {k: v.copy() for k, v in self._dense_host().items()}
        dev = self.device
        return PipelineTables(
            dhcp=self.fastpath.device_tables(dev),
            nat=self.nat.device_tables(dev),
            qos_up=self.qos.up.device_state(dev),
            qos_down=self.qos.down.device_state(dev),
            spoof=self.antispoof.bindings.device_state(dev),
            spoof_ranges=words_to_device(self.antispoof.ranges, dev),
            spoof_config=words_to_device(self.antispoof.config, dev),
        )

    def resync_tables(self) -> None:
        """Full device re-upload after a bulk host-table build (device-written
        QoS tokens and NAT counters reset to the host view)."""
        self.tables = self._device_tables()

    def _host_mirrors(self):
        return (self.fastpath.sub, self.fastpath.vlan, self.fastpath.cid,
                self.nat.sessions, self.nat.reverse, self.nat.sub_nat,
                self.qos.up, self.qos.down, self.antispoof.bindings)

    def pending_dirty(self) -> int:
        return sum(t.dirty_count() for t in self._host_mirrors())

    def _dense_changed(self) -> bool:
        return any(not np.array_equal(v, self._dense_sent[k])
                   for k, v in self._dense_host().items())

    def _drain_updates(self):
        """One bounded update batch, or None when there is nothing to ship
        (no dirty slot and no changed config array)."""
        if self.pending_dirty() == 0 and not self._dense_changed():
            return None
        if any(t._dirty_all for t in self._host_mirrors()):
            # a bulk build abandoned delta tracking: answer with one full upload
            self.resync_tables()
            return None
        dev = self.device
        self._dense_sent = {k: v.copy() for k, v in self._dense_host().items()}
        return (
            self.fastpath.make_updates(dev),
            self.nat.make_updates(dev),
            self.qos.up.make_update(self.qos.update_slots, dev),
            self.qos.down.make_update(self.qos.update_slots, dev),
            self.antispoof.bindings.make_update(self.antispoof.update_slots, dev),
            words_to_device(self.antispoof.ranges, dev),
            words_to_device(self.antispoof.config, dev),
        )

    def _apply_updates(self, upd) -> None:
        fp_upd, nat_upd, qup, qdown, sp_upd, sp_ranges, sp_config = upd
        t = self.tables
        apply_fastpath_updates(t.dhcp, fp_upd)
        apply_nat_updates(t.nat, nat_upd)
        apply_qupdate(t.qos_up, qup)
        apply_qupdate(t.qos_down, qdown)
        apply_update(t.spoof, sp_upd)
        t.spoof_ranges.copy_(sp_ranges)
        t.spoof_config.copy_(sp_config)

    # -- the serving path --
    def _pack_frames(self, frames: list[bytes], B: int):
        """Stage a frame list into [B, L] uint8 + [B] lengths (numpy)."""
        if len(frames) > B:
            raise ValueError(f"batch of {len(frames)} exceeds batch size {B}")
        pkt = np.zeros((B, self.L), dtype=np.uint8)
        length = np.zeros((B,), dtype=np.int64)
        if not frames:
            return pkt, length
        lens = np.fromiter((len(f) for f in frames), dtype=np.int64, count=len(frames))
        if int(lens.max()) > self.L:
            # never truncate: a clipped frame would be NAT-accounted and TX'd corrupt
            raise ValueError(f"frame of {int(lens.max())} bytes exceeds engine pkt_slot {self.L}")
        flat = np.frombuffer(b"".join(frames), dtype=np.uint8)
        rows = np.repeat(np.arange(len(frames)), lens)
        starts = np.cumsum(lens) - lens
        cols = np.arange(len(flat)) - np.repeat(starts, lens)
        pkt[rows, cols] = flat
        length[: len(frames)] = lens
        return pkt, length

    def _fold_stats(self, res: PipelineResult) -> None:
        self.stats.dhcp += res.dhcp_stats.cpu().numpy().astype(np.uint64)
        self.stats.nat += res.nat_stats.cpu().numpy().astype(np.uint64)
        self.stats.qos += res.qos_stats.cpu().numpy().astype(np.uint64)
        self.stats.spoof += res.spoof_stats.cpu().numpy().astype(np.uint64)

    def step(self, pkt: np.ndarray, length: np.ndarray, fa: np.ndarray,
             now: float) -> PipelineResult:
        """Drain + apply updates, run one device step, fold the stats."""
        upd = self._drain_updates()
        if upd is not None:
            self._apply_updates(upd)
        dev = self.device
        # fills, not host copies: the step itself makes no host round trip
        now_s = torch.full((), int(now) & 0xFFFFFFFF, dtype=torch.int64, device=dev)
        now_us = torch.full((), int(now * 1e6) & 0xFFFFFFFF, dtype=torch.int64, device=dev)
        res = pipeline_step(self.tables, torch.from_numpy(pkt).to(dev),
                            torch.from_numpy(length).to(dev), torch.from_numpy(fa).to(dev),
                            self.geom, now_s, now_us)
        self.stats.batches += 1
        self._fold_stats(res)
        return res

    def process(self, frames: list[bytes], from_access: list[bool] | bool = True,
                now: float | None = None) -> dict:
        """Run one batch through the device pipeline and apply verdicts.

        Returns {"tx": [(lane, frame)], "fwd": [...], "dropped": [lanes],
        "slow": [(lane, reply_frame|None)]}.
        """
        now = now if now is not None else self.clock()
        pkt, length = self._pack_frames(frames, self.B)
        if isinstance(from_access, bool):
            fa = np.full((self.B,), from_access, dtype=bool)
        else:
            fa = np.zeros((self.B,), dtype=bool)
            fa[: len(from_access)] = from_access

        res = self.step(pkt, length, fa, now)
        n = len(frames)
        verdict = res.verdict[:n].cpu().numpy()
        out_len = res.out_len[:n].cpu().numpy()
        punt = res.nat_punt[:n].cpu().numpy()
        viol = res.spoof_violation[:n].cpu().numpy()
        send = (verdict == VERDICT_TX) | (verdict == VERDICT_FWD)
        out_rows = res.out_pkt[:n].cpu().numpy() if send.any() else None

        out = {"tx": [], "fwd": [], "dropped": [], "slow": []}
        slow_items = []
        for i, v in enumerate(verdict):
            if v == VERDICT_TX:
                out["tx"].append((i, bytes(out_rows[i, : int(out_len[i])])))
                self.stats.tx += 1
            elif v == VERDICT_FWD:
                out["fwd"].append((i, bytes(out_rows[i, : int(out_len[i])])))
                self.stats.fwd += 1
            elif v == VERDICT_DROP:
                out["dropped"].append(i)
                self.stats.dropped += 1
            else:
                self.stats.passed += 1
                if punt[i]:
                    try:
                        self._punt_new_flow(frames[i], int(now))
                    except Exception:  # noqa: BLE001 — untrusted frame: count, log, go on
                        self.stats.slow_errors += 1
                        log.exception("new-flow punt failed (lane %d)", i)
                    out["slow"].append((i, None))
                else:
                    slow_items.append((i, frames[i]))
            if viol[i] and self.violation_sink is not None:
                self.violation_sink(i, frames[i])
        for i, frame in slow_items:
            reply = None
            if self.slow_path is not None:
                try:
                    reply = self.slow_path(frame)
                except Exception:  # noqa: BLE001 — slow path is untrusted input
                    self.stats.slow_errors += 1
                    log.exception("slow path failed (lane %d)", i)
            out["slow"].append((i, reply))
        out["slow"].sort(key=lambda t: t[0])
        return out

    def _punt_new_flow(self, frame: bytes, now: int) -> None:
        """Device egress-miss: create the session host-side."""
        try:
            d = F.decode(frame)
        except Exception:  # noqa: BLE001 — a truncated frame is simply not a flow
            return
        if d.ethertype != 0x0800:
            return
        src_port = d.icmp_id if d.proto == 1 else d.src_port
        dst_port = 0 if d.proto == 1 else d.dst_port
        self.nat.handle_new_flow(d.src_ip, d.dst_ip, src_port, dst_port, d.proto,
                                 len(frame), now)
