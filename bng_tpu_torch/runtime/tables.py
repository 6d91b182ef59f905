"""Host-side fast-path table management (port of
`bng_tpu/runtime/tables.py`: the DHCP tables and the PPPoE session
tables, with their checkpoint state).

Numpy mirrors of the subscriber / VLAN / circuit-ID cuckoo tables plus
the dense pool and server-config arrays; the device copies are uploaded
with `device_tables(device)` and kept current by bounded update batches
that `apply_fastpath_updates` scatters in place. `PPPoEFastPathTables`
holds the two PPPoE session tables (by session id, by subscriber IP)
and the access concentrator's MAC. `checkpoint_state` / `restore_state`
are the components `runtime/checkpoint.py` snapshots.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bng_tpu_torch.ops.dhcp import (
    ASSIGN_WORDS, AV_CLASS, AV_FLAGS, AV_IP, AV_LEASE_EXP, AV_POOL_ID, AV_VLAN,
    CID_KEY_LEN, POOL_WORDS, PV_DNS1, PV_DNS2, PV_GATEWAY, PV_LEASE_T, PV_NETWORK,
    PV_PREFIX, PV_VALID, SC_IP, SC_MAC_HI, SC_MAC_LO, SERVER_WORDS, DHCPGeom, DHCPTables,
)
from bng_tpu_torch.ops.pppoe import PPPOE_WORDS, PS_IP, PS_MAC_HI, PS_MAC_LO, PS_SESSION_ID
from bng_tpu_torch.ops.table import (
    HostTable, TableGeom, TableState, TableUpdate, apply_update, words_to_device,
)
from bng_tpu_torch.utils.net import mac_to_u64, split_u64


def pack_cid_host(circuit_id: bytes) -> np.ndarray:
    """32-byte (padded/truncated) circuit-id -> 8 big-endian uint32 words."""
    buf = (circuit_id[:CID_KEY_LEN] + b"\x00" * CID_KEY_LEN)[:CID_KEY_LEN]
    return np.frombuffer(buf, dtype=">u4").astype(np.uint32)


class FastPathUpdates(NamedTuple):
    sub: TableUpdate
    vlan: TableUpdate
    cid: TableUpdate
    pools: torch.Tensor  # [P, POOL_WORDS] full (tiny) refresh
    server: torch.Tensor  # [SERVER_WORDS]


def apply_fastpath_updates(tables: DHCPTables, upd: FastPathUpdates) -> DHCPTables:
    """Apply one update batch in place; the dense arrays are copied over."""
    apply_update(tables.sub, upd.sub)
    apply_update(tables.vlan, upd.vlan)
    apply_update(tables.cid, upd.cid)
    tables.pools.copy_(upd.pools)
    tables.server.copy_(upd.server)
    return tables


def clone_dhcp(t: DHCPTables) -> DHCPTables:
    """A copy of the DHCP tables on their device (the bulk lane's replica,
    the devloop's leading copy)."""
    def st(x: TableState) -> TableState:
        return TableState(*(a.clone() for a in x))
    return DHCPTables(sub=st(t.sub), vlan=st(t.vlan), cid=st(t.cid),
                      pools=t.pools.clone(), server=t.server.clone())


def copy_dhcp_(dst: DHCPTables, src: DHCPTables) -> DHCPTables:
    """dst <- src in place, tensor by tensor (dst keeps its storage)."""
    for a, b in zip((*dst.sub, *dst.vlan, *dst.cid, dst.pools, dst.server),
                    (*src.sub, *src.vlan, *src.cid, src.pools, src.server)):
        a.copy_(b)
    return dst


class FastPathTables:
    """Host authority for subscriber/VLAN/circuit-ID/pool/server tables."""

    def __init__(self, sub_nbuckets: int = 1 << 15, vlan_nbuckets: int = 1 << 12,
                 cid_nbuckets: int = 1 << 12, max_pools: int = 256, stash: int = 64,
                 update_slots: int = 256):
        self.sub = HostTable(sub_nbuckets, key_words=2, val_words=ASSIGN_WORDS, stash=stash,
                             name="subscriber_pools")
        self.vlan = HostTable(vlan_nbuckets, key_words=1, val_words=ASSIGN_WORDS, stash=stash,
                              name="vlan_subscriber_pools")
        self.cid = HostTable(cid_nbuckets, key_words=8, val_words=ASSIGN_WORDS, stash=stash,
                             name="circuit_id_subscribers")
        self.pools = np.zeros((max_pools, POOL_WORDS), dtype=np.uint32)
        self.server = np.zeros((SERVER_WORDS,), dtype=np.uint32)
        self.update_slots = update_slots
        self.geom = DHCPGeom(
            sub=TableGeom(sub_nbuckets, stash),
            vlan=TableGeom(vlan_nbuckets, stash),
            cid=TableGeom(cid_nbuckets, stash),
        )

    @staticmethod
    def _assignment(pool_id, ip, lease_expiry, vlan_id, client_class, flags):
        v = np.zeros((ASSIGN_WORDS,), dtype=np.uint32)
        v[AV_POOL_ID] = pool_id
        v[AV_IP] = ip
        v[AV_VLAN] = vlan_id
        v[AV_CLASS] = client_class
        v[AV_LEASE_EXP] = lease_expiry
        v[AV_FLAGS] = flags
        return v

    @staticmethod
    def _mac_key(mac) -> list[int]:
        key = mac_to_u64(mac) if not isinstance(mac, int) else mac
        lo, hi = split_u64(key)
        return [hi, lo]

    def add_subscriber(self, mac, pool_id: int, ip: int, lease_expiry: int,
                       vlan_id: int = 0, client_class: int = 0, flags: int = 0) -> None:
        self.sub.insert(self._mac_key(mac),
                        self._assignment(pool_id, ip, lease_expiry, vlan_id, client_class, flags))

    def add_subscribers_bulk(self, macs_u64, pool_ids, ips, lease_expiries,
                             vlan_ids=0, client_classes=0, flags=0) -> None:
        """Vectorized batch insert for 1M-scale builds (MACs unique and new).
        Follow with device_tables() for a full upload."""
        macs_u64 = np.asarray(macs_u64, dtype=np.uint64)
        n = len(macs_u64)
        keys = np.zeros((n, 2), dtype=np.uint32)
        keys[:, 0] = (macs_u64 >> np.uint64(32)).astype(np.uint32)
        keys[:, 1] = (macs_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        vals = np.zeros((n, ASSIGN_WORDS), dtype=np.uint32)
        vals[:, AV_POOL_ID] = pool_ids
        vals[:, AV_IP] = ips
        vals[:, AV_VLAN] = vlan_ids
        vals[:, AV_CLASS] = client_classes
        vals[:, AV_LEASE_EXP] = lease_expiries
        vals[:, AV_FLAGS] = flags
        self.sub.bulk_insert(keys, vals)

    def remove_subscriber(self, mac) -> bool:
        return self.sub.delete(self._mac_key(mac))

    def get_subscriber(self, mac):
        return self.sub.lookup(self._mac_key(mac))

    def add_vlan_subscriber(self, s_tag: int, c_tag: int, pool_id: int, ip: int,
                            lease_expiry: int, client_class: int = 0, flags: int = 0) -> None:
        self.vlan.insert([(s_tag << 16) | c_tag],
                         self._assignment(pool_id, ip, lease_expiry, 0, client_class, flags))

    def remove_vlan_subscriber(self, s_tag: int, c_tag: int) -> bool:
        return self.vlan.delete([(s_tag << 16) | c_tag])

    def add_circuit_id_subscriber(self, circuit_id: bytes, pool_id: int, ip: int,
                                  lease_expiry: int, client_class: int = 0, flags: int = 0) -> None:
        self.cid.insert(pack_cid_host(circuit_id),
                        self._assignment(pool_id, ip, lease_expiry, 0, client_class, flags))

    def remove_circuit_id_subscriber(self, circuit_id: bytes) -> bool:
        return self.cid.delete(pack_cid_host(circuit_id))

    def add_pool(self, pool_id: int, network: int, prefix_len: int, gateway: int,
                 dns_primary: int = 0, dns_secondary: int = 0, lease_time: int = 3600) -> None:
        if pool_id >= len(self.pools):
            raise ValueError(f"pool_id {pool_id} >= max_pools {len(self.pools)}")
        row = self.pools[pool_id]
        row[PV_NETWORK] = network
        row[PV_PREFIX] = prefix_len
        row[PV_GATEWAY] = gateway
        row[PV_DNS1] = dns_primary
        row[PV_DNS2] = dns_secondary
        row[PV_LEASE_T] = lease_time
        row[PV_VALID] = 1

    def remove_pool(self, pool_id: int) -> None:
        self.pools[pool_id] = 0

    def set_server_config(self, mac, ip: int) -> None:
        hi, lo = self._mac_key(mac)
        self.server[SC_MAC_HI] = hi
        self.server[SC_MAC_LO] = lo
        self.server[SC_IP] = ip

    def touch_lease(self, mac, lease_expiry: int) -> bool:
        return self.sub.update_val_words(self._mac_key(mac), AV_LEASE_EXP, [lease_expiry])

    # -- device sync --
    def device_tables(self, device) -> DHCPTables:
        """Full upload (startup)."""
        return DHCPTables(
            sub=self.sub.device_state(device),
            vlan=self.vlan.device_state(device),
            cid=self.cid.device_state(device),
            pools=words_to_device(self.pools, device),
            server=words_to_device(self.server, device),
        )

    def make_updates(self, device) -> FastPathUpdates:
        """Drain dirty slots into one bounded update batch."""
        return FastPathUpdates(
            sub=self.sub.make_update(self.update_slots, device),
            vlan=self.vlan.make_update(self.update_slots, device),
            cid=self.cid.make_update(self.update_slots, device),
            pools=words_to_device(self.pools, device),
            server=words_to_device(self.server, device),
        )

    def empty_updates(self, device) -> FastPathUpdates:
        """A no-op delta batch that does not consume dirty tracking: the
        scheduler's bulk lane ships it, because the express lane alone
        drains the fastpath deltas. pools/server are re-read every call (the
        step copies them wholesale), so the bulk replica follows live pool
        and server config between refreshes."""
        return FastPathUpdates(
            sub=self.sub.empty_update(self.update_slots, device),
            vlan=self.vlan.empty_update(self.update_slots, device),
            cid=self.cid.empty_update(self.update_slots, device),
            pools=words_to_device(self.pools, device),
            server=words_to_device(self.server, device),
        )

    def dirty_count(self) -> int:
        return self.sub.dirty_count() + self.vlan.dirty_count() + self.cid.dirty_count()

    # -- checkpoint (runtime/checkpoint.py) --
    _CKPT_TABLES = ("sub", "vlan", "cid")

    def checkpoint_state(self) -> tuple[dict, dict]:
        """(meta, arrays): the three cuckoo mirrors slot-exact and the dense
        pool/server config, arrays named '<table>.<array>'."""
        meta = {"geom": {t: getattr(self, t).checkpoint_geom() for t in self._CKPT_TABLES},
                "max_pools": len(self.pools)}
        arrays = {f"{t}.{k}": v
                  for t in self._CKPT_TABLES
                  for k, v in getattr(self, t).checkpoint_arrays().items()}
        arrays["pools"] = self.pools
        arrays["server"] = self.server
        return meta, arrays

    def restore_state(self, meta: dict, arrays: dict) -> dict[str, int]:
        """Hydrate from a checkpoint (ValueError on a geometry mismatch); a
        full device upload must follow."""
        rows = {}
        for t in self._CKPT_TABLES:
            rows[t] = getattr(self, t).restore_arrays(
                {k: arrays[f"{t}.{k}"] for k in ("keys", "vals", "used")}, meta["geom"][t])
        if arrays["pools"].shape != self.pools.shape:
            raise ValueError(
                f"checkpoint pools shape {arrays['pools'].shape} != {self.pools.shape}")
        self.pools[:] = arrays["pools"]
        self.server[:] = arrays["server"]
        rows["pools"] = int(np.count_nonzero(self.pools[:, PV_VALID]))
        return rows


class PPPoEFastPathTables:
    """Host side of the device PPPoE session tables (`ops/pppoe.py`).

    The PPPoE control plane negotiates sessions on the host; an OPEN
    session is published here (`session_up`, the server's on_open hook)
    so its session-stage DATA frames decap and encap on the device, and
    withdrawn by `session_down` (on_close, given a teardown event or the
    session)."""

    def __init__(self, nbuckets: int = 1 << 12, stash: int = 64, update_slots: int = 128,
                 server_mac: bytes = b"\x02\xbb\x00\x00\x00\x01"):
        # 8-word session rows are a zero-pad of the older 6-word layout
        # (PS_* unchanged): such checkpoints restore padded
        self.by_sid = HostTable(nbuckets, key_words=1, val_words=PPPOE_WORDS, stash=stash,
                                name="pppoe_by_sid", compat_val_pad_from=(6,))
        self.by_ip = HostTable(nbuckets, key_words=1, val_words=PPPOE_WORDS, stash=stash,
                               name="pppoe_by_ip", compat_val_pad_from=(6,))
        self.geom = TableGeom(nbuckets, stash)
        self.update_slots = update_slots
        # AC MAC as (hi16, lo32) words: the L2 source of every encapped frame
        self.server_mac = np.array([int.from_bytes(server_mac[:2], "big"),
                                    int.from_bytes(server_mac[2:], "big")], dtype=np.uint32)

    def session_up(self, sess) -> None:
        """Publish an OPEN session (any object with session_id, client_mac
        and assigned_ip)."""
        row = np.zeros((PPPOE_WORDS,), dtype=np.uint32)
        row[PS_SESSION_ID] = sess.session_id
        row[PS_MAC_HI] = int.from_bytes(sess.client_mac[:2], "big")
        row[PS_MAC_LO] = int.from_bytes(sess.client_mac[2:], "big")
        row[PS_IP] = sess.assigned_ip or 0
        self.by_sid.insert([sess.session_id], row)
        if sess.assigned_ip:
            self.by_ip.insert([sess.assigned_ip], row)

    def session_down(self, event) -> None:
        sess = getattr(event, "session", event)
        self.by_sid.delete([sess.session_id])
        if sess.assigned_ip:
            self.by_ip.delete([sess.assigned_ip])

    def bulk_sessions_up(self, session_ids, client_macs_u64, ips) -> None:
        """Vectorized install of many new sessions (ids, MACs and IPs unique,
        IPs non-zero). Follow with a full upload (the engine resyncs)."""
        sids = np.asarray(session_ids, dtype=np.uint32)
        macs = np.asarray(client_macs_u64, dtype=np.uint64)
        rows = np.zeros((len(sids), PPPOE_WORDS), dtype=np.uint32)
        rows[:, PS_SESSION_ID] = sids
        rows[:, PS_MAC_HI] = (macs >> np.uint64(32)).astype(np.uint32)
        rows[:, PS_MAC_LO] = (macs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        rows[:, PS_IP] = np.asarray(ips, dtype=np.uint32)
        self.by_sid.bulk_insert(sids[:, None], rows)
        self.by_ip.bulk_insert(rows[:, PS_IP: PS_IP + 1], rows)

    def make_updates(self, device):
        """(by_sid delta, by_ip delta): the PPPoE tail of the engine's update batch."""
        return (self.by_sid.make_update(self.update_slots, device),
                self.by_ip.make_update(self.update_slots, device))

    def empty_updates(self, device):
        """No-op PPPoE deltas (dirty tracking untouched)."""
        return (self.by_sid.empty_update(self.update_slots, device),
                self.by_ip.empty_update(self.update_slots, device))

    # -- checkpoint (runtime/checkpoint.py) --
    def checkpoint_state(self) -> tuple[dict, dict]:
        meta = {"geom": {"by_sid": self.by_sid.checkpoint_geom(),
                         "by_ip": self.by_ip.checkpoint_geom()}}
        arrays = {f"{t}.{k}": v
                  for t in ("by_sid", "by_ip")
                  for k, v in getattr(self, t).checkpoint_arrays().items()}
        arrays["server_mac"] = self.server_mac
        return meta, arrays

    def restore_state(self, meta: dict, arrays: dict) -> dict[str, int]:
        rows = {}
        for t in ("by_sid", "by_ip"):
            rows[t] = getattr(self, t).restore_arrays(
                {k: arrays[f"{t}.{k}"] for k in ("keys", "vals", "used")}, meta["geom"][t])
        self.server_mac[:] = arrays["server_mac"]
        return rows
