"""Versioned snapshots of every host authority: warm restart (port of
`bng_tpu/runtime/checkpoint.py`, byte-compatible with it).

- **snapshot** (`build_checkpoint`): at the drain barrier
  (`TieredScheduler.quiesce()` / `Engine.quiesce()`: nothing in flight,
  the stream synchronised) the device-written words are folded back into
  the host mirrors (`Engine.fold_device_authoritative`: NAT session
  counters and last_seen, QoS token buckets, copied as bits), and every
  host authority is collected slot-exact: the DHCP fast-path tables, the
  NAT tables and allocator bookkeeping, QoS rows, antispoof bindings,
  garden membership, PPPoE and edge tables, the DHCP lease book and the
  HA session store.

- **format** (`encode_checkpoint` / `decode_checkpoint`): magic
  `b"BNGCKPT1"`, a u32 header length and header CRC32, a JSON header
  (schema version, meta, array manifest, payload length and CRC32) and the
  raw array payload. Arrays are stored as uint32 (the host mirrors' dtype,
  never the device's int32 view), so the same host state with the same
  seq, time and node id encodes to the same bytes in both packages, and a
  snapshot of either restores into the other. A load rejects any mismatch
  (magic, schema, truncation, checksum) with a `CheckpointError`.

- **restore** (`restore_checkpoint`): every component is verified before
  any host mirror changes, the mirrors hydrate, then one full device
  upload (`Engine.resync_tables()`), with no slow-path exchange.

The sharded half (`build_sharded_checkpoint`, `restore_sharded_checkpoint`)
snapshots every shard of a `ShardedCluster` into one file and restores it
slot-exact at the same shard count or re-shards N -> M. The slow-path
fleet's per-worker lease books ride as the `fleet` component, one format
with the parent's book, so either restores into the other. The HA pair's
session store rides as the `ha` component: a restarted active resumes
its sequence, a standby bootstraps and catches up by `replay_since`. A
cluster-of-BNGs coordinator's carve plan rides as the `cluster_plan`
component (`build_checkpoint(cluster_plan=coord)`,
`restore_checkpoint(cluster_coord=coord)`). File lifecycle lives in
`control/statestore.py`.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import NamedTuple

import numpy as np

from bng_tpu_torch.chaos.faults import fault_point

MAGIC = b"BNGCKPT1"
SCHEMA_VERSION = 1
# layout: MAGIC + u32 header_len + u32 header_crc32 + header JSON + payload
_HDR_LEN = struct.Struct("<II")
# hard bound on the header blob, enforced symmetrically at encode AND
# decode: the header only carries schema/seq/geometry dicts (the big
# per-row state — arrays, lease book, NAT bookkeeping, HA sessions —
# lives in the CRC-covered payload), so a header anywhere near this is a
# bug, and a corrupt length prefix must not make the decoder json-parse
# gigabytes
_MAX_HEADER = 1 << 26

# marker for dict components too large for the header: the JSON blob is
# stored as a uint8 array named '<component>/__json__' in the payload
# (CRC32-covered, unlike the header) and the header keeps only this stub;
# the order is the payload's, so it is the reference's
_JSON_MARKER = "__payload_json__"
_PAYLOAD_JSON_COMPONENTS = ("nat", "dhcp", "ha", "fleet")


class CheckpointError(RuntimeError):
    """A checkpoint that must not be restored (corrupt, truncated, or
    schema/geometry mismatched). Callers catch this to fall back to a
    cold start."""


class Checkpoint(NamedTuple):
    """Decoded checkpoint: JSON-safe meta + named numpy arrays."""

    meta: dict
    arrays: dict[str, np.ndarray]

    @property
    def seq(self) -> int:
        return int(self.meta.get("seq", 0))


# ---------------------------------------------------------------------------
# binary format
# ---------------------------------------------------------------------------

def encode_checkpoint(ckpt: Checkpoint) -> bytes:
    """Checkpoint -> file bytes (magic + JSON header + array payload)."""
    names = sorted(ckpt.arrays)
    manifest = []
    chunks = []
    offset = 0
    for name in names:
        arr = np.ascontiguousarray(ckpt.arrays[name])
        raw = arr.tobytes()
        manifest.append({"name": name, "dtype": arr.dtype.str,
                         "shape": list(arr.shape), "offset": offset,
                         "nbytes": len(raw)})
        chunks.append(raw)
        offset += len(raw)
    payload = b"".join(chunks)
    header = json.dumps({
        "schema_version": SCHEMA_VERSION,
        "meta": ckpt.meta,
        "arrays": manifest,
        "payload_len": len(payload),
        "payload_crc32": zlib.crc32(payload) & 0xFFFFFFFF,
    }, separators=(",", ":")).encode()
    if len(header) > _MAX_HEADER:
        # symmetric with decode_header's bound: a save that could never
        # be restored must fail HERE, not at the restore that needed it
        raise CheckpointError(
            f"checkpoint header is {len(header)} bytes (> {_MAX_HEADER}): "
            "oversized meta belongs in the payload")
    return (MAGIC
            + _HDR_LEN.pack(len(header), zlib.crc32(header) & 0xFFFFFFFF)
            + header + payload)


def decode_header(data: bytes) -> tuple[dict, int]:
    """Parse + validate the header only -> (header dict, payload offset).
    Raises CheckpointError on structural problems; does NOT touch the
    payload (the cheap path for `checkpoint info` listings)."""
    if len(data) < len(MAGIC) + _HDR_LEN.size:
        raise CheckpointError("not a checkpoint: file shorter than header")
    if data[: len(MAGIC)] != MAGIC:
        raise CheckpointError(
            f"not a checkpoint: bad magic {data[:len(MAGIC)]!r}")
    hlen, want_crc = _HDR_LEN.unpack_from(data, len(MAGIC))
    if hlen > _MAX_HEADER or len(MAGIC) + _HDR_LEN.size + hlen > len(data):
        raise CheckpointError("corrupt checkpoint: truncated header")
    start = len(MAGIC) + _HDR_LEN.size
    raw = data[start : start + hlen]
    crc = zlib.crc32(raw) & 0xFFFFFFFF
    if crc != want_crc:
        raise CheckpointError(
            f"corrupt checkpoint: header crc32 {crc:#010x} != "
            f"{want_crc:#010x}")
    try:
        header = json.loads(raw)
    except ValueError as e:
        raise CheckpointError(f"corrupt checkpoint header: {e}") from e
    got = header.get("schema_version")
    if got != SCHEMA_VERSION:
        raise CheckpointError(
            f"checkpoint schema version {got} != supported "
            f"{SCHEMA_VERSION}: refusing to restore")
    return header, start + hlen


def verify_checkpoint_bytes(data: bytes) -> tuple[dict, int]:
    """Full structural validation (header + payload length + CRC32)
    without materializing any array -> (header, payload offset). The
    shared gate for decode_checkpoint and store listings. Checksumming
    goes through a memoryview — a multi-hundred-MB payload is never
    copied just to validate it."""
    header, payload_off = decode_header(data)
    payload = memoryview(data)[payload_off:]
    want_len = int(header.get("payload_len", -1))
    if len(payload) != want_len:
        raise CheckpointError(
            f"corrupt checkpoint: payload is {len(payload)} bytes, "
            f"header promises {want_len} (truncated write?)")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    if crc != int(header.get("payload_crc32", -1)):
        raise CheckpointError(
            f"corrupt checkpoint: payload crc32 {crc:#010x} != header "
            f"{int(header.get('payload_crc32', -1)):#010x}")
    return header, payload_off


def roundtrip_checkpoint(ckpt: Checkpoint) -> Checkpoint:
    """In-memory encode -> verify -> decode: the blue/green standby
    hydration source (runtime/ops.py). Exercises the exact rejection
    surface the disk path has (magic/CRC/manifest/truncation) with no
    file round-trip, so a snapshot that could never restore fails the
    swap BEFORE a standby is built from it. The `ops.snapshot` chaos
    point injects encode-side I/O errors (the disk-full / OOM class) —
    surfaced as OSError, which the swap orchestrator turns into a clean
    abort with the active engine untouched."""
    data = encode_checkpoint(ckpt)
    fp = fault_point("ops.snapshot")
    if fp is not None and fp.kind == "io_error":
        raise OSError("chaos: injected I/O error at ops.snapshot")
    return decode_checkpoint(data)


def decode_checkpoint(data: bytes) -> Checkpoint:
    """File bytes -> Checkpoint, rejecting truncation and corruption.
    Peak memory = the input buffer + one owned copy per array (the
    copies detach the result from `data` so the caller can drop it)."""
    header, payload_off = verify_checkpoint_bytes(data)
    payload = memoryview(data)[payload_off:]
    arrays = {}
    try:
        for ent in header["arrays"]:
            off, nbytes = int(ent["offset"]), int(ent["nbytes"])
            buf = payload[off : off + nbytes]
            arr = np.frombuffer(buf, dtype=np.dtype(ent["dtype"])).copy()
            arrays[ent["name"]] = arr.reshape(ent["shape"])
    except (KeyError, TypeError, ValueError) as e:
        # a CRC-valid payload with an inconsistent manifest is still a
        # corrupt checkpoint, not an internal error
        raise CheckpointError(f"corrupt checkpoint manifest: {e}") from e
    return Checkpoint(meta=header["meta"], arrays=arrays)


# ---------------------------------------------------------------------------
# snapshot / restore
# ---------------------------------------------------------------------------

def _ns(prefix: str, arrays: dict) -> dict:
    return {f"{prefix}/{k}": v for k, v in arrays.items()}


def _denamespace(prefix: str, arrays: dict) -> dict:
    plen = len(prefix) + 1
    return {k[plen:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def build_checkpoint(seq: int, now: float, *, engine=None, scheduler=None,
                     fastpath=None, nat=None, qos=None, antispoof=None,
                     garden=None, pppoe=None, edge=None, dhcp=None, ha=None,
                     fleet=None, cluster_plan=None,
                     node_id: str = "") -> Checkpoint:
    """Collect a consistent snapshot of the authoritative state.

    With an `engine`, the table managers default from it, and the
    snapshot runs the full consistency protocol first: quiesce the
    scheduler (or the engine's pipelined loop) so nothing is in flight,
    then fold the device-authoritative words into the host mirrors.
    Without an engine (control-plane-only callers, tests) the host
    mirrors are taken as-is.
    """
    if engine is not None:
        fastpath = fastpath if fastpath is not None else engine.fastpath
        nat = nat if nat is not None else engine.nat
        qos = qos if qos is not None else engine.qos
        antispoof = antispoof if antispoof is not None else engine.antispoof
        garden = garden if garden is not None else engine.garden
        pppoe = pppoe if pppoe is not None else engine.pppoe
        edge = edge if edge is not None else getattr(engine, "edge", None)
        if scheduler is not None:
            scheduler.quiesce()
        else:
            engine.quiesce()
        engine.fold_device_authoritative()

    meta: dict = {"seq": int(seq), "created_at": float(now),
                  "node_id": node_id, "components": {}}
    arrays: dict[str, np.ndarray] = {}

    if fastpath is not None:
        m, a = fastpath.checkpoint_state()
        meta["components"]["fastpath"] = m
        arrays.update(_ns("fastpath", a))
    if nat is not None:
        m, a = nat.checkpoint_state()
        meta["components"]["nat"] = m
        arrays.update(_ns("nat", a))
    if qos is not None:
        meta["components"]["qos"] = {
            "geom": {"up": qos.up.checkpoint_geom(),
                     "down": qos.down.checkpoint_geom()}}
        arrays.update(_ns("qos", {"up.rows": qos.up.rows,
                                  "down.rows": qos.down.rows}))
    if antispoof is not None:
        meta["components"]["antispoof"] = {
            "geom": antispoof.bindings.checkpoint_geom()}
        arrays.update(_ns("antispoof", {
            **{f"bindings.{k}": v
               for k, v in antispoof.bindings.checkpoint_arrays().items()},
            "ranges": antispoof.ranges, "config": antispoof.config}))
    if garden is not None:
        meta["components"]["garden"] = {
            "geom": garden.subscribers.checkpoint_geom()}
        arrays.update(_ns("garden", {
            **{f"subscribers.{k}": v
               for k, v in garden.subscribers.checkpoint_arrays().items()},
            "allowed": garden.allowed}))
    if pppoe is not None:
        m, a = pppoe.checkpoint_state()
        meta["components"]["pppoe"] = m
        arrays.update(_ns("pppoe", a))
    if edge is not None:
        m, a = edge.checkpoint_state()
        meta["components"]["edge"] = m
        arrays.update(_ns("edge", a))
    if dhcp is not None:
        meta["components"]["dhcp"] = dhcp.export_leases()
    if ha is not None:
        meta["components"]["ha"] = ha.checkpoint_state()
    if fleet is not None:
        # per-worker lease books of the slow-path fleet (control/fleet.py);
        # sharding is recomputed at restore so a changed worker count
        # still lands every lease on its new owner
        meta["components"]["fleet"] = fleet.export_state()
    if cluster_plan is not None:
        # carve authority of a cluster-of-BNGs coordinator
        # (bng_tpu/cluster): O(members) and header-safe — lease books
        # ride per-instance checkpoints, not this document
        meta["components"]["cluster_plan"] = cluster_plan.checkpoint_plan()
    # per-row dict state (NAT allocator bookkeeping, lease book, HA
    # sessions) scales with the subscriber count: it rides the payload as a uint8 JSON
    # blob — CRC32-covered, and the header stays small (its size bound
    # is enforced at encode AND decode)
    for name in _PAYLOAD_JSON_COMPONENTS:
        comp = meta["components"].get(name)
        if comp is None:
            continue
        blob = json.dumps(comp, separators=(",", ":")).encode()
        arrays[f"{name}/{_JSON_MARKER}"] = np.frombuffer(
            blob, dtype=np.uint8).copy()
        meta["components"][name] = {_JSON_MARKER: True}
    return Checkpoint(meta=meta, arrays=arrays)


def _resolve_component_meta(ckpt: Checkpoint, comps: dict, name: str):
    """Return a component's meta dict, inflating the payload-JSON stub
    when present (CheckpointError on a missing/corrupt blob)."""
    m = comps.get(name)
    if not (isinstance(m, dict) and m.get(_JSON_MARKER)):
        return m
    blob = ckpt.arrays.get(f"{name}/{_JSON_MARKER}")
    if blob is None:
        raise CheckpointError(
            f"{name}: header stub points at a missing payload meta blob")
    try:
        return json.loads(bytes(np.asarray(blob, dtype=np.uint8)))
    except ValueError as e:
        raise CheckpointError(f"{name}: corrupt payload meta: {e}") from e


def _check_table(table, arrays: dict, geom: dict, label: str) -> None:
    """Geometry + array shape/dtype pre-check for one cuckoo/QoS mirror,
    mutating nothing. Any geometry other than the live one is refused,
    also a value width the table's own restore would pad
    (`compat_val_pad_from`): the gate is the reference's."""
    if geom != table.checkpoint_geom():
        raise CheckpointError(
            f"{label}: checkpoint geometry {geom} != live "
            f"{table.checkpoint_geom()}")
    for k, live in table.checkpoint_arrays().items():
        src = arrays.get(k)
        if src is None:
            raise CheckpointError(f"{label}: checkpoint missing array {k!r}")
        if src.shape != live.shape or src.dtype != live.dtype:
            raise CheckpointError(
                f"{label}: checkpoint array {k!r} is {src.dtype}{src.shape},"
                f" expected {live.dtype}{live.shape}")


def _check_dense(arrays: dict, name: str, live: np.ndarray,
                 label: str) -> None:
    src = arrays.get(name)
    if src is None:
        raise CheckpointError(f"{label}: checkpoint missing array {name!r}")
    if src.shape != live.shape:
        raise CheckpointError(
            f"{label}: checkpoint array {name!r} shape {src.shape} != "
            f"live {live.shape}")


def _verify_components(ckpt: Checkpoint, comps: dict, targets: dict) -> None:
    """All-or-nothing gate: raise CheckpointError on ANY mismatch before
    a single host-mirror write happens."""
    if "fastpath" in comps:
        fp, a = targets["fastpath"], _denamespace("fastpath", ckpt.arrays)
        for t in fp._CKPT_TABLES:
            _check_table(getattr(fp, t),
                         {k: a.get(f"{t}.{k}")
                          for k in ("keys", "vals", "used")},
                         comps["fastpath"]["geom"][t], f"fastpath.{t}")
        _check_dense(a, "pools", fp.pools, "fastpath")
        _check_dense(a, "server", fp.server, "fastpath")
    if "nat" in comps:
        nm, a = targets["nat"], _denamespace("nat", ckpt.arrays)
        for t in nm._CKPT_TABLES:
            _check_table(getattr(nm, t),
                         {k: a.get(f"{t}.{k}")
                          for k in ("keys", "vals", "used")},
                         comps["nat"]["geom"][t], f"nat.{t}")
        _check_dense(a, "hairpin", nm.hairpin, "nat")
        _check_dense(a, "alg", nm.alg, "nat")
    if "qos" in comps:
        q, a = targets["qos"], _denamespace("qos", ckpt.arrays)
        _check_table(q.up, {"rows": a.get("up.rows")},
                     comps["qos"]["geom"]["up"], "qos.up")
        _check_table(q.down, {"rows": a.get("down.rows")},
                     comps["qos"]["geom"]["down"], "qos.down")
    if "antispoof" in comps:
        sp, a = targets["antispoof"], _denamespace("antispoof", ckpt.arrays)
        _check_table(sp.bindings,
                     {k: a.get(f"bindings.{k}")
                      for k in ("keys", "vals", "used")},
                     comps["antispoof"]["geom"], "antispoof.bindings")
        _check_dense(a, "ranges", sp.ranges, "antispoof")
        _check_dense(a, "config", sp.config, "antispoof")
    if "garden" in comps:
        gd, a = targets["garden"], _denamespace("garden", ckpt.arrays)
        _check_table(gd.subscribers,
                     {k: a.get(f"subscribers.{k}")
                      for k in ("keys", "vals", "used")},
                     comps["garden"]["geom"], "garden.subscribers")
        _check_dense(a, "allowed", gd.allowed, "garden")
    if "pppoe" in comps:
        pe, a = targets["pppoe"], _denamespace("pppoe", ckpt.arrays)
        for t in ("by_sid", "by_ip"):
            _check_table(getattr(pe, t),
                         {k: a.get(f"{t}.{k}")
                          for k in ("keys", "vals", "used")},
                         comps["pppoe"]["geom"][t], f"pppoe.{t}")
        _check_dense(a, "server_mac", pe.server_mac, "pppoe")
    if "edge" in comps:
        ed, a = targets["edge"], _denamespace("edge", ckpt.arrays)
        for t in ("tap", "route"):
            _check_table(getattr(ed, t),
                         {k: a.get(f"{t}.{k}")
                          for k in ("keys", "vals", "used")},
                         comps["edge"]["geom"][t], f"edge.{t}")
        _check_dense(a, "tap_filters", ed.tap_filters, "edge")
        _check_dense(a, "tap_config", ed.tap_config, "edge")
    # dry-parse the dict-driven components: their meta is consumed
    # during mutation, so a parse fault there must be caught HERE or the
    # reject would leave the process half-hydrated
    if "nat" in comps:
        try:
            targets["nat"].parse_checkpoint_meta(comps["nat"])
        except (KeyError, ValueError, TypeError) as e:
            raise CheckpointError(
                f"nat: corrupt checkpoint meta: {e!r}") from e
    if "dhcp" in comps:
        from bng_tpu_torch.control.dhcp_server import DHCPServer

        try:
            DHCPServer.parse_lease_state(comps["dhcp"])
        except (KeyError, ValueError, TypeError) as e:
            raise CheckpointError(
                f"dhcp: corrupt checkpoint lease book: {e!r}") from e
    if "ha" in comps:
        try:
            targets["ha"].parse_checkpoint_state(comps["ha"])
        except (KeyError, ValueError, TypeError, AttributeError) as e:
            raise CheckpointError(
                f"ha: corrupt checkpoint session store: {e!r}") from e
    if "fleet" in comps:
        from bng_tpu_torch.control.fleet import SlowPathFleet

        try:
            SlowPathFleet.parse_state(comps["fleet"])
        except (KeyError, ValueError, TypeError) as e:
            raise CheckpointError(
                f"fleet: corrupt checkpoint lease books: {e!r}") from e
    if "cluster_plan" in comps:
        from bng_tpu_torch.cluster import ClusterCoordinator

        try:
            ClusterCoordinator.parse_plan(comps["cluster_plan"])
        except (KeyError, ValueError, TypeError, AttributeError) as e:
            raise CheckpointError(
                f"cluster_plan: corrupt carve plan: {e!r}") from e


def restore_checkpoint(ckpt: Checkpoint, *, engine=None, fastpath=None,
                       nat=None, qos=None, antispoof=None, garden=None,
                       pppoe=None, edge=None, dhcp=None, ha=None,
                       fleet=None, cluster_coord=None) -> dict[str, int]:
    """Hydrate the host mirrors from a decoded checkpoint and re-upload.

    Reject-on-mismatch: every table component present in the checkpoint
    must have a matching live target with identical geometry, or the
    whole restore raises `CheckpointError` and NOTHING is uploaded to
    the device (engine.resync_tables runs only after every component
    hydrated). A live subsystem absent from the checkpoint (enabled
    after the snapshot was taken) simply starts empty. Lease books are one
    format: a fleet's worker books merge into the parent server when the
    live process has no fleet, and a parent book re-shards into the fleet
    when it has one. The HA store restores by the live syncer's role: a
    standby bootstraps, an active resumes. A carve plan replays through
    `cluster_coord`. Returns restored row counts per component.
    """
    if ckpt.meta.get("sharded") is not None:
        raise CheckpointError(
            f"sharded checkpoint "
            f"(n_shards={ckpt.meta['sharded'].get('n_shards')}) cannot "
            f"hydrate a single-engine process: restore with "
            f"restore_sharded_checkpoint")
    if engine is not None:
        fastpath = fastpath if fastpath is not None else engine.fastpath
        nat = nat if nat is not None else engine.nat
        qos = qos if qos is not None else engine.qos
        antispoof = antispoof if antispoof is not None else engine.antispoof
        garden = garden if garden is not None else engine.garden
        pppoe = pppoe if pppoe is not None else engine.pppoe
        edge = edge if edge is not None else getattr(engine, "edge", None)
    comps = dict(ckpt.meta.get("components", {}))
    for name in _PAYLOAD_JSON_COMPONENTS:
        if name in comps:
            comps[name] = _resolve_component_meta(ckpt, comps, name)
    targets = {"fastpath": fastpath, "nat": nat, "qos": qos,
               "antispoof": antispoof, "garden": garden, "pppoe": pppoe,
               "edge": edge, "dhcp": dhcp, "ha": ha, "fleet": fleet,
               "cluster_plan": cluster_coord}
    missing = []
    for name in comps:
        tgt = targets.get(name)
        if tgt is None and name in ("fleet", "dhcp"):
            # a changed --slowpath-workers (including 1 <-> N) must never
            # force a cold start that discards every other component
            tgt = targets.get("dhcp" if name == "fleet" else "fleet")
        if tgt is None:
            missing.append(name)
    if missing:
        raise CheckpointError(
            f"checkpoint carries {sorted(missing)} but the live process "
            f"has no such component(s): refusing a partial restore")
    # verify EVERY component before mutating ANY host mirror: a reject
    # halfway through would leave the process half-hydrated — worse than
    # the cold start the caller falls back to
    _verify_components(ckpt, comps, targets)

    rows: dict[str, int] = {}
    try:
        if "fastpath" in comps:
            got = fastpath.restore_state(comps["fastpath"],
                                         _denamespace("fastpath", ckpt.arrays))
            rows.update({f"fastpath.{k}": v for k, v in got.items()})
        if "nat" in comps:
            got = nat.restore_state(comps["nat"],
                                    _denamespace("nat", ckpt.arrays))
            rows.update({f"nat.{k}": v for k, v in got.items()})
        if "qos" in comps:
            a = _denamespace("qos", ckpt.arrays)
            g = comps["qos"]["geom"]
            rows["qos.up"] = qos.up.restore_arrays({"rows": a["up.rows"]},
                                                   g["up"])
            rows["qos.down"] = qos.down.restore_arrays(
                {"rows": a["down.rows"]}, g["down"])
        if "antispoof" in comps:
            a = _denamespace("antispoof", ckpt.arrays)
            rows["antispoof.bindings"] = antispoof.bindings.restore_arrays(
                {k: a[f"bindings.{k}"] for k in ("keys", "vals", "used")},
                comps["antispoof"]["geom"])
            antispoof.ranges[:] = a["ranges"]
            antispoof.config[:] = a["config"]
        if "garden" in comps:
            a = _denamespace("garden", ckpt.arrays)
            rows["garden.subscribers"] = garden.subscribers.restore_arrays(
                {k: a[f"subscribers.{k}"] for k in ("keys", "vals", "used")},
                comps["garden"]["geom"])
            garden.allowed[:] = a["allowed"]
        if "pppoe" in comps:
            got = pppoe.restore_state(comps["pppoe"],
                                      _denamespace("pppoe", ckpt.arrays))
            rows.update({f"pppoe.{k}": v for k, v in got.items()})
        if "edge" in comps:
            got = edge.restore_state(comps["edge"],
                                     _denamespace("edge", ckpt.arrays))
            rows.update({f"edge.{k}": v for k, v in got.items()})
        if "dhcp" in comps or "fleet" in comps:
            worker_books = (list(comps["fleet"]["workers"])
                            if "fleet" in comps else [])
            parent_book = comps.get("dhcp")
            if fleet is not None:
                # the fleet owns DHCPv4: EVERY lease book (per-worker +
                # parent) re-shards into the workers. The parent book is
                # deliberately NOT hydrated too — double ownership would
                # let the parent's expiry sweep release worker-held
                # addresses back to the pool (double-allocation risk).
                books = worker_books + (
                    [parent_book] if parent_book else [])
                rows["fleet.leases"] = fleet.restore_state(
                    {"workers": books})
            else:
                total = 0
                if parent_book is not None:
                    total += dhcp.restore_leases(parent_book)
                for book in worker_books:
                    total += dhcp.restore_leases(book)
                rows["dhcp.leases"] = total
        if "ha" in comps:
            # role decides the direction: a restarted active resumes its
            # seq; a standby bootstraps then catches up via replay_since
            if hasattr(ha, "bootstrap_state"):
                rows["ha.sessions"] = ha.bootstrap_state(comps["ha"])
            else:
                rows["ha.sessions"] = ha.restore_state(comps["ha"])
        if "cluster_plan" in comps:
            # the plan document replays through the coordinator's store
            # so every member applies the checkpointed carve epoch
            rows["cluster_plan.members"] = cluster_coord.restore_plan(
                comps["cluster_plan"])
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        raise CheckpointError(f"checkpoint restore rejected: {e}") from e

    if engine is not None:
        # one full device upload — the same bulk path a cold start takes
        engine.resync_tables()
    return rows


# ---------------------------------------------------------------------------
# sharded snapshot / restore
# ---------------------------------------------------------------------------
# One file holds EVERY shard's host authorities namespaced
# `shard<i>/<component>/...` plus the flat non-shard components (lease
# book, HA store, fleet books) exactly as the single-engine format
# carries them. `meta["sharded"]` records the topology; restore either
# hydrates slot-exact (same shard count + geometry) or RE-SHARDS every
# row onto its owner under the new topology — the same FNV-1a32 owner
# discipline the fleet lease-book re-shard uses. NAT port-block
# placements cannot move verbatim across a topology change (each shard
# owns its public IPs exclusively), so blocks re-allocate on the new
# owner shard and live flows re-establish through the normal new-flow
# punt; everything host-authoritative (leases, subscriber rows, QoS
# policy, bindings, garden membership, PPPoE sessions) moves losslessly.

def _shard_prefix(i: int) -> str:
    return f"shard{i}"


def build_sharded_checkpoint(cluster, seq: int, now: float, *, dhcp=None,
                             ha=None, fleet=None, quiesce: bool = True,
                             node_id: str = "") -> Checkpoint:
    """Snapshot an N-shard ShardedCluster (parallel/sharded.py) plus the
    flat control-plane components, at the cluster quiesce barrier with
    device-authoritative words folded back — the sharded analog of
    build_checkpoint(engine=...)."""
    if quiesce:
        cluster.quiesce()
        cluster.fold_device_authoritative()
    base = build_checkpoint(seq, now, dhcp=dhcp, ha=ha, fleet=fleet,
                            node_id=node_id)
    meta = base.meta
    arrays = dict(base.arrays)
    meta["sharded"] = {"n_shards": int(cluster.n), "shards": []}
    for i in range(cluster.n):
        sub = build_checkpoint(seq, now, node_id=node_id,
                               **cluster.shard_components(i))
        meta["sharded"]["shards"].append(sub.meta["components"])
        pref = _shard_prefix(i)
        arrays.update({f"{pref}/{k}": v for k, v in sub.arrays.items()})
    return Checkpoint(meta=meta, arrays=arrays)


def _shard_sub_checkpoint(ckpt: Checkpoint, i: int, comps: dict) -> Checkpoint:
    """Shard i's slice of a sharded checkpoint, re-shaped into the flat
    single-engine format (components meta + de-prefixed arrays) so the
    existing verify/restore machinery applies unchanged."""
    pref = _shard_prefix(i) + "/"
    arrays = {k[len(pref):]: v for k, v in ckpt.arrays.items()
              if k.startswith(pref)}
    return Checkpoint(meta={"components": comps}, arrays=arrays)


def _sharded_meta(ckpt: Checkpoint) -> tuple[int, list[dict]]:
    sh = ckpt.meta.get("sharded")
    if not isinstance(sh, dict):
        raise CheckpointError(
            "not a sharded checkpoint (no sharded topology meta): "
            "refusing to hydrate a cluster from a single-engine snapshot")
    try:
        src_n = int(sh["n_shards"])
        shards = list(sh["shards"])
    except (KeyError, TypeError, ValueError) as e:
        raise CheckpointError(f"corrupt sharded topology meta: {e}") from e
    if src_n < 1 or len(shards) != src_n:
        raise CheckpointError(
            f"corrupt sharded topology meta: n_shards={src_n} but "
            f"{len(shards)} shard component sets")
    return src_n, shards


def _used_rows(arrays: dict, name: str, label: str):
    """(keys[used], vals[used]) of one checkpointed HostTable, with the
    structural validation the re-shard walk needs."""
    keys = arrays.get(f"{name}.keys")
    vals = arrays.get(f"{name}.vals")
    used = arrays.get(f"{name}.used")
    if keys is None or vals is None or used is None:
        raise CheckpointError(f"{label}: checkpoint missing {name} arrays")
    if not (keys.ndim == 2 and vals.ndim == 2
            and keys.shape[0] == vals.shape[0] == used.shape[0]):
        raise CheckpointError(
            f"{label}: inconsistent {name} array shapes "
            f"{keys.shape}/{vals.shape}/{used.shape}")
    m = used.astype(bool)
    return keys[m], vals[m]


def _reshard_walk(ckpt: Checkpoint, shards_meta: list[dict], src_n: int,
                  target, now: int) -> dict[str, int]:
    """Re-insert every source shard's rows into `target` (a fresh
    ShardedCluster clone) under ITS owner routing — FNV-1a32 key hash
    for the DHCP tables, subscriber-IP affinity for the chip-local
    state. Raises CheckpointError on structural problems; an insert
    overflow (target shards too small for the re-balanced load) also
    rejects — the caller's throwaway target makes that safe."""
    from bng_tpu_torch.control.nat import NATManager
    from bng_tpu_torch.edge.ops import TC_ARMED
    from bng_tpu_torch.ops.antispoof import AB_IPV4
    from bng_tpu_torch.ops.pppoe import PS_IP
    from bng_tpu_torch.ops.qtable import (QW_BURST, QW_FLAGS, QW_KEY, QW_PRIORITY,
                                          QW_RATE_HI, QW_RATE_LO)
    from bng_tpu_torch.ops.table import shard_owner

    rows = {"dhcp_rows": 0, "qos_rows": 0, "spoof_rows": 0,
            "garden_rows": 0, "pppoe_rows": 0, "nat_blocks": 0,
            "edge_taps": 0, "edge_routes": 0}
    try:
        for i in range(src_n):
            comps = dict(shards_meta[i])
            sub = _shard_sub_checkpoint(ckpt, i, comps)
            for name in _PAYLOAD_JSON_COMPONENTS:
                if name in comps:
                    comps[name] = _resolve_component_meta(sub, comps, name)
            a = sub.arrays
            label = _shard_prefix(i)

            if "fastpath" in comps:
                fa = _denamespace("fastpath", a)
                for t in ("sub", "vlan", "cid"):
                    keys, vals = _used_rows(fa, t, f"{label}.fastpath")
                    if len(keys) == 0:
                        continue
                    owners = shard_owner(
                        [keys[:, k] for k in range(keys.shape[1])],
                        target.n)
                    for r in range(len(keys)):
                        getattr(target.fastpath[int(owners[r])],
                                t).insert(keys[r], vals[r])
                        rows["dhcp_rows"] += 1
                # pool/server config is replicated cluster-wide: shard
                # 0's copy is authoritative for every target shard
                if i == 0:
                    for fp in target.fastpath:
                        _check_dense(fa, "pools", fp.pools,
                                     f"{label}.fastpath")
                        _check_dense(fa, "server", fp.server,
                                     f"{label}.fastpath")
                        fp.pools[:] = fa["pools"]
                        fp.server[:] = fa["server"]

            if "qos" in comps:
                qa = _denamespace("qos", a)
                for side in ("up", "down"):
                    rws = qa.get(f"{side}.rows")
                    if rws is None or rws.ndim != 2:
                        raise CheckpointError(
                            f"{label}.qos: missing/odd {side} rows")
                    for r in rws[(rws[:, QW_FLAGS] & 1) != 0]:
                        ip = int(r[QW_KEY])
                        o = target.affinity_shard_ip(ip)
                        rate = int(r[QW_RATE_LO]) | (int(r[QW_RATE_HI]) << 32)
                        # tokens re-seed to full burst on the new owner
                        # (host cannot carry device tokens across a
                        # re-hash — same rule as in-table relocation)
                        getattr(target.qos[o], side).insert(
                            ip, rate, int(r[QW_BURST]),
                            int(r[QW_PRIORITY]))
                        rows["qos_rows"] += 1

            if "antispoof" in comps:
                sa = _denamespace("antispoof", a)
                keys, vals = _used_rows(sa, "bindings", f"{label}.antispoof")
                for r in range(len(keys)):
                    o = target.affinity_shard_ip(int(vals[r][AB_IPV4]))
                    target.spoof[o].bindings.insert(keys[r], vals[r])
                    rows["spoof_rows"] += 1
                if i == 0:
                    for sp in target.spoof:
                        _check_dense(sa, "ranges", sp.ranges,
                                     f"{label}.antispoof")
                        _check_dense(sa, "config", sp.config,
                                     f"{label}.antispoof")
                        sp.ranges[:] = sa["ranges"]
                        sp.config[:] = sa["config"]

            if "garden" in comps and target.garden is None:
                raise CheckpointError(
                    f"{label} carries garden state but the target "
                    f"cluster has no garden gate: refusing a partial "
                    f"restore")
            if "pppoe" in comps and target.pppoe is None:
                raise CheckpointError(
                    f"{label} carries pppoe state but the target "
                    f"cluster has pppoe disabled: refusing a partial "
                    f"restore")
            if "garden" in comps and target.garden is not None:
                ga = _denamespace("garden", a)
                keys, vals = _used_rows(ga, "subscribers", f"{label}.garden")
                for r in range(len(keys)):
                    o = target.affinity_shard_ip(int(keys[r][0]))
                    target.garden[o].subscribers.insert(keys[r], vals[r])
                    rows["garden_rows"] += 1
                if i == 0:
                    for gd in target.garden:
                        _check_dense(ga, "allowed", gd.allowed,
                                     f"{label}.garden")
                        gd.allowed[:] = ga["allowed"]

            if "pppoe" in comps and target.pppoe is not None:
                pa = _denamespace("pppoe", a)
                for t in ("by_sid", "by_ip"):
                    keys, vals = _used_rows(pa, t, f"{label}.pppoe")
                    for r in range(len(keys)):
                        # both directions land on the session's affinity
                        # shard — the ring steers both sides there
                        o = target.affinity_shard_ip(int(vals[r][PS_IP]))
                        getattr(target.pppoe[o], t).insert(keys[r], vals[r])
                        rows["pppoe_rows"] += 1
                if i == 0 and pa.get("server_mac") is not None:
                    for pe in target.pppoe:
                        pe.server_mac[:] = pa["server_mac"]

            if "edge" in comps and getattr(target, "edge", None) is None:
                raise CheckpointError(
                    f"{label} carries edge state but the target cluster "
                    f"has edge protection disabled: refusing a partial "
                    f"restore")
            if "edge" in comps and getattr(target, "edge", None) is not None:
                ea = _denamespace("edge", a)
                keys, vals = _used_rows(ea, "tap", f"{label}.edge")
                for r in range(len(keys)):
                    # chip-local by subscriber affinity, like the ring
                    o = target.affinity_shard_ip(int(keys[r][0]))
                    target.edge[o].tap.insert(keys[r], vals[r])
                    target.edge[o]._armed += 1
                    target.edge[o].tap_config[TC_ARMED] = \
                        target.edge[o]._armed
                    rows["edge_taps"] += 1
                keys, vals = _used_rows(ea, "route", f"{label}.edge")
                for r in range(len(keys)):
                    o = target.affinity_shard_ip(int(keys[r][0]))
                    target.edge[o].route.insert(keys[r], vals[r])
                    rows["edge_routes"] += 1
                if i == 0:
                    # filter rows are warrant-global: replicated to
                    # every shard, shard 0's copy authoritative
                    for ed in target.edge:
                        _check_dense(ea, "tap_filters", ed.tap_filters,
                                     f"{label}.edge")
                        ed.tap_filters[:] = ea["tap_filters"]

            if "nat" in comps:
                parsed = NATManager.parse_checkpoint_meta(comps["nat"])
                # port blocks re-allocate on the new owner (public-IP
                # ownership is per-shard and exclusive; a block cannot
                # move between public IPs verbatim). Live flows
                # re-establish via the device's new-flow punt.
                for priv_ip in sorted(parsed["blocks"]):
                    o = target.affinity_shard_ip(int(priv_ip))
                    if target.nat[o].allocate_nat(int(priv_ip),
                                                  int(now)) is None:
                        # exhaustion is NOT recoverable-by-punt (the
                        # punt's allocation hits the same empty pool):
                        # reject like any other overflow, loudly
                        raise CheckpointError(
                            f"NAT block for {priv_ip:#x} does not fit "
                            f"shard {o}'s port space under the new "
                            f"topology ({target.n} shards): provision "
                            f"more public IPs / wider port ranges "
                            f"before re-sharding down")
                    rows["nat_blocks"] += 1
                na = _denamespace("nat", a)
                if i == 0 and na.get("hairpin") is not None \
                        and na.get("alg") is not None:
                    # hairpin/ALG policy config is cluster-global
                    for nm in target.nat:
                        nm.hairpin[:] = na["hairpin"]
                        nm.alg[:] = na["alg"]
    except CheckpointError:
        raise
    except (KeyError, IndexError, TypeError, ValueError, RuntimeError) as e:
        raise CheckpointError(
            f"sharded re-shard rejected: {type(e).__name__}: {e}") from e
    return rows


def restore_sharded_checkpoint(ckpt: Checkpoint, cluster, *, dhcp=None,
                               ha=None, fleet=None,
                               now: int = 0) -> dict[str, int]:
    """Hydrate a ShardedCluster (and the flat components) from a sharded
    checkpoint, then one full device upload — reject-on-mismatch like
    the single-engine restore, all-or-nothing across EVERY shard.

    Topology aware: a checkpoint taken at N shards restores into an
    M-shard cluster by re-inserting every row on its owner under the
    new topology (the fleet lease-book re-shard discipline). The
    hydration happens into a throwaway geometry clone first and the
    host authorities are adopted wholesale on success, so a reject can
    never leave the live cluster half-hydrated.
    """
    src_n, shards_meta = _sharded_meta(ckpt)

    tmp = cluster.clone_empty()
    if src_n == cluster.n:
        # slot-exact fast path: verify EVERY shard against the clone's
        # geometry, then hydrate shard by shard (preserves cuckoo/stash
        # placement and the folded device-authoritative words)
        subs = []
        for i in range(src_n):
            comps = dict(shards_meta[i])
            sub = _shard_sub_checkpoint(ckpt, i, comps)
            for name in _PAYLOAD_JSON_COMPONENTS:
                if name in comps:
                    comps[name] = _resolve_component_meta(sub, comps, name)
            targets = tmp.shard_components(i)
            missing = sorted(set(comps) - set(targets))
            if missing:
                raise CheckpointError(
                    f"shard{i} carries {missing} but the live cluster "
                    f"has no such component(s): refusing a partial "
                    f"restore")
            _verify_components(sub, comps, targets)
            subs.append((sub, comps, targets))
        rows: dict[str, int] = {}
        for i, (sub, _comps, targets) in enumerate(subs):
            # the flat restore path knows every component shape; reuse
            # it wholesale per shard (no engine kwarg: the one device
            # upload happens once, below, for all shards together)
            got = restore_checkpoint(sub, **targets)
            rows.update({f"shard{i}.{k}": v for k, v in got.items() if v})
    else:
        rows = _reshard_walk(ckpt, shards_meta, src_n, tmp, now)
        rows["resharded_from"] = src_n
        rows["resharded_to"] = cluster.n

    # flat components (lease book / HA / fleet) hydrate exactly like the
    # single-engine path — the book formats are topology-independent
    flat_comps = dict(ckpt.meta.get("components", {}))
    if flat_comps:
        flat = Checkpoint(
            meta={"components": ckpt.meta.get("components", {})},
            arrays={k: v for k, v in ckpt.arrays.items()
                    if not k.startswith("shard")})
        rows.update(restore_checkpoint(flat, dhcp=dhcp, ha=ha, fleet=fleet))

    # adopt the hydrated authorities wholesale (tmp is a geometry clone,
    # so presence/absence of garden/pppoe/edge matches); then the one
    # full upload — the same bulk path a cold start takes
    cluster.adopt_authorities(tmp)
    cluster.resync_tables()
    return rows
