"""The port's checkpoint, warm restart and state store against the JAX package's.

- Format: `encode_checkpoint` of the same host state (the same seq, time
  and node id) gives the same bytes from both packages; each package
  decodes the other's bytes; the reject surface (bad magic, truncated
  payload, bad CRC, wrong schema, header bit flip) is a `CheckpointError`
  in both.
- Cross-package restore: a full stack (fast path, NAT with flows, QoS,
  antispoof, garden, PPPoE, edge, a DHCP server's lease book) is built in
  each package by the same host calls and driven through a few batches,
  so NAT counters and QoS tokens hold device-written words. The JAX
  snapshot restores into a fresh port engine and the port's into a fresh
  JAX engine. Renewals, cached DISCOVERs and flows then give the same
  verdicts, bytes and table words on all four engines, with no slow-path
  call for the cached leases.
- The fold: rows the bounded drain has not shipped stay host-authoritative,
  and the QoS token words fold to the same bits in both packages.
- Rejects before any mutation: a wrong geometry, a missing component, a
  corrupt NAT meta, a missing PPPoE server MAC, and a reference snapshot
  carrying a component the port does not have (HA, cluster plan).
- `compat_val_pad_from`: 4-word NAT reverse rows and 6-word PPPoE rows
  restore zero-padded to the same words in both packages.
- The state store (`TestStore`, `TestPeriodicCheckpointer` of the
  reference) and the `ckpt.write` / `ckpt.read` fault points.
- A devloop stack with a ring in flight, quiesced and snapshotted, restores
  to the same tables in both packages.
- Sharded, at N = 2 and N = 4: a same-N round trip is slot-exact; a
  re-shard 2 -> 4 and 4 -> 2 gives every shard the reference's rows; a
  single-engine snapshot refuses a cluster and the other way round; a
  too-small target refuses.

Tolerance: exact (the same bytes, words, verdicts and counts).
"""

import json
import struct
import zlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from bng_tpu.chaos import faults as jf
from bng_tpu.control import statestore as j_store
from bng_tpu.control.dhcp_server import DHCPServer as JServer
from bng_tpu.control.nat import NATManager as JNAT
from bng_tpu.control.pool import Pool as JPool
from bng_tpu.control.pool import PoolManager as JPools
from bng_tpu.edge.tables import EdgeTables as JEdge
from bng_tpu.parallel.sharded import ShardedCluster as JCluster
from bng_tpu.runtime import checkpoint as jck
from bng_tpu.runtime.engine import AntispoofTables as JSpoof
from bng_tpu.runtime.engine import Engine as JEngine
from bng_tpu.runtime.engine import GardenTables as JGarden
from bng_tpu.runtime.engine import QoSTables as JQoS
from bng_tpu.runtime.tables import FastPathTables as JFastPath
from bng_tpu.runtime.tables import PPPoEFastPathTables as JPPPoE
from bng_tpu_torch import convert
from bng_tpu_torch import frames as F
from bng_tpu_torch.chaos import faults as tf
from bng_tpu_torch.control import statestore as t_store
from bng_tpu_torch.control.dhcp_server import DHCPServer as TServer
from bng_tpu_torch.control.nat import NATManager as TNAT
from bng_tpu_torch.control.pool import Pool as TPool
from bng_tpu_torch.control.pool import PoolManager as TPools
from bng_tpu_torch.edge.tables import EdgeTables as TEdge
from bng_tpu_torch.ops.antispoof import MODE_LOOSE, MODE_STRICT
from bng_tpu_torch.ops.qtable import QW_FLAGS, QW_LAST_US, QW_TOKENS
from bng_tpu_torch.parallel.sharded import ShardedCluster as TCluster
from bng_tpu_torch.runtime import checkpoint as tck
from bng_tpu_torch.runtime.engine import AntispoofTables as TSpoof
from bng_tpu_torch.runtime.engine import Engine as TEngine
from bng_tpu_torch.runtime.engine import GardenTables as TGarden
from bng_tpu_torch.runtime.engine import QoSTables as TQoS
from bng_tpu_torch.runtime.tables import FastPathTables as TFastPath
from bng_tpu_torch.runtime.tables import PPPoEFastPathTables as TPPPoE
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_stages import assert_tuple_equal

pytestmark = pytest.mark.torch_port

SERVER_MAC = bytes.fromhex("02aabbccdd01")
SERVER_IP = ip_to_u32("10.0.0.1")
NOW = 1_753_000_000
REMOTE = ip_to_u32("93.184.216.34")

JAX = SimpleNamespace(
    name="jax", FastPathTables=JFastPath, NATManager=JNAT, QoSTables=JQoS, AntispoofTables=JSpoof,
    GardenTables=JGarden, PPPoEFastPathTables=JPPPoE, EdgeTables=JEdge, Pool=JPool,
    PoolManager=JPools, DHCPServer=JServer, Engine=JEngine, ck=jck, store=j_store, faults=jf,
    Cluster=JCluster, kw={})
PORT = SimpleNamespace(
    name="port", FastPathTables=TFastPath, NATManager=TNAT, QoSTables=TQoS, AntispoofTables=TSpoof,
    GardenTables=TGarden, PPPoEFastPathTables=TPPPoE, EdgeTables=TEdge, Pool=TPool,
    PoolManager=TPools, DHCPServer=TServer, Engine=TEngine, ck=tck, store=t_store, faults=tf,
    Cluster=TCluster, kw={"device": "cpu"})
PKGS = (JAX, PORT)


class FakeClock:
    def __init__(self, t=float(NOW)):
        self.t = t

    def __call__(self):
        return self.t


def mac(i: int) -> bytes:
    return bytes([0x02, 0xDE, 0xAD, 0x00, 0x00, i])


def dhcp(m, msg_type, xid, **kw) -> bytes:
    p = F.build_request(m, msg_type, xid=xid, **kw)
    p.options.append((F.OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 51, 54])))
    return F.udp_packet(m, b"\xff" * 6, kw.get("ciaddr", 0), 0xFFFFFFFF, 68, 67,
                        p.encode().ljust(320, b"\x00"))


class Sess:
    def __init__(self, sid, m, ip):
        self.session_id, self.client_mac, self.assigned_ip = sid, m, ip


def jwords(tables):
    return jax.tree_util.tree_map(lambda a: np.array(a), tables)


def words(eng):
    """An engine's device tables as uint32 numpy NamedTuples."""
    return convert.tables_to_numpy(eng.tables) if isinstance(eng, TEngine) else jwords(eng.tables)


# ---------------------------------------------------------------------------
# the full stack: every component a checkpoint carries
# ---------------------------------------------------------------------------

def stack(p, populate: bool = True) -> SimpleNamespace:
    """Every host authority, a DHCP server and an engine of package `p`, by
    the same host calls in either package. populate=False: the same
    geometry, empty (a fresh process to restore into)."""
    clock = FakeClock()
    fp = p.FastPathTables(sub_nbuckets=256, vlan_nbuckets=64, cid_nbuckets=64, max_pools=16,
                          stash=16, update_slots=32)
    fp.set_server_config(SERVER_MAC, SERVER_IP)
    pools = p.PoolManager(fp)
    pools.add_pool(p.Pool(pool_id=1, network=ip_to_u32("10.0.0.0"), prefix_len=24,
                          gateway=SERVER_IP, dns_primary=ip_to_u32("1.1.1.1"), lease_time=3600))
    nat = p.NATManager(public_ips=[ip_to_u32("203.0.113.1"), ip_to_u32("203.0.113.2")],
                       ports_per_subscriber=64, sessions_nbuckets=256, sub_nat_nbuckets=64,
                       stash=16, update_slots=64)
    qos = p.QoSTables(nbuckets=64)
    spoof = p.AntispoofTables(nbuckets=64, stash=16)
    garden = p.GardenTables(nbuckets=64, stash=8, update_slots=16)
    pppoe = p.PPPoEFastPathTables(nbuckets=64, stash=8, update_slots=16)
    edge = p.EdgeTables(nbuckets=64, stash=8, update_slots=16, max_filters=8)
    server = p.DHCPServer(SERVER_MAC, SERVER_IP, pools, fastpath_tables=fp, clock=clock)
    slow_calls = []

    def slow(frame):
        slow_calls.append(frame)
        return server.handle_frame(frame)

    if populate:
        fp.add_pool(2, ip_to_u32("10.1.0.0"), 16, ip_to_u32("10.1.0.1"), ip_to_u32("1.1.1.1"), 0,
                    7200)
        for i, ip in ((1, "10.0.0.21"), (2, "10.0.0.22"), (3, "10.0.0.23")):
            fp.add_subscriber(mac(i), pool_id=1, ip=ip_to_u32(ip), lease_expiry=NOW + 900)
        fp.add_vlan_subscriber(100, 0, pool_id=2, ip=ip_to_u32("10.1.0.9"), lease_expiry=NOW + 900)
        fp.add_circuit_id_subscriber(b"olt-3/port-7", pool_id=2, ip=ip_to_u32("10.1.0.8"),
                                     lease_expiry=NOW + 900)
        for ip in ("10.0.0.10", "10.0.0.11"):
            nat.allocate_nat(ip_to_u32(ip), NOW)
        nat.handle_new_flow(ip_to_u32("10.0.0.10"), REMOTE, 5000, 443, 17, 100, NOW)
        nat.handle_new_flow(ip_to_u32("10.0.0.11"), REMOTE, 40000, 80, 6, 100, NOW)
        qos.set_subscriber(ip_to_u32("10.0.0.10"), down_bps=8_000_000, up_bps=8_000,
                           up_burst=600, down_burst=20_000)
        qos.set_subscriber(ip_to_u32("10.0.0.11"), down_bps=0, up_bps=50_000_000, priority=3)
        spoof.set_config(MODE_LOOSE, True)
        spoof.add_binding(mac(0x10), ip_to_u32("10.0.0.10"), MODE_STRICT)
        spoof.add_allowed_range(ip_to_u32("10.0.0.0"), 24)
        garden.set_gardened(ip_to_u32("10.0.0.60"), True)
        garden.allow_destination(ip_to_u32("10.9.9.9"), 80, 6)
        pppoe.session_up(Sess(0x21, mac(0x21), ip_to_u32("10.0.0.70")))
        pppoe.session_up(Sess(0x22, mac(0x22), ip_to_u32("10.0.0.71")))
        edge.arm_tap(ip_to_u32("10.0.0.11"), 7, [(80, 6, 0)])
        edge.set_route(ip_to_u32("10.0.0.10"), b"\x02\x47\x57\x00\x00\x01", table_id=100)
    eng = p.Engine(fp, nat, qos, spoof, garden, pppoe, batch_size=16, pkt_slot=512,
                   slow_path=slow, clock=clock, edge=edge, **p.kw)
    return SimpleNamespace(p=p, clock=clock, fp=fp, pools=pools, nat=nat, qos=qos, spoof=spoof,
                           garden=garden, pppoe=pppoe, edge=edge, server=server, eng=eng,
                           slow_calls=slow_calls)


def udp(src_mac, src, sport, dport, n):
    return F.udp_packet(src_mac, b"\x04" * 6, ip_to_u32(src), REMOTE, sport, dport, b"q" * n)


def drive(st) -> list:
    """Two DORAs through the slow path, then a mixed batch with established
    and new flows and a QoS-limited subscriber: NAT counters and QoS tokens
    become device-written. Returns every batch's output."""
    outs = []
    for k, m in enumerate((mac(0x31), mac(0x32))):
        o = st.eng.process([dhcp(m, F.DISCOVER, 0x500 + k)], now=NOW)
        ip = F.decode_dhcp(F.decode(o["slow"][0][1]).payload).yiaddr
        outs += [o, st.eng.process([dhcp(m, F.REQUEST, 0x510 + k, requested_ip=ip,
                                         server_id=SERVER_IP)], now=NOW)]
    batch = [dhcp(mac(1), F.DISCOVER, 0x520), udp(mac(0x10), "10.0.0.10", 5000, 443, 300),
             udp(mac(0x10), "10.0.0.10", 5000, 443, 300), udp(mac(0x11), "10.0.0.11", 6000, 53, 40),
             F.tcp_packet(mac(0x11), b"\x04" * 6, ip_to_u32("10.0.0.11"), REMOTE, 40000, 80, b"x")]
    outs.append(st.eng.process(batch, now=NOW + 0.5))
    outs.append(st.eng.process(batch[1:], now=NOW + 1.5))
    return outs


def serve_after(st) -> dict:
    """Renewals and cached DISCOVERs of leased clients, flows of the restored
    NAT sessions: answered or forwarded on the device."""
    leases = sorted(st.server.export_leases()["leases"], key=lambda r: r["ip"])
    frames = [dhcp(bytes.fromhex(r["mac"]), F.REQUEST, 0x600 + k, ciaddr=r["ip"])
              for k, r in enumerate(leases)]
    frames += [dhcp(mac(1), F.DISCOVER, 0x610), dhcp(mac(3), F.DISCOVER, 0x611),
               udp(mac(0x10), "10.0.0.10", 5000, 443, 100),
               udp(mac(0x11), "10.0.0.11", 6000, 53, 40),
               F.tcp_packet(mac(0x11), b"\x04" * 6, ip_to_u32("10.0.0.11"), REMOTE, 40000, 80,
                            b"y")]
    return st.eng.process(frames, now=NOW + 10.0)


@pytest.fixture(scope="module")
def driven():
    """Both packages' stacks driven alike, with their checkpoints."""
    out = {}
    for p in PKGS:
        st = stack(p)
        outs = drive(st)
        ck = p.ck.build_checkpoint(5, float(NOW + 2), engine=st.eng, dhcp=st.server,
                                   node_id="bng-a")
        out[p.name] = (st, outs, ck)
    assert out["port"][1] == out["jax"][1]
    return out


def test_encode_is_byte_equal(driven):
    jb = jck.encode_checkpoint(driven["jax"][2])
    tb = tck.encode_checkpoint(driven["port"][2])
    assert tb == jb
    ck = driven["port"][2]
    assert all(a.dtype != np.int32 for a in ck.arrays.values())
    assert ck.meta["components"]["nat"] == {"__payload_json__": True}
    assert set(ck.meta["components"]) == {"fastpath", "nat", "qos", "antispoof", "garden",
                                          "pppoe", "edge", "dhcp"}


def test_each_package_decodes_the_other(driven):
    jb = jck.encode_checkpoint(driven["jax"][2])
    tb = tck.encode_checkpoint(driven["port"][2])
    for dec, data, enc in ((tck.decode_checkpoint, jb, jck.encode_checkpoint),
                           (jck.decode_checkpoint, tb, tck.encode_checkpoint)):
        got = dec(data)
        assert enc(got) == data
        assert got.seq == 5 and got.meta["node_id"] == "bng-a"


def _sample(mod, seq=7):
    return mod.Checkpoint(meta={"seq": seq, "created_at": 123.5, "node_id": "n1",
                                "components": {}},
                          arrays={"a": np.arange(12, dtype=np.uint32).reshape(3, 4) + seq,
                                  "b": np.ones((5,), dtype=np.uint8)})


def _patch_header(data: bytes, **fields) -> bytes:
    hlen, _ = struct.unpack_from("<II", data, len(jck.MAGIC))
    start = len(jck.MAGIC) + 8
    hdr = json.loads(data[start: start + hlen])
    hdr.update(fields)
    new = json.dumps(hdr, separators=(",", ":")).encode()
    return (data[: len(jck.MAGIC)] + struct.pack("<II", len(new), zlib.crc32(new) & 0xFFFFFFFF)
            + new + data[start + hlen:])


def _flip(data: bytes, off: int) -> bytes:
    raw = bytearray(data)
    raw[off] ^= 0x01 if off > 0 else 0xFF
    return bytes(raw)


@pytest.mark.parametrize("case,match", [
    ("bad_magic", "magic"), ("truncated", "truncated"), ("bad_crc", "crc32"),
    ("wrong_schema", "schema version 99"), ("header_bitflip", "header crc32")])
def test_reject_surface(case, match):
    for mod in (jck, tck):
        data = mod.encode_checkpoint(_sample(mod))
        bad = {"bad_magic": lambda d: b"NOTACKPT" + d[8:],
               "truncated": lambda d: d[:-5],
               "bad_crc": lambda d: _flip(d, -1),
               "wrong_schema": lambda d: _patch_header(d, schema_version=99),
               "header_bitflip": lambda d: _flip(d, len(mod.MAGIC) + 8 + 5)}[case](data)
        with pytest.raises(mod.CheckpointError, match=match):
            mod.decode_checkpoint(bad)


def test_cross_package_restore_serves_alike(driven):
    """The JAX snapshot into a fresh port engine, the port's into a fresh JAX
    engine: both, and both originals, then serve the same frames alike."""
    restored = {}
    for p, src in ((PORT, "jax"), (JAX, "port")):
        st = stack(p, populate=False)
        data = driven[src][2]
        ck = p.ck.decode_checkpoint(
            (jck if src == "jax" else tck).encode_checkpoint(data))
        rows = p.ck.restore_checkpoint(ck, engine=st.eng, dhcp=st.server)
        restored[p.name] = (st, rows)
    assert restored["port"][1] == restored["jax"][1]
    assert restored["port"][1]["dhcp.leases"] == 2 and restored["port"][1]["nat.sessions"] == 3
    engines = [driven["jax"][0], driven["port"][0], restored["jax"][0], restored["port"][0]]
    outs = [serve_after(st) for st in engines]
    assert all(o == outs[0] for o in outs[1:])
    assert len(outs[0]["tx"]) == 4 and len(outs[0]["fwd"]) == 3 and not outs[0]["slow"]
    for st in engines[2:]:
        assert st.slow_calls == []  # cached leases: no slow-path exchange
    ref = words(engines[0].eng)
    for st in engines[1:]:
        assert_tuple_equal(words(st.eng), ref, "engine tables")
    for f in ("dhcp", "nat", "qos", "spoof", "garden", "pppoe", "edge"):
        assert np.array_equal(getattr(engines[3].eng.stats, f), getattr(engines[2].eng.stats, f))
    assert restored["port"][0].server.export_leases() == driven["jax"][0].server.export_leases()


def test_fold_keeps_unshipped_rows_and_token_bits():
    """A session inserted after the last drain keeps its host row at the fold;
    a shipped session and the QoS token words take the device's bits, equal
    in both packages."""
    got = []
    for p in PKGS:
        st = stack(p)
        drive(st)
        sub = ip_to_u32("10.0.0.11")
        st.nat.handle_new_flow(sub, ip_to_u32("2.2.2.2"), 2222, 80, 17, 64, NOW + 5)
        slot = st.nat.sessions._find_slot(np.asarray(
            st.nat._key(sub, ip_to_u32("2.2.2.2"), 2222, 80, 17), dtype=np.uint32))
        before = st.nat.sessions.vals[slot].copy()
        st.eng.quiesce()
        st.eng.fold_device_authoritative()
        assert np.array_equal(st.nat.sessions.vals[slot], before)
        dev = st.eng.fetch_session_vals()
        shipped = st.eng._uploaded_mask(st.nat.sessions, st.nat.sessions.used.astype(bool))
        assert np.array_equal(st.nat.sessions.vals[shipped], np.asarray(dev)[shipped])
        live = (st.qos.up.rows[:, QW_FLAGS] & 1) != 0
        got.append((st.nat.sessions.vals.copy(), st.qos.up.rows[live][:, [QW_TOKENS, QW_LAST_US]],
                    st.qos.down.rows.copy()))
    for a, b in zip(*got):
        assert a.dtype == b.dtype == np.uint32 and np.array_equal(a, b)
    assert got[1][1][:, 1].any()  # the device stamped last_us


def _corrupt_nat_meta(ck):
    blob = json.loads(bytes(np.asarray(ck.arrays["nat/__payload_json__"])))
    del blob["eim"]
    ck.arrays["nat/__payload_json__"] = np.frombuffer(json.dumps(blob).encode(),
                                                      dtype=np.uint8).copy()


@pytest.mark.parametrize("case,match", [
    ("geometry", "geometry"), ("missing_component", "dhcp"), ("nat_meta", "nat"),
    ("pppoe_server_mac", "server_mac")])
def test_rejects_happen_before_any_mutation(case, match):
    for p in PKGS:
        src = stack(p)
        ck = p.ck.build_checkpoint(1, float(NOW), fastpath=src.fp, nat=src.nat, pppoe=src.pppoe,
                                   dhcp=src.server if case == "missing_component" else None)
        dst = stack(p, populate=False)
        targets = {"fastpath": dst.fp, "nat": dst.nat, "pppoe": dst.pppoe}
        if case == "geometry":
            targets["fastpath"] = p.FastPathTables(sub_nbuckets=512, vlan_nbuckets=64,
                                                   cid_nbuckets=64, max_pools=16, stash=16)
        elif case == "nat_meta":
            _corrupt_nat_meta(ck)
        elif case == "pppoe_server_mac":
            del ck.arrays["pppoe/server_mac"]
        dst.nat.allocate_nat(ip_to_u32("10.0.0.50"), NOW)
        mirrors = [dst.fp.sub.keys, dst.fp.pools, dst.nat.sub_nat.vals, dst.nat.sessions.used,
                   dst.pppoe.by_sid.keys, dst.pppoe.server_mac, targets["fastpath"].sub.used]
        before = [m.copy() for m in mirrors]
        blocks = dict(dst.nat.blocks)
        with pytest.raises(p.ck.CheckpointError, match=match):
            p.ck.restore_checkpoint(ck, **targets)
        assert all(np.array_equal(m, b) for m, b in zip(mirrors, before))
        assert dst.nat.blocks == blocks


@pytest.mark.parametrize("component", ["ha", "cluster_plan"])
def test_reference_only_components_are_refused(component):
    """A reference snapshot that carries its HA store (into a process with no
    HA pair) or its cluster plan (into a process with no coordinator) has no
    target: the restore refuses it with the reference's "no such component"
    before any mirror or lease changes. (The fleet's books restore:
    tests/test_torch_fleet.py; the HA store: tests/test_torch_ha.py; the
    carve plan: tests/test_torch_cluster.py.)"""
    src = stack(JAX)
    extra = {"ha": SimpleNamespace(checkpoint_state=lambda: {"seq": 3, "sessions": []}),
             "cluster_plan": SimpleNamespace(checkpoint_plan=lambda: {"epoch": 1, "members": {}})}
    ck = JAX.ck.build_checkpoint(1, float(NOW), fastpath=src.fp, nat=src.nat, dhcp=src.server,
                                 **{component: extra[component]})
    ck = PORT.ck.decode_checkpoint(JAX.ck.encode_checkpoint(ck))
    dst = stack(PORT, populate=False)
    mirrors = [dst.fp.sub.keys, dst.fp.pools, dst.nat.sub_nat.vals, dst.nat.sessions.used]
    before = [m.copy() for m in mirrors]
    with pytest.raises(PORT.ck.CheckpointError, match=rf"\['{component}'\].*no such component"):
        PORT.ck.restore_checkpoint(ck, fastpath=dst.fp, nat=dst.nat, dhcp=dst.server)
    assert all(np.array_equal(m, b) for m, b in zip(mirrors, before))
    assert not dst.server.leases


@pytest.mark.parametrize("component", ["nat", "pppoe"])
def test_narrow_rows_restore_zero_padded(component):
    """A checkpoint with the older narrow value rows (4-word NAT reverse rows,
    6-word PPPoE rows): both packages' component restores pad them with
    zeros to the same words, and both packages' `restore_checkpoint`
    refuse the whole checkpoint at the verify gate ("geometry"), the live
    tables untouched."""
    table, width = ("reverse", 4) if component == "nat" else ("by_sid", 6)
    got = []
    for p in PKGS:
        src = stack(p)
        ck = p.ck.build_checkpoint(1, float(NOW), **{component: getattr(src, component)})
        blob = f"{component}/__payload_json__"
        meta = (json.loads(bytes(ck.arrays[blob])) if blob in ck.arrays
                else ck.meta["components"][component])
        meta["geom"][table]["val_words"] = width
        if blob in ck.arrays:
            ck.arrays[blob] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8).copy()
        name = f"{component}/{table}.vals"
        ck.arrays[name] = np.ascontiguousarray(ck.arrays[name][:, :width])
        ck = p.ck.decode_checkpoint(p.ck.encode_checkpoint(ck))
        arrays = {k.split("/", 1)[1]: v for k, v in ck.arrays.items()
                  if k.startswith(component + "/") and not k.endswith("__payload_json__")}
        dst = getattr(stack(p, populate=False), component)
        dst.restore_state(meta, arrays)
        full = getattr(getattr(src, component), table).vals
        t = getattr(dst, table)
        assert np.array_equal(t.vals[:, :width], full[:, :width]) and not t.vals[:, width:].any()
        got.append(t.vals.copy())
        whole = getattr(stack(p, populate=False), component)
        before = getattr(whole, table).vals.copy()
        with pytest.raises(p.ck.CheckpointError, match="geometry"):
            p.ck.restore_checkpoint(ck, **{component: whole})
        assert np.array_equal(getattr(whole, table).vals, before)
    assert np.array_equal(got[0], got[1])


# ---------------------------------------------------------------------------
# the state store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
class TestStore:
    def test_versioned_save_and_latest(self, p, tmp_path):
        st = p.store.CheckpointStore(tmp_path)
        assert st.next_seq() == 1
        p1 = st.save(_sample(p.ck, 1))
        st.save(_sample(p.ck, 2))
        assert st.next_seq() == 3
        got, path = st.load_latest()
        assert got.seq == 2 and np.array_equal(got.arrays["a"], _sample(p.ck, 2).arrays["a"])
        assert p1.exists() and not list(tmp_path.glob(".tmp-*"))

    def test_corrupt_newest_falls_back_to_older(self, p, tmp_path):
        st = p.store.CheckpointStore(tmp_path)
        st.save(_sample(p.ck, 1))
        p2 = st.save(_sample(p.ck, 2))
        p2.write_bytes(_flip(p2.read_bytes(), -1))
        got, _ = st.load_latest()
        assert got.seq == 1
        infos = st.list()
        assert "crc32" in infos[0].error and infos[1].error is None

    def test_all_corrupt_raises(self, p, tmp_path):
        st = p.store.CheckpointStore(tmp_path)
        st.save(_sample(p.ck)).write_bytes(b"garbage")
        with pytest.raises(p.ck.CheckpointError, match="no restorable"):
            st.load_latest()
        with pytest.raises(p.ck.CheckpointError, match="no checkpoints"):
            p.store.CheckpointStore(tmp_path / "empty").load_latest()

    def test_stray_filename_ignored(self, p, tmp_path):
        st = p.store.CheckpointStore(tmp_path)
        path = st.save(_sample(p.ck, 3))
        (tmp_path / "ckpt-latest.bngckpt").write_bytes(path.read_bytes())
        assert st.next_seq() == 4
        assert st.load_latest()[1] == path and [i.seq for i in st.list()] == [3]

    def test_prune_keeps_newest(self, p, tmp_path):
        st = p.store.CheckpointStore(tmp_path)
        for seq in range(1, 6):
            st.save(_sample(p.ck, seq))
        assert st.prune(keep=2) == 3
        assert [i.seq for i in st.list()] == [5, 4]


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
class TestPeriodicCheckpointer:
    def test_cadence_and_retention(self, p, tmp_path):
        clock = FakeClock()
        ck = p.store.PeriodicCheckpointer(p.store.CheckpointStore(tmp_path),
                                          lambda seq, now: _sample(p.ck, seq), interval_s=10.0,
                                          keep=2, clock=clock)
        assert ck.tick(clock()) is not None and ck.tick(clock()) is None
        for _ in range(5):
            clock.t += 10.1
            ck.tick(clock())
        assert ck.stats["saves"] == 6 and len(ck.store.list()) == 2
        assert ck.store.next_seq() == 7

    def test_background_failure_counts_and_never_raises(self, p, tmp_path):
        clock = FakeClock()

        def boom(seq, now):
            raise OSError("disk full")

        ck = p.store.PeriodicCheckpointer(p.store.CheckpointStore(tmp_path), boom,
                                          interval_s=1.0, clock=clock)
        for _ in range(3):
            clock.t += 1.1
            assert ck.tick(clock()) is None
        assert ck.stats["failures"] == 3 and "disk full" in ck.stats["last_error"]
        with pytest.raises(OSError):
            ck.save_now(reason="manual")


@pytest.mark.parametrize("point", ["ckpt.write", "ckpt.read"])
@pytest.mark.parametrize("kind,arg", [("truncate", 7), ("bitflip", 41), ("io_error", 0)])
def test_checkpoint_fault_points(tmp_path, point, kind, arg):
    """An armed write or read fault: the save raises (io_error at write) or
    lands corrupt bytes, the read rejects them, and the store falls back to
    the older file, identically in both packages."""
    got = []
    for p in PKGS:
        st = p.store.CheckpointStore(tmp_path / p.name)
        st.save(_sample(p.ck, 1))
        with p.faults.armed(p.faults.FaultPlan(1, [p.faults.FaultSpec(point, kind, arg=arg)]),
                            log=False) as inj:
            try:
                st.save(_sample(p.ck, 2))
                saved = "ok"
            except OSError:
                saved = "OSError"
            latest, path = st.load_latest()
            fired = len(inj.injected)
        got.append((saved, latest.seq, path.name, fired,
                    [(i.seq, i.error is None) for i in st.list()]))
    assert got[1] == got[0]
    saved, seq, _, fired, listing = got[1]
    assert seq == 1 and fired == 1
    if point == "ckpt.write":
        assert (saved == "OSError") == (kind == "io_error")
        assert listing == ([(1, True)] if kind == "io_error" else [(2, False), (1, True)])
    else:
        assert saved == "ok" and listing == [(2, True), (1, True)]


# ---------------------------------------------------------------------------
# the devloop claim: nothing of a ring in flight reaches a checkpoint
# ---------------------------------------------------------------------------

def test_devloop_ring_in_flight_checkpoints_the_host_state():
    """A ring in flight and a resync (the ROADMAP Queue 3 case where the
    reference's published tables lose a row): after `quiesce()` the
    snapshot is the host state, and both packages restore the same tables,
    every host row included."""
    from test_torch_devloop import BATCH, _burst, _host_dhcp_words, _stack
    from test_torch_scheduler import JAX as SJ, PORT as SP, T0, build_stack, mac as smac

    restored = []
    for mods, ckmod in ((SJ, jck), (SP, tck)):
        sched, server, fp, _ = _stack(mods)
        sched.process(_burst(BATCH * 3), now=T0)
        fp.add_subscriber(smac(0x71), 1, ip_to_u32("10.0.0.71"), int(T0) + 900)
        for i in range(BATCH * 3):
            sched.submit(dhcp(smac(i % 4), F.DISCOVER, 0x4300 + i), True, now=T0)
        for _ in range(3):
            pend, reason = sched.express.close_batch(T0)
            sched._dispatch_express(pend, T0, reason)
        assert len(sched._devloop._inflight) == 1
        fp.add_subscriber(smac(0x72), 1, ip_to_u32("10.0.0.72"), int(T0) + 900)
        sched.engine.resync_tables()
        ck = ckmod.build_checkpoint(1, T0, engine=sched.engine, scheduler=sched)
        assert not sched._devloop._inflight
        host = _host_dhcp_words(fp)
        fresh_sched, _, _ = build_stack(mods, FakeClock(T0))
        ckmod.restore_checkpoint(ckmod.decode_checkpoint(ckmod.encode_checkpoint(ck)),
                                 engine=fresh_sched.engine)
        d = words(fresh_sched.engine).dhcp
        pub = [np.asarray(a) for t in (d.sub, d.vlan, d.cid) for a in t]
        assert all(np.array_equal(h, q) for h, q in zip(host, pub))
        restored.append(words(fresh_sched.engine))
    assert_tuple_equal(restored[1], restored[0], "restored tables")


# ---------------------------------------------------------------------------
# sharded: same-N slot-exact, re-shard N -> M
# ---------------------------------------------------------------------------

def cluster(p, n: int):
    """A small cluster of package p with rows of every kind, placed by the
    cluster's own owner routing (the geometry of tests/test_torch_sharded.py)."""
    kw = {} if p is JAX else {"device": "cpu"}
    cl = p.Cluster(n, batch_per_shard=8, sub_nbuckets=64, vlan_nbuckets=64, cid_nbuckets=64,
                   nat_sessions_nbuckets=64, nat_ports_per_subscriber=256, qos_nbuckets=64,
                   spoof_nbuckets=64, pppoe_enabled=True, pppoe_nbuckets=64, edge_enabled=True,
                   edge_nbuckets=64, **kw)
    cl.add_pool_all(1, ip_to_u32("10.0.0.0"), 16, SERVER_IP, lease_time=3600)
    cl.set_server_config_all(SERVER_MAC, SERVER_IP)
    for i in range(24):
        ip = ip_to_u32("10.0.1.0") + i
        cl.add_subscriber(mac(i), pool_id=1, ip=ip, lease_expiry=NOW + 900)
        cl.allocate_nat(ip, NOW)
        cl.set_qos(ip, down_bps=8_000_000, up_bps=2_000_000)
        cl.add_spoof_binding(mac(i), ip, MODE_STRICT)
        if i % 5 == 0:
            cl.set_gardened(ip, True)
            cl.pppoe_session_up(Sess(0x100 + i, mac(i), ip))
            cl.arm_tap(ip, 3 + i, [(53, 17, 0)])
        if i % 3 == 0:
            cl.set_route(ip, b"\x02\x47\x57\x00\x00\x01", table_id=100 + i % 2)
    cl.add_vlan_subscriber(100, 7, pool_id=1, ip=ip_to_u32("10.0.2.1"), lease_expiry=NOW + 900)
    cl.add_circuit_id_subscriber(b"olt-1/7", pool_id=1, ip=ip_to_u32("10.0.2.2"),
                                 lease_expiry=NOW + 900)
    cl.allow_garden_destination(ip_to_u32("10.9.9.9"), 80, 6)
    cl.sync_tables()
    return cl


def host_state(cl) -> list:
    """Every shard's host arrays, in component order."""
    out = []
    for i in range(cl.n):
        for name, comp in sorted(cl.shard_components(i).items()):
            _, arrays = (comp.checkpoint_state() if hasattr(comp, "checkpoint_state")
                         else (None, {}))
            if name == "qos":
                arrays = {"up": comp.up.rows, "down": comp.down.rows}
            elif name == "antispoof":
                arrays = {**comp.bindings.checkpoint_arrays(), "r": comp.ranges,
                          "c": comp.config}
            elif name == "garden":
                arrays = {**comp.subscribers.checkpoint_arrays(), "a": comp.allowed}
            out += [(i, name, k, np.asarray(v).copy()) for k, v in sorted(arrays.items())]
        out.append((i, "nat.blocks", "", sorted(cl.nat[i].blocks)))
    return out


def same_state(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[:3] == y[:3]
        assert np.array_equal(np.asarray(x[3]), np.asarray(y[3])), x[:3]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_same_n_round_trip_is_slot_exact(n):
    got = []
    for p in PKGS:
        cl = cluster(p, n)
        ck = p.ck.build_sharded_checkpoint(cl, 3, float(NOW), node_id="sh")
        data = p.ck.encode_checkpoint(ck)
        twin = cl.clone_empty()
        rows = p.ck.restore_sharded_checkpoint(p.ck.decode_checkpoint(data), twin, now=NOW)
        same_state(host_state(twin), host_state(cl))
        got.append((data, rows, host_state(twin)))
    assert got[1][0] == got[0][0] and got[1][1] == got[0][1]
    same_state(got[1][2], got[0][2])


@pytest.mark.parametrize("src_n,dst_n", [(2, 4), (4, 2)])
def test_sharded_reshard_matches_reference(src_n, dst_n):
    got = []
    for p in PKGS:
        cl = cluster(p, src_n)
        ck = p.ck.decode_checkpoint(p.ck.encode_checkpoint(
            p.ck.build_sharded_checkpoint(cl, 3, float(NOW))))
        dst = cl.clone_empty(dst_n)
        rows = p.ck.restore_sharded_checkpoint(ck, dst, now=NOW)
        assert dst.n == dst_n and rows["resharded_to"] == dst_n
        got.append((rows, host_state(dst)))
    assert got[1][0] == got[0][0]
    assert got[1][0]["dhcp_rows"] == 26 and got[1][0]["nat_blocks"] == 24
    same_state(got[1][1], got[0][1])


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_sharded_and_single_snapshots_refuse_each_other(p):
    cl = cluster(p, 2)
    st = stack(p)
    single = p.ck.build_checkpoint(1, float(NOW), fastpath=st.fp)
    with pytest.raises(p.ck.CheckpointError, match="not a sharded checkpoint"):
        p.ck.restore_sharded_checkpoint(single, cl.clone_empty())
    sharded = p.ck.build_sharded_checkpoint(cl, 1, float(NOW))
    with pytest.raises(p.ck.CheckpointError, match="cannot hydrate a single-engine"):
        p.ck.restore_checkpoint(sharded, fastpath=st.fp)


@pytest.mark.parametrize("p", PKGS, ids=lambda p: p.name)
def test_sharded_reshard_into_a_too_small_target_refuses(p):
    """Two shards of three 16384-port blocks each hold four subscribers; one
    shard's three blocks cannot take them: the re-shard refuses, and the
    target keeps its empty state."""
    kw = {} if p is JAX else {"device": "cpu"}
    cl = p.Cluster(2, batch_per_shard=8, sub_nbuckets=64, nat_sessions_nbuckets=64,
                   nat_ports_per_subscriber=16384, qos_nbuckets=64, spoof_nbuckets=64, **kw)
    per = {0: [], 1: []}
    ip = ip_to_u32("10.0.3.0")
    while min(len(v) for v in per.values()) < 2:
        o = cl.affinity_shard_ip(ip)
        if len(per[o]) < 2:
            per[o].append(ip)
            assert cl.allocate_nat(ip, NOW)[1] is not None
        ip += 1
    ck = p.ck.build_sharded_checkpoint(cl, 1, float(NOW), quiesce=False)
    small = cl.clone_empty(1)
    with pytest.raises(p.ck.CheckpointError, match="does not fit"):
        p.ck.restore_sharded_checkpoint(ck, small, now=NOW)
    assert small.fastpath[0].sub.count == 0 and not small.nat[0].blocks
