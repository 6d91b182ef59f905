"""The port's packet ring and the engine's other ways in against the JAX
package.

- `classify_dhcp` and `PyRing` against the JAX `PyRing(host_path="scalar")`:
  the same pushes, assembles, completes, injects and pops give the same
  frames, flags, pending counts and stats.
- Over the corpus of tests/test_hostpath.py (runts, truncated headers,
  QinQ, PPPoE LCP/IPCP, relayed giaddr, fragments, junk), `classify_dhcp`,
  `shard_of` at 1, 2 and 4 shards, the admission `peek_dhcp` and
  `fnv1a32` give the reference's answers frame by frame.
- The JAX `Engine` and the port's `Engine(device="cpu")`, both with every
  stage (PPPoE, walled garden, taps, routes) and built by the same host
  calls, give identical output and tables from `process_dhcp` (a DORA
  whose DISCOVER goes to the slow path and whose REQUEST is answered on
  the device once the lease is cached, and a renewal), `process_ring` and
  `process_ring_pipelined` (a punted-then-forwarded flow, one of them
  arriving as PPPoE, a QoS drop, a garden drop, mirror-sink calls and an
  all-control batch on the DHCP-only program).

Tolerance: bit-exact (the same bytes, counts and table words).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest

from bng_tpu.control.admission import peek_dhcp as j_peek_dhcp
from bng_tpu.runtime.engine import Engine as JEngine
from bng_tpu.runtime.ring import PyRing as JRing
from bng_tpu.runtime.ring import classify_dhcp as j_classify
from bng_tpu.runtime.ring import shard_of as j_shard_of
from bng_tpu.utils.net import fnv1a32 as j_fnv1a32
from bng_tpu_torch import convert
from bng_tpu_torch import frames as F
from bng_tpu_torch.control.admission import peek_dhcp
from bng_tpu_torch.ops.nat44 import SV_NAT_IP, SV_NAT_PORT
from bng_tpu_torch.runtime.engine import Engine as TEngine
from bng_tpu_torch.runtime.ring import FLAG_FROM_ACCESS, shard_of
from bng_tpu_torch.runtime.ring import PyRing as TRing
from bng_tpu_torch.runtime.ring import classify_dhcp as t_classify
from bng_tpu_torch.utils.net import fnv1a32, ip_to_u32

from test_hostpath import CORPUS, PUB_IPS
from test_torch_entry import JAX_FULL, PORT_FULL, SESSIONS, deploy_full, full_batch
from test_torch_stages import NOW, REMOTE, assert_tuple_equal, mac

pytestmark = pytest.mark.torch_port

B, L = 48, 512


def classify_corpus():
    m = mac(0x21)
    disc = F.discover_frame(m, 0x11)
    reply = bytearray(disc)
    reply[42] = 2  # BOOTREPLY
    bad_magic = bytearray(disc)
    bad_magic[42 + 236] ^= 0xFF
    frag = bytearray(disc)
    frag[20] = 0x20  # more-fragments
    other_port = F.udp_packet(m, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 68, bytes(300))
    three_tags = F.eth_header(b"\xff" * 6, m, 0x8100, [5]) + disc[12:]
    return [disc, F.discover_frame(m, 0x12, vlans=[7]), F.discover_frame(m, 0x13, vlans=[7, 8]),
            F.discover_frame(m, 0x14, msg_type=F.REQUEST), bytes(reply), bytes(bad_magic),
            bytes(frag), other_port, disc[:200], disc[:13], three_tags,
            F.tcp_packet(m, m, 1, 2, 3, 67, b"x" * 300), m + m + b"\x86\xdd" + bytes(300)]


def test_classify_dhcp_matches_reference():
    flags = [t_classify(f) for f in classify_corpus()]
    assert flags == [j_classify(f) for f in classify_corpus()]
    assert flags[:4] == [2, 2, 2, 2] and sum(flags) == 8


def test_pyring_matches_reference():
    rings = (JRing(nframes=24, frame_size=400, depth=16, host_path="scalar"),
             TRing(nframes=24, frame_size=400, depth=16))
    rng = np.random.default_rng(3)
    corpus = classify_corpus() + [bytes(401)]  # one over frame_size: bad_desc
    got = [[], []]
    windows = [[], []]  # sizes of each ring's open assemble windows, oldest first
    for step in range(6):
        frames = [corpus[int(i)] for i in rng.integers(len(corpus), size=12)]
        fa = bool(step % 2)
        verdict = rng.integers(0, 4, size=8).astype(np.uint8)
        out = rng.integers(0, 256, size=(8, 64), dtype=np.uint8)
        out_len = rng.integers(0, 65, size=8).astype(np.uint32)
        for k, r in enumerate(rings):
            rec = got[k]
            rec.append(r.rx_push_batch(frames[:6], from_access=fa))
            rec.append([r.rx_push(f, from_access=not fa) for f in frames[6:]])
            pkt = np.zeros((8, 300), dtype=np.uint8)
            ln = np.zeros(8, dtype=np.int64)
            fl = np.zeros(8, dtype=np.int64)
            n = r.assemble(pkt, ln, fl)
            rec.append((n, pkt.tobytes(), ln.tolist(), fl.tolist()))
            if n:
                windows[k].append(n)
            if step != 2:  # step 2 leaves its window open: two in flight at step 3
                while windows[k]:
                    r.complete(verdict, out, out_len, windows[k].pop(0))
            rec.append(r.tx_inject(bytes(30 + step), from_access=fa))
            rec.append([r.tx_pop(), r.fwd_pop(), r.slow_pop(), r.slow_pop()])
            rec.append((r.rx_pending(), r.tx_pending(), r.fwd_pending(), r.slow_pending(),
                        r.free_frames(), r.stats()))
    assert got[0] == got[1]
    stats = got[1][-1][-1]
    assert stats["bad_desc"] and stats["fill_empty"] and stats["drop"] and stats["slow"]


def test_classify_bootp_peek_fnv_match_reference():
    flags = [t_classify(f) for f in CORPUS]
    assert flags == [j_classify(f) for f in CORPUS]
    peeks = [peek_dhcp(f) for f in CORPUS]
    assert peeks == [j_peek_dhcp(f) for f in CORPUS]
    keys = [f[:6].ljust(6, b"\0") for f in CORPUS if f]
    assert [fnv1a32(k) for k in keys] == [j_fnv1a32(k) for k in keys]
    # the corpus reaches every branch
    assert sum(p is not None for p in peeks) > 50 and sum(x != 0 for x in flags) > 30


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("from_access", [True, False])
def test_shard_of_matches_reference(n_shards, from_access):
    for i, f in enumerate(CORPUS):
        fl = (FLAG_FROM_ACCESS | t_classify(f)) if from_access else 0
        assert shard_of(f, fl, n_shards, PUB_IPS) == j_shard_of(f, fl, n_shards, PUB_IPS), i


def test_dhcp_batch_buckets_match_reference():
    for n in (0, 1, 63, 64, 65, 100, 1000, 4097, 8192, 9000):
        assert TEngine.dhcp_batch_bucket(n) == JEngine.dhcp_batch_bucket(n)


def _slow_path(frame: bytes):
    """A stand-in slow path: answers DHCP requests with a marker frame."""
    if t_classify(frame):
        return b"\x02" * 6 + frame[6:12] + b"\x08\x00" + b"slow-reply" + frame[-8:]
    return None


def _engines():
    """(jax engine, port engine, their deployments, their sink records)."""
    jd, td = deploy_full(JAX_FULL), deploy_full(PORT_FULL)
    rec = SimpleNamespace(jax=[], port=[])
    kw = dict(batch_size=B, pkt_slot=L, slow_path=_slow_path)
    jeng = JEngine(jd.fp, jd.nat, jd.qos, jd.spoof, jd.garden, jd.pppoe, edge=jd.edge,
                   mirror_sink=lambda *a: rec.jax.append(("mirror",) + a),
                   violation_sink=lambda *a: rec.jax.append(("viol",) + a), **kw)
    teng = TEngine(td.fp, td.nat, td.qos, td.spoof, td.garden, td.pppoe, edge=td.edge,
                   mirror_sink=lambda *a: rec.port.append(("mirror",) + a),
                   violation_sink=lambda *a: rec.port.append(("viol",) + a), device="cpu", **kw)
    return jeng, teng, jd, td, rec


def _assert_engines_equal(jeng, teng):
    for f in ("dhcp", "nat", "qos", "spoof", "garden", "pppoe", "edge"):
        assert np.array_equal(getattr(teng.stats, f), getattr(jeng.stats, f)), f
    for f in ("batches", "tx", "fwd", "dropped", "passed", "slow_errors"):
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    jt = jax.tree_util.tree_map(lambda a: np.array(a), jeng.tables)
    assert_tuple_equal(convert.tables_to_numpy(teng.tables), jt, "engine tables")
    assert teng.pending_dirty() == 0


def test_process_dhcp_dora_and_renewal():
    jeng, teng, jd, td, _ = _engines()
    newcomer = mac(0x31)
    b1 = [F.discover_frame(newcomer, 0x501), F.discover_frame(mac(1), 0x502),
          F.udp_packet(mac(0x10), b"\x04" * 6, ip_to_u32("10.0.0.10"), ip_to_u32(REMOTE),
                       5, 6, b"not dhcp")]
    outs = [(jeng.process_dhcp(b1, now=NOW + 1), teng.process_dhcp(b1, now=NOW + 1))]
    # the slow path leases the newcomer an address and caches it
    for d in (jd, td):
        d.fp.add_subscriber(newcomer, pool_id=1, ip=ip_to_u32("10.0.0.40"), lease_expiry=NOW + 600)
    renew = F.build_request(mac(1), F.REQUEST, xid=0x504, ciaddr=ip_to_u32("10.0.0.21"))
    renew.options.append((F.OPT_PARAM_REQ_LIST, bytes([1, 3, 6])))
    b2 = [F.discover_frame(newcomer, 0x503, msg_type=F.REQUEST),
          F.udp_packet(mac(1), b"\xff" * 6, ip_to_u32("10.0.0.21"), ip_to_u32("10.0.0.1"), 68, 67,
                       renew.encode().ljust(300, b"\x00"))]
    outs.append((jeng.process_dhcp(b2, now=NOW + 2), teng.process_dhcp(b2, now=NOW + 2)))
    for jo, to in outs:
        assert to == jo
    (o1, _), (o2, _) = outs
    assert [i for i, _ in o1["tx"]] == [1]  # cached client answered on the device
    assert [(i, r is not None) for i, r in o1["slow"]] == [(0, True), (2, False)]
    assert [i for i, _ in o2["tx"]] == [0, 1]  # REQUEST acked once cached; renewal acked
    acks = [F.decode_dhcp(F.decode(f).payload) for _, f in o2["tx"]]
    assert [a.msg_type for a in acks] == [F.ACK, F.ACK]
    assert acks[0].yiaddr == ip_to_u32("10.0.0.40")
    _assert_engines_equal(jeng, teng)


def _ring_batches(d):
    """Three ring batches: the full-stack mix, an all-control batch, the mix again
    (its punted flows, one of them PPPoE, now forward)."""
    frames, fa = full_batch(d)
    ctrl = [F.discover_frame(mac(k), 0x600 + k) for k in (1, 2, 3, 7)]
    return [list(zip(frames, fa)), [(f, True) for f in ctrl], list(zip(frames, fa))]


def _push(ring, batch):
    for f, fa in batch:
        assert ring.rx_push(f, from_access=fa)


def _drain(ring):
    out = {"tx": [], "fwd": []}
    for k, pop in (("tx", ring.tx_pop), ("fwd", ring.fwd_pop)):
        while (got := pop()) is not None:
            out[k].append(got)
    out["stats"] = ring.stats()
    out["slow_pending"] = ring.slow_pending()
    return out


@pytest.mark.parametrize("loop", ["sync", "pipelined"])
def test_ring_loops_full_stack(loop):
    jeng, teng, jd, td, rec = _engines()
    rings = (JRing(nframes=256, frame_size=L, depth=128, host_path="scalar"),
             TRing(nframes=256, frame_size=L, depth=128))
    drains = ([], [])
    for k, batch in enumerate(_ring_batches(td)):
        now = NOW + 1 + k
        for eng, ring, dr in ((jeng, rings[0], drains[0]), (teng, rings[1], drains[1])):
            _push(ring, batch)
            if loop == "sync":
                n = eng.process_ring(ring, now=now)
            else:
                n = eng.process_ring_pipelined(ring, now=now)
            dr.append((n, _drain(ring)))
    for eng, ring, dr in ((jeng, rings[0], drains[0]), (teng, rings[1], drains[1])):
        dr.append((eng.flush_pipeline(), _drain(ring)))
    assert drains[1] == drains[0]
    assert rec.port == rec.jax
    _assert_engines_equal(jeng, teng)

    # what the batches exercised (the same on both engines)
    assert any(v == "mirror" for v, *_ in rec.port)
    assert teng.stats.garden[0] > 0 and teng.stats.pppoe[0] > 0 and teng.stats.pppoe[1] > 0
    assert teng.stats.dropped > 0 and teng.stats.qos.any() and teng.stats.edge[2] > 0
    out = [d for _, d in drains[1]]
    first, third = (out[0], out[2]) if loop == "sync" else (out[1], out[3])

    def fwd_from(d, ip):
        return [p for p in (F.decode(f) for f, _ in d["fwd"]) if p.src_ip == ip]

    # the new PPPoE flow of the unrouted session is punted on the first
    # batch and leaves SNAT'd on the third (a routed lane that misses NAT
    # forwards un-NAT'd and is never punted, in both packages)
    (_, _, routed), (_, _, unrouted) = SESSIONS
    assert [p.src_port for p in fwd_from(first, routed)] == []
    row = td.nat.sessions.lookup(td.nat._key(unrouted, ip_to_u32(REMOTE), 6001, 53, 17))
    assert row is not None and fwd_from(first, unrouted) == fwd_from(third, unrouted) == []
    snat = fwd_from(third, int(row[SV_NAT_IP]))
    assert int(row[SV_NAT_PORT]) in [p.src_port for p in snat]
    assert int(row[SV_NAT_PORT]) not in [p.src_port for p in fwd_from(first, int(row[SV_NAT_IP]))]
    assert any(f.startswith(b"\x02" * 6) for d in out for f, _ in d["tx"])  # slow replies
