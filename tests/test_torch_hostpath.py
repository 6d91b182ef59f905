"""The port's vector host path against the JAX package's.

- Every numpy kernel of `bng_tpu_torch/runtime/hostpath.py` (classify,
  shard steering at 1, 2 and 4 shards, the BOOTP offset, the DHCP peek,
  FNV-1a32, the ragged pack) is bit-identical to the reference's and to
  the scalar oracles over the corpus of
  tests/test_hostpath.py::TestKernelIdentity (runts, truncated headers,
  QinQ, PPPoE LCP/IPCP, relayed giaddr, fragments, junk).
- `StagingPool` clears the stale rows of a reused buffer, `ensure_depth`
  widens the cycle, and an upload never aliases the staged buffer.
- `Engine._pack_frames` stages the same bytes under both host paths.
- `ExpressWireTemplate.render_batch` equals the per-frame render (and the
  reference's render) on the groups of TestRenderBatchIdentity, and a
  scheduler's express replies are the same bytes under
  `BNG_HOST_PATH=vector` and `scalar`, and the reference scheduler's.

Tolerance: bit-exact.
"""

import numpy as np
import pytest

from bng_tpu.control.admission import peek_dhcp
from bng_tpu.control.dhcp_codec import ExpressWireTemplate as JTemplate
from bng_tpu.runtime import hostpath as j_hp
from bng_tpu.runtime.ring import shard_of as j_shard_of
from bng_tpu_torch import frames as F
from bng_tpu_torch.control.dhcp_codec import ACK, ExpressWireTemplate
from bng_tpu_torch.control.nat import NATManager
from bng_tpu_torch.ops.express import parse_express
from bng_tpu_torch.runtime import hostpath as t_hp
from bng_tpu_torch.runtime.engine import Engine
from bng_tpu_torch.runtime.ring import FLAG_FROM_ACCESS, classify_dhcp, shard_of
from bng_tpu_torch.runtime.tables import FastPathTables
from bng_tpu_torch.utils.net import fnv1a32

from test_hostpath import CORPUS, PUB_IPS, _discover
from test_torch_scheduler import JAX, PORT, build_stack, dhcp, mac

pytestmark = pytest.mark.torch_port


def _packed():
    buf, lens = t_hp.pack_rows(CORPUS)
    jbuf, jlens = j_hp.pack_rows(CORPUS)
    assert np.array_equal(buf, jbuf) and np.array_equal(lens, jlens)
    return buf, lens.astype(np.int64)


def test_classify_bootp_peek_fnv_match_reference():
    buf, lens = _packed()
    got = t_hp.classify_dhcp_batch(buf, lens)
    assert np.array_equal(got, j_hp.classify_dhcp_batch(buf, lens))
    assert got.tolist() == [classify_dhcp(f) for f in CORPUS]
    for a, b in zip(t_hp.bootp_off_batch(buf, lens), j_hp.bootp_off_batch(buf, lens)):
        assert np.array_equal(a, b)
    msg, macs, parsed = t_hp.peek_dhcp_batch(buf, lens)
    for a, b in zip((msg, macs, parsed), j_hp.peek_dhcp_batch(buf, lens)):
        assert np.array_equal(a, b)
    for i, f in enumerate(CORPUS):
        sp = peek_dhcp(f)
        assert bool(parsed[i]) == (sp is not None)
        if sp is not None:
            assert (int(msg[i]), int(macs[i])) == sp
    rows = np.frombuffer(b"".join(f[:6].ljust(6, b"\0") for f in CORPUS if f),
                         dtype=np.uint8).reshape(-1, 6)
    h = t_hp.fnv1a32_cols(rows)
    assert np.array_equal(h, j_hp.fnv1a32_cols(rows))
    assert h.tolist() == [fnv1a32(r.tobytes()) for r in rows]
    assert parsed.sum() > 50 and (got != 0).sum() > 30  # the corpus reaches every branch


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("from_access", [True, False])
def test_shard_of_matches_reference(n_shards, from_access):
    buf, lens = _packed()
    fl = np.full(len(CORPUS), FLAG_FROM_ACCESS if from_access else 0, np.uint32)
    if from_access:
        fl |= t_hp.classify_dhcp_batch(buf, lens)
    keys = np.sort(np.fromiter(PUB_IPS.keys(), dtype=np.uint64))
    vals = np.array([PUB_IPS[int(k)] for k in keys], dtype=np.int64)
    got = t_hp.shard_of_batch(buf, lens, fl, n_shards, keys, vals)
    assert np.array_equal(got, j_hp.shard_of_batch(buf, lens, fl, n_shards, keys, vals))
    for i, f in enumerate(CORPUS):
        want = j_shard_of(f, int(fl[i]), n_shards, PUB_IPS)
        assert int(got[i]) == shard_of(f, int(fl[i]), n_shards, PUB_IPS) == want, i


def test_pack_rejects_oversize_and_roundtrips():
    with pytest.raises(ValueError, match="exceeds staging slot"):
        t_hp.pack_into([b"x" * 17, b"y"], np.zeros((2, 16), np.uint8), np.zeros(2, np.int64))
    frames = [f for f in CORPUS if f]
    buf, lens = t_hp.pack_rows(frames)
    for i, f in enumerate(frames):
        assert buf[i, : len(f)].tobytes() == f and not buf[i, len(f):].any()


def test_staging_pool_clears_stale_rows_and_grows():
    pool = t_hp.StagingPool(16, depth=2)
    for _ in range(2):  # cycle the whole pool with 3-row batches
        pool.stage([b"aaaa", b"bbbb", b"cccc"], 8)
    pkt, length = pool.stage([b"zz"], 8)
    assert length[0] == 2 and not pkt[1:].any() and not length[1:].any()

    pool = t_hp.StagingPool(8, depth=2)
    a, _ = pool.stage([b"a"], 4)
    pool.ensure_depth(5)
    assert pool.depth == 5
    seen = [pool.stage([b"x"], 4)[0] for _ in range(4)]
    assert all(x is not a for x in seen)  # 4 distinct successors
    b, _ = pool.stage([b"y"], 4)
    assert b is a  # back only after depth = 5 hand-outs
    pool.ensure_depth(3)  # never shrinks
    assert pool.depth == 5

    up = pool.upload(b)
    assert up is not None and up.numpy()[0, 0] == ord("y")
    b[0, 0] = 0  # the upload is a copy
    assert up.numpy()[0, 0] == ord("y")
    assert pool.upload(np.zeros((4, 8), np.uint8)) is None and pool.waits == 0


def test_engine_pack_frames_identical_under_both_paths(monkeypatch):
    engines = {}
    for hp in ("scalar", "vector"):
        monkeypatch.setattr(t_hp, "HOST_PATH", hp)
        fp = FastPathTables(sub_nbuckets=1 << 8, vlan_nbuckets=1 << 6, cid_nbuckets=1 << 6)
        engines[hp] = Engine(fp, NATManager(public_ips=[0xCB007101]), batch_size=32,
                             pkt_slot=256, device="cpu")
        assert engines[hp].host_path == hp
    frames = [f for f in CORPUS if 0 < len(f) <= 256][:30]
    for part in (frames, frames[:3]):  # the second reuses a pooled buffer
        a = engines["scalar"]._pack_frames(part, 32)
        b = engines["vector"]._pack_frames(part, 32)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    for eng in engines.values():
        with pytest.raises(ValueError, match="pkt_slot"):
            eng._pack_frames([b"x" * 300], 32)


@pytest.mark.parametrize("relayed,use_bcast,tags", [
    (False, True, ()), (False, False, ()), (True, False, ()),
    (False, True, [(0x8100, 12)]), (False, False, [(0x88A8, 3), (0x8100, 9)]),
])
def test_render_batch_groups(relayed, use_bcast, tags):
    rng = np.random.default_rng(11)
    kw = dict(server_mac=b"\x02\xaa\xbb\xcc\xdd\x01", server_ip=0x0A000001, gateway=0x0A000001,
              dns1=0x01010101, dns2=0x08080808, lease_t=3600, mask=0xFFFF0000, reply_type=ACK)
    tmpl, jtmpl = ExpressWireTemplate(**kw), JTemplate(**kw)
    frames = [_discover(rng, b"\x02" + bytes(int(x) for x in rng.integers(0, 255, 5)),
                        relayed=relayed, tags=list(tags), bcast=use_bcast) for _ in range(17)]
    descs = [parse_express(f) for f in frames]
    assert all(d is not None for d in descs)
    d0 = descs[0]
    yiaddrs = rng.integers(1, 1 << 32, len(frames)).astype(np.uint32)
    want = [jtmpl.render(f, d.vlan_off, d.dhcp_off, relayed, use_bcast, int(y))
            for f, d, y in zip(frames, descs, yiaddrs)]
    assert [tmpl.render(f, d.vlan_off, d.dhcp_off, relayed, use_bcast, int(y))
            for f, d, y in zip(frames, descs, yiaddrs)] == want
    fmat, _ = t_hp.pack_rows(frames)
    assert tmpl.render_batch(fmat, d0.vlan_off, d0.dhcp_off, relayed, use_bcast, yiaddrs) == want


def test_scheduler_replies_identical_under_both_paths(monkeypatch):
    """Express replies of a mixed burst (cached, VLAN-less, broadcast and
    unicast, a newcomer to the slow path), rendered in groups under the
    vector path and per frame under the scalar one, and by the reference."""
    from test_torch_scheduler import FakeClock

    frames = [dhcp(mac(i % 4), F.DISCOVER, 0x100 + i, broadcast=bool(i % 2)) for i in range(12)]
    frames += [dhcp(mac(i % 4), F.REQUEST, 0x200 + i) for i in range(5)]
    frames.append(dhcp(mac(0x33), F.DISCOVER, 0x300))
    outs = {}
    for name, mods, hp in (("jax", JAX, "scalar"), ("scalar", PORT, "scalar"),
                           ("vector", PORT, "vector")):
        monkeypatch.setattr(t_hp, "HOST_PATH", hp)
        sched, _, _ = build_stack(mods, FakeClock())
        if mods is PORT:
            assert sched._vec == (hp == "vector") and sched.engine.host_path == hp
        outs[name] = sched.process(frames, now=1_700_000_000.0)
    assert outs["vector"] == outs["scalar"] == outs["jax"]
    assert len(outs["vector"]["tx"]) == 17 and dict(outs["vector"]["slow"])[17] is not None
