"""PPPoE sessions bound to their QinQ access lines (`ops/pppoe.py`
PSF_LINE), held against the benchmark's plain reference
(`gpubench/reference/pppoe.py`, NumPy, RFC 2516 framing over 802.1ad
1:1 VLANs, CGNAT and QoS as the configuration states them).

On the CPU, at a small size of the `pppoe_qinq_64k` deployment (256
sessions over 2 S-tags, B = 64 lanes of L = 1,536 bytes, seeded):
- the engine's fused step over mixed batches of upstream session data,
  downstream data and LCP Echo-Requests: every verdict, every output
  frame's bytes and length, every NAT session word and both QoS tables'
  token words equal the reference's; the stats and the line counters
  count each lane;
- a session's data from another line (a C-tag or an S-tag off, one tag,
  none) is a miss: the frame keeps its bytes and PASSes, and counts as a
  line mismatch;
- line-bound and unbound sessions side by side: the bound ones as the
  reference frames them, the unbound ones byte for byte as an engine
  with no bound session gives them;
- the host tables: `bulk_sessions_up` with and without tags,
  `session_up` from a session's `vlans`, and a checkpoint of the 8-word
  rows restoring the tags;
- `NativeRing.rx_submit_batch` with one direction a frame holds what
  `rx_push` of each frame gives.

On a card (marker `card`; this file imports no JAX, so it runs there with
`python -m pytest --noconftest -m card tests/test_torch_pppoe_qinq.py`):
the ring program's replay is bit-equal to the eager fused step at
L = 1,536 with line-bound sessions.

Tolerance: exact (bytes, verdicts, table words).
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bng_tpu_torch.ops import pppoe as tp
from bng_tpu_torch.runtime.engine import Engine, _InFlight
from bng_tpu_torch.runtime.ring import FLAG_FROM_ACCESS, NativeRing
from bng_tpu_torch.runtime.tables import PPPoEFastPathTables
from gpubench import pppoe_check, pppoe_data
from gpubench.reference import pppoe as R
from gpubench.systems import pppoe_ring

pytestmark = pytest.mark.torch_port

BENCH = Path(__file__).resolve().parents[1] / "gpubench"
B, L = 64, 1536
SMALL = {"subscribers": 256, "flows": 1024, "c_tags_per_s_tag": 128, "batch": B,
         "table_stash": 64, "nat_public_addresses": 2}
NOW0 = 1753000060.0


def small_cfg(**over) -> dict:
    cfg = json.loads((BENCH / "configs" / "pppoe_qinq_64k.json").read_text())
    return dict(cfg, **SMALL, **over)


def small_mix() -> dict:
    return dict(json.loads((BENCH / "traffic" / "bidir_mtu.json").read_text()), pool_batches=4)


def stack(seed: int, device="cpu", bound=None):
    """(dataset, traffic, tables, engine) of the small deployment; `bound`
    [S] bool picks the sessions bound to their lines (default: all)."""
    ds = pppoe_data.build(small_cfg(), seed)
    traffic = pppoe_data.closed_loop(small_mix(), ds, B, seed, L)
    tables = pppoe_ring.build_tables(ds, {})
    if bound is not None:
        pp = tables["pppoe"] = PPPoEFastPathTables(nbuckets=pp_nb(ds), stash=64,
                                                   server_mac=ds.ac_mac.to_bytes(6, "big"))
        for sel, tags in ((bound, True), (~bound, False)):
            pp.bulk_sessions_up(ds.session_ids[sel], ds.sub_macs[sel],
                                ds.sub_ips[sel].astype(np.uint32),
                                *((ds.s_tags[sel], ds.c_tags[sel]) if tags else ()))
    eng = Engine(tables["fastpath"], tables["nat"], tables["qos"], tables["antispoof"],
                 pppoe=tables["pppoe"], batch_size=B, pkt_slot=L, device=device)
    return ds, traffic, tables, eng


def pp_nb(ds) -> int:
    return pppoe_ring.deploy.nbuckets_for(ds.n_sessions)


def run_batches(eng, traffic, n_batches: int, gap_s: float = 0.01):
    """Each batch of the pool through the engine's fused step in turn;
    returns [(g0, n, now, host outputs)]."""
    out = []
    for k in range(n_batches):
        g0 = k * B
        sl = slice(g0, g0 + B)
        now = NOW0 + gap_s * k
        fa = traffic.flags[sl] == FLAG_FROM_ACCESS
        res = eng.step(traffic.rows[sl].copy(), traffic.lens[sl].astype(np.uint32), fa, now)
        out.append((g0, B, now, {"verdict": res.verdict.numpy(), "out_pkt": res.out_pkt.numpy(),
                                 "out_len": res.out_len.numpy()}))
    return out


def judge(ref, traffic, eng, tables, ran) -> dict:
    """The cell's own comparison over batches run through `eng.step`: every
    FWD lane's output frame compared, every verdict, the table words."""
    batches = []
    for g0, n, now, h in ran:
        v = h["verdict"].astype(np.int8)
        fwd = np.nonzero(v == R.FWD)[0]
        batches.append({"g0": g0, "n": n, "now": now, "verdict": v, "extra": 0,
                        "out_pos": g0 + fwd, "out_verdict": v[fwd],
                        "out_rows": h["out_pkt"][fwd],
                        "out_lens": h["out_len"][fwd].astype(np.int64)})
    return pppoe_check.ring_checks(ref, traffic, batches, pppoe_check.read_tables(eng, tables))


@pytest.mark.parametrize("seed", [3, 2**33 + 7])
def test_fused_step_equals_the_reference(seed):
    ds, traffic, tables, eng = stack(seed)
    ran = run_batches(eng, traffic, 4)
    checks = judge(R.Reference(ds), traffic, eng, tables, ran)
    assert all(v == 0 for v, _ in checks.values()), checks
    kinds = traffic.kind[:4 * B]
    verdict = np.concatenate([h["verdict"] for *_, h in ran])
    # every kind and verdict the cell has is here: the test is not vacuous
    assert (verdict[kinds == R.KIND_LCP] == R.PASS).all()
    assert {R.FWD, R.DROP} <= set(verdict[kinds == R.KIND_DOWN].tolist())
    assert (verdict[kinds == R.KIND_UP] == R.FWD).any()
    n_up, n_down, n_lcp = ((kinds == k).sum() for k in (R.KIND_UP, R.KIND_DOWN, R.KIND_LCP))
    assert eng.stats.pppoe.tolist() == [n_up, n_down, n_lcp, 0, 0]
    assert eng.stats.pppoe_line.tolist() == [n_up, n_down, 0]


def off_line_frames(ds, refm, sessions):
    """Upstream data of each session from another line than its own: C-tag
    off by one, S-tag off by one, only the S-tag, untagged."""
    flows = sessions  # flow f of session f (f < sessions)
    rows, lens = refm.upstream_rows(flows, 110, L)
    c_off, s_off = rows.copy(), rows.copy()
    c_off[:, 18:20] = R.P.be(ds.c_tags[sessions] % 4094 + 1, 2)
    s_off[:, 14:16] = R.P.be(ds.s_tags[sessions] + 1, 2)
    one = np.zeros_like(rows)
    one[:, :16] = rows[:, :16]
    one[:, 16:L - 4] = rows[:, 20:L]  # the C-tag taken out
    bare = np.zeros_like(rows)
    bare[:, :12] = rows[:, :12]
    bare[:, 12:L - 8] = rows[:, 20:L]
    frames = np.concatenate([c_off, s_off, one, bare])
    flens = np.concatenate([lens, lens, lens - 4, lens - 8])
    return frames, flens


def test_a_frame_off_its_line_is_a_miss_and_passes():
    ds, traffic, tables, eng = stack(5)
    refm = R.Reference(ds)
    sessions = np.array([0, 1, 130, 255])
    frames, flens = off_line_frames(ds, refm, sessions)
    n = len(frames)
    pkt = np.zeros((B, L), dtype=np.uint8)
    pkt[:n] = frames
    length = np.zeros(B, dtype=np.uint32)
    length[:n] = flens
    fa = np.zeros(B, dtype=bool)
    fa[:n] = True
    res = eng.step(pkt, length, fa, NOW0)
    assert (res.verdict.numpy()[:n] == R.PASS).all()
    assert np.array_equal(res.out_pkt.numpy()[:n], pkt[:n])
    assert np.array_equal(res.out_len.numpy()[:n], flens)
    assert eng.stats.pppoe[tp.PST_MISS] == n and eng.stats.pppoe[tp.PST_DECAP] == 0
    # the untagged and single-tagged frames are off the line as much as the others
    assert eng.stats.pppoe_line.tolist() == [0, 0, n]
    # the same frames on the right line decap
    rows, lens = refm.upstream_rows(sessions, 110, L)
    pkt[:len(sessions)], length[:len(sessions)] = rows, lens
    res = eng.step(pkt, length, np.arange(B) < len(sessions), NOW0 + 1)
    assert (res.verdict.numpy()[:len(sessions)] == R.FWD).all()


def test_bound_and_unbound_sessions_side_by_side():
    seed = 9
    bound = np.arange(256) % 2 == 0
    ds, traffic, tables, eng = stack(seed, bound=bound)
    _, _, _, plain = stack(seed, bound=np.zeros(256, dtype=bool))
    ran, ran_plain = run_batches(eng, traffic, 3), run_batches(plain, traffic, 3)
    refm = R.Reference(ds)
    n_bound = 0
    for (g0, n, now, h), (_, _, _, hp) in zip(ran, ran_plain):
        q = np.arange(g0, g0 + n)
        k, ref = traffic.kind[q], traffic.ref[q]
        sess = np.where(k == R.KIND_LCP, ref, ds.flow_session[np.where(k == R.KIND_LCP, 0, ref)])
        data_bound = bound[sess] & (k != R.KIND_LCP)
        # unbound: exactly what an engine with no bound session gives
        for f in ("verdict", "out_len"):
            assert np.array_equal(h[f][~data_bound], hp[f][~data_bound]), f
        assert np.array_equal(h["out_pkt"][~data_bound], hp["out_pkt"][~data_bound])
        # bound and forwarded: the reference's frames
        fwd = data_bound & (h["verdict"] == R.FWD)
        rows, lens = refm.expected_rows(k[fwd], ref[fwd], traffic.lens[q][fwd],
                                        h["verdict"][fwd].astype(np.int8), L)
        assert np.array_equal(h["out_len"][fwd], lens)
        live = np.arange(L)[None, :] < lens[:, None]
        assert ((h["out_pkt"][fwd] == rows) | ~live).all()
        n_bound += int(fwd.sum())
    assert n_bound > 0
    # unbound upstream data keeps its tags: the frame is 8 bytes longer
    up = (traffic.kind[:3 * B] == R.KIND_UP) & ~bound[ds.flow_session[traffic.ref[:3 * B]]]
    v = np.concatenate([h["verdict"] for *_, h in ran])
    lens = np.concatenate([h["out_len"] for *_, h in ran])
    assert (lens[up & (v == R.FWD)] == 110 - 8).all()
    assert eng.stats.pppoe_line[tp.PSL_STRIPPED] < eng.stats.pppoe[tp.PST_DECAP]


def test_bulk_sessions_up_binds_lines_when_tags_are_given():
    t = PPPoEFastPathTables(nbuckets=64, stash=8)
    t.bulk_sessions_up([1, 2], [0x02BB00000001, 0x02BB00000002], [0x64400001, 0x64400002],
                       s_tags=[101, 102], c_tags=[0x1005, 7])  # the VID is the low 12 bits
    t.bulk_sessions_up([3], [0x02BB00000003], [0x64400003])
    rows = {int(k[0]): v for k, v, u in zip(t.by_sid.keys, t.by_sid.vals, t.by_sid.used) if u}
    assert rows[1][[tp.PS_FLAGS, tp.PS_S_TAG, tp.PS_C_TAG]].tolist() == [tp.PSF_LINE, 101, 5]
    assert rows[2][[tp.PS_FLAGS, tp.PS_S_TAG, tp.PS_C_TAG]].tolist() == [tp.PSF_LINE, 102, 7]
    assert rows[3][[tp.PS_FLAGS, tp.PS_S_TAG, tp.PS_C_TAG]].tolist() == [0, 0, 0]
    with pytest.raises(ValueError):
        t.bulk_sessions_up([4], [0x02BB00000004], [0x64400004], s_tags=[101])


@pytest.mark.parametrize("vlans,want", [([101, 42], [tp.PSF_LINE, 101, 42]), ([7], [0, 0, 0]),
                                        ([], [0, 0, 0]), (None, [0, 0, 0])])
def test_session_up_binds_a_qinq_line_only(vlans, want):
    t = PPPoEFastPathTables(nbuckets=64, stash=8)
    sess = SimpleNamespace(session_id=9, client_mac=bytes.fromhex("02cc00000009"),
                           assigned_ip=0x64400009)
    if vlans is not None:
        sess.vlans = vlans
    t.session_up(sess)
    for table in (t.by_sid, t.by_ip):
        row = table.vals[np.nonzero(table.used)[0][0]]
        assert row[[tp.PS_FLAGS, tp.PS_S_TAG, tp.PS_C_TAG]].tolist() == want


def test_checkpoint_restores_the_line_tags():
    from bng_tpu_torch.runtime import checkpoint as ck

    ds = pppoe_data.build(small_cfg(), 11)
    src = pppoe_ring.build_tables(ds, {})
    data = ck.encode_checkpoint(ck.build_checkpoint(1, NOW0, fastpath=src["fastpath"],
                                                    nat=src["nat"], pppoe=src["pppoe"]))
    dst = pppoe_ring.build_tables(ds, {})
    dst["pppoe"] = PPPoEFastPathTables(nbuckets=pp_nb(ds), stash=64)  # no session
    ck.restore_checkpoint(ck.decode_checkpoint(data), fastpath=dst["fastpath"], nat=dst["nat"],
                          pppoe=dst["pppoe"])
    for name in ("by_sid", "by_ip"):
        a, b = getattr(src["pppoe"], name), getattr(dst["pppoe"], name)
        assert np.array_equal(a.vals, b.vals) and np.array_equal(a.used, b.used)
    live = dst["pppoe"].by_sid.vals[dst["pppoe"].by_sid.used != 0]
    assert len(live) == 256 and (live[:, tp.PS_FLAGS] == tp.PSF_LINE).all()
    assert set(live[:, tp.PS_S_TAG].tolist()) == {101, 102}
    # the restored rows serve: a session's data decaps from its line only
    eng = Engine(dst["fastpath"], dst["nat"], pppoe=dst["pppoe"], batch_size=B, pkt_slot=L,
                 device="cpu")
    refm = R.Reference(ds)
    rows, lens = refm.upstream_rows(np.array([0, 200]), 110, L)
    frames, flens = off_line_frames(ds, refm, np.array([0, 200]))
    pkt = np.zeros((B, L), dtype=np.uint8)
    length = np.zeros(B, dtype=np.uint32)
    pkt[:2], length[:2] = rows, lens
    pkt[2:4], length[2:4] = frames[:2], flens[:2]
    eng.step(pkt, length, np.arange(B) < 4, NOW0)
    assert eng.stats.pppoe_line.tolist() == [2, 0, 2]


def test_per_frame_directions_match_rx_push():
    """A batch submit with one direction a frame (DISCOVERs and data from
    both sides, one shard and four) holds what rx_push of each gives."""
    from bng_tpu_torch import frames as F

    ds = pppoe_data.build(small_cfg(), 13)
    refm = R.Reference(ds)
    up, ul = refm.upstream_rows(np.arange(6), 110, L)
    down, dl = refm.downstream_rows(np.arange(6), 1506, L)
    frames = [bytes(r[:n]) for r, n in zip(np.concatenate([up, down]), np.concatenate([ul, dl]))]
    frames += [F.discover_frame(bytes([2, 0, 0, 0, 0, i]), 0x100 + i) for i in range(4)]
    rng = np.random.default_rng(13)
    order = rng.permutation(len(frames))
    frames = [frames[i] for i in order]
    fa = rng.integers(0, 2, len(frames)).astype(bool)
    for shards in (1, 4):
        pushed, batched = NativeRing(64, 2048, 32, shards), NativeRing(64, 2048, 32, shards)
        for f, a in zip(frames, fa):
            assert pushed.rx_push(f, from_access=bool(a))
        addrs = np.zeros(len(frames), dtype=np.uint64)
        assert batched.rx_reserve_batch(addrs) == len(frames)
        umem = batched.umem_view()
        for ad, f in zip(addrs, frames):
            umem[int(ad):int(ad) + len(f)] = np.frombuffer(f, dtype=np.uint8)
        ok = np.zeros(len(frames), dtype=np.uint8)
        lens = np.array([len(f) for f in frames], dtype=np.uint32)
        flags = np.where(fa, FLAG_FROM_ACCESS, 0).astype(np.uint32)
        assert batched.rx_submit_batch(addrs, lens, flags, ok, len(frames)) == len(frames)
        assert ok.all() and batched.stats() == pushed.stats()
        got = []
        for ring in (pushed, batched):
            out = (np.zeros((32, 2048), np.uint8), np.zeros(32, np.uint32), np.zeros(32, np.uint32))
            n = (ring.assemble_sharded if shards > 1 else ring.assemble)(*out)
            got.append((n, *out))
        assert got[0][0] > 0
        for a, b in zip(got[0], got[1]):
            assert np.array_equal(a, b)


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", torch.cuda.current_device())


def _tensors(t, path="tables"):
    if isinstance(t, torch.Tensor):
        yield path, t
    elif t is not None:
        for f in t._fields:
            yield from _tensors(getattr(t, f), f"{path}.{f}")


def _snapshot(eng) -> dict:
    return {k: v.to("cpu", copy=True) for k, v in _tensors(eng.tables)}


@pytest.mark.card
def test_replay_equals_the_eager_step_with_line_bound_sessions(card):
    ds, traffic, _, eng = stack(17, device=card)
    _, _, _, ref = stack(17, device=card)
    ref._replay_ring = False

    def flight(e, k):
        sl = slice(k * B, (k + 1) * B)
        return _InFlight(e._dispatch_ring_batch(traffic.rows[sl].copy(),
                                                traffic.lens[sl].astype(np.uint32),
                                                traffic.flags[sl], B, NOW0 + 0.01 * k))

    flights = [flight(eng, k) for k in range(4)]  # the pipelined order
    for k, fl in enumerate(flights):
        got, want = eng._wait(fl), ref._wait(flight(ref, k))
        assert got.keys() == want.keys()
        for name in want:
            assert np.array_equal(got[name], want[name]), (k, name)
    torch.cuda.synchronize()
    a, b = _snapshot(eng), _snapshot(ref)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert eng.ring_replays == 4 and ref.ring_eager == 4
    assert eng.stats.pppoe_line.tolist() == ref.stats.pppoe_line.tolist()
    assert eng.stats.pppoe_line[tp.PSL_STRIPPED] > 0 and eng.stats.pppoe_line[tp.PSL_WRITTEN] > 0
