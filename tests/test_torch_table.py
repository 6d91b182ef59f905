"""The port's cuckoo tables against the JAX package: host mirrors built by
the same insert/delete sequence are byte-equal, K1's plain version equals
`xla_lookup`, the Pallas probe (interpret mode) and the host mirror over
every table geometry of tests/test_pallas_table.py, and the in-place
update scatters park out-of-range rows exactly like JAX's mode="drop"."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from bng_tpu.ops import qtable as jq
from bng_tpu.ops import table as jt
from bng_tpu.ops.pallas_table import pallas_probe
from bng_tpu_torch import kernel_cases
from bng_tpu_torch.ops import qtable as tq
from bng_tpu_torch.ops import table as tt
from bng_tpu_torch.ops.probe import probe, probe_plain

from test_torch_words import bits

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")


def build_pair(nbuckets, K, V, stash, n_entries, seed, deletes=0):
    """The same insert (and delete) sequence into both host mirrors."""
    rng = np.random.default_rng(seed)
    jtab = jt.HostTable(nbuckets, K, V, stash=stash, name="t")
    ttab = tt.HostTable(nbuckets, K, V, stash=stash, name="t")
    keys = np.unique(rng.integers(0, 2**32, size=(n_entries, K), dtype=np.uint32), axis=0)
    vals = rng.integers(0, 2**32, size=(len(keys), V), dtype=np.uint32)
    for i in range(len(keys)):
        assert jtab.insert(keys[i], vals[i]) == ttab.insert(keys[i], vals[i])
    for i in range(min(deletes, len(keys))):
        assert jtab.delete(keys[i]) == ttab.delete(keys[i])
    return jtab, ttab, keys[deletes:]


def query_mix(keys, K, B, seed, miss_frac=0.3):
    rng = np.random.default_rng(seed + 1)
    q = keys[rng.integers(0, len(keys), B)].copy() if len(keys) else np.zeros((B, K), np.uint32)
    miss = rng.random(B) < miss_frac
    q[miss] = rng.integers(0, 2**32, size=(int(miss.sum()), K), dtype=np.uint32)
    return q


# every table geometry of tests/test_pallas_table.py:52-64
#   (nbuckets, K, V, stash, n_entries, B)
GEOMETRIES = [
    pytest.param(1 << 8, 2, 8, 64, 200, 256, id="dhcp-sub"),
    pytest.param(1 << 6, 1, 8, 64, 100, 64, id="vlan-small-batch"),
    pytest.param(1 << 6, 8, 8, 64, 100, 300, id="cid-k8-kw16"),
    pytest.param(1 << 8, 4, 16, 64, 300, 512, id="nat-sessions-v16"),
    pytest.param(1 << 8, 4, 8, 64, 300, 512, id="nat-reverse-v8"),
    pytest.param(1 << 3, 2, 8, 32, 38, 128, id="overfull-stash-hits"),
    pytest.param(1 << 8, 2, 8, 0, 100, 128, id="no-stash"),
    pytest.param(1 << 6, 2, 8, 64, 0, 128, id="empty-table"),
    pytest.param(1 << 12, 2, 8, 256, 6000, 1024, id="1m-geometry-reduced"),
]


def _port_state(ttab):
    return ttab.device_state(CPU)


def _jax_state(jtab):
    """The JAX upload, copied: on the CPU `jnp.asarray` aliases the host
    array whenever its buffer happens to be aligned, and later host
    inserts would then rewrite the "device" rows underneath."""
    return jt.TableState(*(jnp.array(np.array(a)) for a in jtab.device_state()))


@pytest.mark.parametrize("nbuckets,K,V,stash,n,B", GEOMETRIES)
def test_probe_plain_equals_xla_pallas_and_host(nbuckets, K, V, stash, n, B):
    jtab, ttab, keys = build_pair(nbuckets, K, V, stash, n, seed=nbuckets + K)
    jstate = jtab.device_state()
    tstate = _port_state(ttab)
    # host mirrors and their packed device rows are byte-equal
    for a, b in zip(jstate, tstate):
        assert np.array_equal(np.asarray(a), bits(b))
    q = query_mix(keys, K, B, seed=nbuckets)
    got = tt.xla_lookup(tstate, torch.from_numpy(q.view(np.int32)), nbuckets, stash)
    ref = jt.xla_lookup(jstate, jnp.asarray(q), nbuckets, stash)
    pf, ps, pv = pallas_probe(jstate.krows, jstate.stash_rows, jstate.vals, jnp.asarray(q),
                              nbuckets, stash, interpret=True)
    for r_found, r_slot, r_vals in ((ref.found, ref.slot, ref.vals), (pf, ps, pv)):
        assert np.array_equal(bits(got.found), np.asarray(r_found))
        assert np.array_equal(bits(got.slot), bits(r_slot))
        assert np.array_equal(bits(got.vals), bits(r_vals))
    assert np.array_equal(bits(got.vals), ttab.lookup_batch_host(q))
    # the CPU dispatch of device_lookup is the plain version
    via = tt.device_lookup(tstate, torch.from_numpy(q.view(np.int32)), nbuckets, stash)
    assert all(torch.equal(a, b) for a, b in zip(via, got))


@pytest.mark.parametrize("B", [7, 129, 1000])
def test_probe_ragged_batch(B):
    """B not a multiple of 128 (the TPU lane tile): nothing leaks."""
    jtab, ttab, keys = build_pair(1 << 6, 2, 8, 64, 80, seed=3)
    q = query_mix(keys, 2, B, seed=B)
    ref = jt.xla_lookup(jtab.device_state(), jnp.asarray(q), 1 << 6, 64)
    got = tt.xla_lookup(_port_state(ttab), torch.from_numpy(q.view(np.int32)), 1 << 6, 64)
    assert np.array_equal(bits(got.found), np.asarray(ref.found))
    assert np.array_equal(bits(got.slot), bits(ref.slot))
    assert np.array_equal(bits(got.vals), bits(ref.vals))


@pytest.mark.parametrize("name", list(kernel_cases.PROBE_SPECS))
def test_probe_plain_on_shared_edge_cases(name):
    """The inputs chip_smoke.py holds K1 to on the card: the plain version
    equals `xla_lookup` and the Pallas probe (interpret mode)."""
    c = kernel_cases.probe_case(name)
    args = [torch.from_numpy(a) for a in (c.krows, c.stash_rows, c.vals, c.query)]
    got = probe_plain(*args, c.nbuckets, c.stash)
    ja = [jnp.asarray(a.view(np.uint32)) for a in (c.krows, c.stash_rows, c.vals, c.query)]
    ref = jt.xla_lookup(jt.TableState(*ja[:3]), ja[3], c.nbuckets, c.stash)
    pal = pallas_probe(*ja, c.nbuckets, c.stash, interpret=True)
    for r in ((ref.found, ref.slot, ref.vals), pal):
        for g, x in zip(got, r):
            assert np.array_equal(bits(g), bits(x))
    via = probe(*args, c.nbuckets, c.stash)  # the CPU dispatch is the plain version
    assert all(torch.equal(a, b) for a, b in zip(via, got))


def test_shared_probe_cases_cover_their_edges():
    """Each case holds what its name promises: scattered used stash rows
    with rows 0 and stash-1 used and holes between, lanes that hit the
    stash, duplicate query rows, and the widths and batch sizes asked for."""
    seen_B = set()
    for name, (nbuckets, K, V, stash, fill, B) in kernel_cases.PROBE_SPECS.items():
        c = kernel_cases.probe_case(name)
        seen_B.add(B)
        assert c.query.shape == (B, K) and c.vals.shape == (nbuckets * 4 + stash, V)
        assert c.stash_rows.shape == (stash, tt.way_stride(K)) and c.stash == stash
        used = c.stash_rows[:, K] != 0
        found, slot, _ = probe_plain(*(torch.from_numpy(a) for a in c[:4]), nbuckets, stash)
        stash_hits = int((slot[found] >= nbuckets * 4).sum())
        if fill == "scattered":
            assert used[0] and used[-1] and 0 < used.sum() < stash - 1, name
            assert stash_hits > 0, name
        else:
            assert not used.any() and stash_hits == 0, name
        if fill == "empty":
            assert not found.any()
        if B >= 1000:
            assert len(np.unique(c.query, axis=0)) < B, name  # duplicate rows
            assert 0 < int(found.sum()) < B or fill == "empty", name
    assert seen_B >= {1, 7, 8, 9, 1000, 8192}


def test_host_mirrors_after_deletes_and_stash_overflow():
    """Kick walks, stash placement and deletes keep both mirrors byte-equal."""
    jtab, ttab, _ = build_pair(1 << 3, 2, 8, 32, 40, seed=11, deletes=9)
    assert np.array_equal(jtab.keys, ttab.keys)
    assert np.array_equal(jtab.vals, ttab.vals)
    assert np.array_equal(jtab.used, ttab.used)
    assert int(ttab.used[(1 << 3) * 4:].sum()) > 0  # the stash is in use
    for a, b in zip(jtab.device_state(), ttab.device_state(CPU)):
        assert np.array_equal(np.asarray(a), bits(b))


@pytest.mark.parametrize("nbuckets,K,V,stash,n,B", GEOMETRIES)
def test_find_slots_equals_the_row_by_row_lookup(nbuckets, K, V, stash, n, B):
    """The vectorized `find_slots` (the invariant audit's lookup) gives
    `_find_slot`'s slot, stash hits and misses included, on every geometry."""
    _, ttab, keys = build_pair(nbuckets, K, V, stash, n, seed=nbuckets + n, deletes=n // 10)
    q = query_mix(keys, K, B, seed=n)
    want = [ttab._find_slot(k) for k in q]
    assert ttab.find_slots(q, chunk=97).tolist() == [-1 if w is None else w for w in want]


def test_bulk_insert_matches():
    rng = np.random.default_rng(21)
    keys = np.unique(rng.integers(0, 2**32, size=(3000, 2), dtype=np.uint32), axis=0)
    vals = rng.integers(0, 2**32, size=(len(keys), 8), dtype=np.uint32)
    jtab = jt.HostTable(1 << 10, 2, 8, stash=64)
    ttab = tt.HostTable(1 << 10, 2, 8, stash=64)
    jtab.bulk_insert(keys, vals)
    ttab.bulk_insert(keys, vals)
    assert np.array_equal(jtab.keys, ttab.keys)
    assert np.array_equal(jtab.vals, ttab.vals)
    assert ttab.dirty_count() == ttab.S


def test_apply_update_parks_padding_rows():
    """A partial drain (padding rows parked at NB / stash / S) applied in
    place equals JAX's donated mode="drop" scatter."""
    jtab, ttab, keys = build_pair(1 << 4, 2, 8, 8, 40, seed=5)
    jstate, tstate = _jax_state(jtab), ttab.device_state(CPU)
    rng = np.random.default_rng(6)
    for i in range(12):  # updates, new keys (some to the stash) and deletes
        k = rng.integers(0, 2**32, size=2, dtype=np.uint32)
        v = rng.integers(0, 2**32, size=8, dtype=np.uint32)
        jtab.insert(k, v)
        ttab.insert(k, v)
    for k in keys[:5]:
        jtab.delete(k)
        ttab.delete(k)
    for _ in range(3):  # three bounded drains, the last one mostly padding
        jupd = jtab.make_update(16)
        tupd = ttab.make_update(16, CPU)
        jstate = jt.apply_update(jstate, jupd)
        out = tt.apply_update(tstate, tupd)
        assert out is tstate
        for a, b in zip(jstate, tstate):
            assert np.array_equal(np.asarray(a), bits(b))
    assert ttab.dirty_count() == 0


def test_apply_update_all_padding_is_a_noop():
    _, ttab, _ = build_pair(1 << 4, 1, 8, 0, 10, seed=8)
    tstate = ttab.device_state(CPU)
    before = [t.clone() for t in tstate]
    tt.apply_update(tstate, ttab.make_update(4, CPU))  # nothing dirty: all padding
    assert all(torch.equal(a, b) for a, b in zip(before, tstate))


def _qtables(seed, n=60, nbuckets=32):
    rng = np.random.default_rng(seed)
    jtab, ttab = jq.HostQTable(nbuckets), tq.HostQTable(nbuckets)
    ips = np.unique(rng.integers(0, 2**32, size=n, dtype=np.uint32))
    for ip in ips:
        rate = int(rng.integers(0, 2**40))
        burst = int(rng.integers(0, 2**20))
        prio = int(rng.integers(0, 8))
        assert jtab.insert(int(ip), rate, burst, prio) == ttab.insert(int(ip), rate, burst, prio)
    for ip in ips[:7]:
        assert jtab.delete(int(ip)) == ttab.delete(int(ip))
    return jtab, ttab, ips


def test_host_qtable_matches():
    jtab, ttab, _ = _qtables(1)
    assert np.array_equal(jtab.rows, ttab.rows)
    rng = np.random.default_rng(2)
    ips = np.unique(rng.integers(0, 2**32, size=300, dtype=np.uint32))
    jb, tb = jq.HostQTable(128), tq.HostQTable(128)
    jb.bulk_insert(ips, np.full(len(ips), 10**9, np.uint64), np.full(len(ips), 5000, np.uint32))
    tb.bulk_insert(ips, np.full(len(ips), 10**9, np.uint64), np.full(len(ips), 5000, np.uint32))
    assert np.array_equal(jb.rows, tb.rows)


def test_qlookup_write_token_rows_and_apply_qupdate():
    jtab, ttab, ips = _qtables(3)
    geom_j, geom_t = jq.QTableGeom(32), tq.QTableGeom(32)
    jstate = jq.QTableState(rows=jnp.array(np.array(jtab.device_state().rows)))  # see _jax_state
    tstate = ttab.device_state(CPU)
    rng = np.random.default_rng(4)
    q = np.concatenate([ips[rng.integers(0, len(ips), 40)],
                        rng.integers(0, 2**32, size=24, dtype=np.uint32)])
    jr = jq.qlookup(jstate, jnp.asarray(q), geom_j)
    tr = tq.qlookup(tstate, torch.from_numpy(q.astype(np.int64)), geom_t)
    for f in jq.QLookup._fields:
        assert np.array_equal(bits(getattr(tr, f)), bits(getattr(jr, f))), f

    # head lanes write tokens/now back; non-heads park at S (dropped)
    S = jstate.rows.shape[0]
    heads = rng.random(len(q)) < 0.5
    _, first = np.unique(np.asarray(jr.slot), return_index=True)
    keep = np.zeros(len(q), bool)
    keep[first] = True
    wslot = np.where(heads & keep & np.asarray(jr.found), np.asarray(jr.slot), S).astype(np.int32)
    tokens = rng.random(len(q)).astype(np.float32) * 1e4
    now = 0xDEADBEEF
    jstate = jq.write_token_rows(jstate, jnp.asarray(wslot), jr.row, jnp.asarray(tokens),
                                 jnp.uint32(now))
    tq.write_token_rows(tstate, torch.from_numpy(wslot.astype(np.int64)), tr.row,
                        torch.from_numpy(tokens), torch.tensor(now))
    assert np.array_equal(np.asarray(jstate.rows), bits(tstate.rows))

    # a host policy change drained as a bounded update, padding parked at S
    for ip in ips[7:12]:
        jtab.insert(int(ip), 1000, 2000, 1)
        ttab.insert(int(ip), 1000, 2000, 1)
    jstate = jq.apply_qupdate(jstate, jtab.make_update(8))
    tq.apply_qupdate(tstate, ttab.make_update(8, CPU))
    assert np.array_equal(np.asarray(jstate.rows), bits(tstate.rows))
