"""K2's plain version against the Pallas segmented-prefix kernel
(interpret mode), and the port's qos_kernel against the JAX qos_kernel
under both of its aggregation paths ("sort" and "pallas"): admission,
drops, priority, stats and the token rows compared by bits. The batches
put many lanes on one bucket, and three rounds move the clock so the
float32 refill arithmetic decides the token bits."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import bng_tpu.ops.qos as jqos_mod
from bng_tpu.ops.pallas_qos import seg_prefix_total as j_seg_prefix_total
from bng_tpu.ops.qtable import HostQTable as JHostQTable
from bng_tpu.ops.qtable import QTableGeom as JGeom
from bng_tpu.ops.qtable import QTableState as JQState
from bng_tpu_torch import kernel_cases
from bng_tpu_torch.ops import qos as tqos
from bng_tpu_torch.ops.qtable import HostQTable as THostQTable
from bng_tpu_torch.ops.qtable import QTableGeom as TGeom
from bng_tpu_torch.ops.seg_prefix import seg_prefix_plain, seg_prefix_total

from test_torch_words import bits

pytestmark = pytest.mark.torch_port


def _seg_inputs(B, seed):
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, 5, size=B).astype(np.int32)  # heavy sharing
    slot[: B // 4] = -1 - np.arange(B // 4, dtype=np.int32)  # unique negatives
    slot[B // 4: B // 2] = 7  # one long run
    vec = rng.integers(0, 1600, size=B).astype(np.int32)
    return slot, vec


@pytest.mark.parametrize("compute", ["prefix", "total", "both"])
@pytest.mark.parametrize("B", [1, 48, 300])
def test_seg_prefix_plain_equals_pallas(compute, B):
    slot, vec = _seg_inputs(B, seed=B)
    jp, jtot = j_seg_prefix_total(jnp.asarray(slot), jnp.asarray(vec.astype(np.float32)),
                                  interpret=True, compute=compute)
    tp, ttot = seg_prefix_plain(torch.from_numpy(slot), torch.from_numpy(vec), compute)
    assert np.array_equal(bits(tp), bits(jp))
    assert np.array_equal(bits(ttot), bits(jtot))
    # the CPU dispatch of the wrapper is the plain version
    wp, wt = seg_prefix_total(torch.from_numpy(slot), torch.from_numpy(vec), compute)
    assert torch.equal(wp, tp) and torch.equal(wt, ttot)


def test_seg_prefix_plain_is_exact_past_2_24():
    """Integer accumulation: a bucket sum beyond 2^24 stays the sort path's
    exact integer (rounded once to f32), where f32 accumulation would drift."""
    slot = np.zeros(40, dtype=np.int32)
    vec = np.full(40, 1_000_001, dtype=np.int32)
    tp, tt = seg_prefix_plain(torch.from_numpy(slot), torch.from_numpy(vec), "both")
    expect = np.arange(1, 41, dtype=np.int64) * 1_000_001
    assert np.array_equal(tp.numpy(), expect.astype(np.float32))
    assert np.array_equal(tt.numpy(), np.full(40, expect[-1], dtype=np.float32))


def _seg_oracle(slot, vec, compute):
    """Independent numpy integer oracle: a stable argsort, a uint64 cumsum
    per segment, each sum rounded once to f32 (exact in f64 below 2^53)."""
    B = len(slot)
    order = np.argsort(slot, kind="stable")
    s = slot[order]
    v = vec.view(np.uint32).astype(np.uint64)[order]
    csum = np.cumsum(v)
    head = np.r_[True, s[1:] != s[:-1]]
    seg = np.cumsum(head) - 1
    starts = np.nonzero(head)[0]
    base = (csum - v)[starts][seg]
    ends = np.r_[starts[1:], B] - 1
    pref, tot = np.zeros(B, np.float32), np.zeros(B, np.float32)
    if compute != "total":
        pref[order] = (csum - base).astype(np.float64).astype(np.float32)
    if compute != "prefix":
        tot[order] = (csum[ends][seg] - base).astype(np.float64).astype(np.float32)
    return pref, tot


@pytest.mark.parametrize("name", kernel_cases.SEG_SPECS)
def test_seg_prefix_plain_on_shared_edge_cases(name):
    """The inputs chip_smoke.py holds K2 to on the card (both routes): the
    plain version equals the integer oracle, and the Pallas kernel
    (interpret mode) where its f32 sums are exact and B is small."""
    c = kernel_cases.seg_case(name)
    tp, ttot = seg_prefix_plain(torch.from_numpy(c.slot), torch.from_numpy(c.vec), c.compute)
    op, ot = _seg_oracle(c.slot, c.vec, c.compute)
    assert np.array_equal(bits(tp), bits(op))
    assert np.array_equal(bits(ttot), bits(ot))
    _, inverse = np.unique(c.slot, return_inverse=True)
    sums = np.bincount(inverse.ravel(), weights=c.vec.view(np.uint32).astype(np.float64))
    if len(c.slot) <= 1000 and sums.max() < 2**24:
        jp, jtot = j_seg_prefix_total(jnp.asarray(c.slot),
                                      jnp.asarray(c.vec.view(np.uint32).astype(np.float32)),
                                      interpret=True, compute=c.compute)
        assert np.array_equal(bits(tp), bits(jp))
        assert np.array_equal(bits(ttot), bits(jtot))


def _policies(n_subs, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_subs):
        ip = (10 << 24) | (i + 2)
        rate = int(rng.choice([0, 8_000, 8_000_000, 3 * 2**32 + 12345]))  # 0 = unlimited
        burst = int(rng.integers(500, 6000))
        out.append((ip, rate, burst, int(rng.integers(0, 8))))
    return out


@pytest.mark.parametrize("impl", ["sort", "pallas"])
def test_qos_kernel_matches_reference(impl, monkeypatch):
    monkeypatch.setattr(jqos_mod, "PREFIX_IMPL", impl)
    B = 64
    n_subs = 6
    jt, tt = JHostQTable(32), THostQTable(32)
    for ip, rate, burst, prio in _policies(n_subs, seed=1):
        jt.insert(ip, rate, burst, prio)
        tt.insert(ip, rate, burst, prio)
    jstate = JQState(rows=jnp.array(np.array(jt.rows)))
    tstate = tt.device_state(torch.device("cpu"))
    rng = np.random.default_rng(2)
    for rnd, now_us in enumerate((1_000, 1_700_123, 0xFFFFFF00)):
        ips = ((10 << 24) + 2 + rng.integers(0, n_subs + 2, size=B)).astype(np.uint32)
        ips[:20] = (10 << 24) + 2  # 20 lanes on one bucket
        lens = rng.integers(60, 1500, size=B).astype(np.uint32)
        active = rng.random(B) < 0.9
        jr = jqos_mod.qos_kernel(jnp.asarray(ips), jnp.asarray(lens), jnp.asarray(active),
                                 jstate, JGeom(32), jnp.uint32(now_us))
        tr = tqos.qos_kernel(torch.from_numpy(ips.astype(np.int64)),
                             torch.from_numpy(lens.astype(np.int64)),
                             torch.from_numpy(active), tstate, TGeom(32),
                             torch.tensor(now_us, dtype=torch.int64))
        for f in ("allowed", "dropped", "priority", "stats"):
            assert np.array_equal(bits(getattr(tr, f)), bits(getattr(jr, f))), (rnd, f)
        assert tr.table is tstate
        assert np.array_equal(bits(tstate.rows), np.asarray(jr.table.rows)), rnd
        jstate = jr.table
    assert int(np.asarray(jr.stats)[1]) > 0  # some lanes dropped
