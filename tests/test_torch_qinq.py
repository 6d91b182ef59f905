"""The port's QinQ helpers (`bng_tpu_torch/control/qinq.py`) against the
JAX package's.

- The reference's own cases run on the port (`port_twin`): `VLANPair`,
  `VLANRange` and `QinQMapper` in `tests/test_qinq_ztp.py` and
  `tests/test_garden_dns.py::TestQinQ`.
- The double-tag invariant of `tests/test_qinq_ztp.py::TestDoubleTagParity`
  on the port: for seeded S/C pairs, the key the port's parser derives
  from an 802.1ad frame, `(s_tag << 16) | c_tag`, equals `VLANPair.key()`
  and the JAX parser's key; pairs registered in both packages' mappers
  reach the VLAN table through `FastPathTables.add_vlan_subscriber` with
  the same table words.
- Through the fused step and the DHCP-only program (plain kernels on the
  CPU): a batch of 802.1ad DISCOVERs answered from the VLAN table gives
  the JAX engine's TX bytes, stats and updated table words.

Tolerance: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_garden_dns as ref_gd
import test_qinq_ztp as ref_qz
from bng_tpu.control import qinq as j_qinq
from bng_tpu.ops.parse import parse_batch as j_parse
from bng_tpu.runtime.engine import Engine as JEngine
from bng_tpu_torch import convert
from bng_tpu_torch import frames as F
from bng_tpu_torch.control import qinq as t_qinq
from bng_tpu_torch.ops.parse import parse_batch as t_parse
from bng_tpu_torch.runtime.engine import Engine as TEngine
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_deviceauth import reference_cases, run_on_port
from test_torch_stages import JAX_PKG, NOW, PORT_PKG, assert_tuple_equal, deploy, mac
from test_torch_words import bits

pytestmark = pytest.mark.torch_port

CASES = ([(ref_qz, c) for c in reference_cases(ref_qz, ("TestVLANPair", "TestQinQMapper"))]
         + [(ref_gd, c) for c in reference_cases(ref_gd, ("TestQinQ",))])


@pytest.mark.parametrize("module,case", CASES, ids=[f"{m.__name__}::{c}" for m, c in CASES])
def test_reference_case_holds_on_the_port(module, case, request):
    run_on_port(module, case, request)


def _pairs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out, seen = [], set()
    while len(out) < n:
        s, c = (int(v) for v in rng.integers(1, 4096, size=2))
        if (s, c) not in seen:
            seen.add((s, c))
            out.append((s, c))
    return out


def _qinq_frame(s_tag, c_tag):
    # the reference test's frame: 802.1ad outer, 802.1Q inner, IPv4
    return (b"\x02" * 6 + b"\x04" * 6 + b"\x88\xa8" + s_tag.to_bytes(2, "big")
            + b"\x81\x00" + c_tag.to_bytes(2, "big") + b"\x08\x00" + b"\x00" * 40)


def test_parser_and_registry_agree_on_key():
    pairs = _pairs(3, 24)
    frames = [_qinq_frame(s, c) for s, c in pairs]
    pkt = np.zeros((len(frames), 128), np.uint8)
    for i, f in enumerate(frames):
        pkt[i, :len(f)] = np.frombuffer(f, np.uint8)
    lens = np.array([len(f) for f in frames], np.int32)
    tp = t_parse(torch.from_numpy(pkt.copy()), torch.from_numpy(lens.astype(np.int64)))
    jp = j_parse(jnp.asarray(pkt), jnp.asarray(lens))
    assert bool(tp.is_qinq.all()) and bool(np.asarray(jp.is_qinq).all())
    t_keys = ((tp.s_tag << 16) | tp.c_tag).tolist()
    j_keys = [(int(s) << 16) | int(c) for s, c in zip(np.asarray(jp.s_tag), np.asarray(jp.c_tag))]
    reg = [t_qinq.VLANPair(s, c).key() for s, c in pairs]
    assert t_keys == j_keys == reg == [j_qinq.VLANPair(s, c).key() for s, c in pairs]


def test_mappers_agree_on_seeded_registrations():
    pairs = _pairs(5, 40)
    out = []
    for q in (j_qinq, t_qinq):
        m = q.QinQMapper(q.QinQConfig(s_tag_range=q.VLANRange(1, 4095),
                                      c_tag_range=q.VLANRange(1, 4095)))
        log = []
        r = np.random.default_rng(11)
        for i, (s, c) in enumerate(pairs):
            sub = f"sub-{int(r.integers(0, 30))}"
            try:
                m.register(q.VLANPair(s, c), sub)
                log.append(("ok", sub))
            except ValueError as e:
                log.append(("refused", str(e)))
        for s, c in pairs[::3]:
            log.append(m.get_subscriber(q.VLANPair(s, c)))
        for i in range(0, 30, 4):
            v = m.get_vlan(f"sub-{i}")
            log.append(None if v is None else (v.s_tag, v.c_tag, v.key(), str(v)))
            m.unregister_subscriber(f"sub-{i}")
        log.append(m.stats())
        out.append(log)
    assert out[0] == out[1]


def test_registered_pairs_reach_the_vlan_table_word_for_word():
    pairs = _pairs(7, 32)
    words = []
    for pkg, q in ((JAX_PKG, j_qinq), (PORT_PKG, t_qinq)):
        fp = pkg.FastPathTables(sub_nbuckets=64, vlan_nbuckets=64, cid_nbuckets=64, max_pools=4)
        m = q.QinQMapper()
        for i, (s, c) in enumerate(pairs):
            pair = q.VLANPair(s, c)
            m.register(pair, f"sub-{i}")
            fp.add_vlan_subscriber(pair.s_tag, pair.c_tag, 1, 0x0A000000 + i, NOW + 900)
        assert all(fp.vlan.lookup([q.VLANPair(s, c).key()]) is not None for s, c in pairs)
        words.append((np.array(fp.vlan.keys), np.array(fp.vlan.vals)))
    assert np.array_equal(words[0][0], words[1][0]) and np.array_equal(words[0][1], words[1][1])


# ---- through the fused step and the DHCP-only program ---------------------

N_PAIRS = 12


def qinq_deploy(pkg, q, pairs):
    """A small deployment whose clients are known only by their S/C pair."""
    d = deploy(pkg)
    m = q.QinQMapper(q.QinQConfig(s_tag_range=q.VLANRange(1, 4095),
                                  c_tag_range=q.VLANRange(1, 4095)))
    for i, (s, c) in enumerate(pairs):
        pair = q.VLANPair(s, c)
        m.register(pair, f"qinq-{i}")
        d.fp.add_vlan_subscriber(pair.s_tag, pair.c_tag, pool_id=1,
                                 ip=ip_to_u32(f"10.0.0.{100 + i}"), lease_expiry=NOW + 900)
    d.mapper = m
    return d


def qinq_discovers(pairs, xid0=0x5000):
    return [F.discover_frame(mac(0x40 + i), xid0 + i, vlans=[s, c])
            for i, (s, c) in enumerate(pairs)]


def test_qinq_discovers_through_the_step_equal_the_reference():
    pairs = _pairs(13, N_PAIRS)
    jd, td = qinq_deploy(JAX_PKG, j_qinq, pairs), qinq_deploy(PORT_PKG, t_qinq, pairs)
    jeng = JEngine(jd.fp, jd.nat, jd.qos, jd.spoof, batch_size=16, pkt_slot=512)
    teng = TEngine(td.fp, td.nat, td.qos, td.spoof, batch_size=16, pkt_slot=512, device="cpu")
    frames = qinq_discovers(pairs)
    jo, to = jeng.process(frames, now=NOW + 1), teng.process(frames, now=NOW + 1)
    assert to == jo
    assert sorted(i for i, _ in to["tx"]) == list(range(N_PAIRS))
    for (i, b), (s, c) in zip(sorted(to["tx"]), pairs):
        d = F.decode(b)
        assert d.vlans == [s, c]  # the OFFER keeps both tags
        assert F.decode_dhcp(d.payload).yiaddr == ip_to_u32(f"10.0.0.{100 + i}")
    # the DHCP-only program answers the same pairs the same way
    frames2 = qinq_discovers(pairs, 0x6000)
    assert teng.process_dhcp(frames2, now=NOW + 2) == jeng.process_dhcp(frames2, now=NOW + 2)
    for f in ("dhcp", "nat", "qos", "spoof"):
        assert np.array_equal(getattr(teng.stats, f), getattr(jeng.stats, f)), f
    jt = jax.tree_util.tree_map(lambda a: np.array(a), jeng.tables)
    assert_tuple_equal(convert.tables_to_numpy(teng.tables), jt, "engine tables")
    assert np.array_equal(bits(teng.tables.dhcp.vlan.vals), bits(jt.dhcp.vlan.vals))
