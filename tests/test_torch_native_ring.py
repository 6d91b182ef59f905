"""The port's `NativeRing` and its `PyRing` against the JAX package's
rings.

- The port builds its own byte-for-byte copy of `native/bngring.{h,cpp}`
  (`bng_tpu_torch/csrc/`) with `g++` into `bng_tpu_torch/_build/`; the ctypes
  mirrors match the C layout, and `make_ring` picks the native ring.
- On the ring corpus of tests/test_torch_ring.py plus random frames, and
  on the pressure cases of tests/test_hostpath.py::TestRingIdentity (a
  free pool too small for the pushes, a per-shard queue too shallow, a
  full TX ring at complete), four rings give the same log: what every push
  took, every `assemble` / `assemble_sharded` matrix with its lengths and
  flags, the frames out of `tx_pop`, `fwd_pop` and `slow_pop`, `stats()`
  and the free count. The four: the port's `PyRing` and `NativeRing`, and
  the reference's `NativeRing` and scalar `PyRing`.
- `shard_of` of the native ring equals the Python steering; `wire_pump`
  moves the same frames between two native rings as between two PyRings.
- `Engine.process_ring_pipelined` over a `NativeRing` gives the frames,
  stats and tables it gives over the `PyRing` (the full stack).

Tolerance: bit-exact.
"""

import ctypes as C

import numpy as np
import pytest

from bng_tpu.runtime import ring as j_ring
from bng_tpu_torch import frames as F
from bng_tpu_torch.runtime import nativelib
from bng_tpu_torch.runtime import ring as t_ring
from bng_tpu_torch.runtime.engine import Engine as TEngine
from bng_tpu_torch.utils.net import ip_to_u32

from test_torch_entry import PORT_FULL, deploy_full, full_batch
from test_torch_ring import classify_corpus

pytestmark = pytest.mark.torch_port

PUB_IPS = {0x04040404: 1, 0x08080808: 2, 0x01010101: 99}


def _corpus(seed: int = 5) -> list:
    rng = np.random.default_rng(seed)
    out = classify_corpus()
    for i in range(40):
        m = bytes([2, 0xB0, 0, 0, i >> 8, i & 0xFF])
        out.append(F.udp_packet(m, b"\x04" * 6, ip_to_u32("10.0.0.1") + i,
                                [0x04040404, 0x08080808, 0x0A0B0C0D][i % 3],
                                1000 + i, 53, bytes(int(rng.integers(10, 200)))))
    out += [bytes(rng.integers(0, 256, int(rng.integers(1, 120)), dtype=np.uint8))
            for _ in range(10)]
    return [f for f in out if len(f) <= 500]


def _rings(nframes, frame_size, depth, n_shards):
    kw = dict(nframes=nframes, frame_size=frame_size, depth=depth, n_shards=n_shards)
    return {
        "port py": t_ring.PyRing(**kw),
        "port native": t_ring.NativeRing(**kw),
        "jax native": j_ring.NativeRing(**kw),
        "jax py": j_ring.PyRing(host_path="scalar", **kw),
    }


def _drive(r, corpus, n_shards, sharded, B=32, slot=512, seed=3) -> list:
    for ip, s in PUB_IPS.items():
        r.steer_pub_ip(ip, s)
    rng = np.random.default_rng(seed)
    log = [("pushed", r.rx_push_batch(corpus[:60], from_access=True),
            r.rx_push_batch(corpus[60:], from_access=False))]
    for _ in range(20):
        if not r.rx_pending():
            break
        out = np.full((B, slot), 0xEE, np.uint8)  # stale bytes: assemble must clear them
        ol = np.zeros(B, np.uint32)
        fl = np.zeros(B, np.uint32)
        n = r.assemble_sharded(out, ol, fl) if sharded else r.assemble(out, ol, fl)
        if n == 0:
            break
        nn = B if sharded else n
        log.append(("asm", n, out[:nn].tobytes(), ol[:nn].tobytes(), fl[:nn].tobytes()))
        v = rng.integers(0, 4, nn).astype(np.uint8)
        reply = rng.integers(0, 256, (nn, slot), dtype=np.uint8)
        rl = rng.integers(20, slot, nn).astype(np.uint32)
        r.complete(v, reply, rl, nn)
        log.append(("inject", r.tx_inject(bytes(40 + len(log)), from_access=bool(n % 2))))
    for pop in (r.tx_pop, r.fwd_pop, r.slow_pop):
        while (got := pop()) is not None:
            log.append(("pop", pop.__name__, got))
    log.append(("stats", sorted(r.stats().items()), r.free_frames(), r.rx_pending()))
    return log


def _same(logs: dict) -> None:
    want = logs["jax py"]
    for name, log in logs.items():
        assert log == want, f"{name} differs from the reference PyRing"


@pytest.mark.parametrize("n_shards,sharded", [(1, False), (2, False), (4, False), (2, True),
                                              (4, True)])
def test_five_rings_identical(n_shards, sharded):
    corpus = _corpus()
    logs = {}
    for name, r in _rings(256, 600, 64, n_shards).items():
        logs[name] = _drive(r, corpus, n_shards, sharded)
        r.close()
    _same(logs)
    assert any(e[0] == "asm" for e in logs["jax py"])


def test_pressure_paths():
    """A free pool smaller than the push, per-shard queues of 4, a TX ring
    that fills at complete (the reference's pressure cases at the native
    ring's power-of-two sizes): every ring refuses and drops exactly where
    the reference does."""
    src = [f for f in _corpus(9) if 0 < len(f) <= 500]
    logs = {}
    for name, r in _rings(16, 600, 4, 2).items():
        log = []
        for part in (src[:40], src[40:60]):  # nothing popped between: TX fills
            log += [("pushed", r.rx_push_batch(part)), ("stats", sorted(r.stats().items()))]
            out = np.zeros((16, 512), np.uint8)
            ol = np.zeros(16, np.uint32)
            fl = np.zeros(16, np.uint32)
            n = r.assemble(out, ol, fl)
            r.complete(np.full(n, t_ring.VERDICT_TX, np.uint8), np.zeros((n, 512), np.uint8),
                       np.full(n, 100, np.uint32), n)
            log.append(("after", n, sorted(r.stats().items()), r.free_frames()))
        while (p := r.tx_pop()) is not None:
            log.append(p)
        logs[name] = log
        r.close()
    _same(logs)
    stats = dict(logs["jax py"][5][2])  # after the second complete
    assert stats["rx_full"] > 0 and stats["tx_full"] > 0  # both pressures were hit


def test_native_library_and_layout():
    lib = t_ring.load_native()
    assert lib is not None
    path = nativelib.lib_path("bngring")
    assert path.exists() and path.parent == nativelib.BUILD_DIR
    assert lib.bng_abi_desc_size() == C.sizeof(t_ring.Desc)
    assert lib.bng_abi_desc_flags_off() == t_ring.Desc.flags.offset
    assert lib.bng_abi_stats_size() == C.sizeof(t_ring.RingStats)
    assert lib.bng_abi_version() == j_ring.load_native().bng_abi_version()
    for name in ("bngring.h", "bngring.cpp"):  # the port keeps its own byte-for-byte copy
        assert (nativelib.CSRC / name).read_bytes() == (
            nativelib.PKG_DIR.parent / "native" / name).read_bytes()
    assert isinstance(t_ring.make_ring(64, 512, 32), t_ring.NativeRing)
    assert isinstance(t_ring.make_ring(64, 512, 32, prefer_native=False), t_ring.PyRing)


def test_shard_of_and_wire_pump_match_python():
    corpus = _corpus(11)
    nr = t_ring.NativeRing(nframes=64, frame_size=2048, depth=32, n_shards=8)
    for ip, s in PUB_IPS.items():
        nr.steer_pub_ip(ip, s)
    for f in corpus:
        for fa in (True, False):
            fl = t_ring.FLAG_FROM_ACCESS if fa else 0
            if fa:
                fl |= t_ring.classify_dhcp(f)
            assert nr.shard_of(f, fl) == t_ring.shard_of(f, fl, 8, PUB_IPS)
    nr.close()

    moved = {}
    for kind in ("native", "py"):
        cls = t_ring.NativeRing if kind == "native" else t_ring.PyRing
        a, b = cls(64, 600, 32), cls(64, 600, 32)
        a.rx_push_batch(corpus[:20])
        out = np.zeros((32, 600), np.uint8)
        ol, fl = np.zeros(32, np.uint32), np.zeros(32, np.uint32)
        n = a.assemble(out, ol, fl)
        a.complete(np.full(n, t_ring.VERDICT_TX, np.uint8), out, ol, n)
        got = [t_ring.wire_pump(a, b, budget=8), t_ring.wire_pump(a, b)]
        got.append([b.rx_pending(), a.stats(), b.stats()])
        moved[kind] = got
    assert moved["native"] == moved["py"] and moved["py"][0] == 8


@pytest.mark.parametrize("loop", ["sync", "pipelined"])
def test_engine_ring_loops_over_native_ring(loop):
    """The full-stack mix through the ring loops: over the NativeRing as
    over the PyRing."""
    got = {}
    for kind in ("py", "native"):
        d = deploy_full(PORT_FULL)
        eng = TEngine(d.fp, d.nat, d.qos, d.spoof, d.garden, d.pppoe, edge=d.edge, batch_size=48,
                      pkt_slot=512, device="cpu")
        r = (t_ring.NativeRing(256, 512, 128) if kind == "native"
             else t_ring.PyRing(256, 512, 128))
        frames, fa = full_batch(d)
        ctrl = [F.discover_frame(bytes([2, 0, 0, 0, 0, k]), 0x600 + k) for k in (1, 2, 3, 7)]
        rec = []
        for k, batch in enumerate([list(zip(frames, fa)), [(f, True) for f in ctrl],
                                   list(zip(frames, fa))]):
            for f, a in batch:
                assert r.rx_push(f, from_access=a)
            run = eng.process_ring if loop == "sync" else eng.process_ring_pipelined
            rec.append(run(r, now=1_700_000_001 + k))
        rec.append(eng.flush_pipeline())
        for pop in (r.tx_pop, r.fwd_pop, r.slow_pop):
            while (item := pop()) is not None:
                rec.append(item)
        rec.append((r.stats(), eng.stats.tx, eng.stats.fwd, eng.stats.dropped, eng.stats.passed,
                    eng.stats.dhcp.tolist(), eng.stats.nat.tolist()))
        got[kind] = rec
        r.close()
    assert got["native"] == got["py"]
    assert got["py"][-1][0]["fwd"] > 0 and got["py"][-1][0]["tx"] > 0
