"""The port's kernel gate (port of `bng_tpu/runtime/verify.py`).

The reference's gate asks whether every hot program lowers through
Mosaic/XLA for the TPU. On the card the question is whether every hot
program builds, launches, and gives its plain version's bits. Each entry
of `CHECKS` is `(name, check, cuda_only)`, and each answers one entry of
the reference's `CHECKS` (`REFERENCE_NAMES`):

| port check | reference check | what it runs |
| --- | --- | --- |
| qos_kernel[plain] | qos_kernel[sort] | the QoS stage on the CPU (plain K2) |
| qos_kernel[cuda] | qos_kernel[pallas] | the QoS stage on the card == on the CPU |
| seg_prefix_total[cuda] | pallas_seg_prefix_total | K2 == its plain version on every `kernel_cases.seg_case` |
| table_lookup[plain] | table_lookup[xla] | the probe of a populated table == `HostTable.find_slots` |
| table_lookup[plain-cases] | table_lookup[pallas-interp] | K1's plain version on every `kernel_cases.probe_case`: each hit's row holds the query |
| table_lookup[cuda] | table_lookup[pallas] | K1 == its plain version on every probe case |
| devloop_ring[plain] | dhcp_express[xla] | the devloop ring program at k = 1 and 8 on the CPU == its slots run eagerly |
| devloop_ring[cuda] | dhcp_express[pallas] | the ring graph at k = 1 and 8 == its eager replay and the CPU ring |
| express_aot[plain] | express_aot[xla] | the express program on the CPU == `express_verdicts` |
| express_aot[cuda] | express_aot[pallas] | the express graph == its eager replay and the CPU dispatch |
| fused_pipeline_step | fused_pipeline_step | the fused step (garden on); on the card, GPU == CPU |
| sharded_step | sharded_step | the sharded step and DHCP-only step, one shard a visible card (N = 2 on one card); on the card, GPU == CPU |

`verify_cuda_kernels(cuda=False)` runs the checks that are not CUDA-only
on the CPU, so the tier-1 suite catches drift in the gate's own harness
(table constructors, program builders, kernel signatures), as the
reference's `tpu=False` does. `cuda=True` runs every check on the card.
"""

from __future__ import annotations

import traceback
from typing import Callable

import numpy as np
import torch

from bng_tpu_torch.utils.net import ip_to_u32

NOW = 1_753_000_000
SERVER_MAC = bytes.fromhex("02aabbccdd01")
B = 64


def _equal(a, b, what: str) -> None:
    """Every leaf of two results (tensors, tuples, dicts of arrays) equal,
    bit for bit, compared on the host."""
    if isinstance(a, dict):
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"{what}: card and plain results differ")
    elif isinstance(a, np.ndarray):
        if not np.array_equal(a, b):
            raise AssertionError(f"{what}: card and plain results differ")
    elif a != b:
        raise AssertionError(f"{what}: {a!r} != {b!r}")


def _cpu_copy(tables):
    from bng_tpu_torch import convert

    return convert.tables_from_numpy(convert.tables_to_numpy(tables), "cpu")


def _engine(device, garden: bool = False):
    """A small engine with 256 leased subscribers (MAC 02:aa:00:00:00:i)."""
    from bng_tpu_torch.control.nat import NATManager
    from bng_tpu_torch.runtime.engine import AntispoofTables, Engine, GardenTables, QoSTables
    from bng_tpu_torch.runtime.tables import FastPathTables

    fp = FastPathTables(sub_nbuckets=1 << 10, vlan_nbuckets=256, cid_nbuckets=256,
                        max_pools=4, stash=64)
    fp.set_server_config(SERVER_MAC, ip_to_u32("10.0.0.1"))
    fp.add_pool(1, ip_to_u32("10.0.0.0"), 16, ip_to_u32("10.0.0.1"), ip_to_u32("1.1.1.1"),
                ip_to_u32("8.8.8.8"), 3600)
    for i in range(256):
        fp.add_subscriber(_mac(i), 1, ip_to_u32("10.0.1.0") + i, NOW + 3600)
    nat = NATManager(public_ips=[ip_to_u32("203.0.113.1")], sub_nat_nbuckets=1 << 10)
    qos = QoSTables(nbuckets=256)
    for i in range(32):
        qos.set_subscriber(ip_to_u32("10.0.1.0") + i, down_bps=8_000_000, up_bps=8_000_000)
    return Engine(fp, nat, qos, AntispoofTables(nbuckets=256),
                  garden=GardenTables(nbuckets=256) if garden else None,
                  batch_size=256, device=device)


def _mac(i: int) -> bytes:
    return (0x02AA00000000 + i).to_bytes(6, "big")


def _discovers(n: int, xid0: int) -> list[bytes]:
    from bng_tpu_torch import frames as F

    return [F.discover_frame(_mac((7 * j) % 256), xid0 + j, pad=320) for j in range(n)]


def _desc(frames) -> np.ndarray:
    from bng_tpu_torch.ops.express import XD_WORDS, parse_express

    desc = np.zeros((B, XD_WORDS), dtype=np.uint32)
    for i, f in enumerate(frames):
        desc[i] = parse_express(f).words
    return desc


def _qos_on(device):
    from bng_tpu_torch.ops.qos import qos_kernel
    from bng_tpu_torch.runtime.engine import QoSTables

    qos = QoSTables(nbuckets=256)
    for i in range(32):
        qos.set_subscriber((10 << 24) | (i + 2), down_bps=8_000_000, up_bps=8_000_000)
    n = 256
    ips = torch.from_numpy(((10 << 24) + 2 + np.arange(n) % 64).astype(np.int64)).to(device)
    lens = torch.full((n,), 900, dtype=torch.int64, device=device)
    active = torch.ones((n,), dtype=torch.bool, device=device)
    table = qos.up.device_state(device)
    res = qos_kernel(ips, lens, active, table, qos.geom, torch.tensor(1, device=device))
    return res, table


def _check_qos(device: str) -> None:
    got, table = _qos_on(device)
    if device == "cuda":
        want, want_table = _qos_on("cpu")
        _equal(tuple(got), tuple(want), "qos_kernel")
        _equal(table.rows, want_table.rows, "qos token rows")


def _check_seg_cases() -> None:
    from bng_tpu_torch import kernel_cases
    from bng_tpu_torch.ops import seg_prefix as seg_mod

    for name in kernel_cases.SEG_SPECS:
        c = kernel_cases.seg_case(name)
        s, v = torch.from_numpy(c.slot).cuda(), torch.from_numpy(c.vec).cuda()
        _equal(seg_mod.seg_prefix_cuda(s, v, c.compute),
               seg_mod.seg_prefix_plain(s, v, c.compute), f"K2 {name}")


def _rep_table():
    """A populated table (the DHCP subscriber table's shape) and 256
    queries, half of them present."""
    from bng_tpu_torch.ops.table import HostTable

    t = HostTable(1 << 10, 2, 8, stash=64, name="verify")
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 2**32, size=(256, 2), dtype=np.uint32), axis=0)
    for k in keys:
        t.insert(k, np.arange(8, dtype=np.uint32))
    q = np.concatenate([keys[:128], rng.integers(0, 2**32, size=(128, 2), dtype=np.uint32)])
    return t, q


def _check_table(device: str) -> None:
    from bng_tpu_torch.ops import probe as probe_mod

    t, q = _rep_table()
    st = t.device_state(device)
    args = (st.krows, st.stash_rows, st.vals, torch.from_numpy(q.view(np.int32)).to(device),
            t.nbuckets, t.stash)
    found, slot, vals = probe_mod.probe(*args)
    want = t.find_slots(q)
    if not np.array_equal(found.cpu().numpy(), want >= 0):
        raise AssertionError("table_lookup: found != HostTable.find_slots")
    hit = want >= 0
    if not np.array_equal(slot.cpu().numpy()[hit], want[hit]):
        raise AssertionError("table_lookup: slot != HostTable.find_slots")
    if device == "cuda":
        cpu = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
        _equal((found, slot, vals), probe_mod.probe_plain(*cpu), "table_lookup")


def _probe_cases(device: str):
    from bng_tpu_torch import kernel_cases

    for name in kernel_cases.PROBE_SPECS:
        c = kernel_cases.probe_case(name)
        yield name, tuple(torch.from_numpy(a).to(device) for a in c[:4]) + (c.nbuckets, c.stash)


def _check_probe_cases_plain() -> None:
    from bng_tpu_torch.ops import probe as probe_mod

    for name, (krows, stash_rows, vals, q, nb, stash) in _probe_cases("cpu"):
        found, slot, out = probe_mod.probe_plain(krows, stash_rows, vals, q, nb, stash)
        K = q.shape[1]
        KW = stash_rows.shape[1]
        rows = torch.cat([krows.reshape(-1, KW), stash_rows])  # one key row per slot
        hit = found.nonzero()[:, 0]
        if not (torch.equal(rows[slot[hit].long(), :K], q[hit])
                and bool((rows[slot[hit].long(), K] != 0).all())
                and torch.equal(out[hit], vals[slot[hit].long()])
                and not bool(out[~found].any())):
            raise AssertionError(f"K1 plain {name}: a hit's row does not hold its query")


def _check_probe_cases_cuda() -> None:
    from bng_tpu_torch.ops import probe as probe_mod

    for name, args in _probe_cases("cuda"):
        _equal(probe_mod.probe_cuda(*args), probe_mod.probe_plain(*args), f"K1 {name}")


def _check_express(device: str) -> None:
    from bng_tpu_torch.ops.express import express_verdicts

    eng = _engine(device)
    prog = eng.compile_express_aot(B)
    if device == "cuda" and prog.graph is None:
        raise AssertionError("the express program is not a captured graph on the card")
    desc = _desc(_discovers(B, 0x100))
    got = prog(desc, NOW)
    got = (got.block.clone(), got.stats.clone())
    d = torch.from_numpy(desc.view(np.int32).copy())
    eager = express_verdicts(eng.tables.dhcp, d.to(eng.device), eng.geom.dhcp,
                             torch.tensor(NOW, device=eng.device))
    _equal(got, (eager.block, eager.stats), "express program vs its eager replay")
    if device == "cuda":
        cpu = express_verdicts(_cpu_copy(eng.tables).dhcp, d, eng.geom.dhcp, torch.tensor(NOW))
        _equal(got, (cpu.block, cpu.stats), "express program vs the CPU dispatch")
    if int(got[0][:, 0].sum()) != B:
        raise AssertionError("express program: not every cached DISCOVER answered")


def _check_devloop(device: str) -> None:
    from bng_tpu_torch.ops.express import XD_WORDS, express_verdicts
    from bng_tpu_torch.ops.table import PinnedStage

    eng = _engine(device)
    for k in (1, 8):
        prog = eng.compile_devloop_aot(k, B)
        if device == "cuda" and prog.graph is None:
            raise AssertionError(f"the k={k} ring program is not a captured graph on the card")
        prog.seed(eng.tables.dhcp)
        stage = PinnedStage((k, B, XD_WORDS), np.uint32, eng.device)
        for s in range(k):
            stage.host[s] = _desc(_discovers(B, 0x1000 + s * B))
        res = eng.call_devloop_aot(prog, None, stage, k, NOW)
        blocks, stats = res.blocks.clone(), res.dhcp_stats.clone()
        ring = torch.from_numpy(stage.host.view(np.int32).copy())
        for tables, dev, what in ((prog.tables, eng.device, "its eager replay"),
                                  (_cpu_copy(eng.tables).dhcp, torch.device("cpu"), "the CPU ring")):
            want = [express_verdicts(tables, ring[s].to(dev), eng.geom.dhcp,
                                     torch.tensor(NOW, device=dev)) for s in range(k)]
            want_stats = sum(w.stats for w in want) & 0xFFFFFFFF
            _equal((blocks, stats), (torch.stack([w.block for w in want]), want_stats),
                   f"k={k} ring vs {what}")
        if int(blocks[:, :, 0].sum()) != B * k:
            raise AssertionError(f"k={k} ring: not every cached DISCOVER answered")


def _check_pipeline(device: str) -> None:
    from bng_tpu_torch.ops.pipeline import pipeline_step

    eng = _engine(device, garden=True)
    frames = _discovers(128, 0x2000)
    pkt, length = eng._pack_frames(frames, eng.B)
    fa = np.ones((eng.B,), dtype=bool)
    now_s, now_us = torch.tensor(NOW), torch.tensor(5)

    def step(tables, dev):
        return pipeline_step(tables, torch.from_numpy(pkt).to(dev),
                             torch.from_numpy(length).to(dev), torch.from_numpy(fa).to(dev),
                             eng.geom, now_s.to(dev), now_us.to(dev))

    cpu_tables = _cpu_copy(eng.tables) if device == "cuda" else None
    got = step(eng.tables, eng.device)
    if device == "cuda":
        want = step(cpu_tables, torch.device("cpu"))
        for f in got._fields:
            a, b = getattr(got, f), getattr(want, f)
            if f == "tables" or a is None:
                continue
            _equal(a, b, f"fused step {f}")


def _check_sharded(device: str) -> None:
    """The sharded step and DHCP-only step over every visible card (one
    shard a card, as the reference's check runs one shard a device; 2
    shards sharing the card of a one-card host), equal to the CPU."""
    from bng_tpu_torch.parallel.sharded import ShardedCluster

    n = max(2, torch.cuda.device_count()) if device == "cuda" else 2

    def run(dev):
        cl = ShardedCluster(n, batch_per_shard=B, device=dev)
        pkt = np.zeros((n * B, 512), dtype=np.uint8)
        ln = np.zeros((n * B,), dtype=np.uint32)
        fa = np.ones((n * B,), dtype=bool)
        return cl.step(pkt, ln, fa, 1, 1), cl.dhcp_step(pkt, ln, 1)

    got = run(device)
    if device == "cuda":
        _equal(got, run("cpu"), "sharded step")


# (name, check, cuda_only); a check takes the gate's device ("cuda" or
# "cpu"). The cuda_only checks launch the CUDA kernels and cannot run
# elsewhere; the rest also run on the CPU so the tier-1 suite exercises
# the gate's harness.
CHECKS: list[tuple[str, Callable[[str], None], bool]] = [
    ("qos_kernel[plain]", lambda dev: _check_qos("cpu"), False),
    ("qos_kernel[cuda]", lambda dev: _check_qos("cuda"), True),
    ("seg_prefix_total[cuda]", lambda dev: _check_seg_cases(), True),
    ("table_lookup[plain]", lambda dev: _check_table("cpu"), False),
    ("table_lookup[plain-cases]", lambda dev: _check_probe_cases_plain(), False),
    ("table_lookup[cuda]", lambda dev: (_check_table("cuda"), _check_probe_cases_cuda()), True),
    ("devloop_ring[plain]", lambda dev: _check_devloop("cpu"), False),
    ("devloop_ring[cuda]", lambda dev: _check_devloop("cuda"), True),
    ("express_aot[plain]", lambda dev: _check_express("cpu"), False),
    ("express_aot[cuda]", lambda dev: _check_express("cuda"), True),
    ("fused_pipeline_step", _check_pipeline, False),
    ("sharded_step", _check_sharded, False),
]

# each port check -> the reference check it answers
REFERENCE_NAMES = {
    "qos_kernel[plain]": "qos_kernel[sort]",
    "qos_kernel[cuda]": "qos_kernel[pallas]",
    "seg_prefix_total[cuda]": "pallas_seg_prefix_total",
    "table_lookup[plain]": "table_lookup[xla]",
    "table_lookup[plain-cases]": "table_lookup[pallas-interp]",
    "table_lookup[cuda]": "table_lookup[pallas]",
    "devloop_ring[plain]": "dhcp_express[xla]",
    "devloop_ring[cuda]": "dhcp_express[pallas]",
    "express_aot[plain]": "express_aot[xla]",
    "express_aot[cuda]": "express_aot[pallas]",
    "fused_pipeline_step": "fused_pipeline_step",
    "sharded_step": "sharded_step",
}


def verify_cuda_kernels(verbose: bool = True,
                        cuda: bool = True) -> list[tuple[str, str | None]]:
    """Run every check of the gate: on the card with `cuda=True` (the two
    device-independent checks, the fused and the sharded step, then run on
    the card and compare with the CPU), or only the checks that are not
    CUDA-only on the CPU with `cuda=False`. Returns [(name, None | error
    text)]; raises nothing, callers decide."""
    results: list[tuple[str, str | None]] = []
    dev = "cuda" if cuda else "cpu"
    for name, check, cuda_only in CHECKS:
        if cuda_only and not cuda:
            continue
        try:
            check(dev)
            results.append((name, None))
            if verbose:
                print(f"  kernel gate OK   {name}")
        except Exception:  # noqa: BLE001 — the report carries the failure
            err = traceback.format_exc(limit=3)
            results.append((name, err))
            if verbose:
                print(f"  kernel gate FAIL {name}\n{err}")
    return results
