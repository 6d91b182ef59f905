#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's IPoE main path on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is swallowed):

1. Build: compile every CUDA source of `bng_tpu_torch/csrc/` for sm_90a
   (all nvcc processes started together) and print the nvcc commands and
   the `-Xptxas -v` report, plus the card's name and power limit.
2. Build the headline deployment through the port's own host API: 1M
   DHCP subscribers, 1M established NAT44 flows over 250k subscribers,
   10k QoS policies on flow subscribers (half with a burst below one
   packet), 10k strict antispoof bindings; B = 8192 frames in 512-byte
   slots, 20% cached DISCOVERs and 80% established UDP flows.
3. Kernels against their plain PyTorch versions on the card: K1 (probe)
   on the exact inputs of every probe of one main-path step, a ragged
   batch and every shared edge case of `bng_tpu_torch/kernel_cases.py`
   (scattered stash rows, no stash, an empty table, K = 8, V = 16, B from
   1 to 8192); K2 (seg_prefix) on the step's inputs and every shared K2
   case, which take both of its routes (B up to and past B_ONE), for
   prefix, total and both. Bit-equal or fail.
4. The main path: counts set to 0, 20 batches through `Engine.process`
   (DISCOVER lanes TX with the subscriber's yiaddr, flow lanes FWD with
   the SNAT source and valid IP and UDP checksums, QoS drops, a fresh
   flow punted and then forwarded), counts read: K1 8 and K2 4 per step.
5. One GPU step against the same step on the CPU (plain versions) from
   copied tables: identical verdicts, bytes, stats and tables.
6. Times with CUDA events: each kernel and its plain version at the main
   path's shapes (device time: the stream is held while the host queues
   the calls; each kernel also with L2 flushed before every call), K2 at
   B = 32, K2's sweep route past B_ONE, a one-thread launch floor, the
   device step (Mpps, p50/p99), `Engine.process` per batch with the
   host, peak device memory. `--profile` adds a torch.profiler trace of
   a few steps.

The line before the last is the card's name and power limit; the one
before it the kernels JSON; the last line the result JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from bng_tpu_torch import convert, kernel_cases, kernels
from bng_tpu_torch import frames as F
from bng_tpu_torch.control.nat import NATManager
from bng_tpu_torch.ops import probe as probe_mod
from bng_tpu_torch.ops import qos as qos_mod
from bng_tpu_torch.ops import seg_prefix as seg_mod
from bng_tpu_torch.ops import table as table_mod
from bng_tpu_torch.ops.antispoof import MODE_LOOSE, MODE_STRICT
from bng_tpu_torch.ops.hashing import SEED1, hash_words, u32
from bng_tpu_torch.ops.pipeline import pipeline_step
from bng_tpu_torch.runtime.engine import AntispoofTables, Engine, QoSTables
from bng_tpu_torch.runtime.tables import FastPathTables
from bng_tpu_torch.utils.net import ip_to_u32

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
NOW = 1_753_000_000
L = 512
B = 8192
N_SUBS = 1_000_000
N_FLOWS = 1_000_000
N_NAT_SUBS = 250_000
N_QOS = 10_000
N_BINDINGS = 10_000
BATCHES = 20


def say(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls.

    A spin kernel holds the stream while the host queues the calls, so the
    events time the device's work and not the host's rate of issuing it.
    If queueing outlasted the spin (a host stall), it is measured again
    with a longer spin. With `flush` (a tensor larger than L2) each call
    is timed alone after zeroing it, so the call starts with a cold L2."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    if flush is not None:
        flush.zero_()
    torch.cuda.synchronize()
    spin_s = max(0.02, 10 * iters * (time.perf_counter() - t))
    n_ev = iters if flush is not None else 1
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(n_ev)]
    for _ in range(3):
        spin_s = min(spin_s, 1.0)
        torch.cuda._sleep(int(spin_s * 2e9))  # cycles; at most 2 GHz, so it spins >= spin_s
        t = time.perf_counter()
        if flush is None:
            evs[0][0].record()
            for _ in range(iters):
                fn()
            evs[0][1].record()
        else:
            for start, end in evs:
                flush.zero_()
                start.record()
                fn()
                end.record()
        queued_s = time.perf_counter() - t
        torch.cuda.synchronize()
        if queued_s < spin_s:
            break
        spin_s = 4 * queued_s
    else:
        say(f"note: queueing {iters} calls took {queued_s * 1e3:.1f} ms, longer than the spin; "
            "this time includes host stalls")
    return sum(s.elapsed_time(e) for s, e in evs) / iters


# ---------------------------------------------------------------- deployment

def sub_mac(i: int) -> bytes:
    return (0x02AA00000000 + int(i)).to_bytes(6, "big")


def flow_mac(ip: int) -> bytes:
    return b"\x02\x00" + int(ip).to_bytes(4, "big")


def build_deployment(device):
    """The headline deployment, built through the port's host API."""
    sub_nb = 1 << max(10, (N_SUBS * 2 // 4).bit_length())  # ~50% load, 4-way
    fp = FastPathTables(sub_nbuckets=sub_nb, vlan_nbuckets=1 << 10, cid_nbuckets=1 << 10,
                        max_pools=64, stash=256)
    fp.set_server_config(bytes.fromhex("02aabbccdd01"), ip_to_u32("10.0.0.1"))
    for pid in range(max(1, (N_SUBS >> 16) + 1)):  # /16 pools holding N addresses
        fp.add_pool(pid + 1, ip_to_u32(f"10.{pid}.0.0") & 0xFFFF0000, 16, ip_to_u32("10.0.0.1"),
                    ip_to_u32("1.1.1.1"), ip_to_u32("8.8.8.8"), 86400)
    idx = np.arange(N_SUBS, dtype=np.uint64)
    fp.add_subscribers_bulk(idx + 0x02AA00000000,
                            pool_ids=(idx >> np.uint64(16)).astype(np.uint32) + 1,
                            ips=((10 << 24) + 2 + idx).astype(np.uint32),
                            lease_expiries=np.uint32(NOW + 86400))

    sess_nb = 1 << max(10, (N_FLOWS * 2 // 4).bit_length())
    n_pub = max(4, -(-N_NAT_SUBS // 1008) + 1)
    nat = NATManager(public_ips=[ip_to_u32("203.0.113.1") + i for i in range(n_pub)],
                     ports_per_subscriber=64, sessions_nbuckets=sess_nb,
                     sub_nat_nbuckets=sub_nb, stash=256)
    fi = np.arange(N_FLOWS, dtype=np.int64)
    src_ips = ((10 << 24) + 2 + fi % N_NAT_SUBS).astype(np.uint32)
    dst_ips = (ip_to_u32("93.184.0.0") + fi // N_NAT_SUBS).astype(np.uint32)
    sports = (20000 + fi // N_NAT_SUBS).astype(np.uint32)
    made = nat.bulk_allocate_nat(np.unique(src_ips), NOW)
    nat_ip, nat_port, ok = nat.bulk_flows(src_ips, dst_ips, sports, np.uint32(443),
                                          np.uint32(17), 100, NOW)
    check(made == N_NAT_SUBS and bool(ok.all()), "every NAT flow was allocated")
    flows = np.stack([src_ips, dst_ips, sports, nat_ip, nat_port], axis=1).astype(np.int64)

    qos = QoSTables(nbuckets=1 << 13)
    pol = (10 << 24) + 2 + np.arange(N_QOS, dtype=np.int64) * (N_NAT_SUBS // N_QOS)
    # half with a burst below one 222-byte frame (every lane drops), half generous
    qos.bulk_set_subscribers(pol[: N_QOS // 2], down_bps=64_000, up_bps=64_000,
                             down_burst=150, up_burst=150)
    qos.bulk_set_subscribers(pol[N_QOS // 2:], down_bps=10_000_000, up_bps=2_000_000)

    spoof = AntispoofTables(nbuckets=1 << 14, stash=64)
    spoof.set_config(MODE_LOOSE, False)
    spoof.add_allowed_range(ip_to_u32("10.0.0.0"), 8)
    bound = (10 << 24) + 2 + np.arange(N_BINDINGS, dtype=np.int64) * 7
    keys = np.array([[int.from_bytes(flow_mac(ip)[:2], "big"),
                      int.from_bytes(flow_mac(ip)[2:], "big")] for ip in bound], dtype=np.uint32)
    rows = np.zeros((N_BINDINGS, 8), dtype=np.uint32)
    rows[:, 0] = bound  # AB_IPV4
    rows[:, 5] = 1  # AB_VALIDS: VALID_V4
    rows[:, 6] = MODE_STRICT  # AB_MODE
    spoof.bindings.bulk_insert(keys, rows)

    eng = Engine(fp, nat, qos, spoof, batch_size=B, pkt_slot=L, device=device)
    return eng, flows, set(int(x) for x in pol[: N_QOS // 2])


def make_batch(rng, flows, fresh=()):
    """20% cached DISCOVERs, 80% established flows (+ `fresh` flows first)."""
    frames, expect = [], []
    for f in fresh:
        frames.append(F.with_udp_checksum(
            F.udp_packet(flow_mac(f[0]), b"\x04" * 6, f[0], f[1], f[2], 443, b"x" * 180)))
        expect.append(("fresh", f))
    n_dhcp = B // 5
    for row in range(len(frames), B):
        if row < n_dhcp:
            i = int(rng.integers(N_SUBS))
            frames.append(F.discover_frame(sub_mac(i), 0x1000 + row))
            expect.append(("dhcp", (10 << 24) + 2 + i))
        else:
            f = flows[int(rng.integers(len(flows)))]
            frames.append(F.with_udp_checksum(F.udp_packet(
                flow_mac(f[0]), b"\x04" * 6, int(f[0]), int(f[1]), int(f[2]), 443, b"x" * 180)))
            expect.append(("flow", f))
    return frames, expect


def check_outputs(out, expect, drop_ips, fresh_ok: bool):
    """TX lanes carry the subscriber's yiaddr; flow lanes FWD with the SNAT
    source and valid IP and UDP checksums, or DROP for a policed subscriber."""
    tx = dict(out["tx"])
    fwd = dict(out["fwd"])
    dropped = set(out["dropped"])
    slow = dict(out["slow"])
    n_drop = 0
    for lane, (kind, info) in enumerate(expect):
        if kind == "dhcp":
            check(lane in tx, f"DISCOVER lane {lane} answered on the device")
            reply = F.decode_dhcp(F.decode(tx[lane]).payload)
            check(reply.msg_type == F.OFFER and reply.yiaddr == info, f"OFFER yiaddr lane {lane}")
        elif kind == "flow":
            if int(info[0]) in drop_ips:
                check(lane in dropped, f"policed flow lane {lane} dropped")
                n_drop += 1
                continue
            check(lane in fwd, f"flow lane {lane} forwarded")
            d = F.decode(fwd[lane])
            check(d.src_ip == int(info[3]) and d.src_port == int(info[4]) and d.ip_checksum_ok
                  and d.l4_checksum != 0 and F.l4_checksum_ok(fwd[lane]),
                  f"SNAT rewrite and IP and UDP checksums, lane {lane}")
        else:
            check((lane in fwd) if fresh_ok else (lane in slow), f"fresh flow lane {lane}")
    return n_drop


# ------------------------------------------------------------------- phases

def record_kernel_inputs(eng, pkt, length, fa):
    """Run one main-path step and keep the exact inputs of every kernel call."""
    rec = {"probe": [], "seg_prefix": []}
    orig_probe, orig_seg = table_mod.probe, qos_mod.seg_prefix_total

    def probe_rec(*args):
        rec["probe"].append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return orig_probe(*args)

    def seg_rec(slot, vec, compute="both"):
        rec["seg_prefix"].append((slot.clone(), vec.clone(), compute))
        return orig_seg(slot, vec, compute)

    table_mod.probe, qos_mod.seg_prefix_total = probe_rec, seg_rec
    try:
        eng.step(pkt, length, fa, NOW + 1)
    finally:
        table_mod.probe, qos_mod.seg_prefix_total = orig_probe, orig_seg
    torch.cuda.synchronize()
    check(len(rec["probe"]) == 8 and len(rec["seg_prefix"]) == 4, "8 probes + 4 seg calls per step")
    return rec


def kernels_vs_plain(rec, device):
    """Both kernels against their plain versions on every main-path call
    and every shared edge case, bit for bit; returns {kernel: max |err|}."""
    cases = [("main-path", a) for a in rec["probe"]]
    args = rec["probe"][3]  # the DHCP subscriber-table probe, cut to a ragged batch
    cases.append(("ragged B=1000", args[:3] + (args[3][:1000].contiguous(),) + args[4:]))
    for name in kernel_cases.PROBE_SPECS:
        c = kernel_cases.probe_case(name)
        cases.append((name, tuple(torch.from_numpy(a).to(device) for a in c[:4])
                      + (c.nbuckets, c.stash)))
    err = {"probe": 0.0, "seg_prefix": 0.0}
    for name, a in cases:
        got = probe_mod.probe_cuda(*a)
        ref = probe_mod.probe_plain(*a)
        for g, r, f in zip(got, ref, ("found", "slot", "vals")):
            d = (g.long() - r.long()).abs().max().item() if g.numel() else 0
            err["probe"] = max(err["probe"], float(d))
            check(torch.equal(g, r), f"K1 {name} K={a[3].shape[1]} {f} bit-equal")
    say(f"K1 bit-equal to its plain version on {len(cases)} cases")

    seg_cases = [("main-path", s, v, c) for s, v, c in rec["seg_prefix"]]
    for name in kernel_cases.SEG_SPECS:
        c = kernel_cases.seg_case(name)
        seg_cases.append((name, torch.from_numpy(c.slot).to(device),
                          torch.from_numpy(c.vec).to(device), c.compute))
    check(max(s.shape[0] for _, s, _, _ in seg_cases) > seg_mod.B_ONE, "K2 sweep route covered")
    for name, s, v, c in seg_cases:
        got = seg_mod.seg_prefix_cuda(s, v, c)
        ref = seg_mod.seg_prefix_plain(s, v, c)
        for g, r in zip(got, ref):
            err["seg_prefix"] = max(err["seg_prefix"], (g - r).abs().max().item())
        check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              f"K2 {name} {c} bit-equal")
    say(f"K2 (both routes) bit-equal to its plain version on {len(seg_cases)} cases")
    return err


def gpu_step_equals_cpu_step(eng, pkt, length, fa):
    dev = eng.device
    cpu_tables = convert.tables_from_numpy(convert.tables_to_numpy(eng.tables), "cpu")
    now_s, now_us = torch.tensor(NOW + 100), torch.tensor((NOW + 100) * 10**6 & 0xFFFFFFFF)
    g = pipeline_step(eng.tables, torch.from_numpy(pkt).to(dev), torch.from_numpy(length).to(dev),
                      torch.from_numpy(fa).to(dev), eng.geom, now_s.to(dev), now_us.to(dev))
    c = pipeline_step(cpu_tables, torch.from_numpy(pkt), torch.from_numpy(length),
                      torch.from_numpy(fa), eng.geom, now_s, now_us)
    for f in g._fields:
        if f == "tables":
            continue
        check(torch.equal(getattr(g, f).cpu(), getattr(c, f)), f"GPU step {f} == CPU step")
    gt, ct = convert.tables_to_numpy(eng.tables), convert.tables_to_numpy(cpu_tables)

    def walk(a, b, path):
        if isinstance(a, np.ndarray):
            check(np.array_equal(a, b), f"GPU tables {path} == CPU tables")
        elif a is not None:
            for name, x, y in zip(a._fields, a, b):
                walk(x, y, f"{path}.{name}")

    walk(gt, ct, "tables")
    say("GPU step == CPU step: verdicts, bytes, stats and tables identical")


def probe_bound_ms(a) -> float:
    """Least K1 time for one call: the bytes this call's data needs over HBM."""
    krows, stash_rows, vals, q, nb, stash = a
    Bq, K = q.shape
    KW = stash_rows.shape[1]
    V = vals.shape[1]
    found, slot, _ = probe_mod.probe_plain(*a)
    b1 = hash_words([u32(q[:, k]) for k in range(K)], SEED1) & (nb - 1)
    hit_b1 = found & (slot.long() // 4 == b1) & (slot.long() < nb * 4)
    rows = Bq * 2 - int(hit_b1.sum())  # a b1 hit reads one bucket row, else two
    nbytes = (Bq * K * 4 + rows * 4 * KW * 4 + int(found.sum()) * V * 4 + stash * KW * 4
              + Bq * (1 + 4 + V * 4))
    return nbytes / HBM_BYTES_PER_S * 1e3


def seg_bound_ms(s, v, compute) -> float:
    """Least K2 time: the function's bytes over HBM (slot and vec read, the
    asked outputs written). A segmented scan does O(B) adds, far below the
    bytes' time, so the bytes bound it."""
    Bq = s.shape[0]
    outs = 2 if compute == "both" else 1
    return (Bq * 8 + Bq * 4 * outs) / HBM_BYTES_PER_S * 1e3


def profile_step(step, card: str, steps: int = 5) -> None:
    """torch.profiler over `steps` device steps: per-stage host and device
    time, the top kernels by device time, launches per step and the
    device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t1 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t1) * 1e6
    ka = prof.key_averages()
    # "bng::" rows are the stage ranges: once as host ops (their children's
    # device time) and once as device-side annotations spanning the stage,
    # which are not device work and stay out of the busy sum
    dev = sum(e.self_device_time_total for e in ka if not e.key.startswith("bng::"))
    launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                    "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    say(f"profile over {steps} steps [{card}]: wall {wall_us / steps / 1e3:.3f} ms/step, "
        f"device busy {dev / steps / 1e3:.3f} ms/step ({100 * dev / wall_us:.1f}% busy), "
        f"{launches / steps:.0f} kernel launches/step")
    for e in sorted((e for e in ka if e.key.startswith("bng::") and e.cpu_time_total > 0),
                    key=lambda e: -e.cpu_time_total):
        say(f"  stage {e.key}: host {e.cpu_time_total / steps / 1e3:.3f} ms/step, "
            f"device {e.device_time_total / steps / 1e3:.3f} ms/step")
    ops = [e for e in ka if not e.key.startswith("bng::")]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:12]:
        say(f"  op {e.key[:60]}: device {e.self_device_time_total / steps / 1e3:.4f} ms/step, "
            f"{e.count / steps:.0f} calls/step")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a few device steps with torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    check(torch.cuda.device_count() == 1,
          f"one visible card (found {torch.cuda.device_count()}; set CUDA_VISIBLE_DEVICES)")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    for name, (cmd, log) in kernels.build().items():
        print(" ".join(cmd))
        for line in log.splitlines():
            if "ptxas" in line or "error" in line:
                print(f"  {line.strip()}")
    for name in kernels.SIGNATURES:
        kernels.entry(name)
    say(f"built and loaded {list(kernels.SIGNATURES)} in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    eng, flows, drop_ips = build_deployment(device)
    torch.cuda.synchronize()
    say(f"deployment built and uploaded in {time.perf_counter() - t0:.1f}s "
        f"(device tables {torch.cuda.memory_allocated() / 2**30:.3f} GiB)")

    rng = np.random.default_rng(42)
    frames, expect = make_batch(rng, flows)
    pkt, length = eng._pack_frames(frames, B)
    fa = np.ones((B,), dtype=bool)
    rec = record_kernel_inputs(eng, pkt, length, fa)
    max_err = kernels_vs_plain(rec, device)  # {kernel: max |kernel - plain|}

    # ---- the main path: counts 0, drive, read ----
    torch.cuda.reset_peak_memory_stats()
    batches = [make_batch(rng, flows) for _ in range(BATCHES)]
    fresh_ids = rng.integers(len(flows), size=8)
    fresh = [(int(flows[i, 0]), int(flows[i, 1]), 31000 + k) for k, i in enumerate(fresh_ids)
             if int(flows[i, 0]) not in drop_ips]
    batches[3] = make_batch(rng, flows, fresh)
    batches[4] = make_batch(rng, flows, fresh)
    kernels.reset_launches()
    proc_ms, n_drop = [], 0
    for k, (frames, expect) in enumerate(batches):
        t1 = time.perf_counter()
        out = eng.process(frames, from_access=True, now=NOW + 2 + k * 0.01)
        proc_ms.append((time.perf_counter() - t1) * 1e3)
        n_drop += check_outputs(out, expect, drop_ips, fresh_ok=(k == 4))
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(launches["probe"] == 8 * BATCHES, f"K1 launched 8 per step ({launches})")
    check(launches["seg_prefix"] == 4 * BATCHES, f"K2 launched 4 per step ({launches})")
    check(n_drop > 0 and eng.stats.dropped == n_drop, "QoS drops on policed subscribers")
    check(len(fresh) > 0, "fresh flows present")
    say(f"main path: {BATCHES} batches of {B}; tx {eng.stats.tx} fwd {eng.stats.fwd} "
        f"dropped {eng.stats.dropped} passed {eng.stats.passed}; launches {launches}")

    gpu_step_equals_cpu_step(eng, pkt, length, fa)

    # ---- times ----
    kern = {"probe": {"ms": [], "plain": [], "bound": []},
            "seg_prefix": {"ms": [], "plain": [], "bound": []}}
    # warm: repeated calls on one input; cold: L2 (50 MB) flushed before each call
    flush = torch.empty(2**25, dtype=torch.int32, device=device)  # 128 MiB
    for j, a in enumerate(rec["probe"]):
        ms = cuda_ms(lambda: probe_mod.probe_cuda(*a))
        cold = cuda_ms(lambda: probe_mod.probe_cuda(*a), flush=flush)
        pl = cuda_ms(lambda: probe_mod.probe_plain(*a), iters=5)
        bd = probe_bound_ms(a)
        kern["probe"]["ms"].append(ms)
        kern["probe"]["plain"].append(pl)
        kern["probe"]["bound"].append(bd)
        say(f"  K1 call {j}: K={a[3].shape[1]} V={a[2].shape[1]} nbuckets={a[4]} "
            f"stash={a[5]}: {ms:.4f} ms (cold L2 {cold:.4f}), plain {pl:.4f} ms, "
            f"bound {bd:.6f} ms [{card}]")
    for j, (s, v, c) in enumerate(rec["seg_prefix"]):
        ms = cuda_ms(lambda: seg_mod.seg_prefix_cuda(s, v, c))
        cold = cuda_ms(lambda: seg_mod.seg_prefix_cuda(s, v, c), flush=flush)
        pl = cuda_ms(lambda: seg_mod.seg_prefix_plain(s, v, c), iters=5)
        bd = seg_bound_ms(s, v, c)
        kern["seg_prefix"]["ms"].append(ms)
        kern["seg_prefix"]["plain"].append(pl)
        kern["seg_prefix"]["bound"].append(bd)
        say(f"  K2 call {j} ({c}): {ms:.4f} ms (cold L2 {cold:.4f}), plain {pl:.4f} ms, "
            f"bound {bd:.6f} ms [{card}]")
    del flush
    s1, v1 = rec["seg_prefix"][0][0][:32].contiguous(), rec["seg_prefix"][0][1][:32].contiguous()
    say(f"  K2 at B=32 (the one-CTA route's fixed work): "
        f"{cuda_ms(lambda: seg_mod.seg_prefix_cuda(s1, v1)):.4f} ms [{card}]")
    big = kernel_cases.seg_case(f"mixed-B{seg_mod.B_ONE + 1}/both")
    s2, v2 = torch.from_numpy(big.slot).to(device), torch.from_numpy(big.vec).to(device)
    say(f"  K2 sweep route at B={seg_mod.B_ONE + 1}: "
        f"{cuda_ms(lambda: seg_mod.seg_prefix_cuda(s2, v2)):.4f} ms [{card}]")
    say(f"  one-block launch floor (torch.cuda._sleep(0), one thread): "
        f"{cuda_ms(lambda: torch.cuda._sleep(0), iters=100):.4f} ms [{card}]")

    pkt_d, len_d = torch.from_numpy(pkt).to(device), torch.from_numpy(length).to(device)
    fa_d = torch.from_numpy(fa).to(device)
    now_s, now_us = torch.tensor(NOW + 200, device=device), torch.tensor(5, device=device)
    step = lambda: pipeline_step(eng.tables, pkt_d, len_d, fa_d, eng.geom, now_s, now_us)  # noqa: E731
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    lat = []
    for _ in range(100):
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
    lat = np.array(lat)
    say(f"device step B={B}: {B / (lat.mean() / 1e3) / 1e6:.4f} Mpps, p50 {np.percentile(lat, 50):.3f} ms, "
        f"p99 {np.percentile(lat, 99):.3f} ms, max {lat.max():.3f} ms over {len(lat)} steps "
        f"(host clock, synced) [{card}]")
    say(f"Engine.process per batch (host included): mean {np.mean(proc_ms):.2f} ms, "
        f"p50 {np.percentile(proc_ms, 50):.2f} ms over {BATCHES} batches; "
        f"peak device memory {peak_gib:.3f} GiB [{card}]")
    if args.profile:
        profile_step(step, card)

    src = {"probe": ("cuda", "bng_tpu_torch/csrc/probe.cu", "bng_tpu/ops/pallas_table.py:261"),
           "seg_prefix": ("cuda", "bng_tpu_torch/csrc/seg_prefix.cu",
                          "bng_tpu/ops/pallas_qos.py:127")}
    line = {"kernels": [
        {"name": name, "route": src[name][0], "source": src[name][1], "replaces": src[name][2],
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": float(np.mean(kern[name]["ms"])), "plain_ms": float(np.mean(kern[name]["plain"])),
         "bound_ms": float(np.mean(kern[name]["bound"])),
         "bound_by": "bytes", "library_ms": None}
        for name in ("probe", "seg_prefix")]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
