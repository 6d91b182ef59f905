#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA H100.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero; no phase's error is swallowed):

1. Build: compile every CUDA source of `bng_tpu_torch/csrc/` for sm_90a
   (all nvcc processes started together) and print the nvcc commands and
   the `-Xptxas -v` report, plus the card's name and power limit. (The
   native ring, `csrc/bngring.cpp`, is built with g++ at its first use in
   phase 12.)
2. Build the headline deployment through the port's own host API: 1M
   DHCP subscribers, 1M established NAT44 flows over 250k subscribers,
   10k QoS policies on flow subscribers (half with a burst below one
   packet), 10k strict antispoof bindings; B = 8192 frames in 512-byte
   slots, 20% cached DISCOVERs and 80% established UDP flows.
3. Kernels against their plain PyTorch versions on the card: K1 (probe)
   on the exact inputs of every probe of one IPoE step, a ragged batch
   and every shared edge case of `bng_tpu_torch/kernel_cases.py`
   (scattered stash rows, no stash, an empty table, K = 8, V = 16, B from
   1 to 8192); K2 (seg_prefix) on the step's inputs and every shared K2
   case, which take both of its routes (B up to and past B_ONE), for
   prefix, total and both. Bit-equal or fail.
4. The IPoE path: counts set to 0, 20 batches through `Engine.process`
   (DISCOVER lanes TX with the subscriber's yiaddr, flow lanes FWD with
   the SNAT source and valid IP and UDP checksums, QoS drops, a fresh
   flow punted and then forwarded), counts read: K1 8 and K2 4 per step.
5. One IPoE GPU step against the same step on the CPU (plain versions)
   from copied tables: identical verdicts, bytes, stats and tables.
6. IPoE times with CUDA events: each kernel and its plain version at the
   step's shapes (device time: the stream is held while the host queues
   the calls; each kernel also with L2 flushed before every call), K2 at
   B = 32, K2's sweep route past B_ONE, a one-thread launch floor, the
   device step (Mpps, p50/p99), `Engine.process` per batch with the host
   (split into pack / dispatch / wait / demux). Then IPoE batches through
   `Engine.process` under the scalar and the vector host path in turns
   (`runtime/hostpath.StagingPool`): identical outputs, the split of each.
7. The full-stack deployment, on the headline's host tables (the IPoE
   engine is retired first): 65,534 PPPoE sessions under one access
   concentrator, each with one NAT44 flow; 10,000 gardened subscribers
   with 4 allowed destinations; 64 armed intercept taps (half filtered);
   a next-hop route for each of the 250k flow subscribers over 4
   gateways. The batch mixes cached DISCOVERs, IPoE flows (some tapped),
   QinQ PPPoE upstream data, downstream data to PPPoE subscribers,
   gardened traffic, PPPoE discovery/LCP and unknown sessions.
8. Both kernels against their plain versions, bit-equal, on the exact
   inputs of all 13 K1 and 4 K2 calls of one full-stack step and the 3
   K1 calls of one DHCP-only batch.
9. The full-stack path: counts 0, 10 batches through `Engine.process`,
   every lane checked (TX yiaddr; decapped and SNAT'd bytes; DNAT'd and
   encapped bytes; garden drops; mirror-sink calls with the warrant id;
   the routed dst MAC; PASS for control and unknown sessions), counts
   read: K1 13 and K2 4 per step.
10. One full-stack GPU step against the same step on the CPU: every
    result leaf (mirror and the garden, PPPoE and edge stats too) and
    every table word identical. Then a full-stack and a DHCP-only
    dispatch, each shipping a dirty table row, under torch's sync debug
    mode: no synchronizing CUDA call.
11. The DHCP-only lane: counts 0, `process_dhcp` on 8192 cached
    DISCOVERs per batch, counts read: K1 3 and K2 0 per batch.
12. The ring loops: an all-control batch (the DHCP-only program) and the
    full-stack mix through `process_ring` and `process_ring_pipelined` +
    `flush_pipeline`, the latter over the scalar `PyRing`, the vector
    `PyRing` and the `NativeRing` (built by g++ into
    `bng_tpu_torch/_build/` and loaded, or the run fails); TX/FWD frames
    equal `process` on the same frames, and frames and stats are identical
    across the three rings; counts read.
13. Full-stack times: the device step in turns with the IPoE-only step
    on the same tables and batch (Mpps, p50/p99, their ratio);
    `Engine.process`, `process_dhcp` and `process_ring_pipelined` (over
    each ring) per batch, each split into pack / dispatch / wait / demux; every K1/K2
    call of the full-stack step (the five new call sites printed apart);
    peak device memory. `--profile` adds torch.profiler traces of a few
    IPoE and full-stack steps.
14. The serving stack on the headline's host tables (the full-stack engine
    retired first): a `DHCPServer` with a /16 pool of its own (pool 17,
    10.48.0.0/16), `Engine(slow_path=server.handle_frame)` and a
    `TieredScheduler` at the CLI defaults (express batch 64, 200 us
    deadline, express program on, bulk batch 8192 at depth 2, a drain
    every bulk step). The express program must be a captured CUDA graph of
    3 K1 and 0 K2 launches; K1 bit-equal to its plain version on its three
    probes (K = 1, 8, 2 at B = 64); one graph replay equal to the same
    dispatch on the CPU from copied tables.
15. The DORA storm: counts 0, 8192 new clients in waves of 64 (DISCOVER,
    REQUEST once the OFFER is back, a renewal once the ACK is back) with
    cached DISCOVERs and batches of phase 4's IPoE mix, all submitted and
    polled. Every OFFER and ACK from pool 17 with one yiaddr per client,
    every renewal answered on the device with the slow path's bytes,
    cached DISCOVERs with the table's yiaddr, the bulk lanes as in phase 4,
    no express miss or fallback, and the counts: 3 K1 per express
    dispatch, 8 K1 and 4 K2 per bulk step. Then an express and a bulk
    dispatch under torch's sync debug mode: no synchronising call.
16. Express OFFER latency (submit -> retire) with the bulk lane idle (counts
    0: 3 K1, 0 K2 per dispatch), for a lone frame, and right after a bulk
    dispatch; the express dispatch split (admission, drain, upload,
    replay, wait, render, slow path) and, idle and busy, each lane's
    dispatch and retire time per round; DORAs/s; bulk frames/s with the
    host; the express descriptor upload, a fresh pinned buffer against the
    program's persistent ones; the render of bursts under the scalar and
    the vector host path (identical bytes), for one template group and
    for many.
17. The express graph's device time and K1's at each express probe.
18. The devloop (`express_loop="devloop"`, k = 8): two fresh serving
    stacks, the aot lane's and the devloop's, from the same host tables
    and a held clock, give the same reply bytes for a DORA storm of new
    clients and 200 bursts of 64 cached DISCOVERs; the ring program is a
    captured graph of 3k K1 and 0 K2 launches; K1 bit-equal to its plain
    version on every probe of one eager ring; one graph replay's blocks,
    stats and cursors equal the same ring on the CPU from copied tables.
19. An injected `devloop.dispatch` fail: the ring's slots served per
    batch, counted, the same bytes; a ring dispatch shipping a dirty lease
    row makes no synchronising CUDA call and no staging wait.
20. The devloop's DORA storm (counts 0: 3k K1 per ring, 8 K1 + 4 K2 per
    bulk step; DORAs/s, the per-ring host split), its OFFER latency (bursts
    with the bulk lane idle, lone DISCOVERs, bursts right after a bulk
    dispatch), the cursor audit after quiesce.
21. Full rings at k = 8, 1 and 16: one device dispatch per k express
    batches and 3k K1 per ring by the counts; the ring graph's device time
    per replay at each k, and K1's at the probes of one slot.
22. Warm restart of the headline deployment (the devloop stacks retired
    first): an engine over the headline's host tables serves 3 batches (NAT
    counters and QoS tokens become device-written), then `quiesce`, the
    fold, `build_checkpoint`, `encode_checkpoint`, a save through
    `control/statestore.CheckpointStore` into a temporary directory and
    `load_latest` (read, CRC verify, decode). The file restores into fresh
    host mirrors of the same geometry and a fresh `Engine` (one upload).
    Counts 0: 3 batches and 8192 renewals on the restored engine (8 K1 and
    4 K2 per step), every lane checked, no slow-path call; the original
    engine on the same batches gives every lane and table word equal; K1
    and K2 bit-equal to their plain versions on every call of a restored
    step; a CPU engine restored from the same bytes gives the GPU engine's
    outputs and table words. Printed: the checkpoint's bytes, the seconds
    of each step, the time-to-serve (from the start of `load_latest` to
    the first batch retired; the temporary directory's clean-up between
    the read and the hydrate is left out) and the peak device memory.
23. Blue/green swap of a devloop serving stack (k = 8) under traffic: 256
    cached DISCOVERs and 2,048 flows in flight at the barrier, 256 new
    subscriber rows written between the snapshot and the flip
    (`runtime/ops.blue_green_swap`, audit on). The report's fields, the
    express burst latency just before and just after; the standby's
    express graph and ring program captured anew, its bursts' bytes equal
    to the active's before, the new rows answered on its device, no sync
    in a ring dispatch after the flip, its ring graph against the CPU. Then
    an armed `ops.swap` fail: rolled back, the active engine healed and
    serving the same bytes, K1/K2 bit-equal on every call of the replay;
    the rows written during that swap reach the published tables through
    the heal's upload but not the devloop's leading copy (the reference's
    pump keeps its chain over a resync), so their DISCOVERs take the slow
    path.

24. The sharded deployment (the headline's host tables retired first):
    `ShardedCluster` of 8 logical shards on the card, 8 x 1024 lanes, built
    on the headline's host data (1M DHCP subscribers hash-sharded through
    `add_subscribers_bulk`; 1M NAT44 flows over 250k subscribers, each on
    its affinity shard, 2,000 of them created 1,000 s early; 10k QoS
    policies and 10k strict bindings on their affinity shards; the garden
    on). Batches come from the sharded `NativeRing`: per shard 204 cached
    DISCOVERs the ring steers there (owned anywhere) and 820 flows it
    steers to their owner. One batch through `step`: every lane (OFFER
    with the yiaddr from any shard, SNAT, QoS drop), the summed stats, and
    K1 and K2 bit-equal to their plain versions on all 240 and 32 calls;
    a DHCP-only step: 8192 OFFERs, K1 bit-equal on its 192 calls.
25. A skewed batch (every DISCOVER owned by shard 0): each region's lanes
    up to the exchange capacity get the right OFFER, the rest PASS.
26. The sharded step on the card against the same step on the CPU from
    copied tables, two batches: every result leaf and every shard's table
    words identical; a sharded fused and a sharded DHCP-only dispatch,
    each shipping dirty rows, make no synchronising CUDA call.
27. `process_ring_pipelined` over 6 mixed batches (counts 0: N x (6 + 3N)
    = 240 K1 and 4N = 32 K2 per step) and an all-control batch through
    `process_ring` (3N x N = 192 K1, 0 K2).
28. Times: the staged sharded step (Mpps, p50/p99), the pipelined loop
    per batch split into assemble / drain / dispatch / wait / demux, a
    torch.profiler count of launches per sharded step and the device's
    busy share, shard 0's K1/K2 calls; `expire` sweeping the 2,000 aged
    flows on every shard (their deletions drain with the next batch);
    peak device memory.
29. The sharded checkpoint at full size: fold, `build_sharded_checkpoint`,
    encode and decode, a slot-exact restore into `clone_empty()`: every word
    of the 8 shards' tables equal; the next step on both (counts 0: 240 K1
    and 32 K2, bit-equal to their plain versions) gives equal outputs and
    tables. `sharded_blue_green_swap` with its report. Then an 8 -> 4
    re-shard of a reduced deployment (16,384 subscribers, 4,096 NAT blocks
    whose 16,384 flows re-establish by punt, 1,024 QoS policies and
    bindings; cut because the walk inserts row by row on the host): its
    seconds, per row too, and every row on the shard a 4-shard cluster
    built from the same rows holds it.
30. `dryrun_multichip(8)` on the card, its MULTICHIP-TELEMETRY line printed.
31. The kernel gate: `runtime/verify.verify_cuda_kernels(cuda=True)`, every
    check passes (K1 and K2 against their plain versions on every case of
    `kernel_cases.py`, the express graph and the ring graph at k = 1 and 8
    against their eager replays and the CPU, the QoS stage, the fused
    step and the sharded step at N = 2 against the CPU).
32. The profiler: `utils/profiling.profile_step_durations` (CUDA events) on
    the IPoE device step of the headline deployment, its p50/p99 printed
    beside `time_device_steps`' host-clock figures. It runs inside phase
    6, where that deployment lives (it is retired before phase 24).
33. `loadtest` in-process through `bng_tpu_torch.cli.main` at the
    reference's `dhcp_benchmark.go` defaults (batch 256, 10,000 MACs,
    renewal ratio 0.8, pool /16; `--duration 10 --warmup 2 --json
    --bench-log`), once on the engine and once with `--scheduler`, counts
    0 before each: 0 errors, a response to every request, fast-path hits,
    3 K1 and 0 K2 per device dispatch, the ledger line of class `gpu`
    with the card's name; K1 bit-equal to its plain version on the first
    calls of the engine run. Printed: rps, p50/p99, cache hit rate and the
    fast-path p99.
34. `run` serving: `BNGApp` on the card with the scheduler, the `run`
    default geometry (2^15 subscriber buckets, pool /16) and 8,192
    synthetic subscribers, on a held clock stepped 1 ms a beat (`tick()`
    every simulated second). Its first beats give the same TX bytes as a
    `device="cpu"` app driven the same way. 70 NAT public addresses give
    every leased subscriber a port block. Then beats until every
    synthetic MAC has had a slow-path OFFER, REQUESTs for the first 2,048
    offered addresses (ACKs from the slow path, leases in the device
    tables; each takes a NAT block, and the default NAT table holds about
    4,060), and counts 0 for one more pass of the source with a bulk
    batch of flows from the leased addresses: the leased MACs' DISCOVERs
    answered on the device by the express lane, the rest by the slow
    path, 3 K1 per express dispatch and 9 K1 + 4 K2 per bulk step (the
    IPoE step's 8 and the garden gate's, on by default in `run`); K1 and
    K2 bit-equal to their plain versions on the express program's and
    the bulk step's calls. Between the leases and that pass,
    `engine_swap()` under the ring (frames in the express lane and in
    the RX ring) passes its audit, and the standby serves the pass.
    Printed: beats/s, frames/s, express and slow counts, K1/K2 per path.
35. One subprocess `python -m bng_tpu_torch run --once --no-metrics-enabled`
    (the reference's defaults in every other respect: DHCPv6, SLAAC, the
    walled garden) exits 0 on the card.
36. PPPoE subscribers on the card: `BNGApp` with the scheduler, the `run`
    default geometry (2^12 PPPoE session buckets), PPPoE with local CHAP
    users, DHCPv6 and SLAAC on. 4,032 sessions (the NAT blocks of 64
    public addresses; the default NAT subscriber table holds 4,060)
    negotiate through the ring, 512 at a time: PADI/PADO/PADR/PADS, LCP,
    CHAP, IPCP, the clients built from the port's PPPoE codec. The first
    64 sessions give the same TX/FWD bytes and PPPoE counters on the card
    and on a `device="cpu"` app: their negotiation, one upstream round of
    data (punted to the host's NAT, then forwarded on the device) and one
    downstream round. Every session OPEN; after the drains both device
    session tables hold every row and equal their host mirrors (the
    audit). Counts 0, then upstream UDP from every session (decapped,
    SNAT'd, valid checksums) and downstream to each session's address
    (DNAT'd, encapped with its session id) through the bulk lane: 11 K1
    (IPoE 8, garden 1, PPPoE 2) and 4 K2 per bulk step, both bit-equal to
    their plain versions on one step. A PADT from 256 sessions takes their
    rows off the device and releases their NAT blocks; their next data
    frame PASSes as an unknown session and is answered with PADT. Printed:
    sessions opened per second, bulk frames/s with PPPoE data, the device
    decap/encap counts.
37. DHCPv6 and SLAAC through the demux: 1,024 SOLICIT/REQUEST exchanges
    (IA_NA and IA_PD) and 64 router solicitations through the ring (9 K1
    and 4 K2 per bulk step); every client gets its REPLY and every RS an
    RA; a tick past the lease reaps every v6 lease and sends the periodic
    RA. Printed: exchanges per second.
38. RADIUS, accounting and CoA: an in-process RADIUS peer on 127.0.0.1
    (from the port's RADIUS codec); 16 PPPoE sessions authenticate through
    `RadiusVerifier` and 16 DHCP subscribers through the authenticator;
    an Accounting Start for each; after data through the bulk lane, the
    interims carry the octets the device's NAT session words hold. A
    CoA-Request moves one subscriber to lite-25mbps: its burst of 8 bulk
    steps, none dropped before, drops its excess lanes after by K2's
    decision (K1 and K2 bit-equal to their plain versions on one such
    step). A Disconnect-Request ends one PPPoE session and one DHCP lease:
    both rows leave the device tables (the audit), each with its
    Accounting Stop. Then, at phase 36's size: PPPoE sessions through
    `RadiusVerifier` until the 64 NAT addresses' 4,032 blocks are all
    taken, 512 CoA-Requests by Framed-IP (each subscriber's QoS rows
    then hold its last policy's rate) and 256 Disconnect-Requests (half
    by Framed-IP, half by Calling-Station-Id; the rows leave the device
    tables), each request timed alone: the locators walk every lease and
    session. Printed: the CoA and Disconnect round trips, p50 and p99
    over those requests.

The line before the last is the card's name and power limit; the one
before it the kernels JSON (each kernel's launches by path, `loadtest`,
`run`, `pppoe`, `v6` and `radius` among them); the last line the result
JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import io
import json
import subprocess
import sys
import tempfile
import time
import warnings
from types import SimpleNamespace

import numpy as np
import torch

from bng_tpu_torch import convert, kernel_cases, kernels
from bng_tpu_torch import frames as F
from bng_tpu_torch.control.dhcp_server import DHCPServer
from bng_tpu_torch.control.dhcpv6 import protocol as p6
from bng_tpu_torch.control.pppoe import codec as pppoe_codec
from bng_tpu_torch.control.radius import packet as rp
from bng_tpu_torch.control.nat import NATManager
from bng_tpu_torch.control.pool import Pool, PoolManager
from bng_tpu_torch.edge.tables import EdgeTables
from bng_tpu_torch.ops import probe as probe_mod
from bng_tpu_torch.ops import qos as qos_mod
from bng_tpu_torch.ops import seg_prefix as seg_mod
from bng_tpu_torch.ops import table as table_mod
from bng_tpu_torch.ops.antispoof import MODE_LOOSE, MODE_STRICT
from bng_tpu_torch.ops.express import XD_WORDS, express_verdicts, parse_express
from bng_tpu_torch.ops.garden import GARDEN_WORDS, GV_FLAG
from bng_tpu_torch.ops.hashing import SEED1, hash_words, u32
from bng_tpu_torch.ops.pipeline import pipeline_step
from bng_tpu_torch.runtime import engine as engine_mod
from bng_tpu_torch.runtime.engine import AntispoofTables, Engine, GardenTables, QoSTables
from bng_tpu_torch.chaos import faults
from bng_tpu_torch.control.statestore import CheckpointStore
from bng_tpu_torch.runtime import checkpoint as ckpt_mod
from bng_tpu_torch.runtime import ops as ops_mod
from bng_tpu_torch.devloop.host import DevloopPump
from bng_tpu_torch.ops.table import PinnedStage
from bng_tpu_torch.runtime import hostpath, nativelib
from bng_tpu_torch.runtime import ring as ring_mod
from bng_tpu_torch.runtime.ring import PyRing
from bng_tpu_torch.runtime.scheduler import SchedulerConfig, TieredScheduler
from bng_tpu_torch.runtime.tables import FastPathTables, PPPoEFastPathTables
from bng_tpu_torch import entry as entry_mod
from bng_tpu_torch.parallel.exchange import DeviceLocalExchange
from bng_tpu_torch.parallel.sharded import ShardedCluster, sharded_step
from bng_tpu_torch.utils.net import fnv1a32, ip_to_u32
from bng_tpu_torch.utils.profiling import profile_step_durations

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
HOST_AB_BATCHES = 6  # IPoE batches run under both host paths
# the full-stack deployment, on top of the headline
N_PPPOE = 65_534  # RFC 2516's 16-bit SESSION_ID, 0xFFFF reserved
N_GARDEN = 10_000
N_TAPS = 64
FULL_BATCHES = 10
DHCP_BATCHES = 5
RING_BATCHES = 3
AC_MAC = bytes.fromhex("02aabbccdd01")  # the access concentrator (and DHCP server) MAC
PPPOE_BASE = ip_to_u32("10.32.0.1")  # PPPoE addresses, beyond the DHCP range
PORTAL, DNS = ip_to_u32("100.64.0.10"), ip_to_u32("100.64.0.53")
GARDEN_ALLOWED = ((PORTAL, 80, 6), (PORTAL, 443, 6), (DNS, 53, 17), (DNS, 53, 6))
GATEWAYS = [bytes([0x02, 0x47, 0x57, 0, 0, k]) for k in range(4)]
NEW_SITES = ("garden", "pppoe by_sid", "pppoe by_ip", "tap", "route")  # PR 3's K1 sites
# the serving stack, on the headline's host tables
SERVER_IP = ip_to_u32("10.0.0.1")  # the deployment's DHCP server address
STACK_POOL = 17  # the DHCP server's own /16, which no deployment address uses
STACK_NET = ip_to_u32("10.48.0.0")
STORM_CLIENTS = 8192  # new clients in the DORA storm
STORM_WAVE = 64  # clients per storm cycle: one express batch of each DORA step
STORM_CACHED = 16  # cached DISCOVERs per storm cycle
STORM_BULK_EVERY = 16  # storm cycles per bulk batch of the IPoE mix
LAT_ROUNDS = 200  # express batches of 64 cached DISCOVERs, the bulk lane idle
LONE_ROUNDS = 50  # lone cached DISCOVERs (each closed by the deadline)
BUSY_ROUNDS = 8  # express batches right after a bulk dispatch of B flows
RENDER_ROUNDS = 50  # express bursts rendered under each host path
UPLOAD_ROUNDS = 500  # express descriptor uploads timed each way
RELAY_IP = ip_to_u32("10.9.9.9")  # a relay agent's giaddr (a template group of its own)
DL_CLIENT0 = 1 << 20  # first client MAC of the devloop phases (apart from the storm's)
DL_CLIENTS = 1024  # new clients of the two-stack comparison
DL_BURSTS = 200  # bursts of 64 cached DISCOVERs in the comparison
DL_STORM_CLIENTS = 4096  # new clients of the devloop's DORA storm
DL_ROUNDS = 4  # full rings per k for the dispatch counts


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


def nbuckets_for(n: int) -> int:
    """Power-of-two bucket count holding n keys at about 50% of 4 ways."""
    return 1 << max(10, (n * 2 // 4).bit_length())


# ---------------------------------------------------------------- deployment

def sub_mac(i: int) -> bytes:
    return (0x02AA00000000 + int(i)).to_bytes(6, "big")


def flow_mac(ip: int) -> bytes:
    return b"\x02\x00" + int(ip).to_bytes(4, "big")


def session_mac(k: int) -> bytes:
    return (0x02BB00000000 + int(k)).to_bytes(6, "big")


def sub_ip(i):
    return (10 << 24) + 2 + i


def build_deployment(device):
    """The headline deployment, built through the port's host API."""
    sub_nb = nbuckets_for(N_SUBS)
    fp = FastPathTables(sub_nbuckets=sub_nb, vlan_nbuckets=1 << 10, cid_nbuckets=1 << 10,
                        max_pools=64, stash=256)
    fp.set_server_config(AC_MAC, ip_to_u32("10.0.0.1"))
    for pid in range(max(1, (N_SUBS >> 16) + 1)):  # /16 pools holding N addresses
        fp.add_pool(pid + 1, ip_to_u32(f"10.{pid}.0.0") & 0xFFFF0000, 16, ip_to_u32("10.0.0.1"),
                    ip_to_u32("1.1.1.1"), ip_to_u32("8.8.8.8"), 86400)
    idx = np.arange(N_SUBS, dtype=np.uint64)
    fp.add_subscribers_bulk(idx + 0x02AA00000000,
                            pool_ids=(idx >> np.uint64(16)).astype(np.uint32) + 1,
                            ips=sub_ip(idx).astype(np.uint32),
                            lease_expiries=np.uint32(NOW + 86400))

    # public addresses for the flow subscribers and the full stack's PPPoE ones
    n_pub = max(4, -(-(N_NAT_SUBS + N_PPPOE) // 1008) + 1)
    nat = NATManager(public_ips=[ip_to_u32("203.0.113.1") + i for i in range(n_pub)],
                     ports_per_subscriber=64, sessions_nbuckets=nbuckets_for(N_FLOWS),
                     sub_nat_nbuckets=sub_nb, stash=256)
    fi = np.arange(N_FLOWS, dtype=np.int64)
    src_ips = sub_ip(fi % N_NAT_SUBS).astype(np.uint32)
    dst_ips = (ip_to_u32("93.184.0.0") + fi // N_NAT_SUBS).astype(np.uint32)
    sports = (20000 + fi // N_NAT_SUBS).astype(np.uint32)
    made = nat.bulk_allocate_nat(np.unique(src_ips), NOW)
    nat_ip, nat_port, ok = nat.bulk_flows(src_ips, dst_ips, sports, np.uint32(443),
                                          np.uint32(17), 100, NOW)
    check(made == N_NAT_SUBS and bool(ok.all()), "every NAT flow was allocated")
    flows = np.stack([src_ips, dst_ips, sports, nat_ip, nat_port], axis=1).astype(np.int64)

    qos = QoSTables(nbuckets=1 << 13)
    pol = sub_ip(np.arange(N_QOS, dtype=np.int64) * (N_NAT_SUBS // N_QOS))
    # half with a burst below one 222-byte frame (every lane drops), half generous
    qos.bulk_set_subscribers(pol[: N_QOS // 2], down_bps=64_000, up_bps=64_000,
                             down_burst=150, up_burst=150)
    qos.bulk_set_subscribers(pol[N_QOS // 2:], down_bps=10_000_000, up_bps=2_000_000)

    spoof = AntispoofTables(nbuckets=1 << 14, stash=64)
    spoof.set_config(MODE_LOOSE, False)
    spoof.add_allowed_range(ip_to_u32("10.0.0.0"), 8)
    bound = sub_ip(np.arange(N_BINDINGS, dtype=np.int64) * 7)
    keys = np.array([[int.from_bytes(flow_mac(ip)[:2], "big"),
                      int.from_bytes(flow_mac(ip)[2:], "big")] for ip in bound], dtype=np.uint32)
    rows = np.zeros((N_BINDINGS, 8), dtype=np.uint32)
    rows[:, 0] = bound  # AB_IPV4
    rows[:, 5] = 1  # AB_VALIDS: VALID_V4
    rows[:, 6] = MODE_STRICT  # AB_MODE
    spoof.bindings.bulk_insert(keys, rows)

    eng = Engine(fp, nat, qos, spoof, batch_size=B, pkt_slot=L, device=device)
    return eng, flows, set(int(x) for x in pol[: N_QOS // 2])


def flow_frame(f) -> bytes:
    return F.with_udp_checksum(F.udp_packet(flow_mac(f[0]), b"\x04" * 6, int(f[0]), int(f[1]),
                                            int(f[2]), 443, b"x" * 180))


def make_batch(rng, flows, fresh=()):
    """20% cached DISCOVERs, 80% established flows (+ `fresh` flows first)."""
    frames, expect = [], []
    for f in fresh:
        frames.append(flow_frame(f))
        expect.append(("fresh", f))
    n_dhcp = B // 5
    for row in range(len(frames), B):
        if row < n_dhcp:
            i = int(rng.integers(N_SUBS))
            frames.append(F.discover_frame(sub_mac(i), 0x1000 + row))
            expect.append(("dhcp", sub_ip(i)))
        else:
            f = flows[int(rng.integers(len(flows)))]
            frames.append(flow_frame(f))
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
            check_offer(tx, lane, info)
        elif kind == "flow":
            if int(info[0]) in drop_ips:
                check(lane in dropped, f"policed flow lane {lane} dropped")
                n_drop += 1
                continue
            check_snat(fwd, lane, info)
        else:
            check((lane in fwd) if fresh_ok else (lane in slow), f"fresh flow lane {lane}")
    return n_drop


def check_offer(tx, lane, yiaddr):
    check(lane in tx, f"DISCOVER lane {lane} answered on the device")
    reply = F.decode_dhcp(F.decode(tx[lane]).payload)
    check(reply.msg_type == F.OFFER and reply.yiaddr == yiaddr, f"OFFER yiaddr lane {lane}")


def check_snat(fwd, lane, f):
    check(lane in fwd, f"flow lane {lane} forwarded")
    d = F.decode(fwd[lane])
    check(d.src_ip == int(f[3]) and d.src_port == int(f[4]) and d.ip_checksum_ok
          and d.l4_checksum != 0 and F.l4_checksum_ok(fwd[lane]),
          f"SNAT rewrite and IP and UDP checksums, lane {lane}")
    return d


# ------------------------------------------------------ full-stack deployment

def build_full_stack(hosts, flows, device):
    """The headline's host tables (fastpath, nat, qos, antispoof) plus PPPoE,
    garden, taps and routes, and a full-stack engine over them. The caller
    retires the headline's engine first: two engines draining one set of
    host mirrors would corrupt each other."""
    fp, nat, qos, spoof = hosts
    s = N_NAT_SUBS // N_QOS  # subscriber i is policed where i % s == 0
    check(s >= 3 and N_GARDEN <= N_QOS and N_TAPS <= N_QOS, "garden and taps fit the stride")

    k = np.arange(N_PPPOE, dtype=np.int64)
    p_ip = (PPPOE_BASE + k).astype(np.uint32)
    pppoe = PPPoEFastPathTables(nbuckets=nbuckets_for(N_PPPOE), stash=256, server_mac=AC_MAC)
    pppoe.bulk_sessions_up(k + 1, (0x02BB00000000 + k).astype(np.uint64), p_ip)
    made = nat.bulk_allocate_nat(p_ip, NOW)
    p_dst = (ip_to_u32("93.185.0.0") + k % 4096).astype(np.uint32)
    p_sport = (30000 + k % 20000).astype(np.uint32)
    nat_ip, nat_port, ok = nat.bulk_flows(p_ip, p_dst, p_sport, np.uint32(443), np.uint32(17),
                                          100, NOW)
    check(made == N_PPPOE and bool(ok.all()), "every PPPoE session has its NAT44 flow")
    sessions = np.stack([k + 1, p_ip, p_dst, p_sport, nat_ip, nat_port], axis=1).astype(np.int64)

    garden = GardenTables(nbuckets=nbuckets_for(N_GARDEN), stash=64)
    g_i = 1 + s * np.arange(N_GARDEN, dtype=np.int64)
    rows = np.zeros((N_GARDEN, GARDEN_WORDS), dtype=np.uint32)
    rows[:, GV_FLAG] = 1
    garden.subscribers.bulk_insert(sub_ip(g_i).astype(np.uint32)[:, None], rows)
    for dst in GARDEN_ALLOWED:
        garden.allow_destination(*dst)

    edge = EdgeTables(nbuckets=nbuckets_for(N_NAT_SUBS), stash=64)
    i = np.arange(N_NAT_SUBS, dtype=np.int64)
    gw_rows = np.stack([EdgeTables.route_row(g, 100 + j) for j, g in enumerate(GATEWAYS)])
    edge.route.bulk_insert(sub_ip(i).astype(np.uint32)[:, None], gw_rows[i % len(GATEWAYS)])
    taps = {}  # tapped subscriber ip -> the warrant id its UDP/443 lanes mirror for (or None)
    for t in range(N_TAPS):
        ip, wid = int(sub_ip(2 + s * t)), 1000 + t
        filters = () if t < N_TAPS // 2 else [(443, 17, 0)] if t % 2 == 0 else [(80, 6, 0)]
        edge.arm_tap(ip, wid, filters)
        taps[ip] = wid if not filters or filters[0][0] == 443 else None

    mirrors = []
    eng_full = Engine(fp, nat, qos, spoof, garden, pppoe, batch_size=B, pkt_slot=L, edge=edge,
                      mirror_sink=lambda lane, frame, wid: mirrors.append((lane, wid)),
                      device=device)
    fi = flows[:, 0] - sub_ip(0)
    gardened = (fi % s == 1) & (fi // s < N_GARDEN)
    tapped = (fi % s == 2) & (fi // s < N_TAPS)
    return eng_full, SimpleNamespace(
        sessions=sessions, g_ip=sub_ip(g_i), taps=taps, mirrors=mirrors,
        plain_flows=flows[~gardened], tap_flows=flows[tapped])


def make_full_batch(rng, ctx):
    """The full-stack mix in a shuffled lane order: (frames, from_access, expect)."""
    share = {"dhcp": 0.15, "flow": 0.45, "pppoe_up": 0.15, "pppoe_down": 0.10,
             "garden": 0.05, "ctrl": 0.05}
    count = {k: int(B * v) for k, v in share.items()}
    count["unknown"] = B - sum(count.values())
    items = []
    for _ in range(count["dhcp"]):
        i = int(rng.integers(N_SUBS))
        items.append((F.discover_frame(sub_mac(i), int(rng.integers(1 << 31))), True,
                      ("dhcp", sub_ip(i))))
    n_tap = min(32, len(ctx.tap_flows))
    for j in range(count["flow"]):
        pool = ctx.tap_flows if j < n_tap else ctx.plain_flows
        f = pool[int(rng.integers(len(pool)))]
        items.append((flow_frame(f), True, ("flow", f)))
    for _ in range(count["pppoe_up"]):
        k = int(rng.integers(N_PPPOE))
        sid, ip, dst, sport, _, _ = (int(x) for x in ctx.sessions[k])
        inner = F.with_udp_checksum(F.udp_packet(session_mac(k), AC_MAC, ip, dst, sport, 443,
                                                 b"u" * 150))[14:]
        vlans = [100 + k % 1000, 1 + (k // 1000) % 4000]
        frame = F.pppoe_session_frame(AC_MAC, session_mac(k), sid, F.PROTO_IPV4, inner, vlans)
        items.append((frame, True, ("pppoe_up", (k, vlans, len(frame)))))
    for _ in range(count["pppoe_down"]):
        k = int(rng.integers(N_PPPOE))
        _, _, dst, _, nip, nport = (int(x) for x in ctx.sessions[k])
        frame = F.with_udp_checksum(F.udp_packet(b"\x04" * 6, AC_MAC, dst, nip, 443, nport,
                                                 b"d" * 200))
        items.append((frame, False, ("pppoe_down", (k, len(frame)))))
    for _ in range(count["garden"]):
        ip = int(ctx.g_ip[int(rng.integers(len(ctx.g_ip)))])
        if rng.random() < 0.5:
            dst, port, proto = GARDEN_ALLOWED[int(rng.integers(len(GARDEN_ALLOWED)))]
        else:
            dst, port, proto = ip_to_u32("93.184.7.7"), 443, 17
        build = F.tcp_packet if proto == 6 else F.udp_packet
        frame = build(flow_mac(ip), b"\x04" * 6, ip, dst, 40000 + int(rng.integers(1000)),
                      port, b"g" * 40)
        items.append((frame, True, ("garden", (ip, dst != ip_to_u32("93.184.7.7")))))
    for j in range(count["ctrl"]):
        k = int(rng.integers(N_PPPOE))
        if j % 2:
            frame = F.pppoe_padi_frame(session_mac(k), host_uniq=b"hu")
        else:
            lcp = F.CPPacket(F.CP_ECHO_REQ, j & 0xFF, data=b"\x00\x00\x00\x01").encode()
            frame = F.pppoe_session_frame(AC_MAC, session_mac(k), k + 1, F.PROTO_LCP, lcp)
        items.append((frame, True, ("pass", "control")))
    for _ in range(count["unknown"]):
        k = int(rng.integers(N_PPPOE))
        inner = F.udp_packet(session_mac(k), AC_MAC, PPPOE_BASE + k, 1, 2, 3, b"z" * 40)[14:]
        frame = F.pppoe_session_frame(AC_MAC, session_mac(k), 0xFFFF, F.PROTO_IPV4, inner)
        items.append((frame, True, ("pass", "unknown session")))
    order = rng.permutation(len(items))
    return ([items[o][0] for o in order], [items[o][1] for o in order],
            [items[o][2] for o in order])


def check_full_outputs(out, expect, ctx, drop_ips, mirrors):
    """Every lane of a full-stack batch got its expected outcome; returns
    {kind: lanes} counts."""
    tx, fwd, dropped, slow = dict(out["tx"]), dict(out["fwd"]), set(out["dropped"]), dict(out["slow"])
    want_mirror = set()
    seen = {}
    for lane, (kind, info) in enumerate(expect):
        seen[kind] = seen.get(kind, 0) + 1
        if kind == "dhcp":
            check_offer(tx, lane, info)
        elif kind == "flow":
            src = int(info[0])
            if ctx.taps.get(src):
                want_mirror.add((lane, ctx.taps[src]))
            if src in drop_ips:
                check(lane in dropped, f"policed flow lane {lane} dropped")
                continue
            d = check_snat(fwd, lane, info)
            check(d.dst_mac == GATEWAYS[(src - sub_ip(0)) % len(GATEWAYS)],
                  f"next-hop dst MAC, lane {lane}")
        elif kind == "pppoe_up":
            k, vlans, n = info
            _, _, dst, sport, nip, nport = (int(x) for x in ctx.sessions[k])
            check(lane in fwd, f"PPPoE upstream lane {lane} forwarded")
            raw = fwd[lane]
            d = F.decode(raw)
            check(len(raw) == n - 8 and d.vlans == vlans and d.ethertype == 0x0800
                  and d.dst_mac == AC_MAC and d.src_mac == session_mac(k),
                  f"PPPoE decap keeps the L2 header and tags, lane {lane}")
            check(d.src_ip == nip and d.src_port == nport and d.dst_ip == dst
                  and d.ip_checksum_ok and F.l4_checksum_ok(raw), f"PPPoE SNAT, lane {lane}")
        elif kind == "pppoe_down":
            k, n = info
            sid, ip, _, sport, _, _ = (int(x) for x in ctx.sessions[k])
            check(lane in fwd, f"PPPoE downstream lane {lane} forwarded")
            raw = fwd[lane]
            hdr = F.PPPoEPacket.decode(raw[14:])
            check(len(raw) == n + 8 and raw[:6] == session_mac(k) and raw[6:12] == AC_MAC
                  and raw[12:14] == b"\x88\x64" and hdr.session_id == sid
                  and hdr.payload[:2] == b"\x00\x21", f"PPPoE encap, lane {lane}")
            inner = raw[:12] + b"\x08\x00" + raw[22:]
            d = F.decode(inner)
            check(d.dst_ip == ip and d.dst_port == sport and d.ip_checksum_ok
                  and F.l4_checksum_ok(inner), f"DNAT under the encap, lane {lane}")
        elif kind == "garden":
            ip, allowed = info
            if not allowed:
                check(lane in dropped, f"garden drop, lane {lane}")
                continue
            check(lane in fwd, f"gardened lane {lane} to an allowed destination forwarded")
            d = F.decode(fwd[lane])
            check(d.src_ip == ip and d.dst_mac == GATEWAYS[(ip - sub_ip(0)) % len(GATEWAYS)],
                  f"gardened lane routed, not translated, lane {lane}")
        else:
            check(lane in slow, f"{info} lane {lane} passed to the slow path")
    check(set(mirrors) == want_mirror and len(mirrors) == len(want_mirror),
          f"mirror-sink calls {sorted(mirrors)[:4]}... == expected {sorted(want_mirror)[:4]}...")
    check(len(want_mirror) > 0, "some lanes mirrored")
    return seen


# ------------------------------------------------------------------- phases

def table_names(tables) -> dict[int, str]:
    """{probe-row tensor address: table name} over a PipelineTables."""
    out = {}
    for name, t in (("antispoof", tables.spoof), ("dhcp vlan", tables.dhcp.vlan),
                    ("dhcp cid", tables.dhcp.cid), ("dhcp sub", tables.dhcp.sub),
                    ("nat sessions", tables.nat.sessions), ("nat reverse", tables.nat.reverse),
                    ("nat sub_nat", tables.nat.sub_nat), ("garden", tables.garden),
                    ("pppoe by_sid", tables.pppoe_by_sid), ("pppoe by_ip", tables.pppoe_by_ip),
                    ("tap", tables.tap), ("route", tables.route)):
        if t is not None:
            out[t.krows.data_ptr()] = name
    return out


def record_kernel_inputs(run, n_probe: int | None, n_seg: int, what: str, names=None):
    """Run `run()` once and keep the exact inputs of every kernel call (and,
    given `table_names`, the table each probe read)."""
    rec = {"probe": [], "seg_prefix": [], "table": []}
    orig_probe, orig_seg = table_mod.probe, qos_mod.seg_prefix_total

    def probe_rec(*args):
        rec["table"].append((names or {}).get(args[0].data_ptr(), "?"))
        rec["probe"].append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return orig_probe(*args)

    def seg_rec(slot, vec, compute="both"):
        rec["seg_prefix"].append((slot.clone(), vec.clone(), compute))
        return orig_seg(slot, vec, compute)

    table_mod.probe, qos_mod.seg_prefix_total = probe_rec, seg_rec
    try:
        run()
    finally:
        table_mod.probe, qos_mod.seg_prefix_total = orig_probe, orig_seg
    torch.cuda.synchronize()
    if n_probe is not None:  # None: the caller checks the counts
        check(len(rec["probe"]) == n_probe and len(rec["seg_prefix"]) == n_seg,
              f"{what}: {n_probe} probes + {n_seg} seg calls (got {len(rec['probe'])}, "
              f"{len(rec['seg_prefix'])})")
    return rec


def probes_vs_plain(cases, err):
    for name, a in cases:
        got = probe_mod.probe_cuda(*a)
        ref = probe_mod.probe_plain(*a)
        for g, r, f in zip(got, ref, ("found", "slot", "vals")):
            d = (g.long() - r.long()).abs().max().item() if g.numel() else 0
            err["probe"] = max(err["probe"], float(d))
            check(torch.equal(g, r), f"K1 {name} K={a[3].shape[1]} {f} bit-equal")


def segs_vs_plain(cases, err):
    for name, s, v, c in cases:
        got = seg_mod.seg_prefix_cuda(s, v, c)
        ref = seg_mod.seg_prefix_plain(s, v, c)
        for g, r in zip(got, ref):
            err["seg_prefix"] = max(err["seg_prefix"], (g - r).abs().max().item())
        check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              f"K2 {name} {c} bit-equal")


def kernels_vs_plain(rec, device, err):
    """Both kernels against their plain versions on every IPoE-step call and
    every shared edge case, bit for bit; keeps the max |err| in `err`."""
    cases = [("main-path", a) for a in rec["probe"]]
    args = rec["probe"][3]  # the DHCP subscriber-table probe, cut to a ragged batch
    cases.append(("ragged B=1000", args[:3] + (args[3][:1000].contiguous(),) + args[4:]))
    for name in kernel_cases.PROBE_SPECS:
        c = kernel_cases.probe_case(name)
        cases.append((name, tuple(torch.from_numpy(a).to(device) for a in c[:4])
                      + (c.nbuckets, c.stash)))
    probes_vs_plain(cases, err)
    say(f"K1 bit-equal to its plain version on {len(cases)} cases")

    seg_cases = [("main-path", s, v, c) for s, v, c in rec["seg_prefix"]]
    for name in kernel_cases.SEG_SPECS:
        c = kernel_cases.seg_case(name)
        seg_cases.append((name, torch.from_numpy(c.slot).to(device),
                          torch.from_numpy(c.vec).to(device), c.compute))
    check(max(s.shape[0] for _, s, _, _ in seg_cases) > seg_mod.B_ONE, "K2 sweep route covered")
    segs_vs_plain(seg_cases, err)
    say(f"K2 (both routes) bit-equal to its plain version on {len(seg_cases)} cases")


def gpu_step_equals_cpu_step(eng, pkt, length, fa, what: str):
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
        a, b = getattr(g, f), getattr(c, f)
        check((a is None and b is None) or torch.equal(a.cpu(), b), f"{what} GPU step {f} == CPU step")
    gt, ct = convert.tables_to_numpy(eng.tables), convert.tables_to_numpy(cpu_tables)

    def walk(a, b, path):
        if isinstance(a, np.ndarray):
            check(np.array_equal(a, b), f"{what} GPU tables {path} == CPU tables")
        elif a is not None:
            for name, x, y in zip(a._fields, a, b):
                walk(x, y, f"{path}.{name}")

    walk(gt, ct, "tables")
    say(f"{what}: GPU step == CPU step: every result leaf, byte, stat and table word identical")


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


def time_kernels(rec, card: str, what: str):
    """Warm, L2-cold and plain device times of every recorded call, with its
    bound: {kernel: {"ms": [...], "plain": [...], "bound": [...]}}."""
    kern = {"probe": {"ms": [], "plain": [], "bound": []},
            "seg_prefix": {"ms": [], "plain": [], "bound": []}}
    flush = torch.empty(2**25, dtype=torch.int32, device="cuda")  # 128 MiB > 50 MB L2
    for j, a in enumerate(rec["probe"]):
        ms = cuda_ms(lambda: probe_mod.probe_cuda(*a))
        cold = cuda_ms(lambda: probe_mod.probe_cuda(*a), flush=flush)
        pl = cuda_ms(lambda: probe_mod.probe_plain(*a), iters=5)
        bd = probe_bound_ms(a)
        for key, x in (("ms", ms), ("plain", pl), ("bound", bd)):
            kern["probe"][key].append(x)
        say(f"  {what} K1 call {j} ({rec['table'][j]}): K={a[3].shape[1]} V={a[2].shape[1]} nbuckets={a[4]} "
            f"stash={a[5]}: {ms:.4f} ms (cold L2 {cold:.4f}), plain {pl:.4f} ms, "
            f"bound {bd:.6f} ms [{card}]")
    for j, (s, v, c) in enumerate(rec["seg_prefix"]):
        ms = cuda_ms(lambda: seg_mod.seg_prefix_cuda(s, v, c))
        cold = cuda_ms(lambda: seg_mod.seg_prefix_cuda(s, v, c), flush=flush)
        pl = cuda_ms(lambda: seg_mod.seg_prefix_plain(s, v, c), iters=5)
        bd = seg_bound_ms(s, v, c)
        for key, x in (("ms", ms), ("plain", pl), ("bound", bd)):
            kern["seg_prefix"][key].append(x)
        say(f"  {what} K2 call {j} ({c}): {ms:.4f} ms (cold L2 {cold:.4f}), plain {pl:.4f} ms, "
            f"bound {bd:.6f} ms [{card}]")
    del flush
    return kern


def time_device_steps(steps: dict, card: str, n: int = 100) -> dict:
    """Host-clock latency of each synchronised device step, the steps taken
    in turns (ABBA...) so a drift of the host's speed falls on all alike;
    returns {name: p50 ms}."""
    for step in steps.values():
        for _ in range(3):
            step()
    torch.cuda.synchronize()
    lat = {name: [] for name in steps}
    names = list(steps)
    for r in range(n):
        for name in (names if r % 2 == 0 else names[::-1]):
            t1 = time.perf_counter()
            steps[name]()
            torch.cuda.synchronize()
            lat[name].append((time.perf_counter() - t1) * 1e3)
    p50 = {}
    for name, ms in lat.items():
        ms = np.array(ms)
        p50[name] = float(np.percentile(ms, 50))
        say(f"{name} device step B={B}: {B / (ms.mean() / 1e3) / 1e6:.4f} Mpps, "
            f"p50 {p50[name]:.3f} ms, p99 {np.percentile(ms, 99):.3f} ms, "
            f"max {ms.max():.3f} ms over {len(ms)} steps (host clock, synced) [{card}]")
    return p50


def profile_step(step, card: str, what: str, steps: int = 5) -> None:
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
    say(f"{what} profile over {steps} steps [{card}]: wall {wall_us / steps / 1e3:.3f} ms/step, "
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


def staged_step(eng, pkt, length, fa, ipoe_only: bool = False):
    """One device step on a staged batch; `ipoe_only` runs the same tables
    with the garden, PPPoE and edge stages left out."""
    dev = eng.device
    pkt_d, len_d = torch.from_numpy(pkt).to(dev), torch.from_numpy(length).to(dev)
    fa_d = torch.from_numpy(fa).to(dev)
    now_s, now_us = torch.tensor(NOW + 200, device=dev), torch.tensor(5, device=dev)
    tables, geom = eng.tables, eng.geom
    if ipoe_only:
        tables = tables._replace(garden=None, garden_allowed=None, pppoe_by_sid=None,
                                 pppoe_by_ip=None, pppoe_server_mac=None, tap=None,
                                 tap_filters=None, tap_config=None, route=None)
        geom = geom._replace(garden=None, pppoe=None, tap=None, route=None)
    return lambda: pipeline_step(tables, pkt_d, len_d, fa_d, geom, now_s, now_us)


class HostSplit:
    """Host time the serving calls made inside the block spend packing (or
    assembling) frames, dispatching the device work (the drain, uploads,
    the ops and the queued result copies), waiting for the results, and,
    the rest of each call, demuxing verdicts."""

    PARTS = ("pack", "dispatch", "wait")

    def __init__(self, eng, ring=None):
        self.sites = [(eng, "_pack_frames", "pack"), (eng, "_dispatch_step", "dispatch"),
                      (eng, "_run_dhcp_batch", "dispatch"),
                      (engine_mod._InFlight, "__init__", "dispatch"),
                      (engine_mod._InFlight, "wait", "wait")]
        if ring is not None:
            self.sites.append((ring, "assemble", "pack"))
        self.ms = {k: 0.0 for k in self.PARTS}

    def __enter__(self):
        self.saved = []
        for obj, name, part in self.sites:
            orig = getattr(obj, name)
            self.saved.append((obj, name, obj.__dict__.get(name)))

            def timed(*a, _orig=orig, _part=part, **kw):
                t = time.perf_counter()
                try:
                    return _orig(*a, **kw)
                finally:
                    self.ms[_part] += (time.perf_counter() - t) * 1e3
            setattr(obj, name, timed)
        return self

    def __exit__(self, *exc):
        for obj, name, orig in reversed(self.saved):
            if orig is None:
                delattr(obj, name)
            else:
                setattr(obj, name, orig)

    def report(self, call_ms) -> str:
        n = len(call_ms)
        parts = {k: v / n for k, v in self.ms.items()}
        parts["demux"] = float(np.mean(call_ms)) - sum(parts.values())
        return ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + " ms per call"


def check_dispatch_makes_no_sync(eng, pkt, length, fa, dpkt, dlen):
    """A dispatch (a drain that ships dirty rows, the uploads, the fused
    step or the DHCP-only program, the queued result copies) makes no
    host round trip: torch's sync debug mode reports every synchronizing
    CUDA call made inside it."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.edge.set_route(int(sub_ip(0)), GATEWAYS[0], 100)  # a dirty row for each drain
            flights = [engine_mod._InFlight(eng._dispatch_step(pkt, length, fa, NOW + 4))]
            eng.fastpath.touch_lease(sub_mac(0), NOW + 86400)
            flights.append(engine_mod._InFlight(eng._run_dhcp_batch(dpkt, dlen, NOW + 4)))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for fl in flights:
        fl.wait()
    syncs = [str(w.message) for w in seen if "called a synchronizing" in str(w.message)]
    check(not syncs, f"a dispatch synchronised the host: {syncs[:3]}")
    check(eng.pending_dirty() == 0, "the dirty rows shipped with the dispatches")
    say("a full-stack dispatch and a DHCP-only dispatch, each shipping a dirty row, made no "
        "synchronizing CUDA call (torch.cuda sync debug mode)")


def check_launches(got, steps: int, per_step: dict, what: str):
    for name, n in per_step.items():
        check(got[name] == n * steps, f"{what}: {name} launched {n} per step x {steps} ({got})")


# ------------------------------------------------------------- the IPoE path

def ipoe_phases(eng, flows, drop_ips, card, device, profile: bool, err):
    rng = np.random.default_rng(42)
    frames, _ = make_batch(rng, flows)
    pkt, length = eng._pack_frames(frames, B)
    fa = np.ones((B,), dtype=bool)
    rec = record_kernel_inputs(lambda: eng.step(pkt, length, fa, NOW + 1), 8, 4, "IPoE step",
                               table_names(eng.tables))
    kernels_vs_plain(rec, device, err)

    torch.cuda.reset_peak_memory_stats()
    batches = [make_batch(rng, flows) for _ in range(BATCHES)]
    fresh_ids = rng.integers(len(flows), size=8)
    fresh = [(int(flows[i, 0]), int(flows[i, 1]), 31000 + k) for k, i in enumerate(fresh_ids)
             if int(flows[i, 0]) not in drop_ips]
    batches[3] = make_batch(rng, flows, fresh)
    batches[4] = make_batch(rng, flows, fresh)
    kernels.reset_launches()
    proc_ms, n_drop = [], 0
    split = HostSplit(eng)
    for k, (frames, expect) in enumerate(batches):
        with split:
            t1 = time.perf_counter()
            out = eng.process(frames, from_access=True, now=NOW + 2 + k * 0.01)
            proc_ms.append((time.perf_counter() - t1) * 1e3)
        n_drop += check_outputs(out, expect, drop_ips, fresh_ok=(k == 4))
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check_launches(launches, BATCHES, {"probe": 8, "seg_prefix": 4}, "IPoE path")
    check(n_drop > 0 and eng.stats.dropped == n_drop, "QoS drops on policed subscribers")
    check(len(fresh) > 0, "fresh flows present")
    say(f"IPoE path: {BATCHES} batches of {B}; tx {eng.stats.tx} fwd {eng.stats.fwd} "
        f"dropped {eng.stats.dropped} passed {eng.stats.passed}; launches {launches}")

    gpu_step_equals_cpu_step(eng, pkt, length, fa, "IPoE")
    host_path_ab(eng, batches[5:5 + HOST_AB_BATCHES], card)

    time_kernels(rec, card, "IPoE")
    s1, v1 = rec["seg_prefix"][0][0][:32].contiguous(), rec["seg_prefix"][0][1][:32].contiguous()
    say(f"  K2 at B=32 (the one-CTA route's fixed work): "
        f"{cuda_ms(lambda: seg_mod.seg_prefix_cuda(s1, v1)):.4f} ms [{card}]")
    big = kernel_cases.seg_case(f"mixed-B{seg_mod.B_ONE + 1}/both")
    s2, v2 = torch.from_numpy(big.slot).to(device), torch.from_numpy(big.vec).to(device)
    say(f"  K2 sweep route at B={seg_mod.B_ONE + 1}: "
        f"{cuda_ms(lambda: seg_mod.seg_prefix_cuda(s2, v2)):.4f} ms [{card}]")
    say(f"  one-block launch floor (torch.cuda._sleep(0), one thread): "
        f"{cuda_ms(lambda: torch.cuda._sleep(0), iters=100):.4f} ms [{card}]")
    step = staged_step(eng, pkt, length, fa)
    p50 = time_device_steps({"IPoE": step}, card)["IPoE"]
    d = profile_step_durations(step, iters=100, device=device)
    say(f"IPoE profile_step_durations ({d.source}, CUDA events, 100 steps): "
        f"p50 {d.percentile(50) / 1e3:.3f} ms, p99 {d.percentile(99) / 1e3:.3f} ms; "
        f"time_device_steps p50 {p50:.3f} ms (host clock, synced) [{card}]")
    say(f"IPoE Engine.process per batch (host included): mean {np.mean(proc_ms):.2f} ms, "
        f"p50 {np.percentile(proc_ms, 50):.2f} ms over {BATCHES} batches ({split.report(proc_ms)}); "
        f"peak device memory {peak_gib:.3f} GiB [{card}]")
    if profile:
        profile_step(step, card, "IPoE")
    return launches


def set_host_path(eng, path: str, pool) -> None:
    """Point the engine at a host path. The engine resolves BNG_HOST_PATH
    once, at construction; the smoke compares both paths on one engine and
    one set of device tables, so it swaps the staging here."""
    eng.host_path = path
    eng._stage_pool = pool if path == "vector" else None


def host_path_ab(eng, batches, card) -> None:
    """Each batch through `Engine.process` under the scalar and the vector
    host path in turns, at one `now`: identical outputs; the host split
    (pack, dispatch, wait, demux) of each path."""
    split = {p: HostSplit(eng) for p in ("scalar", "vector")}
    ms = {p: [] for p in split}
    pool = hostpath.StagingPool(eng.L, device=eng.device)
    for k, (frames, _) in enumerate(batches):
        outs = {}
        for path in (("scalar", "vector") if k % 2 == 0 else ("vector", "scalar")):
            set_host_path(eng, path, pool)
            with split[path]:
                t1 = time.perf_counter()
                outs[path] = eng.process(frames, from_access=True, now=NOW + 5 + k * 0.01)
                ms[path].append((time.perf_counter() - t1) * 1e3)
        check(outs["vector"] == outs["scalar"], f"IPoE batch {k}: vector host path == scalar")
    check(pool.waits == 0, "no vector staging waited for an upload")
    set_host_path(eng, "scalar", pool)
    for path in ("scalar", "vector"):
        say(f"IPoE Engine.process, {path} host path: mean {np.mean(ms[path]):.2f} ms over "
            f"{len(batches)} batches, outputs identical across the paths "
            f"({split[path].report(ms[path])}) [{card}]")


# ------------------------------------------------------- the full-stack paths

def full_stack_phases(hosts, flows, drop_ips, card, device, profile: bool, err):
    t0 = time.perf_counter()
    eng, ctx = build_full_stack(hosts, flows, device)
    torch.cuda.synchronize()
    say(f"full-stack deployment built and uploaded in {time.perf_counter() - t0:.1f}s "
        f"(device tables {torch.cuda.memory_allocated() / 2**30:.3f} GiB; {N_PPPOE} PPPoE "
        f"sessions, {N_GARDEN} gardened, {N_TAPS} taps, {N_NAT_SUBS} routes)")
    rng = np.random.default_rng(7)
    frames, fa_list, expect = make_full_batch(rng, ctx)
    pkt, length = eng._pack_frames(frames, B)
    fa = np.array(fa_list, dtype=bool)

    # ---- kernels against their plain versions on every call of both programs
    rec = record_kernel_inputs(lambda: eng.step(pkt, length, fa, NOW + 1), 13, 4,
                               "full-stack step", table_names(eng.tables))
    check(sorted(set(rec["table"])) == sorted(table_names(eng.tables).values()),
          f"the full-stack step probed every table ({rec['table']})")
    dhcp_frames = [F.discover_frame(sub_mac(i), 0x7000 + j)
                   for j, i in enumerate(rng.integers(N_SUBS, size=B))]
    dpkt, dlen = eng._pack_frames(dhcp_frames, B)
    drec = record_kernel_inputs(lambda: eng._collect(eng._run_dhcp_batch(dpkt, dlen, NOW + 1)),
                                3, 0, "DHCP-only batch")
    probes_vs_plain([("full-stack", a) for a in rec["probe"]]
                    + [("DHCP-only", a) for a in drec["probe"]], err)
    segs_vs_plain([("full-stack", s, v, c) for s, v, c in rec["seg_prefix"]], err)
    say(f"K1 bit-equal on all {len(rec['probe'])} calls of a full-stack step and "
        f"{len(drec['probe'])} of a DHCP-only batch; K2 on the step's {len(rec['seg_prefix'])}")

    # ---- the full stack through Engine.process
    torch.cuda.reset_peak_memory_stats()
    batches = [make_full_batch(rng, ctx) for _ in range(FULL_BATCHES)]
    kernels.reset_launches()
    proc_ms, seen = [], {}
    split = HostSplit(eng)
    for k, (bf, bfa, bexp) in enumerate(batches):
        ctx.mirrors.clear()
        with split:
            t1 = time.perf_counter()
            out = eng.process(bf, from_access=bfa, now=NOW + 2 + k * 0.01)
            proc_ms.append((time.perf_counter() - t1) * 1e3)
        for kind, n in check_full_outputs(out, bexp, ctx, drop_ips, ctx.mirrors).items():
            seen[kind] = seen.get(kind, 0) + n
    launches_full = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check_launches(launches_full, FULL_BATCHES, {"probe": 13, "seg_prefix": 4}, "full-stack path")
    st = eng.stats
    check(st.pppoe[0] > 0 and st.pppoe[1] > 0 and st.garden[0] > 0 and st.edge[0] > 0
          and st.edge[1] > 0 and st.edge[2] > 0, "every stage counted work")
    say(f"full-stack path: {FULL_BATCHES} batches of {B}, every lane as expected ({seen}); "
        f"tx {st.tx} fwd {st.fwd} dropped {st.dropped} passed {st.passed}; pppoe {st.pppoe.tolist()} "
        f"garden {st.garden.tolist()} edge {st.edge.tolist()}; launches {launches_full}")

    gpu_step_equals_cpu_step(eng, pkt, length, fa, "full stack")
    check_dispatch_makes_no_sync(eng, pkt, length, fa, dpkt, dlen)

    # ---- the DHCP-only lane
    kernels.reset_launches()
    dhcp_ms = []
    dsplit = HostSplit(eng)
    for k in range(DHCP_BATCHES):
        ids = rng.integers(N_SUBS, size=B)
        dframes = [F.discover_frame(sub_mac(i), 0x8000 + j) for j, i in enumerate(ids)]
        with dsplit:
            t1 = time.perf_counter()
            out = eng.process_dhcp(dframes, now=NOW + 3 + k)
            dhcp_ms.append((time.perf_counter() - t1) * 1e3)
        tx = dict(out["tx"])
        for lane, i in enumerate(ids):
            check_offer(tx, lane, sub_ip(int(i)))
    launches_dhcp = dict(kernels.LAUNCHES)
    check_launches(launches_dhcp, DHCP_BATCHES, {"probe": 3, "seg_prefix": 0}, "DHCP-only lane")
    say(f"DHCP-only lane: {DHCP_BATCHES} batches of {B} DISCOVERs, all OFFERed on the device; "
        f"launches {launches_dhcp}")

    # ---- the ring loops against process on the same frames
    ring_runs, launches_ring = ring_phases(eng, ctx, rng)

    # ---- times
    kern = time_kernels(rec, card, "full-stack")
    new = [j for j, t in enumerate(rec["table"]) if t in NEW_SITES]
    say(f"  K1 at this slice's {len(new)} call sites ({', '.join(rec['table'][j] for j in new)}): "
        f"mean {np.mean([kern['probe']['ms'][j] for j in new]):.4f} ms, plain "
        f"{np.mean([kern['probe']['plain'][j] for j in new]):.4f} ms, bound "
        f"{np.mean([kern['probe']['bound'][j] for j in new]):.6f} ms [{card}]")
    step = staged_step(eng, pkt, length, fa)
    p50 = time_device_steps({"full-stack": step,  # and the same tables and batch, stages off
                             "IPoE-only": staged_step(eng, pkt, length, fa, ipoe_only=True)}, card)
    say(f"full-stack p50 / IPoE-only p50, timed in turns: "
        f"{p50['full-stack'] / p50['IPoE-only']:.3f} [{card}]")
    say(f"full-stack Engine.process per batch (host included): mean {np.mean(proc_ms):.2f} ms, "
        f"p50 {np.percentile(proc_ms, 50):.2f} ms over {FULL_BATCHES} batches "
        f"({split.report(proc_ms)}); peak device memory {peak_gib:.3f} GiB [{card}]")
    say(f"process_dhcp per batch of {B}: mean {np.mean(dhcp_ms):.2f} ms, "
        f"p50 {np.percentile(dhcp_ms, 50):.2f} ms over {DHCP_BATCHES} batches "
        f"({dsplit.report(dhcp_ms)}) [{card}]")
    for kind, (ring_ms, ring_split, _, _) in ring_runs.items():
        say(f"process_ring_pipelined over the {kind} ring, per call (assemble, dispatch, retire "
            f"the previous batch): mean {np.mean(ring_ms):.2f} ms over {len(ring_ms)} calls "
            f"({ring_split.report(ring_ms)}) [{card}]")
    if profile:
        profile_step(step, card, "full-stack")
    return kern, {"full": launches_full, "dhcp_only": launches_dhcp, **launches_ring}


RING_KINDS = ("PyRing scalar", "PyRing vector", "NativeRing")


def make_ring_of(kind: str):
    """A ring holding 3 undrained batches (the native ring takes pow2 sizes)."""
    kw = dict(nframes=1 << 16, frame_size=L, depth=1 << 15)
    if kind == "NativeRing":
        lib = ring_mod.load_native()
        check(lib is not None and str(nativelib.lib_path("bngring")) == lib._name,
              "the port's bngring built by g++ into bng_tpu_torch/_build/ and loaded")
        return ring_mod.NativeRing(**kw)
    return ring_mod.PyRing(host_path=kind.split()[1], **kw)


def push_runs(ring, frames, fa) -> int:
    """Push in order, one `rx_push_batch` per run of equal direction."""
    n, i = 0, 0
    while i < len(frames):
        j = i
        while j < len(frames) and fa[j] == fa[i]:
            j += 1
        n += ring.rx_push_batch(frames[i:j], from_access=fa[i])
        i = j
    return n


def ring_phases(eng, ctx, rng):
    """process_ring (an all-control batch, then the mix) and
    process_ring_pipelined over RING_BATCHES mixed batches through each of
    RING_KINDS, each against `process` on the same frames: the same TX/FWD
    frames, drops and PASS lanes, and ring stats that count them, identical
    across the three rings."""
    batches = [make_full_batch(rng, ctx) for _ in range(RING_BATCHES)]
    want = []
    for k, (bf, bfa, _) in enumerate(batches):
        out = eng.process(bf, from_access=bfa, now=NOW + 10 + k)
        want.append(out)

    def pops(ring):
        got = {"tx": [], "fwd": []}
        for key, pop in (("tx", ring.tx_pop), ("fwd", ring.fwd_pop)):
            while (item := pop()) is not None:
                got[key].append(item[0])
        return got

    def expected(outs):
        return ([f for o in outs for _, f in o["tx"]], [f for o in outs for _, f in o["fwd"]])

    kernels.reset_launches()
    ring = PyRing(nframes=6 * B, frame_size=L, depth=4 * B)  # holds 3 undrained batches
    ctrl = [F.discover_frame(sub_mac(i), 0x9000 + j)
            for j, i in enumerate(rng.integers(N_SUBS, size=B))]
    check(ring.rx_push_batch(ctrl) == B, "control batch pushed")
    check(eng.process_ring(ring, now=NOW + 10) == B, "process_ring took the control batch")
    check(ring.tx_pending() == B and ring.stats()["slow"] == 0, "every DISCOVER OFFERed")
    pops(ring)
    launches_ctrl = dict(kernels.LAUNCHES)
    check_launches(launches_ctrl, 1, {"probe": 3, "seg_prefix": 0}, "ring control batch")

    kernels.reset_launches()
    for k, (bf, bfa, _) in enumerate(batches):
        for f, a in zip(bf, bfa):
            check(ring.rx_push(f, from_access=a), "ring push")
        check(eng.process_ring(ring, now=NOW + 10 + k) == B, "process_ring took the batch")
    got = pops(ring)
    check((got["tx"], got["fwd"]) == expected(want), "process_ring TX/FWD == process")
    launches_sync = dict(kernels.LAUNCHES)
    check_launches(launches_sync, RING_BATCHES, {"probe": 13, "seg_prefix": 4}, "process_ring")

    kernels.reset_launches()
    runs = {}
    for kind in RING_KINDS:
        ring = make_ring_of(kind)
        call_ms, retired = [], 0
        split = HostSplit(eng, ring)
        for k, (bf, bfa, _) in enumerate(batches):
            check(push_runs(ring, bf, bfa) == len(bf), f"{kind} ring push")
            with split:
                t1 = time.perf_counter()
                retired += eng.process_ring_pipelined(ring, now=NOW + 10 + k)
                call_ms.append((time.perf_counter() - t1) * 1e3)
        retired += eng.flush_pipeline()
        check(retired == RING_BATCHES * B, f"every pipelined batch retired ({kind} ring)")
        got = pops(ring)
        check((got["tx"], got["fwd"]) == expected(want),
              f"process_ring_pipelined over the {kind} ring: TX/FWD == process")
        runs[kind] = (call_ms, split, ring.stats(), got)
        ring.close()
    launches_pipe = dict(kernels.LAUNCHES)
    check_launches(launches_pipe, RING_BATCHES * len(RING_KINDS), {"probe": 13, "seg_prefix": 4},
                   "process_ring_pipelined")
    stats = runs["PyRing scalar"][2]
    n = {v: sum(len(o[v]) for o in want) for v in ("tx", "fwd", "dropped", "slow")}
    check(stats["rx"] == RING_BATCHES * B and stats["tx"] == n["tx"] and stats["fwd"] == n["fwd"]
          and stats["drop"] == n["dropped"] and stats["slow"] == n["slow"],
          f"ring stats {stats} count process's verdicts {n}")
    for kind, (_, _, st, got) in runs.items():
        check(st == stats and got == runs["PyRing scalar"][3],
              f"the {kind} ring's frames and stats == the scalar PyRing's ({st})")
    say(f"ring loops: control batch on the DHCP-only program {launches_ctrl}; process_ring and "
        f"process_ring_pipelined on {RING_BATCHES} mixed batches each equal process, over "
        f"{', '.join(RING_KINDS)} alike (stats {stats}); launches {launches_sync} and "
        f"{launches_pipe}")
    return runs, {"ring_control": launches_ctrl, "ring_sync": launches_sync,
                  "ring_pipelined": launches_pipe}


# ------------------------------------------------------- the serving stack

def client_mac(k: int) -> bytes:
    return (0x02CC00000000 + int(k)).to_bytes(6, "big")


def storm_request(m: bytes, xid: int, ip: int) -> bytes:
    """A REQUEST for an offered address (the renewal sends the same bytes)."""
    p = F.build_request(m, F.REQUEST, xid=xid, requested_ip=ip, server_id=SERVER_IP)
    p.options.append((F.OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 51, 54])))
    return F.udp_packet(m, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67, p.encode().ljust(300, b"\x00"))


class StackClock:
    """The deployment's epoch: advancing with the host clock, or held at
    `fixed` while two stacks must give the same bytes."""

    def __init__(self, fixed: float | None = None):
        self.t0, self.fixed = time.perf_counter(), fixed

    def __call__(self) -> float:
        return self.fixed if self.fixed is not None else NOW + 20 + (time.perf_counter() - self.t0)


def build_serving_stack(hosts, device, clock=None, **cfg):
    """DHCPServer -> Engine(slow_path=server.handle_frame) -> TieredScheduler
    at the CLI defaults (`cfg` overrides), on the headline's host tables (the
    caller retired every other engine over them). The server leases from a
    /16 of its own."""
    fp, nat, qos, spoof = hosts
    clock = clock or StackClock()
    pools = PoolManager(fp)
    pools.add_pool(Pool(pool_id=STACK_POOL, network=STACK_NET, prefix_len=16,
                        gateway=STACK_NET + 1, dns_primary=ip_to_u32("1.1.1.1"),
                        dns_secondary=ip_to_u32("8.8.8.8"), lease_time=86400))
    server = DHCPServer(AC_MAC, SERVER_IP, pools, fastpath_tables=fp, clock=clock)
    eng = Engine(fp, nat, qos, spoof, batch_size=B, pkt_slot=L, slow_path=server.handle_frame,
                 clock=clock, device=device)
    t1 = time.perf_counter()
    sched = TieredScheduler(eng, SchedulerConfig(**{
        "express_batch": 64, "express_max_wait_us": 200.0, "express_aot": True, "bulk_batch": B,
        "bulk_depth": 2, "drain_every": 1, **cfg}))
    return sched, server, time.perf_counter() - t1


def run_until(sched, n: int, timeout_s: float = 120.0) -> list:
    """Poll until n completions have arrived (partial batches close on
    their deadlines); returns them."""
    got, t0 = [], time.perf_counter()
    while len(got) < n:
        sched.poll()
        got += sched.drain_completions()
        check(time.perf_counter() - t0 < timeout_s, f"{n} completions within {timeout_s}s")
    check(len(got) == n, f"{n} completions (got {len(got)})")
    return got


def check_express_program(eng) -> None:
    """The express program is a CUDA graph whose replay makes 3 K1 and 0 K2
    launches."""
    prog = eng.express_aot(64)
    check(prog is not None and prog.graph is not None, "the express program is a captured graph")
    check(prog.launches == {"probe": 3, "seg_prefix": 0},
          f"the express graph holds 3 K1 and 0 K2 launches ({prog.launches})")


def express_graph_ms(eng) -> float:
    """Device time of one express graph replay."""
    return cuda_ms(eng.express_aot(64).graph.replay)


def express_desc(frames) -> np.ndarray:
    desc = np.zeros((64, XD_WORDS), dtype=np.uint32)
    for i, f in enumerate(frames):
        desc[i] = parse_express(f).words
    return desc


def express_vs_plain_and_cpu(eng, rng, err):
    """K1 against its plain version on the express program's three probes
    (K = 1, 8, 2 at B = 64), and one graph replay against the same dispatch
    on the CPU from copied tables. Returns the probes' recorded inputs and
    the descriptor batch."""
    # MAC hits, some VLAN-tagged and some with an option-82 circuit-ID
    # (neither cached, so the MAC tier answers them too)
    frames = [F.discover_frame(sub_mac(i), 0xA000 + j, vlans=[5] if j % 8 == 0 else None,
                               circuit_id=b"cid-%d" % j if j % 8 == 1 else b"", pad=320)
              for j, i in enumerate(rng.integers(N_SUBS, size=64))]
    desc = express_desc(frames)
    dev = eng.device
    now = NOW + 30
    desc_d = torch.from_numpy(desc.view(np.int32)).to(dev)
    rec = record_kernel_inputs(lambda: express_verdicts(eng.tables.dhcp, desc_d, eng.geom.dhcp,
                                                        torch.tensor(now, device=dev)),
                               3, 0, "express program", table_names(eng.tables))
    check([a[3].shape for a in rec["probe"]] == [(64, 1), (64, 8), (64, 2)],
          "the express probes: VLAN K=1, circuit-ID K=8, MAC K=2 at B=64")
    probes_vs_plain([("express", a) for a in rec["probe"]], err)

    prog = eng.express_aot(64)
    got = prog(desc, now)
    block, stats = got.block.cpu(), got.stats.cpu()
    cpu = convert.tables_from_numpy(convert.tables_to_numpy(eng.tables), "cpu")
    want = express_verdicts(cpu.dhcp, torch.from_numpy(desc.view(np.int32).copy()), eng.geom.dhcp,
                            torch.tensor(now))
    check(torch.equal(block, want.block) and torch.equal(stats, want.stats),
          "the express graph's block and stats == the CPU dispatch")
    check(int(block[:, 0].sum()) == 64, "every cached DISCOVER answered by the express program")
    say("express program: K1 bit-equal to its plain version on its 3 probes (K=1, 8, 2; B=64); "
        "one graph replay's block and stats == the same dispatch on the CPU")
    return rec


def check_serving_dispatch_makes_no_sync(sched, rng, flows) -> None:
    """An express dispatch (the fastpath drain shipping a dirty lease row,
    the descriptor upload, the graph replay, the queued result copies) and a
    bulk dispatch (the replica refresh, the drain shipping a dirty binding,
    the fused step, the prefetched next drain) make no synchronising CUDA
    call."""
    eng = sched.engine
    eng.fastpath.touch_lease(sub_mac(1), NOW + 86400)  # a dirty row for the express drain
    eng.antispoof.add_binding(b"\x02\x99\x00\x00\x00\x01", ip_to_u32("10.200.0.1"), MODE_LOOSE)
    for j, i in enumerate(rng.integers(N_SUBS, size=64)):
        sched.submit(F.discover_frame(sub_mac(i), 0xB000 + j), True, tag=("sync", j))
    for j in range(B):
        sched.submit(flow_frame(flows[int(rng.integers(len(flows)))]), True, tag=("sync-bulk", j))
    now = sched.clock()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pend, reason = sched.express.close_batch(now)
            check(sched._dispatch_express(pend, now, reason) == 0,
                  "express dispatch retired nothing")
            pend, reason = sched.bulk.close_batch(now)
            check(sched._dispatch_bulk(pend, now, reason) is None, "bulk dispatch retired nothing")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sched.flush()
    done = sched.drain_completions()
    check(len(done) == 64 + B, "the checked dispatches retired")
    syncs = [str(w.message) for w in seen if "called a synchronizing" in str(w.message)]
    check(not syncs, f"a scheduler dispatch synchronised the host: {syncs[:3]}")
    check(eng.pending_dirty() == 0, "the dirty rows shipped with the dispatches")
    say("an express dispatch (its drain shipping a dirty lease row) and a bulk dispatch (the "
        "prefetched drain applied, the next one, with a dirty binding, built) made no "
        "synchronizing CUDA call (torch.cuda sync debug mode)")


def bulk_out(done, n: int) -> dict:
    """Completions tagged (kind, batch, lane) -> an Engine.process-shaped dict."""
    out = {"tx": [], "fwd": [], "dropped": [], "slow": []}
    for c in done:
        lane = c.tag[-1]
        key = {"tx": "tx", "fwd": "fwd", "drop": "dropped", "slow": "slow"}[c.verdict]
        out[key].append(lane if key == "dropped" else (lane, c.frame))
    check(sum(len(v) for v in out.values()) == n, "every lane of the batch completed")
    return out


def dora_storm(sched, rng, flows, drop_ips, clients: int = STORM_CLIENTS, first: int = 0):
    """`clients` new clients (MACs from `first`), STORM_WAVE per cycle: cycle c sends the
    renewals of wave c-2 (first, so the cycle's first dispatch drains their
    leases), the REQUESTs of wave c-1, the DISCOVERs of wave c and a few
    cached DISCOVERs; every STORM_BULK_EVERY cycles a batch of the IPoE mix
    too. Every lane is checked; returns (seconds, bulk batches)."""
    n_waves = clients // STORM_WAVE
    offers, requests, acks = {}, {}, {}
    n_bulk = 0
    t0 = time.perf_counter()
    for cyc in range(n_waves + 2):
        items = []
        if cyc >= 2:
            items += [(requests[k], ("renew", k)) for k in range((cyc - 2) * STORM_WAVE,
                                                                  (cyc - 1) * STORM_WAVE)]
        if 1 <= cyc <= n_waves:
            for k in range((cyc - 1) * STORM_WAVE, cyc * STORM_WAVE):
                requests[k] = storm_request(client_mac(first + k), 0x5000000 + k, offers[k])
                items.append((requests[k], ("req", k)))
        if cyc < n_waves:
            items += [(F.discover_frame(client_mac(first + k), 0x4000000 + k), ("disc", k))
                      for k in range(cyc * STORM_WAVE, (cyc + 1) * STORM_WAVE)]
            items += [(F.discover_frame(sub_mac(i), 0x6000000 + j), ("cached", int(i)))
                      for j, i in enumerate(rng.integers(N_SUBS, size=STORM_CACHED))]
        for f, tag in items:
            check(sched.submit(f, True, tag=tag) == "express", f"{tag} on the express lane")
        expect = None
        if cyc % STORM_BULK_EVERY == STORM_BULK_EVERY // 2:
            frames, expect = make_batch(rng, flows)
            for lane, f in enumerate(frames):
                sched.submit(f, True, tag=("bulk", lane))
            n_bulk += 1
        done = run_until(sched, len(items) + (B if expect is not None else 0))
        for c in done:
            kind = c.tag[0]
            if kind == "bulk":
                continue
            check(c.lane == "express", f"{c.tag} served by the express lane")
            if kind == "disc":
                check(c.verdict == "slow" and c.frame is not None, f"new client {c.tag} OFFERed")
                r = F.decode_dhcp(F.decode(c.frame).payload)
                check(r.msg_type == F.OFFER and (r.yiaddr >> 16) == (STACK_NET >> 16),
                      f"OFFER from pool {STACK_POOL} for {c.tag}")
                offers[c.tag[1]] = r.yiaddr
            elif kind == "req":
                check(c.verdict == "slow" and c.frame is not None, f"REQUEST {c.tag} ACKed")
                r = F.decode_dhcp(F.decode(c.frame).payload)
                check(r.msg_type == F.ACK and r.yiaddr == offers[c.tag[1]],
                      f"ACK with the OFFER's yiaddr for {c.tag}")
                acks[c.tag[1]] = c.frame
            elif kind == "renew":
                check(c.verdict == "tx" and c.frame == acks[c.tag[1]],
                      f"renewal {c.tag} answered on the device with the slow path's bytes")
            else:
                check(c.verdict == "tx", f"cached DISCOVER {c.tag} answered on the device")
                check_offer({0: c.frame}, 0, sub_ip(c.tag[1]))
        if expect is not None:
            check_outputs(bulk_out([c for c in done if c.tag[0] == "bulk"], B), expect, drop_ips,
                          fresh_ok=False)
    check(len(acks) == clients and len(set(offers.values())) == clients,
          "every new client got an OFFER and an ACK with one address of its own")
    return time.perf_counter() - t0, n_bulk


def express_latency(sched, rng, rounds: int, per_round: int, busy_flows=None):
    """Submit -> retire ms of cached DISCOVERs, `per_round` at a time; with
    `busy_flows`, each round first dispatches a bulk batch of them. Returns
    (latencies, bulk frames retired per second)."""
    lat, bulk_frames, t0 = [], 0, time.perf_counter()
    for r in range(rounds):
        if busy_flows is not None:
            for lane, f in enumerate(busy_flows):
                sched.submit(f, True, tag=("busy-bulk", lane))
            sched.poll()  # the bulk lane closes full and dispatches
        for j, i in enumerate(rng.integers(N_SUBS, size=per_round)):
            sched.submit(F.discover_frame(sub_mac(i), 0x7000000 + j), True, tag=("lat", int(i)))
        done = []
        while sum(c.tag[0] == "lat" for c in done) < per_round:
            sched.poll()
            done += sched.drain_completions()
        bulk_frames += sum(c.tag[0] == "busy-bulk" for c in done)
        for c in done:
            if c.tag[0] == "lat":
                check(c.lane == "express" and c.verdict == "tx",
                      "cached DISCOVER answered on the device")
                check_offer({0: c.frame}, 0, sub_ip(c.tag[1]))
                lat.append(c.latency_s * 1e3)
    if busy_flows is not None:
        sched.flush()
        bulk_frames += sum(c.tag[0] == "busy-bulk" for c in sched.drain_completions())
        check(bulk_frames == rounds * len(busy_flows), "every bulk frame retired")
    return np.array(lat), bulk_frames / (time.perf_counter() - t0)


class ExpressSplit(HostSplit):
    """Host time of the express dispatches and retires inside the block:
    admission parse, fastpath drain, descriptor upload, graph replay, the
    wait for the outputs, the template render, and the slow path."""

    PARTS = ("admit", "drain", "upload", "replay", "wait", "render", "slow")

    def __init__(self, sched):
        import bng_tpu_torch.runtime.scheduler as sched_mod

        eng = sched.engine
        self.sites = [(sched_mod, "parse_express", "admit"),
                      (eng, "_drain_fastpath_updates", "drain"),
                      (engine_mod.ExpressProgram, "__call__", "upload"),
                      (torch.cuda.CUDAGraph, "replay", "replay"),
                      (engine_mod._InFlight, "wait", "wait"),
                      (TieredScheduler, "_express_reply", "render"),
                      (TieredScheduler, "_express_replies_vec", "render"),
                      (eng, "_handle_slow_lanes", "slow")]
        self.ms = {k: 0.0 for k in self.PARTS}

    def report(self, n_dispatch: int) -> str:
        ms = dict(self.ms)
        ms["upload"] -= ms["replay"]  # the program call holds the replay
        return ", ".join(f"{k} {v / n_dispatch:.4f}" for k, v in ms.items()) + " ms per dispatch"


class RenderSplit(HostSplit):
    """Host time of the express retire's template render, per host path."""

    PARTS = ("scalar", "vector")

    def __init__(self):
        self.sites = [(TieredScheduler, "_express_reply", "scalar"),
                      (TieredScheduler, "_express_replies_vec", "vector")]
        self.ms = {k: 0.0 for k in self.PARTS}


def express_render_ab(sched, rng, card, rounds: int, one_group: bool) -> None:
    """The same bursts of 64 cached DISCOVERs through the express lane under
    the scalar render (a template patch per frame) and the vector one (one
    batched patch per template group), in turns: identical reply bytes; the
    render's host ms per dispatch of 64 for each. `one_group`: untagged
    subscribers of one pool (one template group); else subscribers of every
    pool, a quarter VLAN-tagged and an eighth relayed (many small groups)."""
    split = RenderSplit()
    with split:
        for r in range(rounds):
            if one_group:
                frames = [F.discover_frame(sub_mac(i), 0x7A00000 + j)
                          for j, i in enumerate(rng.integers(min(N_SUBS, 1 << 16), size=64))]
            else:
                frames = [F.discover_frame(sub_mac(i), 0x7A00000 + j,
                                           vlans=[5] if j % 4 == 0 else None,
                                           giaddr=RELAY_IP if j % 8 == 1 else 0)
                          for j, i in enumerate(rng.integers(N_SUBS, size=64))]
            got = {}
            for path in (("scalar", "vector") if r % 2 == 0 else ("vector", "scalar")):
                sched._vec = path == "vector"
                got[path] = sched.process(frames)
            check(got["vector"] == got["scalar"] and len(got["scalar"]["tx"]) == 64,
                  f"burst {r}: the vector render's bytes == the scalar render's")
    sched._vec = False
    what = "one template group" if one_group else "every pool, tagged and relayed lanes mixed"
    say(f"express render per dispatch of 64 ({what}), bytes identical over {rounds} bursts: "
        f"scalar {split.ms['scalar'] / rounds:.4f} ms, vector {split.ms['vector'] / rounds:.4f} ms "
        f"[{card}]")


def express_upload_ab(eng, card, rounds: int) -> None:
    """The express program's descriptor upload, host time per call, in
    turns: a fresh pinned buffer per upload (the way before this slice) and
    the program's persistent pinned buffers, each reused after the event
    behind its last copy."""
    prog = eng.express_aot(64)
    desc = np.random.default_rng(5).integers(0, 1 << 32, size=(64, XD_WORDS), dtype=np.uint32)
    ms = {"fresh": 0.0, "persistent": 0.0}
    waits = sum(st.waits for st in prog.stages)
    torch.cuda.synchronize()
    for r in range(rounds):
        for way in (("fresh", "persistent") if r % 2 == 0 else ("persistent", "fresh")):
            t1 = time.perf_counter()
            if way == "fresh":
                prog.desc.copy_(torch.from_numpy(desc.view(np.int32)).pin_memory(), non_blocking=True)
            else:
                st = prog.stages[r % len(prog.stages)]
                np.copyto(st.acquire(), desc)
                st.upload_into(prog.desc)
            ms[way] += (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    say(f"express descriptor upload per dispatch (host, {rounds} of each in turns): a fresh "
        f"pinned buffer {ms['fresh'] / rounds:.4f} ms, the persistent pinned buffers "
        f"{ms['persistent'] / rounds:.4f} ms ({sum(st.waits for st in prog.stages) - waits} "
        f"waits) [{card}]")


class BeatSplit(HostSplit):
    """Host time inside the block of each lane's dispatch and retire (a
    retire holds the wait for the batch's outputs)."""

    PARTS = ("express dispatch", "express retire", "bulk dispatch", "bulk retire")

    def __init__(self):
        self.sites = [(TieredScheduler, "_dispatch_express", "express dispatch"),
                      (TieredScheduler, "_retire_express", "express retire"),
                      (TieredScheduler, "_dispatch_bulk", "bulk dispatch"),
                      (TieredScheduler, "_retire_bulk", "bulk retire")]
        self.ms = {k: 0.0 for k in self.PARTS}

    def report(self, rounds: int) -> str:
        return ", ".join(f"{k} {v / rounds:.3f}" for k, v in self.ms.items()) + " ms per round"


def serving_stack_phases(hosts, flows, drop_ips, card, device, err):
    t0 = time.perf_counter()
    sched, server, capture_s = build_serving_stack(hosts, device)
    eng = sched.engine
    torch.cuda.synchronize()
    say(f"serving stack built in {time.perf_counter() - t0:.1f}s (the express graph captured in "
        f"{capture_s * 1e3:.1f} ms at scheduler init); DHCP server pool {STACK_POOL} "
        f"{STACK_NET >> 24}.{(STACK_NET >> 16) & 0xFF}.0.0/16")
    check_express_program(eng)
    rng = np.random.default_rng(11)
    rec = express_vs_plain_and_cpu(eng, rng, err)

    # ---- the DORA storm with cached DISCOVERs and the IPoE mix
    snap0 = sched.stats_snapshot()
    kernels.reset_launches()
    storm_s, n_bulk = dora_storm(sched, rng, flows, drop_ips)
    launches_storm = dict(kernels.LAUNCHES)
    snap = sched.stats_snapshot()
    ex = snap["express"]
    n_aot = ex["aot_dispatches"] - snap0["express"]["aot_dispatches"]
    n_bdisp = snap["bulk"]["batches"] - snap0["bulk"]["batches"]
    check(ex["aot_misses"] == 0 and ex["jit_dispatches"] == 0 and ex["fallbacks"] == {},
          f"the graph served every express batch ({ex})")
    check(n_aot == snap["express"]["batches"] - snap0["express"]["batches"],
          "aot_dispatches == the express batches")
    check(n_bdisp == n_bulk, f"{n_bulk} bulk batches dispatched ({n_bdisp})")
    check_launches(launches_storm, 1, {"probe": 3 * n_aot + 8 * n_bdisp, "seg_prefix": 4 * n_bdisp},
                   "serving stack (3 K1 per express dispatch, 8 K1 + 4 K2 per bulk step)")
    say(f"serving stack: DORA storm of {STORM_CLIENTS} new clients (OFFER and ACK from pool "
        f"{STACK_POOL}, renewals answered on the device with the slow path's bytes), "
        f"cached DISCOVERs and {n_bulk} IPoE batches: {n_aot} express dispatches, {n_bdisp} bulk; "
        f"launches {launches_storm}; server {server.stats}")
    say(f"DORA storm: {STORM_CLIENTS / storm_s:.1f} DORAs/s through the scheduler and the slow "
        f"path ({storm_s:.2f} s, cached DISCOVERs and IPoE batches interleaved) [{card}]")

    check_serving_dispatch_makes_no_sync(sched, rng, flows)

    # ---- express OFFER latency, the bulk lane idle: counts 0, express only
    kernels.reset_launches()
    split, beat = ExpressSplit(sched), BeatSplit()
    n0 = sched.express_aot_dispatches
    with split, beat:
        lat, _ = express_latency(sched, rng, LAT_ROUNDS, 64)
    n_lat = sched.express_aot_dispatches - n0
    launches_express = dict(kernels.LAUNCHES)
    check(n_lat == LAT_ROUNDS, f"one express dispatch per round ({n_lat})")
    check_launches(launches_express, n_lat, {"probe": 3, "seg_prefix": 0}, "express lane")
    lone, _ = express_latency(sched, rng, LONE_ROUNDS, 1)
    flow_frames = [flow_frame(flows[int(i)]) for i in rng.integers(len(flows), size=B)]
    busy_beat = BeatSplit()
    with busy_beat:
        busy, bulk_fps = express_latency(sched, rng, BUSY_ROUNDS, 64, busy_flows=flow_frames)
    for name, x in (("64 cached DISCOVERs, bulk idle", lat), ("a lone cached DISCOVER", lone),
                    ("64 cached DISCOVERs right after a bulk dispatch", busy)):
        say(f"express OFFER latency submit->retire, {name}: p50 {np.percentile(x, 50):.3f} ms, "
            f"p99 {np.percentile(x, 99):.3f} ms, max {x.max():.3f} ms over {len(x)} frames "
            f"[{card}]")
    say(f"express dispatch split over {n_lat} dispatches: {split.report(n_lat)} [{card}]")
    say(f"beat split, bulk idle: {beat.report(LAT_ROUNDS)}; right after a bulk dispatch: "
        f"{busy_beat.report(BUSY_ROUNDS)} [{card}]")
    say(f"bulk lane with the host (submit, dispatch, retire, {BUSY_ROUNDS} batches of {B} flows "
        f"with an express batch each): {bulk_fps:.0f} frames/s [{card}]")
    express_upload_ab(eng, card, UPLOAD_ROUNDS)
    express_render_ab(sched, rng, card, RENDER_ROUNDS, one_group=False)
    express_render_ab(sched, rng, card, RENDER_ROUNDS, one_group=True)

    # ---- device times
    say(f"express graph replay (3 K1 + selects, B=64): {express_graph_ms(eng):.4f} ms "
        f"device [{card}]")
    time_kernels(rec, card, "express")
    return {"express": launches_express, "serving_stack": launches_storm}


# ------------------------------------------------------------- the devloop

def stack_workload(sched, seed: int) -> list:
    """The comparison workload, through the `process` facade (each call
    flushes, so two stacks give the same bytes): DORA waves of DL_CLIENTS new
    clients (a cycle sends the renewals of wave c-2, the REQUESTs of wave
    c-1 and the DISCOVERs of wave c), then DL_BURSTS bursts of 64 cached
    DISCOVERs. Returns every call's output."""
    rng = np.random.default_rng(seed)
    out, offers, requests = [], {}, {}
    n_waves, W = DL_CLIENTS // STORM_WAVE, STORM_WAVE
    for cyc in range(n_waves + 2):
        renew = list(range((cyc - 2) * W, (cyc - 1) * W)) if cyc >= 2 else []
        req = list(range((cyc - 1) * W, cyc * W)) if 1 <= cyc <= n_waves else []
        disc = list(range(cyc * W, (cyc + 1) * W)) if cyc < n_waves else []
        frames = [requests[k] for k in renew]
        for k in req:
            requests[k] = storm_request(client_mac(DL_CLIENT0 + k), 0x5800000 + k, offers[k])
            frames.append(requests[k])
        frames += [F.discover_frame(client_mac(DL_CLIENT0 + k), 0x4800000 + k) for k in disc]
        res = sched.process(frames)
        check([i for i, _ in res["tx"]] == list(range(len(renew))),
              f"cycle {cyc}: the renewals, and only they, answered on the device")
        slow = dict(res["slow"])
        for j, k in enumerate(disc):
            offers[k] = F.decode_dhcp(F.decode(slow[len(renew) + len(req) + j]).payload).yiaddr
        out.append(res)
    for _ in range(DL_BURSTS):
        frames = [F.discover_frame(sub_mac(i), 0x7800000 + j)
                  for j, i in enumerate(rng.integers(N_SUBS, size=64))]
        res = sched.process(frames)
        check(len(res["tx"]) == 64, "every cached DISCOVER of a burst answered on the device")
        out.append(res)
    return out


def devloop_vs_plain_and_cpu(eng, k: int, rng, err):
    """K1 against its plain version on every probe of one eager ring of k
    slots over the ring program's tables, and one graph replay's blocks,
    stats and cursors against the same ring on the CPU from copied tables.
    Returns the probes' recorded inputs."""
    prog = eng.devloop_aot(k, 64)
    dev = eng.device
    now = NOW + 40
    stage = PinnedStage((k, 64, XD_WORDS), np.uint32, dev)
    for slot in range(k):
        stage.host[slot] = express_desc(
            [F.discover_frame(sub_mac(i), 0xC000 + slot * 64 + j,
                              vlans=[5] if j % 8 == 0 else None,
                              circuit_id=b"cid-%d" % j if j % 8 == 1 else b"", pad=320)
             for j, i in enumerate(rng.integers(N_SUBS, size=64))])
    ring_d = torch.from_numpy(stage.host.view(np.int32).copy()).to(dev)
    now_d = torch.tensor(now, device=dev)
    rec = record_kernel_inputs(
        lambda: [express_verdicts(prog.tables, ring_d[s], eng.geom.dhcp, now_d) for s in range(k)],
        3 * k, 0, f"devloop ring k={k}", table_names(eng.tables._replace(dhcp=prog.tables)))
    probes_vs_plain([("devloop", a) for a in rec["probe"]], err)

    cpu = convert.tables_from_numpy(convert.tables_to_numpy(prog.tables), "cpu")
    saved = prog.cursors.clone()
    res = eng.call_devloop_aot(prog, None, stage, k, now)
    blocks, stats, cur = (t.cpu().clone() for t in (res.blocks, res.dhcp_stats, res.cursors))
    base = saved.cpu()
    prog.cursors.copy_(saved)  # the pump's slot accounting does not count this replay
    ring_c = torch.from_numpy(stage.host.view(np.int32).copy())
    want = [express_verdicts(cpu, ring_c[s], eng.geom.dhcp, torch.tensor(now)) for s in range(k)]
    want_stats = sum(w.stats for w in want) & 0xFFFFFFFF
    check(torch.equal(blocks, torch.stack([w.block for w in want]))
          and torch.equal(stats, want_stats), f"the k={k} ring graph's blocks and stats == the CPU ring")
    check(cur.tolist()[:3] == [k, (int(base[1]) + k) & 0xFFFFFFFF, (int(base[2]) + 1) & 0xFFFFFFFF],
          f"the ring graph advanced the cursors (tail, seq, epoch) by one ring ({cur.tolist()})")
    check(int(blocks[:, :, 0].sum()) == 64 * k, "every cached DISCOVER of the ring answered")
    say(f"devloop ring k={k}: K1 bit-equal to its plain version on the {3 * k} probes of one eager "
        f"ring; one graph replay's blocks, stats and cursors == the same ring on the CPU")
    return rec


def check_devloop_program(eng, k: int) -> None:
    prog = eng.devloop_aot(k, 64)
    check(prog is not None and prog.graph is not None, f"the k={k} ring program is a captured graph")
    check(prog.launches == {"probe": 3 * k, "seg_prefix": 0},
          f"the k={k} ring graph holds {3 * k} K1 and 0 K2 launches ({prog.launches})")


def check_ring_dispatch_makes_no_sync(sched, rng) -> None:
    """A ring dispatch (the fastpath drain shipping a dirty lease row into
    the leading copy, the ring upload from pinned memory, the graph replay,
    the queued result copies) makes no synchronising CUDA call, and no
    staging buffer waits for its last upload."""
    eng, pump = sched.engine, sched._devloop
    k = pump.ring.k
    eng.fastpath.touch_lease(sub_mac(3), NOW + 86400)
    for j, i in enumerate(rng.integers(N_SUBS, size=64 * k)):
        sched.submit(F.discover_frame(sub_mac(i), 0xD000 + j), True, tag=("sync", j))
    now, waits, d0 = sched.clock(), pump.ring.staging_waits, pump.dispatches
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(k):
                pend, reason = sched.express.close_batch(now)
                check(sched._dispatch_express(pend, now, reason) == 0, "the ring retired nothing")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    check(pump.dispatches == d0 + 1, "the k-th batch dispatched the ring")
    sched.flush()
    check(len(sched.drain_completions()) == 64 * k, "the checked ring retired")
    syncs = [str(w.message) for w in seen if "called a synchronizing" in str(w.message)]
    check(not syncs, f"a ring dispatch synchronised the host: {syncs[:3]}")
    check(pump.ring.staging_waits == waits, "no ring staging buffer waited for its upload")
    check(eng.pending_dirty() == 0, "the dirty lease row shipped with the ring")
    say(f"a ring dispatch of k={k} (its drain shipping a dirty lease row) made no synchronizing "
        f"CUDA call (torch.cuda sync debug mode) and no staging wait")


def ring_dispatch_counts(sched, rng, rounds: int) -> dict:
    """`rounds` full rings of k batches of 64 cached DISCOVERs, submitted and
    polled: one device dispatch per k express batches, 3k K1 per ring."""
    pump = sched._devloop
    k = pump.ring.k
    d0, b0 = pump.dispatches, pump.batches
    kernels.reset_launches()
    for r in range(rounds):
        for j, i in enumerate(rng.integers(N_SUBS, size=64 * k)):
            sched.submit(F.discover_frame(sub_mac(i), 0xE000 + j), True, tag=("count", int(i)))
        for c in run_until(sched, 64 * k):
            check(c.verdict == "tx", "cached DISCOVER answered by the ring")
    launches = dict(kernels.LAUNCHES)
    nd, nb = pump.dispatches - d0, pump.batches - b0
    check(nd == rounds and nb == rounds * k, f"k={k}: {rounds} ring dispatches for {nb} batches")
    check_launches(launches, nd, {"probe": 3 * k, "seg_prefix": 0}, f"devloop k={k}")
    sched.quiesce()
    audit = pump.audit()
    check(audit["consistent"], f"k={k} cursor audit after quiesce ({audit})")
    say(f"devloop k={k}: {nd} device dispatches for {nb} express batches "
        f"({nd / nb:.4f} per batch); launches {launches}; cursors {pump.ring.read_cursors().tolist()}")
    return launches


class DevloopSplit(HostSplit):
    """Host time of the devloop's dispatches and retires inside the block:
    admission parse, fastpath drain, ring upload, graph replay, the wait for
    the ring's outputs, the rest of the retire, the template render and
    the slow path."""

    PARTS = ("admit", "drain", "upload", "replay", "wait", "retire", "render", "slow")

    def __init__(self, sched):
        import bng_tpu_torch.runtime.scheduler as sched_mod

        eng = sched.engine
        self.sites = [(sched_mod, "parse_express", "admit"),
                      (eng, "_drain_fastpath_updates", "drain"),
                      (PinnedStage, "upload_into", "upload"),
                      (torch.cuda.CUDAGraph, "replay", "replay"),
                      (engine_mod._InFlight, "wait", "wait"),
                      (DevloopPump, "_retire", "retire"),
                      (TieredScheduler, "_express_reply", "render"),
                      (TieredScheduler, "_express_replies_vec", "render"),
                      (eng, "_handle_slow_lanes", "slow")]
        self.ms = {k: 0.0 for k in self.PARTS}

    def report(self, n_rings: int) -> str:
        ms = dict(self.ms)
        ms["retire"] -= ms["wait"] + ms["render"] + ms["slow"]  # the retire holds them
        return ", ".join(f"{k} {v / n_rings:.4f}" for k, v in ms.items()) + " ms per ring"


def devloop_phases(hosts, flows, drop_ips, card, device, err):
    fp = hosts[0]
    # ---- two fresh stacks, the per-batch lane's and the devloop's, same bytes
    outs = {}
    for loop in ("aot", "devloop"):
        clock = StackClock(fixed=NOW + 30)
        t0 = time.perf_counter()
        sched, server, setup_s = build_serving_stack(hosts, device, clock, express_loop=loop)
        check(sched.express_loop == loop, f"the {loop} stack resolved its loop")
        say(f"{loop} serving stack built in {time.perf_counter() - t0:.1f}s (scheduler init, "
            f"its graphs captured, {setup_s * 1e3:.1f} ms)")
        outs[loop] = stack_workload(sched, seed=21)
        if loop == "aot":
            # back to the host state the devloop stack starts from
            for mk in list(server.leases):
                fp.remove_subscriber(mk)
            del sched, server
            gc.collect()
            torch.cuda.empty_cache()
    check(outs["devloop"] == outs["aot"],
          f"two fresh stacks: the devloop's reply bytes == the aot lane's ({DL_CLIENTS} DORAs, "
          f"{DL_BURSTS} bursts of 64)")
    eng, pump = sched.engine, sched._devloop
    sched.quiesce()
    check(pump.audit()["consistent"], "cursor audit after the comparison")
    say(f"devloop k={pump.ring.k}: reply bytes of {DL_CLIENTS} DORAs (OFFER, ACK, renewal on the "
        f"device) and {DL_BURSTS} bursts of 64 cached DISCOVERs == the aot lane's, from two fresh "
        f"stacks; pump {pump.stats()}")
    clock.fixed = None  # host time from here on: latencies and rates

    # ---- the program on the card: its tally, K1 against plain, a replay against the CPU
    check_devloop_program(eng, 8)
    rec = devloop_vs_plain_and_cpu(eng, 8, np.random.default_rng(23), err)

    # ---- an injected devloop.dispatch fail: served per batch, counted, the same bytes
    rng = np.random.default_rng(29)
    frames = [F.discover_frame(sub_mac(i), 0xF000 + j)
              for j, i in enumerate(rng.integers(N_SUBS, size=64 * pump.ring.k))]
    clean = sched.process(frames)
    miss0, slots0 = sched.express_fallbacks.get("devloop_miss", 0), pump.fallback_slots
    with faults.armed(faults.FaultPlan(0, [faults.FaultSpec("devloop.dispatch", faults.FAIL)]),
                      log=False) as inj:
        faulted = sched.process(frames)
    check(faulted == clean and inj.injected == [("devloop.dispatch", "fail", 1)]
          and sched.express_fallbacks["devloop_miss"] == miss0 + 1
          and pump.fallback_slots == slots0 + pump.ring.k,
          "an injected devloop.dispatch fail: the ring's slots served per batch, counted, "
          "identical bytes")
    say(f"devloop.dispatch fail injected: {pump.ring.k} slots served per batch, counted "
        f"(fallbacks {sched.express_fallbacks}), bytes identical to the clean ring")
    check_ring_dispatch_makes_no_sync(sched, rng)

    # ---- the DORA storm and the latencies through the devloop (counts 0)
    snap0 = sched.stats_snapshot()
    d0 = pump.dispatches
    kernels.reset_launches()
    split = DevloopSplit(sched)
    with split:
        storm_s, n_bulk = dora_storm(sched, rng, flows, drop_ips, clients=DL_STORM_CLIENTS,
                                     first=DL_CLIENT0 + DL_CLIENTS)
    launches_storm = dict(kernels.LAUNCHES)
    n_ring, snap = pump.dispatches - d0, sched.stats_snapshot()
    n_bdisp = snap["bulk"]["batches"] - snap0["bulk"]["batches"]
    check(snap["express"]["fallbacks"] == snap0["express"]["fallbacks"]
          and snap["express"]["jit_dispatches"] == 0, "the rings served the storm")
    check_launches(launches_storm, 1, {"probe": 3 * pump.ring.k * n_ring + 8 * n_bdisp,
                                       "seg_prefix": 4 * n_bdisp},
                   "devloop storm (3k K1 per ring, 8 K1 + 4 K2 per bulk step)")
    say(f"devloop DORA storm: {DL_STORM_CLIENTS / storm_s:.1f} DORAs/s ({DL_STORM_CLIENTS} new "
        f"clients, {storm_s:.2f} s, cached DISCOVERs and {n_bulk} IPoE batches interleaved); "
        f"{n_ring} ring dispatches for "
        f"{snap['express']['batches'] - snap0['express']['batches']} express batches; "
        f"launches {launches_storm} [{card}]")
    say(f"devloop per-ring host split in the storm: {split.report(n_ring)} [{card}]")
    lat, _ = express_latency(sched, rng, LAT_ROUNDS, 64)
    lone, _ = express_latency(sched, rng, LONE_ROUNDS, 1)
    flow_frames = [flow_frame(flows[int(i)]) for i in rng.integers(len(flows), size=B)]
    busy, _ = express_latency(sched, rng, BUSY_ROUNDS, 64, busy_flows=flow_frames)
    for name, x in (("64 cached DISCOVERs, bulk idle", lat), ("a lone cached DISCOVER", lone),
                    ("64 cached DISCOVERs right after a bulk dispatch", busy)):
        say(f"devloop k={pump.ring.k} OFFER latency submit->retire, {name}: p50 "
            f"{np.percentile(x, 50):.3f} ms, p99 {np.percentile(x, 99):.3f} ms, max {x.max():.3f} "
            f"ms over {len(x)} frames [{card}]")
    sched.quiesce()
    check(pump.audit()["consistent"], f"cursor audit after the storm ({pump.audit()})")

    # ---- dispatches per express batch at k = 8, 1, 16 (rings that fill)
    launches = {"devloop_storm": launches_storm}
    launches["devloop_k8"] = ring_dispatch_counts(sched, rng, DL_ROUNDS)

    # ---- device times: the graph per replay, K1 inside it
    prog = eng.devloop_aot(8, 64)
    saved = prog.cursors.clone()
    graph_ms = cuda_ms(lambda: prog.graph.replay())
    prog.cursors.copy_(saved)
    say(f"devloop ring graph k=8 (24 K1 + selects over 8 slots of 64): {graph_ms:.4f} ms device "
        f"per replay, {graph_ms / 24:.5f} ms per K1 launch of it at most [{card}]")
    slot0 = {"probe": rec["probe"][:3], "seg_prefix": [], "table": rec["table"][:3]}
    time_kernels(slot0, card, "devloop ring slot 0")
    for k in (1, 16):
        other = TieredScheduler(eng, SchedulerConfig(
            express_batch=64, express_max_wait_us=200.0, bulk_batch=B, bulk_depth=2,
            drain_every=1, express_loop="devloop", devloop_k=k))
        check_devloop_program(eng, k)
        launches[f"devloop_k{k}"] = ring_dispatch_counts(other, rng, DL_ROUNDS)
        say(f"devloop ring graph k={k}: {cuda_ms(lambda: eng.devloop_aot(k, 64).graph.replay()):.4f} ms "
            f"device per replay [{card}]")
    return launches


# ------------------------------------------------------------- the sharded step

N_SHARDS = 8  # the reference's multichip default
B_SHARD = B // N_SHARDS  # lanes per shard
SH_BATCHES = 6  # ring batches through process_ring_pipelined, timed
SH_STEPS = 10  # staged device steps timed
N_AGED = 2000  # flows created long before the traffic, swept by expire
NAT_IPS_PER_SHARD = 34  # 64-port blocks for ~31k NAT subscribers per shard
SH_DISC = B_SHARD // 5  # cached DISCOVERs per shard region


def build_sharded(device):
    """The sharded deployment on the headline's host data, built through
    `ShardedCluster`: 1M DHCP subscribers hash-sharded over 8 shards
    (`add_subscribers_bulk`, sub_nbuckets = nbuckets_for(1M / 8)), 1M NAT44
    UDP flows over 250k subscribers each on its affinity shard (the first
    N_AGED flows created 1000 s before the rest), 10k QoS policies (half
    with a burst below one frame) and 10k strict antispoof bindings on
    their subscribers' affinity shards, the walled garden on."""
    cl = ShardedCluster(
        N_SHARDS, batch_per_shard=B_SHARD, sub_nbuckets=nbuckets_for(N_SUBS // N_SHARDS),
        vlan_nbuckets=1 << 10, cid_nbuckets=1 << 10, max_pools=64,
        nat_sessions_nbuckets=nbuckets_for(N_FLOWS // N_SHARDS), nat_ports_per_subscriber=64,
        nat_sub_nbuckets=nbuckets_for(N_NAT_SUBS // N_SHARDS), qos_nbuckets=1 << 13,
        spoof_nbuckets=1 << 12,
        public_ips=[ip_to_u32("203.0.113.1") + i for i in range(N_SHARDS * NAT_IPS_PER_SHARD)],
        public_ips_per_shard=NAT_IPS_PER_SHARD, device=device)
    cl.set_server_config_all(AC_MAC, SERVER_IP)
    for pid in range(max(1, (N_SUBS >> 16) + 1)):
        cl.add_pool_all(pid + 1, ip_to_u32(f"10.{pid}.0.0") & 0xFFFF0000, 16, SERVER_IP,
                        ip_to_u32("1.1.1.1"), ip_to_u32("8.8.8.8"), 86400)
    idx = np.arange(N_SUBS, dtype=np.uint64)
    owners = cl.add_subscribers_bulk(idx + 0x02AA00000000,
                                     pool_ids=(idx >> np.uint64(16)).astype(np.uint32) + 1,
                                     ips=sub_ip(idx).astype(np.uint32),
                                     lease_expiries=np.uint32(NOW + 86400))

    aff = np.array([cl.affinity_shard_ip(int(ip)) for ip in sub_ip(np.arange(N_NAT_SUBS))])
    fi = np.arange(N_FLOWS, dtype=np.int64)
    src = sub_ip(fi % N_NAT_SUBS).astype(np.uint32)
    dst = (ip_to_u32("93.184.0.0") + fi // N_NAT_SUBS).astype(np.uint32)
    sport = (20000 + fi // N_NAT_SUBS).astype(np.uint32)
    shard = aff[fi % N_NAT_SUBS]
    aged = fi < N_AGED
    nat_ip = np.zeros(N_FLOWS, dtype=np.int64)
    nat_port = np.zeros(N_FLOWS, dtype=np.int64)
    for s in range(N_SHARDS):
        m = shard == s
        cl.nat[s].bulk_allocate_nat(np.unique(src[m]), NOW)
        for sel, t in ((m & aged, NOW - 1000), (m & ~aged, NOW)):
            ip, port, ok = cl.nat[s].bulk_flows(src[sel], dst[sel], sport[sel], np.uint32(443),
                                                np.uint32(17), 100, t)
            check(bool(ok.all()), f"shard {s}: every NAT flow allocated")
            nat_ip[sel], nat_port[sel] = ip, port
    flows = np.stack([src, dst, sport, nat_ip, nat_port, shard, aged], axis=1).astype(np.int64)

    pol = sub_ip(np.arange(N_QOS, dtype=np.int64) * (N_NAT_SUBS // N_QOS))
    pol_aff = aff[np.arange(N_QOS) * (N_NAT_SUBS // N_QOS)]
    half = np.arange(N_QOS) < N_QOS // 2
    bound = sub_ip(np.arange(N_BINDINGS, dtype=np.int64) * 7)
    bound_aff = aff[(np.arange(N_BINDINGS) * 7) % N_NAT_SUBS]
    keys = np.array([[int.from_bytes(flow_mac(ip)[:2], "big"), int.from_bytes(flow_mac(ip)[2:], "big")]
                     for ip in bound], dtype=np.uint32)
    rows = np.zeros((N_BINDINGS, 8), dtype=np.uint32)
    rows[:, 0], rows[:, 5], rows[:, 6] = bound, 1, MODE_STRICT  # AB_IPV4, AB_VALIDS, AB_MODE
    for s in range(N_SHARDS):
        q = pol_aff == s
        cl.qos[s].bulk_set_subscribers(pol[q & half], down_bps=64_000, up_bps=64_000,
                                       down_burst=150, up_burst=150)
        cl.qos[s].bulk_set_subscribers(pol[q & ~half], down_bps=10_000_000, up_bps=2_000_000)
        cl.spoof[s].set_config(MODE_LOOSE, False)
        cl.spoof[s].add_allowed_range(ip_to_u32("10.0.0.0"), 8)
        cl.spoof[s].bindings.bulk_insert(keys[bound_aff == s], rows[bound_aff == s])
    cl.sync_tables()
    return cl, flows, set(int(x) for x in pol[half]), np.asarray(owners)


def steer_groups(macs_idx) -> dict[int, list[int]]:
    """Subscriber indices grouped by the ring shard their DISCOVER is
    steered to (FNV-1a32 of the source MAC for DHCP control)."""
    out = {s: [] for s in range(N_SHARDS)}
    for i in macs_idx:
        out[fnv1a32(sub_mac(int(i))) % N_SHARDS].append(int(i))
    return out


def sharded_frames(rng, flows, groups):
    """One full 8 x 1024 batch in push order: per shard n_disc cached
    DISCOVERs the ring steers there (their owners anywhere) and flows of
    that shard's subscribers (none aged). Returns (frames, expect by lane)."""
    n_disc = SH_DISC
    live = np.nonzero(flows[:, 6] == 0)[0]
    by_shard = [live[flows[live, 5] == s] for s in range(N_SHARDS)]
    frames, expect = [], {}
    for s in range(N_SHARDS):
        for r in range(B_SHARD):
            lane = s * B_SHARD + r
            if r < n_disc:
                i = groups[s][int(rng.integers(len(groups[s])))]
                frames.append(F.discover_frame(sub_mac(i), 0x2000 + lane))
                expect[lane] = ("dhcp", sub_ip(i))
            else:
                f = flows[by_shard[s][int(rng.integers(len(by_shard[s])))]]
                frames.append(flow_frame(f))
                expect[lane] = ("flow", f)
    return frames, expect


def assemble_full(cl, ring, frames):
    """Push a batch's frames into the steering ring and assemble one window:
    every shard's region must come back full, in push order."""
    check(ring.rx_push_batch(frames, from_access=True) == len(frames), "ring took the batch")
    pkt, length, flags = (np.zeros((B, L), np.uint8), np.zeros((B,), np.uint32),
                          np.zeros((B,), np.uint32))
    check(ring.assemble_sharded(pkt, length, flags) == B, "sharded assemble filled every region")
    for lane, f in enumerate(frames):
        if lane % 997 == 0:
            check(bytes(pkt[lane, : length[lane]]) == f, f"ring lane {lane} holds its frame")
    return pkt, length, flags


def drain_ring(ring) -> None:
    while ring.tx_pop() is not None:
        pass
    while ring.fwd_pop() is not None:
        pass
    while ring.slow_pop() is not None:
        pass


def check_sharded_outputs(out, expect, drop_ips) -> int:
    """Per lane: DISCOVERs TX with the subscriber's yiaddr, flows FWD with
    their SNAT rewrite (or DROP for a policed subscriber)."""
    n_drop = 0
    v = out["verdict"]
    for lane, (kind, info) in expect.items():
        frame = bytes(out["out_pkt"][lane, : int(out["out_len"][lane])])
        if kind == "dhcp":
            check(v[lane] == 2, f"sharded DISCOVER lane {lane} TX")
            check_offer({lane: frame}, lane, info)
        elif int(info[0]) in drop_ips:
            check(v[lane] == 1, f"sharded policed flow lane {lane} DROP")
            n_drop += 1
        else:
            check(v[lane] == 3, f"sharded flow lane {lane} FWD")
            check_snat({lane: frame}, lane, info)
    return n_drop


def sharded_names(cl) -> dict[int, str]:
    out = {}
    for i, t in enumerate(cl.tables):
        out.update({k: f"shard {i} {v}" for k, v in table_names(t).items()})
    return out


def sharded_launches(n: int, local: int) -> dict:
    """K1 and K2 launches of one sharded fused step: each shard's local
    probes plus one probe per owner shard for each of the three DHCP
    lookups; two K2 per QoS direction per shard."""
    return {"probe": n * (local + 3 * n), "seg_prefix": 4 * n}


def staged_lanes(cl, pkt, length, fa, device):
    b = cl.b
    return ([torch.from_numpy(pkt[i * b:(i + 1) * b]).to(device) for i in range(cl.n)],
            [torch.from_numpy(length[i * b:(i + 1) * b].astype(np.int64)).to(device)
             for i in range(cl.n)],
            [torch.from_numpy(fa[i * b:(i + 1) * b]).to(device) for i in range(cl.n)])


def sharded_gpu_equals_cpu(cl, batches, device):
    """The sharded step on the card and on the CPU (plain versions, a copy of
    every shard's tables, the CPU exchange), batch after batch: every result
    leaf and every shard's table words identical."""
    cpu_tables = [convert.tables_from_numpy(convert.tables_to_numpy(t), "cpu") for t in cl.tables]
    cpu_ex = DeviceLocalExchange(["cpu"] * cl.n)
    for k, (pkt, length, fa) in enumerate(batches):
        now = [NOW + 40 + k, (NOW + 40 + k) * 10**6 & 0xFFFFFFFF]
        g = sharded_step(cl.tables, cl.exchange, *staged_lanes(cl, pkt, length, fa, device),
                         cl.geom_sharded, *(torch.tensor(x, device=device) for x in now))
        c = sharded_step(cpu_tables, cpu_ex, *staged_lanes(cl, pkt, length, fa, "cpu"),
                         cl.geom_sharded, *(torch.tensor(x) for x in now))
        for f in g._fields:
            a, b = getattr(g, f), getattr(c, f)
            if f == "tables" or (a is None and b is None):
                continue
            check(torch.equal(a.cpu(), b), f"sharded batch {k}: GPU {f} == CPU {f}")
        for i, (gt, ct) in enumerate(zip(cl.tables, cpu_tables)):
            ga, ca = convert.tables_to_numpy(gt), convert.tables_to_numpy(ct)

            def walk(a, b, path):
                if isinstance(a, np.ndarray):
                    check(np.array_equal(a, b), f"sharded batch {k}: shard {i} {path} GPU == CPU")
                elif a is not None:
                    for name, x, y in zip(a._fields, a, b):
                        walk(x, y, f"{path}.{name}")

            walk(ga, ca, "tables")
    say(f"sharded step: GPU == CPU on {len(batches)} batches (verdicts, bytes, lengths, summed "
        f"stats, punts, violations and every word of all {cl.n} shards' tables)")


def check_sharded_dispatch_makes_no_sync(cl, pkt, length, fa, dpkt, dlen):
    """A sharded fused dispatch and a sharded DHCP-only dispatch, each
    draining dirty rows on every shard, make no synchronizing CUDA call."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(0, 64, 8):
                cl.touch_lease(sub_mac(i), NOW + 86400)
            flights = [engine_mod._InFlight(cl._dispatch_fused(pkt, length, fa, NOW + 45, 0))]
            for i in range(1, 64, 8):
                cl.touch_lease(sub_mac(i), NOW + 86400)
            flights.append(engine_mod._InFlight(cl._dispatch_dhcp(dpkt, dlen, NOW + 45)))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for fl in flights:
        fl.wait()
    syncs = [str(w.message) for w in seen if "called a synchronizing" in str(w.message)]
    check(not syncs, f"a sharded dispatch synchronised the host: {syncs[:3]}")
    check(cl.pending_dirty() == 0, "the dirty rows shipped with the sharded dispatches")
    say("a sharded fused dispatch and a sharded DHCP-only dispatch, each shipping dirty rows, "
        "made no synchronizing CUDA call (torch.cuda sync debug mode)")


class ShardSplit:
    """Host time of `process_ring_pipelined` over the sharded ring: the
    ring's assemble, the update drain of every shard, the rest of the
    dispatch (uploads, queueing N shards' steps and the output copies), the
    wait for the outputs, and the rest (the demux to the ring and the slow
    path)."""

    def __init__(self, cl, ring):
        self.sites = [(ring, "assemble_sharded", "assemble"), (cl, "_drain_updates", "drain"),
                      (cl, "_drain_fastpath", "drain"), (cl, "_dispatch_ring_batch", "dispatch"),
                      (engine_mod._InFlight, "wait", "wait")]
        self.ms = {"assemble": 0.0, "drain": 0.0, "dispatch": 0.0, "wait": 0.0}

    __enter__ = HostSplit.__enter__
    __exit__ = HostSplit.__exit__

    def report(self, call_ms) -> str:
        n = len(call_ms)
        parts = {k: v / n for k, v in self.ms.items()}
        parts["dispatch"] -= parts["drain"]  # the drain runs inside the dispatch
        parts["demux"] = float(np.mean(call_ms)) - sum(parts.values())
        return ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + " ms per call"


def sharded_phases(card, device, err):
    """The sharded deployment: per-lane outcomes and kernels on every call,
    GPU == CPU, the skewed batch's punts, no sync in a dispatch, launch
    counts, times, expire and dryrun_multichip(8)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cl, flows, drop_ips, owners = build_sharded(device)
    torch.cuda.synchronize()
    say(f"sharded deployment ({N_SHARDS} shards x {B_SHARD} lanes; {N_SUBS} DHCP subscribers "
        f"hash-sharded, per shard {np.bincount(owners, minlength=N_SHARDS).tolist()}; "
        f"{N_FLOWS} NAT flows on affinity shards, per shard "
        f"{np.bincount(flows[:, 5], minlength=N_SHARDS).tolist()}) built and uploaded in "
        f"{time.perf_counter() - t0:.1f}s (device tables {torch.cuda.memory_allocated() / 2**30:.3f} GiB)")
    rng = np.random.default_rng(8)
    groups = steer_groups(rng.integers(N_SUBS, size=40_000))
    ring = cl.make_ring(nframes=4 * B, frame_size=L, depth=2 * B)
    check(type(ring).__name__ == "NativeRing", "the sharded ring is the NativeRing")
    local = 6  # antispoof 1, NAT44 4, garden 1
    per = sharded_launches(N_SHARDS, local)

    # 1. one ring-assembled batch through step(): every lane, every kernel call
    frames, expect = sharded_frames(rng, flows, groups)
    pkt, length, flags = assemble_full(cl, ring, frames)
    fa = (flags & ring_mod.FLAG_FROM_ACCESS) != 0
    box = {}
    rec = record_kernel_inputs(lambda: box.update(out=cl.step(pkt, length, fa, NOW + 1, 1000)),
                               per["probe"], per["seg_prefix"], "sharded step", sharded_names(cl))
    out = box["out"]
    ring.complete(out["verdict"].astype(np.uint8), np.ascontiguousarray(out["out_pkt"]),
                  out["out_len"].astype(np.uint32), B)
    drain_ring(ring)
    n_drop = check_sharded_outputs(out, expect, drop_ips)
    check(n_drop > 0 and int(out["qos_stats"][1]) == n_drop, "sharded QoS drops, summed")
    check(int(out["dhcp_stats"][1]) == N_SHARDS * SH_DISC, "summed DHCP hits = DISCOVER lanes")
    probes_vs_plain([("sharded", a) for a in rec["probe"]], err)
    segs_vs_plain([("sharded", s, v, c) for s, v, c in rec["seg_prefix"]], err)
    cross = sum(1 for t in rec["table"] if t.startswith("shard") and "dhcp" in t)
    # shard 0's calls are timed later; the rest of the recorded inputs (a
    # copy of the probed table per call) are let go
    srec = {"probe": rec["probe"][: local + 3 * N_SHARDS], "seg_prefix": rec["seg_prefix"][:4],
            "table": rec["table"][: local + 3 * N_SHARDS]}
    n_rec = (len(rec["probe"]), len(rec["seg_prefix"]))
    del rec
    say(f"sharded step: every lane as the deployment implies ({N_SHARDS * SH_DISC} OFFERs from "
        f"any shard, {n_drop} QoS drops, the rest SNAT); K1 bit-equal on its {n_rec[0]} "
        f"calls ({cross} of them the exchange's owner probes), K2 on its {n_rec[1]}")

    dframes = [F.discover_frame(sub_mac(groups[s][j]), 0x3000 + s * B_SHARD + j)
               for s in range(N_SHARDS) for j in range(B_SHARD)]
    dpkt, dlen, _ = assemble_full(cl, ring, dframes)
    box = {}
    drec = record_kernel_inputs(lambda: box.update(out=cl.dhcp_step(dpkt, dlen, NOW + 2)),
                                3 * N_SHARDS * N_SHARDS, 0, "sharded DHCP step")
    ring.complete(np.where(box["out"]["is_reply"], 2, 0).astype(np.uint8),
                  np.ascontiguousarray(box["out"]["out_pkt"]),
                  box["out"]["out_len"].astype(np.uint32), B)
    drain_ring(ring)
    check(bool(box["out"]["is_reply"].all()), "the sharded DHCP-only step answered every lane")
    probes_vs_plain([("sharded dhcp", a) for a in drec["probe"]], err)
    say(f"sharded DHCP-only step: {B} OFFERs; K1 bit-equal on its {len(drec['probe'])} calls")
    del drec

    # 2. the skewed batch: every DISCOVER's owner is shard 0, so each
    # region's lanes past the exchange capacity punt: PASS, never a reply
    cap = table_mod.exchange_capacity(B_SHARD, cl.geom_sharded.dhcp.sub)
    skew_groups = steer_groups(np.nonzero(owners == 0)[0][:60_000])
    sframes = [F.discover_frame(sub_mac(skew_groups[s][j]), 0x4000 + j)
               for s in range(N_SHARDS) for j in range(B_SHARD)]
    spkt, slen, sflags = assemble_full(cl, ring, sframes)
    sout = cl.step(spkt, slen, (sflags & ring_mod.FLAG_FROM_ACCESS) != 0, NOW + 3, 2000)
    ring.complete(sout["verdict"].astype(np.uint8), np.ascontiguousarray(sout["out_pkt"]),
                  sout["out_len"].astype(np.uint32), B)
    drain_ring(ring)
    for s in range(N_SHARDS):
        v = sout["verdict"][s * B_SHARD:(s + 1) * B_SHARD]
        check((v[:cap] == 2).all() and (v[cap:] == 0).all(),
              f"skewed region {s}: {cap} OFFERs, the rest PASS")
        for r in range(0, cap, 37):
            lane = s * B_SHARD + r
            check_offer({lane: bytes(sout["out_pkt"][lane, : int(sout["out_len"][lane])])}, lane,
                        sub_ip(skew_groups[s][r]))
    say(f"skewed batch (every DISCOVER owned by shard 0): exchange capacity {cap} of {B_SHARD} "
        f"lanes; per region {cap} OFFERs with the right yiaddr, {B_SHARD - cap} punted (PASS)")

    # 3. GPU == CPU on two batches, then no sync in a sharded dispatch
    two = []
    for _ in range(2):
        fr, _ = sharded_frames(rng, flows, groups)
        p_, l_, f_ = assemble_full(cl, ring, fr)
        ring.complete(np.zeros((B,), np.uint8), p_, l_, B)
        drain_ring(ring)
        two.append((p_, l_.astype(np.int64), (f_ & ring_mod.FLAG_FROM_ACCESS) != 0))
    sharded_gpu_equals_cpu(cl, two, device)
    check_sharded_dispatch_makes_no_sync(cl, two[0][0], two[0][1], two[0][2], dpkt, dlen)

    # 4. the ring loops: counts 0, the pipelined loop over mixed batches,
    # then an all-control batch (the sharded DHCP-only program)
    mixed = [sharded_frames(rng, flows, groups)[0] for _ in range(SH_BATCHES)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    split = ShardSplit(cl, ring)
    call_ms, done = [], 0
    for k, fr in enumerate(mixed):
        check(ring.rx_push_batch(fr, from_access=True) == B, "ring took the batch")
        with split:
            t1 = time.perf_counter()
            done += cl.process_ring_pipelined(ring, NOW + 10 + k, (10 + k) * 10**6, pkt_slot=L)
            call_ms.append((time.perf_counter() - t1) * 1e3)
        drain_ring(ring)
    done += cl.flush_pipeline()
    drain_ring(ring)
    sh = dict(kernels.LAUNCHES)
    check(done == SH_BATCHES * B, f"pipelined loop retired every frame ({done})")
    check_launches(sh, SH_BATCHES, per, "sharded path")
    kernels.reset_launches()
    check(ring.rx_push_batch(dframes, from_access=True) == B, "ring took the control batch")
    check(cl.process_ring(ring, NOW + 30, 30 * 10**6, pkt_slot=L) == B, "control batch retired")
    drain_ring(ring)
    shd = dict(kernels.LAUNCHES)
    check_launches(shd, 1, {"probe": 3 * N_SHARDS * N_SHARDS, "seg_prefix": 0}, "sharded DHCP path")
    say(f"sharded launches: {per['probe']} K1 + {per['seg_prefix']} K2 per fused step "
        f"(N x (6 local + 3N) and 4N at N = {N_SHARDS}), {3 * N_SHARDS * N_SHARDS} K1 per DHCP-only "
        f"step; counts {sh} over {SH_BATCHES} steps, {shd} over one")
    snap = cl.telemetry.snapshot()
    say(f"sharded telemetry: {snap['steps']} steps, {snap['psum_dhcp_hits']} summed hits, "
        f"pass_total {snap['pass_total']}, missteers {snap['missteer_total']}")
    check(snap["missteer_total"] == 0, "no missteer on the steering ring")

    # 5. times
    lanes = staged_lanes(cl, *two[0], device)
    tn = (torch.tensor(NOW + 50, device=device), torch.tensor(50 * 10**6, device=device))

    def step():
        return sharded_step(cl.tables, cl.exchange, *lanes, cl.geom_sharded, *tn)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    lat = []
    for _ in range(SH_STEPS):
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
    lat = np.array(lat)
    say(f"sharded device step N={N_SHARDS} x {B_SHARD} = {B} lanes: "
        f"{B / (lat.mean() / 1e3) / 1e6:.4f} Mpps, p50 {np.percentile(lat, 50):.3f} ms, "
        f"p99 {np.percentile(lat, 99):.3f} ms over {SH_STEPS} steps (host clock, synced) [{card}]")
    say(f"sharded process_ring_pipelined per batch of {B}: mean {np.mean(call_ms):.2f} ms, "
        f"p50 {np.percentile(call_ms, 50):.2f}, p99 {np.percentile(call_ms, 99):.2f} ms, "
        f"{B / (np.mean(call_ms) / 1e3) / 1e6:.4f} Mpps with the host ({split.report(call_ms)}) [{card}]")
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"sharded peak device memory over the ring loops and the timed steps: {peak:.3f} GiB "
        f"(tables {torch.cuda.memory_allocated() / 2**30:.3f} GiB held with shard 0's recorded "
        f"kernel inputs) [{card}]")
    profile_step(step, card, "sharded", steps=2)
    time_kernels(srec, card, "sharded (shard 0)")

    # 6. expire: the aged flows (never in the traffic) on every shard
    before = [cl.nat[s].sessions.count for s in range(N_SHARDS)]
    aged_per = np.bincount(flows[flows[:, 6] == 1, 5], minlength=N_SHARDS)
    t1 = time.perf_counter()
    n_exp = cl.expire(NOW + 100)
    exp_ms = (time.perf_counter() - t1) * 1e3
    gone = [b - cl.nat[s].sessions.count for s, b in enumerate(before)]
    check(n_exp == N_AGED and gone == aged_per.tolist() and min(gone) > 0,
          f"expire swept the aged flows on every shard ({n_exp}, {gone})")
    fr, _ = sharded_frames(rng, flows, groups)
    check(ring.rx_push_batch(fr, from_access=True) == B, "ring took the batch")
    cl.process_ring(ring, NOW + 101, 101 * 10**6, pkt_slot=L)
    drain_ring(ring)
    check(cl.pending_dirty() == 0, "the expired rows drained to every shard's device tables")
    say(f"sharded expire: {n_exp} aged flows swept over {N_SHARDS} shards ({gone}) in "
        f"{exp_ms:.1f} ms (device rows fetched, {sum(before)} sessions scanned) [{card}]")
    del lanes, srec
    more = sharded_checkpoint_phases(cl, flows, groups, ring, rng, per, card, device, err)
    del cl, ring
    gc.collect()
    torch.cuda.empty_cache()

    # 7. the reference's dryrun on the card
    kernels.reset_launches()
    snap = entry_mod.dryrun_multichip(N_SHARDS)
    check(snap["steps"] == 7 and snap["psum_dhcp_hits"] == 4 * N_SHARDS, "dryrun_multichip(8)")
    return {"sharded": sh, "sharded_dhcp": shd, **more}


# ------------------------------------------- checkpoint, warm restart and swap

RS_BATCHES = 3  # headline batches before the snapshot, and after the restore
SWAP_ROUNDS = 50  # express bursts of 64 timed just before and just after the swap
SWAP_WRITES = 256  # subscriber rows written between the snapshot and the flip
SW_CLIENT0 = 1 << 21  # first client MAC of those rows
RESHARD_SUBS = 16_384  # the re-shard's reduced deployment (the walk inserts row by row)
RESHARD_FLOWS = 16_384
RESHARD_NAT_SUBS = 4_096


def host_words(tables):
    """A copy of a PipelineTables' words on the host (uint32 leaves)."""
    def copy(x):
        if isinstance(x, np.ndarray):
            return x.copy()
        return None if x is None else type(x)(*(copy(v) for v in x))

    return copy(convert.tables_to_numpy(tables))


def words_equal(x, y, what: str, path: str = "tables") -> None:
    """Every word of two host copies of PipelineTables, equal."""
    if isinstance(x, np.ndarray):
        check(np.array_equal(x, y), f"{what}: {path} equal")
    elif x is not None:
        for name, u, v in zip(x._fields, x, y):
            words_equal(u, v, what, f"{path}.{name}")


def tables_equal(a, b, what: str) -> None:
    """Every word of two PipelineTables, equal."""
    words_equal(convert.tables_to_numpy(a), convert.tables_to_numpy(b), what)


def renew_frame(i: int, xid: int) -> bytes:
    """A bound client's renewal: REQUEST with ciaddr, unicast to the server."""
    m, ip = sub_mac(i), int(sub_ip(i))
    p = F.build_request(m, F.REQUEST, xid=xid, ciaddr=ip)
    p.options.append((F.OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 51, 54])))
    return F.udp_packet(m, b"\xff" * 6, ip, SERVER_IP, 68, 67, p.encode().ljust(320, b"\x00"))


def check_acks(out, subs) -> None:
    tx = dict(out["tx"])
    check(len(tx) == len(subs), f"every renewal answered on the device ({len(tx)} of {len(subs)})")
    for lane, i in enumerate(subs):
        reply = F.decode_dhcp(F.decode(tx[lane]).payload)
        check(reply.msg_type == F.ACK and reply.yiaddr == int(sub_ip(int(i))), f"ACK lane {lane}")


def restart_phases(hosts, flows, drop_ips, card, device, err):
    """Warm restart of the headline deployment: traffic (device-written NAT
    counters and QoS tokens), quiesce, fold, snapshot through the state
    store, then a fresh engine restored from the file and one upload."""
    fp, nat, qos, spoof = hosts
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(fp, nat, qos, spoof, batch_size=B, pkt_slot=L, device=device)
    rng = np.random.default_rng(41)
    for k in range(RS_BATCHES):
        frames, expect = make_batch(rng, flows)
        check_outputs(eng.process(frames, now=NOW + 40 + k), expect, drop_ips, False)
    t = {}
    t0 = time.perf_counter()
    eng.quiesce()
    eng.fold_device_authoritative()
    t["fold"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck = ckpt_mod.build_checkpoint(1, float(NOW + 45), fastpath=fp, nat=nat, qos=qos,
                                   antispoof=spoof, node_id="chip-smoke")
    t["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = ckpt_mod.encode_checkpoint(ck)
    t["encode"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="bng-ckpt-") as d:
        store = CheckpointStore(d)
        t0 = time.perf_counter()
        path = store.save(ck)
        t["save"] = time.perf_counter() - t0
        size = path.stat().st_size
        t0 = time.perf_counter()
        ck2, got = store.load_latest()
        t["read"] = time.perf_counter() - t0
    check(got == path and size == len(data), "the store's newest file is the one saved")
    del ck

    # restore: fresh host mirrors of the same geometry, one upload, serve
    nows = [NOW + 50 + k for k in range(RS_BATCHES)]
    batches = [make_batch(rng, flows) for _ in range(RS_BATCHES)]
    ren_subs = rng.integers(N_SUBS, size=B)
    ren = [renew_frame(int(i), 0x9000000 + j) for j, i in enumerate(ren_subs)]
    slow_calls = []
    t0 = time.perf_counter()
    tmp = ops_mod.clone_mirrors(eng)
    rows = ckpt_mod.restore_checkpoint(ck2, **tmp)
    t["hydrate"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    eng2 = Engine(tmp["fastpath"], tmp["nat"], tmp["qos"], tmp["antispoof"], batch_size=B,
                  pkt_slot=L, slow_path=slow_calls.append, device=device)
    torch.cuda.synchronize()
    t["upload"] = time.perf_counter() - t1
    kernels.reset_launches()
    outs2 = [eng2.process(batches[0][0], now=nows[0])]
    t["serve"] = t["read"] + time.perf_counter() - t0
    first_tables = host_words(eng2.tables)
    outs2 += [eng2.process(f, now=n) for (f, _), n in zip(batches[1:], nows[1:])]
    out_ren2 = eng2.process(ren, now=NOW + 60)
    launches = dict(kernels.LAUNCHES)
    check_launches(launches, RS_BATCHES + 1, {"probe": 8, "seg_prefix": 4}, "restored engine")
    for out, (_, expect) in zip(outs2, batches):
        check_outputs(out, expect, drop_ips, False)
    check_acks(out_ren2, ren_subs)
    check(not slow_calls, f"no slow-path call on the restored engine ({len(slow_calls)})")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the original engine on the same batches: every lane and every table word equal
    outs1 = [eng.process(f, now=n) for (f, _), n in zip(batches, nows)]
    out_ren1 = eng.process(ren, now=NOW + 60)
    check(outs1 == outs2 and out_ren1 == out_ren2, "restored engine == original, every lane")
    tables_equal(eng.tables, eng2.tables, "restored engine tables == the original's")

    # K1 and K2 against their plain versions on every call of a restored step
    frames, expect = make_batch(rng, flows)
    box = {}
    rec = record_kernel_inputs(lambda: box.update(out=eng2.process(frames, now=NOW + 61)),
                               8, 4, "restored step", table_names(eng2.tables))
    check_outputs(box["out"], expect, drop_ips, False)
    probes_vs_plain([("restored", a) for a in rec["probe"]], err)
    segs_vs_plain([("restored", *c) for c in rec["seg_prefix"]], err)
    del rec

    # a CPU engine of the port restored from the same bytes: GPU == CPU
    tmpc = ops_mod.clone_mirrors(eng)
    ckpt_mod.restore_checkpoint(ckpt_mod.decode_checkpoint(data), **tmpc)
    cpu = Engine(tmpc["fastpath"], tmpc["nat"], tmpc["qos"], tmpc["antispoof"], batch_size=B,
                 pkt_slot=L, device="cpu")
    check(cpu.process(batches[0][0], now=nows[0]) == outs2[0],
          "the CPU engine restored from the same bytes == the GPU engine, every lane")
    words_equal(first_tables, convert.tables_to_numpy(cpu.tables), "GPU == CPU restored tables")
    del cpu, tmpc, first_tables

    say(f"warm restart of the headline deployment: checkpoint {size} bytes "
        f"({size / 2**20:.1f} MiB, {len(ck2.arrays)} arrays; restored rows "
        f"sub {rows['fastpath.sub']}, nat sessions {rows['nat.sessions']}, blocks "
        f"{rows['nat.blocks']}, eim {rows['nat.eim']}, qos {rows['qos.up']}+{rows['qos.down']}, "
        f"bindings {rows['antispoof.bindings']}) [{card}]")
    say("warm restart seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in (("fold", t["fold"]), ("build", t["build"]),
                                    ("encode", t["encode"]),
                                    ("save (encode + write + fsync)", t["save"]),
                                    ("read (read + CRC verify + decode)", t["read"]),
                                    ("host hydrate", t["hydrate"]), ("upload", t["upload"])))
        + f"; time-to-serve (read + hydrate + upload + first batch of {B} retired) "
        f"{t['serve']:.3f} s; "
        f"peak device memory {peak:.3f} GiB [{card}]")
    say(f"restored engine: {RS_BATCHES} headline batches and {B} renewals == the original engine "
        f"(every lane and table word), cached DISCOVERs and renewals answered on the device with "
        f"0 slow-path calls; K1/K2 bit-equal on a restored step; the CPU engine restored from "
        f"the same bytes == the GPU engine; launches {launches}")
    del eng2, tmp, ck2, data, eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"restore": launches}


def swap_phases(hosts, flows, drop_ips, card, device, err):
    """Blue/green swap of the serving stack (the express lane and the
    devloop at k = 8) under traffic, with rows written between the snapshot
    and the flip; then an armed `ops.swap` fail that rolls back."""
    fp = hosts[0]
    sched, server, _ = build_serving_stack(hosts, device, express_loop="devloop")
    eng, pump = sched.engine, sched._devloop
    check(sched.express_loop == "devloop" and pump.ring.k == 8, "the devloop stack at k = 8")
    # the deployment's rows are bulk installs with no lease book: the audit
    # runs without the server's book (its row-vs-lease clause has nothing to hold)
    comps = {"engine": eng, "scheduler": sched}
    rng = np.random.default_rng(43)
    burst = [F.discover_frame(sub_mac(int(i)), 0xE000000 + j)
             for j, i in enumerate(rng.integers(N_SUBS, size=64 * 8))]
    ref = sched.process(burst)
    lat_before, _ = express_latency(sched, rng, SWAP_ROUNDS, 64)

    # traffic in flight at the barrier: express rings and a bulk batch, not polled
    inflight = [F.discover_frame(sub_mac(int(i)), 0xE100000 + j)
                for j, i in enumerate(rng.integers(N_SUBS, size=64 * 4))]
    inflight += [flow_frame(flows[int(i)]) for i in rng.integers(len(flows), size=B // 4)]
    for j, f in enumerate(inflight):
        sched.submit(f, True, tag=("swap-traffic", j))

    def writes(first):
        return [(client_mac(SW_CLIENT0 + first + j), STACK_NET + 0xF000 + first + j)
                for j in range(SWAP_WRITES)]

    def patched(rows, record):
        """clone_mirrors (called after the snapshot) first writes `rows`;
        the delta replay's kernel inputs are recorded when asked."""
        real_clone, real_replay = ops_mod.clone_mirrors, ops_mod.replay_delta_since
        box = {}

        def clone_then_write(e):
            for m, ip in rows:
                fp.add_subscriber(m, pool_id=STACK_POOL, ip=ip, lease_expiry=NOW + 86400)
            return real_clone(e)

        def replay(e, arrays, *a, **kw):
            if not record:
                return real_replay(e, arrays, *a, **kw)
            box["rec"] = record_kernel_inputs(
                lambda: box.update(d=real_replay(e, arrays, *a, **kw)), None, 0, "delta replay")
            return box["d"]

        ops_mod.clone_mirrors, ops_mod.replay_delta_since = clone_then_write, replay
        return box, (real_clone, real_replay)

    new = writes(0)
    snap0, d_old = sched.stats_snapshot(), pump.dispatches
    kernels.reset_launches()
    box, real = patched(new, record=False)
    try:
        rep = ops_mod.blue_green_swap(comps)
    finally:
        ops_mod.clone_mirrors, ops_mod.replay_delta_since = real
    check(rep["outcome"] == "ok" and rep["audit_ok"], f"the swap flipped ({rep})")
    standby = comps["engine"]
    check(standby is not eng and sched.engine is standby, "the scheduler serves the standby")
    check(standby.express_captures == 1 and standby.devloop_captures == 1,
          "the express graph and the ring program were captured for the standby")
    check(sched._devloop is not pump and sched._devloop._seeded is None,
          "a fresh pump for the standby; its leading copy seeds at the first ring")
    check(rep["frames_deferred"] == len(inflight), f"the barrier retired the frames in flight "
          f"({rep['frames_deferred']} of {len(inflight)})")
    done = {c.tag[1]: c for c in sched.drain_completions() if c.tag[0] == "swap-traffic"}
    check(len(done) == len(inflight) and all(c.verdict in ("tx", "fwd", "drop")
                                             for c in done.values()),
          "every frame in flight at the barrier answered on the device")
    # the written rows are still dirty at the replay (no drain ran since), so
    # they ship with its steps; delta_rows counts only slots it newly marks
    check(rep["delta_steps"] >= 1 and not rep["delta_resync"],
          f"the delta replay shipped the rows written after the snapshot ({rep})")
    after = sched.process(burst)
    check(after == ref, "cached-DISCOVER bursts: the standby's bytes == the active's before")
    probe = sched.process([F.discover_frame(m, 0xE200000 + j) for j, (m, _) in enumerate(new)])
    tx = dict(probe["tx"])
    check(len(tx) == SWAP_WRITES and all(
        F.decode_dhcp(F.decode(tx[j]).payload).yiaddr == ip for j, (_, ip) in enumerate(new)),
        "the rows written between the snapshot and the flip answer on the standby's device")
    lat_after, _ = express_latency(sched, rng, SWAP_ROUNDS, 64)
    check_ring_dispatch_makes_no_sync(sched, rng)
    launches = dict(kernels.LAUNCHES)
    snap = sched.stats_snapshot()
    n_bulk = snap["bulk"]["batches"] - snap0["bulk"]["batches"]
    check(launches["seg_prefix"] == 4 * (rep["delta_steps"] + n_bulk)
          and launches["probe"] > 8 * rep["delta_steps"],
          f"swap path: 4 K2 per replay step and bulk step, K1 above 8 per replay step ({launches})")
    say(f"blue/green swap under traffic: outcome {rep['outcome']}, frames_deferred "
        f"{rep['frames_deferred']}, quiesce_s {rep['quiesce_s']:.3f}, hydrate_s "
        f"{rep['hydrate_s']:.3f}, delta_rows {rep['delta_rows']} / delta_steps "
        f"{rep['delta_steps']}, audit {rep['audit_s']:.3f} s (ok, {rep['violations']}), flip_s "
        f"{rep['flip_s']:.6f}, duration_s {rep['duration_s']:.3f}; launches {launches} "
        f"(old pump {pump.dispatches - d_old} rings, new pump {sched._devloop.dispatches}, "
        f"{n_bulk} bulk steps) [{card}]")
    for name, x in (("just before the swap", lat_before), ("just after the swap", lat_after)):
        say(f"express burst of 64 cached DISCOVERs (devloop k=8), {name}: p50 "
            f"{np.percentile(x, 50):.3f} ms, p99 {np.percentile(x, 99):.3f} ms over {len(x)} "
            f"frames [{card}]")
    devloop_vs_plain_and_cpu(standby, 8, rng, err)

    # an armed ops.swap fail: rolled back, the active engine healed and serving alike
    burst2 = [F.discover_frame(sub_mac(int(i)), 0xE300000 + j)
              for j, i in enumerate(rng.integers(N_SUBS, size=64 * 8))]
    before2 = sched.process(burst2)
    new2 = writes(SWAP_WRITES)
    box, real = patched(new2, record=True)
    try:
        with faults.armed(faults.FaultPlan(0, [faults.FaultSpec("ops.swap", faults.FAIL)]),
                          log=False) as inj:
            rb = ops_mod.blue_green_swap(comps)
    finally:
        ops_mod.clone_mirrors, ops_mod.replay_delta_since = real
    check(rb["outcome"] == "rolled_back" and inj.injected == [("ops.swap", "fail", 1)]
          and comps["engine"] is standby and sched.engine is standby,
          f"an armed ops.swap fail rolled back ({rb})")
    check(sched.process(burst2) == before2, "after the rollback the active engine's bytes == before")
    probe = sched.process([F.discover_frame(m, 0xE400000 + j) for j, (m, _) in enumerate(new2)])
    # the heal's upload does not reach the devloop: its leading copy, seeded
    # before it, keeps threading its own chain, as the reference's pump does
    # (ROADMAP Queue 3), so the rows written during the swap are not in it
    check(not probe["tx"] and len(probe["slow"]) == SWAP_WRITES,
          "the rows written during the swap take the slow path after the heal, as in the "
          f"reference ({len(probe['tx'])} on the device)")
    rec = box["rec"]
    n_steps = rb["delta_steps"]
    check(len(rec["probe"]) == 8 * n_steps and len(rec["seg_prefix"]) == 4 * n_steps,
          f"the replay ran {n_steps} fused steps (8 K1 + 4 K2 each)")
    probes_vs_plain([("delta replay", a) for a in rec["probe"]], err)
    segs_vs_plain([("delta replay", *c) for c in rec["seg_prefix"]], err)
    say(f"armed ops.swap fail: outcome {rb['outcome']} after the replay of {rb['delta_rows']} rows "
        f"in {n_steps} steps (K1/K2 bit-equal on its {len(rec['probe'])} + "
        f"{len(rec['seg_prefix'])} calls), the active engine healed (one upload) and serving the "
        f"same bytes; duration_s {rb['duration_s']:.3f} [{card}]")
    del rec, box, sched, server, eng, standby, comps, pump
    gc.collect()
    torch.cuda.empty_cache()
    return {"swap": launches}


def build_reshard_cluster(n: int, device, flows: bool = True):
    """The re-shard's reduced deployment on n shards: 16,384 DHCP subscribers,
    NAT blocks for 4,096 of them (with 16,384 flows when `flows`), 1,024 QoS
    policies and 1,024 strict bindings, each on its affinity shard."""
    k = 2  # public IPs per shard: 64-port blocks for the shard's NAT subscribers
    cl = ShardedCluster(
        n, batch_per_shard=B_SHARD, sub_nbuckets=nbuckets_for(RESHARD_SUBS),
        vlan_nbuckets=1 << 10, cid_nbuckets=1 << 10, max_pools=64,
        nat_sessions_nbuckets=nbuckets_for(RESHARD_FLOWS), nat_ports_per_subscriber=64,
        nat_sub_nbuckets=nbuckets_for(RESHARD_NAT_SUBS), qos_nbuckets=1 << 12,
        spoof_nbuckets=1 << 12,
        public_ips=[ip_to_u32("203.0.113.1") + i for i in range(N_SHARDS * k)],
        public_ips_per_shard=k, device=device)
    cl.set_server_config_all(AC_MAC, SERVER_IP)
    cl.add_pool_all(1, ip_to_u32("10.0.0.0"), 16, SERVER_IP, ip_to_u32("1.1.1.1"), 0, 86400)
    idx = np.arange(RESHARD_SUBS, dtype=np.uint64)
    cl.add_subscribers_bulk(idx + 0x02AA00000000, pool_ids=1, ips=sub_ip(idx).astype(np.uint32),
                            lease_expiries=np.uint32(NOW + 86400))
    subs = sub_ip(np.arange(RESHARD_NAT_SUBS, dtype=np.int64))
    aff = np.array([cl.affinity_shard_ip(int(ip)) for ip in subs])
    fi = np.arange(RESHARD_FLOWS, dtype=np.int64)
    src = subs[fi % RESHARD_NAT_SUBS].astype(np.uint32)
    for s in range(n):
        check(cl.nat[s].bulk_allocate_nat(subs[aff == s], NOW) == int((aff == s).sum()),
              f"re-shard source shard {s}: every NAT block carved")
        m = aff[fi % RESHARD_NAT_SUBS] == s
        if flows and m.any():
            _, _, ok = cl.nat[s].bulk_flows(
                src[m], (ip_to_u32("93.184.0.0") + fi[m] // RESHARD_NAT_SUBS).astype(np.uint32),
                (20000 + fi[m] // RESHARD_NAT_SUBS).astype(np.uint32), np.uint32(443),
                np.uint32(17), 100, NOW)
            check(bool(ok.all()), f"re-shard source shard {s}: every flow allocated")
    for j, ip in enumerate(subs[::4]):
        cl.set_qos(int(ip), down_bps=10_000_000, up_bps=2_000_000)
        cl.add_spoof_binding(flow_mac(int(ip)), int(ip), MODE_STRICT)
    cl.sync_tables()
    return cl


def placement(cl) -> list:
    """Per shard, which keys it holds: DHCP rows, NAT blocks, QoS policies,
    antispoof bindings (sets; slots differ with the insert order)."""
    out = []
    for i in range(cl.n):
        def keys(t):
            return {tuple(r) for r in t.keys[t.used != 0].tolist()}
        out.append((keys(cl.fastpath[i].sub), set(cl.nat[i].blocks),
                    {int(r[0]) for r in cl.qos[i].up.rows if r[1] & 1},
                    keys(cl.spoof[i].bindings)))
    return out


def sharded_checkpoint_phases(cl, flows, groups, ring, rng, per, card, device, err):
    """The sharded deployment's checkpoint: a same-N snapshot restored
    slot-exact into `clone_empty()`, the next step on both; the sharded
    blue/green swap; then an 8 -> 4 re-shard of a reduced deployment."""
    t = {}
    t0 = time.perf_counter()
    cl.quiesce()
    cl.fold_device_authoritative()
    t["fold"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck = ckpt_mod.build_sharded_checkpoint(cl, 1, float(NOW + 200), quiesce=False,
                                           node_id="chip-smoke")
    t["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = ckpt_mod.encode_checkpoint(ck)
    t["encode"] = time.perf_counter() - t0
    del ck
    t0 = time.perf_counter()
    ck2 = ckpt_mod.decode_checkpoint(data)
    t["decode"] = time.perf_counter() - t0
    twin = cl.clone_empty()
    t0 = time.perf_counter()
    rows = ckpt_mod.restore_sharded_checkpoint(ck2, twin, now=NOW + 200)
    torch.cuda.synchronize()
    t["restore"] = time.perf_counter() - t0
    del ck2
    for i in range(N_SHARDS):
        tables_equal(cl.tables[i], twin.tables[i], f"shard {i} restored slot-exact")

    fr, _ = sharded_frames(rng, flows, groups)
    pkt, length, flags = assemble_full(cl, ring, fr)
    ring.complete(np.zeros((B,), np.uint8), pkt, length, B)
    drain_ring(ring)
    fa = (flags & ring_mod.FLAG_FROM_ACCESS) != 0
    kernels.reset_launches()
    box = {}
    rec = record_kernel_inputs(lambda: box.update(out=twin.step(pkt, length, fa, NOW + 201, 1000)),
                               per["probe"], per["seg_prefix"], "restored sharded step",
                               sharded_names(twin))
    launches = dict(kernels.LAUNCHES)
    check_launches(launches, 1, per, "restored sharded step")
    ref = cl.step(pkt, length, fa, NOW + 201, 1000)
    for k, v in ref.items():
        check(np.array_equal(v, box["out"][k]), f"restored cluster's step {k} == the original's")
    for i in range(N_SHARDS):
        tables_equal(cl.tables[i], twin.tables[i], f"shard {i} after the next step")
    probes_vs_plain([("restored sharded", a) for a in rec["probe"]], err)
    segs_vs_plain([("restored sharded", *c) for c in rec["seg_prefix"]], err)
    say(f"sharded checkpoint N={N_SHARDS} same-N: {len(data)} bytes ({len(data) / 2**20:.1f} MiB); "
        f"fold {t['fold']:.3f} s, build {t['build']:.3f} s, encode {t['encode']:.3f} s, decode "
        f"(CRC verify) {t['decode']:.3f} s, restore into clone_empty() (hydrate + upload) "
        f"{t['restore']:.3f} s; every word of the {N_SHARDS} shards' tables equal, the next step's "
        f"outputs and tables equal, K1/K2 bit-equal on its {len(rec['probe'])} + "
        f"{len(rec['seg_prefix'])} calls; {len(rows)} row counts [{card}]")
    del rec, twin, data, box
    gc.collect()
    torch.cuda.empty_cache()

    comps = {"cluster": cl}
    rep = ops_mod.sharded_blue_green_swap(comps, clock=lambda: float(NOW + 210))
    check(rep["outcome"] == "ok" and rep["audit_ok"], f"the sharded swap flipped ({rep})")
    standby = comps["cluster"]
    out_s = standby.step(pkt, length, fa, NOW + 211, 2000)
    out_c = cl.step(pkt, length, fa, NOW + 211, 2000)
    for k, v in out_c.items():
        check(np.array_equal(v, out_s[k]), f"the standby cluster's step {k} == the retired one's")
    say(f"sharded blue/green swap N={N_SHARDS}: outcome {rep['outcome']}, frames_deferred "
        f"{rep['frames_deferred']}, quiesce_s {rep['quiesce_s']:.3f}, hydrate_s "
        f"{rep['hydrate_s']:.3f}, audit {rep['audit_s']:.3f} s ({rep['violations']}), flip_s "
        f"{rep['flip_s']:.6f}, duration_s {rep['duration_s']:.3f}; the standby's next step == "
        f"the retired cluster's [{card}]")
    del standby, comps
    gc.collect()
    torch.cuda.empty_cache()

    # the 8 -> 4 re-shard of a reduced deployment: the walk inserts row by row
    src = build_reshard_cluster(N_SHARDS, device)
    ck = ckpt_mod.decode_checkpoint(ckpt_mod.encode_checkpoint(
        ckpt_mod.build_sharded_checkpoint(src, 1, float(NOW))))
    dst = src.clone_empty(4)
    t0 = time.perf_counter()
    got = ckpt_mod.restore_sharded_checkpoint(ck, dst, now=NOW)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    n_rows = sum(v for k, v in got.items() if not k.startswith("resharded"))
    direct = build_reshard_cluster(4, device, flows=False)
    check(placement(dst) == placement(direct),
          "re-shard 8 -> 4: every row on the shard a 4-shard cluster built from the rows holds it")
    say(f"re-shard {N_SHARDS} -> 4 of {RESHARD_SUBS} subscribers, {RESHARD_NAT_SUBS} NAT blocks "
        f"({RESHARD_FLOWS} flows re-establish by punt), {RESHARD_NAT_SUBS // 4} QoS policies and "
        f"bindings: {walk_s:.3f} s for {n_rows} rows ({walk_s / n_rows * 1e6:.1f} us per row, "
        f"upload included; {got}) [{card}]")
    del src, dst, direct, ck
    return {"sharded_restore": launches}


# ------------------------------------------------- the operator's entry points

LT_ARGS = ["--duration", "10", "--warmup", "2", "--batch-size", "256", "--macs", "10000",
           "--renewal-ratio", "0.8", "--pool-cidr", "10.0.0.0/16", "--json"]
RUN_SUBS = 8192  # synthetic subscribers of the `run` phase
# of them given a lease (REQUEST after the OFFER): half the ~4,060
# subscriber NAT blocks the `run` default NAT table holds, since every
# ACK allocates one
RUN_LEASED = 2048
RUN_CMP_BEATS = 24  # beats driven on the card and on the CPU, TX compared
RUN_FLOWS = 1024  # flows from leased addresses through the bulk lane
WORKING_FLAGS = ["--no-metrics-enabled"]  # the reference's defaults, but metrics


def gate_phase(card) -> None:
    """The port's kernel gate, every check on the card."""
    from bng_tpu_torch.runtime.verify import verify_cuda_kernels

    t0 = time.perf_counter()
    res = verify_cuda_kernels(verbose=False, cuda=True)
    bad = [(n, e) for n, e in res if e]
    check(not bad, f"kernel gate: {bad}")
    say(f"kernel gate: {len(res)} checks passed in {time.perf_counter() - t0:.1f}s "
        f"({', '.join(n for n, _ in res)}) [{card}]")


@contextlib.contextmanager
def first_probe_calls(n: int):
    """Keep the inputs of the first n K1 calls made through `ops/table.probe`."""
    rec, orig = [], table_mod.probe

    def probe_rec(*args):
        if len(rec) < n:
            rec.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return orig(*args)

    table_mod.probe = probe_rec
    try:
        yield rec
    finally:
        table_mod.probe = orig


def loadtest_phases(card, err) -> dict:
    """`loadtest` in-process through the port's `cli.main`, engine and
    scheduler; returns {path: launches}."""
    from bng_tpu_torch import cli
    from bng_tpu_torch.telemetry import ledger

    out = {}
    name = torch.cuda.get_device_name(0)
    for path, extra in (("loadtest", []), ("loadtest_scheduler", ["--scheduler"])):
        with tempfile.TemporaryDirectory() as tmp:
            log = f"{tmp}/bench.jsonl"
            buf = io.StringIO()
            kernels.reset_launches()
            with first_probe_calls(6) as rec, contextlib.redirect_stdout(buf):
                rc = cli.main(["loadtest", *LT_ARGS, "--bench-log", log, *extra])
            launches = dict(kernels.LAUNCHES)
            line = ledger.read(log)[-1]
        check(rc == 0, f"{path}: exit code {rc}")
        res = json.loads(buf.getvalue())
        served = res["served"]
        check(res["errors"] == 0 and res["responses"] == res["requests"] > 0,
              f"{path}: no errors, a response to every request ({res['errors']}, "
              f"{res['responses']}/{res['requests']})")
        check(res["fastpath_hits"] > 0, f"{path}: fast-path hits after warmup")
        # the scheduler's express graph is captured before the run starts:
        # its two warm-up runs (3 K1 each) fall in our count, not the run's
        warm = 6 if extra else 0
        check(served["launches"]["probe"] == 3 * served["dispatches"] > 0
              and launches["probe"] == served["launches"]["probe"] + warm
              and launches["seg_prefix"] == served["launches"]["seg_prefix"] == 0,
              f"{path}: 3 K1 and 0 K2 per device dispatch ({launches}, {served})")
        check(ledger.backend_class(line) == "gpu" and line["env"]["device_kind"] == name
              and line["env"]["table_impl"] == "cuda",
              f"{path}: the ledger line is class gpu on {name} ({line['env']})")
        if rec:  # the engine run's DHCP-only program calls K1 through the wrapper
            probes_vs_plain([(path, a) for a in rec], err)
        say(f"{path}{' (K1 bit-equal on its first ' + str(len(rec)) + ' calls)' if rec else ''}: "
            f"{res['rps']:.1f} req/s, batch p50 {res['latency_p50_us']:.1f} / p99 "
            f"{res['latency_p99_us']:.1f} us, per request p50 {res['request_p50_us']} / p99 "
            f"{res['request_p99_us']} us, cache hit {res['cache_hit_rate']:.4f}, fast-path p99 "
            f"{res['fastpath_p99_us']:.1f} us, {res['requests']} requests in {res['batches']} "
            f"batches, {served['dispatches']} device dispatches, launches {launches}, "
            f"program {res['program']} [{card}]")
        out[path] = launches
    return out


class BeatClock:
    """The app's clock: held, stepped by the phase that drives it."""

    def __init__(self, t: float):
        self.t = t

    def __call__(self) -> float:
        return self.t


def pop_tx(ring) -> list:
    out = []
    while (got := ring.tx_pop()) is not None:
        out.append(bytes(got[0]) if isinstance(got, tuple) else bytes(got))
    return out


def drive_app(app, clock, beats: int, step_s: float = 0.001) -> list:
    """`beats` beats of the app, the clock stepped each beat and `tick()`
    each simulated second; returns the TX frames."""
    ring, out = app.components["ring"], []
    for _ in range(beats):
        before = int(clock.t)
        clock.t += step_s
        app.drive_once()
        if int(clock.t) != before:
            app.tick(clock.t)
        out += pop_tx(ring)
    return out


def settle(app) -> list:
    """Retire everything in flight and put its frames on the TX ring."""
    sched, ring = app.components["scheduler"], app.components["ring"]
    sched.flush()
    for c in sched.drain_completions():
        if c.frame is not None and c.verdict in ("tx", "fwd", "slow"):
            ring.tx_inject(c.frame, from_access=c.from_access)
    return pop_tx(ring)


def dhcp_replies(frames) -> list:
    """(msg type, client MAC, yiaddr) of each DHCP reply."""
    out = []
    for f in frames:
        d = F.decode(f)
        if d.dst_port == 68:
            m = F.decode_dhcp(d.payload)
            out.append((m.msg_type, bytes(m.chaddr[:6]), m.yiaddr))
    return out


def synthetic_mac(i: int) -> bytes:
    return (0x02B70000 << 16 | i).to_bytes(6, "big")


def run_app(device, clock):
    from bng_tpu_torch.cli import BNGApp, BNGConfig

    # 70 public addresses: a 1,024-port block for each leased subscriber
    # (63 a public address)
    cfg = BNGConfig(scheduler_enabled=True, synthetic_subs=RUN_SUBS, dhcpv6_enabled=False,
                    slaac_enabled=False, metrics_enabled=False, coa_enabled=False,
                    nat_public_ips=[f"203.0.113.{k}" for k in range(1, 71)])
    return BNGApp(cfg, clock=clock, device=device)


def run_phases(card, device, err) -> dict:
    """`run` serving on the card (the scheduler over the engine, the
    synthetic source, the slow path); returns {"run": launches}."""
    outs = []
    for dev in (device, "cpu"):
        clk = BeatClock(float(NOW))
        app = run_app(dev, clk)
        try:
            outs.append(drive_app(app, clk, RUN_CMP_BEATS) + settle(app))
        finally:
            app.close()
    check(outs[0] == outs[1] and len(outs[0]) == 16 * RUN_CMP_BEATS,
          f"run: the card's first {RUN_CMP_BEATS} beats' TX bytes == the CPU app's "
          f"({len(outs[0])} vs {len(outs[1])} frames)")
    say(f"run: the first {RUN_CMP_BEATS} beats on the card gave the CPU app's TX bytes "
        f"({len(outs[0])} OFFERs)")

    clk = BeatClock(float(NOW))
    app = run_app(device, clk)
    try:
        c = app.components
        sched, ring, dhcp = c["scheduler"], c["ring"], c["dhcp"]
        eng = c["engine"]
        check(eng.fastpath.sub.nbuckets == 1 << 15, "the run default geometry: 2^15 buckets")
        # pass 1: every synthetic MAC gets a slow-path OFFER
        t0, offers, beats = time.perf_counter(), {}, 0
        while len(offers) < RUN_SUBS:
            for t, m, ip in dhcp_replies(drive_app(app, clk, 16)):
                if t == F.OFFER:
                    offers[m] = ip
            beats += 16
            check(beats < 4 * RUN_SUBS // 16, f"every synthetic MAC offered ({len(offers)})")
        offers.update((m, ip) for t, m, ip in dhcp_replies(settle(app)) if t == F.OFFER)
        t1 = time.perf_counter()
        say(f"run pass 1: {RUN_SUBS} synthetic MACs offered by the slow path in {beats} beats, "
            f"{beats / (t1 - t0):.1f} beats/s, {16 * beats / (t1 - t0):.1f} frames/s [{card}]")
        # REQUESTs for the first RUN_LEASED offered addresses
        acks = {}
        for base in range(0, RUN_LEASED, 256):
            for i in range(base, base + 256):
                m = synthetic_mac(i)
                ok = ring.rx_push(storm_request(m, 0x5000 + i, offers[m]), from_access=True)
                check(ok, "the ring takes the REQUESTs")
            for t, m, ip in dhcp_replies(drive_app(app, clk, 8) + settle(app)):
                if t == F.ACK:
                    acks[m] = ip
        check(len(acks) == RUN_LEASED and all(acks[m] == offers[m] for m in acks)
              and len(dhcp.leases) == RUN_LEASED,
              f"{RUN_LEASED} ACKs with the offered addresses ({len(acks)}, {len(dhcp.leases)})")
        while eng.fastpath.dirty_count():  # the express drain ships the lease rows
            drive_app(app, clk, 1)
        settle(app)

        # a blue/green swap under the ring: two beats' DISCOVERs wait in the
        # express lane and two more in the RX ring; the standby serves pass 2
        drive_app(app, clk, 2)
        app._push_synthetic(ring)
        rep = app.engine_swap()
        check(rep["outcome"] == "ok" and rep["audit_ok"], f"run: engine_swap ({rep})")
        check(c["engine"] is not eng and sched.engine is c["engine"], "the standby is in service")
        eng = c["engine"]
        drive_app(app, clk, 1)  # the frames left in the RX ring, served by the standby
        settle(app)
        say(f"run: engine_swap ok, audit ok, {rep['frames_deferred']} frames deferred, "
            f"{rep['duration_s']:.3f}s (quiesce {rep['quiesce_s']:.3f}, hydrate "
            f"{rep['hydrate_s']:.3f}, audit {rep['audit_s']:.3f}, flip {rep['flip_s']:.3f}), "
            f"{rep['delta_rows']} delta rows in {rep['delta_steps']} steps [{card}]")

        # pass 2, counted: one more cycle of the source and flows through the bulk lane
        flows = [F.udp_packet(m, AC_MAC, ip, ip_to_u32("93.184.216.34"), 30000 + k, 53, b"q" * 64)
                 for k, (m, ip) in enumerate(sorted(acks.items()))]
        obs0 = {k: dict(v) for k, v in sched.observed.items()}
        tx0, disc0 = eng.stats.tx, dhcp.stats.discover
        kernels.reset_launches()
        t0 = time.perf_counter()
        for k in range(0, RUN_FLOWS, 64):
            for f in flows[k: k + 64]:
                ring.rx_push(f, from_access=True)
            drive_app(app, clk, 2)
        tx = drive_app(app, clk, RUN_SUBS // 16 - 2 * (RUN_FLOWS // 64)) + settle(app)
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        n_ex = sched.observed["express"]["dispatches"] - obs0["express"]["dispatches"]
        n_bulk = sched.observed["bulk"]["dispatches"] - obs0["bulk"]["dispatches"]
        device_answered, slow = eng.stats.tx - tx0, dhcp.stats.discover - disc0
        check(device_answered == RUN_LEASED and slow == RUN_SUBS - RUN_LEASED,
              f"run pass 2: leased MACs answered on the standby's device, the rest by the slow "
              f"path ({device_answered}, {slow})")
        # the run default has the walled garden on: its gate adds one K1 to
        # the IPoE step's 8
        check(n_ex > 0 and n_bulk > 0 and launches["probe"] == 3 * n_ex + 9 * n_bulk
              and launches["seg_prefix"] == 4 * n_bulk,
              f"run: 3 K1 per express dispatch, 9 K1 + 4 K2 per bulk step "
              f"({launches}, {n_ex} express, {n_bulk} bulk)")
        beats = RUN_SUBS // 16
        say(f"run pass 2: {beats} beats in {dt:.3f}s ({beats / dt:.1f} beats/s, "
            f"{(RUN_SUBS + RUN_FLOWS) / dt:.1f} frames/s); DISCOVERs answered on the device "
            f"{device_answered}, by the slow path {slow}; {n_ex} express dispatches "
            f"({3 * n_ex} K1), {n_bulk} bulk steps ({9 * n_bulk} K1, {4 * n_bulk} K2); "
            f"launches {launches}; {len(tx)} TX frames [{card}]")
        # the app's first expire sweep (the tick at simulated second 1, inside
        # pass 2) reads the device's session words, which are zeros for rows
        # the drain has not shipped yet: those sessions go and their reverse
        # rows stay, as in the reference (ROADMAP Queue 3)
        nat = eng.nat
        say(f"run: after the first expire sweep: {nat.sessions.count} NAT sessions, "
            f"{int(np.count_nonzero(nat.reverse.used))} reverse rows of {RUN_FLOWS} flows")

        # both kernels on this path's calls: the express program, a bulk step
        dev = eng.device
        desc = express_desc([F.discover_frame(synthetic_mac(i), 0x6000 + i, pad=320)
                             for i in range(64)])
        desc_d = torch.from_numpy(desc.view(np.int32)).to(dev)
        rec = record_kernel_inputs(lambda: express_verdicts(eng.tables.dhcp, desc_d, eng.geom.dhcp,
                                                            torch.tensor(int(clk.t), device=dev)),
                                   3, 0, "run express program", table_names(eng.tables))
        probes_vs_plain([("run express", a) for a in rec["probe"]], err)
        pkt, length = eng._pack_frames(flows[:eng.B], eng.B)
        rec = record_kernel_inputs(lambda: eng.step(pkt, length, np.ones((eng.B,), dtype=bool),
                                                    clk.t), 9, 4, "run bulk step",
                                   table_names(eng.tables))
        probes_vs_plain([("run bulk", a) for a in rec["probe"]], err)
        segs_vs_plain([("run bulk", *a) for a in rec["seg_prefix"]], err)
        say("run: K1 and K2 bit-equal to their plain versions on the express program's 3 "
            "and the bulk step's 9 + 4 calls")
        return {"run": launches}
    finally:
        app.close()


# ---------------------------------------- the subscriber protocol servers behind `run`

# PPPoE sessions of phase 36: as many as 64 NAT public addresses give port
# blocks (63 each); the `run` default NAT subscriber table holds 4,060
N_PPPOE_RUN = 4032
PPPOE_NAT_IPS = [f"203.0.113.{k}" for k in range(1, 65)]
PPPOE_WAVE = 512  # sessions started together (one beat's ingest budget of PADIs)
PPPOE_PADT = 256  # sessions ended by PADT
PPPOE_CMP = 64  # sessions negotiated on the card and on the CPU, TX compared
V6_CLIENTS = 1024  # DHCPv6 SOLICIT/REQUEST exchanges (IA_NA and IA_PD)
RS_CLIENTS = 64  # router solicitations
RADIUS_SUBS = 16  # PPPoE sessions, and DHCP subscribers, authenticated by RADIUS
COA_REQS = 512  # CoA-Requests timed at phase 36's size
COA_DISC = 256  # Disconnect-Requests timed at phase 36's size
QOS_STEPS = 8  # bulk steps of one subscriber's flow before, and after, the CoA
QOS_FRAME = 500  # bytes of each of those frames
WAN_IP = ip_to_u32("93.184.216.34")
WAN_MAC = bytes.fromhex("024757000001")


def ppp_user(mac: bytes) -> tuple[str, bytes]:
    return f"sub-{mac.hex()}", b"pw-" + mac[-3:].hex().encode()


class PPPoEPeers:
    """The client side of PPPoE and PPP (discovery, LCP, CHAP, IPCP) for many
    subscribers at once, built from the port's PPPoE codec: `padi(mac)`
    starts a subscriber, `react(frame)` answers one frame from the access
    concentrator; a peer is open once its IPCP Conf-Req is acked."""

    def __init__(self, macs):
        self.peer = {m: SimpleNamespace(sid=0, ip=0, open=False, asked=False, padt=0)
                     for m in macs}

    def padi(self, mac: bytes) -> bytes:
        return F.pppoe_padi_frame(mac, host_uniq=mac[-2:])

    def data(self, mac: bytes, sport: int, payload: bytes) -> bytes:
        p = self.peer[mac]
        inner = F.udp_packet(mac, AC_MAC, p.ip, WAN_IP, sport, 53, payload)[14:]
        return F.pppoe_session_frame(AC_MAC, mac, p.sid, F.PROTO_IPV4, inner)

    def _ppp(self, mac, proto, cp) -> bytes:
        return F.pppoe_session_frame(AC_MAC, mac, self.peer[mac].sid, proto, cp.encode())

    def react(self, frame: bytes) -> list:
        if frame[12:14] not in (b"\x88\x63", b"\x88\x64") or frame[:6] not in self.peer:
            return []
        mac, p = frame[:6], self.peer[frame[:6]]
        pkt = pppoe_codec.PPPoEPacket.decode(frame[14:])
        if frame[12:14] == b"\x88\x63":
            if pkt.code == F.CODE_PADO:
                tags = pppoe_codec.parse_tags(pkt.payload)
                out = [F.Tag(F.TAG_SERVICE_NAME)] + [t for t in tags if t.type in (
                    pppoe_codec.TAG_AC_COOKIE, F.TAG_HOST_UNIQ)]
                return [F.eth_frame(AC_MAC, mac, F.ETH_PPPOE_DISCOVERY, pppoe_codec.PPPoEPacket(
                    F.CODE_PADR, 0, F.serialize_tags(out)).encode())]
            if pkt.code == F.CODE_PADS and pkt.session_id:
                p.sid = pkt.session_id
                return [self._ppp(mac, F.PROTO_LCP, F.CPPacket(F.CP_CONF_REQ, 1, [
                    F.CPOption(1, (1492).to_bytes(2, "big")),
                    F.CPOption(5, (0x5EED0000 | mac[-1]).to_bytes(4, "big"))]))]
            if pkt.code == F.CODE_PADT:
                p.padt += 1
            return []
        proto, body = pppoe_codec.parse_ppp(pkt.payload)
        if proto == pppoe_codec.PROTO_CHAP:
            if body[0] != 1:  # Success/Failure: IPCP follows
                return []
            ident, vlen = body[1], body[4]
            user, pw = ppp_user(mac)
            resp = hashlib.md5(bytes([ident]) + pw + body[5: 5 + vlen]).digest()
            out = bytes([16]) + resp + user.encode()
            return [F.pppoe_session_frame(AC_MAC, mac, p.sid, pppoe_codec.PROTO_CHAP,
                                          bytes([2, ident]) + (4 + len(out)).to_bytes(2, "big")
                                          + out)]
        if proto not in (F.PROTO_LCP, F.PROTO_IPCP):
            return []  # IPV6CP: left unanswered (SLAAC and DHCPv6 give v6 on IPoE)
        cp = pppoe_codec.CPPacket.decode(body)
        if proto == F.PROTO_LCP:
            if cp.code == F.CP_CONF_REQ:
                return [self._ppp(mac, proto, F.CPPacket(F.CP_CONF_ACK, cp.identifier,
                                                         cp.options))]
            if cp.code == F.CP_ECHO_REQ:
                return [self._ppp(mac, proto, F.CPPacket(F.CP_ECHO_REP, cp.identifier,
                                                         data=(0x5EED0000 | mac[-1]).to_bytes(
                                                             4, "big")))]
            return []
        out = []
        if cp.code == F.CP_CONF_REQ:
            out.append(self._ppp(mac, proto, F.CPPacket(F.CP_CONF_ACK, cp.identifier,
                                                        cp.options)))
            if not p.asked:  # our own request: 0.0.0.0, for the server to Nak
                p.asked = True
                out.append(self._ppp(mac, proto, F.CPPacket(F.CP_CONF_REQ, 1,
                                                            [F.CPOption(3, bytes(4))])))
        elif cp.code == F.CP_CONF_NAK:
            p.ip = int.from_bytes(next(o.data for o in cp.options if o.type == 3), "big")
            out.append(self._ppp(mac, proto, F.CPPacket(F.CP_CONF_REQ, 2, [
                F.CPOption(3, p.ip.to_bytes(4, "big"))])))
        elif cp.code == F.CP_CONF_ACK:
            p.open = True
        return out


def seed_pppoe(app, seed: int) -> None:
    """The PPPoE server's randomness (AC cookie secret, LCP magic, CHAP
    challenges) from a seed, so two apps answer with the same bytes."""
    srv, rng = app.components["pppoe"], np.random.default_rng(seed)
    srv.config.cookie_secret = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    srv._magic = lambda: 0xAC000001
    srv.chap._mkchallenge = lambda: rng.integers(0, 256, 16, dtype=np.uint8).tobytes()


def protocol_app(device, clock, **kw):
    """`BNGApp` with the `run` defaults but metrics, the scheduler on, and a
    Python ring big enough for a wave of negotiations."""
    from bng_tpu_torch.cli import BNGApp, BNGConfig

    app = BNGApp(BNGConfig(scheduler_enabled=True, metrics_enabled=False, **kw),
                 clock=clock, device=device)
    app.components["ring"] = PyRing(nframes=16384, frame_size=2048, depth=4096)
    return app


def serve_frames(app, clock, frames, fa: bool = True) -> list:
    """Push frames, drive beats until the ring's RX side is empty, retire
    what is in flight and drive one more beat (the demux's pending frames
    go out with a beat); returns every TX and FWD frame."""
    ring, out = app.components["ring"], []
    for k in range(0, max(len(frames), 1), 2048):
        for f in frames[k: k + 2048]:
            check(ring.rx_push(f, from_access=fa), "the ring takes the frames")
        out += drive_app(app, clock, 2 + len(frames[k: k + 2048]) // 512)
        out += settle(app) + drive_app(app, clock, 1)
    while (got := ring.fwd_pop()) is not None:
        out.append(bytes(got[0]))
    return out


def negotiate(app, clock, peers, macs) -> list:
    """Every peer from PADI to IPCP through the ring, PPPOE_WAVE at a time;
    returns the TX frames."""
    tx = []
    for k in range(0, len(macs), PPPOE_WAVE):
        pending, rounds = [peers.padi(m) for m in macs[k: k + PPPOE_WAVE]], 0
        while pending:
            out = serve_frames(app, clock, pending)
            tx += out
            pending = [r for f in out for r in peers.react(f)]
            rounds += 1
            check(rounds < 20, f"PPPoE negotiation settles ({rounds} rounds)")
    return tx


def drain_tables(app, clock) -> int:
    """Bulk steps of a frame nobody claims until every host table row but
    the fastpath's (which the express lane's dispatches ship) has reached
    the device; returns the steps."""
    eng, n = app.components["engine"], 0
    junk = WAN_MAC + AC_MAC + b"\x88\xb5" + bytes(46)
    while eng.pending_dirty() > eng.fastpath.dirty_count():
        serve_frames(app, clock, [junk], fa=False)
        n += 1
        check(n < 200, f"the table drains finish ({eng.pending_dirty()} rows left)")
    return n


def launches_of(sched, obs0, launches, what: str, k1_bulk: int) -> tuple:
    n_ex = sched.observed["express"]["dispatches"] - obs0["express"]["dispatches"]
    n_bulk = sched.observed["bulk"]["dispatches"] - obs0["bulk"]["dispatches"]
    check(n_bulk > 0 and launches["probe"] == 3 * n_ex + k1_bulk * n_bulk
          and launches["seg_prefix"] == 4 * n_bulk,
          f"{what}: 3 K1 per express dispatch, {k1_bulk} K1 + 4 K2 per bulk step "
          f"({launches}, {n_ex} express, {n_bulk} bulk)")
    return n_ex, n_bulk


def observed(sched) -> dict:
    return {k: dict(v) for k, v in sched.observed.items()}


def bulk_step_vs_plain(eng, frames, clk, n_probe: int, what: str, err) -> None:
    """K1 and K2 bit-equal to their plain versions on every call of one bulk
    step of `frames`."""
    pkt, length = eng._pack_frames(frames[:eng.B], eng.B)
    rec = record_kernel_inputs(lambda: eng.step(pkt, length, np.ones((eng.B,), dtype=bool),
                                                clk.t), n_probe, 4, what, table_names(eng.tables))
    probes_vs_plain([(what, a) for a in rec["probe"]], err)
    segs_vs_plain([(what, *a) for a in rec["seg_prefix"]], err)


def pppoe_first_beats(dev, cfg) -> dict:
    """The first PPPOE_CMP sessions negotiated, then one upstream round of
    their data punted to the host's NAT, the same round forwarded on the
    device, and one downstream round; the TX/FWD bytes of each part and the
    engine's PPPoE counters."""
    clk = BeatClock(float(NOW))
    app = protocol_app(dev, clk, **cfg)
    try:
        seed_pppoe(app, 36)
        macs = [session_mac(k) for k in range(PPPOE_CMP)]
        peers = PPPoEPeers(macs)
        run = {"negotiation": negotiate(app, clk, peers, macs)}
        drain_tables(app, clk)
        up = [peers.data(m, 40000, b"u" * 64) for m in macs]
        run["upstream punted"] = serve_frames(app, clk, up)
        drain_tables(app, clk)
        run["upstream"] = serve_frames(app, clk, up)
        snat = [F.decode(f) for f in run["upstream"] if f[12:14] == b"\x08\x00"]
        run["downstream"] = serve_frames(app, clk, [
            F.udp_packet(WAN_MAC, AC_MAC, WAN_IP, d.src_ip, 53, d.src_port, b"d" * 64)
            for d in snat], fa=False)
        enc = [f for f in run["downstream"] if f[12:14] == b"\x88\x64"]
        check(len(snat) == len(enc) == PPPOE_CMP,
              f"pppoe ({dev}): every session's data decapped and SNAT'd, and encapped on the "
              f"way back ({len(snat)} up, {len(enc)} down)")
        run["stats"] = app.components["engine"].stats.pppoe.copy()
        return run
    finally:
        app.close()


def pppoe_phases(card, device, err) -> dict:
    """Phase 36: PPPoE subscribers on the card; returns {"pppoe": launches}."""
    from bng_tpu_torch.chaos.invariants import audit_app

    cfg = dict(pppoe_enabled=True, nat_public_ips=PPPOE_NAT_IPS,
               pppoe_users=[dict(zip(("username", "password"),
                                     (u, p.decode()))) for u, p in
                            (ppp_user(session_mac(k)) for k in range(N_PPPOE_RUN))])
    # the first sessions on the card and on the CPU: the same TX bytes
    card_run, cpu_run = (pppoe_first_beats(dev, cfg) for dev in (device, "cpu"))
    for part in ("negotiation", "upstream punted", "upstream", "downstream"):
        check(card_run[part] == cpu_run[part],
              f"pppoe: the card's TX/FWD bytes of the {PPPOE_CMP} sessions' {part} == the CPU "
              f"app's ({len(card_run[part])} vs {len(cpu_run[part])} frames)")
    check(np.array_equal(card_run["stats"], cpu_run["stats"]),
          f"pppoe: the card's PPPoE counters == the CPU app's ({card_run['stats'].tolist()} vs "
          f"{cpu_run['stats'].tolist()})")
    say(f"pppoe: {PPPOE_CMP} sessions negotiated, then one round of data up (punted, then "
        f"forwarded) and down: TX/FWD bytes and PPPoE counters {card_run['stats'].tolist()} "
        f"equal the CPU app's [{card}]")

    clk = BeatClock(float(NOW))
    app = protocol_app(device, clk, **cfg)
    try:
        c = app.components
        seed_pppoe(app, 36)
        sched, eng, srv, nat, ring = c["scheduler"], c["engine"], c["pppoe"], c["nat"], c["ring"]
        check(eng.fastpath.sub.nbuckets == 1 << 15 and eng.pppoe.by_sid.nbuckets == 1 << 12,
              "the run default geometry: 2^15 subscriber and 2^12 PPPoE session buckets")
        macs = [session_mac(k) for k in range(N_PPPOE_RUN)]
        peers = PPPoEPeers(macs)
        t0 = time.perf_counter()
        negotiate(app, clk, peers, macs)
        t_open = time.perf_counter() - t0
        check(all(p.open for p in peers.peer.values()) and len(srv.sessions) == N_PPPOE_RUN
              and srv.stats.sessions_opened == N_PPPOE_RUN and srv.stats.auth_failure == 0,
              f"every PPPoE session OPEN ({len(srv.sessions)}, {srv.stats})")
        drains = drain_tables(app, clk)
        rep = audit_app(app)
        check(rep.ok and rep.checks.get("pppoe_sessions") == N_PPPOE_RUN
              and eng.pppoe.by_sid.count == eng.pppoe.by_ip.count == N_PPPOE_RUN,
              f"pppoe: both device session tables hold {N_PPPOE_RUN} rows, equal to their "
              f"host mirrors ({rep.violations_by_kind()}, {eng.pppoe.by_sid.count})")
        say(f"pppoe: {N_PPPOE_RUN} sessions PADI -> IPCP OPEN through the ring in {t_open:.3f}s "
            f"({N_PPPOE_RUN / t_open:.1f} sessions/s), {drains} drain steps, audit ok [{card}]")

        # upstream data from every session (the first punts its NAT session,
        # the second forwards), then downstream to each session's address
        up = [peers.data(m, 40000, b"u" * 64) for m in macs]
        obs0, dev0 = observed(sched), eng.stats.pppoe.copy()
        kernels.reset_launches()
        t0 = time.perf_counter()
        serve_frames(app, clk, up)
        drain_tables(app, clk)
        out = serve_frames(app, clk, up)
        snat = {}
        for f in out:
            if f[12:14] == b"\x08\x00":
                d = F.decode(f)
                snat[(d.src_ip, d.src_port)] = f
        by_pub = {}
        for ip_port, f in snat.items():
            check(F.decode(f).ip_checksum_ok and F.l4_checksum_ok(f),
                  "pppoe: upstream frames leave with valid checksums")
            by_pub[ip_port] = f
        check(len(snat) == N_PPPOE_RUN and all(
            ip in nat._next_block for ip, _ in snat),
            f"pppoe: every session's upstream frame decapped and SNAT'd ({len(snat)})")
        ip_sid = {p.ip: p.sid for p in peers.peer.values()}
        down = [F.udp_packet(WAN_MAC, AC_MAC, WAN_IP, ip, 53, port, b"d" * 64)
                for ip, port in snat]
        out = serve_frames(app, clk, down, fa=False)
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        enc = [f for f in out if f[12:14] == b"\x88\x64" and f[20:22] == b"\x00\x21"]
        ok = 0
        for f in enc:
            inner = F.decode(f[:12] + b"\x08\x00" + f[22:])
            ok += ip_sid.get(inner.dst_ip) == int.from_bytes(f[16:18], "big") \
                and inner.dst_port == 40000 and inner.ip_checksum_ok
        check(ok == N_PPPOE_RUN, f"pppoe: every downstream frame DNAT'd and encapped with its "
              f"session id ({ok} of {N_PPPOE_RUN})")
        n_ex, n_bulk = launches_of(sched, obs0, launches, "pppoe", 11)
        dev_st = eng.stats.pppoe - dev0
        say(f"pppoe data: {3 * N_PPPOE_RUN} frames through the bulk lane in {dt:.3f}s "
            f"({3 * N_PPPOE_RUN / dt:.1f} frames/s with the host), device decap "
            f"{int(dev_st[0])}, encap {int(dev_st[1])}, ctrl punts {int(dev_st[2])}, misses "
            f"{int(dev_st[4])}; {n_bulk} bulk steps ({11 * n_bulk} K1, {4 * n_bulk} K2), "
            f"{n_ex} express [{card}]")
        bulk_step_vs_plain(eng, up[:eng.B // 2] + down[:eng.B // 2], clk, 11, "pppoe bulk", err)

        # a PADT wave: the rows leave the device, the blocks go back
        gone = macs[:PPPOE_PADT]
        gone_ips = [peers.peer[m].ip for m in gone]
        serve_frames(app, clk, [F.eth_frame(AC_MAC, m, F.ETH_PPPOE_DISCOVERY,
                                            pppoe_codec.PPPoEPacket(
                                                F.CODE_PADT, peers.peer[m].sid).encode())
                                for m in gone])
        drain_tables(app, clk)
        rep = audit_app(app)
        left = N_PPPOE_RUN - PPPOE_PADT
        check(rep.ok and len(srv.sessions) == left and eng.pppoe.by_sid.count == left
              and not any(ip in nat.blocks for ip in gone_ips),
              f"pppoe: {PPPOE_PADT} PADTs took their rows off the device and released "
              f"their NAT blocks ({len(srv.sessions)}, {eng.pppoe.by_sid.count})")
        miss0 = eng.stats.pppoe.copy()
        out = serve_frames(app, clk, [peers.data(m, 40000, b"u" * 64) for m in gone])
        check(eng.stats.pppoe[4] - miss0[4] == PPPOE_PADT and sum(
            f[12:14] == b"\x88\x63" and f[15] == F.CODE_PADT for f in out) == PPPOE_PADT,
            f"pppoe: the ended sessions' data PASSes as an unknown session (device misses "
            f"{int(eng.stats.pppoe[4] - miss0[4])}), answered by PADT")
        st = app.stats()["pppoe"]
        say(f"pppoe: PADT wave of {PPPOE_PADT}: rows off both device tables, NAT blocks "
            f"released, their data PASSed and answered with PADT; stats {json.dumps(st)} [{card}]")
        return {"pppoe": launches}
    finally:
        app.close()


def v6_phases(card, device, err) -> dict:
    """Phase 37: DHCPv6 and SLAAC through the demux; returns {"v6": launches}."""
    clk = BeatClock(float(NOW))
    app = protocol_app(device, clk)
    try:
        c = app.components
        sched, v6 = c["scheduler"], c["dhcpv6"]
        macs = [client_mac(0x600000 + k) for k in range(V6_CLIENTS)]
        duid = {m: p6.generate_duid_ll(m).encode() for m in macs}

        def frame(m, msg):
            ll = bytes.fromhex("fe80000000000000") + m[:3] + b"\xff\xfe" + m[3:]
            return F.udp6_packet(m, bytes.fromhex("333300010002"), ll,
                                 bytes.fromhex("ff020000000000000000000000010002"), 546, 547,
                                 msg.encode())

        def msg(m, mtype, xid, server=None):
            d = p6.DHCPv6Message(mtype, xid)
            d.add(p6.OPT_CLIENTID, duid[m])
            if server is not None:
                d.add(p6.OPT_SERVERID, server)
            d.add_ia_na(p6.IANA(1))
            d.add_ia_pd(p6.IAPD(1))
            return d

        def replies(out, mtype):
            got = {}
            for f in out:
                if f[12:14] == b"\x86\xdd" and f[20] == 17 and f[56:58] == b"\x02\x22":
                    r = p6.DHCPv6Message.decode(f[62:])
                    if r.msg_type == mtype:
                        got[f[:6]] = r
            return got

        obs0 = observed(sched)
        kernels.reset_launches()
        t0 = time.perf_counter()
        adv = replies(serve_frames(app, clk, [frame(m, msg(m, p6.SOLICIT, k))
                                              for k, m in enumerate(macs)]), p6.ADVERTISE)
        check(len(adv) == V6_CLIENTS, f"v6: every SOLICIT ADVERTISEd ({len(adv)})")
        rep = replies(serve_frames(app, clk, [frame(m, msg(m, p6.REQUEST, 0x10000 + k,
                                                            adv[m].server_duid))
                                              for k, m in enumerate(macs)]), p6.REPLY)
        dt = time.perf_counter() - t0
        # `run` builds the DHCPv6 server with an address pool and no prefix
        # pool (as the reference does): IA_PD is answered NoPrefixAvail
        check(len(rep) == V6_CLIENTS and all(
            r.ia_nas()[0].addresses and r.ia_pds()[0].status[0] == p6.STATUS_NO_PREFIX_AVAIL
            for r in rep.values()) and len(v6.leases) == V6_CLIENTS,
            f"v6: every REQUEST got its REPLY with an address, and IA_PD its status "
            f"({len(rep)}, {len(v6.leases)} leases)")
        rs = []
        for k in range(RS_CLIENTS):
            m = client_mac(0x700000 + k)
            ll = bytes.fromhex("fe80000000000000") + m[:3] + b"\xff\xfe" + m[3:]
            icmp = bytes([133, 0, 0, 0, 0, 0, 0, 0])
            rs.append(bytes.fromhex("333300000002") + m + b"\x86\xdd" + bytes([0x60, 0, 0, 0])
                      + len(icmp).to_bytes(2, "big") + bytes([58, 255]) + ll
                      + bytes.fromhex("ff020000000000000000000000000002") + icmp)
        ra = [f for f in serve_frames(app, clk, rs) if f[12:14] == b"\x86\xdd" and f[20] == 58
              and f[54] == 134]
        launches = dict(kernels.LAUNCHES)
        check(len(ra) == RS_CLIENTS and len({f[:6] for f in ra}) == RS_CLIENTS,
              f"v6: every RS answered with a unicast RA ({len(ra)})")
        launches_of(sched, obs0, launches, "v6", 9)
        say(f"v6: {V6_CLIENTS} SOLICIT/REQUEST exchanges (IA_NA + IA_PD) in {dt:.3f}s "
            f"({V6_CLIENTS / dt:.1f} exchanges/s through the ring and the demux), "
            f"{RS_CLIENTS} RS -> RA; launches {launches} [{card}]")
        # past the valid lifetime: the sweep reaps the v6 leases, SLAAC's periodic RA goes out
        clk.t += 2 * app.config.lease_time + 61
        app.tick(clk.t)
        out = pop_tx(c["ring"])
        check(len(v6.leases) == 0 and not v6.addr_pool._allocated
              and any(f[:6] == bytes.fromhex("333300000001") and f[54] == 134 for f in out),
              f"v6: tick past the lease reaps every lease ({len(v6.leases)}) and sends the "
              f"periodic RA")
        say(f"v6: tick at +{2 * app.config.lease_time + 61}s reaped {V6_CLIENTS} leases, "
            f"periodic RA out; demux {c['slowpath'].stats} [{card}]")
        return {"v6": launches}
    finally:
        app.close()


class RadiusPeer:
    """An in-process RADIUS server on 127.0.0.1 (auth and accounting sockets)
    from the port's RADIUS codec: PAP and CHAP against `users`, every
    Accounting-Request kept and answered."""

    def __init__(self, secret: bytes, users: dict):
        import socket
        import threading

        self.secret, self.users, self.acct = secret, users, []
        self.socks = []
        for _ in range(2):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.bind(("127.0.0.1", 0))
            s.settimeout(0.2)
            self.socks.append(s)
        self.auth_port, self.acct_port = (s.getsockname()[1] for s in self.socks)
        self._run = True
        self._threads = [threading.Thread(target=self._loop, args=(s,), daemon=True)
                         for s in self.socks]
        for t in self._threads:
            t.start()

    def _answer(self, req):
        if req.code == rp.ACCOUNTING_REQUEST:
            self.acct.append(req)
            return rp.RadiusPacket(rp.ACCOUNTING_RESPONSE, req.id)
        entry = self.users.get(req.get_str(rp.USER_NAME) or "")
        chap = req.get(rp.CHAP_PASSWORD)
        if chap is not None:
            ok = entry is not None and chap[1:] == hashlib.md5(
                chap[:1] + entry["password"] + (req.get(rp.CHAP_CHALLENGE) or b"")).digest()
        else:  # an empty password travels as an empty attribute
            pw = req.get(rp.USER_PASSWORD)
            ok = entry is not None and (rp.decrypt_password(pw, self.secret, req.authenticator)
                                        if pw else b"") == entry["password"]
        resp = rp.RadiusPacket(rp.ACCESS_ACCEPT if ok else rp.ACCESS_REJECT, req.id)
        if ok:
            resp.add(rp.FILTER_ID, entry["policy"])
        return resp

    def _loop(self, s):
        while self._run:
            try:
                data, addr = s.recvfrom(4096)
            except OSError:
                continue
            req = rp.RadiusPacket.decode(data)
            s.sendto(self._answer(req).encode(self.secret, request_auth=req.authenticator),
                     addr)

    def close(self):
        self._run = False
        for t in self._threads:
            t.join(timeout=2)
        for s in self.socks:
            s.close()


def coa_send(app, pkt, secret: bytes) -> tuple:
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.settimeout(5.0)
        t0 = time.perf_counter()
        s.sendto(pkt.encode(secret), ("127.0.0.1", app.components["coa"].addr[1]))
        data = s.recvfrom(4096)[0]
        return rp.RadiusPacket.decode(data), (time.perf_counter() - t0) * 1e3
    finally:
        s.close()


def pcts(ms: list) -> str:
    p50, p99 = np.percentile(ms, [50, 99])
    return f"p50 {p50:.3f} / p99 {p99:.3f} / max {max(ms):.3f} ms"


def coa_at_scale(app, clk, peer, secret: bytes, card, n_subs: int = N_PPPOE_RUN) -> None:
    """Phase 38 at phase 36's size: PPPoE sessions authenticated through
    RADIUS until `n_subs` subscribers hold a NAT block, then COA_REQS
    CoA-Requests by Framed-IP and COA_DISC Disconnect-Requests (half by
    Framed-IP, half by Calling-Station-Id), each request timed alone."""
    from bng_tpu_torch.chaos.invariants import audit_app

    c = app.components
    eng, srv, dhcp, nat = c["engine"], c["pppoe"], c["dhcp"], c["nat"]
    macs = [session_mac(0x9000 + k) for k in range(n_subs - len(nat.blocks))]
    for m in macs:
        peer.users[ppp_user(m)[0]] = {"password": ppp_user(m)[1],
                                      "policy": "residential-100mbps"}
    peers = PPPoEPeers(macs)
    t0 = time.perf_counter()
    negotiate(app, clk, peers, macs)
    t_open = time.perf_counter() - t0
    drain_tables(app, clk)
    n_ppp, n_dhcp = len(srv.sessions), len(nat.blocks) - len(srv.sessions)
    check(all(p.open for p in peers.peer.values()) and len(nat.blocks) == n_subs,
          f"coa: {len(macs)} more PPPoE sessions OPEN through RadiusVerifier, {n_subs} "
          f"subscribers with a NAT block ({len(nat.blocks)})")

    rng = np.random.default_rng(38)
    ips = sorted(nat.blocks)
    policies = ("lite-25mbps", "residential-100mbps")
    last, coa_ms = {}, []
    for k, i in enumerate(rng.integers(0, len(ips), COA_REQS)):
        req = rp.RadiusPacket(rp.COA_REQUEST, k & 0xFF)
        req.add(rp.FRAMED_IP_ADDRESS, ips[i])
        req.add(rp.FILTER_ID, policies[k & 1])
        resp, ms = coa_send(app, req, secret)
        check(resp.code == rp.COA_ACK, f"coa: CoA-Request {k} ACKed ({resp.code})")
        last[ips[i]] = policies[k & 1]
        coa_ms.append(ms)
    rates = {ip: c["qos"].up.lookup(ip)["rate_bps"] for ip in last}
    check(all(rates[ip] == c["policies"].get(p).upload_bps for ip, p in last.items()),
          f"coa: each of {len(last)} subscribers' QoS rows hold its last CoA's rate")

    gone = [macs[i] for i in rng.choice(len(macs), COA_DISC, replace=False)]
    disc_ms, stops0 = [], len(peer.acct)
    for k, m in enumerate(gone):
        req = rp.RadiusPacket(rp.DISCONNECT_REQUEST, k & 0xFF)
        if k & 1:
            req.add(rp.CALLING_STATION_ID, "-".join(f"{b:02X}" for b in m))
        else:
            req.add(rp.FRAMED_IP_ADDRESS, peers.peer[m].ip)
        resp, ms = coa_send(app, req, secret)
        check(resp.code == rp.DISCONNECT_ACK, f"coa: Disconnect-Request {k} ACKed "
              f"({resp.code})")
        disc_ms.append(ms)
    out = serve_frames(app, clk, [])
    drain_tables(app, clk)
    rep = audit_app(app)
    padts = sum(f[12:14] == b"\x88\x63" and f[15] == F.CODE_PADT for f in out)
    stops = sum(r.get_int(rp.ACCT_STATUS_TYPE) == rp.ACCT_STOP for r in peer.acct[stops0:])
    check(rep.ok and padts == stops == COA_DISC and len(srv.sessions) == n_ppp - COA_DISC
          and eng.pppoe.by_sid.count == eng.pppoe.by_ip.count == n_ppp - COA_DISC,
          f"coa: {COA_DISC} Disconnects took their sessions off both device tables, each with "
          f"its PADT and Accounting Stop ({padts} PADTs, {stops} stops, "
          f"{eng.pppoe.by_sid.count} rows, {rep.violations_by_kind()})")
    say(f"coa at {n_subs} NAT blocks ({n_ppp} PPPoE sessions, {n_dhcp} DHCP subscribers'; "
        f"{len(macs)} sessions opened through RADIUS in {t_open:.3f}s, "
        f"{len(macs) / t_open:.1f}/s): {COA_REQS} CoA-Requests round trip {pcts(coa_ms)}; "
        f"{COA_DISC} Disconnect-Requests {pcts(disc_ms)}; coa stats {app.stats()['coa']} "
        f"[{card}]")


def radius_phases(card, device, err) -> dict:
    """Phase 38: RADIUS auth, accounting and CoA; returns {"radius": launches}."""
    secret = b"smoke-secret"
    ppp_macs = [session_mac(0x8000 + k) for k in range(RADIUS_SUBS)]
    dhcp_macs = [client_mac(0x800000 + k) for k in range(RADIUS_SUBS)]
    users = {ppp_user(m)[0]: {"password": ppp_user(m)[1], "policy": "residential-100mbps"}
             for m in ppp_macs}
    users[""] = {"password": b"", "policy": "residential-100mbps"}  # DHCP MAC authentication
    peer = RadiusPeer(secret, users)
    clk = BeatClock(float(NOW))
    app = None
    try:
        app = protocol_app(device, clk, pppoe_enabled=True, acct_interim_interval=60,
                           radius_server=f"127.0.0.1:{peer.auth_port}",
                           radius_secret=secret.decode(), coa_listen="127.0.0.1:0",
                           nat_public_ips=PPPOE_NAT_IPS)
        c = app.components
        # the flag names the auth port; accounting goes to the peer's second socket
        c["radius"].servers[0].acct_port = peer.acct_port
        c["radius"].clock = clk
        seed_pppoe(app, 38)
        sched, eng, ring, dhcp = c["scheduler"], c["engine"], c["ring"], c["dhcp"]
        obs0 = observed(sched)
        kernels.reset_launches()
        peers = PPPoEPeers(ppp_macs)
        negotiate(app, clk, peers, ppp_macs)
        check(all(p.open for p in peers.peer.values()),
              "radius: every PPPoE session authenticated through RadiusVerifier and OPEN")
        offers = {m: ip for t, m, ip in dhcp_replies(serve_frames(app, clk, [
            F.discover_frame(m, 0x9000 + k, pad=320) for k, m in enumerate(dhcp_macs)]))
            if t == F.OFFER}
        acks = {m: ip for t, m, ip in dhcp_replies(serve_frames(app, clk, [
            storm_request(m, 0x9100 + k, offers[m]) for k, m in enumerate(dhcp_macs)]))
            if t == F.ACK}
        check(len(acks) == RADIUS_SUBS and c["radius"].stats["auth_ok"] == 2 * RADIUS_SUBS,
              f"radius: {RADIUS_SUBS} PPPoE and {RADIUS_SUBS} DHCP subscribers accepted "
              f"({len(acks)} ACKs, {c['radius'].stats})")
        starts = [r for r in peer.acct if r.get_int(rp.ACCT_STATUS_TYPE) == rp.ACCT_START]
        check(len(starts) == 2 * RADIUS_SUBS, f"radius: an Accounting Start for each "
              f"({len(starts)})")

        # data through the bulk lane, then an interim with the device's octets
        data = [peers.data(m, 41000, b"a" * 200) for m in ppp_macs] + [
            F.udp_packet(m, AC_MAC, ip, WAN_IP, 41000, 53, b"a" * 200)
            for m, ip in acks.items()]
        for _ in range(3):
            serve_frames(app, clk, data)
            drain_tables(app, clk)
        clk.t += 61
        app.tick(clk.t)
        octets = eng.nat.subscriber_octets(eng.fetch_session_vals())
        interims = {r.get_int(rp.FRAMED_IP_ADDRESS): r for r in peer.acct
                    if r.get_int(rp.ACCT_STATUS_TYPE) == rp.ACCT_INTERIM}
        sub_ips = [p.ip for p in peers.peer.values()] + list(acks.values())
        # (upstream bytes are the subscriber's output octets)
        good = sum(interims.get(ip) is not None and octets.get(ip, (0, 0))[1] > 0
                   and interims[ip].get_int(rp.ACCT_OUTPUT_OCTETS) == octets[ip][1] & 0xFFFFFFFF
                   and (interims[ip].get_int(rp.ACCT_INPUT_OCTETS) or 0) == octets[ip][0]
                   for ip in sub_ips)
        check(good == 2 * RADIUS_SUBS, f"radius: every interim carries the octets the device's "
              f"NAT session words hold ({good} of {2 * RADIUS_SUBS})")
        launches = dict(kernels.LAUNCHES)
        launches_of(sched, obs0, launches, "radius", 11)

        # CoA: one DHCP subscriber to a lower rate; K2's decision drops its excess
        m0, ip0 = next(iter(acks.items()))
        burst = [F.udp_packet(m0, AC_MAC, ip0, WAN_IP, 41000, 53, b"b" * (QOS_FRAME - 42))
                 for _ in range(eng.B)]

        def burst_dropped():
            d0 = eng.stats.dropped
            for _ in range(QOS_STEPS):
                serve_frames(app, clk, burst)
            return eng.stats.dropped - d0

        before = burst_dropped()
        coa = rp.RadiusPacket(rp.COA_REQUEST, 1)
        coa.add(rp.FRAMED_IP_ADDRESS, ip0)
        coa.add(rp.FILTER_ID, "lite-25mbps")
        resp, coa_ms = coa_send(app, coa, secret)
        lite = c["policies"].get("lite-25mbps")
        row = c["qos"].up.lookup(ip0)
        after = burst_dropped()
        check(resp.code == rp.COA_ACK and row["rate_bps"] == lite.upload_bps
              and before == 0 and after > 0,
              f"radius: the CoA-Request moved {F.decode(burst[0]).src_ip:#x} to lite-25mbps "
              f"and its excess lanes drop ({resp.code}, dropped {before} then {after})")
        bulk_step_vs_plain(eng, burst, clk, 11, "radius bulk", err)

        # Disconnect: one PPPoE session and one DHCP lease leave the device tables
        p1, m1 = peers.peer[ppp_macs[0]], next(iter(list(acks)[1:]))
        d1 = rp.RadiusPacket(rp.DISCONNECT_REQUEST, 2)
        d1.add(rp.FRAMED_IP_ADDRESS, p1.ip)
        d2 = rp.RadiusPacket(rp.DISCONNECT_REQUEST, 3)
        d2.add(rp.CALLING_STATION_ID, "-".join(f"{b:02X}" for b in m1))
        r1, disc_ms = coa_send(app, d1, secret)
        r2, _ = coa_send(app, d2, secret)
        out = serve_frames(app, clk, [])
        drain_tables(app, clk)
        # the lease's DISCOVER: its express dispatch ships the row's deletion
        # first, so the device no longer answers it and the slow path OFFERs
        tx0 = eng.stats.tx
        again = dhcp_replies(serve_frames(app, clk, [F.discover_frame(m1, 0x9200, pad=320)]))
        from bng_tpu_torch.chaos.invariants import audit_app

        rep = audit_app(app)
        check(r1.code == r2.code == rp.DISCONNECT_ACK and rep.ok
              and eng.pppoe.by_sid.lookup([p1.sid]) is None and eng.pppoe.by_ip.lookup([p1.ip])
              is None and eng.fastpath.get_subscriber(m1) is None and eng.stats.tx == tx0
              and [t for t, _, _ in again] == [F.OFFER]
              and any(f[12:14] == b"\x88\x63" and f[15] == F.CODE_PADT for f in out),
              f"radius: Disconnect ended the PPPoE session (PADT out) and the DHCP lease; "
              f"both rows off the device ({r1.code}, {r2.code}, {eng.stats.tx - tx0} device "
              f"answers, {again}, {rep.violations_by_kind()})")
        stops = [r for r in peer.acct if r.get_int(rp.ACCT_STATUS_TYPE) == rp.ACCT_STOP]
        check(len(stops) == 2, f"radius: an Accounting Stop for each ({len(stops)})")
        say(f"radius: {2 * RADIUS_SUBS} subscribers authenticated, {len(starts)} starts, "
            f"{len(interims)} interims with the device's octets, one CoA round trip "
            f"{coa_ms:.3f} ms and one Disconnect {disc_ms:.3f} ms at {2 * RADIUS_SUBS} "
            f"subscribers, dropped {before} then {after} of {QOS_STEPS * eng.B} lanes [{card}]")
        coa_at_scale(app, clk, peer, secret, card)
        return {"radius": launches}
    finally:
        if app is not None:
            app.close()
        peer.close()

def module_entry_phase(card) -> None:
    """`python -m bng_tpu_torch run --once` in a subprocess."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "bng_tpu_torch", "run", "--once", *WORKING_FLAGS],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"python -m bng_tpu_torch run --once: rc {out.returncode}\n"
          f"{out.stderr[-2000:]}")
    st = json.loads(out.stdout)
    check(st["device"] == "cuda", f"run --once on the card ({st['device']})")
    say(f"python -m bng_tpu_torch run --once: rc 0 in {time.perf_counter() - t0:.1f}s, "
        f"device {st['device']} [{card}]")


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

    err = {"probe": 0.0, "seg_prefix": 0.0}  # max |kernel - plain| over every comparison
    launches = {"ipoe": ipoe_phases(eng, flows, drop_ips, card, device, args.profile, err)}
    # the full-stack engine drains the same host tables: retire this one first
    hosts = (eng.fastpath, eng.nat, eng.qos, eng.antispoof)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    kern, more = full_stack_phases(hosts, flows, drop_ips, card, device, args.profile, err)
    launches.update(more)
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(serving_stack_phases(hosts, flows, drop_ips, card, device, err))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(devloop_phases(hosts, flows, drop_ips, card, device, err))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(restart_phases(hosts, flows, drop_ips, card, device, err))
    launches.update(swap_phases(hosts, flows, drop_ips, card, device, err))
    del hosts
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(sharded_phases(card, device, err))
    gc.collect()
    torch.cuda.empty_cache()
    gate_phase(card)
    launches.update(loadtest_phases(card, err))
    launches.update(run_phases(card, device, err))
    module_entry_phase(card)
    launches.update(pppoe_phases(card, device, err))
    launches.update(v6_phases(card, device, err))
    launches.update(radius_phases(card, device, err))

    src = {"probe": ("cuda", "bng_tpu_torch/csrc/probe.cu", "bng_tpu/ops/pallas_table.py:261"),
           "seg_prefix": ("cuda", "bng_tpu_torch/csrc/seg_prefix.cu",
                          "bng_tpu/ops/pallas_qos.py:127")}
    line = {"kernels": [
        {"name": name, "route": src[name][0], "source": src[name][1], "replaces": src[name][2],
         "launches": launches["full"][name], "max_abs_err": err[name],
         "ms": float(np.mean(kern[name]["ms"])), "plain_ms": float(np.mean(kern[name]["plain"])),
         "bound_ms": float(np.mean(kern[name]["bound"])),
         "bound_by": "bytes", "library_ms": None,
         "launches_by_path": {p: v[name] for p, v in launches.items()}}
        for name in ("probe", "seg_prefix")]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
