#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA H100, or
the paths that need several cards on a host with N of them.

    python3 chip_smoke.py [--profile]      # exactly one visible card
    python3 chip_smoke.py --cards N        # exactly N >= 2 visible cards

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
   prefix, total and both. Bit-equal or fail. Before them the ring's
   movers (`ops/umem.py`): the gather and the scatter at B = 8,192 with
   L = 512 and L = 1,536 (the IPoE, wire and PPPoE rings' geometries),
   full and partial batches, headroom-offset descriptors, every output
   byte against their plain versions, one launch of each a call, then
   each timed against live bytes over the host link (the `umem` path).
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
   (split into pack / dispatch / wait / demux).
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
    `flush_pipeline`, the latter over the `PyRing` and the `NativeRing`
    (built by g++ into `bng_tpu_torch/_build/` and loaded, or the run
    fails); TX/FWD frames equal `process` on the same frames, and frames
    and stats are identical across the two rings; counts read.
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
    program's persistent ones; the render of bursts, for one template
    group and for many.
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

39. Telemetry on the IPoE headline engine (inside phase 6, where that
    deployment lives): 6 IPoE batches through `Engine.process` with a span
    tracer armed (a flight recorder behind it) and the same 6 with it
    disarmed, each run from one copy of the device tables: equal verdicts,
    bytes and stats, 8 K1 and 4 K2 per batch, one flight record per batch,
    K1/K2 bit-equal on their first calls. `device` is fed only from the
    CUDA-event step durations of phase 32. Printed: the dispatch, device,
    device_wait, reply and total p50/p99, the armed overhead per step, a
    hook pair's cost armed and disarmed, and `slo.evaluate` of the
    breakdown against the reference's default budgets (a reading).
40. The no-sync checks of phases 10, 15, 19 and 26 run again with a tracer
    armed: still no synchronising CUDA call; the serving and ring checks'
    batches leave their flight records.
41. `run` at the reference's defaults with telemetry, the SLO monitor, a
    checkpoint directory and metrics (phase 34's geometry: the scheduler,
    8,192 synthetic subscribers, 70 NAT addresses, 2^15 subscriber
    buckets), on the card and on the CPU under a held clock: 24 beats of
    the source with a few bulk flows give the same TX bytes, the same
    exposition (every counter and gauge, each histogram's `_count`; the
    checkpoint age reads the wall clock), stage counts, flight records and
    lane counts; counts 0: 3 K1 per express dispatch, 9 K1 + 4 K2 per bulk
    step, K1/K2 bit-equal on the first bulk step's calls. On the card app:
    `GET /metrics` over HTTP equals `expose()` (timed, and one
    `collect_once`), a forced trigger dumps the express and bulk records
    with backend `gpu`, 32 synthetic MACs are leased, a snapshot is taken
    on the loop thread (timed), and a fresh app on that directory restores
    at start (timed) and answers those 32 DISCOVERs on the device with no
    slow-path OFFER (3 K1 per express dispatch).
42. The operator's process: `python -m bng_tpu_torch run --synthetic-subs
    8192 --telemetry-enabled --checkpoint-dir <tmp> --metrics-port 0` on
    the card, scraped over HTTP until it shows served batches, then
    SIGTERM: rc 0 and one checkpoint; `run --once` on that directory
    restores from it on the card.
43. `python -m bng_tpu_torch trace export --scheduler` on the card: the
    Chrome JSON holds the express lane's spans (the DORA is control
    traffic only, so, as in the reference, no bulk thread); then `trace
    status`.
44. The slow-path fleet behind `run`: `BNGApp` at phase 34's geometry
    (the scheduler, 2^15 subscriber buckets, pool /16; NAT off) with a
    ring the phase feeds. On this call, a storm of 8,192 new clients
    (waves of 512 in flight; after an untimed 128-client warm-up) at 1
    worker (the parent's server), 4 inline and 4 spawned workers: DORAs/s
    each, every client ACKed with a unique address held in a worker's
    book, `worker_failures` 0, and the spawned workers add no CUDA context
    (the card's free memory moves no more than the inline run's, within
    256 MiB). The rates print on a line of their own. The timed 4-inline
    run's TX bytes, worker lease books and pool bitmap equal a
    `device="cpu"` app's under the same warm-up and storm, and K1 is held
    bit-equal to its plain version on that run's last express dispatch
    (its 3 calls, on the path's own buffers). The seconds a spawned
    worker's imports take (`run`'s module entry re-imported as
    __mp_main__, then the fleet: no torch) print beside a bare `import
    torch`.
45. The live process: `python -m bng_tpu_torch run --slowpath-workers 4
    --slowpath-worker-mode process --ctl-listen 127.0.0.1:0
    --checkpoint-dir <tmp>` on the card; `ctl fleet resize 6` and `ctl
    fleet rolling-restart` (outcome ok each) and `ctl status` over its
    wire; SIGTERM (rc 0, a snapshot with the fleet's books); then `chaos
    audit --slowpath-workers 6 --checkpoint-dir <tmp>` on the card: the
    app restored from that snapshot audits clean, rc 0.
46. The chaos sweep: the 23 scenarios and storms (storm scale 0.25; the
    four cluster-of-BNGs scenarios and `cluster_scale_storm` among them)
    and a 2-epoch soak in-process on the card, each timed, counts 0
    before and read after (the `chaos` path); `python -m bng_tpu_torch
    chaos run --seed 5 --storm-scale 0.25 --soak-epochs 2` on the card and
    with `--device cpu`, in turn: all three canonical reports equal, `ok:
    true`. Every K1 and K2 call of `production_day` (QoS-limited lanes
    that share a slot) and `sharded_swap_crash_rollback` (the 2-shard
    exchange probes), recorded as the sweep runs them, is held bit-equal
    to its plain version.
47. Sharded serving through `run`: `BNGApp` with `--shards 4 --batch-size
    4096 --shard-nbuckets 8192` (4 x 1,024 lanes, 2^15 subscriber buckets in
    all), the scheduler off, 8,192 synthetic subscribers, four NAT public
    addresses (one a shard), on a held clock, fed by the cluster-built
    steered ring. First a card app and a `device="cpu"` app on the same
    frames (2,048 DISCOVERs, 256 leases, their renewals and 64 flows twice):
    the same TX and FWD bytes, `stats()` and every shard's host rows and
    device tables. Then pass 1 (every synthetic MAC offered by the slow
    path), REQUESTs for 2,048 offers, an `engine_swap()` under the ring (a
    window in flight, frames in the RX ring; outcome ok) and `audit_app`
    clean after it; counts 0, the timed pass 2: 8,192 DISCOVERs (the leased
    MACs answered on the device, the rest by the slow path) and 1,024 new
    UDP flows from the NAT block holders, 512 DISCOVERs and 64 flows a beat:
    N x (6 + 3N) K1 and 4N K2 per fused window, 3N x N K1 per DHCP-only
    window, `missteers` 0; one more beat's 72 K1 and 16 K2 calls held
    bit-equal to their plain versions, some K2 calls with QoS-limited lanes
    sharing a slot. The same drive at `--shards 1` (the engine at B = 4096):
    beats/s and frames/s of both print on a line of their own.
48. The HA pair: an active and a standby `BNGApp` on the card (phase 44's
    geometry with the scheduler, NAT off), each with a loopback cluster
    listener, a checkpoint directory and the replicated store in write
    mode with the other as its peer; over TLS with a certificate `openssl`
    makes now and the standby pinning it, when `openssl` is on the host
    (plain HTTP otherwise, said). The active takes a DORA storm of 8,192
    new clients in waves of 512: 4,096 before the standby joins (its full
    sync timed), 3,584 with the standby following the SSE deltas (the lag
    from each `push_change` to the standby's apply, host clock, p50/p99),
    512 while the standby's stream is down; the reconnect heals by
    `replay_since` with no second full sync (timed). The standby's store
    equals the active's (`_audit_ha_pair` clean); one sync tick converges
    the store pair; each app's snapshot restores its `ha` store into a
    fresh app.
49. The Nexus allocator behind `run`: a loopback `ClusterServer` mounting
    `NexusBackend` (the port's `DistributedAllocator` on a
    `MemoryAllocationStore` for 10.77.0.0/16) is the Nexus; `BNGApp` at
    phase 44's geometry (the scheduler, NAT off) with `--nexus-url`, a
    10.77.0.0/16 pool and PSK device authentication from a key file (its
    signature verifies). Counts 0: a storm of 8,192 new clients in waves
    of 512, every yiaddr the Nexus's answer; each client's next DISCOVER
    answered on the device with it. The Nexus closed: the FSM reaches
    PARTITIONED within threshold x interval (3 x 5 s) of 1 s ticks; 1,024
    more clients lease from the local pool with no Nexus call (timed). A
    Nexus on the same port with 64 of those addresses claimed earlier by
    another node: the heal's tick reports 64 conflicts and 64 renumbered
    (timed), the losers' fast-path rows leave the card, their DISCOVERs
    punt to the slow path while the other 960 are answered on the device;
    3 K1 per express dispatch and 9 K1 + 4 K2 per bulk step, K1 bit-equal
    to its plain version on the last express dispatch. The same drive on a
    `device="cpu"` app gives the same ACKs, states, events, OFFERs and
    fast-path table words. Then degraded auth (a loopback RADIUS server,
    as in phase 38, accepts two subscribers; after their leases expire a
    REJECT is not served from the cache; the server stopped, the cached
    profile serves one, a new subscriber gets no lease), an mTLS app
    built from a certificate `openssl` makes now (when it is on the host),
    and `--slowpath-workers 4` in Nexus mode, inline and spawned, 8,192
    DORAs each. DORAs/s with and without the Nexus (phase 44's, on this
    call), the partition detection time, the partitioned local-pool
    DORAs/s and the heal's reconcile time print on a line of their own.
50. DNS and the walled garden behind `run`: `BNGApp` at `run`'s geometry
    (2^15 subscriber buckets, the garden and QoS on, the scheduler; NAT
    off as in phases 44 and 48) with `--dns-enabled` on a free loopback
    port forwarding to `FakeUpstream`, a loopback UDP upstream (no
    network). 8,192 clients leased; 4,096 put in the garden through
    `walledgarden.add_to_walled_garden`, the rest provisioned; the
    resolver's client set equals the gardened leases. Counts 0: each
    gardened subscriber's UDP frame to its DNS server on port 53 and TCP
    frame to the portal pass the device's gate (NAT off: they go on to the
    host, verdict PASS) and its UDP frame elsewhere drops on the device;
    every provisioned frame passes; 9 K1 + 4 K2 per bulk step, bit-equal
    to their plain versions on one bulk step. Gardened leases resolve to
    the portal through `Resolver.resolve`, provisioned ones to the
    upstream's answer; 10,000 queries over the listener's socket from 64
    loopback sources: queries/s, p50/p99 and the cache hit rate print on
    a line of their own, and `/metrics` carries `bng_dns_*`
    (`collect_dns`). 1,024 subscribers released from the garden: the
    device stops dropping their frames and the resolver forwards their
    queries.
51. The AF_XDP wire's four scenarios on the card (tests/test_wire_pump.py's
    serving stack: DHCP, NAT44, QoS and PPPoE behind one `Engine`, batch
    8): DORA (the leased client's next DISCOVER answered on the device), a
    new flow's punt then its SNAT, a shaped flow's QoS drops, PPPoE session
    data's punt then decap + SNAT, each frame injected at the far end of
    `SimKernelRings` (the memory rung's kernel), moved by `WirePump` into a
    `NativeRing`, served by `process_ring_pipelined` and pumped back out.
    Under the scalar and the vector pump, and on a CPU engine: the far-end
    bytes equal. Counts 0: 10 K1 (IPoE 8, PPPoE 2) and 4 K2 a fused step,
    3 K1 a DHCP-only batch; one step's calls bit-equal to their plain
    versions.
52. The wire at the headline's scale (inside phase 6's run of the IPoE
    engine, before it is retired): 6 batches of 8,192 (phase 4's mix)
    injected at the far end, pumped in, served by `process_ring_pipelined`
    and pumped out, under each pump, and the same frames pushed into a
    `NativeRing` with no wire, in one call: the egress equal (the pumps
    exactly, the no-wire run's TX and FWD as a multiset); counts 0: 8 K1
    and 4 K2 a step, the first step's calls bit-equal. Printed: frames/s
    end to end of each, and a traced run's split per batch: wire_rx,
    assemble, dispatch, wait, demux, wire_tx.
53. `loadtest --wire` (inside phase 33, beside plain `loadtest`): the
    memory rung's loop (`WireLoopTarget`: inject, pump, engine, pump,
    collect by xid) under each pump at the same defaults: 0 errors, every
    request answered through the wire, 3 K1 a DHCP-only dispatch. Printed:
    req/s and batch p50/p99.
54. `run --wire-if nosuchif0` on the card, as a process (the memory-rung
    warning, a `wire_rung_fallback` flight dump) and as an app (the native
    ring, `bng_wire_rung{mode="memory"} 1` on `/metrics`). Where the host
    allows AF_XDP, XDP programs and a veth pair, the four scenarios run
    live over the copy rung, every reply phase 51's bytes; otherwise one
    line names what the host refused.
55. The cluster of BNGs (host code, no kernel launch: counts 0, read 0):
    `python -m bng_tpu_torch cluster run --instances 4 --subscribers 8192
    --once --checkpoint-out F` with `--mode inline` and `--mode process`,
    every subscriber leased with a unique address, and `cluster status
    --from-checkpoint F` reads the carve back. In-process: the wave's
    DORAs/s in each mode, and a failover (a member killed, its standby
    promoted by ticks, its subscribers' renewals ACKed with their
    addresses) with its re-DORA time.
56. QinQ: 8,192 subscribers known only by their S/C-tag pair (registered
    in `QinQMapper`, reached through `add_vlan_subscriber`); a batch of
    8,192 802.1ad DISCOVERs through `Engine.process` (the fused step) and
    `process_dhcp` on the card: every OFFER from the VLAN probe with both
    tags kept, the card's bytes equal a CPU engine's, the VLAN probe's
    results equal the CPU's, one step's 8 K1 and 4 K2 bit-equal to their
    plain versions; counts 0 then read (8 K1 + 4 K2 a fused step, 3 K1 a
    DHCP-only batch). Printed: DISCOVERs/s through each.
57. The NAT ALGs: 1,024 NAT subscribers, FTP and SIP ALGs on, one batch of
    FTP PORT/EPRT/PASV commands and SIP INVITEs through `Engine.process`:
    every lane punted by the NAT44 ALG trigger (`NST_ALG`); the host
    rewrite (`ALGHandler`, data connections pre-installed through
    `NATManager.handle_new_flow`) equals the expected bytes and a CPU
    engine's; after the drain the FTP servers' first data packets are
    DNAT'd on the card; one step's 8 K1 and 4 K2 bit-equal; counts 0 then
    read. Printed: the step, the rewrite per payload, the data step.
58. The host verbs as subprocesses: `demo`, `perf gate` on a clean and a
    regressed ledger the phase writes (rc 0, then 1 naming the stage) and
    `check` (rc 0); no kernel launch. Printed: each verb's seconds.
59. The copying exchange on one card (inside phase 25, on its skewed
    batch): the batch through `sharded_step` with `CopyingExchange` over
    the cluster's map (every shard on this card) equals the same batch
    through `DeviceLocalExchange`, run before and after it (lanes, summed
    stats, punts); counts 0, then 240 K1 + 32 K2, every call bit-equal to
    its plain version.

With `--cards N` (N >= 2 visible cards) only these run, after the build
and a line per card (name, power limit) and `nvidia-smi topo -m`:
C1. K1 and K2 on every case of `kernel_cases.py` on each card, card 0
    current: bit-equal to their plain versions there; launches by card.
C2. Phase 24's sharded deployment spread over the cards (shard i on card
    i mod N, the copying exchange): a ring batch through `step` (every
    lane, every K1/K2 call bit-equal on its card, launches by card), the
    skewed batch, the DHCP-only step; two batches against the same tables
    on card 0 and on the CPU (every leaf and word equal); the spread and
    the one-card step's p50/p99 in turns; the pipelined loop; shard 0's
    and the last card's K1/K2 times; expire; a checkpoint over the cards
    restored onto card 0 (every word equal, the audit clean, the next
    step equal).
C3. `python -m bng_tpu_torch run --once --shards N --batch-size 4096
    --shard-nbuckets 8192` over the cards and with `--device cuda:0`
    (rc 0, the placement its log reports); phase 47's `run --shards 4`
    drive over the cards == on card 0 == on the CPU.
C4. The scheduler with the express lane on cuda:1 beside the shared lane
    (-1), over the headline's host tables in turn: the express graph and
    the DHCP tables on the express card, the bulk replica on cuda:0, a
    DORA storm of 1,024 new clients, OFFER p50/p99 for bursts of 64 idle
    and right after a bulk dispatch (the EXPRESS-CARDS line), the same
    reply bytes from both; the k = 8 ring program captured on cuda:1 and
    a devloop scheduler there giving the same bytes; the engine's own
    fused step (`Engine.process`, the drive that bypasses the scheduler)
    on cuda:0 with the DHCP tables home, and the next burst back on
    cuda:1.
C5. The kernel gate, `verify_cuda_kernels(cuda=True)`, with each card
    current in turn.

The line before the last is the card's name and power limit (the first
card's with `--cards N`); the one before it the kernels JSON (each
kernel's launches by path, the movers' beside K1 and K2, `umem`,
`sharded_copy`, `loadtest`,
`run`, `pppoe`, `v6`, `radius`, `ipoe_traced`, `run_observed`,
`run_restored`, `fleet`, `chaos`, `run_sharded`, `run_shards1`,
`ha_pair`, `run_nexus`, `fleet_nexus`, `run_dns`, `wire_headline`,
`loadtest_wire_scalar`, `loadtest_wire_vector`, `wire_scenarios`,
`run_wire_if`, `cluster`, `qinq`, `nat_alg` and `host_verbs` among them);
the last line the result JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
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
from bng_tpu_torch.ops import umem as umem_ops
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
from bng_tpu_torch.runtime import nativelib
from bng_tpu_torch.runtime import ring as ring_mod
from bng_tpu_torch.runtime.ring import PyRing
from bng_tpu_torch.runtime.scheduler import SchedulerConfig, TieredScheduler
from bng_tpu_torch.runtime.tables import FastPathTables, PPPoEFastPathTables
from bng_tpu_torch import entry as entry_mod
from bng_tpu_torch.parallel.exchange import CopyingExchange, DeviceLocalExchange
from bng_tpu_torch.parallel.sharded import ShardedCluster, sharded_step
from bng_tpu_torch.telemetry import FlightRecorder, RecorderConfig
from bng_tpu_torch.telemetry import slo as slo_mod
from bng_tpu_torch.telemetry import spans as tele
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
TELE_BATCHES = 6  # IPoE batches run with a tracer armed, and again disarmed
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
RENDER_ROUNDS = 50  # express bursts rendered
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


def reset_launches() -> None:
    """Zero the launch counts of K1 and K2 (`kernels.LAUNCHES`) and of the
    ring's movers (`ops/umem.LAUNCHES`) before a path's run."""
    kernels.reset_launches()
    for name in umem_ops.LAUNCHES:
        umem_ops.LAUNCHES[name] = 0


def launch_counts() -> dict:
    """Each kernel's launches since `reset_launches`: K1 (`probe`), K2
    (`seg_prefix`) and the ring's movers (`umem_gather`, `umem_scatter`)."""
    return {**kernels.LAUNCHES, **{f"umem_{k}": v for k, v in umem_ops.LAUNCHES.items()}}


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
    given `table_names`, the table each probe read); calls made while a
    CUDA graph is captured hold no values yet and are not kept."""
    rec = {"probe": [], "seg_prefix": [], "table": []}
    orig_probe, orig_seg = table_mod.probe, qos_mod.seg_prefix_total

    def probe_rec(*args):
        if torch.cuda.is_current_stream_capturing():  # a capture: no values to keep
            return orig_probe(*args)
        rec["table"].append((names or {}).get(args[0].data_ptr(), "?"))
        rec["probe"].append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return orig_probe(*args)

    def seg_rec(slot, vec, compute="both"):
        if torch.cuda.is_current_stream_capturing():
            return orig_seg(slot, vec, compute)
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
        # the ring loops dispatch through `_dispatch_ring_batch`, which on a
        # card replays a ring program and calls neither eager dispatch
        dispatch = (["_dispatch_ring_batch"] if ring is not None else
                    ["_dispatch_step", "_run_dhcp_batch"])
        self.sites = [(eng, "_pack_frames", "pack"),
                      *((eng, name, "dispatch") for name in dispatch),
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
    reset_launches()
    proc_ms, n_drop = [], 0
    split = HostSplit(eng)
    for k, (frames, expect) in enumerate(batches):
        with split:
            t1 = time.perf_counter()
            out = eng.process(frames, from_access=True, now=NOW + 2 + k * 0.01)
            proc_ms.append((time.perf_counter() - t1) * 1e3)
        n_drop += check_outputs(out, expect, drop_ips, fresh_ok=(k == 4))
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check_launches(launches, BATCHES, {"probe": 8, "seg_prefix": 4}, "IPoE path")
    check(n_drop > 0 and eng.stats.dropped == n_drop, "QoS drops on policed subscribers")
    check(len(fresh) > 0, "fresh flows present")
    say(f"IPoE path: {BATCHES} batches of {B}; tx {eng.stats.tx} fwd {eng.stats.fwd} "
        f"dropped {eng.stats.dropped} passed {eng.stats.passed}; launches {launches}")

    gpu_step_equals_cpu_step(eng, pkt, length, fa, "IPoE")

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
    return launches, ipoe_telemetry_phase(eng, flows, card, device, d.us, err)


@contextlib.contextmanager
def tracer_armed():
    """A span tracer with a flight recorder (dumps into a temporary
    directory), armed for the block."""
    with tempfile.TemporaryDirectory() as tmp:
        with tele.armed(tele.Tracer(recorder=FlightRecorder(RecorderConfig(out_dir=tmp)))) as tr:
            yield tr


@contextlib.contextmanager
def first_kernel_calls(n_probe: int, n_seg: int):
    """Keep the inputs of the first n_probe K1 calls (`ops/table.probe`) and
    the first n_seg K2 calls (`ops/qos.seg_prefix_total`) made in the block."""
    rec = {"probe": [], "seg_prefix": []}
    orig_probe, orig_seg = table_mod.probe, qos_mod.seg_prefix_total

    def probe_rec(*args):
        if len(rec["probe"]) < n_probe:
            rec["probe"].append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                      for a in args))
        return orig_probe(*args)

    def seg_rec(slot, vec, compute="both"):
        if len(rec["seg_prefix"]) < n_seg:
            rec["seg_prefix"].append((slot.clone(), vec.clone(), compute))
        return orig_seg(slot, vec, compute)

    table_mod.probe, qos_mod.seg_prefix_total = probe_rec, seg_rec
    try:
        yield rec
    finally:
        table_mod.probe, qos_mod.seg_prefix_total = orig_probe, orig_seg


def first_calls_vs_plain(rec, what: str, err) -> str:
    probes_vs_plain([(what, a) for a in rec["probe"]], err)
    segs_vs_plain([(what, *a) for a in rec["seg_prefix"]], err)
    return f"K1 and K2 bit-equal to their plain versions on their first {len(rec['probe'])} " \
           f"and {len(rec['seg_prefix'])} calls"


def engine_counts(eng) -> dict:
    st = eng.stats
    return {f: getattr(st, f).copy() for f in ("dhcp", "nat", "qos", "spoof")} | {
        f: getattr(st, f) for f in ("batches", "tx", "fwd", "dropped", "passed", "slow_errors")}


def pcts_us(bd: dict, stage: str) -> str:
    s = bd.get(stage)
    return f"{stage} p50 {s['p50_us']:.1f} / p99 {s['p99_us']:.1f} us (n {s['count']})" \
        if s else f"{stage} (no samples)"


def hook_pair_ns(n: int = 200_000) -> float:
    """Host cost of one `t()` + `lap()` pair, the hot-path hooks, in ns."""
    t0 = time.perf_counter_ns()
    for _ in range(n):
        tele.lap(tele.REPLY, tele.t())
    return (time.perf_counter_ns() - t0) / n


def ipoe_telemetry_phase(eng, flows, card, device, device_us, err) -> dict:
    """TELE_BATCHES IPoE batches through `Engine.process` with a tracer armed
    and the same batches with it disarmed, in turns (disarmed, armed,
    disarmed, armed), each run from the same device tables (a copy taken
    first, adopted before each run): equal verdicts, bytes and stats. The
    first run warms the adopted tables' path and is left out of the
    overhead. `device` is fed from the CUDA-event step durations
    (`profile_step_durations`), never host time. Returns the armed runs'
    launches."""
    rng = np.random.default_rng(1234)
    batches = [make_batch(rng, flows)[0] for _ in range(TELE_BATCHES)]
    snap = convert.tables_to_numpy(eng.tables)
    runs = []
    for armed in (False, True, False, True):
        eng.adopt_device_tables(convert.tables_from_numpy(snap, device))
        torch.cuda.synchronize()
        before = engine_counts(eng)
        outs, ms = [], []
        reset_launches()
        ctx = tracer_armed() if armed else contextlib.nullcontext()
        with ctx as tr, first_kernel_calls(8, 4) as rec:
            for k, frames in enumerate(batches):
                t1 = time.perf_counter()
                outs.append(eng.process(frames, from_access=True, now=NOW + 50 + k * 0.01))
                ms.append((time.perf_counter() - t1) * 1e3)
            if armed:
                tr.observe_many(tele.DEVICE, device_us)
                bd, records = tr.breakdown(), tr.recorder.records()
        launches = launch_counts()
        after = engine_counts(eng)
        delta = {k: (after[k] - before[k]) for k in after}
        runs.append((outs, {k: v.tolist() if isinstance(v, np.ndarray) else v
                            for k, v in delta.items()}, ms, launches))
    for k in (1, 2, 3):
        check(runs[k][0] == runs[0][0], f"IPoE telemetry: run {k}'s verdicts and bytes == the "
              "first disarmed run's")
        check(runs[k][1] == runs[0][1], f"IPoE telemetry: run {k}'s stats == the first "
              f"disarmed run's ({runs[k][1]} vs {runs[0][1]})")
        check_launches(runs[k][3], TELE_BATCHES, {"probe": 8, "seg_prefix": 4}, f"IPoE run {k}")
    check(len(records) == TELE_BATCHES and all(r["lane"] == "engine" for r in records)
          and all(bd[s]["count"] == TELE_BATCHES for s in ("dispatch", "device_wait", "reply",
                                                            "total")),
          f"IPoE telemetry: one flight record and one dispatch, device_wait and reply lap per "
          f"batch ({bd.keys()}, {len(records)} records)")
    check(bd["device"]["count"] == len(device_us), "device fed from the CUDA-event durations only")
    kern = first_calls_vs_plain(rec, "IPoE armed", err)
    on, off = runs[1][2] + runs[3][2], runs[2][2]
    overhead = float(np.mean(on) - np.mean(off))
    spread = abs(float(np.mean(runs[1][2]) - np.mean(runs[3][2])))
    pair_off = hook_pair_ns()
    with tracer_armed():
        pair_on = hook_pair_ns()
    verdict = slo_mod.evaluate(bd)
    say(f"IPoE telemetry: {TELE_BATCHES} batches armed == disarmed, in 4 runs (verdicts, "
        f"bytes, stats); {kern}; {pcts_us(bd, 'dispatch')}, {pcts_us(bd, 'device')} (CUDA "
        f"events), {pcts_us(bd, 'device_wait')}, {pcts_us(bd, 'reply')}, "
        f"{pcts_us(bd, 'total')} (the last armed run); Engine.process mean armed "
        f"{np.mean(on):.3f} ms, disarmed {np.mean(off):.3f} ms (first run {np.mean(runs[0][2]):.3f}, "
        f"left out), armed overhead {overhead:.3f} ms per step against a spread of "
        f"{spread:.3f} ms between the two armed runs (host clock); a t()/lap() hook pair "
        f"{pair_off:.1f} ns disarmed, {pair_on:.1f} ns armed [{card}]")
    say(f"IPoE telemetry: evaluate(breakdown) against the reference's default budgets: "
        f"ok={verdict['ok']} breaches={verdict['breaches']}; device p99 "
        f"{bd['device']['p99_us']:.1f} us against the reference's default 50 us budget, "
        f"{'within' if 'device' not in verdict['breaches'] else 'over'} it (a reading, not "
        f"a gate) [{card}]")
    return {k: runs[1][3][k] + runs[3][3][k] for k in runs[1][3]}


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
    reset_launches()
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
    launches_full = launch_counts()
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
    with tracer_armed():
        check_dispatch_makes_no_sync(eng, pkt, length, fa, dpkt, dlen)
    say("  (and again with a tracer armed)")

    # ---- the DHCP-only lane
    reset_launches()
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
    launches_dhcp = launch_counts()
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


RING_KINDS = ("PyRing", "NativeRing")


def make_ring_of(kind: str):
    """A ring holding 3 undrained batches (the native ring takes pow2 sizes)."""
    kw = dict(nframes=1 << 16, frame_size=L, depth=1 << 15)
    if kind == "NativeRing":
        lib = ring_mod.load_native()
        check(lib is not None and str(nativelib.lib_path("bngring")) == lib._name,
              "the port's bngring built by g++ into bng_tpu_torch/_build/ and loaded")
        return ring_mod.NativeRing(**kw)
    return ring_mod.PyRing(**kw)


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
    across the two rings."""
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

    reset_launches()
    ring = PyRing(nframes=6 * B, frame_size=L, depth=4 * B)  # holds 3 undrained batches
    ctrl = [F.discover_frame(sub_mac(i), 0x9000 + j)
            for j, i in enumerate(rng.integers(N_SUBS, size=B))]
    check(ring.rx_push_batch(ctrl) == B, "control batch pushed")
    check(eng.process_ring(ring, now=NOW + 10) == B, "process_ring took the control batch")
    check(ring.tx_pending() == B and ring.stats()["slow"] == 0, "every DISCOVER OFFERed")
    pops(ring)
    launches_ctrl = launch_counts()
    check_launches(launches_ctrl, 1, {"probe": 3, "seg_prefix": 0}, "ring control batch")

    reset_launches()
    for k, (bf, bfa, _) in enumerate(batches):
        for f, a in zip(bf, bfa):
            check(ring.rx_push(f, from_access=a), "ring push")
        check(eng.process_ring(ring, now=NOW + 10 + k) == B, "process_ring took the batch")
    got = pops(ring)
    check((got["tx"], got["fwd"]) == expected(want), "process_ring TX/FWD == process")
    launches_sync = launch_counts()
    check_launches(launches_sync, RING_BATCHES, {"probe": 13, "seg_prefix": 4}, "process_ring")

    reset_launches()
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
    launches_pipe = launch_counts()
    check_launches(launches_pipe, RING_BATCHES * len(RING_KINDS), {"probe": 13, "seg_prefix": 4},
                   "process_ring_pipelined")
    # the full stack's mirror sink reads the arriving frames from a staged
    # batch, so even the native ring takes the copying loop here
    check(eng.mirror_sink is not None and launches_sync["umem_gather"] == 0
          and launches_pipe["umem_gather"] == launches_pipe["umem_scatter"] == 0,
          f"ring loops with a mirror sink: no mover launched ({launches_sync}, {launches_pipe})")
    stats = runs["PyRing"][2]
    n = {v: sum(len(o[v]) for o in want) for v in ("tx", "fwd", "dropped", "slow")}
    check(stats["rx"] == RING_BATCHES * B and stats["tx"] == n["tx"] and stats["fwd"] == n["fwd"]
          and stats["drop"] == n["dropped"] and stats["slow"] == n["slow"],
          f"ring stats {stats} count process's verdicts {n}")
    for kind, (_, _, st, got) in runs.items():
        check(st == stats and got == runs["PyRing"][3],
              f"the {kind} ring's frames and stats == the PyRing's ({st})")
    say(f"ring loops: control batch on the DHCP-only program {launches_ctrl}; process_ring and "
        f"process_ring_pipelined on {RING_BATCHES} mixed batches each equal process, over "
        f"{', '.join(RING_KINDS)} alike (stats {stats}); launches {launches_sync} and "
        f"{launches_pipe}")
    return runs, {"ring_control": launches_ctrl, "ring_sync": launches_sync,
                  "ring_pipelined": launches_pipe}


# ------------------------------------------------------- the ring's movers

PCIE_BYTES_PER_S = 64e9  # H100 SXM host link, PCIe Gen5 x16, one direction (data sheet)


def umem_cases() -> dict:
    """name: (frame_size, slot L, lanes n of B, headroom offsets): the main
    path's geometries, the IPoE cells' ring (512-B frames, L = 512), the
    wire's (2,048-B chunks, frames at base + WIRE_HEADROOM) and the PPPoE
    cell's (2,048, L = 1,536), with partial batches and misaligned heads."""
    return {"ipoe": (512, L, B, (0,)),
            "ipoe_partial": (512, L, B - 1237, (0,)),
            "wire_headroom": (2048, L, B, (WIRE_HEADROOM,)),
            "pppoe": (2048, 1536, B, (0,)),
            "pppoe_partial_headroom": (2048, 1536, B - 1237, (0, 3, 17, WIRE_HEADROOM))}


def umem_case(rng, ring, umem, frame_size: int, L_: int, n: int, offs, card_dev):
    """One batch through the gather and the scatter on the card and through
    their plain versions on the CPU: (differing bytes of the gather's
    outputs, of the UMEM after the scatter, live bytes each way, the
    descriptor buffer and the card's inputs for timing)."""
    host = ring.umem_view()
    host[:] = rng.integers(0, 256, host.shape, dtype=np.uint8)
    nframes = host.shape[0] // frame_size
    off = rng.choice(np.array(offs, dtype=np.uint64), B)
    desc = umem_ops.DescStage(B, card_dev).acquire()
    desc.addrs[:] = rng.permutation(nframes)[:B].astype(np.uint64) * np.uint64(frame_size) + off
    # lengths up to the chunk's room: runts, full slots, frames longer than L
    desc.lens[:] = np.minimum(rng.integers(0, frame_size + 1, B), frame_size - off.astype(np.int64))
    desc.flags[:] = rng.integers(0, 4, B)
    outs, ins = {}, {}
    for dev in ("cpu", card_dev):
        t = dict(pkt=torch.full((B, L_), 0xEE, dtype=torch.uint8, device=dev),
                 length=torch.full((B,), 7, dtype=torch.int64, device=dev),
                 fa=torch.ones((B,), dtype=torch.bool, device=dev),
                 desc=torch.full((umem_ops.DESC_BYTES * B,), 9, dtype=torch.uint8, device=dev),
                 now_s=torch.zeros((), dtype=torch.int64, device=dev),
                 now_us=torch.zeros((), dtype=torch.int64, device=dev))
        umem_ops.gather(umem, desc, t["desc"], n, t["pkt"], t["length"], t["fa"], t["now_s"],
                        NOW + 1, t["now_us"], (NOW + 1) * 10**6 + 17)
        torch.cuda.synchronize()
        outs[str(dev)], ins[str(dev)] = [v.cpu() for v in t.values()], t
        desc.acquire()
    gather_off = sum(int((a != b).sum()) for a, b in zip(outs["cpu"], outs[str(card_dev)]))
    live_in = int(np.minimum(desc.lens[:n], L_).sum())
    verdict = torch.from_numpy(rng.integers(0, 4, B).astype(np.int32))
    out_pkt = torch.from_numpy(rng.integers(0, 256, (B, L_), dtype=np.uint8))
    out_len = torch.from_numpy(rng.integers(0, frame_size + 64, B).astype(np.int64))
    addrs = umem_ops.desc_addrs(outs["cpu"][3], B)
    want = torch.from_numpy(host.copy())
    umem_ops.scatter_plain(want, addrs, n, frame_size, verdict, out_pkt, out_len)
    dv = {k: v.to(card_dev) for k, v in
          dict(addrs=addrs, verdict=verdict, out_pkt=out_pkt, out_len=out_len).items()}
    umem_ops.scatter(umem, dv["addrs"], n, dv["verdict"], dv["out_pkt"], dv["out_len"])
    torch.cuda.synchronize()
    scatter_off = int((torch.from_numpy(host) != want).sum())
    a, v = addrs[:n], verdict[:n]
    room = frame_size - a % frame_size
    w = torch.clamp(torch.minimum(out_len[:n], room), max=L_)
    live_out = int(w[(v == engine_mod.VERDICT_TX) | (v == engine_mod.VERDICT_FWD)].sum())
    return gather_off, scatter_off, live_in, live_out, desc, ins[str(card_dev)], dv


def umem_phase(card, err) -> tuple[dict, dict]:
    """The ring's movers (`ops/umem.py`, `csrc/umem.cu`) at the main path's
    shapes, B = 8,192 with L = 512 and L = 1,536, full and partial batches,
    headroom-offset descriptors: every output byte equal to the plain
    versions', one launch of each a call; then each timed on the full
    batches against its bound, live bytes over the host link. Returns
    ({"umem": launches}, the movers' times)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    err["umem_gather"] = err["umem_scatter"] = 0
    times = {"umem_gather": {"ms": [], "bound": []}, "umem_scatter": {"ms": [], "bound": []}}
    rng = np.random.default_rng(22)
    cases = umem_cases()
    reset_launches()
    timed = []
    for name, (frame_size, L_, n, offs) in cases.items():
        ring = ring_mod.NativeRing(nframes=4 * B, frame_size=frame_size, depth=2 * B)
        umem = ring.map_umem(dev)
        g_off, s_off, live_in, live_out, desc, t, dv = umem_case(rng, ring, umem, frame_size, L_,
                                                                 n, offs, dev)
        err["umem_gather"] = max(err["umem_gather"], g_off)
        err["umem_scatter"] = max(err["umem_scatter"], s_off)
        check(g_off == 0 and s_off == 0,
              f"umem {name}: gather {g_off} and scatter {s_off} bytes off their plain versions")
        say(f"  umem {name} (frame {frame_size}, L {L_}, n {n} of {B}, offsets {offs}): gather "
            f"and scatter equal their plain versions byte for byte ({live_in} B in, "
            f"{live_out} B out)")
        if n == B:
            timed.append((name, ring, umem, desc, t, dv, live_in, live_out))
        else:
            ring.close()
    launches = launch_counts()
    check(launches["umem_gather"] == launches["umem_scatter"] == len(cases),
          f"umem: one gather and one scatter launch a call ({launches})")
    for name, ring, umem, desc, t, dv, live_in, live_out in timed:
        g = cuda_ms(lambda: umem_ops.gather_cuda(umem, desc, t["desc"], B, t["pkt"], t["length"],
                                                 t["fa"], t["now_s"], NOW, t["now_us"], NOW))
        sc = cuda_ms(lambda: umem_ops.scatter_cuda(umem, dv["addrs"], B, dv["verdict"],
                                                   dv["out_pkt"], dv["out_len"]))
        gb, sb = live_in / PCIE_BYTES_PER_S * 1e3, live_out / PCIE_BYTES_PER_S * 1e3
        for k, ms, bound in (("umem_gather", g, gb), ("umem_scatter", sc, sb)):
            times[k]["ms"].append(ms)
            times[k]["bound"].append(bound)
        say(f"  umem {name}: gather {g:.4f} ms (bound {gb:.4f}, {live_in / g / 1e6:.1f} GB/s), "
            f"scatter {sc:.4f} ms (bound {sb:.4f}, {live_out / sc / 1e6:.1f} GB/s) [{card}]")
        ring.close()
    say(f"ring movers: {len(cases)} cases bit-equal to their plain versions; launches "
        f"{launches}")
    return {"umem": launches}, times


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
                      (eng, "_handle_slow_lanes", "slow")]
        self.ms = {k: 0.0 for k in self.PARTS}

    def report(self, n_dispatch: int) -> str:
        ms = dict(self.ms)
        ms["upload"] -= ms["replay"]  # the program call holds the replay
        return ", ".join(f"{k} {v / n_dispatch:.4f}" for k, v in ms.items()) + " ms per dispatch"


class RenderSplit(HostSplit):
    """Host time of the express retire's template render."""

    PARTS = ("render",)

    def __init__(self):
        self.sites = [(TieredScheduler, "_express_reply", "render")]
        self.ms = {k: 0.0 for k in self.PARTS}


def express_render(sched, rng, card, rounds: int, one_group: bool) -> None:
    """Bursts of 64 cached DISCOVERs through the express lane, each reply
    rendered by a template patch per frame: every lane answered; the
    render's host ms per dispatch of 64. `one_group`: untagged subscribers
    of one pool (one template group); else subscribers of every pool, a
    quarter VLAN-tagged and an eighth relayed (many small groups)."""
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
            got = sched.process(frames)
            check(len(got["tx"]) == 64, f"burst {r}: every lane answered on the express lane")
    what = "one template group" if one_group else "every pool, tagged and relayed lanes mixed"
    say(f"express render per dispatch of 64 ({what}), over {rounds} bursts: "
        f"{split.ms['render'] / rounds:.4f} ms [{card}]")


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
    reset_launches()
    storm_s, n_bulk = dora_storm(sched, rng, flows, drop_ips)
    launches_storm = launch_counts()
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
    with tracer_armed() as tr:
        check_serving_dispatch_makes_no_sync(sched, rng, flows)
    check(tr.seq == 2 and not tr.records_dropped, f"the armed check's express and bulk batches "
          f"left one flight record each ({tr.seq})")
    say("  (and again with a tracer armed: an express and a bulk flight record)")

    # ---- express OFFER latency, the bulk lane idle: counts 0, express only
    reset_launches()
    split, beat = ExpressSplit(sched), BeatSplit()
    n0 = sched.express_aot_dispatches
    with split, beat:
        lat, _ = express_latency(sched, rng, LAT_ROUNDS, 64)
    n_lat = sched.express_aot_dispatches - n0
    launches_express = launch_counts()
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
    express_render(sched, rng, card, RENDER_ROUNDS, one_group=False)
    express_render(sched, rng, card, RENDER_ROUNDS, one_group=True)

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
    reset_launches()
    for r in range(rounds):
        for j, i in enumerate(rng.integers(N_SUBS, size=64 * k)):
            sched.submit(F.discover_frame(sub_mac(i), 0xE000 + j), True, tag=("count", int(i)))
        for c in run_until(sched, 64 * k):
            check(c.verdict == "tx", "cached DISCOVER answered by the ring")
    launches = launch_counts()
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
    with tracer_armed() as tr:
        check_ring_dispatch_makes_no_sync(sched, rng)
    k = sched._devloop.ring.k
    check(tr.seq == k and tr.breakdown()["loop_fill"]["count"] == k,
          f"the armed ring's {k} slots left one flight record each ({tr.seq})")
    say(f"  (and again with a tracer armed: {k} flight records, one per ring slot)")

    # ---- the DORA storm and the latencies through the devloop (counts 0)
    snap0 = sched.stats_snapshot()
    d0 = pump.dispatches
    reset_launches()
    split = DevloopSplit(sched)
    with split:
        storm_s, n_bulk = dora_storm(sched, rng, flows, drop_ips, clients=DL_STORM_CLIENTS,
                                     first=DL_CLIENT0 + DL_CLIENTS)
    launches_storm = launch_counts()
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


def now_on(n: int, dev, now_s: int, now_us: int):
    """`now` in seconds and microseconds on one device, as per-shard lists."""
    s, us = torch.tensor(now_s, device=dev), torch.tensor(now_us, device=dev)
    return [s] * n, [us] * n


def sharded_gpu_equals_cpu(cl, batches, device):
    """The sharded step on the card and on the CPU (plain versions, a copy of
    every shard's tables, the CPU exchange), batch after batch: every result
    leaf and every shard's table words identical."""
    cpu_tables = [convert.tables_from_numpy(convert.tables_to_numpy(t), "cpu") for t in cl.tables]
    cpu_ex = DeviceLocalExchange(["cpu"] * cl.n)
    for k, (pkt, length, fa) in enumerate(batches):
        now = [NOW + 40 + k, (NOW + 40 + k) * 10**6 & 0xFFFFFFFF]
        g = sharded_step(cl.tables, cl.exchange, *staged_lanes(cl, pkt, length, fa, device),
                         cl.geom_sharded, *now_on(cl.n, device, *now))
        c = sharded_step(cpu_tables, cpu_ex, *staged_lanes(cl, pkt, length, fa, "cpu"),
                         cl.geom_sharded, *now_on(cl.n, "cpu", *now))
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
    copy_launches = copy_exchange_phase(cl, spkt, slen, (sflags & ring_mod.FLAG_FROM_ACCESS) != 0,
                                        card, err)

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
    with tracer_armed():
        check_sharded_dispatch_makes_no_sync(cl, two[0][0], two[0][1], two[0][2], dpkt, dlen)
    say("  (and again with a tracer armed)")

    # 4. the ring loops: counts 0, the pipelined loop over mixed batches,
    # then an all-control batch (the sharded DHCP-only program)
    mixed = [sharded_frames(rng, flows, groups)[0] for _ in range(SH_BATCHES)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
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
    sh = launch_counts()
    check(done == SH_BATCHES * B, f"pipelined loop retired every frame ({done})")
    check_launches(sh, SH_BATCHES, per, "sharded path")
    reset_launches()
    check(ring.rx_push_batch(dframes, from_access=True) == B, "ring took the control batch")
    check(cl.process_ring(ring, NOW + 30, 30 * 10**6, pkt_slot=L) == B, "control batch retired")
    drain_ring(ring)
    shd = launch_counts()
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
    tn = now_on(cl.n, device, NOW + 50, 50 * 10**6)

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
    reset_launches()
    snap = entry_mod.dryrun_multichip(N_SHARDS)
    check(snap["steps"] == 7 and snap["psum_dhcp_hits"] == 4 * N_SHARDS, "dryrun_multichip(8)")
    return {"sharded": sh, "sharded_dhcp": shd, **copy_launches, **more}


def copy_exchange_phase(cl, pkt, length, fa, card, err) -> dict:
    """Phase 59: the skewed batch of phase 25 through the copying exchange
    (`CopyingExchange` over the cluster's map, every shard on this card):
    its lanes, summed stats and punts bit-equal to the same batch through
    `DeviceLocalExchange`, run before it and again after it (the step
    writes no table these lanes read); counts 0, then every K1 and K2 call
    of the copying run bit-equal to its plain version."""
    t0 = time.perf_counter()
    lanes = (cl._lanes(pkt), cl._lanes(np.asarray(length).astype(np.int64)), cl._lanes(fa))
    now = cl._now(NOW + 3, 2000)

    def run(ex):
        return sharded_step(cl.tables, ex, *lanes, cl.geom_sharded, *now)

    before = run(cl.exchange)
    per = sharded_launches(cl.n, 6)
    reset_launches()
    box = {}
    rec = record_kernel_inputs(lambda: box.update(out=run(CopyingExchange(cl.shard_devices))),
                               per["probe"], per["seg_prefix"], "copying exchange step")
    launches = launch_counts()
    after = run(cl.exchange)
    got = box["out"]
    for f in got._fields:
        a = getattr(got, f)
        if f == "tables" or a is None:
            continue
        check(torch.equal(a, getattr(before, f)) and torch.equal(a, getattr(after, f)),
              f"copying exchange: {f} == DeviceLocalExchange's, bit for bit")
    check_launches(launches, 1, per, "copying exchange step")
    probes_vs_plain([("copying exchange", a) for a in rec["probe"]], err)
    segs_vs_plain([("copying exchange", s, v, c) for s, v, c in rec["seg_prefix"]], err)
    punted = int((got.verdict == 0).sum())
    n_rec = (len(rec["probe"]), len(rec["seg_prefix"]))
    del rec
    say(f"copying exchange on one card: the skewed batch's {B} lanes ({punted} punted), summed "
        f"stats and punts == DeviceLocalExchange's; {per['probe']} K1 + {per['seg_prefix']} K2, "
        f"bit-equal to their plain versions on all {n_rec[0]} and {n_rec[1]} calls; "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    return {"sharded_copy": launches}


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
    reset_launches()
    outs2 = [eng2.process(batches[0][0], now=nows[0])]
    t["serve"] = t["read"] + time.perf_counter() - t0
    first_tables = host_words(eng2.tables)
    outs2 += [eng2.process(f, now=n) for (f, _), n in zip(batches[1:], nows[1:])]
    out_ren2 = eng2.process(ren, now=NOW + 60)
    launches = launch_counts()
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
    reset_launches()
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
    launches = launch_counts()
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
    reset_launches()
    box = {}
    rec = record_kernel_inputs(lambda: box.update(out=twin.step(pkt, length, fa, NOW + 201, 1000)),
                               per["probe"], per["seg_prefix"], "restored sharded step",
                               sharded_names(twin))
    launches = launch_counts()
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


def loadtest_phases(card, err) -> dict:
    """`loadtest` in-process through the port's `cli.main`, engine and
    scheduler, then (phase 53) `--wire` under each pump; returns {path:
    launches}."""
    from bng_tpu_torch import cli
    from bng_tpu_torch.telemetry import ledger

    out = {}
    name = torch.cuda.get_device_name(0)
    for path, extra in (("loadtest", []), ("loadtest_scheduler", ["--scheduler"]),
                        ("loadtest_wire_scalar", ["--wire", "--wire-pump", "scalar"]),
                        ("loadtest_wire_vector", ["--wire", "--wire-pump", "vector"])):
        with tempfile.TemporaryDirectory() as tmp:
            log = f"{tmp}/bench.jsonl"
            buf = io.StringIO()
            reset_launches()
            with first_kernel_calls(6, 0) as rec, contextlib.redirect_stdout(buf):
                rc = cli.main(["loadtest", *LT_ARGS, "--bench-log", log, *extra])
            launches = launch_counts()
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
        warm = 6 if "--scheduler" in extra else 0
        check(served["launches"]["probe"] == 3 * served["dispatches"] > 0
              and launches["probe"] == served["launches"]["probe"] + warm
              and launches["seg_prefix"] == served["launches"]["seg_prefix"] == 0,
              f"{path}: 3 K1 and 0 K2 per device dispatch ({launches}, {served})")
        check(ledger.backend_class(line) == "gpu" and line["env"]["device_kind"] == name
              and line["env"]["table_impl"] == "cuda",
              f"{path}: the ledger line is class gpu on {name} ({line['env']})")
        rec = rec["probe"]
        if rec:  # the engine run's DHCP-only program calls K1 through the wrapper
            probes_vs_plain([(path, a) for a in rec], err)
        wire = ""
        if "--wire" in extra:
            w = res["wire"]
            st = w["pump_stats"]
            check(w["mode"] == "memory" and w["pump_path"] == extra[-1] and w["unmatched"] == 0
                  and st["rx"] == st["tx"] > 0 and st["rx_submit_fail"] == 0
                  and st["tx_overflow"] == 0,
                  f"{path}: every request through the wire and back ({w})")
            wire = (f", wire: the memory rung (SimKernelRings), {w['pump_path']} pump, rx "
                    f"{st['rx']} tx {st['tx']}")
        say(f"{path}{' (K1 bit-equal on its first ' + str(len(rec)) + ' calls)' if rec else ''}: "
            f"{res['rps']:.1f} req/s, batch p50 {res['latency_p50_us']:.1f} / p99 "
            f"{res['latency_p99_us']:.1f} us, per request p50 {res['request_p50_us']} / p99 "
            f"{res['request_p99_us']} us, cache hit {res['cache_hit_rate']:.4f}, fast-path p99 "
            f"{res['fastpath_p99_us']:.1f} us, {res['requests']} requests in {res['batches']} "
            f"batches, {served['dispatches']} device dispatches, launches {launches}, "
            f"program {res['program']}{wire} [{card}]")
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
        reset_launches()
        t0 = time.perf_counter()
        for k in range(0, RUN_FLOWS, 64):
            for f in flows[k: k + 64]:
                ring.rx_push(f, from_access=True)
            drive_app(app, clk, 2)
        tx = drive_app(app, clk, RUN_SUBS // 16 - 2 * (RUN_FLOWS // 64)) + settle(app)
        dt = time.perf_counter() - t0
        launches = launch_counts()
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


def launches_of(sched, obs0, launches, what: str, k1_bulk: int, bulk: bool = True) -> tuple:
    """3 K1 per express dispatch, k1_bulk K1 + 4 K2 per bulk step, and a
    bulk step (with `bulk`) or at least one K1 (without) in the window."""
    n_ex = sched.observed["express"]["dispatches"] - obs0["express"]["dispatches"]
    n_bulk = sched.observed["bulk"]["dispatches"] - obs0["bulk"]["dispatches"]
    check((n_bulk > 0 if bulk else launches["probe"] > 0)
          and launches["probe"] == 3 * n_ex + k1_bulk * n_bulk
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
        reset_launches()
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
        launches = launch_counts()
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
        reset_launches()
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
        launches = launch_counts()
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
        reset_launches()
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
        launches = launch_counts()
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

# ------------------------------------------ observability: what `run` turns on by default

REPO = os.path.dirname(os.path.abspath(__file__))  # the subprocesses run from the checkout
SCRAPES = 5  # GET /metrics timed
OBS_LEASED = 32  # synthetic MACs leased before the snapshot: the restored app's first 2 beats
# families computed from the wall clock (the checkpointer's age reads
# time.time() at scrape): compared by presence only
WALL_FAMILIES = ("bng_ckpt_last_success_age_seconds",)
DEVICE_SAMPLE = 'bng_stage_latency_us_count{stage="device"}'  # recorded on the card alone


def exposition_samples(text: str) -> dict:
    """{sample key: value} of every counter and gauge, and each histogram's
    `_count` (buckets and sums carry wall-time values)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, val = line.rsplit(" ", 1)
        name = key.split("{", 1)[0]
        if name.endswith(("_bucket", "_sum")):
            continue
        out[key] = "wall" if name in WALL_FAMILIES else val
    return out


def obs_app(device, clock, ckpt_dir: str, trace_dir: str):
    """`run` at the reference's defaults (DHCPv6, SLAAC, the walled garden,
    metrics) with phase 34's geometry, the scheduler, telemetry with its
    SLO monitor, and a checkpoint directory."""
    from bng_tpu_torch.cli import BNGApp, BNGConfig

    cfg = BNGConfig(scheduler_enabled=True, synthetic_subs=RUN_SUBS, telemetry_enabled=True,
                    checkpoint_dir=ckpt_dir, trace_dir=trace_dir, metrics_port=0,
                    nat_public_ips=[f"203.0.113.{k}" for k in range(1, 71)])
    return BNGApp(cfg, clock=clock, device=device)


def obs_flows(n: int = 4) -> list:
    """UDP frames from subscribers with no lease: bulk-lane traffic (punted
    to the host's NAT), so the flight records hold bulk batches too."""
    return [F.udp_packet(bytes([2, 0x55, 0, 0, 0, k]), AC_MAC, ip_to_u32(f"10.0.9.{k + 1}"),
                         WAN_IP, 40000 + k, 53, b"q" * 40) for k in range(n)]


def obs_drive(app, clk, beats: int) -> list:
    """`beats` beats of the source with a few flows every fourth beat."""
    ring, tx = app.components["ring"], []
    for k in range(beats):
        if k % 4 == 1:
            for f in obs_flows():
                ring.rx_push(f, from_access=True)
        tx += drive_app(app, clk, 1)
    return tx + settle(app)


def run_observed_phases(card, device, err) -> dict:
    """`run` at the reference's defaults with telemetry, the SLO monitor,
    the checkpointer and metrics, on the card and on the CPU; the scrape
    over HTTP; a forced flight dump; a snapshot on the loop thread and the
    restore of a fresh app. Returns {"run_observed": launches}."""
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, dev in enumerate((device, "cpu")):
            clk = BeatClock(float(NOW))
            app = obs_app(dev, clk, f"{tmp}/{k}/ckpt", f"{tmp}/{k}/trace")
            c = app.components
            try:
                app.tick(clk.t)
                reset_launches()
                with first_kernel_calls(9, 4) as rec:
                    tx = obs_drive(app, clk, RUN_CMP_BEATS)
                launches = launch_counts()
                t0 = time.perf_counter()
                c["collector"].collect_once()
                collect_ms = (time.perf_counter() - t0) * 1e3
                tr, sched = c["telemetry"], c["scheduler"]
                out.append(SimpleNamespace(
                    tx=tx, expo=exposition_samples(c["metrics"].expose()),
                    stages={k: v["count"] for k, v in tr.breakdown().items()},
                    records=[(r["seq"], r["lane"], r["n"], r["shed"], r["punt"])
                             for r in tr.recorder.records()],
                    lanes=observed(sched), launches=launches, rec=rec, collect_ms=collect_ms,
                    backend=tr.recorder.meta["backend"]))
                if k == 0:
                    more = run_observed_card(app, clk, card, device, f"{tmp}/{k}", tx)
            finally:
                app.close()
        g, cpu = out
        # the express graph's own time (`device`, from its CUDA event pair) is
        # recorded on the card alone: checked here, then left out of the
        # comparisons with the CPU
        n_dev = int(g.expo.pop(DEVICE_SAMPLE, 0))
        check(DEVICE_SAMPLE not in cpu.expo and "device" not in cpu.stages
              and 0 < n_dev == g.stages.pop("device", 0) <= g.lanes["express"]["dispatches"],
              f"run observed: `device` samples on the card alone, at most one per express "
              f"dispatch ({n_dev}, {g.lanes['express']['dispatches']} express dispatches)")
        check(g.tx == cpu.tx and len(g.tx) >= 16 * RUN_CMP_BEATS,
              f"run observed: the card's first {RUN_CMP_BEATS} beats' TX bytes == the CPU app's "
              f"({len(g.tx)} vs {len(cpu.tx)} frames)")
        diff = {k: (g.expo.get(k), cpu.expo.get(k)) for k in set(g.expo) | set(cpu.expo)
                if g.expo.get(k) != cpu.expo.get(k)}
        check(not diff, f"run observed: every counter and gauge family and each histogram's "
              f"_count equal on the card and the CPU ({sorted(diff.items())[:8]})")
        check(g.stages == cpu.stages and g.records == cpu.records and g.lanes == cpu.lanes,
              f"run observed: the same stage counts, flight records and lane counts ({g.stages} "
              f"vs {cpu.stages})")
        check((g.backend, cpu.backend) == ("gpu", "cpu"), f"recorder backends ({g.backend}, "
              f"{cpu.backend})")
        check({r[1] for r in g.records} == {"express", "bulk"}, "express and bulk flight records")
        n_ex, n_bulk = g.lanes["express"]["dispatches"], g.lanes["bulk"]["dispatches"]
        check(n_bulk > 0 and g.launches["probe"] == 3 * n_ex + 9 * n_bulk
              and g.launches["seg_prefix"] == 4 * n_bulk,
              f"run observed: 3 K1 per express dispatch, 9 K1 + 4 K2 per bulk step "
              f"({g.launches}, {n_ex} express, {n_bulk} bulk)")
        kern = first_calls_vs_plain(g.rec, "run observed bulk", err)
        say(f"run observed: {RUN_CMP_BEATS} beats on the card == the CPU app (TX bytes, "
            f"{len(g.expo)} exposition samples, stage counts {g.stages}, "
            f"{len(g.records)} flight records); {kern}; launches {g.launches} "
            f"({n_ex} express, {n_bulk} bulk); collect_once {g.collect_ms:.3f} ms [{card}]")
    return {"run_observed": g.launches, **more}


def run_observed_card(app, clk, card, device, tmp: str, tx) -> dict:
    """On the card app after its compared beats: the scrape over HTTP, a
    forced flight dump, leases, a snapshot on the loop thread, and a fresh
    app restored from it whose first beats answer the leased MACs'
    DISCOVERs on the device."""
    c = app.components
    col, met, tr = c["collector"], c["metrics"], c["telemetry"]
    port = col.serve_http(0)
    try:
        scrape_ms = []
        for _ in range(SCRAPES):
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
                body = resp.read().decode()
            scrape_ms.append((time.perf_counter() - t0) * 1e3)
            check(body == met.expose(), "GET /metrics == expose()")
        t0 = time.perf_counter()
        expose_len = len(met.expose())
        expose_ms = (time.perf_counter() - t0) * 1e3
    finally:
        col.stop()
    path = tele.trigger("smoke", "forced dump")
    check(path is not None and os.path.exists(path), f"a forced trigger dumped ({path})")
    with open(path) as f:
        dump = json.load(f)
    check(dump["reason"] == "smoke" and dump["meta"]["backend"] == "gpu"
          and {r["lane"] for r in dump["records"]} == {"express", "bulk"},
          f"the dump holds the express and bulk records, backend gpu ({dump['meta']})")
    say(f"run observed: GET /metrics on port {port} == expose() ({len(body)} bytes), "
        f"{SCRAPES} scrapes p50 {np.percentile(scrape_ms, 50):.3f} / max {max(scrape_ms):.3f} "
        f"ms (expose() alone {expose_ms:.3f} ms, {expose_len} bytes); a forced dump of "
        f"{len(dump['records'])} records, backend "
        f"{dump['meta']['backend']}, program {dump['meta'].get('express_program')} [{card}]")

    # leases for the first OBS_LEASED synthetic MACs, from their OFFERs in
    # the compared beats' TX
    ring, dhcp, eng = c["ring"], c["dhcp"], c["engine"]
    offers = {}
    for t, m, ip in dhcp_replies(tx):
        if t == F.OFFER:
            offers.setdefault(m, ip)
    for i in range(OBS_LEASED):
        m = synthetic_mac(i)
        check(ring.rx_push(storm_request(m, 0x9000 + i, offers[m]), from_access=True),
              "the ring takes the REQUESTs")
    acks = [m for t, m, _ in dhcp_replies(drive_app(app, clk, 8) + settle(app)) if t == F.ACK]
    check(len(acks) == OBS_LEASED, f"{OBS_LEASED} ACKs ({len(acks)})")
    while eng.fastpath.dirty_count():  # the express drain ships the lease rows
        drive_app(app, clk, 1)
    settle(app)
    ckptr = c["checkpointer"]
    t0 = time.perf_counter()
    with app._ctl:  # on the loop thread, between beats
        path = ckptr.save_now(reason="smoke")
    snap_s = time.perf_counter() - t0
    col.collect_once()
    expo = exposition_samples(met.expose())
    check(expo["bng_ckpt_saves_total"] == "1" and expo['bng_ckpt_duration_seconds_count'
                                                        '{reason="smoke"}'] == "1",
          "the snapshot counted in bng_ckpt_*")

    # a fresh app on the same directory restores at start
    clk2 = BeatClock(clk.t + 5)
    t0 = time.perf_counter()
    fresh = obs_app(device, clk2, str(path.parent), f"{tmp}/trace2")
    restore_s = time.perf_counter() - t0
    try:
        fc = fresh.components
        rows = fc.get("checkpoint_restored")
        check(rows is not None and rows["dhcp.leases"] == OBS_LEASED,
              f"the fresh app restored {OBS_LEASED} leases ({rows})")
        feng, fdhcp = fc["engine"], fc["dhcp"]
        tx0, disc0 = feng.stats.tx, fdhcp.stats.discover
        reset_launches()
        tx = drive_app(fresh, clk2, OBS_LEASED // 16) + settle(fresh)
        launches = launch_counts()
        got = dhcp_replies(tx)
        check(feng.stats.tx - tx0 == OBS_LEASED and fdhcp.stats.discover == disc0
              and sorted(m for t, m, _ in got if t == F.OFFER)
              == sorted(synthetic_mac(i) for i in range(OBS_LEASED)),
              f"the restored app answered its first {OBS_LEASED} DISCOVERs (the leased MACs) on "
              f"the device, no slow-path OFFER ({feng.stats.tx - tx0}, "
              f"{fdhcp.stats.discover - disc0})")
        check(exposition_samples(fc["metrics"].expose())
              ['bng_ckpt_restores_total{outcome="ok"}'] == "1", "the restore counted ok")
        n_ex = fc["scheduler"].observed["express"]["dispatches"]
        check(launches["probe"] == 3 * n_ex and launches["seg_prefix"] == 0,
              f"restored: 3 K1 per express dispatch ({launches}, {n_ex})")
    finally:
        fresh.close()
    nonzero = {k: v for k, v in rows.items() if v}
    say(f"run observed: snapshot on the loop thread {snap_s:.3f} s ({path.stat().st_size} "
        f"bytes, 2^15 subscriber buckets, {OBS_LEASED} leases); a fresh app built and restored "
        f"in {restore_s:.3f} s ({nonzero}); its first {OBS_LEASED} DISCOVERs answered on the "
        f"device [{card}]")
    return {"run_restored": launches}


def read_lines(stream, sink: list) -> threading.Thread:
    """Drain a child's pipe into `sink` on a thread (so the child never
    blocks on a full pipe)."""
    th = threading.Thread(target=lambda: sink.extend(iter(stream.readline, "")), daemon=True)
    th.start()
    return th


def wait_for(pred, timeout_s: float, what: str):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        got = pred()
        if got:
            return got
        time.sleep(0.2)
    raise RuntimeError(f"check failed: {what} within {timeout_s:.0f} s")


def operator_process_phase(card) -> None:
    """`python -m bng_tpu_torch run --synthetic-subs 8192 --telemetry-enabled
    --checkpoint-dir <tmp> --metrics-port 0` on the card: scraped over
    HTTP, then SIGTERM: rc 0 and a new checkpoint; then `run --once` on the
    same directory restores from it."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, BNG_TRACE_DIR=f"{tmp}/trace")
        ckpt = f"{tmp}/ckpt"
        cmd = [sys.executable, "-m", "bng_tpu_torch", "run", "--synthetic-subs", str(RUN_SUBS),
               "--telemetry-enabled", "--checkpoint-dir", ckpt, "--metrics-port", "0"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=env, cwd=REPO)
        err_lines, out_lines = [], []
        readers = [read_lines(proc.stderr, err_lines), read_lines(proc.stdout, out_lines)]
        try:
            def port():
                for line in err_lines:
                    m = re.search(r"metrics on :(\d+)/metrics", line)
                    if m:
                        return int(m.group(1))
                check(proc.poll() is None, f"run exited early (rc {proc.returncode}): "
                      f"{''.join(err_lines)[-2000:]}")
                return None

            p = wait_for(port, 300, "run prints its metrics port")
            up_s = time.perf_counter() - t0

            def scraped():
                with urllib.request.urlopen(f"http://127.0.0.1:{p}/metrics", timeout=30) as r:
                    body = r.read().decode()
                ex = exposition_samples(body)
                ok = (int(ex.get("bng_telemetry_batch_records_total", "0")) > 0
                      and int(ex.get('bng_dhcp_requests_total{type="offer"}', "0")) > 0
                      and 'bng_stage_latency_us_count{stage="dispatch"}' in ex)
                return (body, ex) if ok else None

            body, ex = wait_for(scraped, 120, "a scrape shows served batches")
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            term_s = time.perf_counter() - t1
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for th in readers:
                th.join(timeout=10)
        check(rc == 0, f"run after SIGTERM: rc {rc}\n{''.join(err_lines)[-2000:]}")
        files = CheckpointStore(ckpt).list()
        check(len(files) == 1, f"SIGTERM wrote a checkpoint ({files})")
        records, offers = (ex["bng_telemetry_batch_records_total"],
                           ex['bng_dhcp_requests_total{type="offer"}'])
        say(f"python -m bng_tpu_torch run: metrics up {up_s:.1f}s after start, a scrape of "
            f"{len(body)} bytes ({records} flight records, {offers} OFFERs), SIGTERM -> rc 0 "
            f"in {term_s:.2f}s with checkpoint seq {files[0].seq} [{card}]")
        once = subprocess.run([sys.executable, "-m", "bng_tpu_torch", "run", "--once",
                               "--checkpoint-dir", ckpt], capture_output=True, text=True,
                              timeout=300, env=env, cwd=REPO)
        check(once.returncode == 0, f"run --once on the checkpoint dir: rc {once.returncode}\n"
              f"{once.stderr[-2000:]}")
        restored = [line for line in once.stderr.splitlines()
                    if "warm restart from checkpoint" in line]
        check(len(restored) == 1 and json.loads(once.stdout)["device"] == "cuda",
              f"run --once restored from the checkpoint on the card ({once.stderr[-1000:]})")
        say(f"python -m bng_tpu_torch run --once on that directory: rc 0, "
            f"rows {json.loads(restored[0])['rows']} [{card}]")


def trace_export_phase(card) -> None:
    """`python -m bng_tpu_torch trace export --scheduler` on the card, then
    `trace status`: the Chrome JSON has the express lane's thread (the DORA
    is control traffic only, so the reference's has no bulk thread either)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([sys.executable, "-m", "bng_tpu_torch", "trace", "export",
                              "--scheduler", "--trace-dir", tmp, "--out", f"{tmp}/dora.json"],
                             capture_output=True, text=True, timeout=300, cwd=REPO)
        check(out.returncode == 0, f"trace export: rc {out.returncode}\n{out.stderr[-2000:]}")
        res = json.loads(out.stdout)
        with open(res["trace"]) as f:
            trace = json.load(f)
        threads = {e["args"]["name"] for e in trace["traceEvents"] if e["name"] == "thread_name"}
        xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
        check("lane:express" in threads and res["events"] == len(xs) > 0
              and {"lane_wait", "dispatch", "device_wait", "reply", "total"} <= set(res["stages"]),
              f"trace export: the express lane's spans ({threads}, {res['stages']})")
        st = subprocess.run([sys.executable, "-m", "bng_tpu_torch", "trace", "status",
                             "--trace-dir", tmp], capture_output=True, text=True, timeout=120,
                            cwd=REPO)
        check(st.returncode == 0, f"trace status: rc {st.returncode}")
        say(f"trace export --scheduler: {res['events']} spans on threads {sorted(threads)}, "
            f"stages {res['stages']} [{card}]")


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


# ------------------------------------------------ the slow-path fleet behind `run`

FLEET_CLIENTS = 8192  # new clients of each timed DORA storm
FLEET_WAVE = 512  # clients whose DORAs are in flight together
FLEET_WARM = 128  # clients of the untimed warm-up storm (express graph, first batches)
FLEET_RUNS = ((1, "inline"), (4, "inline"), (4, "process"))  # (workers, mode) timed
CONTEXT_BYTES = 256 << 20  # less than one CUDA context: a spawned worker must not add one


def fleet_app(device, clock, workers: int, mode: str):
    """`BNGApp` at `run`'s geometry (the scheduler, 2^15 subscriber buckets,
    pool /16) with `workers` slow-path workers and a ring the phase feeds.
    NAT is off: 8,192 leases would need more port blocks than the default
    NAT table holds."""
    from bng_tpu_torch.cli import BNGApp, BNGConfig

    cfg = BNGConfig(scheduler_enabled=True, dhcpv6_enabled=False, slaac_enabled=False,
                    metrics_enabled=False, coa_enabled=False, nat_enabled=False,
                    slowpath_workers=workers, slowpath_worker_mode=mode)
    app = BNGApp(cfg, clock=clock, device=device)
    app.components["ring"] = PyRing(4 * FLEET_WAVE, 2048, 2 * FLEET_WAVE)
    return app


def fleet_storm(app, clk, first: int, n: int) -> tuple[list, dict]:
    """DORA of clients first..first+n in waves of FLEET_WAVE through the
    app's ring (a DISCOVER the fleet's admission shed is sent again);
    returns (every TX frame, {mac: acked ip})."""
    ring, tx, acks = app.components["ring"], [], {}
    for base in range(first, first + n, FLEET_WAVE):
        macs = [client_mac(k) for k in range(base, min(base + FLEET_WAVE, first + n))]
        offers: dict = {}
        for attempt in range(4):
            for m in macs:
                if m not in offers:
                    check(ring.rx_push(F.discover_frame(m, 0x10000 + attempt, pad=320),
                                       from_access=True), "the ring takes the DISCOVERs")
            got = drive_app(app, clk, 2) + settle(app)
            tx += got
            offers.update((m, ip) for t, m, ip in dhcp_replies(got) if t == F.OFFER)
            if len(offers) == len(macs):
                break
        check(len(offers) == len(macs), f"fleet storm: every client offered "
              f"({len(offers)} of {len(macs)})")
        for m in macs:
            check(ring.rx_push(storm_request(m, 0x20000, offers[m]), from_access=True),
                  "the ring takes the REQUESTs")
        got = drive_app(app, clk, 2) + settle(app)
        tx += got
        acks.update((m, ip) for t, m, ip in dhcp_replies(got) if t == F.ACK)
    return tx, acks


def fleet_books(app, tx, acks) -> tuple:
    return (tx, acks, app.components["fleet"].export_state(),
            dict(app.components["pools"].pools[1]._allocated))


def import_seconds(src: str) -> tuple[float, str]:
    """Wall seconds of a fresh interpreter that runs `src` (the import
    cost a spawned worker pays before it serves) and what it printed."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    dt = time.perf_counter() - t0
    check(out.returncode == 0, f"python -c {src!r}: rc {out.returncode}\n{out.stderr[-1500:]}")
    return dt, out.stdout.strip()


WORKER_IMPORTS = ("import runpy, sys; "
                  "runpy.run_module('bng_tpu_torch.__main__', run_name='__mp_main__'); "
                  "import bng_tpu_torch.control.fleet; print('torch' in sys.modules)")


def fleet_phases(card, device, err) -> dict:
    """The slow-path fleet behind `run` on the card: a DORA storm at one
    worker, at 4 inline and at 4 spawned workers (DORAs/s each, on this
    call); the timed inline run against a CPU app under the same storm,
    and K1 on its last express dispatch; a spawned worker's imports
    timed; then the live process over --ctl-listen and `chaos audit` on
    its snapshot."""
    from bng_tpu_torch.utils.net import mac_to_u64

    rates, launches, card_books = {}, {}, None
    for workers, mode in FLEET_RUNS:
        name = f"{workers} {mode}" if workers > 1 else "1 worker"
        torch.cuda.synchronize()
        free0 = torch.cuda.mem_get_info()[0]
        clk = BeatClock(float(NOW))
        app = fleet_app(device, clk, workers, mode)
        try:
            c = app.components
            fleet_storm(app, clk, 1_000_000, FLEET_WARM)
            reset_launches()
            t0 = time.perf_counter()
            tx, acks = fleet_storm(app, clk, 0, FLEET_CLIENTS)
            dt = time.perf_counter() - t0
            launches[name] = launch_counts()
            torch.cuda.synchronize()
            used = free0 - torch.cuda.mem_get_info()[0]
            check(len(acks) == FLEET_CLIENTS and len(set(acks.values())) == FLEET_CLIENTS,
                  f"fleet {name}: {FLEET_CLIENTS} ACKs with unique addresses ({len(acks)})")
            if name == "4 inline":
                card_books = fleet_books(app, tx, acks)
                # K1 on the path's own last express dispatch: the program's
                # buffers still hold its descriptors, `now` and tables
                sched = c["scheduler"]
                prog = c["engine"].express_aot(sched.express.cfg.batch, sched._express_dev)
                check(prog is not None and prog.graph is not None,
                      f"fleet {name}: the scheduler's captured express program")
                rec = record_kernel_inputs(prog._run, 3, 0, "fleet express dispatch",
                                           table_names(c["engine"].tables))
                probes_vs_plain([("fleet express", a) for a in rec["probe"]], err)
            if workers > 1:
                snap = c["fleet"].stats_snapshot()
                books = c["fleet"].export_state()
                leased = {mac_to_u64(bytes.fromhex(lz["mac"]))
                          for w in books["workers"] for lz in w["leases"]}
                check(snap["worker_failures"] == 0 and not snap["dead_workers"],
                      f"fleet {name}: worker_failures 0 ({snap['worker_failures']})")
                check({mac_to_u64(m) for m in acks} <= leased,
                      f"fleet {name}: every ACK in a worker's lease book")
                if mode == "process":
                    # four spawned workers, none with a CUDA context: the
                    # card's free memory moved no more than the inline run's
                    check(used - rates["4 inline"][1] < CONTEXT_BYTES,
                          f"fleet {name}: no CUDA context in the workers (device memory "
                          f"{used} B against inline's {rates['4 inline'][1]} B)")
            else:
                check("fleet" not in c and len(c["dhcp"].leases) == FLEET_CLIENTS + FLEET_WARM,
                      "fleet 1 worker: the parent server holds every lease")
            rates[name] = (FLEET_CLIENTS / dt, used)
            say(f"fleet {name}: {FLEET_CLIENTS} DORAs in {dt:.3f}s, "
                f"{FLEET_CLIENTS / dt:.1f} DORAs/s, launches {launches[name]}, device "
                f"memory +{used / 2**20:.1f} MiB [{card}]")
        finally:
            app.close()
    check(all(v["probe"] > 0 for v in launches.values()), "fleet: K1 launched on every run")
    say("fleet 4 inline: K1 bit-equal to its plain version on the last express dispatch's 3 "
        "calls")
    # the timed inline run's books against a CPU app's under the same storm
    # (inline: the workers run on the app's held clock, so the books are
    # deterministic)
    t0 = time.perf_counter()
    clk = BeatClock(float(NOW))
    app = fleet_app("cpu", clk, 4, "inline")
    try:
        fleet_storm(app, clk, 1_000_000, FLEET_WARM)
        cpu_books = fleet_books(app, *fleet_storm(app, clk, 0, FLEET_CLIENTS))
    finally:
        app.close()
    check(card_books == cpu_books,
          f"fleet: the timed {FLEET_CLIENTS}-client storm (4 inline workers) on the card gives "
          f"the CPU app's TX bytes, lease books and pool bitmap")
    say(f"fleet: the timed 4-inline run on the card == the CPU app under the same storm "
        f"({len(card_books[0])} TX frames, "
        f"{sum(len(w['leases']) for w in card_books[2]['workers'])} leases in the worker books; "
        f"the CPU run {time.perf_counter() - t0:.1f}s)")
    # what a spawned `run` worker imports before it serves, against torch
    (w_s, w_torch), (t_s, _) = import_seconds(WORKER_IMPORTS), import_seconds("import torch")
    check(w_torch == "False", f"a spawned run worker's imports bring in no torch ({w_torch})")
    print(f"fleet worker imports: {w_s:.3f}s (run's module entry as __mp_main__ and the fleet, "
          f"no torch); import torch {t_s:.3f}s [{card}]", flush=True)
    FLEET_RATES.update((k, v[0]) for k, v in rates.items())
    print("fleet DORAs/s: " + ", ".join(f"{k} {v[0]:.1f}" for k, v in rates.items())
          + f" ({FLEET_CLIENTS} clients each) [{card}]", flush=True)
    fleet_ctl_phase(card)
    return {"fleet": launches["4 inline"]}


def ctl(addr: str, *argv) -> dict:
    out = subprocess.run([sys.executable, "-m", "bng_tpu_torch", "ctl", "--ctl-addr", addr,
                          *argv], capture_output=True, text=True, timeout=300, cwd=REPO)
    check(out.returncode == 0, f"ctl {' '.join(argv)}: rc {out.returncode}\n{out.stdout[-1500:]}"
          f"{out.stderr[-1500:]}")
    return json.loads(out.stdout)


def fleet_ctl_phase(card) -> None:
    """`python -m bng_tpu_torch run` on the card with 4 spawned workers and
    --ctl-listen: `ctl fleet resize 6`, `ctl fleet rolling-restart`, `ctl
    status`, then SIGTERM (a snapshot with the fleet's books) and `chaos
    audit` of an app restored from it: rc 0."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "bng_tpu_torch", "run", "--synthetic-subs", "2048",
               "--slowpath-workers", "4", "--slowpath-worker-mode", "process",
               "--ctl-listen", "127.0.0.1:0", "--checkpoint-dir", tmp, "--metrics-port", "0"]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                cwd=REPO)
        err_lines, out_lines = [], []
        readers = [read_lines(proc.stderr, err_lines), read_lines(proc.stdout, out_lines)]
        try:
            def addr():
                for line in err_lines:
                    m = re.search(r"ctl on (\S+:\d+)", line)
                    if m:
                        return m.group(1)
                check(proc.poll() is None, f"run exited early (rc {proc.returncode}): "
                      f"{''.join(err_lines)[-2000:]}")
                return None

            a = wait_for(addr, 300, "run prints its ctl address")
            wait_for(lambda: ctl(a, "status")["ops"] is not None, 60, "ctl status answers")
            time.sleep(2.0)  # the synthetic source through the fleet for a while
            t0 = time.perf_counter()
            rz = ctl(a, "fleet", "resize", "6")
            rz_s = time.perf_counter() - t0
            check(rz["outcome"] == "ok" and rz["to"] == 6, f"ctl fleet resize 6 ({rz})")
            t0 = time.perf_counter()
            rr = ctl(a, "fleet", "rolling-restart")
            rr_s = time.perf_counter() - t0
            check(rr["outcome"] == "ok" and len(rr["replaced"]) == 6 and not rr["lost"],
                  f"ctl fleet rolling-restart ({rr})")
            st = ctl(a, "status")
            check(st["fleet"]["workers"] == 6 and not st["fleet"]["dead_workers"]
                  and st["fleet"]["resizes"] == 1 and st["fleet"]["rolling_restarts"] == 1,
                  f"ctl status after the transitions ({st})")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for th in readers:
                th.join(timeout=10)
        check(rc == 0, f"run after SIGTERM: rc {rc}\n{''.join(err_lines)[-2000:]}")
        say(f"ctl on the live run (4 spawned workers): fleet resize 6 ok in {rz_s:.2f}s "
            f"({rz['leases_moved']} leases, {rz['offers_moved']} offers moved, "
            f"{rz['duration_s']:.3f}s in the loop), rolling-restart ok in {rr_s:.2f}s "
            f"({rr['duration_s']:.3f}s in the loop), status: 6 workers, none dead [{card}]")
        out = subprocess.run([sys.executable, "-m", "bng_tpu_torch", "chaos", "audit",
                              "--slowpath-workers", "6", "--slowpath-worker-mode", "inline",
                              "--checkpoint-dir", tmp],
                             capture_output=True, text=True, timeout=300, cwd=REPO)
        check(out.returncode == 0, f"chaos audit of the restored app: rc {out.returncode}\n"
              f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
        rep = json.loads(out.stdout)
        restored = [json.loads(ln) for ln in out.stderr.splitlines()
                    if ln.startswith("{") and "warm restart" in ln]
        check(rep["ok"] and rep["checks"]["slice_granted"] > 0 and len(restored) == 1,
              f"chaos audit: clean, with the fleet's slices, on the restored books ({rep})")
        say(f"chaos audit of the app restored from the live run's SIGTERM snapshot on the card: "
            f"rc 0, checks {rep['checks']}, restored {restored[0].get('rows')} [{card}]")


# ------------------------------------------------------------- the chaos sweep

CHAOS_SEED = 5
CHAOS_SCALE = 0.25  # the storms' subscriber counts (1.0: the published storms)
CHAOS_SOAK = 2
# entries whose every kernel call is held against the plain versions:
# QoS-limited lanes that share a slot, and the 2-shard exchange probes
CHAOS_RECORDED = ("production_day", "sharded_swap_crash_rollback")


def chaos_cmd(device: str | None) -> list:
    return ([sys.executable, "-m", "bng_tpu_torch", "chaos", "run", "--seed", str(CHAOS_SEED),
             "--storm-scale", str(CHAOS_SCALE), "--soak-epochs", str(CHAOS_SOAK)]
            + (["--device", device] if device else []))


def chaos_phases(card, device, err) -> dict:
    """The chaos suite on the card: the 23 entries and the soak
    in-process (each entry timed; counts 0 before, read after), `python -m
    bng_tpu_torch chaos run` on the card and with `--device cpu`, one after
    the other: the three canonical reports equal and ok; K1/K2 bit-equal
    to their plain versions on every call of the CHAOS_RECORDED entries,
    kept as the sweep ran them."""
    from bng_tpu_torch.chaos import runner

    check(len(runner.ALL_SCENARIOS) == 23, "chaos: the sweep runs all 23 entries")
    reset_launches()
    report = {"schema": runner.REPORT_SCHEMA, "seed": CHAOS_SEED, "scenarios": {},
              "storm_scale": CHAOS_SCALE}
    secs, recs = {}, {}
    for name in sorted(runner.ALL_SCENARIOS):
        t0 = time.perf_counter()
        box = {}

        def sweep(name=name):
            box["got"] = runner.run_scenarios(CHAOS_SEED, names=[name],
                                              storm_scale=CHAOS_SCALE, device=device)

        if name in CHAOS_RECORDED:  # every kernel call's inputs kept as it runs
            recs[name] = record_kernel_inputs(sweep, None, 0, name)
        else:
            sweep()
        got = box["got"]
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        report["scenarios"].update(got["scenarios"])
    t0 = time.perf_counter()
    report["soak"] = runner.soak(CHAOS_SEED, epochs=CHAOS_SOAK)
    secs["soak"] = time.perf_counter() - t0
    launches = launch_counts()
    report["ok"] = (all(r.get("ok", False) for r in report["scenarios"].values())
                    and report["soak"]["ok"])
    mine = runner.canonical_json(report)
    say("chaos sweep on the card, seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + f"; total {sum(secs.values()):.1f} s [{card}]")
    failed = {k: r.get("budget", r.get("error")) for k, r in report["scenarios"].items()
              if not r.get("ok")}
    check(report["ok"], f"chaos sweep on the card: every entry ok (failed: {failed})")
    # one after the other: two sweeps at once oversubscribe the host's cores,
    # and the storms' stage budgets read wall time
    runs = {}
    for where in (None, "cpu"):
        t0 = time.perf_counter()
        runs[where] = subprocess.run(chaos_cmd(where), capture_output=True, text=True,
                                     timeout=900, cwd=REPO)
        runs[where].seconds = time.perf_counter() - t0
    gpu, cpu = runs[None], runs["cpu"]
    check(gpu.returncode == 0 and cpu.returncode == 0,
          f"chaos run: rc {gpu.returncode} on the card, {cpu.returncode} on the CPU\n"
          f"{gpu.stderr[-1500:]}{cpu.stderr[-1500:]}")
    check(gpu.stdout.strip() == mine and cpu.stdout.strip() == mine,
          "chaos run: the card's report == the CPU's == the in-process sweep's "
          "(canonical JSON, every field)")
    check(json.loads(gpu.stdout)["ok"] is True, "chaos run on the card reports ok: true")
    check(launches["probe"] > 0 and launches["seg_prefix"] > 0,
          f"chaos sweep: K1 and K2 launched on the card ({launches})")
    say(f"python -m bng_tpu_torch chaos run --seed {CHAOS_SEED} --storm-scale {CHAOS_SCALE} "
        f"--soak-epochs {CHAOS_SOAK}: ok, {len(mine)} bytes, equal to --device cpu and to "
        f"the in-process sweep; as a process {gpu.seconds:.1f}s on the card, {cpu.seconds:.1f}s "
        f"on the CPU; launches {launches} [{card}]")

    # both kernels on the sweep's own calls of the recorded entries
    for name, rec in recs.items():
        check(rec["probe"], f"chaos {name}: K1 calls recorded")
        probes_vs_plain([(f"chaos {name}", a) for a in rec["probe"]], err)
        segs_vs_plain([(f"chaos {name}", *a) for a in rec["seg_prefix"]], err)
    segs = [s for rec in recs.values() for s, _v, _c in rec["seg_prefix"]]
    shared = sum(int((torch.unique(s[s >= 0], return_counts=True)[1] > 1).any()) for s in segs)
    check(shared > 0, "chaos: K2 held on calls whose QoS-limited lanes share a slot")
    say("chaos: K1 and K2 bit-equal to their plain versions on every call of "
        + ", ".join(f"{k} ({len(r['probe'])} K1, {len(r['seg_prefix'])} K2)"
                    for k, r in recs.items())
        + f" as the sweep ran them; {shared} K2 calls with limited lanes sharing a slot")
    return {"chaos": launches}


# ------------------------------------------------ sharded serving through `run`

SH_RUN_SHARDS = 4  # run --shards 4 --batch-size 4096 --shard-nbuckets 8192
SH_RUN_BATCH = 4096  # 1,024 lanes a shard
SH_RUN_NBUCKETS = 8192  # per shard: the single engine's 2^15 subscriber buckets in all
SH_RUN_NAT_IPS = [f"203.0.113.{k}" for k in range(1, 5)]  # one public address a shard
SH_PASS1_BEAT = 992  # synthetic DISCOVERs pushed a beat in pass 1 (+16 of the source)
SH_PASS2_BEAT = 496  # and in the timed pass 2 (+16 of the source): 16 beats
SH_PASS2_BEATS = RUN_SUBS // (SH_PASS2_BEAT + 16)
# a flow punted to NAT in beat k is dispatched in k, retired (its mapping
# made) in k + 1 and shipped with k + 2's window: pass 2 sends each of its
# RUN_FLOWS flows in one of its first 14 beats and again two beats later
SH_RESEND_LAG = 2
SH_FLOWS_BEAT = 64  # flows of the card-vs-CPU drive and of the recorded beat
SH_CMP_OFFERS = 2048  # the card-vs-CPU drive: DISCOVERs, then REQUESTs, renewals and flows
SH_CMP_LEASED = 256


def sharded_run_app(device, clock, shards: int):
    """`BNGApp` at `run`'s geometry with the scheduler off (the pipelined
    ring loop): `--shards N --batch-size 4096 --shard-nbuckets 8192` and the
    synthetic source; at N = 1 the engine over the same 2^15 subscriber
    buckets. Four NAT public addresses: at 4 shards each owns one."""
    from bng_tpu_torch.cli import BNGApp, BNGConfig

    cfg = BNGConfig(shards=shards, batch_size=SH_RUN_BATCH, shard_nbuckets=SH_RUN_NBUCKETS,
                    synthetic_subs=RUN_SUBS, dhcpv6_enabled=False, slaac_enabled=False,
                    metrics_enabled=False, coa_enabled=False, nat_public_ips=SH_RUN_NAT_IPS)
    return BNGApp(cfg, clock=clock, device=device)


def ring_settle(app) -> tuple[list, list]:
    """Retire the in-flight window of the pipelined loop; (TX, FWD) frames."""
    c = app.components
    if "cluster" in c:
        c["cluster"].flush_pipeline(app._slow_path)
    else:
        c["engine"].flush_pipeline()
    ring, fwd = c["ring"], []
    while (got := ring.fwd_pop()) is not None:
        fwd.append(bytes(got[0]))
    return pop_tx(ring), fwd


def ring_beat(app, clk, pushes=(), synthetic: int = 0) -> tuple[list, list]:
    """One beat: `synthetic` more DISCOVERs of the source and `pushes`
    into the RX ring, then `drive_once` (which adds the source's 16);
    (TX, FWD) frames popped after it."""
    ring = app.components["ring"]
    if synthetic:
        n0 = app._syn_i
        app._push_synthetic(ring, per_beat=synthetic)
        check(app._syn_i == n0 + synthetic, "the ring takes the synthetic DISCOVERs")
    for f in pushes:
        check(ring.rx_push(f, from_access=True), "the ring takes the frames")
    clk.t += 0.001
    app.drive_once()
    fwd = []
    while (got := ring.fwd_pop()) is not None:
        fwd.append(bytes(got[0]))
    return pop_tx(ring), fwd


def nat_holders(app, acks) -> list:
    """The leased (mac, ip) whose subscriber got a NAT port block, in lease order."""
    c = app.components
    nats = c["cluster"].nat if "cluster" in c else [c["engine"].nat]
    held = set().union(*(n.blocks for n in nats))
    return [(m, ip) for m, ip in acks.items() if ip in held]


def sharded_flows(holders, n: int) -> list:
    """n UDP flows over the NAT holders, a few per subscriber (their lanes
    share a QoS slot in a batch)."""
    return [F.udp_packet(m, AC_MAC, ip, WAN_IP, 30000 + k // len(holders), 53, b"q" * 64)
            for k, (m, ip) in ((k, holders[k % len(holders)]) for k in range(n))]


def sharded_run_leases(app, clk, n_offers: int, n_leased: int, per_beat: int):
    """Pass 1 (every synthetic MAC offered by the slow path) and REQUESTs for
    the first n_leased offers, their rows shipped; returns (offers, acks,
    TX, FWD, beats)."""
    tx, fwd, offers, beats = [], [], {}, 0
    while app._syn_i + 16 < n_offers:
        t, f = ring_beat(app, clk, synthetic=min(per_beat, n_offers - app._syn_i - 16))
        tx, fwd, beats = tx + t, fwd + f, beats + 1
    t, f = ring_settle(app)
    tx, fwd = tx + t, fwd + f
    offers.update((m, ip) for ty, m, ip in dhcp_replies(tx) if ty == F.OFFER)
    macs = [synthetic_mac(i) for i in range(n_leased)]
    check(all(m in offers for m in macs), f"pass 1 offered the first {n_leased} MACs "
          f"({len(offers)} offers)")
    acks = {}
    for base in range(0, n_leased, 512):
        t, f = ring_beat(app, clk, [storm_request(m, 0x5000 + base + k, offers[m])
                                    for k, m in enumerate(macs[base: base + 512])])
        t2, f2 = ring_settle(app)
        tx, fwd = tx + t + t2, fwd + f + f2
        acks.update((m, ip) for ty, m, ip in dhcp_replies(t + t2) if ty == F.ACK)
    check(len(acks) == n_leased and all(acks[m] == offers[m] for m in acks),
          f"{n_leased} ACKs with the offered addresses ({len(acks)})")
    c = app.components
    fps = c["cluster"].fastpath if "cluster" in c else [c["engine"].fastpath]
    while sum(fp.dirty_count() for fp in fps):  # the DHCP drain ships the lease rows
        t, f = ring_beat(app, clk)
        t2, f2 = ring_settle(app)
        tx, fwd = tx + t + t2, fwd + f + f2
    return offers, acks, tx, fwd, beats


def sharded_run_cmp(device) -> tuple:
    """The card-vs-CPU drive at 4 shards: SH_CMP_OFFERS DISCOVERs, REQUESTs
    for SH_CMP_LEASED, then renewals and flows from the leases; every TX and
    FWD frame, stats() and every shard's table words."""
    clk = BeatClock(float(NOW))
    app = sharded_run_app(device, clk, SH_RUN_SHARDS)
    try:
        _o, acks, tx, fwd, _b = sharded_run_leases(app, clk, SH_CMP_OFFERS, SH_CMP_LEASED,
                                                   SH_PASS1_BEAT)
        flows = sharded_flows(nat_holders(app, acks), SH_FLOWS_BEAT)
        renew = [F.discover_frame(m, 0x7000 + k, pad=320) for k, m in enumerate(acks)]
        app.config.synthetic_subs = 0  # the scripted frames alone
        for k in range(2):  # the flows punted to NAT, then translated on the device
            t, f = ring_beat(app, clk, renew[k * 128:(k + 1) * 128] + flows)
            t2, f2 = ring_settle(app)
            tx, fwd = tx + t + t2, fwd + f + f2
        t, f = ring_settle(app)
        cl = app.components["cluster"]
        cl.quiesce()
        stats = app.stats()
        stats.pop("device")
        words = [(host_words(cl.tables[i]),
                  cl.fastpath[i].sub.keys.tobytes(), cl.fastpath[i].sub.vals.tobytes(),
                  cl.nat[i].checkpoint_state()[0]) for i in range(cl.n)]
        return tx + t, fwd + f, stats, words
    finally:
        app.close()


def count_windows(cl) -> dict:
    """Count the fused and DHCP-only windows the cluster dispatches."""
    n = {"fused": 0, "dhcp": 0}
    fused, dhcp = cl._dispatch_fused, cl._dispatch_dhcp

    def f(*a, **k):
        n["fused"] += 1
        return fused(*a, **k)

    def d(*a, **k):
        n["dhcp"] += 1
        return dhcp(*a, **k)

    cl._dispatch_fused, cl._dispatch_dhcp = f, d
    return n


def run_sharded_phases(card, device, err) -> dict:
    """`run --shards 4` on the card (phase 47): the card against a CPU app on
    the same frames, then pass 1 and the leases, an `engine_swap` under the
    ring and its audit, the timed pass 2 (counts 0) beside the same
    configuration at --shards 1, and at each shard count one beat's K1/K2
    calls against their plain versions; returns {"run_sharded": launches,
    "run_shards1": launches}."""
    from bng_tpu_torch.chaos.invariants import audit_app

    t0 = time.perf_counter()
    cmp = [sharded_run_cmp(dev) for dev in (device, "cpu")]
    check(cmp[0][0] == cmp[1][0] and cmp[0][1] == cmp[1][1],
          f"run --shards 4: the card's TX and FWD bytes == the CPU app's "
          f"({len(cmp[0][0])}/{len(cmp[1][0])} TX, {len(cmp[0][1])}/{len(cmp[1][1])} FWD)")
    check(cmp[0][2] == cmp[1][2], f"run --shards 4: stats() == the CPU app's\n{cmp[0][2]}\n"
          f"{cmp[1][2]}")
    for i, (g, c) in enumerate(zip(cmp[0][3], cmp[1][3])):
        check(g[1:] == c[1:], f"run --shards 4: shard {i}'s host rows == the CPU app's")
        words_equal(g[0], c[0], f"run --shards 4: shard {i}'s device tables == the CPU app's")
    check(cmp[0][2]["sharded"]["missteers"] == 0 and len(cmp[0][1]) > 0,
          "run --shards 4 (card vs CPU): no missteer, flows forwarded")
    say(f"run --shards 4: the card == the CPU app on {SH_CMP_OFFERS} DISCOVERs, "
        f"{SH_CMP_LEASED} leases and their renewals, {SH_FLOWS_BEAT} flows twice "
        f"({len(cmp[0][0])} TX, {len(cmp[0][1])} FWD frames, stats and every shard's table "
        f"words equal; {time.perf_counter() - t0:.1f}s)")

    rates, launches, out = {}, {}, {}
    for shards in (SH_RUN_SHARDS, 1):
        clk = BeatClock(float(NOW))
        app = sharded_run_app(device, clk, shards)
        try:
            c = app.components
            ring, dhcp = c["ring"], c["dhcp"]
            if shards > 1:
                cl = c["cluster"]
                check("engine" not in c and cl.n == shards and cl.b == SH_RUN_BATCH // shards
                      and cl.fastpath[0].sub.nbuckets == SH_RUN_NBUCKETS,
                      "run --shards 4: a 4 x 1,024-lane cluster of 8,192 buckets a shard")
            else:
                check(c["engine"].fastpath.sub.nbuckets == 1 << 15 and c["engine"].B == SH_RUN_BATCH,
                      "run --shards 1: the engine over 2^15 buckets at B = 4096")
            t1 = time.perf_counter()
            offers, acks, _tx, _fwd, beats1 = sharded_run_leases(app, clk, RUN_SUBS, RUN_LEASED,
                                                                 SH_PASS1_BEAT)
            t_lease = time.perf_counter() - t1
            holders = nat_holders(app, acks)
            flows = sharded_flows(holders, RUN_FLOWS)
            if shards > 1:
                # a blue/green swap under the ring: a window in flight and
                # frames waiting in the RX ring at the barrier
                ring_beat(app, clk, synthetic=256)
                app._push_synthetic(ring, per_beat=256)
                before = c["cluster"]
                rep = app.engine_swap()
                check(rep["outcome"] == "ok" and rep["audit_ok"] and c["cluster"] is not before,
                      f"run --shards 4: engine_swap under the ring ({rep})")
                ring_beat(app, clk)
                ring_settle(app)
                audit = audit_app(app)
                check(audit.ok, f"run --shards 4: audit_app clean after the swap "
                      f"({audit.violations_by_kind()})")
                say(f"run --shards 4: engine_swap ok, audit ok, {rep['frames_deferred']} frames "
                    f"deferred, {rep['duration_s']:.3f}s (quiesce {rep['quiesce_s']:.3f}, "
                    f"hydrate {rep['hydrate_s']:.3f}, audit {rep['audit_s']:.3f}, flip "
                    f"{rep['flip_s']:.3f}); audit_app clean after it [{card}]")
                cl = c["cluster"]
                windows = count_windows(cl)
            # pass 2, counted and timed: one more cycle of the source (the
            # leased MACs answered on the device, the rest by the slow path),
            # SH_PASS2_BEAT + 16 DISCOVERs a beat, and each flow twice: its
            # first frame punts to NAT, its second is translated on the device
            groups = np.array_split(np.arange(RUN_FLOWS), SH_PASS2_BEATS - SH_RESEND_LAG)
            app._syn_i = 0
            disc0 = dhcp.stats.discover
            tx_dev0 = (c["cluster"].stats_summary()["tx"] if shards > 1
                       else c["engine"].stats.tx)
            reset_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            beats, tx, fwd, n_flow = 0, [], [], 0
            while app._syn_i < RUN_SUBS:
                sent = [flows[i] for g in (beats, beats - SH_RESEND_LAG)
                        if 0 <= g < len(groups) for i in groups[g]]
                t, f = ring_beat(app, clk, sent,
                                 synthetic=min(SH_PASS2_BEAT, RUN_SUBS - 16 - app._syn_i))
                tx, fwd, beats, n_flow = tx + t, fwd + f, beats + 1, n_flow + len(sent)
            t, f = ring_settle(app)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            launches[shards] = launch_counts()
            tx, fwd = tx + t, fwd + f
            slow = dhcp.stats.discover - disc0
            dev_tx = ((c["cluster"].stats_summary()["tx"] if shards > 1 else c["engine"].stats.tx)
                      - tx_dev0)
            frames = RUN_SUBS + n_flow
            check(beats == SH_PASS2_BEATS and n_flow == 2 * RUN_FLOWS,
                  f"run --shards {shards} pass 2: {SH_PASS2_BEATS} beats, every flow sent twice "
                  f"({beats}, {n_flow})")
            check(slow == RUN_SUBS - RUN_LEASED and dev_tx == RUN_LEASED,
                  f"run --shards {shards} pass 2: the leased MACs answered on the device, the "
                  f"rest by the slow path ({dev_tx}, {slow})")
            check(len(fwd) == RUN_FLOWS, f"run --shards {shards} pass 2: every flow's second "
                  f"frame forwarded on the device ({len(fwd)} FWD)")
            rates[shards] = (beats / dt, frames / dt, beats, dt)
            say(f"run --shards {shards} pass 2: {beats} beats, {frames} frames in {dt:.3f}s: "
                f"{beats / dt:.2f} beats/s, {frames / dt:.1f} frames/s; DISCOVERs answered on the "
                f"device {dev_tx}, by the slow path {slow}; {len(fwd)} FWD of {n_flow} flow "
                f"frames ({RUN_FLOWS} flows sent twice) over {len(holders)} NAT holders; launches "
                f"{launches[shards]}; pass 1 + leases {t_lease:.2f}s ({beats1} beats) [{card}]")
            if shards > 1:
                per = sharded_launches(shards, 6)
                k1 = per["probe"] * windows["fused"] + 3 * shards * shards * windows["dhcp"]
                check(launches[shards]["probe"] == k1
                      and launches[shards]["seg_prefix"] == per["seg_prefix"] * windows["fused"],
                      f"run --shards 4: N x (6 + 3N) K1 and 4N K2 per fused window, 3N x N K1 "
                      f"per DHCP-only window ({launches[shards]}, {windows})")
                summ = app.stats()["sharded"]
                check(summ["missteers"] == 0, f"run --shards 4: missteers 0 ({summ})")
                names, what = sharded_names(cl), f"windows {windows}; missteers " \
                    f"{summ['missteers']}, nat_punts {summ['nat_punts']}, slow_errors " \
                    f"{summ['slow_errors']}"
            else:
                per = {"probe": 9, "seg_prefix": 4}  # one engine step at B = 4096
                names, what = table_names(c["engine"].tables), "one engine step"
            # one beat's K1/K2 calls, at this path's shapes, against their
            # plain versions
            app._syn_i = 0
            for fr in sharded_flows(holders[:SH_FLOWS_BEAT // 4], SH_FLOWS_BEAT):
                ring.rx_push(fr, from_access=True)  # 4 flows a subscriber
            app._push_synthetic(ring, per_beat=SH_PASS2_BEAT)
            rec = record_kernel_inputs(app.drive_once, per["probe"], per["seg_prefix"],
                                       f"run --shards {shards} beat", names)
            ring_settle(app)
            path = "run_sharded" if shards > 1 else "run_shards1"
            probes_vs_plain([(path, a) for a in rec["probe"]], err)
            segs_vs_plain([(path, *a) for a in rec["seg_prefix"]], err)
            shared = sum(int((torch.unique(s[s >= 0], return_counts=True)[1] > 1).any())
                         for s, _v, _c in rec["seg_prefix"])
            check(shared > 0, f"run --shards {shards}: K2 held on calls whose QoS-limited lanes "
                  "share a slot")
            say(f"run --shards {shards}: one beat's {len(rec['probe'])} K1 and "
                f"{len(rec['seg_prefix'])} K2 calls bit-equal to their plain versions; {shared} "
                f"K2 calls with QoS-limited lanes sharing a slot; {what} [{card}]")
            out[shards] = len(tx)
        finally:
            app.close()
        gc.collect()
        torch.cuda.empty_cache()
    r4, r1 = rates[SH_RUN_SHARDS], rates[1]
    print(f"run --shards 4 vs 1 (scheduler off, {SH_RUN_BATCH} lanes): {r4[0]:.2f} vs "
          f"{r1[0]:.2f} beats/s, {r4[1]:.1f} vs {r1[1]:.1f} frames/s ({r4[1] / r1[1]:.3f}x) "
          f"[{card}]", flush=True)
    return {"run_sharded": launches[SH_RUN_SHARDS], "run_shards1": launches[1]}


# --------------------------------------- the HA pair over the cluster listener

HA_CLIENTS = 8192  # the active's DORA storm, in waves of FLEET_WAVE
HA_BEFORE = 4096  # of them before the standby joins (its full sync)
HA_GAP = 512  # clients DORAed while the standby's stream is down


def ha_certs(tmp: str) -> dict | None:
    """A self-signed certificate for 127.0.0.1 made now, or None with no
    openssl on the host."""
    import shutil

    from bng_tpu_torch.control import ztp_tls

    if shutil.which("openssl") is None:
        return None
    key, crt = os.path.join(tmp, "cluster.key"), os.path.join(tmp, "cluster.crt")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", key,
                    "-out", crt, "-days", "2", "-subj", "/CN=cluster.bng.test",
                    "-addext", "subjectAltName=DNS:cluster.bng.test,IP:127.0.0.1"],
                   check=True, capture_output=True, timeout=120)
    with open(crt) as f:
        der = ztp_tls.pem_to_der(f.read())[0]
    return {"cert": crt, "key": key, "pin": ztp_tls.cert_fingerprint(der)}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ha_app(device, clock, role: str, listen: str, peer: str, store_peer: str, ckpt: str,
           tls: dict | None):
    """`BNGApp` at `run`'s geometry with the scheduler (NAT off, as the
    fleet's: 8,192 leases outgrow the default NAT table), an HA role, a
    cluster listener, the replicated store in write mode with the other
    app as its peer, and a checkpoint directory; over TLS when `tls`."""
    from bng_tpu_torch.cli import BNGApp, BNGConfig

    scheme = "https" if tls else "http"
    extra = dict(cluster_tls_cert=tls["cert"], cluster_tls_key=tls["key"],
                 cluster_tls_pins=[tls["pin"]]) if tls else {}
    cfg = BNGConfig(scheduler_enabled=True, dhcpv6_enabled=False, slaac_enabled=False,
                    metrics_enabled=False, coa_enabled=False, nat_enabled=False,
                    ha_role=role, ha_peer=f"{scheme}://{peer}" if peer else "",
                    cluster_listen=listen, store_mode="write",
                    store_peers=[f"{scheme}://{store_peer}"], checkpoint_dir=ckpt,
                    node_id=f"bng-{role}", **extra)
    app = BNGApp(cfg, clock=clock, device=device)
    app.components["ring"] = PyRing(4 * FLEET_WAVE, 2048, 2 * FLEET_WAVE)
    return app


def ha_pair_phases(card, device, err) -> dict:
    """The HA pair on the card (phase 48): an active and a standby `BNGApp`
    over a loopback cluster listener (TLS with a certificate made now when
    openssl is there); the standby's full sync, the replication lag, a
    stream drop healed by replay, the stores equal, each app's `ha`
    checkpoint component restored into a fresh app, and the replicated
    store converged; K1 held against its plain version on the active's
    last express dispatch; returns {"ha_pair": launches}."""
    from bng_tpu_torch.chaos.invariants import audit_invariants

    tmp = tempfile.mkdtemp(prefix="bng-ha-")
    tls = ha_certs(tmp)
    say("ha pair: openssl " + ("found: the pair runs over TLS with a pinned certificate made now"
                               if tls else "not on this host: the pair runs in plain HTTP"))
    ports = [free_port(), free_port()]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    dirs = [os.path.join(tmp, d) for d in ("active", "standby", "active2", "standby2")]
    clk = BeatClock(float(NOW))
    act = ha_app(device, clk, "active", addrs[0], "", addrs[1], dirs[0], tls)
    sb = None
    try:
        url = act.components["cluster_server"].url
        check(url == ("https://" if tls else "http://") + addrs[0], f"ha: the listener ({url})")
        ha_a = act.components["ha"]
        push_t, apply_t = {}, {}
        inner_push = ha_a.push_change

        def timed_push(*a, **k):
            t = time.perf_counter()
            inner_push(*a, **k)
            push_t[ha_a._seq] = t

        ha_a.push_change = timed_push
        reset_launches()
        t0 = time.perf_counter()
        fleet_storm(act, clk, 0, HA_BEFORE)
        t_storm1 = time.perf_counter() - t0
        check(len(ha_a.store) == HA_BEFORE, f"ha: the active's store holds every lease "
              f"({len(ha_a.store)})")

        # the standby joins an active that already holds the sessions
        sb = ha_app(device, clk, "standby", addrs[1], addrs[0], addrs[0], dirs[1], tls)
        ha_b = sb.components["ha"]
        inner_apply = ha_b._on_change

        def timed_apply(ch):
            inner_apply(ch)
            apply_t[ch.seq] = time.perf_counter()

        ha_b._on_change = timed_apply
        t0 = time.perf_counter()
        sb.tick(clk.t)
        t_full = time.perf_counter() - t0
        check(ha_b.connected and ha_b.stats["full_syncs"] == 1 and len(ha_b.store) == HA_BEFORE,
              f"ha: the standby full-synced {HA_BEFORE} sessions ({ha_b.stats})")

        # live deltas while the active takes the rest of the storm
        t0 = time.perf_counter()
        fleet_storm(act, clk, HA_BEFORE, HA_CLIENTS - HA_BEFORE - HA_GAP)
        t_storm2 = time.perf_counter() - t0
        deadline = time.monotonic() + 30.0
        while ha_b.last_seq < ha_a._seq and time.monotonic() < deadline:
            time.sleep(0.01)
        check(ha_b.last_seq == ha_a._seq, f"ha: the standby caught up ({ha_b.last_seq} of "
              f"{ha_a._seq})")
        lag = np.array([(apply_t[s] - push_t[s]) * 1e3 for s in push_t if s in apply_t])
        check(len(lag) == HA_CLIENTS - HA_BEFORE - HA_GAP, f"ha: a lag for every delta "
              f"({len(lag)})")

        # the stream drops; the active takes HA_GAP more clients; the standby
        # reconnects and heals by replay_since, with no second full sync
        ha_b.disconnect()
        fleet_storm(act, clk, HA_CLIENTS - HA_GAP, HA_GAP)
        clk.t += 1.0
        t0 = time.perf_counter()
        sb.tick(clk.t)
        t_re = time.perf_counter() - t0
        deadline = time.monotonic() + 30.0
        while ha_b.last_seq < ha_a._seq and time.monotonic() < deadline:
            time.sleep(0.01)
        check(ha_b.connected and ha_b.stats["full_syncs"] == 1 and ha_b.last_seq == ha_a._seq,
              f"ha: the reconnect healed by replay_since with no full sync ({ha_b.stats})")
        launches = launch_counts()
        # K1 on the active's own last express dispatch: the program's
        # buffers still hold its descriptors, `now` and tables
        sched, eng = act.components["scheduler"], act.components["engine"]
        prog = eng.express_aot(sched.express.cfg.batch, sched._express_dev)
        check(prog is not None and prog.graph is not None,
              "ha: the active scheduler's captured express program")
        rec = record_kernel_inputs(prog._run, 3, 0, "ha active express dispatch",
                                   table_names(eng.tables))
        probes_vs_plain([("ha_pair express", a) for a in rec["probe"]], err)
        rep = audit_invariants(ha_pair=(ha_a, ha_b), check_roundtrip=False)
        check(rep.ok and rep.checks["ha_sessions"] == HA_CLIENTS and len(ha_b.store) == HA_CLIENTS,
              f"ha: the standby's store == the active's ({rep.violations_by_kind()}, "
              f"{len(ha_b.store)})")
        say(f"ha pair ({'TLS, pinned' if tls else 'plain HTTP'}): full sync of {HA_BEFORE} "
            f"sessions {t_full:.3f}s; replication lag over {len(lag)} deltas p50 "
            f"{np.percentile(lag, 50):.3f} ms, p99 {np.percentile(lag, 99):.3f} ms (push_change "
            f"to the standby's apply, host clock); after a drop and {HA_GAP} more leases the "
            f"reconnect took {t_re:.3f}s, {ha_b.stats['deltas']} deltas, "
            f"{ha_b.stats['full_syncs'] - 1} full syncs in the heal; stores equal ({HA_CLIENTS} "
            f"sessions); storms {HA_BEFORE / t_storm1:.1f} and "
            f"{(HA_CLIENTS - HA_BEFORE - HA_GAP) / t_storm2:.1f} DORAs/s; launches {launches}; "
            f"K1 bit-equal to its plain version on the active's last express dispatch's "
            f"{len(rec['probe'])} calls [{card}]")
        print(f"ha pair: full sync {t_full:.3f}s for {HA_BEFORE} sessions, lag p50 "
              f"{np.percentile(lag, 50):.3f} / p99 {np.percentile(lag, 99):.3f} ms, reconnect "
              f"{t_re:.3f}s with {ha_b.stats['full_syncs'] - 1} full syncs [{card}]", flush=True)

        # the replicated store: a write on each, one sync tick, equal digests
        sa, sbs = act.components["cluster_store"], sb.components["cluster_store"]
        for k, (m, ip) in enumerate(sorted((s.mac, s.ip) for s in ha_a.store.all())[:256]):
            (sa if k % 2 else sbs).put(f"sub/{m}", str(ip).encode())
        clk.t += 10.0
        t0 = time.perf_counter()
        act.tick(clk.t)
        t_sync = time.perf_counter() - t0
        check(sa.store.digest() == sbs.store.digest() and len(sa.list("sub/")) == 256,
              "ha: the replicated store pair converged after one sync tick")
        say(f"ha: the store pair (write mode, each the other's peer) converged in one tick "
            f"({t_sync:.3f}s, 256 keys, members {sorted(sa.members())}) [{card}]")

        # each app's `ha` component restores into a fresh app
        for app, d, role in ((act, dirs[0], "active"), (sb, dirs[1], "standby")):
            with app._ctl:
                path = app.components["checkpointer"].save_now(reason="ha")
            fresh = ha_app(device, BeatClock(clk.t), role, "", addrs[0] if role == "standby"
                           else "", addrs[0], d, tls)
            try:
                rows = fresh.components.get("checkpoint_restored", {})
                check(rows.get("ha.sessions") == HA_CLIENTS
                      and fresh.components["ha"].checkpoint_state()
                      == app.components["ha"].checkpoint_state(),
                      f"ha: the {role}'s checkpoint restores its store into a fresh app "
                      f"({fresh.components.get('checkpoint_error')}, {rows.get('ha.sessions')})")
            finally:
                fresh.close()
            say(f"ha: the {role}'s snapshot ({os.path.getsize(path)} bytes) restored "
                f"{HA_CLIENTS} sessions into a fresh app")
        return {"ha_pair": launches}
    finally:
        if sb is not None:
            sb.close()
        act.close()
        subprocess.run(["rm", "-rf", tmp], check=False)


# ---------------------------------- the Nexus allocator with partition resilience

NEXUS_CIDR = "10.77.0.0/16"
NEXUS_CLIENTS = 8192  # Nexus-first DORAs, in waves of FLEET_WAVE
NEXUS_PART = 1024  # clients leased from the local pool while the Nexus is down
NEXUS_CONFLICTS = 64  # of those, claimed at the heal by another node at an earlier time
NEXUS_PSK = "chip-smoke-device-psk-0123"
NEXUS_TICKS = 30  # 1 s ticks the FSM has to reach PARTITIONED (threshold 3 x 5 s)
FLEET_RATES: dict = {}  # phase 44's DORAs/s, printed beside the Nexus fleet's


class NexusBackend:
    """The loopback Nexus's allocator: the port's `DistributedAllocator` on a
    `MemoryAllocationStore` for NEXUS_CIDR, behind a lock (the listener
    serves each request on a thread of its own). The pools' gateway is
    claimed first, as a Nexus pool reserves it."""

    def __init__(self, clock):
        from bng_tpu_torch.control.allocator import DistributedAllocator, MemoryAllocationStore

        self.store = MemoryAllocationStore()
        self.alloc = DistributedAllocator(NEXUS_CIDR, self.store, node_id="nexus",
                                          lease_seconds=86400, clock=clock)
        self.lock = threading.Lock()
        self.calls = 0
        self.claim("10.77.0.1", "gateway", 0.0)

    def claim(self, ip: str, sid: str, at: float, node: str = "nexus") -> None:
        from bng_tpu_torch.control.allocator import AllocationRecord

        with self.lock:
            check(self.store.put(AllocationRecord(ip=ip, subscriber_id=sid, allocated_at=at,
                                                  node_id=node))
                  and self.alloc.bitmap.allocate_specific(ip, sid), f"nexus: {ip} claimed")

    def allocate(self, subscriber_id, pool_hint):
        with self.lock:
            self.calls += 1
            return self.alloc.allocate(subscriber_id)

    def lookup(self, sid):
        with self.lock:
            rec = self.store.find_by_subscriber(sid)
        return rec.ip if rec is not None else None

    def lookup_by_ip(self, ip):
        with self.lock:
            rec = self.store.get(ip)
        return (rec.subscriber_id, rec.allocated_at) if rec is not None else None

    def release(self, sid):
        with self.lock:
            return self.alloc.release(sid)

    def pool_info(self):
        return {"pools": [{"cidr": NEXUS_CIDR}]}


def nexus_app(device, clock, url: str, workers: int = 1, mode: str = "inline",
              auth: str = "psk", **kw):
    """`BNGApp` at phase 44's geometry (the scheduler, 2^15 subscriber
    buckets, NAT off) allocating through the Nexus at `url` from a
    NEXUS_CIDR pool, with PSK device authentication from a key file."""
    from bng_tpu_torch.cli import BNGApp, BNGConfig

    tmp = tempfile.mkdtemp(prefix="bng-psk-")
    psk_file = os.path.join(tmp, "psk")
    with open(psk_file, "w") as f:
        f.write(NEXUS_PSK + "\n")
    cfg = BNGConfig(scheduler_enabled=True, dhcpv6_enabled=False, slaac_enabled=False,
                    metrics_enabled=False, coa_enabled=False, nat_enabled=False,
                    slowpath_workers=workers, slowpath_worker_mode=mode, nexus_url=url,
                    pool_cidr=NEXUS_CIDR, device_auth_method=auth,
                    device_auth_psk_file=psk_file, **kw)
    try:
        app = BNGApp(cfg, clock=clock, device=device)
    finally:
        subprocess.run(["rm", "-rf", tmp], check=False)
    app.components["ring"] = PyRing(4 * FLEET_WAVE, 2048, 2 * FLEET_WAVE)
    return app


def ship_fastpath(app, clk, mac: bytes) -> None:
    """Beats of one leased client's DISCOVER until the express drain (a
    bounded batch a dispatch) has shipped every fast-path row."""
    for k in range(256):
        if not app.components["engine"].fastpath.dirty_count():
            break
        check(app.components["ring"].rx_push(F.discover_frame(mac, 0x40000 + k, pad=320),
                                             from_access=True), "the ring takes the DISCOVER")
        drive_app(app, clk, 1)
        settle(app)
    check(app.components["engine"].fastpath.dirty_count() == 0, "the fast-path rows shipped")


def rediscover(app, clk, macs) -> tuple[dict, int, int]:
    """Each MAC's next DISCOVER through the ring; returns ({mac: OFFER
    yiaddr}, DISCOVERs answered on the device, DISCOVERs the slow path
    saw)."""
    c = app.components
    eng, dhcp, ring = c["engine"], c["dhcp"], c["ring"]
    tx0, disc0, offers = eng.stats.tx, dhcp.stats.discover, {}
    for k in range(0, len(macs), FLEET_WAVE):
        for m in macs[k: k + FLEET_WAVE]:
            check(ring.rx_push(F.discover_frame(m, 0x30000 + k, pad=320), from_access=True),
                  "the ring takes the DISCOVERs")
        got = drive_app(app, clk, 2) + settle(app)
        offers.update((m, ip) for t, m, ip in dhcp_replies(got) if t == F.OFFER)
    return offers, eng.stats.tx - tx0, dhcp.stats.discover - disc0


def nexus_drive(device, card: str | None, err) -> dict:
    """Phase 49's drive of one app: the Nexus-first storm, the DISCOVERs
    answered on the device, the partition, local-pool DORAs, the heal with
    NEXUS_CONFLICTS conflicts, and the losers' DISCOVERs. On the card
    (`card` set) it times each part, counts the launches and holds K1 on
    the last express dispatch; it returns what a CPU app must give too."""
    from bng_tpu_torch.control.cluster_http import ClusterServer
    from bng_tpu_torch.control.deviceauth import PSK_SIGNATURE_HEADER, PSK_TIMESTAMP_HEADER
    from bng_tpu_torch.control.resilience import PartitionState
    from bng_tpu_torch.utils.net import u32_to_ip

    clk = BeatClock(float(NOW))
    backend = NexusBackend(clk)
    srv = ClusterServer().mount_allocator(backend).start()
    srv2 = None
    app = nexus_app(device, clk, srv.url)
    out, tm = {}, {}
    try:
        c = app.components
        sched, eng, dhcp, res = c["scheduler"], c["engine"], c["dhcp"], c["resilience"]
        da = c["deviceauth"]
        hdr = da.http_headers()
        da.verify_signature(hdr["X-Device-ID"], hdr[PSK_TIMESTAMP_HEADER],
                            hdr[PSK_SIGNATURE_HEADER])
        check(da.mode.value == "psk" and da.authenticate().success,
              "nexus: PSK device authentication built from the key file, its signature verifies")
        fleet_storm(app, clk, 1_000_000, FLEET_WARM)  # the express graph, first batches
        obs0 = observed(sched)
        reset_launches()
        t0 = time.perf_counter()
        _tx, acks = fleet_storm(app, clk, 0, NEXUS_CLIENTS)
        tm["storm"] = time.perf_counter() - t0
        central = {m: backend.lookup(m.hex()) for m in acks}
        check(len(acks) == NEXUS_CLIENTS and all(central[m] == u32_to_ip(ip)
                                                 for m, ip in acks.items()),
              f"nexus: every yiaddr of the {NEXUS_CLIENTS}-client storm is the Nexus's answer "
              f"({len(acks)} ACKs, {sum(central[m] == u32_to_ip(ip) for m, ip in acks.items())} "
              f"Nexus answers)")
        out["acks"] = sorted(acks.items())
        ship_fastpath(app, clk, client_mac(0))
        macs = [client_mac(k) for k in range(NEXUS_CLIENTS)]
        offers, on_dev, slow = rediscover(app, clk, macs)
        check(on_dev == NEXUS_CLIENTS and slow == 0 and offers == acks,
              f"nexus: every client's next DISCOVER answered on the device with its Nexus "
              f"yiaddr ({on_dev} on the device, {slow} by the slow path)")

        # the Nexus goes away: the FSM partitions within its threshold ticks
        srv.close()
        t_close, ticks, t0 = clk.t, 0, time.perf_counter()
        while res.state != PartitionState.PARTITIONED:
            clk.t = float(int(clk.t) + 1)
            app.tick(clk.t)
            ticks += 1
            check(ticks <= NEXUS_TICKS, f"nexus: PARTITIONED within {NEXUS_TICKS} ticks")
        tm["detect_wall"] = time.perf_counter() - t0
        out["detect"] = (ticks, clk.t - t_close, res.events.partitions)
        check(res.failure_threshold == 3 and res.check_interval_s == 5.0
              and clk.t - t_close <= res.failure_threshold * res.check_interval_s,
              f"nexus: PARTITIONED after {ticks} ticks, {clk.t - t_close:.0f} s of the app "
              f"clock (threshold {res.failure_threshold} x {res.check_interval_s} s)")
        calls0 = backend.calls
        t0 = time.perf_counter()
        _tx, part = fleet_storm(app, clk, NEXUS_CLIENTS, NEXUS_PART)
        tm["part"] = time.perf_counter() - t0
        check(len(part) == NEXUS_PART and backend.calls == calls0
              and res.conflicts.count == NEXUS_PART and res.state == PartitionState.PARTITIONED,
              f"nexus: {NEXUS_PART} clients leased from the local pool while partitioned, no "
              f"Nexus call, each recorded ({len(part)}, {backend.calls - calls0} calls, "
              f"{res.conflicts.count} recorded)")
        out["part"] = sorted(part.items())

        # the heal: another node claimed NEXUS_CONFLICTS of those addresses earlier
        pmacs = sorted(part)
        losers = pmacs[::NEXUS_PART // NEXUS_CONFLICTS][:NEXUS_CONFLICTS]
        for k, m in enumerate(losers):
            backend.claim(u32_to_ip(part[m]), f"other-{k}", clk.t - 9999.0, node="bng-other")
        srv2 = ClusterServer(srv.host, srv.port).mount_allocator(backend).start()
        states, t_heal = [], 0.0
        for _ in range(NEXUS_TICKS):
            clk.t = float(int(clk.t) + 1)
            t0 = time.perf_counter()
            app.tick(clk.t)
            dt = time.perf_counter() - t0
            states.append(res.state.value)
            if res.state == PartitionState.NORMAL:
                t_heal = dt  # the tick that probed, reconciled and renumbered
                break
        tm["heal"] = t_heal
        ev = dict(vars(res.events))
        out["heal"] = (states, ev)
        check(res.state == PartitionState.NORMAL and ev["conflicts_found"] == NEXUS_CONFLICTS
              and ev["renumbered"] == NEXUS_CONFLICTS,
              f"nexus: the heal found {NEXUS_CONFLICTS} conflicts and renumbered "
              f"{NEXUS_CONFLICTS} ({ev})")
        check(all(eng.fastpath.get_subscriber(m) is None for m in losers)
              and all(eng.fastpath.get_subscriber(m) is not None for m in pmacs
                      if m not in losers), "nexus: the losers' host fast-path rows are gone")
        ship_fastpath(app, clk, client_mac(0))
        out["words"] = host_words(eng.tables).dhcp
        keep = [m for m in pmacs if m not in losers]
        offers, on_dev, slow = rediscover(app, clk, losers + keep)
        check(on_dev == NEXUS_PART - NEXUS_CONFLICTS and slow == NEXUS_CONFLICTS
              and all(offers[m] == part[m] for m in keep) and len(offers) == NEXUS_PART,
              f"nexus: the losers' DISCOVERs punt to the slow path, the other "
              f"{NEXUS_PART - NEXUS_CONFLICTS} are answered on the device ({on_dev} on the "
              f"device, {slow} slow)")
        out["renumbered"] = sorted((m, offers[m]) for m in losers)
        launches = launch_counts()
        out["stats"] = app.stats()["resilience"]
        if card is not None:
            launches_of(sched, obs0, launches, "run_nexus", 9, bulk=False)
            # K1 on the path's own last express dispatch: the program's
            # buffers still hold its descriptors, `now` and tables
            prog = eng.express_aot(sched.express.cfg.batch, sched._express_dev)
            check(prog is not None and prog.graph is not None,
                  "nexus: the scheduler's captured express program")
            rec = record_kernel_inputs(prog._run, 3, 0, "nexus express dispatch",
                                       table_names(eng.tables))
            probes_vs_plain([("nexus express", a) for a in rec["probe"]], err)
            out["launches"], out["times"] = launches, tm
        return out
    finally:
        app.close()
        srv.close()
        if srv2 is not None:
            srv2.close()


def degraded_auth_phase(device, card) -> None:
    """RADIUS down behind a Nexus app: a subscriber accepted before is
    served from the cached profile, a REJECT never is, a new one gets no
    lease."""
    from bng_tpu_torch.control.cluster_http import ClusterServer

    clk = BeatClock(float(NOW))
    backend = NexusBackend(clk)
    srv = ClusterServer().mount_allocator(backend).start()
    secret = b"smoke-secret"
    peer = RadiusPeer(secret, {"": {"password": b"", "policy": "residential-100mbps"}})
    app = None
    try:
        app = nexus_app(device, clk, srv.url, lease_time=300,
                        radius_server=f"127.0.0.1:{peer.auth_port}",
                        radius_secret=secret.decode())
        c = app.components
        c["radius"].servers[0].acct_port = peer.acct_port
        c["radius"].servers[0].timeout_s, c["radius"].servers[0].retries = 0.05, 1
        cache = c["resilience"].radius_handler
        a, b, new = (client_mac(0x900000 + k) for k in range(3))

        def dora(m, xid):
            got = dhcp_replies(serve_frames(app, clk, [F.discover_frame(m, xid, pad=320)]))
            offer = [ip for t, mm, ip in got if t == F.OFFER and mm == m]
            if not offer:
                return None
            got = dhcp_replies(serve_frames(app, clk, [storm_request(m, xid + 1, offer[0])]))
            return [t for t, mm, _ in got if mm == m]

        check(dora(a, 0x9300) == [F.ACK] and dora(b, 0x9310) == [F.ACK],
              "degraded auth: two subscribers accepted (their profiles cached)")
        clk.t += 400.0
        app.tick(clk.t)
        check(not c["dhcp"].leases, "degraded auth: the leases expired")
        peer.users[""]["password"] = b"no longer"  # a real REJECT for everyone
        rejected = dora(b, 0x9320)
        peer.close()  # every server times out from here on
        t0 = time.perf_counter()
        served = dora(a, 0x9330)
        dt = time.perf_counter() - t0
        fresh = dora(new, 0x9340)
        check(rejected != [F.ACK] and served == [F.ACK] and fresh != [F.ACK]
              and cache.stats["cache_hits"] == 1,
              f"degraded auth: a REJECT is not served from the cache ({rejected}), the cached "
              f"profile serves a known subscriber ({served}), a new one gets none ({fresh}; "
              f"{cache.stats})")
        say(f"degraded auth (RADIUS stopped, Nexus up): the cached profile served a known "
            f"subscriber's DORA in {dt:.3f}s (timeouts of 0.05 s included), a REJECT and a new "
            f"subscriber refused [{card}]")
    finally:
        if app is not None:
            app.close()
        peer.close()
        srv.close()


def mtls_app_phase(device, card) -> None:
    """With openssl on the host, `run --device-auth-method mtls` builds on
    the card from a certificate made now."""
    from bng_tpu_torch.control.cluster_http import ClusterServer

    tmp = tempfile.mkdtemp(prefix="bng-mtls-")
    try:
        tls = ha_certs(tmp)
        if tls is None:
            say("nexus: openssl is not on this host: no mTLS app")
            return
        clk = BeatClock(float(NOW))
        srv = ClusterServer().mount_allocator(NexusBackend(clk)).start()
        try:
            app = nexus_app(device, clk, srv.url, auth="mtls", device_auth_cert=tls["cert"],
                            device_auth_key=tls["key"])
            try:
                da = app.components["deviceauth"]
                check(da.mode.value == "mtls" and da.authenticate().success
                      and da.identity.device_id == "dev-cluster-bng-test"
                      and app.components["engine"].device.type == device.type,
                      f"nexus: the mTLS app built on the card ({da.identity})")
                say(f"nexus: an mTLS app built on the card (device {da.identity.device_id}, "
                    f"certificate fingerprint {da.fingerprint[:16]}...)")
            finally:
                app.close()
        finally:
            srv.close()
    finally:
        subprocess.run(["rm", "-rf", tmp], check=False)


def nexus_fleet_runs(device, card) -> tuple[dict, dict]:
    """`run --slowpath-workers 4` in Nexus mode, inline and spawned: a storm
    of 8,192 new clients each; returns ({name: DORAs/s}, the inline run's
    launches)."""
    from bng_tpu_torch.control.cluster_http import ClusterServer
    from bng_tpu_torch.utils.net import u32_to_ip

    rates, launches = {}, {}
    for mode in ("inline", "process"):
        clk = BeatClock(float(NOW))
        backend = NexusBackend(clk)
        srv = ClusterServer().mount_allocator(backend).start()
        app = nexus_app(device, clk, srv.url, workers=4, mode=mode)
        try:
            c = app.components
            check(c["fleet"].spec.nexus_url == srv.url and c["fleet"].spec.nexus_node_id == "bng0",
                  "nexus fleet: the spec carries the Nexus")
            if mode == "inline":
                check([w.nexus.node_id for w in c["fleet"]._inline]
                      == [f"bng0-w{i}" for i in range(4)], "nexus fleet: one allocator a worker")
            fleet_storm(app, clk, 1_000_000, FLEET_WARM)
            obs0, calls0 = observed(c["scheduler"]), backend.calls
            reset_launches()
            t0 = time.perf_counter()
            _tx, acks = fleet_storm(app, clk, 0, NEXUS_CLIENTS)
            dt = time.perf_counter() - t0
            got = launch_counts()
            snap = c["fleet"].stats_snapshot()
            central = sum(backend.lookup(m.hex()) == u32_to_ip(ip) for m, ip in acks.items())
            check(len(acks) == NEXUS_CLIENTS and len(set(acks.values())) == NEXUS_CLIENTS
                  and backend.calls - calls0 >= NEXUS_CLIENTS and central > 0
                  and snap["worker_failures"] == 0,
                  f"nexus fleet 4 {mode}: {NEXUS_CLIENTS} unique ACKs, a Nexus call for each "
                  f"new client ({len(acks)}, {backend.calls - calls0} calls, {central} Nexus "
                  f"answers, {snap['worker_failures']} failures)")
            if card is not None:
                launches_of(c["scheduler"], obs0, got, f"fleet_nexus 4 {mode}", 9, bulk=False)
            rates[f"4 {mode}"] = NEXUS_CLIENTS / dt
            if mode == "inline":
                launches = got
            say(f"nexus fleet 4 {mode}: {NEXUS_CLIENTS} DORAs in {dt:.3f}s, "
                f"{NEXUS_CLIENTS / dt:.1f} DORAs/s; {central} yiaddrs are the Nexus's answer (the "
                f"rest fall outside the answering worker's lease slice and come from it); "
                f"{backend.calls - calls0} Nexus calls; launches {got} [{card}]")
        finally:
            app.close()
            srv.close()
    return rates, launches


def nexus_phases(card, device, err) -> dict:
    """Phase 49: `run --nexus-url` on the card; returns {"run_nexus": ...,
    "fleet_nexus": ...}."""
    got = nexus_drive(device, card, err)
    tm = got.pop("times")
    launches = got.pop("launches")
    t0 = time.perf_counter()
    ref = nexus_drive("cpu", None, err)
    words_equal(got.pop("words"), ref.pop("words"), "nexus: the card's fast-path tables after "
                                                    "the heal == the CPU app's", "dhcp")
    check(got == ref, "nexus: the card's storm, partition, heal and renumbered OFFERs == the "
                      "CPU app's under the same drive")
    say(f"nexus: the same drive on a CPU app gave the card's ACKs, states, conflicts and table "
        f"words ({time.perf_counter() - t0:.1f}s)")
    ticks, detect_s, _ = got["detect"]
    states, ev = got["heal"]
    say(f"nexus run: {NEXUS_CLIENTS} Nexus-first DORAs in {tm['storm']:.3f}s "
        f"({NEXUS_CLIENTS / tm['storm']:.1f} DORAs/s), each next DISCOVER answered on the "
        f"device; PARTITIONED after {ticks} ticks ({detect_s:.0f} s of the app clock; those "
        f"ticks took {tm['detect_wall']:.3f} s of wall time, the failed probes' timeouts "
        f"included); {NEXUS_PART} local-pool DORAs "
        f"in {tm['part']:.3f}s ({NEXUS_PART / tm['part']:.1f} DORAs/s); the heal's tick "
        f"{tm['heal']:.3f}s ({ev['conflicts_found']} conflicts, {ev['renumbered']} renumbered, "
        f"states {states}); launches {launches}; K1 bit-equal to its plain version on the last "
        f"express dispatch's 3 calls [{card}]")
    degraded_auth_phase(device, card)
    mtls_app_phase(device, card)
    rates, fleet_launches = nexus_fleet_runs(device, card)
    base = FLEET_RATES or {}
    print(f"nexus DORAs/s: run 1 worker {NEXUS_CLIENTS / tm['storm']:.1f} with the Nexus "
          f"(phase 44's 1 worker without it: {base.get('1 worker', float('nan')):.1f}); "
          f"partitioned local pool {NEXUS_PART / tm['part']:.1f}; fleet 4 inline "
          f"{rates['4 inline']:.1f} (without: {base.get('4 inline', float('nan')):.1f}), 4 "
          f"process {rates['4 process']:.1f} (without: {base.get('4 process', float('nan')):.1f});"
          f" partition detected after {ticks} ticks = {detect_s:.0f} s of the app clock "
          f"({tm['detect_wall']:.3f} s of wall time); heal reconcile {tm['heal']:.3f}s "
          f"[{card}]", flush=True)
    return {"run_nexus": launches, "fleet_nexus": fleet_launches}


# ------------------------------------------ DNS and the walled garden behind `run`

DNS_SUBS = 8192  # leased subscribers
DNS_GARDEN = 4096  # of them in the walled garden
DNS_RELEASE = 1024  # gardened subscribers released at the end
DNS_QUERIES = 10_000  # queries over the listener's socket
DNS_NAMES = 500  # distinct names among them
DNS_CLIENTS = 64  # loopback source addresses the queries come from
DNS_PRIMARY = ip_to_u32("1.1.1.1")  # the pools' DNS server (run's default)
PORTAL_IP = ip_to_u32("10.255.255.1")  # run's default portal
OTHER_IP = ip_to_u32("93.184.216.34")  # any other destination


class FakeUpstream:
    """A loopback UDP DNS upstream from the port's codec: an A record for
    every name, its address from the name's CRC."""

    def __init__(self):
        import socket
        import zlib

        from bng_tpu_torch.control import dns_wire
        from bng_tpu_torch.control.dns import Record, Response

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.2)
        self.addr = f"127.0.0.1:{self.sock.getsockname()[1]}"
        self.seen = 0
        self._run = True

        def serve():
            while self._run:
                try:
                    data, client = self.sock.recvfrom(4096)
                except OSError:
                    continue
                txid, q = dns_wire.decode_query(data)
                self.seen += 1
                resp = Response(query=q, answers=[Record(name=q.name, rtype=q.qtype, ttl=300,
                                                         ipv4=self.answer(q.name))])
                self.sock.sendto(dns_wire.encode_response(resp, txid), client)

        self.answer = lambda name: f"198.51.100.{zlib.crc32(name.encode()) % 254 + 1}"
        self._thread = threading.Thread(target=serve, daemon=True)
        self._thread.start()

    def close(self):
        self._run = False
        self._thread.join(timeout=2)
        self.sock.close()


def dns_app(device, clock, upstream: str):
    """`BNGApp` at `run`'s geometry (2^15 subscriber buckets, the walled
    garden and QoS on, the scheduler) with the DNS listener on a free
    loopback port forwarding to `upstream`, and metrics. NAT is off, as in
    phases 44 and 48: 8,192 leases outgrow the default NAT table."""
    from bng_tpu_torch.cli import BNGApp, BNGConfig

    cfg = BNGConfig(scheduler_enabled=True, dhcpv6_enabled=False, slaac_enabled=False,
                    coa_enabled=False, nat_enabled=False, dns_enabled=True,
                    dns_listen="127.0.0.1:0", dns_upstreams=[upstream])
    app = BNGApp(cfg, clock=clock, device=device)
    app.components["ring"] = PyRing(4 * FLEET_WAVE, 2048, 2 * FLEET_WAVE)
    return app


def gate_frames(acks, macs, kinds) -> list:
    """(kind, mac, frame) for each MAC and kind: "dns" (UDP to its DNS server
    on port 53), "portal" (TCP to the portal) and "other" (UDP elsewhere)."""
    out = []
    for k, m in enumerate(macs):
        ip = acks[m]
        for kind in kinds:
            if kind == "dns":
                f = F.udp_packet(m, AC_MAC, ip, DNS_PRIMARY, 20000 + k % 30000, 53, b"d" * 40)
            elif kind == "portal":
                f = F.tcp_packet(m, AC_MAC, ip, PORTAL_IP, 30000 + k % 30000, 80, b"GET /")
            else:
                f = F.udp_packet(m, AC_MAC, ip, OTHER_IP, 40000 + k % 20000, 4000, b"o" * 40)
            out.append((kind, m, f))
    return out


def gate_verdicts(app, frames) -> tuple[dict, dict]:
    """Submit the frames to the scheduler's bulk lane, retire them; returns
    ({(kind, mac): verdict}, the garden gate's stats delta)."""
    c = app.components
    sched, eng = c["scheduler"], c["engine"]
    g0 = eng.stats.garden.copy()
    for k, (kind, m, f) in enumerate(frames):
        check(sched.submit(f, from_access=True, tag=(kind, m, k)) == "bulk",
              "the data frames take the bulk lane")
    sched.flush()
    done = sched.drain_completions()
    check(len(done) == len(frames), f"every frame retired ({len(done)} of {len(frames)})")
    g = eng.stats.garden - g0
    return {(cmp.tag[0], cmp.tag[1]): cmp.verdict for cmp in done}, {
        "gated_drops": int(g[0]), "allowed_hits": int(g[1])}


def dns_phases(card, device, err) -> dict:
    """Phase 50: DNS and the walled garden in `run` on the card; returns
    {"run_dns": launches}."""
    import socket
    import urllib.request

    from bng_tpu_torch.control import dns_wire
    from bng_tpu_torch.control.dns import Query
    from bng_tpu_torch.utils.net import u32_to_ip

    up = FakeUpstream()
    clk = BeatClock(float(NOW))
    app = dns_app(device, clk, up.addr)
    try:
        c = app.components
        sched, eng, garden, resolver = (c["scheduler"], c["engine"], c["walledgarden"],
                                        c["dns_resolver"])
        check(eng.fastpath.sub.nbuckets == 1 << 15 and eng.garden is not None
              and c["qos"] is not None, "dns: run's geometry (2^15 buckets, garden and QoS on)")
        _tx, acks = fleet_storm(app, clk, 0, DNS_SUBS)
        check(len(acks) == DNS_SUBS, f"dns: {DNS_SUBS} subscribers leased ({len(acks)})")
        macs = [client_mac(k) for k in range(DNS_SUBS)]
        gardened, provisioned = macs[:DNS_GARDEN], macs[DNS_GARDEN:]
        t0 = time.perf_counter()
        for m in gardened:
            garden.add_to_walled_garden(m)
        for m in provisioned:
            garden.release_from_walled_garden(m)
        t_garden = time.perf_counter() - t0
        steps = drain_tables(app, clk)
        ship_fastpath(app, clk, macs[-1])
        g_ips = {u32_to_ip(acks[m]) for m in gardened}
        check(resolver._walled_clients == g_ips,
              f"dns: the resolver's client set == the {DNS_GARDEN} gardened leases "
              f"({len(resolver._walled_clients)})")

        # the bulk lane: the garden gate on the device
        frames = (gate_frames(acks, gardened, ("dns", "portal", "other"))
                  + gate_frames(acks, provisioned, ("other",)))
        obs0 = observed(sched)
        reset_launches()
        t0 = time.perf_counter()
        verdicts, gstats = gate_verdicts(app, frames)
        dt = time.perf_counter() - t0
        launches = launch_counts()
        n_ex, n_bulk = launches_of(sched, obs0, launches, "run_dns", 9)
        dropped = {key for key, v in verdicts.items() if v == "drop"}
        check(dropped == {("other", m) for m in gardened}
              and gstats == {"gated_drops": DNS_GARDEN, "allowed_hits": 2 * DNS_GARDEN},
              f"dns: the device drops exactly the gardened subscribers' frames to other "
              f"destinations and passes their DNS and portal frames and every provisioned frame "
              f"({len(dropped)} dropped, gate {gstats}, verdicts "
              f"{sorted(set(verdicts.values()))})")
        bulk_step_vs_plain(eng, [f for _k, _m, f in frames], clk, 9, "dns bulk", err)
        say(f"dns: {DNS_GARDEN} subscribers gardened and {DNS_SUBS - DNS_GARDEN} provisioned in "
            f"{t_garden:.3f}s, {steps} bulk steps shipped the rows; {len(frames)} frames in "
            f"{dt:.3f}s through {n_bulk} bulk steps: {len(dropped)} dropped by the gate, "
            f"{gstats['allowed_hits']} gardened DNS and portal frames passed, verdicts "
            f"{ {v: sum(1 for x in verdicts.values() if x == v) for v in set(verdicts.values())} }"
            f"; launches {launches}; K1 and K2 bit-equal to their plain versions on one bulk "
            f"step's 9 + 4 calls [{card}]")

        # the resolver: gardened leases get the portal, everyone else the upstream
        names = [f"host{k}.example.com" for k in range(DNS_NAMES)]
        check(all(resolver.resolve(Query(name=names[k % DNS_NAMES], source=ip)).answers[0].ipv4
                  == "10.255.255.1" for k, ip in enumerate(sorted(g_ips))),
              "dns: every gardened lease resolves to the portal")
        prov = [u32_to_ip(acks[m]) for m in provisioned[:256]]
        check(all(resolver.resolve(Query(name=names[k % DNS_NAMES], source=ip)).answers[0].ipv4
                  == up.answer(names[k % DNS_NAMES]) for k, ip in enumerate(prov)),
              "dns: provisioned leases get the upstream's answers")
        # names no check above resolved, so the window's first query of
        # each goes upstream; DNS_CLIENTS loopback sources, so no one client passes the
        # resolver's per-client rate limit (run's default, 100 qps, burst 200)
        qnames = [f"q{k}.example.net" for k in range(DNS_NAMES)]
        srv_addr = c["dns_server"].addr
        clients = []
        for i in range(DNS_CLIENTS):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.settimeout(5.0)
            s.bind((f"127.0.1.{i + 1}", 0))
            clients.append(s)
        cl = clients[0]
        stats0, rtt = resolver.stats(), []
        try:
            t0 = time.perf_counter()
            for k in range(DNS_QUERIES):
                name, cl = qnames[(k * 7919) % DNS_NAMES], clients[k % DNS_CLIENTS]
                t1 = time.perf_counter()
                cl.sendto(dns_wire.encode_query(Query(name=name), k & 0xFFFF), srv_addr)
                data, _ = cl.recvfrom(4096)
                rtt.append(time.perf_counter() - t1)
                txid, _q, resp = dns_wire.decode_response(data)
                check(txid == k & 0xFFFF and resp.answers and resp.answers[0].ipv4
                      == up.answer(name), f"dns: query {k} answered by the upstream's record")
            t_q = time.perf_counter() - t0
            # a loopback client gardened: the portal for any name over the socket
            resolver.add_walled_garden_client("127.0.1.1")
            clients[0].sendto(dns_wire.encode_query(Query(name="anything.example.org"), 1),
                              srv_addr)
            _t, _q, resp = dns_wire.decode_response(clients[0].recvfrom(4096)[0])
            resolver.remove_walled_garden_client("127.0.1.1")
            check(resp.answers[0].ipv4 == "10.255.255.1",
                  "dns: a gardened client gets the portal over the socket")
        finally:
            for s in clients:
                s.close()
        st = resolver.stats()
        hits = st["cache_hits"] - stats0["cache_hits"]
        qs = st["queries"] - stats0["queries"] - 1
        rtt_ms = np.array(rtt) * 1e3
        port = c["collector"].serve_http(0)
        c["collector"].collect_once()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            expo = exposition_samples(r.read().decode())
        served = int(float(expo.get('bng_dns_queries_total{outcome="served"}', "0")))
        check(served >= DNS_QUERIES and "bng_dns_cache_hit_rate" in expo,
              f"dns: collect_dns exposes bng_dns_* on /metrics ({served} served)")
        print(f"dns: {DNS_QUERIES} queries over the socket in {t_q:.3f}s, "
              f"{DNS_QUERIES / t_q:.1f} queries/s, p50 {np.percentile(rtt_ms, 50):.3f} ms, p99 "
              f"{np.percentile(rtt_ms, 99):.3f} ms, cache hit rate {hits / qs:.4f} "
              f"({DNS_NAMES} names from {DNS_CLIENTS} clients, {up.seen} upstream queries, "
              f"{st['rate_limited'] - stats0['rate_limited']} rate-limited) [{card}]", flush=True)

        # release DNS_RELEASE of the garden: the device passes them, the
        # resolver forwards their queries
        rel = gardened[:DNS_RELEASE]
        for m in rel:
            garden.release_from_walled_garden(m)
        drain_tables(app, clk)
        verdicts, gstats = gate_verdicts(app, gate_frames(acks, rel, ("other",)))
        check(all(v != "drop" for v in verdicts.values()) and gstats["gated_drops"] == 0,
              f"dns: the released subscribers' frames pass the device ({gstats})")
        check(all(resolver.resolve(Query(name=names[k % DNS_NAMES],
                                         source=u32_to_ip(acks[m]))).answers[0].ipv4
                  == up.answer(names[k % DNS_NAMES]) for k, m in enumerate(rel))
              and len(resolver._walled_clients) == DNS_GARDEN - DNS_RELEASE,
              "dns: the released subscribers' queries are forwarded upstream")
        say(f"dns: {DNS_RELEASE} subscribers released from the garden: their frames pass the "
            f"device, their queries go upstream; {len(resolver._walled_clients)} remain "
            f"gardened [{card}]")
        return {"run_dns": launches}
    finally:
        app.close()
        up.close()


# ------------------------------------------------ the AF_XDP wire (phases 51-54)

WIRE_HEADROOM = 256  # copy-mode chunk headroom: the kernel writes frames at base + 256
WIRE_PUMPS = ("scalar", "vector")
WIRE_BATCHES = 6  # headline batches through the wire under each pump (phase 52)
WIRE_CLIENT = bytes.fromhex("02c0ffee0001")  # phase 51's DORA client
WIRE_NAT_SUB = ip_to_u32("10.0.0.55")  # phase 51's NAT subscriber
WIRE_QOS_SUB = ip_to_u32("10.0.0.60")  # phase 51's shaped subscriber (1,500-byte buckets)
WIRE_PUB = ip_to_u32("203.0.113.1")  # phase 51's one public address
VETH = ("bngsm0", "bngsm1")  # phase 54's live pair: the BNG's end, the far end


class WireSess:
    """Phase 51's PPPoE session (tests/test_wire_pump.py's)."""

    session_id = 0x0042
    client_mac = bytes.fromhex("02c0ffee0101")
    assigned_ip = ip_to_u32("10.0.0.50")


def wire_stack(device):
    """tests/test_wire_pump.py's serving stack on `device`: DHCP, NAT44,
    QoS and PPPoE behind one Engine (batch 8), on a held clock."""
    clock = BeatClock(float(NOW))
    fastpath = FastPathTables(sub_nbuckets=512, vlan_nbuckets=64, cid_nbuckets=64, max_pools=16)
    fastpath.set_server_config(AC_MAC, SERVER_IP)
    pools = PoolManager(fastpath)
    pools.add_pool(Pool(pool_id=1, network=ip_to_u32("10.0.0.0"), prefix_len=24,
                        gateway=SERVER_IP, dns_primary=ip_to_u32("1.1.1.1"), lease_time=3600))
    nat = NATManager(public_ips=[WIRE_PUB], sessions_nbuckets=256, sub_nat_nbuckets=64)
    qos = QoSTables(nbuckets=256)
    pp = PPPoEFastPathTables(nbuckets=64, stash=8, server_mac=AC_MAC)
    server = DHCPServer(AC_MAC, SERVER_IP, pools, fastpath_tables=fastpath, clock=clock)
    eng = Engine(fastpath, nat, qos, pppoe=pp, batch_size=8, slow_path=server.handle_frame,
                 clock=clock, device=device)
    pp.session_up(WireSess())
    for ip in (WireSess.assigned_ip, WIRE_NAT_SUB, WIRE_QOS_SUB):
        nat.allocate_nat(ip, NOW)
    qos.set_subscriber(WIRE_QOS_SUB, down_bps=8000, up_bps=8000, up_burst=1500, down_burst=1500)
    return eng


def wire_dhcp(msg_type, xid: int, **kw) -> bytes:
    p = F.build_request(WIRE_CLIENT, msg_type, xid=xid, **kw)
    p.options.append((F.OPT_PARAM_REQ_LIST, bytes([1, 3, 6, 51, 54])))
    return F.udp_packet(WIRE_CLIENT, b"\xff" * 6, 0, 0xFFFFFFFF, 68, 67,
                        p.encode().ljust(320, b"\x00"))


def wire_frames() -> dict:
    """The data frames of the four scenarios."""
    from bng_tpu_torch.ops.pppoe import PPP_IPV4

    inner = F.udp_packet(WireSess.client_mac, AC_MAC, WireSess.assigned_ip,
                         ip_to_u32("8.8.8.8"), 40000, 53, b"q" * 32)[14:]
    sess = pppoe_codec.PPPoEPacket(code=0, session_id=WireSess.session_id,
                                   payload=pppoe_codec.ppp_frame(PPP_IPV4, inner)).encode()
    return {"nat": F.udp_packet(bytes.fromhex("02c0ffee0010"), AC_MAC, WIRE_NAT_SUB,
                                ip_to_u32("93.184.216.34"), 40000, 443, b"nat-payload"),
            "qos": F.udp_packet(bytes.fromhex("02c0ffee0020"), AC_MAC, WIRE_QOS_SUB,
                                ip_to_u32("8.8.8.8"), 1111, 9999, b"x" * 400),
            "pppoe": pppoe_codec.eth_frame(AC_MAC, WireSess.client_mac,
                                           pppoe_codec.ETH_PPPOE_SESSION, sess)}


def wire_scenarios(eng, roundtrip) -> dict:
    """The four scenarios of tests/test_wire_pump.py through
    `roundtrip(frames) -> far-end egress`: DORA (the second DISCOVER
    answered on the device), a NAT flow's punt then its SNAT, an
    established shaped flow's QoS drops, PPPoE session data's punt then
    decap + SNAT. Returns {scenario: egress frames}, every outcome checked."""
    fr = wire_frames()
    offers = roundtrip([wire_dhcp(F.DISCOVER, 0x11)])
    check(len(offers) == 1, f"wire DORA: one OFFER egressed ({len(offers)})")
    offer = F.decode_dhcp(F.decode(offers[0]).payload)
    check(offer.msg_type == F.OFFER, "wire DORA: the reply is an OFFER")
    acks = roundtrip([wire_dhcp(F.REQUEST, 0x12, requested_ip=offer.yiaddr,
                                server_id=SERVER_IP)])
    check(len(acks) == 1 and F.decode_dhcp(F.decode(acks[0]).payload).msg_type == F.ACK,
          "wire DORA: the REQUEST's ACK egressed")
    tx0 = int(eng.stats.tx)
    offers2 = roundtrip([wire_dhcp(F.DISCOVER, 0x13)])
    check(len(offers2) == 1 and int(eng.stats.tx) == tx0 + 1,
          "wire DORA: the leased client's next DISCOVER answered on the device")
    check(roundtrip([fr["nat"]]) == [], "wire NAT: a new flow's first frame punts (no egress)")
    natted = roundtrip([fr["nat"]])
    check(len(natted) == 1 and F.decode(natted[0]).src_ip == WIRE_PUB,
          "wire NAT: the flow's next frame SNATs on the device")
    check(roundtrip([fr["qos"]]) == [], "wire QoS: the shaped flow's first frame punts")
    d0 = int(eng.stats.dropped)
    shaped = roundtrip([fr["qos"]] * 4)
    dropped = int(eng.stats.dropped) - d0
    check(dropped >= 1 and len(shaped) == 4 - dropped,
          f"wire QoS: the 1,500-byte bucket drops {dropped} of 4 on the device")
    check(roundtrip([fr["pppoe"]]) == [], "wire PPPoE: the session's first data frame punts")
    fwd = roundtrip([fr["pppoe"]])
    d = F.decode(fwd[0]) if len(fwd) == 1 else None
    check(d is not None and d.ethertype == 0x0800 and d.src_ip == WIRE_PUB,
          "wire PPPoE: the next frame decaps and SNATs on the device")
    return {"dora": offers + acks + offers2, "nat": natted, "qos": shaped, "pppoe": fwd}


def sim_wire(path: str, nframes: int = 256, ring_size: int = 128):
    """A NativeRing with SimKernelRings (the memory rung's kernel) and a
    WirePump of `path` over it."""
    from bng_tpu_torch.runtime import xsk

    ring = ring_mod.NativeRing(nframes=nframes, frame_size=2048, depth=max(64, nframes // 2))
    kern = xsk.SimKernelRings(ring, headroom=WIRE_HEADROOM, ring_size=ring_size)
    return ring, kern, xsk.WirePump(ring, kern, path=path)


def sim_roundtrip(eng, ring, kern, pump, rounds: int = 6):
    def roundtrip(frames):
        kern.inject_many(frames)
        got = []
        for _ in range(rounds):
            pump.pump(budget=16)
            kern.deliver()
            eng.process_ring_pipelined(ring)
            eng.flush_pipeline(ring)
            pump.pump(budget=16)
            got.extend(kern.drain_egress())
        return got
    return roundtrip


@contextlib.contextmanager
def count_dispatches(eng):
    """{"fused": steps, "dhcp": DHCP-only batches} the engine dispatched in
    the block: each drains once before it issues or replays its program."""
    n = {"fused": 0, "dhcp": 0}
    saved = {}
    for name, kind in (("_drain_step", "fused"), ("_drain_dhcp", "dhcp")):
        orig = saved[name] = getattr(eng, name)

        def counted(*a, _orig=orig, _kind=kind, **kw):
            n[_kind] += 1
            return _orig(*a, **kw)
        setattr(eng, name, counted)
    try:
        yield n
    finally:
        for name in saved:
            delattr(eng, name)


def wire_scenario_phase(card, device, err) -> tuple[dict, dict]:
    """Phase 51: the four scenarios through SimKernelRings -> WirePump ->
    NativeRing -> process_ring_pipelined -> pump -> far end, on the card
    under both pumps and once on a CPU engine: the far-end bytes equal.
    Returns ({"wire_scenarios": launches}, the card's egress)."""
    outs, per = {}, {}
    reset_launches()
    for path in WIRE_PUMPS:
        eng = wire_stack(device)
        ring, kern, pump = sim_wire(path)
        rt = sim_roundtrip(eng, ring, kern, pump)
        with count_dispatches(eng) as n:
            outs[path] = wire_scenarios(eng, rt)
        per[path] = dict(n)
        st = pump.pump_stats
        check(pump.last_path == path and st["rx_submit_fail"] == 0 and st["tx_overflow"] == 0,
              f"wire {path} pump: ran its own path, no failed submit, no overflow ({st})")
        ring.close()
    launches = launch_counts()
    check(outs["scalar"] == outs["vector"], "wire: far-end bytes equal across the two pumps")
    fused = sum(p["fused"] for p in per.values())
    dhcp = sum(p["dhcp"] for p in per.values())
    # one step's kernel calls from the wire path, held against the plain versions
    eng = wire_stack(device)
    ring, kern, pump = sim_wire("vector")
    rt = sim_roundtrip(eng, ring, kern, pump)
    fr = wire_frames()
    check(rt([fr["qos"]]) == [], "wire QoS punt (recorded run)")
    rec = record_kernel_inputs(lambda: rt([fr["qos"]] * 4), None, 0, "wire step")
    k1 = len(rec["probe"])
    check(k1 == 10 and len(rec["seg_prefix"]) == 4,
          f"wire step: 10 K1 (IPoE 8, PPPoE 2) and 4 K2 ({k1}, {len(rec['seg_prefix'])})")
    probes_vs_plain([("wire step", a) for a in rec["probe"]], err)
    segs_vs_plain([("wire step", *a) for a in rec["seg_prefix"]], err)
    ring.close()
    check(launches["probe"] == 10 * fused + 3 * dhcp and launches["seg_prefix"] == 4 * fused
          and launches["umem_gather"] == launches["umem_scatter"] == fused + dhcp,
          f"wire: 10 K1 + 4 K2 a fused step and 3 K1 a DHCP-only batch, every batch by "
          f"descriptor ({launches}; {fused} fused, {dhcp} DHCP-only)")
    # the same drive on a CPU engine
    eng = wire_stack("cpu")
    ring, kern, pump = sim_wire("scalar")
    cpu = wire_scenarios(eng, sim_roundtrip(eng, ring, kern, pump))
    ring.close()
    check(cpu == outs["scalar"], "wire: the card's far-end bytes == the CPU engine's")
    say(f"wire scenarios (DORA, NAT punt then SNAT, QoS drops, PPPoE decap + SNAT) through "
        f"SimKernelRings -> WirePump -> NativeRing -> process_ring_pipelined -> far end: "
        f"equal under the scalar and the vector pump and to a CPU engine; "
        f"{fused} fused steps and {dhcp} DHCP-only batches, launches {launches}; one step's "
        f"10 K1 and 4 K2 bit-equal to their plain versions [{card}]")
    return {"wire_scenarios": launches}, outs["scalar"]


def pop_egress(ring) -> list:
    out = []
    for pop in (ring.tx_pop, ring.fwd_pop):
        while (got := pop()) is not None:
            out.append(bytes(got[0]) if isinstance(got, tuple) else bytes(got))
    return out


def wire_headline_phase(eng, flows, card, err) -> dict:
    """Phase 52: the headline engine (1M subscribers, B = 8192) fed through
    the wire: 6 batches of the IPoE mix injected at the far end of
    SimKernelRings, pumped into a NativeRing, served by
    process_ring_pipelined and pumped back out, under each pump; beside
    them the same frames pushed into a NativeRing with no wire. Egress
    equal (the two pumps exactly, the no-wire run as a multiset: the wire
    interleaves TX and FWD), 8 K1 + 4 K2 a step, the first step's calls
    bit-equal to their plain versions; frames/s end to end and a traced
    run's split per batch."""
    from bng_tpu_torch.runtime import xsk

    rng = np.random.default_rng(52)
    batches = [make_batch(rng, flows)[0] for _ in range(WIRE_BATCHES)]
    n_frames = WIRE_BATCHES * B

    def ring_():
        return ring_mod.NativeRing(nframes=1 << 16, frame_size=2048, depth=1 << 15)

    def plain(t_base):
        ring, egress = ring_(), []
        t = time.perf_counter()
        for k, frames in enumerate(batches):
            check(ring.rx_push_batch(frames, from_access=True) == B, "no-wire push")
            eng.process_ring_pipelined(ring, now=t_base + k * 0.01)
            egress += pop_egress(ring)
        eng.flush_pipeline()
        egress += pop_egress(ring)
        secs = time.perf_counter() - t
        ring.close()
        return egress, secs, None

    def wire(path, t_base):
        ring = ring_()
        kern = xsk.SimKernelRings(ring, headroom=WIRE_HEADROOM, ring_size=1 << 15)
        pump = xsk.WirePump(ring, kern, path=path)
        pump.pump(budget=B)  # stock the kernel fill ring
        egress = []
        t = time.perf_counter()
        for k, frames in enumerate(batches):
            kern.inject_many(frames)  # the far end: delivered into the stocked frames
            pump.pump(budget=B)  # kernel RX -> ring, refill
            eng.process_ring_pipelined(ring, now=t_base + k * 0.01)
            pump.pump(budget=B)  # the retired batch's verdicts -> kernel TX
            egress += kern.drain_egress()
        eng.flush_pipeline()
        pump.pump(budget=B)
        egress += kern.drain_egress()
        secs = time.perf_counter() - t
        st = dict(pump.pump_stats)
        check(pump.last_path == path and st["rx"] == n_frames and st["rx_submit_fail"] == 0
              and st["tx_overflow"] == 0, f"wire {path}: every frame pumped in ({st})")
        ring.close()
        return egress, secs, st

    reset_launches()
    runs = {}
    with first_kernel_calls(8, 4) as rec:
        for i, name in enumerate(WIRE_PUMPS + ("no wire",)):
            t_base = NOW + 1000 * (i + 1)  # the QoS buckets refill between runs
            runs[name] = wire(name, t_base) if name in WIRE_PUMPS else plain(t_base)
    launches = launch_counts()
    check_launches(launches, 3 * WIRE_BATCHES, {"probe": 8, "seg_prefix": 4,
                                                "umem_gather": 1, "umem_scatter": 1},
                   "wire headline (every batch by descriptor)")
    held = first_calls_vs_plain(rec, "wire headline", err)
    check(runs["scalar"][0] == runs["vector"][0], "wire headline: egress equal across the pumps")
    check(sorted(runs["scalar"][0]) == sorted(runs["no wire"][0]) and runs["scalar"][0],
          "wire headline: the wire's egress == the no-wire ring's TX and FWD frames")
    eg = runs["scalar"][2]
    fps = {k: n_frames / v[1] for k, v in runs.items()}
    say(f"wire headline: {WIRE_BATCHES} batches of {B} (20% cached DISCOVERs, 80% flows) "
        f"through the wire, {len(runs['scalar'][0])} frames back out (pump stats {eg}); "
        f"frames/s end to end: scalar pump {fps['scalar']:.1f}, vector pump "
        f"{fps['vector']:.1f}, no wire {fps['no wire']:.1f} (wire/no wire "
        f"{fps['scalar'] / fps['no wire']:.3f} scalar, {fps['vector'] / fps['no wire']:.3f} "
        f"vector); launches {launches}; {held} [{card}]")
    # the split of a traced run of each (its own counts, not the path's)
    for name in WIRE_PUMPS:
        with tracer_armed() as tr:
            wire(name, NOW + 5000 + 1000 * WIRE_PUMPS.index(name))
        bd = tr.breakdown()
        part = {s: bd[s]["mean_us"] * bd[s]["count"] / 1e3 / WIRE_BATCHES
                for s in ("wire_rx", "ring", "dispatch", "device_wait", "reply", "wire_tx")
                if s in bd}
        say(f"wire headline split, {name} pump (traced, ms per batch of {B}): wire_rx "
            f"{part.get('wire_rx', 0):.3f}, assemble {part.get('ring', 0):.3f}, dispatch "
            f"{part.get('dispatch', 0):.3f}, wait {part.get('device_wait', 0):.3f}, demux "
            f"{part.get('reply', 0):.3f}, wire_tx {part.get('wire_tx', 0):.3f} [{card}]")
    return {"wire_headline": launches}


def veth_pair() -> str:
    """Make phase 54's veth pair, up; '' or what the host refused."""
    try:
        subprocess.run(["ip", "link", "del", VETH[0]], capture_output=True, timeout=30)
        r = subprocess.run(["ip", "link", "add", VETH[0], "type", "veth", "peer", "name",
                            VETH[1]], capture_output=True, text=True, timeout=30)
    except OSError as e:
        return f"no `ip` command ({e})"
    if r.returncode != 0:
        return f"ip link add refused: {r.stderr.strip()} (needs CAP_NET_ADMIN)"
    for i in VETH:
        subprocess.run(["ip", "link", "set", i, "up"], capture_output=True, timeout=30)
    time.sleep(0.3)  # carrier settle
    return ""


def wire_live(device, card, want: dict) -> bool:
    """The four scenarios over the copy rung on a veth pair: AF_XDP on the
    BNG's end, the redirect program through the kernel's verifier, frames
    injected and collected with AF_PACKET on the far end. Each scenario's
    reply must be phase 51's bytes. False (with the missing privilege
    printed) where the host cannot."""
    import socket as so

    from bng_tpu_torch.runtime import xdp_redirect, xsk

    why = ""
    if xsk.probe() == xsk.MODE_MEMORY:
        why = "no AF_XDP socket (needs CAP_NET_RAW and kernel support)"
    elif not xdp_redirect.probe():
        why = "no XDP program load (needs CAP_BPF or CAP_SYS_ADMIN)"
    else:
        why = veth_pair()
    if why:
        print(f"wire live rung: not run here: {why} [{card}]", flush=True)
        return False
    eng = wire_stack(device)
    ring = ring_mod.NativeRing(nframes=4096, frame_size=2048, depth=1024)
    att = xsk.open_wire(ring, ifname=VETH[0], queue=0, pump_path="vector")
    socks, redir = [], None
    try:
        if att.xsk is None:
            print(f"wire live rung: not run here: the attach landed on the {att.mode} rung "
                  f"({att.detail}) [{card}]", flush=True)
            return False
        check(att.mode == xsk.MODE_COPY, f"wire live: the veth binds the copy rung ({att.mode})")
        s = att.xsk
        redir = xdp_redirect.XdpRedirect(VETH[0], {0: s.fd})
        txs = so.socket(so.AF_PACKET, so.SOCK_RAW)
        txs.bind((VETH[1], 0))
        rxs = so.socket(so.AF_PACKET, so.SOCK_RAW, so.htons(0x0003))
        rxs.bind((VETH[1], 0))
        rxs.setblocking(False)
        socks = [txs, rxs]
        s.pump()  # stock the kernel fill ring

        def exchange(frames, want_n: int, deadline_s: float = 8.0):
            for f in frames:
                txs.send(f)
            got = []
            deadline = time.time() + deadline_s
            while time.time() < deadline and len(got) < want_n:
                s.pump(budget=64)
                eng.process_ring_pipelined(ring)
                eng.flush_pipeline(ring)
                s.pump(budget=64)
                while True:
                    try:
                        got.append(rxs.recv(4096))
                    except (BlockingIOError, OSError):
                        break
                time.sleep(0.01)
            return got

        fr = wire_frames()
        offer = F.decode_dhcp(F.decode(want["dora"][0]).payload)
        check(want["dora"][0] in exchange([wire_dhcp(F.DISCOVER, 0x11)], 1),
              "wire live: the OFFER is phase 51's bytes")
        check(want["dora"][1] in exchange([wire_dhcp(F.REQUEST, 0x12, requested_ip=offer.yiaddr,
                                                     server_id=SERVER_IP)], 1),
              "wire live: the ACK is phase 51's bytes")
        check(want["dora"][2] in exchange([wire_dhcp(F.DISCOVER, 0x13)], 1),
              "wire live: the device's OFFER is phase 51's bytes")
        check(want["nat"][0] not in exchange([fr["nat"]], 1, 2.0), "wire live: NAT punt")
        check(want["nat"][0] in exchange([fr["nat"]], 1), "wire live: the SNAT is phase 51's")
        exchange([fr["qos"]], 1, 2.0)
        got = exchange([fr["qos"]] * 4, len(want["qos"]))
        check(all(f in got for f in want["qos"]), "wire live: the QoS survivors are phase 51's")
        exchange([fr["pppoe"]], 1, 2.0)
        check(want["pppoe"][0] in exchange([fr["pppoe"]], 1),
              "wire live: the PPPoE decap + SNAT is phase 51's")
        st = s.pump_stats
        say(f"wire live rung: the four scenarios over AF_XDP copy mode on a veth pair "
            f"({VETH[0]}), the redirect program through the kernel's verifier: every reply "
            f"phase 51's bytes; pump stats {st} [{card}]")
        return True
    finally:
        for x in socks:
            x.close()
        if redir is not None:
            redir.close()
        if att.xsk is not None:
            att.xsk.close()
        ring.close()
        subprocess.run(["ip", "link", "del", VETH[0]], capture_output=True, timeout=30)


def run_wire_if_phase(card, device, want: dict) -> tuple[dict, bool]:
    """Phase 54: `run --wire-if` with an interface that does not exist lands
    on the memory rung loudly (the warning, the flight dump,
    bng_wire_rung{mode="memory"} 1), as a process and as an app on the
    card; then the live copy rung where the host allows it."""
    from bng_tpu_torch.cli import BNGApp, BNGConfig
    from bng_tpu_torch.telemetry import recorder as rec_mod

    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([sys.executable, "-m", "bng_tpu_torch", "run", "--once",
                            "--wire-if", "nosuchif0", "--telemetry-enabled", "--trace-dir", tmp],
                           capture_output=True, text=True, timeout=600, cwd=REPO)
        check(r.returncode == 0, f"run --wire-if nosuchif0: rc {r.returncode}\n{r.stderr[-1500:]}")
        check("FELL BACK to the memory rung" in r.stderr and "interface not found" in r.stderr,
              "run --wire-if nosuchif0: the memory-rung warning")
        dumps = [f for f in os.listdir(tmp) if rec_mod.TRIG_WIRE_FALLBACK in f]
        check(dumps, f"run --wire-if nosuchif0: a {rec_mod.TRIG_WIRE_FALLBACK} flight dump "
                     f"({os.listdir(tmp)})")
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        app = BNGApp(BNGConfig(wire_if="nosuchif0", telemetry_enabled=True, trace_dir=tmp,
                               metrics_port=0), device=device)
        try:
            c = app.components
            att = c["wire_attachment"]
            check(att.mode == "memory" and type(c["ring"]).__name__ == "NativeRing"
                  and c["telemetry"].recorder.triggers.get(rec_mod.TRIG_WIRE_FALLBACK) == 1,
                  f"run --wire-if app: memory rung over the native ring, one fallback dump "
                  f"({att})")
            for _ in range(4):
                app.drive_once()
            c["collector"].collect_once()
            lines = [ln for ln in c["metrics"].expose().splitlines()
                     if ln.startswith("bng_wire_")]
            check('bng_wire_rung{mode="memory"} 1' in lines
                  and 'bng_wire_rung{mode="copy"} 0' in lines,
                  f"run --wire-if app: /metrics pins the memory rung ({lines})")
            check(c["engine"].device.type == torch.device(device).type,
                  f"run --wire-if app: the engine on {device} ({c['engine'].device})")
        finally:
            app.close()
        launches = launch_counts()
    say(f"run --wire-if nosuchif0 on the card: the memory rung, loudly (the warning, a "
        f"{rec_mod.TRIG_WIRE_FALLBACK} flight dump, bng_wire_rung{{mode=\"memory\"}} 1); no "
        f"frame touched a wire, so none counts as wire serving [{card}]")
    live = wire_live(device, card, want)
    return {"run_wire_if": launches}, live


# ------------------------------------------------------ the cluster (phase 55)

CLUSTER_INSTANCES = 4
CLUSTER_SUBS = 8192  # the DORA wave through the front door


def cluster_wave_timed(mode: str) -> tuple[dict, float, dict]:
    """`cluster run`'s coordinator (its defaults: 10.0.0.0/10, one worker an
    instance, no fast-path table) with the wave timed."""
    from bng_tpu_torch.cli import _cluster_wave
    from bng_tpu_torch.cluster import ClusterCoordinator

    coord = ClusterCoordinator(mode=mode, space_network=ip_to_u32("10.0.0.0"),
                               space_prefix_len=10, fabric=(mode == "process"),
                               fabric_bind=("127.0.0.1", 0))
    try:
        coord.add_instances([f"bng-{i:02d}" for i in range(CLUSTER_INSTANCES)])
        coord.status()  # every member answers: a spawned child's start-up is not timed
        t = time.perf_counter()
        wave = _cluster_wave(coord, CLUSTER_SUBS)
        secs = time.perf_counter() - t
        return wave, secs, coord.status()
    finally:
        coord.close()


def cluster_failover_timed() -> dict:
    """An inline cluster on a simulated clock: a wave, a member killed, its
    standby promoted by ticks, the victim's subscribers re-DORA (renewals
    through the front door, each ACKed with its original address)."""
    from bng_tpu_torch.chaos.faults import SimClock
    from bng_tpu_torch.chaos.scenarios import _discover, _mac, _renew, _reply, _request
    from bng_tpu_torch.cluster import ClusterCoordinator, instance_for_mac

    clock = SimClock()
    coord = ClusterCoordinator(clock=clock, space_network=ip_to_u32("10.0.0.0"),
                               space_prefix_len=10)
    try:
        coord.add_instances([f"bng-{i:02d}" for i in range(CLUSTER_INSTANCES)])
        macs = [_mac(0x5000 + i) for i in range(CLUSTER_SUBS // 4)]
        leased = {}
        for k in range(0, len(macs), 512):
            chunk = macs[k:k + 512]
            out = coord.handle_batch([(i, _discover(m, 0x100 + k + i))
                                      for i, m in enumerate(chunk)], now=clock())
            offers = {m: _reply(rep).yiaddr for (_l, rep), m in zip(out, chunk) if rep}
            out = coord.handle_batch([(i, _request(m, offers[m], 0x200000 + k + i))
                                      for i, m in enumerate(offers)], now=clock())
            leased.update({m: _reply(rep).yiaddr for (_l, rep), m in zip(out, offers) if rep})
        check(len(leased) == len(macs), f"cluster failover: {len(macs)} leased ({len(leased)})")
        ids = coord.member_ids()
        victim = ids[1]
        victim_macs = [m for m in macs if instance_for_mac(m, ids) == victim]
        t0 = time.perf_counter()
        coord.kill_instance(victim)
        ticks = 0
        while coord.members[victim].role != "promoted" and ticks < 64:
            clock.advance(1.0)
            coord.tick()
            ticks += 1
        t1 = time.perf_counter()
        out = coord.handle_batch([(k, _renew(m, leased[m], 0x400000 + k))
                                  for k, m in enumerate(victim_macs)], now=clock())
        t2 = time.perf_counter()
        sticky = sum(1 for (_l, rep), m in zip(out, victim_macs)
                     if rep is not None and _reply(rep).yiaddr == leased[m])
        check(coord.members[victim].role == "promoted" and sticky == len(victim_macs) > 0,
              f"cluster failover: standby promoted, {sticky}/{len(victim_macs)} renewals ACKed "
              f"with their addresses")
        return {"victim_subs": len(victim_macs), "ticks": ticks, "promote_s": t1 - t0,
                "redora_s": t2 - t1, "sticky": sticky}
    finally:
        coord.close()


def cluster_phase(card) -> dict:
    """Phase 55: `cluster run --instances 4 --subscribers 8192 --once
    --checkpoint-out F` as a process with `--mode inline` and `--mode
    process`, `cluster status --from-checkpoint F`; the wave's DORAs/s and
    the failover's re-DORA time in-process. The cluster is host code: it
    launches no kernel (counts 0 before, read after)."""
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("inline", "process"):
            ck = os.path.join(tmp, f"{mode}.ckpt")
            t = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "bng_tpu_torch", "cluster", "run",
                                "--instances", str(CLUSTER_INSTANCES), "--subscribers",
                                str(CLUSTER_SUBS), "--once", "--mode", mode,
                                "--checkpoint-out", ck], capture_output=True, text=True,
                               timeout=600, cwd=REPO)
            secs = time.perf_counter() - t
            check(r.returncode == 0, f"cluster run --mode {mode}: rc {r.returncode}\n"
                                     f"{r.stderr[-1500:]}")
            out = json.loads(r.stdout)
            check(out["wave"] == {"subscribers": CLUSTER_SUBS, "leased": CLUSTER_SUBS,
                                  "unique_ips": CLUSTER_SUBS, "shed": 0, "ok": True},
                  f"cluster run --mode {mode}: every subscriber leased ({out['wave']})")
            st = subprocess.run([sys.executable, "-m", "bng_tpu_torch", "cluster", "status",
                                 "--from-checkpoint", ck], capture_output=True, text=True,
                                timeout=300, cwd=REPO)
            plan = json.loads(st.stdout) if st.returncode == 0 else {}
            check(plan.get("blocks") == CLUSTER_INSTANCES
                  and sorted(plan.get("members", {})) == sorted(out["status"]["members"]),
                  f"cluster status --from-checkpoint ({mode}): the carve plan ({st.stderr})")
            say(f"cluster run --mode {mode} --instances {CLUSTER_INSTANCES} --subscribers "
                f"{CLUSTER_SUBS} --once: rc 0 in {secs:.1f}s as a process, {CLUSTER_SUBS} "
                f"leased, {plan['addresses']} addresses carved; cluster status reads the plan "
                f"back [{card}]")
    rates = {}
    for mode in ("inline", "process"):
        wave, secs, status = cluster_wave_timed(mode)
        check(wave["ok"] and status["instances"] == CLUSTER_INSTANCES,
              f"cluster wave ({mode}): {wave}")
        rates[mode] = CLUSTER_SUBS / secs
    fo = cluster_failover_timed()
    launches = launch_counts()
    check(launches == {"probe": 0, "seg_prefix": 0, "umem_gather": 0, "umem_scatter": 0},
          f"cluster: host code, no kernel launched ({launches})")
    print(f"cluster: {CLUSTER_SUBS}-subscriber DORA wave through the front door of "
          f"{CLUSTER_INSTANCES} instances: {rates['inline']:.1f} DORAs/s inline, "
          f"{rates['process']:.1f} DORAs/s with one process an instance; failover: the standby "
          f"promoted after {fo['ticks']} ticks of 1 s ({fo['promote_s']:.3f} s of wall time), "
          f"the victim's {fo['victim_subs']} subscribers re-DORAed in {fo['redora_s']:.3f} s, "
          f"{fo['sticky']} ACKed with their addresses; no kernel launch (host code) [{card}]",
          flush=True)
    return {"cluster": launches}


# ------------------------------------------ QinQ, the NAT ALGs, host verbs

QINQ_SUBS = 8192  # subscribers known only by their S/C-tag pair
QINQ_NET = ip_to_u32("10.64.0.0")  # a /18: gateway .1, subscribers from .2
QINQ_ROUNDS = 5  # DISCOVER batches timed through each path
ALG_SUBS = 1024  # NAT subscribers sending one ALG control packet each (one batch)
ALG_NET = ip_to_u32("10.80.0.0")
ALG_SERVER = ip_to_u32("198.51.100.7")  # the FTP and SIP server
ALG_PUBLIC = [ip_to_u32("203.0.113.1"), ip_to_u32("203.0.113.2")]
ALG_KINDS = ("PORT", "EPRT", "PASV", "INVITE")  # lane i sends ALG_KINDS[i % 4]
VERB_DEMO_SUBS = 8


def qinq_pair(i: int) -> tuple[int, int]:
    return 100 + i // 4000, 1 + i % 4000  # unique (S, C) pairs, S 100..102


def qinq_stack(device):
    """Phase 56's deployment: QINQ_SUBS pairs registered in a `QinQMapper`
    and, through it, in the VLAN table (`add_vlan_subscriber`)."""
    from bng_tpu_torch.control.qinq import QinQConfig, QinQMapper, VLANPair, VLANRange

    fp = FastPathTables(sub_nbuckets=1024, vlan_nbuckets=nbuckets_for(QINQ_SUBS),
                        cid_nbuckets=64, max_pools=4, update_slots=QINQ_SUBS)
    fp.set_server_config(AC_MAC, SERVER_IP)
    fp.add_pool(1, QINQ_NET, 18, QINQ_NET + 1, ip_to_u32("1.1.1.1"), 0, 3600)
    mapper = QinQMapper(QinQConfig(s_tag_range=VLANRange(1, 4095), c_tag_range=VLANRange(1, 4095)))
    for i in range(QINQ_SUBS):
        pair = VLANPair(*qinq_pair(i))
        mapper.register(pair, f"qinq-{i}")
        fp.add_vlan_subscriber(pair.s_tag, pair.c_tag, 1, QINQ_NET + 2 + i, NOW + 3600)
    nat = NATManager(public_ips=[ip_to_u32("203.0.113.1")], sessions_nbuckets=1024,
                     sub_nat_nbuckets=1024)
    eng = Engine(fp, nat, QoSTables(nbuckets=1024), batch_size=QINQ_SUBS, pkt_slot=L,
                 device=device)
    return eng, mapper


def qinq_discovers(xid0: int) -> list:
    return [F.discover_frame(bytes([0x02, 0x51, 0x51, 0, i >> 8, i & 0xFF]), xid0 + i,
                             vlans=list(qinq_pair(i))) for i in range(QINQ_SUBS)]


def check_qinq_offers(tx, mapper, what: str) -> None:
    from bng_tpu_torch.control.qinq import VLANPair

    check(sorted(i for i, _ in tx) == list(range(QINQ_SUBS)), f"{what}: every lane answered")
    for i, b in tx:
        d = F.decode(b)
        reply = F.decode_dhcp(d.payload)
        pair = VLANPair(*d.vlans)
        ok = (d.vlans == list(qinq_pair(i)) and reply.msg_type == F.OFFER
              and reply.yiaddr == QINQ_NET + 2 + i
              and mapper.get_subscriber(pair) == f"qinq-{i}"
              and pair.key() == (qinq_pair(i)[0] << 16) | qinq_pair(i)[1])
        check(ok, f"{what} lane {i}: an OFFER of its pair's address, both tags kept")


def qinq_phase(card, device, err) -> dict:
    """Phase 56: QINQ_SUBS 802.1ad DISCOVERs, each client known only by its
    S/C pair (registered in `QinQMapper`, reached through the VLAN table),
    through the fused step and the DHCP-only program on the card: OFFERs
    from the VLAN probe, the card's bytes equal a CPU engine's, one step's
    8 K1 (the VLAN probe among them) and 4 K2 bit-equal to their plain
    versions; counts 0 then read."""
    eng, mapper = qinq_stack(device)
    cpu, _ = qinq_stack("cpu")
    frames = qinq_discovers(0x10000)
    names = table_names(eng.tables)
    out = {}
    rec = record_kernel_inputs(lambda: out.update(eng.process(frames, now=NOW + 1)), 8, 4,
                               "qinq fused step", names)
    check_qinq_offers(out["tx"], mapper, "qinq fused step")
    check(out == cpu.process(frames, now=NOW + 1), "qinq fused step: the card's bytes == the CPU's")
    vi = rec["table"].index("dhcp vlan")
    va = rec["probe"][vi]
    got = probe_mod.probe_cuda(*va)
    ref = probe_mod.probe_plain(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in va))
    check(bool(got[0].all()) and all(torch.equal(g.cpu(), r) for g, r in zip(got, ref)),
          "qinq: the VLAN probe finds every pair, its found/slot/vals == the CPU's")
    probes_vs_plain([("qinq step", a) for a in rec["probe"]], err)
    segs_vs_plain([("qinq step", *a) for a in rec["seg_prefix"]], err)
    frames = qinq_discovers(0x20000)
    dhcp = eng.process_dhcp(frames, now=NOW + 2)
    check_qinq_offers(dhcp["tx"], mapper, "qinq DHCP-only")
    check(dhcp == cpu.process_dhcp(frames, now=NOW + 2),
          "qinq DHCP-only: the card's bytes == the CPU's")
    reset_launches()
    rates = {}
    for path, fn in (("fused", eng.process), ("dhcp", eng.process_dhcp)):
        batches = [qinq_discovers(0x30000 + r * QINQ_SUBS) for r in range(QINQ_ROUNDS)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for k, b in enumerate(batches):
            o = fn(b, now=NOW + 3 + k)
            check(len(o["tx"]) == QINQ_SUBS, f"qinq {path} batch {k}: every DISCOVER answered")
        rates[path] = QINQ_ROUNDS * QINQ_SUBS / (time.perf_counter() - t)
    launches = launch_counts()
    check(launches == {"probe": QINQ_ROUNDS * (8 + 3), "seg_prefix": QINQ_ROUNDS * 4,
                      "umem_gather": 0, "umem_scatter": 0},
          f"qinq: 8 K1 + 4 K2 a fused step, 3 K1 a DHCP-only batch ({launches})")
    print(f"qinq: {QINQ_SUBS} 802.1ad DISCOVERs a batch, clients known only by their S/C "
          f"pair (QinQMapper -> VLAN table): {rates['fused']:.1f} DISCOVERs/s through "
          f"Engine.process, {rates['dhcp']:.1f} through process_dhcp (host included); the "
          f"card's OFFERs == the CPU's; one step's 8 K1 (the VLAN probe found all "
          f"{QINQ_SUBS}) and 4 K2 bit-equal to their plain versions; launches {launches} "
          f"[{card}]", flush=True)
    return {"qinq": launches}


def alg_ip(i: int) -> int:
    return ALG_NET + 2 + i


def alg_hostport(ip: int, port: int) -> str:
    return ",".join(str(b) for b in ip.to_bytes(4, "big")) + f",{port >> 8},{port & 0xFF}"


def alg_stack(device):
    """Phase 57's deployment: ALG_SUBS NAT subscribers (QoS on each), the
    FTP and SIP ALGs on (ALG flags, `add_alg_port`)."""
    from bng_tpu_torch.ops.nat44 import FLAG_ALG_FTP, FLAG_ALG_SIP

    fp = FastPathTables(sub_nbuckets=1024, vlan_nbuckets=64, cid_nbuckets=64, max_pools=4)
    fp.set_server_config(AC_MAC, SERVER_IP)
    nat = NATManager(public_ips=ALG_PUBLIC, ports_per_subscriber=64,
                     sessions_nbuckets=nbuckets_for(4 * ALG_SUBS),
                     sub_nat_nbuckets=nbuckets_for(ALG_SUBS), update_slots=4 * ALG_SUBS)
    nat.flags |= FLAG_ALG_FTP | FLAG_ALG_SIP
    nat.add_alg_port(21, 6)
    nat.add_alg_port(5060, 17)
    qos = QoSTables(nbuckets=nbuckets_for(ALG_SUBS), update_slots=ALG_SUBS)
    for i in range(ALG_SUBS):
        nat.allocate_nat(alg_ip(i), NOW)
        qos.set_subscriber(alg_ip(i), down_bps=100_000_000, up_bps=20_000_000)
    return Engine(fp, nat, qos, batch_size=ALG_SUBS, pkt_slot=L, device=device)


def alg_frames() -> list:
    out = []
    for i in range(ALG_SUBS):
        ip, kind = alg_ip(i), ALG_KINDS[i % 4]
        src = bytes([0x02, 0xA1, 0, 0, i >> 8, i & 0xFF])
        if kind == "INVITE":
            a = ".".join(str(b) for b in ip.to_bytes(4, "big"))
            sdp = (f"INVITE sip:bob@example.com SIP/2.0\r\nVia: SIP/2.0/UDP {a}:5060\r\n"
                   f"Contact: <sip:u{i}@{a}:5060>\r\n\r\nc=IN IP4 {a}\r\n"
                   f"m=audio {20000 + 2 * i} RTP/AVP 0\r\n")
            out.append(F.udp_packet(src, b"\x04" * 6, ip, ALG_SERVER, 5060, 5060, sdp.encode()))
            continue
        a = ".".join(str(b) for b in ip.to_bytes(4, "big"))
        cmd = {"PORT": f"PORT {alg_hostport(ip, 5001)}\r\n",
               "EPRT": f"EPRT |1|{a}|5001|\r\n", "PASV": "PASV\r\n"}[kind]
        out.append(F.tcp_packet(src, b"\x04" * 6, ip, ALG_SERVER, 40000 + i, 21, cmd.encode()))
    return out


def alg_drive(eng, record: bool) -> dict:
    """The ALG path on one engine: the control batch (every lane punted by
    the NAT44 ALG trigger), the host rewrite with the data connections
    pre-installed through the NAT manager, then the FTP servers' first data
    packets toward the mapped public ports."""
    from bng_tpu_torch.control.nat_alg import ALGConnection, ALGHandler
    from bng_tpu_torch.ops.nat44 import NST_ALG
    from bng_tpu_torch.utils.net import u32_to_ip

    nat = eng.nat
    frames = alg_frames()
    alg0 = int(eng.stats.nat[NST_ALG])
    o1 = {}
    t = time.perf_counter()
    rec = None
    if record:
        rec = record_kernel_inputs(lambda: o1.update(eng.process(frames, now=NOW + 1)), 8, 4,
                                   "ALG step", table_names(eng.tables))
    else:
        o1.update(eng.process(frames, now=NOW + 1))
    step_s = time.perf_counter() - t

    def mapper_for(server_port, proto):
        def mapper(ip, port):
            got = nat.handle_new_flow(ip_to_u32(ip), ALG_SERVER, port, server_port, proto, 64,
                                      NOW + 1)
            return None if got is None else (u32_to_ip(got[0]), int(got[1]))
        return mapper

    ftp, sip = ALGHandler(mapper_for(20, 6)), ALGHandler(mapper_for(5060, 17))
    rewritten, expect = [], []
    t = time.perf_counter()
    for lane, _ in o1["slow"]:  # a punted lane's frame is the host's to handle
        d = F.decode(frames[lane])
        sport, proto = (5060, 17) if d.dst_port == 5060 else (40000 + lane, 6)
        row = nat.sessions.lookup(nat._key(d.src_ip, ALG_SERVER, sport, d.dst_port, proto))
        conn = ALGConnection(private_ip=u32_to_ip(d.src_ip), private_port=sport,
                             public_ip=u32_to_ip(int(row[0])), public_port=int(row[1]),
                             protocol=proto)
        rewritten.append((lane, (sip if proto == 17 else ftp).process(conn, d.dst_port,
                                                                       d.payload, True)))
    rewrite_s = time.perf_counter() - t
    data = []
    for lane, _ in rewritten:
        kind = ALG_KINDS[lane % 4]
        ip = alg_ip(lane)
        if kind in ("PORT", "EPRT"):
            row = nat.sessions.lookup(nat._key(ip, ALG_SERVER, 5001, 20, 6))
            pub, port = int(row[0]), int(row[1])
            p = u32_to_ip(pub)
            expect.append((f"PORT {alg_hostport(pub, port)}\r\n" if kind == "PORT"
                           else f"EPRT |1|{p}|{port}|\r\n").encode())
            data.append((lane, pub, port))
        elif kind == "PASV":
            expect.append(b"PASV\r\n")
        else:
            d = F.decode(frames[lane])
            row = nat.sessions.lookup(nat._key(ip, ALG_SERVER, 5060, 5060, 17))
            expect.append(d.payload.replace(u32_to_ip(ip).encode(),
                                            u32_to_ip(int(row[0])).encode()))
    dframes = [F.tcp_packet(b"\x04" * 6, bytes([0x02, 0xA1, 0, 0, lane >> 8, lane & 0xFF]),
                            ALG_SERVER, pub, 20, port, b"", flags=0x02)
               for lane, pub, port in data]
    t = time.perf_counter()
    o2 = eng.process(dframes, from_access=False, now=NOW + 2)
    data_s = time.perf_counter() - t
    return dict(o1=o1, o2=o2, alg=int(eng.stats.nat[NST_ALG]) - alg0, rewritten=rewritten,
                expect=expect, data=data, step_s=step_s, rewrite_s=rewrite_s, data_s=data_s,
                rec=rec)


def nat_alg_phase(card, device, err) -> dict:
    """Phase 57: FTP PORT/EPRT/PASV and SIP INVITEs from ALG_SUBS NAT
    subscribers through the engine on the card: every lane punted by the
    NAT44 ALG trigger (`NST_ALG`), one step's 8 K1 and 4 K2 bit-equal; the
    host rewrite equal to the expected bytes and to a CPU engine's; the
    FTP data connections' first packets DNAT'd on the card after the
    drain; counts 0 then read."""
    reset_launches()
    r = alg_drive(alg_stack(device), True)
    launches = launch_counts()
    check(launches == {"probe": 16, "seg_prefix": 8, "umem_gather": 0, "umem_scatter": 0},
          f"ALG: 8 K1 + 4 K2 a fused step, two steps ({launches})")
    probes_vs_plain([("ALG step", a) for a in r["rec"]["probe"]], err)
    segs_vs_plain([("ALG step", *a) for a in r["rec"]["seg_prefix"]], err)
    check(r["alg"] == ALG_SUBS and sorted(i for i, _ in r["o1"]["slow"]) == list(range(ALG_SUBS))
          and r["o1"]["fwd"] == [] and r["o1"]["tx"] == [],
          f"ALG: every control lane punted by the ALG trigger (NST_ALG +{r['alg']})")
    check([b for _, b in r["rewritten"]] == r["expect"],
          "ALG: PORT/EPRT rewritten to the data session's public endpoint, PASV untouched, "
          "the INVITE's private address replaced by its public one")
    fwd = dict(r["o2"]["fwd"])
    check(sorted(fwd) == list(range(len(r["data"]))),
          f"ALG: every data connection's first packet forwarded ({len(fwd)} of {len(r['data'])})")
    for k, (lane, _, _) in enumerate(r["data"]):
        d = F.decode(fwd[k])
        check(d.dst_ip == alg_ip(lane) and d.dst_port == 5001 and F.l4_checksum_ok(fwd[k]),
              f"ALG data lane {k}: DNAT'd to its client's port 5001, checksum valid")
    c = alg_drive(alg_stack("cpu"), False)
    for key in ("o1", "o2", "rewritten", "alg", "data"):
        check(c[key] == r[key], f"ALG: the card's {key} == the CPU engine's")
    print(f"nat ALG: {ALG_SUBS} control packets (FTP PORT/EPRT/PASV, SIP INVITE) in one batch: "
          f"{r['alg']} punted by the ALG trigger, the step with the punts' host NAT work "
          f"{r['step_s'] * 1e3:.3f} ms; host rewrite {r['rewrite_s'] * 1e6 / ALG_SUBS:.2f} us a "
          f"payload ({len(r['data'])} data sessions pre-installed); {len(fwd)} first data "
          f"packets DNAT'd in {r['data_s'] * 1e3:.3f} ms; the card == the CPU engine; one step's "
          f"8 K1 and 4 K2 bit-equal; launches {launches} [{card}]", flush=True)
    return {"nat_alg": launches}


def verb_ledger(path: str, card: str, regress: bool) -> None:
    lines = []
    for i in range(6):
        p99 = 100.0 * (1 + 0.02 * i) * (2.0 if regress and i == 5 else 1.0)
        lines.append({"schema_version": 1, "run_id": f"smoke-{i}", "metric": "chip_smoke verbs",
                      "value": 1.0, "unit": "Mpps", "batch": 64, "device": card,
                      "env": {"platform": "gpu", "device_kind": card, "host": "chip"},
                      "stage_breakdown": {"dispatch": {"count": 100, "p50_us": 50.0,
                                                       "p99_us": p99}}})
    with open(path, "w") as f:
        f.writelines(json.dumps(ln) + "\n" for ln in lines)


def host_verbs_phase(card) -> dict:
    """Phase 58: `python -m bng_tpu_torch demo`, `perf gate` on ledgers the
    phase writes (clean, then a planted regression) and `check`, each as a
    subprocess with its output checked; host paths, no kernel launch."""
    reset_launches()
    secs = {}

    def verb(*argv):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "bng_tpu_torch", *argv], capture_output=True,
                           text=True, timeout=300, cwd=REPO)
        secs[" ".join(a for a in argv if os.sep not in a)] = time.perf_counter() - t
        return r

    r = verb("demo", "--subscribers", str(VERB_DEMO_SUBS))
    half = VERB_DEMO_SUBS // 2
    check(r.returncode == 0 and r.stdout.splitlines()[-1]
          == f"demo complete: {{'provisioned': {VERB_DEMO_SUBS}, 'active': {half}, "
             f"'walled': {half}}}", f"demo: rc {r.returncode}, {r.stdout[-300:]}{r.stderr[-300:]}")
    with tempfile.TemporaryDirectory() as tmp:
        led = os.path.join(tmp, "ledger.jsonl")
        verb_ledger(led, card, regress=False)
        r = verb("perf", "gate", "--ledger", led)
        check(r.returncode == 0 and "CLEAN" in r.stdout, f"perf gate (clean): rc {r.returncode}")
        verb_ledger(led, card, regress=True)
        r = verb("perf", "gate", "--ledger", led, "--json")
        check(r.returncode == 1 and json.loads(r.stdout)["rc"] == 1
              and "REGRESSION in stage:dispatch" in r.stderr,
              f"perf gate (planted regression): rc {r.returncode}, {r.stderr[-300:]}")
    r = verb("check")
    check(r.returncode == 0 and "0 finding(s)" in r.stderr and "(0 unjustified)" in r.stderr,
          f"check: rc {r.returncode}, {r.stdout[-500:]}{r.stderr[-300:]}")
    launches = launch_counts()
    check(launches == {"probe": 0, "seg_prefix": 0, "umem_gather": 0, "umem_scatter": 0},
          f"host verbs: no kernel launched ({launches})")
    print("host verbs: " + ", ".join(f"`{k}` {v:.2f} s" for k, v in secs.items())
          + f" as subprocesses (demo's lines, perf gate rc 0 then 1 naming the stage, check "
            f"rc 0); no kernel launch [{card}]", flush=True)
    return {"host_verbs": launches}


# ------------------------------------------------- several cards (--cards N)

CARDS_STEPS = 10  # timed sharded steps over the cards, and on one card, in turns
CARDS_BATCHES = 3  # mixed batches through process_ring_pipelined over the cards
CARDS_CLIENTS = 1024  # new clients DORAed through each express placement
CARDS_BURSTS = 200  # bursts of 64 cached DISCOVERs, the bulk lane idle, per placement
CARDS_BUSY = 8  # bursts right after a bulk dispatch of B flows, per placement


def cards_lines(n: int) -> str:
    """Every card's name and power limit, the interconnect as `nvidia-smi
    topo -m` and `nvlink -s` report it (or their failure), and which card
    pairs torch reports peer access between."""
    out = []
    for cmd in (["--query-gpu=index,name,power.limit", "--format=csv,noheader"],
                ["topo", "-m"], ["nvlink", "-s"]):
        r = subprocess.run(["nvidia-smi", *cmd], capture_output=True, text=True, timeout=60)
        text = (r.stdout.strip() or r.stderr.strip())[:3000]
        out.append(f"nvidia-smi {' '.join(cmd)} (rc {r.returncode}):\n{text}")
    peer = [[int(i != j and torch.cuda.can_device_access_peer(i, j)) for j in range(n)]
            for i in range(n)]
    out.append(f"peer access (torch.cuda.can_device_access_peer): {peer}")
    return "\n".join(out)


def sync_cards(n: int) -> None:
    for i in range(n):
        torch.cuda.synchronize(i)


def card_launches() -> dict:
    return {i: dict(v) for i, v in sorted(kernels.LAUNCHES_ON.items())}


def cards_kernel_phase(n: int, card: str, err) -> dict:
    """Phase C1: K1 and K2 launched on every card, with card 0 current (the
    C entries make their inputs' card current for the launch), bit-equal to
    their plain versions there on every case of `kernel_cases.py`; K2's
    cases take route 1 (the shared-memory opt-in, set on each card) and
    route 2; counts 0, then each card's."""
    check(torch.cuda.current_device() == 0, "card 0 is current")
    reset_launches()
    n_probe = n_seg = 0
    for i in range(n):
        dev = torch.device("cuda", i)
        cases = []
        for name in kernel_cases.PROBE_SPECS:
            c = kernel_cases.probe_case(name)
            cases.append((f"{name} on cuda:{i}", tuple(torch.from_numpy(a).to(dev) for a in c[:4])
                          + (c.nbuckets, c.stash)))
        probes_vs_plain(cases, err)
        seg_cases = []
        for name in kernel_cases.SEG_SPECS:
            c = kernel_cases.seg_case(name)
            seg_cases.append((f"{name} on cuda:{i}", torch.from_numpy(c.slot).to(dev),
                              torch.from_numpy(c.vec).to(dev), c.compute))
        check(min(s.shape[0] for _, s, _, _ in seg_cases) <= seg_mod.B_ONE
              < max(s.shape[0] for _, s, _, _ in seg_cases), f"K2's two routes on cuda:{i}")
        segs_vs_plain(seg_cases, err)
        n_probe, n_seg = len(cases), len(seg_cases)
    sync_cards(n)
    per = card_launches()
    check(per == {i: {"probe": n_probe, "seg_prefix": n_seg} for i in range(n)},
          f"every case launched on its own card ({per})")
    check(torch.cuda.current_device() == 0, "the launches left card 0 current")
    say(f"K1 on {n_probe} cases and K2 on {n_seg} (both routes) launched on each of {n} cards "
        f"with card 0 current, bit-equal to their plain versions there; launches by card {per} "
        f"[{card}]")
    return {"cards_kernels": launch_counts()}


def spread_launches(cl, fused: bool) -> dict:
    """K1/K2 launches by card of one sharded step: a shard's local probes
    and K2 calls run on its card, and so do the owner probes every source
    shard sends it (3 lookups from each of the N shards)."""
    out = {}
    for i, dev in enumerate(cl.shard_devices):
        c = out.setdefault(dev.index, {"probe": 0, "seg_prefix": 0})
        c["probe"] += (6 + 3 * cl.n) if fused else 3 * cl.n
        c["seg_prefix"] += 4 if fused else 0
    return out


def one_card_copy(cl, dev):
    """Every shard's tables copied onto one device, with the exchange it takes."""
    tables = [convert.tables_from_numpy(convert.tables_to_numpy(t), dev) for t in cl.tables]
    return tables, DeviceLocalExchange([dev] * cl.n)


def cards_sharded_phase(n: int, card: str, err) -> dict:
    """Phase C2: phase 24's sharded deployment (1M subscribers, 8 shards x 1,024
    lanes) spread over the n cards by the placement rule, the copying
    exchange between them. One ring batch through `step` (every lane, K1/K2
    bit-equal on every call, launches by card), the skewed batch (punts),
    the DHCP-only step; two batches of the spread step against the same
    tables copied onto card 0 (`DeviceLocalExchange`) and onto the CPU:
    every result leaf and table word equal; the spread step's and the
    one-card step's host-clock p50/p99 in turns; the pipelined ring loop;
    expire; then a checkpoint taken over the cards restored onto card 0,
    every table word equal, the audit clean, the next step equal."""
    from bng_tpu_torch.chaos.invariants import audit_invariants

    device = torch.device("cuda")
    t0 = time.perf_counter()
    cl, flows, drop_ips, owners = build_sharded(device)
    sync_cards(n)
    want = [torch.device("cuda", i % n) for i in range(N_SHARDS)]
    check(cl.shard_devices == want and isinstance(cl.exchange, CopyingExchange),
          f"shard i on cuda:(i mod {n}), the copying exchange ({cl.shard_devices})")
    mem = {i: torch.cuda.memory_allocated(i) / 2**30 for i in range(n)}
    say(f"sharded deployment over {n} cards ({N_SHARDS} shards x {B_SHARD} lanes, "
        f"{[str(d) for d in cl.shard_devices]}) built and uploaded in "
        f"{time.perf_counter() - t0:.1f}s; device tables by card (GiB) "
        f"{ {i: round(v, 3) for i, v in mem.items()} }")
    rng = np.random.default_rng(8)
    groups = steer_groups(rng.integers(N_SUBS, size=40_000))
    ring = cl.make_ring(nframes=4 * B, frame_size=L, depth=2 * B)
    per = sharded_launches(N_SHARDS, 6)

    # 1. one ring batch through step(): every lane, every call, launches by card
    frames, expect = sharded_frames(rng, flows, groups)
    pkt, length, flags = assemble_full(cl, ring, frames)
    fa = (flags & ring_mod.FLAG_FROM_ACCESS) != 0
    reset_launches()
    box = {}
    rec = record_kernel_inputs(lambda: box.update(out=cl.step(pkt, length, fa, NOW + 1, 1000)),
                               per["probe"], per["seg_prefix"], "spread sharded step",
                               sharded_names(cl))
    by_card = card_launches()
    check(by_card == spread_launches(cl, True), f"spread step: launches by card {by_card}")
    out = box["out"]
    ring.complete(out["verdict"].astype(np.uint8), np.ascontiguousarray(out["out_pkt"]),
                  out["out_len"].astype(np.uint32), B)
    drain_ring(ring)
    n_drop = check_sharded_outputs(out, expect, drop_ips)
    check(int(out["dhcp_stats"][1]) == N_SHARDS * SH_DISC, "summed DHCP hits = DISCOVER lanes")
    on_cards = sorted({a[3].device.index for a in rec["probe"]})
    check(on_cards == list(range(n)), f"the recorded K1 calls ran on every card ({on_cards})")
    probes_vs_plain([("spread", a) for a in rec["probe"]], err)
    segs_vs_plain([("spread", s, v, c) for s, v, c in rec["seg_prefix"]], err)
    # the first calls on card 0 and on the last card are timed later
    on = {}
    for i, k in ((0, 12), (n - 1, 6)):
        calls = [(a, t) for a, t in zip(rec["probe"], rec["table"]) if a[3].device.index == i]
        on[i] = {"probe": [a for a, _ in calls][:k], "table": [t for _, t in calls][:k],
                 "seg_prefix": [a for a in rec["seg_prefix"] if a[0].device.index == i][:k // 3]}
    del rec
    say(f"spread sharded step: every lane as the deployment implies ({N_SHARDS * SH_DISC} OFFERs, "
        f"{n_drop} QoS drops, the rest SNAT); K1/K2 bit-equal on every call on its card; "
        f"launches by card {by_card}")

    # 2. the skewed batch and the DHCP-only step
    cap = table_mod.exchange_capacity(B_SHARD, cl.geom_sharded.dhcp.sub)
    skew = steer_groups(np.nonzero(owners == 0)[0][:60_000])
    sframes = [F.discover_frame(sub_mac(skew[s][j]), 0x4000 + j)
               for s in range(N_SHARDS) for j in range(B_SHARD)]
    spkt, slen, sflags = assemble_full(cl, ring, sframes)
    sout = cl.step(spkt, slen, (sflags & ring_mod.FLAG_FROM_ACCESS) != 0, NOW + 3, 2000)
    ring.complete(sout["verdict"].astype(np.uint8), np.ascontiguousarray(sout["out_pkt"]),
                  sout["out_len"].astype(np.uint32), B)
    drain_ring(ring)
    for s in range(N_SHARDS):
        v = sout["verdict"][s * B_SHARD:(s + 1) * B_SHARD]
        check((v[:cap] == 2).all() and (v[cap:] == 0).all(),
              f"spread skewed region {s}: {cap} OFFERs, the rest PASS")
    dframes = [F.discover_frame(sub_mac(groups[s][j]), 0x3000 + s * B_SHARD + j)
               for s in range(N_SHARDS) for j in range(B_SHARD)]
    dpkt, dlen, _ = assemble_full(cl, ring, dframes)
    reset_launches()
    dout = cl.dhcp_step(dpkt, dlen, NOW + 2)
    dby = card_launches()
    ring.complete(np.where(dout["is_reply"], 2, 0).astype(np.uint8),
                  np.ascontiguousarray(dout["out_pkt"]), dout["out_len"].astype(np.uint32), B)
    drain_ring(ring)
    check(bool(dout["is_reply"].all()) and dby == spread_launches(cl, False),
          f"spread DHCP-only step: every lane answered, launches by card {dby}")
    say(f"spread skewed batch: per region {cap} OFFERs, {B_SHARD - cap} punted; spread DHCP-only "
        f"step: {B} OFFERs, launches by card {dby}")

    # 3. the spread step == one card == the CPU, two batches
    two = []
    for _ in range(2):
        fr, _ = sharded_frames(rng, flows, groups)
        p_, l_, f_ = assemble_full(cl, ring, fr)
        ring.complete(np.zeros((B,), np.uint8), p_, l_, B)
        drain_ring(ring)
        two.append((p_, l_.astype(np.int64), (f_ & ring_mod.FLAG_FROM_ACCESS) != 0))
    sync_cards(n)
    one_tables, one_ex = one_card_copy(cl, torch.device("cuda", 0))
    cpu_tables, cpu_ex = one_card_copy(cl, torch.device("cpu"))
    one_lanes = [staged_lanes(cl, *b_, torch.device("cuda", 0)) for b_ in two]
    for k, (p_, l_, f_) in enumerate(two):
        now = [NOW + 40 + k, (NOW + 40 + k) * 10**6 & 0xFFFFFFFF]
        g = sharded_step(cl.tables, cl.exchange, cl._lanes(p_), cl._lanes(l_), cl._lanes(f_),
                         cl.geom_sharded, *cl._now(*now))
        o = sharded_step(one_tables, one_ex, *one_lanes[k], cl.geom_sharded,
                         *now_on(cl.n, "cuda:0", *now))
        c = sharded_step(cpu_tables, cpu_ex, *staged_lanes(cl, p_, l_, f_, "cpu"),
                         cl.geom_sharded, *now_on(cl.n, "cpu", *now))
        check(g.verdict.device == torch.device("cuda", 0), "the spread step gathers on card 0")
        for f in g._fields:
            a = getattr(g, f)
            if f == "tables" or a is None:
                continue
            check(torch.equal(a, getattr(o, f)) and torch.equal(a.cpu(), getattr(c, f)),
                  f"batch {k}: the spread step's {f} == one card's == the CPU's")
        for i in range(N_SHARDS):
            w = convert.tables_to_numpy(cl.tables[i])
            words_equal(w, convert.tables_to_numpy(one_tables[i]), f"batch {k} shard {i} vs one card")
            words_equal(w, convert.tables_to_numpy(cpu_tables[i]), f"batch {k} shard {i} vs the CPU")
    del cpu_tables
    say(f"spread sharded step == the same tables on one card == on the CPU, 2 batches (every "
        f"result leaf and every word of all {N_SHARDS} shards' tables)")

    # 4. times: the spread step and the one-card step in turns (host clock, every card synced)
    sp_lanes = (cl._lanes(two[0][0]), cl._lanes(two[0][1]), cl._lanes(two[0][2]))
    sp_now = cl._now(NOW + 50, 50 * 10**6)
    one_now = now_on(cl.n, "cuda:0", NOW + 50, 50 * 10**6)
    steps = {
        f"spread over {n} cards": lambda: sharded_step(cl.tables, cl.exchange, *sp_lanes,
                                                       cl.geom_sharded, *sp_now),
        "one card": lambda: sharded_step(one_tables, one_ex, *one_lanes[0], cl.geom_sharded,
                                         *one_now),
    }
    for step in steps.values():
        for _ in range(2):
            step()
    sync_cards(n)
    lat = {k: [] for k in steps}
    names = list(steps)
    for r in range(CARDS_STEPS):
        for name in (names if r % 2 == 0 else names[::-1]):
            t1 = time.perf_counter()
            steps[name]()
            sync_cards(n)
            lat[name].append((time.perf_counter() - t1) * 1e3)
    p50 = {}
    for name, ms in lat.items():
        ms = np.array(ms)
        p50[name] = float(np.percentile(ms, 50))
        say(f"sharded device step N={N_SHARDS} x {B_SHARD} lanes, {name}: "
            f"{B / (ms.mean() / 1e3) / 1e6:.4f} Mpps, p50 {p50[name]:.3f} ms, "
            f"p99 {np.percentile(ms, 99):.3f} ms over {len(ms)} steps (host clock, every card "
            f"synced) [{card}]")
    ratio = p50[names[0]] / p50[names[1]]
    say(f"spread / one-card step p50: {ratio:.3f} (prediction 0.8-1.3) [{card}]")
    del one_tables
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the pipelined ring loop over the cards
    reset_launches()
    call_ms, done = [], 0
    for k in range(CARDS_BATCHES):
        fr, _ = sharded_frames(rng, flows, groups)
        check(ring.rx_push_batch(fr, from_access=True) == B, "ring took the batch")
        t1 = time.perf_counter()
        done += cl.process_ring_pipelined(ring, NOW + 60 + k, (60 + k) * 10**6, pkt_slot=L)
        call_ms.append((time.perf_counter() - t1) * 1e3)
        drain_ring(ring)
    done += cl.flush_pipeline()
    drain_ring(ring)
    pipe = launch_counts()
    check(done == CARDS_BATCHES * B, f"pipelined loop over the cards retired every frame ({done})")
    check_launches(pipe, CARDS_BATCHES, per, "spread pipelined loop")
    check(cl.telemetry.snapshot()["missteer_total"] == 0, "no missteer")
    say(f"spread process_ring_pipelined per batch of {B}: mean {np.mean(call_ms):.2f} ms over "
        f"{CARDS_BATCHES} batches; launches by card {card_launches()} [{card}]")
    kern = time_kernels(on[0], card, "spread (card 0)")
    with torch.cuda.device(n - 1):
        time_kernels(on[n - 1], card, f"spread (card {n - 1})")
    del on

    # 6. expire (its deletions drain to every card with the next batch),
    # then a checkpoint over the cards restored onto card 0
    n_exp = cl.expire(NOW + 100)
    check(n_exp == N_AGED, f"expire swept the aged flows on every shard ({n_exp})")
    fr, _ = sharded_frames(rng, flows, groups)
    check(ring.rx_push_batch(fr, from_access=True) == B, "ring took the batch")
    cl.process_ring(ring, NOW + 101, 101 * 10**6, pkt_slot=L)
    drain_ring(ring)
    check(cl.pending_dirty() == 0, "the expired rows drained to every card")
    t1 = time.perf_counter()
    data = ckpt_mod.encode_checkpoint(ckpt_mod.build_sharded_checkpoint(
        cl, 1, float(NOW + 200), node_id="chip-smoke"))
    build_s = time.perf_counter() - t1
    one = ShardedCluster(cl.n, **{**cl._ctor_kwargs, "device": "cuda:0", "devices": None})
    t1 = time.perf_counter()
    ckpt_mod.restore_sharded_checkpoint(ckpt_mod.decode_checkpoint(data), one, now=NOW + 200)
    torch.cuda.synchronize(0)
    restore_s = time.perf_counter() - t1
    check(one.shard_devices == [torch.device("cuda", 0)] * N_SHARDS, "the restore target is card 0")
    for i in range(N_SHARDS):
        tables_equal(cl.tables[i], one.tables[i], f"shard {i} restored from the cards onto card 0")
    rep = audit_invariants(cluster=one, check_roundtrip=False)
    check(rep.ok, f"the restored cluster audits clean ({rep.violations_by_kind()})")
    fr, _ = sharded_frames(rng, flows, groups)
    p_, l_, f_ = assemble_full(cl, ring, fr)
    ring.complete(np.zeros((B,), np.uint8), p_, l_, B)
    drain_ring(ring)
    f_ = (f_ & ring_mod.FLAG_FROM_ACCESS) != 0
    a, b_ = cl.step(p_, l_, f_, NOW + 201, 1000), one.step(p_, l_, f_, NOW + 201, 1000)
    for k, v in a.items():
        check(np.array_equal(v, b_[k]), f"the restored one-card cluster's step {k} == the cards'")
    say(f"sharded checkpoint over {n} cards ({len(data) / 2**20:.1f} MiB, fold + build + encode "
        f"{build_s:.3f} s) restored onto card 0 in {restore_s:.3f} s: every word of the "
        f"{N_SHARDS} shards' tables equal, the audit clean, the next step equal [{card}]")
    del one, data, cl, ring
    gc.collect()
    torch.cuda.empty_cache()
    return {"cards_sharded": by_card_total(by_card), "cards_pipelined": pipe,
            "cards_sharded_dhcp": by_card_total(dby)}, kern


def by_card_total(by_card: dict) -> dict:
    return {k: sum(c[k] for c in by_card.values()) for k in kernels.SIGNATURES}


def cards_run_phase(n: int, card: str) -> None:
    """Phase C3: `python -m bng_tpu_torch run --once --shards n --batch-size
    4096 --shard-nbuckets 8192` over the cards (the default device: one
    shard a card) and with `--device cuda:0` (every shard on card 0), each
    a subprocess: rc 0, the shard placement its log reports, seconds; then
    `run --shards 4` in-process (phase 47's drive: DISCOVERs, leases,
    renewals and flows) over the cards, on card 0 and on the CPU: the same
    TX and FWD bytes, stats and every shard's table words."""
    secs = {}
    for label, pre in (("cards", []), ("card 0", ["--device", "cuda:0"])):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "bng_tpu_torch", *pre, "run", "--once",
                            "--shards", str(n), "--batch-size", "4096", "--shard-nbuckets",
                            "8192"], capture_output=True, text=True, timeout=600, cwd=REPO)
        secs[label] = time.perf_counter() - t
        check(r.returncode == 0, f"run --once --shards {n} on {label}: rc {r.returncode}\n"
              f"{r.stderr[-2000:]}")
        built = [json.loads(ln) for ln in r.stderr.splitlines()
                 if ln.startswith("{") and "sharded cluster built" in ln]
        check(len(built) == 1, f"run --shards {n} on {label}: one cluster built")
        want = ([f"cuda:{i % n}" for i in range(n)] if label == "cards" else ["cuda:0"] * n)
        check(built[0]["shard_devices"] == want,
              f"run --shards {n} on {label}: shards on {built[0]['shard_devices']}")
        stats = json.loads(r.stdout)
        check(stats["sharded"]["shards"] == n, f"run --shards {n} on {label}: stats")
    say(f"run --once --shards {n} --batch-size 4096 --shard-nbuckets 8192: over the cards "
        f"{secs['cards']:.1f} s, on card 0 {secs['card 0']:.1f} s (subprocesses, rc 0, "
        f"shards placed as the log reports) [{card}]")
    t0 = time.perf_counter()
    cmp = [sharded_run_cmp(dev) for dev in ("cuda", "cuda:0", "cpu")]
    for other, name in ((cmp[1], "card 0"), (cmp[2], "the CPU")):
        check(cmp[0][0] == other[0] and cmp[0][1] == other[1],
              f"run --shards {SH_RUN_SHARDS} over the cards: TX and FWD bytes == {name}'s")
        check(cmp[0][2] == other[2], f"run --shards {SH_RUN_SHARDS} over the cards: stats == "
              f"{name}'s")
        for i, (g, c) in enumerate(zip(cmp[0][3], other[3])):
            check(g[1:] == c[1:], f"shard {i}'s host rows == {name}'s")
            words_equal(g[0], c[0], f"shard {i}'s device tables == {name}'s")
    say(f"run --shards {SH_RUN_SHARDS} in-process over the cards == on card 0 == on the CPU "
        f"({len(cmp[0][0])} TX, {len(cmp[0][1])} FWD frames, stats and every shard's table "
        f"words; {time.perf_counter() - t0:.1f} s)")


def burst_bytes(sched, macs, xid0: int) -> list:
    """One burst of cached DISCOVERs through the express lane, flushed (a
    held clock closes no deadline); reply bytes in submit order."""
    for j, i in enumerate(macs):
        check(sched.submit(F.discover_frame(sub_mac(int(i)), xid0 + j), True,
                           tag=("b", j)) == "express", "burst on the express lane")
    sched.flush()
    done = sched.drain_completions()
    check(len(done) == len(macs) and all(c.verdict == "tx" for c in done),
          "every burst DISCOVER answered on the device")
    return [c.frame for c in sorted(done, key=lambda c: c.tag[1])]


def cards_express_phase(card: str) -> dict:
    """Phase C4: the scheduler with the express lane on cuda:1 (the default
    pick with two or more cards) beside the shared lane (-1), each over the
    headline's host tables, in turn: the express program and a devloop
    ring (k = 8) captured on cuda:1 and launching there; the authoritative
    DHCP tables on cuda:1 and the bulk replica on cuda:0; a DORA storm of
    new clients (the leases drain onto cuda:1, renewals answered there) with
    IPoE batches; bursts of 64 cached DISCOVERs with the bulk lane idle and
    right after a bulk dispatch of B flows: OFFER p50/p99 of both lanes,
    and the same reply bytes from both for the same bursts; beside the
    lane on cuda:1, the engine's own fused step on cuda:0."""
    device = torch.device("cuda")
    t0 = time.perf_counter()
    eng, flows, drop_ips = build_deployment(device)
    hosts = (eng.fastpath, eng.nat, eng.qos, eng.antispoof)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    say(f"headline host tables built in {time.perf_counter() - t0:.1f}s")
    flow_frames = [flow_frame(flows[int(i)])
                   for i in np.random.default_rng(3).integers(len(flows), size=B)]
    lat, replies, launches = {}, {}, {}
    for turn, (label, idx) in enumerate((("shared", -1), ("cuda:1", None))):
        clk = StackClock()
        sched, server, capture_s = build_serving_stack(hosts, device, clock=clk,
                                                       express_device_index=idx)
        eng = sched.engine
        own = label != "shared"
        want = torch.device("cuda", 1) if own else None
        check(sched._express_dev == want, f"{label}: the express lane's card {sched._express_dev}")
        prog = eng.express_aot(64, sched._express_dev)
        check(prog is not None and prog.graph is not None
              and prog.launches == {"probe": 3, "seg_prefix": 0},
              f"{label}: the express program is a captured graph of 3 K1")
        home = torch.device("cuda", 1 if own else 0)
        check(prog.device == home and eng.dhcp_device == home,
              f"{label}: the express graph and the DHCP tables on {home}")
        rng = np.random.default_rng(21)
        reset_launches()
        n0 = sched.express_aot_dispatches
        storm_s, n_bulk = dora_storm(sched, rng, flows, drop_ips, clients=CARDS_CLIENTS,
                                     first=turn * CARDS_CLIENTS)
        n_exp = sched.express_aot_dispatches - n0
        check(sched._bulk_dhcp.sub.krows.device == torch.device("cuda", 0),
              f"{label}: the bulk replica on cuda:0")
        snap = sched.stats_snapshot()["express"]
        check(snap["aot_misses"] == 0 and snap["fallbacks"] == {}, f"{label}: no miss ({snap})")
        storm_by = card_launches()
        want_by = ({0: {"probe": 8 * n_bulk, "seg_prefix": 4 * n_bulk},
                    1: {"probe": 3 * n_exp, "seg_prefix": 0}} if own else
                   {0: {"probe": 8 * n_bulk + 3 * n_exp, "seg_prefix": 4 * n_bulk}})
        check(storm_by == want_by, f"{label}: 3 K1 per express dispatch on the express card, "
              f"8 K1 + 4 K2 per bulk step on cuda:0 ({storm_by})")
        reset_launches()
        idle, _ = express_latency(sched, rng, CARDS_BURSTS, 64)
        idle_by = card_launches()
        check(idle_by == {1 if own else 0: {"probe": 3 * CARDS_BURSTS, "seg_prefix": 0}},
              f"{label}: 3 K1 per burst on the express card ({idle_by})")
        busy, _ = express_latency(sched, rng, CARDS_BUSY, 64, busy_flows=flow_frames)
        lat[label] = (idle, busy)
        clk.fixed = float(NOW + 500)  # held: the reply bytes carry the lease time left
        replies[label] = burst_bytes(sched, np.random.default_rng(5).integers(N_SUBS, size=64),
                                     0x7100000)
        launches[label] = idle_by
        say(f"express lane {label}: graph captured in {capture_s * 1e3:.1f} ms; DORA storm of "
            f"{CARDS_CLIENTS} new clients in {storm_s:.2f} s ({CARDS_CLIENTS / storm_s:.1f} "
            f"DORAs/s, {n_bulk} IPoE batches), launches by card {storm_by} [{card}]")
        for name, x in (("bulk idle", idle), ("right after a bulk dispatch", busy)):
            say(f"express OFFER latency, lane {label}, 64 cached DISCOVERs {name}: p50 "
                f"{np.percentile(x, 50):.3f} ms, p99 {np.percentile(x, 99):.3f} ms, max "
                f"{x.max():.3f} ms over {len(x)} frames [{card}]")
        if own:
            sched.quiesce()
            t1 = time.perf_counter()
            ring_prog = eng.compile_devloop_aot(8, 64, sched._express_dev)
            check(ring_prog.graph is not None and ring_prog.device == torch.device("cuda", 1)
                  and ring_prog.tables.sub.krows.device == torch.device("cuda", 1)
                  and ring_prog.launches == {"probe": 24, "seg_prefix": 0},
                  "the k = 8 ring program captured on cuda:1 (24 K1)")
            say(f"devloop ring k = 8 captured on cuda:1 in {(time.perf_counter() - t1) * 1e3:.1f} "
                f"ms; one replay {cuda_ms_on(1, lambda: ring_prog.graph.replay()):.4f} ms device "
                f"[{card}]")
            dl = TieredScheduler(eng, SchedulerConfig(
                express_batch=64, express_max_wait_us=200.0, bulk_batch=B,
                express_loop="devloop", devloop_k=8))
            check(dl.express_loop == "devloop" and dl._express_dev == torch.device("cuda", 1),
                  "a devloop scheduler on cuda:1")
            reset_launches()
            got = burst_bytes(dl, np.random.default_rng(5).integers(N_SUBS, size=64), 0x7100000)
            dl.flush()
            check(got == replies[label], "the devloop lane on cuda:1 gives the aot lane's bytes")
            check(dl._devloop.audit()["consistent"], "the ring's cursor audit after flush")
            launches["devloop"] = card_launches()
            check(set(launches["devloop"]) == {1}, f"the ring replayed on cuda:1 "
                  f"({launches['devloop']})")
            del dl
            # the engine's own fused step (the native ring's drive, which
            # bypasses the scheduler) brings the DHCP tables home to cuda:0;
            # the next express burst takes them back to cuda:1
            reset_launches()
            out = eng.process(flow_frames)
            fused_by = card_launches()
            check(eng.dhcp_device == torch.device("cuda", 0) and set(fused_by) == {0}
                  and len(out["tx"]) + len(out["fwd"]) + len(out["dropped"]) + len(out["slow"])
                  == len(flow_frames),
                  f"the engine's fused step on cuda:0 with the DHCP tables home ({fused_by})")
            got = burst_bytes(sched, np.random.default_rng(5).integers(N_SUBS, size=64),
                              0x7100000)
            check(got == replies[label] and eng.dhcp_device == torch.device("cuda", 1),
                  "the express lane on cuda:1 again after the fused step, the same bytes")
            say(f"engine fused step with the express lane on cuda:1: DHCP tables home on "
                f"cuda:0, launches by card {fused_by}; the next burst back on cuda:1 [{card}]")
        sched.quiesce()
        del sched, server, eng, prog
        gc.collect()
        torch.cuda.empty_cache()
    check(replies["shared"] == replies["cuda:1"],
          "the same bursts give the same reply bytes on both express placements")
    (si, sb), (oi, ob) = lat["shared"], lat["cuda:1"]
    say("EXPRESS-CARDS " + json.dumps({
        "shared": {"idle_p50": float(np.percentile(si, 50)), "idle_p99": float(np.percentile(si, 99)),
                   "busy_p50": float(np.percentile(sb, 50)), "busy_p99": float(np.percentile(sb, 99))},
        "cuda:1": {"idle_p50": float(np.percentile(oi, 50)), "idle_p99": float(np.percentile(oi, 99)),
                   "busy_p50": float(np.percentile(ob, 50)), "busy_p99": float(np.percentile(ob, 99))},
        "card": card}))
    return {"cards_express_shared": by_card_total(launches["shared"]),
            "cards_express_own": by_card_total(launches["cuda:1"]),
            "cards_devloop": by_card_total(launches["devloop"])}


def cuda_ms_on(i: int, fn) -> float:
    with torch.cuda.device(i):
        return cuda_ms(fn)


def cards_gate_phase(n: int, card: str) -> None:
    """Phase C5: the kernel gate, `verify_cuda_kernels(cuda=True)`, with each
    card current in turn: every check passes on every card (its sharded
    check spreads one shard a card)."""
    from bng_tpu_torch.runtime.verify import verify_cuda_kernels

    for i in range(n):
        with torch.cuda.device(i):
            t = time.perf_counter()
            res = verify_cuda_kernels(verbose=False, cuda=True)
            bad = [(name, e) for name, e in res if e is not None]
            check(not bad, f"kernel gate on cuda:{i}: {bad}")
            say(f"kernel gate on cuda:{i}: {len(res)} checks pass in "
                f"{time.perf_counter() - t:.1f} s [{card}]")


def cards_main(n: int, card: str):
    """--cards n: the phases that need several cards, alone. Returns the
    launches by path, the max |kernel - plain| and card 0's kernel times."""
    t_all = time.perf_counter()
    err = {"probe": 0.0, "seg_prefix": 0.0}
    launches = cards_kernel_phase(n, card, err)
    more, kern = cards_sharded_phase(n, card, err)
    launches.update(more)
    cards_run_phase(n, card)
    launches.update(cards_express_phase(card))
    cards_gate_phase(n, card)
    say(f"--cards {n}: every phase passed in {time.perf_counter() - t_all:.1f} s")
    return launches, err, kern


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a few device steps with torch.profiler")
    ap.add_argument("--cards", type=int, default=None, metavar="N",
                    help="run only the phases that need several cards, on exactly N >= 2")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    want = args.cards if args.cards is not None else 1
    check(args.cards is None or args.cards >= 2, f"--cards takes N >= 2 (got {args.cards})")
    check(torch.cuda.device_count() == want,
          f"{want} visible card(s) (found {torch.cuda.device_count()}; set CUDA_VISIBLE_DEVICES)")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.cards is not None:
        say(f"cards:\n{cards_lines(args.cards)}")

    t0 = time.perf_counter()
    for name, (cmd, log) in kernels.build().items():
        print(" ".join(cmd))
        for line in log.splitlines():
            if "ptxas" in line or "error" in line:
                print(f"  {line.strip()}")
    for name in kernels.SIGNATURES:
        kernels.entry(name)
    say(f"built and loaded {list(kernels.SIGNATURES)} in {time.perf_counter() - t0:.1f}s")
    if args.cards is not None:
        launches, err, kern = cards_main(args.cards, card)
        return finish(launches, launches["cards_sharded"], err, kern, card)

    t0 = time.perf_counter()
    eng, flows, drop_ips = build_deployment(device)
    torch.cuda.synchronize()
    say(f"deployment built and uploaded in {time.perf_counter() - t0:.1f}s "
        f"(device tables {torch.cuda.memory_allocated() / 2**30:.3f} GiB)")

    err = {"probe": 0.0, "seg_prefix": 0.0}  # max |kernel - plain| over every comparison
    launches, movers = umem_phase(card, err)
    ipoe, ipoe_traced = ipoe_phases(eng, flows, drop_ips, card, device, args.profile, err)
    launches.update({"ipoe": ipoe, "ipoe_traced": ipoe_traced})
    launches.update(wire_headline_phase(eng, flows, card, err))
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
    launches.update(run_observed_phases(card, device, err))
    operator_process_phase(card)
    trace_export_phase(card)
    launches.update(fleet_phases(card, device, err))
    launches.update(chaos_phases(card, device, err))
    launches.update(run_sharded_phases(card, device, err))
    launches.update(ha_pair_phases(card, device, err))
    launches.update(nexus_phases(card, device, err))
    launches.update(dns_phases(card, device, err))
    more, wire_want = wire_scenario_phase(card, device, err)
    launches.update(more)
    more, _live = run_wire_if_phase(card, device, wire_want)
    launches.update(more)
    launches.update(cluster_phase(card))
    launches.update(qinq_phase(card, device, err))
    launches.update(nat_alg_phase(card, device, err))
    launches.update(host_verbs_phase(card))
    return finish(launches, launches["full"], err, {**kern, **movers}, card,
                  {"umem_gather": launches["wire_headline"],
                   "umem_scatter": launches["wire_headline"]})


def finish(launches, main_path, err, kern, card, main_of=None) -> int:
    """The kernels line (each kernel's launches on the main path and by
    path, its max |err| and its times against its bound), the card line,
    the result line. K1 and K2's main path is `main_path`; the ring's
    movers (timed only on one card) name theirs in `main_of`, the
    headline's ring loop, and replace no TPU kernel."""
    src = {"probe": ("cuda", "bng_tpu_torch/csrc/probe.cu", "bng_tpu/ops/pallas_table.py:261"),
           "seg_prefix": ("cuda", "bng_tpu_torch/csrc/seg_prefix.cu",
                          "bng_tpu/ops/pallas_qos.py:127"),
           "umem_gather": ("cuda", "bng_tpu_torch/csrc/umem.cu", None),
           "umem_scatter": ("cuda", "bng_tpu_torch/csrc/umem.cu", None)}
    main_of = {"probe": main_path, "seg_prefix": main_path, **(main_of or {})}
    line = {"kernels": [
        {"name": name, "route": src[name][0], "source": src[name][1], "replaces": src[name][2],
         "launches": main_of[name][name], "max_abs_err": err[name],
         "ms": float(np.mean(kern[name]["ms"])),
         "plain_ms": float(np.mean(kern[name]["plain"])) if "plain" in kern[name] else None,
         "bound_ms": float(np.mean(kern[name]["bound"])),
         "bound_by": "bytes", "library_ms": None,
         "launches_by_path": {p: v.get(name, 0) for p, v in launches.items()}}
        for name in src if name in kern]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
