#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit. The script

  1. builds the port's CUDA kernels from foundationdb_tpu_torch/csrc/ and
     prints the card's name and power limit (nvidia-smi);
  2. kernel phase, at the bench width (T=4096 txns, 8192 point reads and
     8192 point writes, 256 range reads and 256 range writes, 16-byte keys
     over an 8192-key hot pool, a 24576-row table): runs local_phases on the
     card, then the fixpoint kernel and its plain torch version on the same
     inputs, and requires bit-equal verdicts on every batch, with the range
     groups filled so every term of the kernel runs; times the kernel's
     device time per launch (CUDA events around launches queued behind a
     spin kernel, so the host's time drops out) and both calls as their
     caller sees them (CUDA events, host time included), and the kernel on
     a batch with no rows (its floor: launch, setup, one round); then the
     same at the shape the engine phase gives the kernel (the default
     KernelConfig: 4096 rows in every group);
  3. deep-chain phase, at the bench width: CHAIN_TXNS txns, each reading
     the key the one before writes, so the fixpoint takes one round per
     link; kernel and plain version must agree bit for bit and in rounds;
  4. step phase: resolve_step on device-resident batches for a few hundred
     steps with the bench's GC lag; prints ms per batch and txn/s;
  5. engine phase (the main path a user calls): TorchConflictEngine() on the
     card at the default KernelConfig (65536-row table, 4096 txns, 4096 rows
     per group) resolves byte-key CommitTransaction batches, long keys
     and range rows included, so the general router takes nearly every
     batch; its verdicts must equal the same engine on the CPU on every
     batch and OracleConflictEngine on the first batches. The launch counts
     are zeroed just before and read just after: the kernel must have run,
     and the plain version must never have seen a CUDA tensor. The packed
     arrays of the engine's largest chunk are recorded on the way (wrappers
     around the engine's _run_step and _run_detect, installed by this
     script) and replayed
     through local_phases and the kernel: the shape users' batches give the
     kernel, most rows padding;
  6. graph-step phase: the step phase's batches through a captured CUDA
     graph of an 8-step chunk scan, against the eager step on the same
     schedule: equal statuses on every batch; ms per batch, txn/s, device
     busy share and launches per replay of both;
  7. columnar engine phase: TorchConflictEngine() with the bucket ladder
     (512, 1024, 2048) and scans (2, 4, 8), at the default keyspace heat
     (64 buckets), warmed up (graph memory read before and after), on
     point-only traffic of 200 to 20000 txns a batch, two batches of them
     read-only, through columnar_pack / columnar_dispatch / force, the
     dispatch under torch.cuda.set_sync_debug_mode("error"); verdicts equal
     the oracle's, the general router's and a CPU engine's on every batch,
     and heat_snapshot() equals the CPU engine's; every bucket and scan
     size serves, nothing is captured after warmup(); host-pack, dispatch
     and force ms per batch, txn/s, and each layer's time apart, the bytes
     one chunk copies back among them. Then the same with heat_buckets=0,
     held to the heat-on verdicts: kernel ms and kernels per one-chunk
     replay with heat and without, at each bucket;
  8. tiered columnar engine phase: the same with history_structure=
     "tiered" (8 run slots, the lazy merge an IF node in every captured
     step); verdicts equal the card's monolithic engine's, the CPU tiered
     engine's and the oracle's on every batch; merges must run inside
     replays at least twice, with no host read of the merge predicate; the
     captured IF nodes are counted; program kernel ms with and without a
     merge, and the merge alone; heat_snapshot() and
     history_stats_snapshot() equal the CPU tiered engine's, and the heat
     aggregate counts the merges the serving path counted;
  8b. device loop phases: DeviceLoopEngine() (one program per bucket, a
     CUDA graph WHILE node over the filled prefix of a 4-chunk queue slot;
     tiered: the merge's IF node nested in the WHILE body), monolithic then
     tiered, at the default heat, warmed up (2 graphs per bucket, WHILE and
     IF nodes counted, graph memory); the same traffic, dispatch under sync
     debug "error", verdicts equal the oracle's and the columnar card
     engine's, heat snapshot (and tiered history stats) equal to the
     columnar engine's; no blocking sync; slots filled to 1 and to 4; the
     card's trace shows one fixpoint kernel per filled chunk of a top-
     bucket replay at fill 1 and 4; enqueue and decode host ms. Then every
     engine serves the traffic once more, in turns (monolithic, heat off,
     tiered, loop, tiered loop), for txn/s and per-layer ms;
  9. tiered general-router phase: the engine phase's traffic (byte keys,
     ranges, long keys) through a tiered engine on the card; verdicts equal
     the monolithic card engine's, the CPU tiered engine's and the
     oracle's;
  10. pipeline phase: the traffic through ResolverPipeline at depth 1, 2 and
     3, packing inline and on a one-thread executor: verdicts equal serial
     resolve(); txn/s per depth; then the tiered engine and the loop engine
     at depth 1-3 (no blocking sync).
  11. telemetry phase: the engines above run with device-time sampling
     off; fresh ones (columnar and loop, monolithic and tiered) run at
     sample rate 1.0 with spans on, the dispatch under sync debug "error":
     verdicts equal the off engines' on every batch, one ledger row per
     program (two captured graphs each) with its capture ms and peak
     bytes, one CUDA-event sample and one engine.device_time span per
     dispatch unit, no blocking sync; the spans' ms per batch beside the
     phase's clocks, the sampled device ms per chunk beside the profiler's
     kernel ms; a columnar engine at the default rate (1/16); txn/s of
     off, default and on in turns, twice; then the columnar and loop
     engines' sampled intervals against a torch.profiler trace of the same
     pass: the kernels, copies and idle time inside them, and where the
     idle time sits;
  12. scheduled pipeline phase: ResolverPipeline at depth 2 with a
     BudgetBatcher and a ConflictScheduler built with resolver_sched "on",
     over skewed traffic (pre-aborts retried at a fresh snapshot): the
     dispatched journal replays equal through a CPU engine and the oracle.
  13. resolver role phase: the port's Resolver role (server/resolver.py) in
     the port's simulator (sim/), buggify on, over the warmed engines above,
     on the columnar traffic less its 20000-txn batch (ROLE_SIZES) with
     versions MAX_WRITE_TRANSACTION_LIFE_VERSIONS
     // GC_LAG_BATCHES apart (the role sets its own horizon, 4 batches
     behind): a proxy process sends every batch over the simulated network,
     chained by prev_version, every 4th twice. Serially, pipelined at depth
     1-3 (the service fed the card's own pack clock and sampled device ms
     per bucket), the loop engine at depth 2, a kill at batch 4 with a
     second role (gen2, over the heat-off engine) serving every later
     version, and depth 2 again with the same seed. Each run journals to a
     BlackboxJournal; its journal is read back and replayed through the
     oracle in worker processes, and every reply must equal the replay;
     duplicates come from the replay window; the same-seed runs give equal
     replies, journal bytes and scheduler steps; dispatches run under sync
     debug "error" and the loop role makes no blocking sync. Virtual reply
     latency p50 / p99, wall txn/s through the role and of the bare engine.
  14. supervised role phase: the role at depth 2 over
     ResilientEngine(FaultInjectingEngine(the columnar card engine)), on
     the columnar generator at 200-2048 txns a batch (36 batches): the bare
     role first, then (a) fault-free, buggify off, probe_rate 1.0: HEALTHY,
     0 faults, 0 probe mismatches, 0 oracle batches; (b) exceptions, hangs,
     stragglers and outages: SUSPECT -> HEALTHY and FAILED -> PROBATION ->
     HEALTHY visited; (c) flips at probe_rate 1.0: QUARANTINED. Every reply
     equals the oracle replay of its journal; the dispatch faults are the
     injector's and the buggify sites', none the card's; no dispatch
     synchronizes; a rewarm captures nothing. Transitions, stats, rewarm
     ms, launches, wall txn/s beside the bare role's.
  15. crash recovery phase: two spawn-context children over one directory.
     A: a journal that fsyncs every record, a program cache, snapshots,
     a supervised card engine warmed up; serves 9 batches and is killed
     with SIGKILL once the last is durable. B (with the cache) and B' (on a
     copy, without) boot cold, recover() and serve the rest: complete,
     covered, 0 mismatches, verdicts equal to the oracle's over the whole
     stream; the journal holds snapshot and recovery events. The blackout
     beside resolver_recovery_budget_ms, the clock from process start to
     the first served batch by part, the captures, the caches' summaries.
  16. reshard phase: an ElasticResolverGroup of supervised tiered card
     engines (no multi-chunk scans: its batches are one chunk each; a
     spare prewarmed) in the simulator; the ReshardController
     splits the hot span and later merges it back, each under concurrent
     load, over skewed traffic (64 hot keys): every verdict equals one
     serial oracle's; run_slice since a watermark equals shadow_slice after
     coalesce. Each blackout beside reshard_blackout_budget_ms, the batch
     paths, launches per slot, device memory.
  17. cluster phase: the port's static simulated cluster (master, proxy,
     tlog, storage servers, ratekeeper, clients; server/cluster.py) with
     resolvers on the card. run_spec on CycleTestCUDA, CycleTest,
     Serializability, ConflictRangeCheck, RandomReadWrite and AtomicOps at
     seeds 1 and 2, every resolver a TorchConflictEngine at the specs'
     KernelConfig: each run ok and equal to its oracle twin (ok, metrics,
     virtual time), every card engine's recorded batches equal to a fresh
     oracle's replay. Then the latency harness (run_latency_under_load,
     open-loop Poisson arrivals through the whole commit path, 6,000
     txns a point) with a TorchConflictEngine at the default KernelConfig
     in the resolver, fed the columnar phase's one-chunk replay ms per
     bucket and pack ms per txn: depth 1 at bucket 512, depth 2 at 1024
     and 2048 at 0.97 and 1.0 of T / device_ms, the fastest in-budget
     depth-2 point again with spans on; each point's result equal to its
     oracle twin's. Sustained and committed txn/s, virtual p50 / p99
     against resolver_p99_budget_ms, wall s and wall txn/s, launches.
  18. dynamic cluster phase: the port's dynamic simulated cluster
     (coordinators, leader election, the cluster controller, workers, the
     master's epoch recovery, data distribution; server/cluster.py
     DynamicCluster) with every resolver recruited in every generation a
     card engine. run_spec on each of the 13 dynamic specs at seed 1,
     BackupCorrectness (its restore cluster recruits card engines too)
     also at seed 2, at the specs' KernelConfig
     (capacity 1024, T=64; DataDistributionAttrition at capacity 4096),
     each engine supervised as recruitment does (DeviceNemesis: over the
     fault injector, as its own factory): each run ok and equal to its oracle
     twin (ok, metrics, virtual time), each supervisor's health counters
     equal to its twin's, dispatch faults sorted by cause with none from
     the card, every card call and every supervisor's journal equal to a
     fresh oracle's replay. Then a recovery run at the bench's
     KernelConfig: 64 closed-loop clients (2 point reads and 2 point
     writes over the 8192-key pool) to 1,000 commits, the worker hosting
     resolver.resolve REBOOT-killed at 30% and the one hosting
     proxy.commit at 65%, each kill an epoch recovery that recruits fresh
     card engines: equal to its oracle twin (committed count, the final
     keyspace, virtual time), 0 durability violations; committed txn/s in
     virtual and wall time, batches and graphs per generation, virtual and
     wall ms from each kill to the new epoch's first commit, peak device
     memory.
  19. bindings/backup phase: the stack tester's streams 201 and 202
     (bindings/stacktester.py) through a static cluster with two card
     resolvers at the specs' KernelConfig: journal and final keyspace
     byte-equal to the oracle run's, every card call equal to an oracle
     replay. Then a full-width backup: two dynamic clusters of the
     recovery run's shape in one simulation with card resolvers at the
     bench's KernelConfig, the recovery run's 64 clients to 1,000 commits;
     a BackupAgent starts after 500 commits, snapshots in 8 chunks with 3
     workers, finishes when the load is done and is restored into the
     second cluster: the restore equals the source read at the end
     version, and the run equals its oracle twin (commits, end version,
     restored rows, virtual time); committed txn/s before and during the
     backup, snapshot / finish / restore virtual and wall s, rows and log
     bytes moved, graphs, launches, peak device memory. Then
     tests/test_dr.py's DR switchover (seed 201) with card resolvers in
     both clusters: nothing lost, the locked source refuses user commits,
     equal to its oracle twin.
  20. real phase: the wall-clock cluster (real/cluster.py) of 4 OS-process
     nodes over 127.0.0.1 TCP, the first three also coordinators, started
     through real_node_main (a wrapper of real/node.py's main that records
     every engine its factory builds and reports on SIGTERM), every
     recruited resolver a TorchConflictEngine at the default KernelConfig:
     the Cycle ring over 1,000 keys and 500 transactions, then the
     launcher's backup -> wipe -> restore drill through a blobstore://
     HTTPBlobServer; each held to at least one card resolver, fixpoint
     launches in each node that recruited one, no plain fixpoint on a
     CUDA tensor, and every recorded call equal to a fresh oracle's
     replay. Then real/nemesis.py's fault campaign on the torch and
     device_loop card modes (seed 11, 8 s; the watchdog, the black-box
     journal and the trace export on): assert_slos, journal parity 0,
     every incident explained, the Chrome trace valid, forensics.explain
     of a resolved version, dispatch faults sorted by cause with none from
     the card; the crash-restart campaign on a card engine (its child
     instrumented by crash_child_main): parity across the crash, a
     complete recovery, the restarted child serving on the card, its
     blackout against resolver_recovery_budget_ms reported, not gated;
     the six recipes of the scenario atlas on the torch mode at 3.5 s each:
     every scorecard row and journal parity 0.
  21. sharded phase (sharded_phase): the fixpoint kernel's stacked entry
     (S sub-shards in one launch) against its plain version on the
     stacked step's own inputs at the bench shape with S in {1, 2, 8} (at
     S = 1 also against the single-table entry) and at the default
     KernelConfig with S = 8; SubshardedConflictEngine with 8 sub-shards
     at the bench's KernelConfig (the pool cut into 8 equal spans at heat
     64, heat 0 and tiered; adversarial splits at heat 64) on the columnar
     traffic through serve(): verdicts equal the oracle's and the
     single-table card engine's, the heat snapshots and history stats of
     the uniform and tiered engines equal CPU twins'; its one-chunk
     program's device ms and kernels against a single table's at the same
     config, and txn/s of both in turns; ShardedConflictEngine and
     MeshShardedConflictEngine (serial and overlapped) with 1, 2 and 4
     shards on the card: verdicts equal the oracle's, no blocking sync,
     mesh_stats; a ResolverPipeline at depth 2 over the 4-shard mesh
     engine; CycleTestTPU8 and RandomReadWriteTPU8 at seed 1 with 8-shard
     card resolvers, each equal to its oracle twin and every recorded
     resolve to a fresh oracle's replay; one mesh campaign (2 shards) at
     the atlas's 3.5 s.
  22. tools phase (tools_phase): each tool bench.py drives, through its
     entry point at bench.py's shape: ladder_bench.drive_bucket_ladder
     (the bench CFG, ladder 512/1024/2048; 0 builds and captures after
     warmup; every batch equal to the oracle twin's); floor_bench's floor
     sweep (both search modes, equal verdicts), apply sweep and loop
     floor at the 512-txn point; heat_bench.run_conflict_heat there
     (concentration rising with s, the split, on/off parity, device ms on
     against off; the sweep equal to CPU engines'); profile_kernel's
     variants at the bench shape (the fixpoint kernel equal to its plain
     version); the native engine's txn/s; recovery_bench.run_rewarm in
     two fresh processes on the card; a cli session and a one-shot `cli
     status` over dynamic clusters with card resolvers, and `fdbbackup
     restore` and `dr` with card resolvers (every card call equal to a
     fresh oracle's replay, the text but the engine views and the
     backup results equal to oracle twins').
  23. smokes phase (smokes_phase): the six smokes that build card engines,
     each through its run(device="cuda"): heat_smoke (hot ranges cover the
     planted keys, split balance, strict exposition, no heat in a heat-off
     engine's outputs or captured programs), history_smoke (parity with
     the oracle across monolithic and tiered engines, 0 builds and
     captures after warmup, exposition; its apply speedup against the
     1.5x bar printed, reported, not gated), perf_smoke (ledger rows,
     peak bytes, sampling on/off parity, 0 blocking syncs, the trend
     gate), reshard_smoke (split and merge, blackout within 250 ms, 0
     steady builds, journal parity), mesh_smoke (8 shards stacked on the
     card: live and journal parity across an epoch flip, the stacked
     entry, 0 blocking syncs) and crash_smoke (kill -9 and recovery in
     budget, its child instrumented by crash_child_main). Every check of
     each is gated but history's speedup; every resolve of the heat and
     perf smokes' engines is replayed through a fresh oracle (a twin).
  The oracle twins of phases 17-19 and 21-23, and the CPU twins of 21
  and 22, run together in 6 worker processes after the last card run
  (phase 23's), the longest first.

Each path's kernel launches are counted from 0 just before it and read
just after (a captured graph's fixpoint launches are counted at each
replay: FIXPOINT.graph_launches, n for a loop replay at fill n; the
stacked entry's in FIXPOINT_STACKED); a path that launched none fails.
The graph-step, columnar and loop phases also read a replay's fixpoint
kernels from the card's trace (torch.profiler): C per C-step graph and n
per loop replay at fill n, or they fail.

It prints a `kernels` JSON line (both fixpoint entries), the card line,
and last
{"ok": true, "device": {...}}. Any failed check exits non-zero with no
result line; so does a machine without CUDA, or a directory holding this
file without the package.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and the
#: non-tensor float32 rate, the table's peak for scalar ALU work
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
GC_LAG_BATCHES = 4
#: the data: one seed, an 8192-key hot pool of 16-byte keys (bench.py:55),
#: 8 distinct batches cycled as bench.py cycles them, and a 20000-key pool
#: for the engine's byte keys
SEED = 2026
POOL_KEYS = 8192
N_DISTINCT = 8
BYTE_KEYS = 20000
#: txns of the deep-chain batch: 1023 links, so 1024 rounds
CHAIN_TXNS = 1024
#: chunks of the graph-step phase's captured scan
GRAPH_C = 8
#: the columnar engine's ladder and scan sizes, and its batch sizes: with
#: 2 point reads per txn a chunk holds at most 2048 txns, so these reach
#: every bucket and scans of 1, 2, 4 and 8 top-bucket chunks
LADDER = (512, 1024, 2048)
SCANS = (2, 4, 8)
COLUMNAR_SIZES = [200, 300, 900, 1800, 4000, 9000, 20000]
#: read-only batches (point reads only) inserted into that traffic, at
#: these positions: they append no run under the tiered structure
READ_ONLY = {5: 3000, 7: 6000}
VERSION_STEP = 5000
#: runs of each pipeline configuration
PIPELINE_RUNS = 3
#: txns of the engine phases' resolve() batches
ENGINE_SIZES = [256, 384, 512, 512, 1500, 3000, 4500, 6000]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_cfg(ck):
    """The bench's north-star shape (bench.py:36-52), fixpoint by device."""
    return ck.KernelConfig(key_words=4, capacity=24576, max_point_reads=8192,
                           max_point_writes=8192, max_reads=256, max_writes=256,
                           max_txns=4096)


# ---------------------------------------------------------------------------
# packed batches, made on the host from a seed and moved to the card once
# ---------------------------------------------------------------------------

def key_pool(cfg, rng):
    """The hot pool: POOL_KEYS random 16-byte keys, packed and sorted."""
    import numpy as np

    K = cfg.lanes
    pool = np.zeros((POOL_KEYS, K), np.uint32)
    pool[:, :4] = rng.integers(0, 2**32, size=(POOL_KEYS, 4), dtype=np.uint32)
    pool[:, K - 1] = 16
    return pool[np.lexsort([pool[:, c] for c in range(K - 1, -1, -1)])]


def synth_packed(cfg, rng, pool):
    """One batch in packed form: 2 point reads and 2 point writes per txn
    over the hot pool (the Cycle / RandomReadWrite shape), plus full range
    groups — [pool[i], pool[i+d]) with d in 1..4 — so the ovw and ovrp
    terms of the fixpoint run."""
    import numpy as np

    T = cfg.max_txns
    pool_n = pool.shape[0]

    def point_rows(cap):
        per = cap // T
        keys = pool[rng.integers(0, pool_n, size=cap)]
        return keys, np.repeat(np.arange(T, dtype=np.int32), per)

    def range_rows(cap):
        i = rng.integers(0, pool_n - 5, size=cap)
        d = rng.integers(1, 5, size=cap)
        txn = np.sort(rng.integers(0, T, size=cap)).astype(np.int32)
        return pool[i], pool[i + d], txn

    rpb, rp_txn = point_rows(cfg.rp)
    wpb, wp_txn = point_rows(cfg.wp)
    rb, re, r_txn = range_rows(cfg.max_reads)
    wb, we, w_txn = range_rows(cfg.max_writes)
    return {
        "rpb": rpb, "rp_snap": np.zeros(cfg.rp, np.int32), "rp_txn": rp_txn,
        "rp_valid": np.ones(cfg.rp, bool),
        "rb": rb, "re": re, "r_snap": np.zeros(cfg.max_reads, np.int32), "r_txn": r_txn,
        "r_valid": np.ones(cfg.max_reads, bool),
        "wpb": wpb, "wp_txn": wp_txn, "wp_valid": np.ones(cfg.wp, bool),
        "wb": wb, "we": we, "w_txn": w_txn, "w_valid": np.ones(cfg.max_writes, bool),
        "t_ok": np.ones(T, bool), "t_too_old": np.zeros(T, bool),
        "now": 0, "gc": 0,
    }


def versioned(cfg, batch, now: int, rng=None):
    """The bench's version schedule (bench.py:196-205): snapshots half a
    batch behind `now`, the GC horizon GC_LAG_BATCHES batches behind. With
    `rng`, each txn's snapshot lies up to two batches behind instead, so
    reads also hit history. `now` and `gc` become 0-d device tensors made
    by a fill, not a copy, so nothing waits on the card; the step is told
    the GC branch (`gc_branch(batch)`) instead of reading it."""
    import torch

    T = cfg.max_txns
    gc = max(now - GC_LAG_BATCHES * T, 0)
    dev = batch["t_ok"].device
    out = dict(batch, now=torch.full((), now, dtype=torch.int32, device=dev),
               gc=torch.full((), gc, dtype=torch.int32, device=dev), _gc=gc)
    if rng is None:
        out["rp_snap"] = torch.full_like(batch["rp_snap"], max(now - T // 2, 0))
        out["r_snap"] = torch.full_like(batch["r_snap"], max(now - T // 2, 0))
    else:
        snap = torch.from_numpy(now - rng.integers(1, 2 * T, size=T)).to(
            batch["rp_snap"].device, torch.int32).clamp_(min=0)
        out["rp_snap"] = snap[batch["rp_txn"].long()]
        out["r_snap"] = snap[batch["r_txn"].long()]
    return out, now + T - gc


def gc_branch(batch) -> bool:
    return batch["_gc"] > 0


def cuda_ms(fn, repeats: int, samples: int = 5) -> float:
    """Median over `samples` of the CUDA-event time of `repeats` calls run
    back to back, per call, after one warm call: what a call costs its
    caller, the host's time for it included where the host falls behind
    the card."""
    import torch

    fn()
    times = []
    for _ in range(samples):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(repeats):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / repeats)
    return statistics.median(times)


def device_ms(fn, calls: int, samples: int = 5) -> float:
    """Median over `samples` of the device time per call of `calls` calls
    queued behind a spin kernel, so that all of them are on the card's
    queue before the first one starts: the kernel's own time on the card
    (with the card's gap between launches), without the wrapper's host
    time. A sample counts only if the spin outlasted the queueing; else the
    spin doubles. (A torch.profiler trace of the same launches lost some or
    all of its kernel events in 2 of 12 runs, so the events are timed
    directly.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    spin = 10_000_000                       # cycles: ~6 ms at 1.7 GHz
    times = []
    while len(times) < samples:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        ahead = not a.query()               # the spin was still running
        torch.cuda.synchronize()
        if ahead:
            times.append(a.elapsed_time(b) / calls)
        else:
            spin *= 2
            check(spin < 2**36, "the host never got ahead of the card")
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def kernel_phase(ck, fc, cfg, dev, rng, n_batches: int):
    """Kernel vs plain fixpoint on the same local_phases outputs, batch by
    batch, on an evolving table."""
    import torch

    pool = key_pool(cfg, rng)
    batches = [ck.batch_from_numpy(cfg, synth_packed(cfg, rng, pool), dev)
               for _ in range(N_DISTINCT)]
    state = ck.initial_state(cfg, device=dev)
    now = 1
    for i in range(GC_LAG_BATCHES + 2):           # warm the table first
        batch, now = versioned(cfg, batches[i % N_DISTINCT], now)
        state, _ = ck.resolve_step(cfg, state, batch, gc_branch(batch))
    commits = aborts = mixed = 0
    rounds = []
    last = None
    hist_hit_txns = 0
    for i in range(n_batches):
        batch, nxt = versioned(cfg, batches[i % N_DISTINCT], now, rng)
        hist, edges, wpos = ck.local_phases(cfg, state, batch)
        got = fc.commit_fixpoint_kernel(cfg, batch["t_ok"], hist, edges, batch)
        want = fc.commit_fixpoint_plain(cfg, batch["t_ok"], hist, edges, batch)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"kernel and plain fixpoint disagree on batch {i} at "
              f"{int((got != want).sum())} of {cfg.max_txns} txns")
        c = int(got.sum())
        hist_hit_txns += int((hist > 0).sum())
        commits += c
        aborts += cfg.max_txns - c
        mixed += 0 < c < cfg.max_txns
        rounds.append(int(fc.FIXPOINT.last_rounds.item()))
        state, overflow, _ = ck.apply_writes_and_gc(cfg, state, batch, got, wpos,
                                                    gc_branch(batch))
        check(not bool(overflow), f"table overflow in the kernel phase, batch {i}")
        now = nxt
        last = (batch, hist, edges)
    check(mixed == n_batches, f"only {mixed} of {n_batches} batches had a real abort mix")
    check(hist_hit_txns > 0, "no read hit history in the kernel phase")

    batch, hist, edges = last
    kernel = lambda: fc.commit_fixpoint_kernel(cfg, batch["t_ok"], hist, edges, batch)  # noqa: E731
    kernel_ms = device_ms(kernel, 20)
    call_ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(lambda: fc.commit_fixpoint_plain(cfg, batch["t_ok"], hist, edges, batch), 1)
    r = rounds[-1]
    # the kernel's floor at this shape: a batch with no rows, one round, so
    # only the launch, the setup of the shared tables and one mask rebuild
    _, empty = replay_phase(ck, fc, cfg, state,
                            ck.batch_from_numpy(cfg, chain_packed(ck, cfg, 0), dev))
    check(empty["rounds"] == 1, f"an empty batch took {empty['rounds']} rounds")
    return {
        "batches": n_batches, "mismatches": 0, "commits": commits, "aborts": aborts,
        "history_hit_txns": hist_hit_txns,
        "rounds_median": statistics.median(rounds), "rounds_max": max(rounds),
        "rounds_timed": r, "kernel_ms": kernel_ms, "call_ms": call_ms, "plain_ms": plain_ms,
        "empty_ms": empty["kernel_ms"],
        **fixpoint_bound(cfg, batch, hist, edges, r),
    }


def fixpoint_bound(cfg, batch, hist, edges, rounds: int):
    """The least time the card could take for one fixpoint on these inputs,
    counting what this data needs: t_ok, the history hits and every valid
    flag read once; the txn, gid slot and edge words of the VALID rows only
    (an invalid row's edge words are zero and decide nothing); the output
    written once — over HBM, against the ALU work `rounds` rounds of the
    valid rows need (the word ANDs, the writer masks, the bitmap update)."""
    T, WRW, WPW = cfg.max_txns, cfg.wr_words, cfg.wp_words
    nrp, nrr = int(batch["rp_valid"].sum()), int(batch["r_valid"].sum())
    nwp, nwr = int(batch["wp_valid"].sum()), int(batch["w_valid"].sum())
    in_bytes = (5 * T + cfg.rp + cfg.max_reads + cfg.wp + cfg.max_writes  # t_ok, hist, flags
                + nrp * (8 + 4 * WRW)              # rp_txn, gid_rp, the ovw row
                + nrr * (4 + 4 * (WRW + WPW))      # r_txn, the ovw and ovrp rows
                + nwp * 8 + nwr * 4                # wp_txn, gid_wp; w_txn
                + T + 4)                           # committed, rounds
    ops = rounds * (nrp * (2 + 2 * WRW) + nrr * 2 * (WRW + WPW) + 3 * (nwp + nwr) + 3 * T // 32)
    bytes_ms = in_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ALU_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "input_bytes": in_bytes, "ops": ops}


def replay_phase(ck, fc, cfg, state, batch, repeats: int = 20):
    """local_phases on one recorded (state, batch), then kernel vs plain:
    bit-equal verdicts; the kernel timed. Returns (committed, results)."""
    import torch

    hist, edges, _ = ck.local_phases(cfg, state, batch)
    got = fc.commit_fixpoint_kernel(cfg, batch["t_ok"], hist, edges, batch)
    rounds = int(fc.FIXPOINT.last_rounds.item())
    want = fc.commit_fixpoint_plain(cfg, batch["t_ok"], hist, edges, batch)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"kernel and plain fixpoint disagree at "
          f"{int((got != want).sum())} of {cfg.max_txns} txns")
    kernel = lambda: fc.commit_fixpoint_kernel(cfg, batch["t_ok"], hist, edges, batch)  # noqa: E731
    kernel_ms = device_ms(kernel, repeats)
    call_ms = cuda_ms(kernel, repeats)
    return got, {
        "rounds": rounds, "kernel_ms": kernel_ms, "call_ms": call_ms, "commits": int(got.sum()),
        "txns": int(batch["t_ok"].sum()), "valid_point_reads": int(batch["rp_valid"].sum()),
        "valid_range_reads": int(batch["r_valid"].sum()),
        "nonzero_edge_words": int((edges["ovw"] != 0).sum() + (edges["ovrp"] != 0).sum()),
        **fixpoint_bound(cfg, batch, hist, edges, rounds)}


def stacked_bound(cfg, batch, rounds: int):
    """fixpoint_bound for the stacked entry: every sub-shard's valid rows,
    history hits and flags, t_ok and the output once."""
    import numpy as np

    S = batch["t_ok"].shape[0]
    parts = [fixpoint_bound(cfg, {k: v[s] for k, v in batch.items()}, None, None, rounds)
             for s in range(S)]
    T = cfg.max_txns
    in_bytes = sum(p["input_bytes"] for p in parts) - (S - 1) * (2 * T + 4)  # t_ok, committed
    ops = sum(p["ops"] for p in parts)
    bytes_ms = in_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ALU_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "input_bytes": int(in_bytes), "ops": int(np.int64(ops))}


def sharded_kernel_phase(ck, fc, cfg, dev, rng, S: int, n_batches: int):
    """The fixpoint kernel's stacked entry against its plain version on the
    stacked step's own inputs: S sub-shard tables on the card, each fed
    its own packed batch over its own hot pool (the sub-shards share the
    txn space), the stacked phases 1-2, then both fixpoints on the same
    inputs, batch by batch on evolving tables; at S = 1 also the
    single-table entry on the same inputs. Times the stacked entry (device
    ms behind a spin), its call and the plain version."""
    import torch

    pools = [key_pool(cfg, rng) for _ in range(S)]
    packed = [[synth_packed(cfg, rng, pools[s]) for s in range(S)] for _ in range(N_DISTINCT)]
    for per in packed:              # the sub-shards share t_ok / t_too_old
        for b in per[1:]:
            b["t_ok"], b["t_too_old"] = per[0]["t_ok"], per[0]["t_too_old"]
    batches = [ck._stack([ck.batch_from_numpy(cfg, b, dev) for b in per]) for per in packed]
    state = ck._stack([ck.initial_state(cfg, device=dev) for _ in range(S)])

    def versioned_stack(batch, now, rng=None):
        T = cfg.max_txns
        gc = max(now - GC_LAG_BATCHES * T, 0)
        out = dict(batch, now=torch.full((S,), now, dtype=torch.int32, device=dev),
                   gc=torch.full((S,), gc, dtype=torch.int32, device=dev), _gc=gc)
        if rng is None:
            out["rp_snap"] = torch.full_like(batch["rp_snap"], max(now - T // 2, 0))
            out["r_snap"] = torch.full_like(batch["r_snap"], max(now - T // 2, 0))
        else:
            snap = torch.from_numpy(now - rng.integers(1, 2 * T, size=T)).to(
                dev, torch.int32).clamp_(min=0)
            out["rp_snap"] = snap[batch["rp_txn"].long()]
            out["r_snap"] = snap[batch["r_txn"].long()]
        return out, now + T - gc

    def strip(b):
        return {k: v for k, v in b.items() if k != "_gc"}

    now = 1
    for i in range(GC_LAG_BATCHES + 2):           # warm the tables first
        batch, now = versioned_stack(batches[i % N_DISTINCT], now)
        state, _ = ck.resolve_step_stacked(cfg, state, strip(batch), gc_branch(batch))
    rounds, mixed, hist_hits, single_equal = [], 0, 0, 0
    last = None
    for i in range(n_batches):
        batch, nxt = versioned_stack(batches[i % N_DISTINCT], now, rng)
        b = strip(batch)
        hist, edges, wpos = ck.detect_step_stacked(cfg, state, b)
        got = fc.commit_fixpoint_stacked_kernel(cfg, b["t_ok"][0], hist, edges, b)
        want = fc.commit_fixpoint_stacked_plain(cfg, b["t_ok"][0], hist, edges, b)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"stacked kernel and plain fixpoint disagree at S={S} on batch {i} at "
              f"{int((got != want).sum())} of {cfg.max_txns} txns")
        rounds.append(int(fc.FIXPOINT_STACKED.last_rounds.item()))
        if S == 1:
            one = fc.commit_fixpoint_kernel(cfg, b["t_ok"][0], hist[0],
                                            {k: v[0] for k, v in edges.items()},
                                            {k: v[0] for k, v in b.items()})
            torch.cuda.synchronize()
            check(torch.equal(got, one), f"the stacked entry at S=1 differs from the single-"
                  f"table entry on batch {i}")
            check(int(fc.FIXPOINT.last_rounds.item()) == rounds[-1],
                  "the stacked entry at S=1 took other rounds than the single-table entry")
            single_equal += 1
        c = int(got.sum())
        mixed += 0 < c < cfg.max_txns
        hist_hits += int((hist.sum(0) > 0).sum())
        state, overflow = ck.apply_step_stacked(cfg, state, b, got, wpos, gc_branch(batch))
        check(not bool(overflow), f"table overflow in the stacked kernel phase, batch {i}")
        now = nxt
        last = (b, hist, edges)
    check(mixed == n_batches, f"only {mixed} of {n_batches} stacked batches had an abort mix")
    check(hist_hits > 0, "no read hit history in the stacked kernel phase")
    b, hist, edges = last
    kernel = lambda: fc.commit_fixpoint_stacked_kernel(cfg, b["t_ok"][0], hist, edges, b)  # noqa: E731
    kernel_ms = device_ms(kernel, 20)
    call_ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(lambda: fc.commit_fixpoint_stacked_plain(cfg, b["t_ok"][0], hist, edges,
                                                                b), 1)
    plan = fc.launch_plan_stacked(cfg, S)
    return {"S": S, "batches": n_batches, "mismatches": 0, "single_entry_equal": single_equal,
            "rounds_median": statistics.median(rounds), "rounds_max": max(rounds),
            "rounds_timed": rounds[-1], "kernel_ms": kernel_ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "wtx_in_smem": plan["wtx_in_smem"],
            "smem_bytes": plan["smem_bytes"],
            "scratch_bytes": plan["entry_scratch_bytes"] + plan["point_scratch_bytes"]
            + plan["wtx_bytes"] + plan["gid_table_bytes"],
            **stacked_bound(cfg, b, rounds[-1])}


def chain_packed(ck, cfg, n: int):
    """A deep chain of n txns over point rows: txn i reads the key txn i-1
    writes. The fixpoint settles one link per round: n rounds in all."""
    import numpy as np

    T = cfg.max_txns
    key = [b"c%05d" % i for i in range(n)]
    t_ok = np.zeros((T,), bool)
    t_ok[:n] = True
    return ck.build_batch_arrays(
        cfg, key[:-1], [0] * (n - 1), list(range(1, n)), [], [], [], [],
        key, list(range(n)), [], [], [], t_ok, np.zeros((T,), bool), 10, 0)


def chain_phase(ck, fc, cfg, dev):
    """The deep chain on an empty table: bit-equal, n rounds, and the
    alternating verdicts the chain must give."""
    import torch

    batch = ck.batch_from_numpy(cfg, chain_packed(ck, cfg, CHAIN_TXNS), dev)
    got, out = replay_phase(ck, fc, cfg, ck.initial_state(cfg, device=dev), batch, repeats=3)
    check(out["rounds"] == CHAIN_TXNS, f"deep chain took {out['rounds']} rounds, "
          f"expected {CHAIN_TXNS}")
    alt = torch.arange(CHAIN_TXNS, device=dev) % 2 == 0
    check(torch.equal(got[:CHAIN_TXNS], alt), "deep chain verdicts do not alternate")
    return out


def step_phase(ck, cfg, dev, rng, steps: int):
    """resolve_step on device-resident batches, the bench's GC lag."""
    import torch

    pool = key_pool(cfg, rng)
    batches = [ck.batch_from_numpy(cfg, synth_packed(cfg, rng, pool), dev)
               for _ in range(N_DISTINCT)]
    state = ck.initial_state(cfg, device=dev)
    now = 1
    flags = []

    def run(n, i0):
        nonlocal state, now
        for i in range(i0, i0 + n):
            batch, now = versioned(cfg, batches[i % N_DISTINCT], now)
            state, out = ck.resolve_step(cfg, state, batch, gc_branch(batch))
            flags.append(out["overflow"])

    run(2 * N_DISTINCT, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps, 2 * N_DISTINCT)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(not bool(torch.stack(flags).any()), "table overflow in the step phase")
    n = int(state["n"])
    check(0 < n <= cfg.capacity, f"table occupancy {n} out of range")
    out = {"steps": steps, "ms_per_batch": dt / steps * 1e3,
           "txn_per_s": cfg.max_txns * steps / dt, "table_rows": n}

    # a short profiled window: device kernel time by kernel name, and the
    # share of the window's wall time the device spent in kernels
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n_prof, 2 * N_DISTINCT + steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, launches = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            launches += 1
    check(not bool(torch.stack(flags).any()), "table overflow in the profiled steps")
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out["profile"] = {
        "steps": n_prof, "wall_ms_per_step": wall_us / n_prof / 1e3,
        "device_ms_per_step": busy_us / n_prof / 1e3,
        "device_busy_share": busy_us / wall_us if busy_us else None,
        "kernels_per_step": launches / n_prof,
        "top": [(name[:90], us / n_prof / 1e3) for name, us in top],
    }
    return out


def byte_txns(rng, n, now, long_frac):
    """CommitTransactions over 16-byte keys: 2 point reads and 2 point
    writes each, some range reads / range clears, and — at `long_frac` —
    keys past the 16-byte window, which take the host long-key tier."""
    from foundationdb_tpu_torch.core.types import CommitTransaction, KeyRange

    def key():
        if rng.random() < long_frac:
            return b"L/%06d/" % rng.integers(0, 500) + b"x" * int(rng.integers(9, 64))
        return b"k/%014d" % rng.integers(0, BYTE_KEYS)

    txns = []
    for _ in range(n):
        t = CommitTransaction(read_snapshot=int(max(0, now - rng.integers(1, 4 * 4096))))
        for _ in range(2):
            k = key()
            t.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
        if rng.random() < 0.1:
            a = int(rng.integers(0, BYTE_KEYS - 8))
            t.read_conflict_ranges.append(
                KeyRange(b"k/%014d" % a, b"k/%014d" % (a + int(rng.integers(1, 8)))))
        for _ in range(2):
            k = key()
            t.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
        if rng.random() < 0.05:
            a = int(rng.integers(0, BYTE_KEYS - 8))
            t.write_conflict_ranges.append(
                KeyRange(b"k/%014d" % a, b"k/%014d" % (a + int(rng.integers(1, 8)))))
        txns.append(t)
    return txns


def byte_traffic(rng, sizes):
    """(txns, now, oldest) of the engine phases: byte_txns batches, long
    keys in every third batch from the second, the GC horizon moving on
    odd batches."""
    out, now, oldest = [], 10_000, 0
    for b, n in enumerate(sizes):
        now += 4096
        if b % 2:
            oldest = now - 2 * 4096
        out.append((byte_txns(rng, n, now, long_frac=0.02 if b % 3 == 1 else 0.0), now, oldest))
    return out


def engine_phase(fc, he, oracle_mod, dev, cfg, traffic, oracle_batches: int,
                 structure="monolithic", card_reference=None):
    """The main path: resolve() on the card vs the same engine on the CPU
    (every batch), the oracle (the first `oracle_batches` batches) and,
    where given, another card engine's verdicts (`card_reference`, one list
    per batch). Returns (the largest chunk's recorded arrays and table,
    results, verdicts per batch)."""
    import torch

    gpu = he.TorchConflictEngine(cfg, history_structure=structure)
    gpu.warmup(scan_sizes=())            # the general router's one program
    cpu = he.TorchConflictEngine(cfg, device="cpu", history_structure=structure)
    # record the packed arrays (and the table they meet) of the largest
    # chunk, fused or split-step. Inside the timed resolve, so it takes
    # references and one stream-ordered copy of the table, which the
    # engine updates in place.
    captured = {"txns": -1}

    def recording(run):
        def wrapped(per_shard):
            n = int(per_shard[0]["t_ok"].sum())
            if n > captured["txns"]:
                captured.update(txns=n, arrays=per_shard[0],
                                state={k: v.clone() for k, v in gpu.state.items()})
            return run(per_shard)
        return wrapped

    gpu._run_step = recording(gpu._run_step)
    gpu._run_detect = recording(gpu._run_detect)
    ora = oracle_mod.OracleConflictEngine()
    counts = [0, 0, 0]
    gpu_s = 0.0
    verdicts = []
    fc.FIXPOINT.reset_counts()
    for b, (txns, now, oldest) in enumerate(traffic):
        t0 = time.perf_counter()
        got = [int(v) for v in gpu.resolve(txns, now, oldest)]
        torch.cuda.synchronize()
        gpu_s += time.perf_counter() - t0
        want = [int(v) for v in cpu.resolve(txns, now, oldest)]
        check(got == want, f"{structure} engine batch {b}: card and CPU verdicts differ at "
              f"{sum(g != w for g, w in zip(got, want))} of {len(txns)} txns")
        if card_reference is not None:
            check(got == card_reference[b], f"{structure} engine batch {b}: verdicts differ "
                  "from the monolithic card engine's")
        if b < oracle_batches:
            ref = [int(v) for v in ora.resolve(txns, now, oldest)]
            check(got == ref, f"{structure} engine batch {b}: verdicts differ from the oracle")
        verdicts.append(got)
        for v in got:
            counts[v] += 1
    eager, graph = fc.FIXPOINT.launches, fc.FIXPOINT.graph_launches
    launches = eager + graph
    plain_cuda = fc.FIXPOINT.plain_cuda_calls
    check(launches > 0, f"the {structure} engine path never launched the fixpoint kernel")
    check(plain_cuda == 0, f"the {structure} engine path ran the plain fixpoint on CUDA tensors")
    check(gpu._tier_has_writes, "no long-key write reached the host tier")
    check(min(counts) > 0, f"verdict mix lacks a class: {counts}")
    return captured, {
        "structure": gpu.history_structure, "batches": len(traffic),
        "txns": sum(len(t) for t, _, _ in traffic), "oracle_batches": oracle_batches,
        "launches": launches, "eager_launches": eager, "graph_launches": graph,
        "merges": gpu.perf.merges,
        "conflict": counts[0], "too_old": counts[1],
        "committed": counts[2], "card_resolve_s": gpu_s}, verdicts


# ---------------------------------------------------------------------------
# the serving path: captured chunk scans, the columnar engine, the pipeline
# ---------------------------------------------------------------------------

#: the fixpoint kernel's name in a device trace (csrc/fixpoint.cu)
FIXPOINT_KERNEL = "commit_fixpoint_kernel"


def profile_window(run, units: int, kernel: str = FIXPOINT_KERNEL):
    """torch.profiler over `units` calls of run(): wall ms per call, device
    kernel ms per call, the device's busy share of the wall time, kernel
    launches per call (kernels replayed from a CUDA graph included), and of
    them the fixpoint kernels the card ran per call, read from the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(units):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, launches, fixpoints = 0.0, 0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
            launches += 1
            fixpoints += kernel in e.name
    return {"wall_ms": wall_us / units / 1e3, "device_ms": busy_us / units / 1e3,
            "device_busy_share": busy_us / wall_us if busy_us else None,
            "kernels": launches / units, "fixpoint_kernels": fixpoints / units}


def traced_replays(run, units: int, fixpoints: int, what: str, kernel: str = FIXPOINT_KERNEL):
    """profile_window over `units` calls of a graph replay that must run
    `fixpoints` fixpoint kernels (named `kernel`) on the card each. A trace
    that shows more fails; one that shows fewer is taken again, up to 3
    traces in all, since a trace can lose kernel events (see device_ms)."""
    for attempt in range(1, 4):
        pw = profile_window(run, units, kernel)
        check(pw["fixpoint_kernels"] <= fixpoints, f"the card ran {pw['fixpoint_kernels']} "
              f"fixpoint kernels per replay of {what}, expected {fixpoints}")
        if pw["fixpoint_kernels"] == fixpoints:
            return dict(pw, traces=attempt)
    fail(f"3 traces of {what} show {pw['fixpoint_kernels']} fixpoint kernels per replay, "
         f"expected {fixpoints}")


def graph_step_phase(ck, fc, he, cfg, dev, rng, units: int):
    """The step phase's packed batches (same generator, same pool) through
    the captured chunk scan of C = GRAPH_C at the bench shape, against the
    eager step on the same schedule: unit u is GRAPH_C chunks at one
    version, the GC horizon GC_LAG_BATCHES batches behind on its last
    chunk, as the chunks of one engine batch run. Statuses and overflow
    flags must be equal on every chunk."""
    import torch

    T = cfg.max_txns
    pool = key_pool(cfg, rng)
    batches = [ck.batch_from_numpy(cfg, synth_packed(cfg, rng, pool), dev)
               for _ in range(N_DISTINCT)]
    eng = he.TorchConflictEngine(cfg, device=dev, scan_sizes=(GRAPH_C,))
    t0 = time.perf_counter()
    prog = eng._program(cfg, GRAPH_C)
    capture_s = time.perf_counter() - t0
    sched, now = [], 1
    for u in range(units):
        gc = max(now - GC_LAG_BATCHES * T, 0)
        rows = []
        for c in range(GRAPH_C):
            b = dict(batches[(u * GRAPH_C + c) % N_DISTINCT])
            last = c == GRAPH_C - 1
            b["now"] = torch.full((), now, dtype=torch.int32, device=dev)
            b["gc"] = torch.full((), gc if last else 0, dtype=torch.int32, device=dev)
            b["rp_snap"] = torch.full_like(b["rp_snap"], max(now - T // 2, 0))
            b["r_snap"] = torch.full_like(b["r_snap"], max(now - T // 2, 0))
            rows.append(b)
        inputs = {k: torch.stack([ck._u32_to_i32(b[k]) if k in ck.KEY_FIELDS else b[k]
                                  for b in rows]) for k in prog.inputs}
        sched.append((rows, inputs, gc > 0))
        now = now + T - gc

    def eager(out=None):
        state = ck.initial_state(cfg, device=dev)
        for rows, _, gc_last in sched:
            for c, b in enumerate(rows):
                state, o = ck.resolve_step(cfg, state, b, gc_last and c == GRAPH_C - 1)
                if out is not None:
                    out.append((o["status"], o["overflow"]))
        return state

    replay_host_s = []

    def graph(out=None):
        eng._reset_device_state(0)
        for _, inputs, gc_last in sched:
            for k, v in inputs.items():
                prog.inputs[k].copy_(v)
            t0 = time.perf_counter()
            prog.run(gc_last)
            replay_host_s.append(time.perf_counter() - t0)
            if out is not None:
                out.append((prog.status.clone(), prog.overflow.clone()))

    want, got = [], []
    eager(want)
    fc.FIXPOINT.reset_counts()
    graph(got)
    launches = fc.FIXPOINT.graph_launches
    check(fc.FIXPOINT.plain_cuda_calls == 0 and fc.FIXPOINT.launches == 0,
          "the graph replays ran a fixpoint outside the graph")
    check(launches == units * GRAPH_C, f"{launches} fixpoint launches in {units} replays")
    want_s = torch.stack([s for s, _ in want])
    got_s = torch.cat([s for s, _ in got])
    check(torch.equal(got_s, want_s), f"graph and eager statuses differ at "
          f"{int((got_s != want_s).sum())} of {want_s.numel()} txns")
    check(torch.equal(torch.cat([o for _, o in got]), torch.stack([o for _, o in want])),
          "graph and eager overflow flags differ")
    check(not bool(torch.stack([o for _, o in want]).any()), "table overflow in the graph phase")
    statuses = torch.bincount(want_s.flatten().long(), minlength=3).tolist()
    check(statuses[0] > 0 and statuses[2] > 0, f"no abort mix in the graph phase: {statuses}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    chunks = units * GRAPH_C
    eager_s, graph_s = timed(eager), timed(graph)
    eager_s2, graph_s2 = timed(eager), timed(graph)
    n_prof = 2
    it = iter(range(10**9))

    def one_unit():
        rows, inputs, gc_last = sched[next(it) % units]
        for k, v in inputs.items():
            prog.inputs[k].copy_(v)
        prog.run(gc_last)

    gp = traced_replays(one_unit, n_prof, GRAPH_C, f"the {GRAPH_C}-step graph")
    state = ck.initial_state(cfg, device=dev)

    def eager_unit():
        nonlocal state
        rows, _, gc_last = sched[next(it) % units]
        for c, b in enumerate(rows):
            state, _ = ck.resolve_step(cfg, state, b, gc_last and c == GRAPH_C - 1)

    ep = profile_window(eager_unit, n_prof)
    return {
        "units": units, "C": GRAPH_C, "chunks": chunks, "mismatches": 0, "launches": launches,
        "verdicts": statuses, "capture_s": capture_s, "captures": eng.perf.captures,
        "fixpoint_launches_per_replay": launches / units,
        "fixpoint_kernels_per_replay_traced": gp["fixpoint_kernels"],
        "graph_ms_per_batch": [graph_s / chunks * 1e3, graph_s2 / chunks * 1e3],
        "eager_ms_per_batch": [eager_s / chunks * 1e3, eager_s2 / chunks * 1e3],
        "graph_txn_per_s": T * chunks / min(graph_s, graph_s2),
        "eager_txn_per_s": T * chunks / min(eager_s, eager_s2),
        "graph_profile": {k: (v / GRAPH_C if k in ("wall_ms", "device_ms") else v)
                          for k, v in gp.items()},
        "eager_profile": {k: (v / GRAPH_C if k in ("wall_ms", "device_ms") else v)
                          for k, v in ep.items()},
        "kernels_per_replay": gp["kernels"],
        "replay_host_ms": statistics.median(replay_host_s) * 1e3,
    }


def columnar_traffic(rng, sizes, read_only, step=VERSION_STEP):
    """Point-only CommitTransactions (bench.py:46-49): 2 point reads and 2
    point writes per txn over one hot pool of POOL_KEYS 16-byte keys, with
    batches of `read_only` ({position: txns}) holding the reads alone.
    Versions advance `step` a batch; the GC horizon trails by
    GC_LAG_BATCHES batches, and ~3% of snapshots lie behind it (too old).
    Each txn's wire block is encoded here, as a client encodes its commit
    request once: the timed pack is the resolver's."""
    from foundationdb_tpu_torch.core.types import CommitTransaction, KeyRange

    plan = [(n, False) for n in sizes]
    for pos in sorted(read_only):
        plan.insert(pos, (read_only[pos], True))
    out, now = [], 10_000
    for b, (n, reads_only) in enumerate(plan):
        now += step
        oldest = max(0, now - GC_LAG_BATCHES * step)
        lag = rng.integers(1, 2 * step, size=n)
        old = rng.random(n) < 0.03
        lag[old] = rng.integers((GC_LAG_BATCHES + 1) * step,
                                (GC_LAG_BATCHES + 2) * step, size=int(old.sum()))
        keys = rng.integers(0, POOL_KEYS, size=(n, 4))
        txns = []
        for i in range(n):
            t = CommitTransaction(read_snapshot=int(max(0, now - lag[i])))
            for j in range(2 if reads_only else 4):
                k = b"h/%014d" % keys[i, j]
                (t.read_conflict_ranges if j < 2 else t.write_conflict_ranges).append(
                    KeyRange(k, k + b"\x00"))
            t.conflict_wire_info()
            txns.append(t)
        out.append((txns, now, oldest))
    return out


def warmed(eng):
    """warmup() `eng` on an emptied cache: (seconds, memory reserved before
    and after, IF nodes and WHILE nodes captured)."""
    import torch

    from foundationdb_tpu_torch.ops import graph_if

    torch.cuda.synchronize()
    torch.cuda.empty_cache()            # what earlier phases left cached
    mem0 = torch.cuda.memory_reserved()
    ifs, whiles = graph_if.GRAPH_IF.nodes, graph_if.GRAPH_IF.while_nodes
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    return {"warmup_s": time.perf_counter() - t0, "memory_reserved_before_warmup": mem0,
            "memory_reserved_after_warmup": torch.cuda.memory_reserved(),
            "if_nodes": graph_if.GRAPH_IF.nodes - ifs,
            "while_nodes": graph_if.GRAPH_IF.while_nodes - whiles}


def serve(ck, fc, eng, batches, label, references, counter=None):
    """Every point-only batch through columnar_pack / columnar_dispatch /
    force, the dispatch under sync debug mode "error" (a synchronizing call
    there fails the phase); verdicts against each of `references`, [(name,
    fn(b, txns, now, oldest) -> verdicts)], on every batch. Fails on a
    capture after warmup, a path without kernel launches or with the plain
    fixpoint on CUDA tensors, or a host read of the merge or loop
    condition. `counter`: the fixpoint entry the path launches
    (fc.FIXPOINT, or fc.FIXPOINT_STACKED for the sharded engines). Returns
    (verdicts per batch, totals)."""
    import torch

    counter = counter or fc.FIXPOINT
    captures = eng.perf.captures
    host_reads = (ck.MERGE.host_reads, ck.LOOP.host_reads)
    # the host's share of heat: the aggregator's merges (a "c" layout
    # merges chunk by chunk through the same method: time the outer call)
    merge_heat, heat_s, depth = eng._merge_heat, [0.0], [0]

    def timed_merge(*a, **k):
        depth[0] += 1
        t0 = time.perf_counter()
        try:
            merge_heat(*a, **k)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            heat_s[0] += time.perf_counter() - t0

    eng._merge_heat = timed_merge
    pack_s = dispatch_s = force_s = 0.0
    launches = plain = 0
    serial, counts = [], [0, 0, 0]
    for b, (txns, now, oldest) in enumerate(batches):
        counter.reset_counts()
        t0 = time.perf_counter()
        plan = eng.columnar_pack(txns, now, oldest)
        t1 = time.perf_counter()
        check(plan is not None, f"batch {b} did not take the columnar path")
        torch.cuda.set_sync_debug_mode("error")
        try:
            force = eng.columnar_dispatch(plan)
        except RuntimeError as e:
            fail(f"batch {b}: the {label} dispatch synchronized with the card: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        t2 = time.perf_counter()
        got = [int(v) for v in force()]
        t3 = time.perf_counter()
        launches += counter.launches + counter.graph_launches
        plain += counter.plain_cuda_calls
        pack_s, dispatch_s, force_s = pack_s + t1 - t0, dispatch_s + t2 - t1, force_s + t3 - t2
        for name, ref in references:
            want = ref(b, txns, now, oldest)
            check(got == want, f"{label} batch {b}: verdicts differ from {name} at "
                  f"{sum(g != w for g, w in zip(got, want))} of {len(txns)} txns")
        serial.append(got)
        for v in got:
            counts[v] += 1
    eng._merge_heat = merge_heat
    check(eng.perf.captures == captures, f"the {label} engine captured after warmup()")
    check(launches > 0 and plain == 0, f"{label} path: {launches} kernel launches, "
          f"{plain} plain fixpoints on CUDA tensors")
    check((ck.MERGE.host_reads, ck.LOOP.host_reads) == host_reads,
          f"the {label} path read a merge or loop condition on the host")
    check(all(v > 0 for v in eng.perf.bucket_hits.values()),
          f"a bucket went unused: {eng.perf.bucket_hits}")
    check(min(counts) > 0, f"verdict mix lacks a class: {counts}")
    tiered = eng.history_structure == "tiered"
    merges = eng.perf.merges
    check(not tiered or merges >= 2, f"only {merges} merges ran inside tiered replays")
    if eng.heat is not None:
        # the heat aggregate's run accounting counts the merges the serving
        # path counted, with no sync of its own
        stats = eng.history_stats_snapshot()
        check(stats["merges"] == merges, f"the heat aggregate counted {stats['merges']} "
              f"merges, the {label} path {merges}")
    n, txns_total = len(batches), sum(len(t) for t, _, _ in batches)
    return serial, {
        "batches": n, "txns": txns_total, "mismatches": 0, "launches": launches,
        "conflict": counts[0], "too_old": counts[1], "committed": counts[2], "merges": merges,
        "bucket_hits": dict(eng.perf.bucket_hits),
        "pack_ms_per_batch": pack_s / n * 1e3, "dispatch_ms_per_batch": dispatch_s / n * 1e3,
        "force_ms_per_batch": force_s / n * 1e3, "heat_merge_ms_per_batch": heat_s[0] / n * 1e3,
        "txn_per_s": txns_total / (pack_s + dispatch_s + force_s),
        "sizes": [len(t) for t, _, _ in batches]}


def d2h_chunk_bytes(outputs):
    """Bytes one chunk's outputs copy back to the host: row 0 of every
    chunk-stacked output, a 0-d output whole."""
    return sum(int(t[0].nbytes) if t.dim() else int(t.nbytes) for t in outputs)


def columnar_engine_phase(ck, fc, he, cfg, batches, structure, references, heat_buckets=None):
    """TorchConflictEngine() on the card with the bucket ladder and chunk
    scans, the given history structure and heat buckets (None: the default,
    64), device-time sampling off, warmed up; every point-only batch
    through serve(). Tiered:
    warmup() captures one IF node per step, merges run inside replays (at
    least twice) and the merge predicate is never read on the host."""
    import torch

    eng = he.TorchConflictEngine(cfg, ladder=LADDER, scan_sizes=SCANS,
                                 history_structure=structure, heat_buckets=heat_buckets,
                                 device_time_sample_rate=0.0)
    cfg = eng.cfg
    tiered = eng.history_structure == "tiered"
    warm = warmed(eng)
    captures = eng.perf.captures
    n_graphs = len(eng.buckets) * (1 + len(SCANS)) * 2
    check(captures == n_graphs, f"warmup captured {captures} graphs, expected {n_graphs}")
    want_nodes = 2 * len(eng.buckets) * (1 + sum(SCANS)) if tiered else 0
    check(warm["if_nodes"] == want_nodes and warm["while_nodes"] == 0,
          f"warmup captured {warm['if_nodes']} IF nodes and {warm['while_nodes']} WHILE nodes, "
          f"expected {want_nodes} and 0")
    label = f"{structure} columnar (heat {cfg.heat_buckets})"
    serial, served = serve(ck, fc, eng, batches, label, references)
    check(all(eng.perf.scan_dispatches.get(c, 0) > 0 for c in (1,) + SCANS),
          f"a scan size went unused: {eng.perf.scan_dispatches}")
    # the layers apart: each program's kernel time per replay (profiler:
    # the host cannot queue replays ahead of the card, so spin-queued CUDA
    # events do not apply; on the last inputs it was given, without GC),
    # the host time to launch it, and the copies of one top-bucket chunk's
    # hot fields to the card (device time, and the host time to issue them)
    program_ms, program_kernels, launch_ms = {}, {}, {}
    for key in sorted(eng._programs):
        prog = eng._programs[key]
        if key[1] == 1 or key == (cfg.max_txns, max(SCANS)):
            pw = traced_replays(lambda: prog.run(False), 2, key[1], f"the {key} program")
            program_ms[f"{key[0]}x{key[1]}"] = pw["device_ms"]
            program_kernels[f"{key[0]}x{key[1]}"] = pw["kernels"]
            # host ms of a launch on an idle card, then of relaunching the
            # same graph while that launch still runs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prog.run(False)
            t1 = time.perf_counter()
            prog.run(False)
            t2 = time.perf_counter()
            launch_ms[f"{key[0]}x{key[1]}"] = [(t1 - t0) * 1e3, (t2 - t1) * 1e3]
            torch.cuda.synchronize()
    top = eng._programs[(cfg.max_txns, 1)]
    outs = [top.status, top.overflow, *top.heat.values()]
    if top.merged is not None:
        outs.append(top.merged)
    d2h_bytes = d2h_chunk_bytes(outs)
    bufs, lease = eng.arena.lease(cfg)
    h2d_ms = device_ms(lambda: top.load(0, bufs, lease.pack), 20)
    h2d_bytes = sum(t.nbytes for t in lease.pack.tensors.values())
    load_host_s = []
    for _ in range(20):
        t0 = time.perf_counter()
        top.load(0, bufs, lease.pack)
        load_host_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    lease.release()
    out = dict(served, **warm)
    out.update({
        "structure": eng.history_structure, "heat_buckets": cfg.heat_buckets,
        "program_device_ms": program_ms, "program_kernels": program_kernels,
        "program_launch_host_ms": launch_ms,
        "h2d_chunk_ms": h2d_ms,
        "h2d_chunk_bytes": h2d_bytes, "h2d_chunk_copies": len(he.HOT_FIELDS),
        "h2d_chunk_host_ms": statistics.median(load_host_s) * 1e3,
        "d2h_chunk_bytes": d2h_bytes,
        "captures": captures, "scan_dispatches": dict(eng.perf.scan_dispatches),
        "arena_misses": eng.arena.misses,
    })
    if tiered:
        out.update(merge_costs(ck, cfg, eng, batches[-1]))
    return eng, serial, out


def loop_engine_phase(ck, fc, dl, cfg, batches, structure, references):
    """DeviceLoopEngine() on the card with the bucket ladder, the given
    history structure, the default heat and device-time sampling off,
    warmed up: 2 graphs per bucket,
    each with one WHILE node (and under the tiered structure 2 IF nodes,
    one nested in the WHILE body); every point-only batch through serve(),
    no blocking sync. Then the top bucket's program alone: the card's trace
    must show one fixpoint kernel per filled chunk of a replay, at fill 1
    and fill Q; kernel ms per replay at each fill."""
    import torch

    eng = dl.DeviceLoopEngine(cfg, ladder=LADDER, history_structure=structure,
                              device_time_sample_rate=0.0)
    cfg = eng.cfg
    tiered = eng.history_structure == "tiered"
    Q = eng.queue_slots
    warm = warmed(eng)
    n_b = len(eng.buckets)
    check(eng.perf.captures == 2 * n_b, f"the loop warmup captured {eng.perf.captures} graphs, "
          f"expected {2 * n_b}")
    want_ifs = 4 * n_b if tiered else 0
    check(warm["while_nodes"] == 2 * n_b and warm["if_nodes"] == want_ifs,
          f"the loop warmup captured {warm['while_nodes']} WHILE nodes and {warm['if_nodes']} "
          f"IF nodes, expected {2 * n_b} and {want_ifs}")
    label = f"{structure} device loop"
    fills = []
    dispatch = eng._dispatch_unit

    def recording(bucket, per_chunks, packs=None, **kw):
        fills.append(len(per_chunks))
        return dispatch(bucket, per_chunks, packs, **kw)

    eng._dispatch_unit = recording
    stats0 = dict(eng.loop_stats)
    serial, served = serve(ck, fc, eng, batches, label, references)
    eng._dispatch_unit = dispatch
    stats = {k: eng.loop_stats[k] - stats0[k] for k in stats0}
    check(stats["blocking_syncs"] == 0, f"the {label} drained with {stats['blocking_syncs']} "
          "blocking syncs")
    check(set(fills) >= {1, Q}, f"the {label} never filled a slot to 1 and to {Q}: {fills}")
    top = eng._programs[(cfg.max_txns, -1)]
    replay_ms, replay_kernels = {}, {}
    for n in (1, Q):
        def run():
            top.n_chunks.fill_(n)
            top.graphs[False].replay()
        pw = traced_replays(run, 2, n, f"the {label} top program at fill {n}")
        replay_ms[n], replay_kernels[n] = pw["device_ms"], pw["kernels"]
    # host ms of a replay on an idle card, then of relaunching it at once
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    top.graphs[False].replay()
    t1 = time.perf_counter()
    top.graphs[False].replay()
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    launch_ms = [(t1 - t0) * 1e3, (t2 - t1) * 1e3]
    outs = [top.out["commit_bits"], top.out["too_old_bits"], top.out["overflow"],
            *top.out.get("heat", {}).values()]
    if "merged" in top.out:
        outs.append(top.out["merged"])
    n = len(batches)
    out = dict(served, **warm)
    out.update({
        "structure": eng.history_structure, "heat_buckets": cfg.heat_buckets,
        "queue_slots": Q, "captures": eng.perf.captures, "fills": fills,
        "units": stats["units"], "drained_nonblocking": stats["drained_nonblocking"],
        "forced_waits": stats["forced_waits"], "blocking_syncs": stats["blocking_syncs"],
        "enqueue_ms_per_batch": stats["enqueue_ms"] / n, "decode_ms_per_batch": stats["decode_ms"] / n,
        "wait_ms_per_batch": stats["wait_ms"] / n,
        "top_replay_device_ms": replay_ms, "top_replay_kernels": replay_kernels,
        "top_launch_host_ms": launch_ms, "d2h_chunk_bytes": d2h_chunk_bytes(outs),
    })
    return eng, serial, out


def loop_report(card, lp, references, seconds):
    print(f"{lp['structure']} device loop phase [{card}]: {lp['txns']} point-only txns in "
          f"{lp['batches']} batches match {references}: {lp['committed']} committed / "
          f"{lp['conflict']} conflict / {lp['too_old']} too old; buckets {lp['bucket_hits']}, "
          f"{lp['units']} slots, fills {sorted(set(lp['fills']))} (Q={lp['queue_slots']}); "
          f"{lp['captures']} graphs captured in warmup ({lp['warmup_s']:.2f} s) with "
          f"{lp['while_nodes']} WHILE and {lp['if_nodes']} IF nodes, none after; memory reserved "
          f"{lp['memory_reserved_before_warmup']} -> {lp['memory_reserved_after_warmup']} B; "
          f"pack {lp['pack_ms_per_batch']:.4f} dispatch {lp['dispatch_ms_per_batch']:.4f} (enqueue "
          f"{lp['enqueue_ms_per_batch']:.4f}) force {lp['force_ms_per_batch']:.4f} (decode "
          f"{lp['decode_ms_per_batch']:.4f} incl. heat merge {lp['heat_merge_ms_per_batch']:.4f}, "
          f"wait {lp['wait_ms_per_batch']:.4f}) ms/batch, "
          f"{lp['txn_per_s']:.0f} txn/s; drains: {lp['drained_nonblocking']} non-blocking, "
          f"{lp['forced_waits']} forced waits, {lp['blocking_syncs']} blocking syncs; "
          f"{lp['launches']} kernel launches; top program replay "
          f"{ {k: round(v, 4) for k, v in lp['top_replay_device_ms'].items()} } ms and "
          f"{ {k: round(v, 1) for k, v in lp['top_replay_kernels'].items()} } kernels by fill, "
          f"host ms to launch it on an idle card / to relaunch it at once "
          f"{[round(x, 4) for x in lp['top_launch_host_ms']]}; "
          f"{lp['d2h_chunk_bytes']} B back per chunk ({seconds:.1f} s)", flush=True)


def merge_costs(ck, cfg, eng, batch):
    """The tiered top-bucket one-chunk program on a write-bearing chunk of
    `batch`, its run stack set before each replay: to 0 (the run appends)
    and to full (the step merges first), kernel ms and kernels per replay
    from the card's trace (each replay also runs the fill that sets the
    stack); then _merge_runs alone on the engine's table with a full stack
    (device ms of a graph replay)."""
    import torch

    prog = eng._programs[(cfg.max_txns, 1)]
    txns, now, oldest = batch
    plan = eng.columnar_pack(txns, now, oldest)
    per, _, bucket, lease, pack = next(c for c in plan["chunks"] if c[2] is cfg)
    prog.load(0, per[0], pack)
    NR = cfg.run_slots
    out = {}
    for label, nruns in (("append", 0), ("merge", NR)):
        def run():
            eng.state["nruns"].fill_(nruns)
            prog.run(False)
        pw = traced_replays(run, 2, 1, f"the tiered top program ({label})")
        check(bool(prog.merged[0]) == (nruns == NR), f"the {label} replay merged "
              f"{bool(prog.merged[0])}")
        out[f"top_program_{label}_ms"] = pw["device_ms"]
        out[f"top_program_{label}_kernels"] = pw["kernels"]
    torch.cuda.synchronize()
    for c in plan["chunks"]:
        if c[3] is not None:
            c[3].release()
    # the merge alone, captured in a graph of its own: eagerly its ~700+
    # launches would fill the launch queue behind device_ms's spin
    st = eng.state
    full = torch.full((), NR, dtype=torch.int32, device=st["n"].device)

    def merge():
        return ck._merge_runs(cfg, st["hkeys"], st["hvers"], st["n"], st["rkeys"],
                              st["rvers"], st["rn"], full)

    merge()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(), capture_error_mode="relaxed"):
        merge()
    out["merge_ms"] = device_ms(graph.replay, 5)
    out["merge_rows"] = NR * cfg.run_rows
    return out


def columnar_report(card, colp, references, seconds):
    print(f"{colp['structure']} columnar engine phase [{card}]: {colp['txns']} point-only txns "
          f"in {colp['batches']} batches {colp['sizes']} match {references}: "
          f"{colp['committed']} committed / {colp['conflict']} conflict / {colp['too_old']} too old; "
          f"buckets {colp['bucket_hits']}, scans {colp['scan_dispatches']}; {colp['captures']} graphs "
          f"captured in warmup ({colp['warmup_s']:.2f} s), none after; memory reserved "
          f"{colp['memory_reserved_before_warmup']} -> {colp['memory_reserved_after_warmup']} B; "
          f"pack {colp['pack_ms_per_batch']:.4f} dispatch {colp['dispatch_ms_per_batch']:.4f} force "
          f"{colp['force_ms_per_batch']:.4f} (heat merge {colp['heat_merge_ms_per_batch']:.4f}) "
          f"ms/batch, {colp['txn_per_s']:.0f} txn/s; "
          f"{colp['launches']} kernel launches; arena misses {colp['arena_misses']} "
          f"({seconds:.1f} s)", flush=True)
    print(f"  columnar layers [{card}]: program kernel ms per replay "
          f"{ {k: round(v, 4) for k, v in colp['program_device_ms'].items()} }, kernels per replay "
          f"{ {k: round(v, 1) for k, v in colp['program_kernels'].items()} }, host ms to "
          f"launch one on an idle card / to relaunch it at once "
          f"{ {k: [round(x, 4) for x in v] for k, v in colp['program_launch_host_ms'].items()} }; "
          f"one top-bucket chunk's {colp['h2d_chunk_bytes']} hot bytes to the card in "
          f"{colp['h2d_chunk_copies']} copies: {colp['h2d_chunk_ms']:.4f} ms on the card, "
          f"{colp['h2d_chunk_host_ms']:.4f} ms of host time to issue", flush=True)


def columnar_timing(eng, batches, serial):
    """The traffic once more through a warmed engine reset to an empty
    table: pack, dispatch and force ms per batch and txn/s; verdicts equal
    its first pass's; nothing captured."""
    import torch

    eng.base = eng.oldest_version = 0
    eng.clear(0)
    torch.cuda.synchronize()
    captures, merges = eng.perf.captures, eng.perf.merges
    loop0 = dict(getattr(eng, "loop_stats", {}))
    pack_s = dispatch_s = force_s = 0.0
    for b, (txns, now, oldest) in enumerate(batches):
        t0 = time.perf_counter()
        plan = eng.columnar_pack(txns, now, oldest)
        t1 = time.perf_counter()
        force = eng.columnar_dispatch(plan)
        t2 = time.perf_counter()
        got = [int(v) for v in force()]
        t3 = time.perf_counter()
        pack_s, dispatch_s, force_s = pack_s + t1 - t0, dispatch_s + t2 - t1, force_s + t3 - t2
        check(got == serial[b], f"{eng.history_structure} timing pass, batch {b}: verdicts "
              "differ from the first pass")
    check(eng.perf.captures == captures, "a timing pass captured")
    n = len(batches)
    out = {"pack_ms_per_batch": pack_s / n * 1e3, "dispatch_ms_per_batch": dispatch_s / n * 1e3,
           "force_ms_per_batch": force_s / n * 1e3,
           "txn_per_s": sum(len(t) for t, _, _ in batches) / (pack_s + dispatch_s + force_s),
           "merges": eng.perf.merges - merges}
    if loop0:
        stats = {k: eng.loop_stats[k] - loop0[k] for k in loop0}
        check(stats["blocking_syncs"] == 0, "a loop timing pass made a blocking sync")
        out.update(enqueue_ms_per_batch=stats["enqueue_ms"] / n,
                   decode_ms_per_batch=stats["decode_ms"] / n)
    return out


def pipeline_phase(fc, pl, eng, batches, serial, runs=PIPELINE_RUNS, executors=(0, 1)):
    """The same traffic through the port's ResolverPipeline at depth 1, 2
    and 3, packing inline (0) and on a one-thread executor (1), `runs`
    times each in turns, on the warmed engine reset to an empty table each
    run: verdicts equal serial resolve()'s on every batch."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    out = {}
    captures = eng.perf.captures
    launches = 0
    for _, depth, threads in itertools.product(range(runs), (1, 2, 3), executors):
        eng.base = eng.oldest_version = 0
        eng.clear(0)
        torch.cuda.synchronize()
        fc.FIXPOINT.reset_counts()
        ex = ThreadPoolExecutor(threads) if threads else None
        try:
            pipe = pl.ResolverPipeline(eng, depth=depth, executor=ex)
            t0 = time.perf_counter()
            handles = [pipe.submit(txns, now, oldest) for txns, now, oldest in batches]
            got = [[int(v) for v in h.result()] for h in handles]
            wall = time.perf_counter() - t0
        finally:
            if ex is not None:
                ex.shutdown()
        n = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
        check(n > 0 and fc.FIXPOINT.plain_cuda_calls == 0,
              f"pipeline depth {depth}: {n} kernel launches")
        launches += n
        for b, (g, w) in enumerate(zip(got, serial)):
            check(g == w, f"pipeline depth {depth}, executor threads {threads}: batch {b} "
                  "differs from serial resolve()")
        run = out.setdefault(f"depth{depth}_{'executor' if threads else 'inline'}",
                             {"txn_per_s": []})
        run["txn_per_s"].append(sum(len(t) for t, _, _ in batches) / wall)
    check(eng.perf.captures == captures, "the pipeline captured after warmup()")
    out["launches"] = launches
    return out


TELEMETRY_TURNS = 2
#: the telemetry phase's engines: key -> (family, history structure)
TELEMETRY_ENGINES = {"columnar": ("columnar", "monolithic"),
                     "tiered_columnar": ("columnar", "tiered"),
                     "device_loop": ("loop", "monolithic"),
                     "tiered_device_loop": ("loop", "tiered")}
#: the telemetry engines whose sampled intervals are held against the
#: card's trace of the same pass
TRACED_SAMPLES = ("columnar", "device_loop")
SCHED_TICKS = 24
SCHED_ARRIVALS = 300
SCHED_HOT_KEYS = 64


def span_ms_per_batch(spans, versions):
    """Mean ms per batch of each engine and pipeline span over the batches'
    trace ids (the batch versions), from the program's own span records."""
    by = spans.durations_by_trace()
    names = sorted({s["Name"] for s in spans.spans})
    return {name: sum(by.get(v, {}).get(name, 0.0) for v in versions) / len(versions) * 1e3
            for name in names}


def ledger_rows(eng):
    return [{k: r[k] for k in ("bucket", "n_chunks", "kind", "duration_ms", "peak_bytes")}
            for r in eng.perf_ledger.rows()]


def telemetry_engine_phase(ck, fc, he, dl, trace, cfg, batches, family, structure, serial):
    """A fresh engine of `family` ("columnar" | "loop") and `structure` at
    device-time sample rate 1.0, warmed up: one perf-ledger row per
    program, two captured graphs each, every row with its capture ms and a
    peak-bytes reading. Then the traffic through serve() with spans on:
    verdicts equal `serial` (the same engine with spans and sampling off)
    on every batch, every dispatch unit timed with CUDA events (one
    sample and one engine.device_time span each), no blocking sync on the
    loop; the engine spans' ms per batch beside serve()'s clocks."""
    kw = dict(ladder=LADDER, history_structure=structure, device_time_sample_rate=1.0)
    eng = (he.TorchConflictEngine(cfg, scan_sizes=SCANS, **kw) if family == "columnar"
           else dl.DeviceLoopEngine(cfg, **kw))
    label = f"{structure} {family} (spans on, sampling 1.0)"
    warm = warmed(eng)
    rows = eng.perf_ledger.rows()
    check(len(rows) == len(eng._programs) == eng.perf.compiles
          and eng.perf.captures == 2 * len(rows),
          f"the {label} ledger holds {len(rows)} rows for {len(eng._programs)} programs and "
          f"{eng.perf.captures} graphs")
    check(all(r["kind"] == "warmup" and r["duration_ms"] > 0 and (r["peak_bytes"] or 0) > 0
              for r in rows), f"a {label} ledger row lacks its capture time or bytes: {rows}")
    stats0 = dict(getattr(eng, "loop_stats", {}))
    spans = trace.g_spans
    spans.clear()
    spans.enabled = True
    try:
        _, served = serve(ck, fc, eng, batches, label, [
            ("the engine with spans and sampling off", lambda b, *_: serial[b])])
    finally:
        spans.enabled = False
    units = sum(eng.perf.scan_dispatches.values())
    samples = sum(d["samples"] for d in eng.perf.device_time.values())
    device_spans = spans.by_name("engine.device_time")
    check(samples == units == len(device_spans) > 0,
          f"the {label}: {samples} samples and {len(device_spans)} device_time spans for "
          f"{units} dispatch units")
    out = dict(served, **warm)
    out.update({
        "units": units, "samples": samples, "captures": eng.perf.captures,
        "span_ms_per_batch": span_ms_per_batch(spans, [now for _, now, _ in batches]),
        "sampled_device_ms_per_chunk": {str(b): ms for b, ms in
                                        eng.perf.device_time_ms_by_bucket().items()},
        "ledger_rows": ledger_rows(eng),
        "ledger_peak_bytes_sum": sum(r["peak_bytes"] or 0 for r in rows),
        "ledger_capture_ms_sum": sum(r["duration_ms"] for r in rows),
    })
    spans.clear()
    if stats0:
        blocking = eng.loop_stats["blocking_syncs"] - stats0["blocking_syncs"]
        check(blocking == 0, f"the {label} drained with {blocking} blocking syncs")
        out["blocking_syncs"] = blocking
    return eng, out


def telemetry_turns(trace, engines, batches, serial):
    """columnar_timing of each (label, engine, spans on) in turns,
    TELEMETRY_TURNS times: txn/s and per-batch clocks per label."""
    turns = {label: [] for label, _, _ in engines}
    for _ in range(TELEMETRY_TURNS):
        for label, eng, spans_on in engines:
            trace.g_spans.enabled = spans_on
            try:
                turns[label].append(columnar_timing(eng, batches, serial))
            finally:
                trace.g_spans.enabled = False
                trace.g_spans.clear()
    return turns


def union_us(spans):
    """Length of the union of [start, end) intervals."""
    total, lo, hi = 0.0, None, None
    for s, e in sorted(spans):
        if hi is None or s > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return total + (0.0 if hi is None else hi - lo)


def sampled_vs_trace(fc, eng, batches, serial):
    """What the sampled CUDA events of `eng` (rate 1.0) hold: the traffic
    once through the engine, then once more under torch.profiler with
    each batch's dispatch and force in a record_function window. Per
    batch: the sampled ms (engine.device_time, summed over the batch's
    units) of both passes, and from the trace the device activity inside
    the window: kernels, copies, and their union (busy). The traced pass's
    sampled ms less busy is time the stream sat idle between a unit's
    start and end events. A trace that lost fixpoint kernels is taken
    again, 3 traces in all; verdicts equal the first pass's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    tag = "chip_smoke.batch"

    def one_pass():
        eng.base = eng.oldest_version = 0
        eng.clear(0)
        torch.cuda.synchronize()
        sampled = []
        for b, (txns, now, oldest) in enumerate(batches):
            plan = eng.columnar_pack(txns, now, oldest)
            m0 = sum(d["ms_total"] for d in eng.perf.device_time.values())
            with record_function(f"{tag}{b}"):
                got = [int(v) for v in eng.columnar_dispatch(plan)()]
            check(got == serial[b], f"traced pass, batch {b}: verdicts differ from the first pass")
            sampled.append(sum(d["ms_total"] for d in eng.perf.device_time.values()) - m0)
        torch.cuda.synchronize()
        return sampled

    untraced = one_pass()
    for attempt in range(1, 4):
        fc.FIXPOINT.reset_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced = one_pass()
        windows, device = {}, []
        for e in prof.events():
            if e.name.startswith(tag):
                # the window on the host (its device twin is no activity)
                if e.device_type == DeviceType.CPU:
                    windows[int(e.name[len(tag):])] = (e.time_range.start, e.time_range.end)
            elif e.device_type == DeviceType.CUDA:
                device.append((e.time_range.start, e.time_range.end, e.name))
        fixpoints = sum(FIXPOINT_KERNEL in n for _, _, n in device)
        if fixpoints == fc.FIXPOINT.graph_launches:
            break
    rows, inside = [], 0
    for b, (txns, _, _) in enumerate(batches):
        w0, w1 = windows[b]
        ev = [(s, e, n) for s, e, n in device if s >= w0 and e <= w1]
        inside += len(ev)
        copies = [(s, e) for s, e, n in ev if n.startswith(("Memcpy", "Memset"))]
        kernels = [(s, e) for s, e, n in ev if not n.startswith(("Memcpy", "Memset"))]
        spans = [(s, e) for s, e, _ in ev]
        busy = union_us(spans) / 1e3
        row = {"txns": len(txns), "sampled_ms": untraced[b], "traced_sampled_ms": traced[b],
               "kernel_ms": union_us(kernels) / 1e3, "copy_ms": union_us(copies) / 1e3,
               "busy_ms": busy, "idle_ms": traced[b] - busy,
               "idle_share": 1 - busy / traced[b] if traced[b] else None}
        if kernels:
            # where the idle time sits: before the first kernel (the copies
            # in and the graph launch), among the kernels, after the last
            # (the copies out); the rest lies outside the first and last
            # device operation (issuing the first copy after the start event)
            d0, d1 = min(s for s, _ in spans), max(e for _, e in spans)
            k0, k1 = min(s for s, _ in kernels), max(e for _, e in kernels)
            for name, lo, hi in (("idle_before_kernels_ms", d0, k0),
                                 ("idle_among_kernels_ms", k0, k1),
                                 ("idle_after_kernels_ms", k1, d1)):
                clipped = [(max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi]
                row[name] = (hi - lo - union_us(clipped)) / 1e3
            row["outside_device_ops_ms"] = traced[b] - (d1 - d0) / 1e3
        rows.append(row)
    total = {k: sum(r.get(k, 0.0) for r in rows) for k in (
        "sampled_ms", "traced_sampled_ms", "kernel_ms", "copy_ms", "busy_ms", "idle_ms",
        "idle_before_kernels_ms", "idle_among_kernels_ms", "idle_after_kernels_ms",
        "outside_device_ops_ms")}
    total["idle_share"] = (total["idle_ms"] / total["traced_sampled_ms"]
                           if total["traced_sampled_ms"] else None)
    return {"batches": rows, "total": total, "traces": attempt,
            "trace_fixpoints": fixpoints, "fixpoint_launches": fc.FIXPOINT.graph_launches,
            "device_events": len(device), "device_events_outside_windows": len(device) - inside}


def skewed_arrivals(rng, n, now):
    """Point-only arrivals on skewed keys: half read-modify-write one of
    SCHED_HOT_KEYS hot keys, half read 2 and write 2 of the rest of the
    pool; snapshots up to 2 batches behind."""
    from foundationdb_tpu_torch.core.types import CommitTransaction, KeyRange

    lag = rng.integers(0, 2 * VERSION_STEP, size=n)
    hot = rng.random(n) < 0.5
    hot_key = rng.integers(0, SCHED_HOT_KEYS, size=n)
    cold = rng.integers(SCHED_HOT_KEYS, POOL_KEYS, size=(n, 4))
    out = []
    for i in range(n):
        t = CommitTransaction(read_snapshot=int(max(0, now - lag[i])))
        keys = [b"h/%014d" % hot_key[i]] * 2 if hot[i] else [b"h/%014d" % k for k in cold[i]]
        for j, k in enumerate(keys):
            (t.read_conflict_ranges if j < len(keys) // 2 else t.write_conflict_ranges).append(
                KeyRange(k, k + b"\x00"))
        out.append(t)
    return out


def scheduled_pipeline_phase(fc, he, pl, knobs, oracle_mod, trace, eng, cfg, rng):
    """ResolverPipeline at depth 2 over `eng` with a BudgetBatcher over its
    ladder and a ConflictScheduler built with the `resolver_sched` knob
    "on" (fed by the engine's heat witnesses), spans on: SCHED_TICKS ticks
    of skewed arrivals, each tick's select() sized by the batcher's target,
    pre-aborted txns retried at a fresh snapshot. The dispatched journal
    replays equal through a CPU engine and the oracle, batch by batch."""
    from foundationdb_tpu_torch.core.types import CommitTransaction, KeyRange

    knobs.SERVER_KNOBS.set_knob("resolver_sched", "on")
    try:
        sched = pl.ConflictScheduler(heat=eng.heat)
    finally:
        knobs.SERVER_KNOBS.set_knob("resolver_sched", "")
    check(sched.enabled, "resolver_sched=on left the scheduler off")
    batcher = pl.BudgetBatcher([b.max_txns for b in eng.buckets])
    eng.base = eng.oldest_version = 0
    eng.clear(0)
    fc.FIXPOINT.reset_counts()
    pipe = pl.ResolverPipeline(eng, depth=2, batcher=batcher, conflict_sched=sched)
    pending, now, journal, handles, caps = [], 10_000, [], [], []
    trace.g_spans.clear()
    trace.g_spans.enabled = True
    t0 = time.perf_counter()
    try:
        for _ in range(SCHED_TICKS):
            now += VERSION_STEP
            oldest = max(0, now - GC_LAG_BATCHES * VERSION_STEP)
            pending.extend(skewed_arrivals(rng, SCHED_ARRIVALS, now))
            caps.append(pipe.suggested_batch_txns())
            plan = sched.select(pending, caps[-1])
            retries = []
            for txn, _ in plan.preaborts:
                r = CommitTransaction(read_snapshot=now)
                r.read_conflict_ranges.extend(KeyRange(x.begin, x.end)
                                              for x in txn.read_conflict_ranges)
                r.write_conflict_ranges.extend(KeyRange(x.begin, x.end)
                                               for x in txn.write_conflict_ranges)
                retries.append(r)
            pending = plan.remaining + retries
            if plan.dispatch:
                journal.append((list(plan.dispatch), now, oldest))
                handles.append(pipe.submit(plan.dispatch, now, oldest))
        got = [[int(v) for v in h.result()] for h in handles]
        wall = time.perf_counter() - t0
    finally:
        trace.g_spans.enabled = False
    launches = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
    check(launches > 0 and fc.FIXPOINT.plain_cuda_calls == 0,
          f"the scheduled pipeline: {launches} kernel launches")
    forces = trace.g_spans.by_name("pipeline.force")
    check(len(forces) == len(journal), f"{len(forces)} pipeline.force spans for "
          f"{len(journal)} batches")
    trace.g_spans.clear()
    cpu = he.TorchConflictEngine(cfg, device="cpu", ladder=LADDER, scan_sizes=SCANS)
    ora = oracle_mod.OracleConflictEngine()
    for b, (txns, v, old) in enumerate(journal):
        want = [int(x) for x in ora.resolve(txns, v, old)]
        check(got[b] == want, f"scheduled pipeline batch {b}: verdicts differ from the oracle's")
        check([int(x) for x in cpu.resolve(txns, v, old)] == want,
              f"scheduled pipeline batch {b}: the CPU engine differs from the oracle")
    c = sched.counters
    check(c["preaborts"] + c["laned"] > 0, f"the scheduler neither pre-aborted nor laned: {c}")
    n = sum(len(t) for t, _, _ in journal)
    return {"batches": len(journal), "txns": n, "txn_per_s": n / wall, "launches": launches,
            "caps": sorted(set(caps)), "counters": dict(c),
            "ewma_ms": {f"{k[0]}:{k[1]}:{k[2]}": v for k, v in batcher.ewma_ms.items()},
            "target": batcher.target_batch_txns(2), "budget_ms": batcher.budget_ms}


def telemetry_phases(ck, fc, he, dl, pl, oracle_mod, card, engine_cfg, batches, rng, phases):
    """The telemetry phases at full width. `phases` maps each of "columnar",
    "tiered_columnar", "device_loop", "tiered_device_loop" to the earlier
    phase's (engine, verdicts per batch, report), that engine with spans
    and sampling off. Per family and structure: a fresh engine at sample
    rate 1.0 with spans on (telemetry_engine_phase); the monolithic
    columnar engine at the default rate; the engines' txn/s in turns
    (off, default, on); then the scheduled pipeline. Returns (telemetry
    results, scheduled pipeline results)."""
    from foundationdb_tpu_torch.core import knobs, perfledger, trace

    tele, pairs = {}, {}
    device_refs = {key: rep.get("program_device_ms") or {
        f"{engine_cfg.max_txns}x{k}": v for k, v in rep["top_replay_device_ms"].items()}
        for key, (_, _, rep) in phases.items()}
    for key, (family, structure) in TELEMETRY_ENGINES.items():
        off_eng, sv, off_rep = phases[key]
        t0 = time.perf_counter()
        on_eng, tm = telemetry_engine_phase(ck, fc, he, dl, trace, engine_cfg, batches, family,
                                            structure, sv)
        pairs[key] = (on_eng, off_eng, sv)
        tele[key] = tm
        spans = tm["span_ms_per_batch"]
        print(f"telemetry phase, {key} [{card}]: spans on + sampling 1.0 match spans and "
              f"sampling off on all {tm['batches']} batches; {tm['samples']} samples for "
              f"{tm['units']} dispatch units (CUDA events); {len(tm['ledger_rows'])} ledger rows "
              f"for {tm['captures']} graphs, capture ms {tm['ledger_capture_ms_sum']:.1f} (warmup "
              f"{tm['warmup_s']:.2f} s), peak bytes sum {tm['ledger_peak_bytes_sum']} against "
              f"{tm['memory_reserved_after_warmup'] - tm['memory_reserved_before_warmup']} B "
              f"reserved by warmup; span ms/batch "
              f"{ {k: round(v, 4) for k, v in spans.items()} } beside clocks pack "
              f"{tm['pack_ms_per_batch']:.4f} dispatch {tm['dispatch_ms_per_batch']:.4f} force "
              f"{tm['force_ms_per_batch']:.4f} (off: {off_rep['pack_ms_per_batch']:.4f} / "
              f"{off_rep['dispatch_ms_per_batch']:.4f} / {off_rep['force_ms_per_batch']:.4f}); "
              f"sampled device ms per chunk by bucket {tm['sampled_device_ms_per_chunk']} beside "
              f"the profiler's kernel ms per replay "
              f"{ {k: round(v, 4) for k, v in device_refs[key].items()} }"
              + (f"; {tm['blocking_syncs']} blocking syncs" if "blocking_syncs" in tm else "")
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        print(f"  ledger rows, {key} [{card}]: " + ", ".join(
            f"{r['bucket']}x{r['n_chunks']} {r['duration_ms']:.1f} ms {r['peak_bytes']} B"
            for r in tm["ledger_rows"]), flush=True)
    # the default sample rate (1/16) on the monolithic columnar engine
    t0 = time.perf_counter()
    deng = he.TorchConflictEngine(engine_cfg, ladder=LADDER, scan_sizes=SCANS)
    dwarm = warmed(deng)
    _, dserved = serve(ck, fc, deng, batches, "monolithic columnar (default sampling)",
                       [("spans and sampling off", lambda b, *_: phases["columnar"][1][b])])
    d_units = sum(deng.perf.scan_dispatches.values())
    d_samples = sum(d["samples"] for d in deng.perf.device_time.values())
    check(d_samples == d_units // perfledger.sample_every_from_rate(None),
          f"the default rate took {d_samples} samples of {d_units} units")
    tele["default_rate"] = dict(dserved, **dwarm, units=d_units, samples=d_samples)
    print(f"telemetry phase, columnar at the default sample rate [{card}]: matches spans and "
          f"sampling off on all {dserved['batches']} batches; {d_samples} samples for {d_units} "
          f"dispatch units; {dserved['txn_per_s']:.0f} txn/s ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    for key, (on_eng, off_eng, sv) in pairs.items():
        engines = [("spans off, sampling 0", off_eng, False)]
        if key == "columnar":
            engines.append(("spans off, sampling 1/16", deng, False))
        engines.append(("spans on, sampling 1.0", on_eng, True))
        tele[key]["turns"] = telemetry_turns(trace, engines, batches, sv)
        print(f"  telemetry turns, {key} [{card}]: " + "; ".join(
            f"{label}: " + " / ".join(f"{r['txn_per_s']:.0f}" for r in runs) + " txn/s"
            for label, runs in tele[key]["turns"].items())
            + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    for key in TRACED_SAMPLES:
        t0 = time.perf_counter()
        svt = tele[key]["sampled_vs_trace"] = sampled_vs_trace(fc, pairs[key][0], batches,
                                                               pairs[key][2])
        tot = svt["total"]
        print(f"  sampled events vs the trace, {key} [{card}]: sampled ms per pass "
              f"{tot['sampled_ms']:.4f} untraced, {tot['traced_sampled_ms']:.4f} traced; in the "
              f"traced batches' windows the card ran kernels {tot['kernel_ms']:.4f} ms, copies "
              f"{tot['copy_ms']:.4f} ms, busy {tot['busy_ms']:.4f} ms: idle "
              f"{tot['idle_ms']:.4f} ms ({tot['idle_share']:.4f}) inside the sampled intervals: "
              f"{tot['idle_before_kernels_ms']:.4f} before the first kernel, "
              f"{tot['idle_among_kernels_ms']:.4f} among the kernels, "
              f"{tot['idle_after_kernels_ms']:.4f} after the last, "
              f"{tot['outside_device_ops_ms']:.4f} outside the first and last operation; "
              f"per batch (txns: sampled untraced / traced / busy / kernels ms) " + ", ".join(
                  f"{r['txns']}: {r['sampled_ms']:.3f} / {r['traced_sampled_ms']:.3f} / "
                  f"{r['busy_ms']:.3f} / {r['kernel_ms']:.3f}" for r in svt["batches"])
              + f"; trace {svt['traces']} of 3, {svt['trace_fixpoints']} of "
              f"{svt['fixpoint_launches']} fixpoint kernels, {svt['device_events']} device "
              f"events, {svt['device_events_outside_windows']} outside the windows "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    spp = scheduled_pipeline_phase(fc, he, pl, knobs, oracle_mod, trace, pairs["columnar"][0],
                                   engine_cfg, rng)
    print(f"scheduled pipeline phase [{card}]: depth 2, BudgetBatcher (budget "
          f"{spp['budget_ms']} ms, batch caps {spp['caps']}, target {spp['target']}) and "
          f"resolver_sched=on over skewed traffic: {spp['txns']} txns in {spp['batches']} "
          f"batches replay equal through the CPU engine and the oracle; {spp['txn_per_s']:.0f} "
          f"txn/s; scheduler {spp['counters']}; EWMA ms "
          f"{ {k: round(v, 4) for k, v in spp['ewma_ms'].items()} }; {spp['launches']} kernel "
          f"launches ({time.perf_counter() - t0:.1f} s)", flush=True)
    return tele, spp


# ---------------------------------------------------------------------------
# the resolver role inside the port's simulator
# ---------------------------------------------------------------------------

#: the role phase: the batch whose reply triggers the kill, the pipelined
#: depths, and the virtual seconds each run is given (the role's counter
#: logger never ends, so a run ends at this time)
ROLE_KILL_AT = 4
#: the role phase's batch sizes: the columnar traffic less its 20000-txn
#: batch (the oracle replay of that one batch is quadratic host Python,
#: ~25 s)
ROLE_SIZES = COLUMNAR_SIZES[:-1]
ROLE_DEPTHS = (1, 2, 3)
ROLE_RUN_UNTIL = 60.0
#: worker processes that read the role runs' journals back and replay them
#: through the oracle after the last run (host Python, ~35 s for the whole
#: traffic)
ROLE_REPLAY_WORKERS = 4
#: one journal segment holds a whole run (~15 MB): nothing rotates away
ROLE_JOURNAL_SEGMENT_BYTES = 1 << 30


def role_version_step() -> int:
    """Versions advance MAX_WRITE_TRANSACTION_LIFE_VERSIONS // GC_LAG_BATCHES
    a batch, so the horizon the role sets itself (version -
    MAX_WRITE_TRANSACTION_LIFE_VERSIONS) trails by GC_LAG_BATCHES batches,
    as versioned() does."""
    from foundationdb_tpu_torch.core.types import MAX_WRITE_TRANSACTION_LIFE_VERSIONS

    return MAX_WRITE_TRANSACTION_LIFE_VERSIONS // GC_LAG_BATCHES


def nearest_rank(xs, q: float) -> float:
    s = sorted(xs)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def drive_role(fc, engine, batches, journal_dir, label, *, pipeline=None, kill_at=None,
               engine2=None, seed=SEED, supervise=None, buggify_on=True):
    """One run of the port's resolver role in the port's simulator.

    Simulator(seed) (buggify on) holds a proxy process and a resolver
    process; the role serves `engine` on the serial path (pipeline=None) or
    through the pipelined service (a PipelineConfig). The proxy sends each
    batch as a ResolveTransactionBatchRequest over sim.net.request to the
    role's RESOLVE_TOKEN endpoint, chained by prev_version, every 4th batch
    twice (a retried delivery). A BlackboxJournal in `journal_dir`, one
    segment large enough for the run, records what the role resolved (with
    buggify on, it may shed a record: a short write it accounts for in
    `shed_events`; its ring keeps every record). With `kill_at`, the
    resolver process is killed once the proxy holds batch `kill_at`'s
    reply, with later batches in flight, and a second role (token suffix
    "gen2", over `engine2`, its chain restarted at the kill point) serves
    every later version. Every dispatch runs under sync debug "error"; a
    dispatch that synchronizes raises, and the run fails after it ends
    (whatever caught the error on the way). With `supervise`, a callable
    taking the card engine, the role serves what it returns (built once
    the simulator exists: a ResilientEngine draws its seed from the
    simulation's stream) and the card engine under it is the one
    instrumented; `buggify_on=False` turns buggify off for the run.
    Returns the run's record: the accepted reply per version, the role
    generation that gave it and its virtual latency; the (virtual time,
    task name) of every step the scheduler queued; the journal's batch
    records as its ring holds them and its durability accounting; the wall
    seconds of the run, of the engines' resolve() calls and of the
    journal's batch records; the fixpoint launches; the supervised stack
    (`stack`, or None)."""
    import torch

    from foundationdb_tpu_torch.core import blackbox, buggify, error
    from foundationdb_tpu_torch.server.messages import ResolveTransactionBatchRequest
    from foundationdb_tpu_torch.server.resolver import Resolver
    from foundationdb_tpu_torch.sim.loop import TaskPriority, delay, set_scheduler
    from foundationdb_tpu_torch.sim.network import Endpoint
    from foundationdb_tpu_torch.sim.simulator import Simulator

    sim = Simulator(seed)
    if not buggify_on:
        buggify.disable()
    stack = supervise(engine) if supervise is not None else None
    sched = sim.sched
    tasks = []
    schedule_step = sched._schedule_step

    def logged_step(task, fut, priority):
        tasks.append((sched.time, task.name))
        schedule_step(task, fut, priority)

    sched._schedule_step = logged_step
    clocks = {"engine_s": 0.0, "journal_s": 0.0, "sample_s": 0.0, "dispatches": 0}
    sync_errors = []

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                clocks[key] += time.perf_counter() - t0
        return run

    def instrument(eng):
        dispatch = eng.columnar_dispatch

        def guarded_dispatch(plan):
            clocks["dispatches"] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return dispatch(plan)
            except RuntimeError as e:
                sync_errors.append(str(e))
                raise
            finally:
                torch.cuda.set_sync_debug_mode("default")

        eng.resolve, eng.columnar_dispatch = timed(eng.resolve, "engine_s"), guarded_dispatch

    def role(proc, eng, **kw):
        r = Resolver(proc, eng, pipeline=pipeline, **kw)
        r._sample_rows = timed(r._sample_rows, "sample_s")
        return r

    record_batch = blackbox.record_batch
    engines = [e for e in (engine, engine2) if e is not None]
    for e in engines:
        instrument(e)
    blackbox.record_batch = timed(record_batch, "journal_s")
    journal = blackbox.install(blackbox.BlackboxJournal(
        str(journal_dir), fresh=True, segment_bytes=ROLE_JOURNAL_SEGMENT_BYTES))
    proxy = sim.new_process("proxy")
    rproc = sim.new_process("resolver")
    roles = [role(rproc, stack if stack is not None else engine, start_version=0)]
    endpoints = [Endpoint(rproc.address, roles[0].token)]
    replies, answered_by, latency = {}, {}, {}
    kill_version = batches[kill_at][1] if kill_at is not None else None
    depth = pipeline.depth if pipeline is not None else 1

    def request(i):
        txns, version, _ = batches[i]
        prev = batches[i - 1][1] if i else 0
        return ResolveTransactionBatchRequest(prev_version=prev, version=version,
                                              last_received_version=prev, transactions=txns)

    async def send(gen, i):
        version, t0 = batches[i][1], sched.time
        try:
            reply = await sim.net.request(proxy.address, endpoints[gen], request(i))
        except error.FDBError:
            return      # the role died with the request in flight: gen2 answers it
        if version not in replies:
            replies[version] = list(reply.committed)
            answered_by[version] = gen
            latency[version] = sched.time - t0

    def spawn_send(gen, i):
        sched.spawn(send(gen, i), TaskPriority.PROXY_COMMIT, name=f"proxy.send{gen}")

    async def feeder():
        gen = 0
        for i in range(len(batches)):
            if buggify.buggify():
                await delay(sched.rng.random01() * 0.01, TaskPriority.PROXY_COMMIT)
            spawn_send(gen, i)
            if i % 4 == 3:
                spawn_send(gen, i)
            if gen == 0 and kill_version is not None and i >= kill_at + depth:
                while kill_version not in replies:
                    await delay(0.005, TaskPriority.PROXY_COMMIT)
                sim.kill_process(rproc)
                for v in [v for v in replies if v > kill_version]:
                    del replies[v], answered_by[v], latency[v]
                rproc2 = sim.new_process("resolver2")
                roles.append(role(rproc2, engine2, start_version=kill_version,
                                  token_suffix="gen2"))
                endpoints.append(Endpoint(rproc2.address, roles[1].token))
                gen = 1
                for j in range(kill_at + 1, i + 1):
                    spawn_send(gen, j)

    fc.FIXPOINT.reset_counts()
    t0 = time.perf_counter()
    try:
        sched.spawn(feeder(), TaskPriority.PROXY_COMMIT, name="proxy.feeder")
        sim.run(until=ROLE_RUN_UNTIL)
        wall = time.perf_counter() - t0
    finally:
        set_scheduler(None)
        buggify.disable()
        summary = journal.summary()
        ring = [(ev.proc, ev.payload) for ev in journal.events() if ev.kind == "batch"]
        blackbox.uninstall()
        blackbox.record_batch = record_batch
        for e in engines:
            del e.resolve, e.columnar_dispatch
    check(not sync_errors, f"{label}: {len(sync_errors)} dispatches synchronized with the "
          f"card: {sync_errors[:1]}")
    launches = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
    check(launches > 0 and fc.FIXPOINT.plain_cuda_calls == 0,
          f"{label}: {launches} kernel launches, {fc.FIXPOINT.plain_cuda_calls} plain "
          "fixpoints on CUDA tensors")
    check(set(replies) == {v for _, v, _ in batches},
          f"{label}: {len(replies)} of {len(batches)} versions answered")
    return {"label": label, "roles": roles, "replies": replies, "answered_by": answered_by,
            "latency": latency, "tasks": tasks, "wall_s": wall, "launches": launches,
            "journal_dir": str(journal_dir), "kill_version": kill_version, "stack": stack,
            "journal": {"batches": ring, "shed_events": summary["shed_events"],
                        "durability_gap": summary["durability_gap"]}, **clocks}


def role_sequences(run):
    """Each role process's journaled (version, new_oldest) sequence, from
    the journal's ring."""
    out = {}
    for proc, b in run["journal"]["batches"]:
        out.setdefault(proc, []).append((b.version, b.new_oldest))
    return {proc: tuple(seq) for proc, seq in out.items()}


def journal_read_back(journal_dir, ring):
    """Read a role run's journal back from disk (read_journal): each role
    process's (version, new_oldest, verdicts) sequence, in order, and the
    versions whose record on disk holds other transactions than the
    journal's ring (`ring`, [(proc, BBBatch)]) for that process and
    version. Returns ({proc: sequence on disk}, {proc: [version, ...]})."""
    from foundationdb_tpu_torch.core import blackbox

    ring_txns = {(proc, b.version): b.txns for proc, b in ring}
    disk, differ = {}, {}
    for ev in blackbox.read_journal(journal_dir):
        if ev.kind == "batch":
            b = ev.payload
            disk.setdefault(ev.proc, []).append((b.version, b.new_oldest, list(b.verdicts)))
            if list(b.txns) != list(ring_txns.get((ev.proc, b.version), ())):
                differ.setdefault(ev.proc, []).append(b.version)
    return disk, differ


def oracle_replay(seq):
    """One role process's journaled batches ([BBBatch], from the journal's
    ring) through a fresh OracleConflictEngine: ({(version, new_oldest),
    ...}, the oracle's verdicts per batch). Host Python only, quadratic in
    a batch's transactions."""
    from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine

    oracle = OracleConflictEngine()
    return (tuple((b.version, b.new_oldest) for b in seq),
            [[int(x) for x in oracle.resolve(list(b.txns), b.version, b.new_oldest)]
             for b in seq])


def replay_jobs(runs):
    """The distinct journaled sequences of `runs` to replay, longest first:
    [[BBBatch, ...], ...], one per role process whose (version, new_oldest)
    sequence is not a prefix of one already listed."""
    seqs = []
    for run in runs:
        by_proc = {}
        for proc, b in run["journal"]["batches"]:
            by_proc.setdefault(proc, []).append(b)
        seqs += by_proc.values()
    jobs, keys = [], []
    for seq in sorted(seqs, key=len, reverse=True):
        key = tuple((b.version, b.new_oldest) for b in seq)
        if not any(k[:len(key)] == key for k in keys):
            jobs.append(seq)
            keys.append(key)
    return jobs


def check_role_run(run, disk, replays):
    """Hold a role run to the oracle replay of its journal. The journal's
    ring gives each role's (txns, version, new_oldest, verdicts) sequence;
    `replays` maps each replayed (version, new_oldest) sequence to its
    oracle verdicts (a prefix of a replayed sequence reads its verdicts off
    it); `disk` is the journal read back from disk. Each role resolved each
    version at most once, counts as many resolved batches as it journaled,
    and journaled the oracle's verdicts; the disk holds the ring's records
    in order less exactly the ones the journal reports shed; every accepted
    reply equals the replay of the generation that gave it. After a kill,
    gen2 resolved every later version exactly once and gave every later
    reply. Returns the mismatches (0, or the run fails), the first role's
    horizon by version and the records shed."""
    label = run["label"]
    resolved, shed = [], 0
    sequences = role_sequences(run)
    for gen, role in enumerate(run["roles"]):
        key = sequences.get(role.proc.address, ())
        check(len({v for v, _ in key}) == len(key), f"{label}: role {gen} resolved a version twice")
        n = role.stats.counter("batches_resolved").value
        check(n == len(key), f"{label}: role {gen} counts {n} resolved batches, its journal "
              f"{len(key)}")
        hit = next((k for k in replays if k[:len(key)] == key), None)
        check(hit is not None, f"{label}: role {gen}'s sequence was never replayed")
        want = dict(zip((v for v, _ in key), replays[hit]))
        check(all(list(b.verdicts) == want[b.version] for p, b in run["journal"]["batches"]
                  if p == role.proc.address),
              f"{label}: role {gen}'s journaled verdicts differ from the oracle replay")
        on_disk = disk.get(role.proc.address, [])
        kept = {v for v, _, _ in on_disk}
        check([(v, old) for v, old, _ in on_disk] == [(v, old) for v, old in key if v in kept]
              and all(verdicts == want[v] for v, _, verdicts in on_disk),
              f"{label}: role {gen}'s journal on disk differs from its ring")
        shed += len(key) - len(on_disk)
        resolved.append(want)
    check(shed == run["journal"]["shed_events"] and run["journal"]["durability_gap"] == (shed > 0),
          f"{label}: {shed} records missing from disk, the journal reports "
          f"{run['journal']['shed_events']} shed")
    mismatches = sum(got != resolved[run["answered_by"][v]].get(v)
                     for v, got in run["replies"].items())
    check(mismatches == 0, f"{label}: {mismatches} replies differ from the oracle replay of the "
          "role's journal")
    kill = run["kill_version"]
    if kill is not None:
        later = sorted(v for v in run["replies"] if v > kill)
        check(len(resolved) == 2 and sorted(resolved[1]) == later
              and all(run["answered_by"][v] == 1 for v in later),
              f"{label}: the versions after the kill point were not each answered once by gen2")
    else:
        check(len(resolved) == 1 and sorted(resolved[0]) == sorted(run["replies"]),
              f"{label}: the role did not resolve every version once")
    horizons = dict(sequences.get(run["roles"][0].proc.address, ()))
    return mismatches, horizons, shed


def replay_and_check(run):
    """journal_read_back, oracle_replay and check_role_run in this
    process."""
    disk, differ = journal_read_back(run["journal_dir"], run["journal"]["batches"])
    check(not differ, f"{run['label']}: the journal on disk holds other transactions than "
          f"its ring at versions {differ}")
    return check_role_run(run, disk, dict(map(oracle_replay, replay_jobs([run]))))


def journal_bytes(directory):
    return [p.read_bytes() for p in sorted(Path(directory).glob("bbox-*.seg"))]


def bare_engine_txn_per_s(engine, batches, horizons, replies):
    """The same engine on the same traffic with no role around it: serial
    resolve() at the versions and horizons (`horizons`, by version) the role
    used, from an emptied table; verdicts equal the role's replies."""
    import torch

    engine.base = engine.oldest_version = 0
    engine.clear(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for txns, version, _ in batches:
        got = [int(v) for v in engine.resolve(txns, version, horizons[version])]
        check(got == replies[version], f"the bare engine at version {version} differs from "
              "the role's reply")
    return sum(len(t) for t, _, _ in batches) / (time.perf_counter() - t0)


def resolver_role_phase(fc, pl, card, engines, clocks, rng):
    """The resolver role (server/resolver.py) over the port's warmed engines
    in the port's simulator (drive_role) on the columnar traffic (less its
    largest batch: ROLE_SIZES) with its
    versions MAX_WRITE_TRANSACTION_LIFE_VERSIONS // GC_LAG_BATCHES apart:
    serially, pipelined at depth 1-3, the loop engine at depth 2, a kill
    and restart at depth 2, and depth 2 again with the same seed. The
    pipelined service runs on the card's own figures: `clocks` gives the
    columnar and loop phases' pack ms per txn and the telemetry phase's
    sampled device ms per bucket (and the loop's enqueue and decode ms).
    Engines are cleared to version 0 between runs, with no capture. After
    each run without a kill, its engine resolves the traffic bare, at the
    role's horizons, for its wall txn/s without the role under the same
    host load. After the last run, ROLE_REPLAY_WORKERS worker processes
    read each run's journal back from disk (its records' transactions
    equal to the ring's) and replay each distinct (version, new_oldest)
    sequence through the oracle once; every run holds to the replay
    (check_role_run). The loop role makes no blocking sync; the second
    depth-2 run gives the same replies, journal bytes and scheduler steps
    as the first."""
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    import torch

    from foundationdb_tpu_torch.core.types import MAX_WRITE_TRANSACTION_LIFE_VERSIONS as life

    eng, leng, eng2 = engines["columnar"], engines["device_loop"], engines["gen2"]
    batches = columnar_traffic(rng, ROLE_SIZES, READ_ONLY, step=role_version_step())
    txns_total = sum(len(t) for t, _, _ in batches)

    def config(depth, key="columnar", **kw):
        return pl.PipelineConfig(depth=depth, pack_ms_per_txn=clocks[key]["pack_ms_per_txn"],
                                 device_ms_by_bucket=clocks[key]["device_ms_by_bucket"], **kw)

    def cleared(*engs):
        for e in engs:
            if e is not None:
                e.base = e.oldest_version = 0
                e.clear(0)
        torch.cuda.synchronize()

    runs = [("serial", "resolver_role_serial", eng, {}),
            *((f"depth{d}", "resolver_role_pipelined", eng, {"pipeline": config(d)})
              for d in ROLE_DEPTHS),
            ("device_loop_depth2", "resolver_role_device_loop", leng, {"pipeline": config(
                2, "device_loop", dispatch_mode="device_loop",
                queue_enqueue_ms=clocks["device_loop"]["queue_enqueue_ms"],
                result_drain_ms=clocks["device_loop"]["result_drain_ms"])}),
            ("restart_depth2", "resolver_role_restart", eng,
             {"pipeline": config(2), "kill_at": ROLE_KILL_AT, "engine2": eng2}),
            ("depth2_same_seed", "resolver_role_pipelined", eng, {"pipeline": config(2)})]
    captures = [e.perf.captures for e in (eng, leng, eng2)]
    out, launches, bare, served = {"runs": {}}, {}, {}, []
    with tempfile.TemporaryDirectory(prefix="role-journals-") as tmp:
        for label, path, engine, kw in runs:
            t0 = time.perf_counter()
            cleared(engine, kw.get("engine2"))
            stats0 = dict(getattr(engine, "loop_stats", {}))
            run = drive_role(fc, engine, batches, Path(tmp) / label, f"resolver role, {label}",
                             **kw)
            if stats0:
                blocking = engine.loop_stats["blocking_syncs"] - stats0["blocking_syncs"]
                check(blocking == 0, f"the loop role made {blocking} blocking syncs")
                run["blocking_syncs"] = blocking
            if kw.get("kill_at") is None:
                # the same engine bare right after its role run, under the
                # same host load (after a kill, gen2's table starts empty,
                # so the bare pass could not reproduce its replies: the
                # restart run reads the engine's latest bare pass)
                horizons = dict(role_sequences(run)[run["roles"][0].proc.address])
                bare[id(engine)] = bare_engine_txn_per_s(engine, batches, horizons,
                                                         run["replies"])
            run["bare_txn_per_s"] = bare[id(engine)]
            run["seconds"] = time.perf_counter() - t0
            launches[path] = launches.get(path, 0) + run["launches"]
            served.append((label, engine, kw, run))
        # the oracle replays and the read-backs run after the last timed run,
        # so no worker shares the host with a role or a bare pass
        t0 = time.perf_counter()
        with ProcessPoolExecutor(ROLE_REPLAY_WORKERS, mp_context=get_context("spawn")) as pool:
            replaying = [pool.submit(oracle_replay, seq) for seq in replay_jobs(
                [run for *_, run in served])]
            reading = [pool.submit(journal_read_back, run["journal_dir"],
                                   run["journal"]["batches"]) for *_, run in served]
            replays = dict(f.result() for f in replaying)
            read_back = [f.result() for f in reading]
        replay_s = time.perf_counter() - t0
        for (label, engine, kw, run), (disk, differ) in zip(served, read_back):
            check(not differ, f"resolver role, {label}: the journal on disk holds other "
                  f"transactions than its ring at versions {differ}")
            mismatches, horizons, shed = check_role_run(run, disk, replays)
            lat = list(run["latency"].values())
            rec = {"txns": txns_total, "batches": len(batches),
                   "duplicates": sum(1 for i in range(len(batches)) if i % 4 == 3),
                   "mismatches": mismatches, "launches": run["launches"],
                   "virtual_p50_ms": nearest_rank(lat, 0.50) * 1e3,
                   "virtual_p99_ms": nearest_rank(lat, 0.99) * 1e3,
                   "wall_s": run["wall_s"], "engine_s": run["engine_s"],
                   "journal_s": run["journal_s"], "key_sample_s": run["sample_s"],
                   "dispatches": run["dispatches"],
                   "tightened_horizons": sum(old != max(0, v - life)
                                             for v, old in horizons.items()),
                   "wall_txn_per_s": txns_total / run["wall_s"],
                   "bare_engine_txn_per_s": run["bare_txn_per_s"],
                   "scheduler_steps": len(run["tasks"]), "journal_shed": shed,
                   "journal_records_read_back": sum(map(len, disk.values())),
                   "blocking_syncs": run.get("blocking_syncs"),
                   "answered_by_gen2": sum(run["answered_by"].values())}
            out["runs"][label] = rec
            rest_ms = (run["wall_s"] - run["engine_s"] - run["journal_s"]
                       - run["sample_s"]) / len(batches) * 1e3
            print(f"resolver role, {label} [{card}]: {rec['txns']} txns in {rec['batches']} "
                  f"batches, {rec['duplicates']} delivered twice, {mismatches} mismatches against "
                  f"the oracle replay of its journal"
                  + (f" ({rec['answered_by_gen2']} versions answered by gen2)"
                     if kw.get("kill_at") is not None else "")
                  + f"; virtual reply latency p50 {rec['virtual_p50_ms']:.4f} ms p99 "
                  f"{rec['virtual_p99_ms']:.4f} ms; wall {rec['wall_txn_per_s']:.0f} txn/s through "
                  f"the role (engine {run['engine_s'] * 1e3:.1f} ms, journal "
                  f"{run['journal_s'] * 1e3:.1f} ms, the role's key sample "
                  f"{run['sample_s'] * 1e3:.1f} ms, the rest {rest_ms:.3f} ms a batch), bare "
                  f"engine {rec['bare_engine_txn_per_s']:.0f} txn/s"
                  + (" (its pass after the previous run)" if kw.get("kill_at") is not None
                     else " (its pass right after this run)")
                  + f"; {rec['scheduler_steps']} scheduler steps; {run['dispatches']} dispatches "
                  "under sync debug \"error\""
                  + (f", {run['blocking_syncs']} blocking syncs" if "blocking_syncs" in run else "")
                  + f"; {run['launches']} fixpoint launches; buggify shed {shed} journal records "
                  f"and tightened {rec['tightened_horizons']} horizons; "
                  f"{rec['journal_records_read_back']} records read back from disk, their "
                  f"transactions equal to the ring's ({run['seconds']:.1f} s)", flush=True)
        first = next(run for label, *_, run in served if label == "depth2")
        again = next(run for label, *_, run in served if label == "depth2_same_seed")
        same = {"replies": again["replies"] == first["replies"],
                "scheduler_steps": again["tasks"] == first["tasks"],
                "journal_bytes": journal_bytes(again["journal_dir"])
                == journal_bytes(first["journal_dir"])}
        check(all(same.values()), f"the same seed ran differently: {same}")
        out["seed_replay"] = dict(same, steps=len(again["tasks"]),
                                  bytes=sum(map(len, journal_bytes(again["journal_dir"]))))
    print(f"  seed replay [{card}]: depth 2 twice with seed {SEED}: equal replies, "
          f"{out['seed_replay']['steps']} equal (virtual time, task) scheduler steps, "
          f"{out['seed_replay']['bytes']} equal journal bytes; {len(replays)} oracle replays "
          f"and {len(served)} read-backs in {ROLE_REPLAY_WORKERS} workers after the last run "
          f"({replay_s:.1f} s)", flush=True)
    check([e.perf.captures for e in (eng, leng, eng2)] == captures,
          "an engine captured in the role phase")
    out.update(launches=launches, oracle_replays=len(replays), replay_wait_s=replay_s)
    return out


#: the supervised runs' traffic: the columnar generator at the ladder's
#: sizes (200-2048 txns a batch), three times over. The failover oracle and
#: the probe are quadratic host Python (~25 s for one 20000-txn batch), and
#: a rewarm puts a version's committed writes in one synthetic transaction,
#: which may hold at most wp = 4096 point writes: a 2048-txn batch's fit
SUPERVISED_SIZES = [200, 512, 1024, 2048, 300, 900, 1800, 256, 700, 1500, 2048, 400] * 3
#: the supervisor of the fault runs: tests/test_fault_tolerance.py's CFG
#: (the knobs' defaults would take 4-batch failover and probation windows)
SUPERVISOR = dict(dispatch_timeout=0.2, retry_budget=2, retry_backoff=0.02,
                  probation_batches=2, failover_min_batches=2)
#: the three supervised runs: fault rates, probe rate, buggify. A straggler
#: waits at most 1.5 x slow_seconds = 0.15 s, under the 0.2 s watchdog, so
#: every watchdog fault is an injected hang
SUPERVISED_RUNS = {
    "fault_free": (dict(exception=0, hang=0, slow=0, outage=0, flip=0), 1.0, False),
    "faults": (dict(exception=0.05, hang=0.03, slow=0.1, slow_seconds=0.1, outage=0.03,
                    outage_seconds=0.2, flip=0), 0.25, True),
    "flips": (dict(exception=0, hang=0, slow=0, outage=0, flip=0.05), 1.0, True),
}


def sort_faults(stack, log):
    """Count a supervisor's dispatch faults by cause in `log["faults"]`:
    an injected exception, the watchdog (an injected hang), a buggify site
    of the supervisor, or other (the card itself); the message of each
    other fault in `log["other_errors"]`."""
    from foundationdb_tpu_torch.core import error

    log.setdefault("faults", {"injected": 0, "watchdog": 0, "buggify": 0, "other": 0})
    dispatch_once = stack._dispatch_once

    async def counted_dispatch(*a):
        try:
            return await dispatch_once(*a)
        except error.FDBError as e:
            msg = str(e)
            kind = ("buggify" if "buggify:" in msg else "injected" if "injected dispatch" in msg
                    else "watchdog" if "dispatch watchdog" in msg else "other")
            log["faults"][kind] += 1
            if kind == "other":
                log.setdefault("other_errors", []).append(msg)
            raise

    stack._dispatch_once = counted_dispatch


def supervised_stack(card_engine, rates, probe_rate, log):
    """ResilientEngine(FaultInjectingEngine(card_engine)) with its dispatch
    faults sorted by cause (`log["faults"]`: injected exception, watchdog,
    buggify, other), its health transitions and its rewarms (ms, captures,
    ok) logged. Built inside the run's simulator."""
    from foundationdb_tpu_torch.fault import (FaultInjectingEngine, FaultRates, ResilienceConfig,
                                              ResilientEngine)

    inj = FaultInjectingEngine(card_engine, rates=FaultRates(**rates))
    stack = ResilientEngine(inj, ResilienceConfig(probe_rate=probe_rate, **SUPERVISOR))
    log.update(faults={"injected": 0, "watchdog": 0, "buggify": 0, "other": 0},
               transitions=[], rewarms=[], injector=inj)
    sort_faults(stack, log)
    set_state, rewarm = stack._set_state, stack._rewarm_device

    def logged_state(state):
        if state != stack.state:
            log["transitions"].append((stack.state, state))
        set_state(state)

    def timed_rewarm():
        import torch

        c0, t0, ok = card_engine.perf.captures, time.perf_counter(), False
        try:
            rewarm()
            ok = True
        finally:
            if card_engine.device.type == "cuda":
                torch.cuda.synchronize()
            log["rewarms"].append(((time.perf_counter() - t0) * 1e3,
                                   card_engine.perf.captures - c0, ok))

    stack._set_state, stack._rewarm_device = logged_state, timed_rewarm
    return stack


def supervised_role_phase(fc, pl, card, eng, clocks, rng, role_depth2):
    """The resolver role at depth 2 in the port's simulator over
    ResilientEngine(FaultInjectingEngine(`eng`)), journal on, on the
    columnar generator at 200-2048 txns a batch: (a) fault-free with
    buggify off and probe_rate 1.0 (every batch checked against a
    shadow-rebuilt oracle): HEALTHY, 0 faults, 0 probe mismatches, 0 oracle
    batches; (b) exceptions, hangs, stragglers and outages at probe_rate
    0.25, buggify on: the run visits SUSPECT -> HEALTHY and FAILED ->
    PROBATION -> HEALTHY; (c) flips at 0.05 with probe_rate 1.0: it ends
    QUARANTINED. The same traffic through the bare role (no supervisor)
    runs first, for the wall txn/s beside theirs. Every reply equals the oracle
    replay of the run's journal; every dispatch fault is one the injector
    or a buggify site caused (none is a card error), counted by cause;
    no dispatch synchronizes; a rewarm captures nothing."""
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    import torch

    batches = columnar_traffic(rng, SUPERVISED_SIZES, {}, step=role_version_step())
    txns_total = sum(len(t) for t, _, _ in batches)
    pipeline = pl.PipelineConfig(depth=2, pack_ms_per_txn=clocks["pack_ms_per_txn"],
                                 device_ms_by_bucket=clocks["device_ms_by_bucket"])
    captures0 = eng.perf.captures
    served, out = [], {"runs": {}, "batches": len(batches), "txns": txns_total}
    with tempfile.TemporaryDirectory(prefix="supervised-journals-") as tmp:
        for label, (rates, probe_rate, bug) in [("bare", (None, 0, True)),
                                                *SUPERVISED_RUNS.items()]:
            eng.base = eng.oldest_version = 0
            eng.clear(0)
            if eng.device.type == "cuda":
                torch.cuda.synchronize()
            log = {}
            supervise = (None if rates is None
                         else lambda e, r=rates, p=probe_rate: supervised_stack(e, r, p, log))
            t0 = time.perf_counter()
            run = drive_role(fc, eng, batches, Path(tmp) / label, f"supervised role, {label}",
                             pipeline=pipeline, supervise=supervise, buggify_on=bug)
            run["seconds"] = time.perf_counter() - t0
            run["log"] = log
            served.append((label, run))
        t0 = time.perf_counter()
        with ProcessPoolExecutor(ROLE_REPLAY_WORKERS, mp_context=get_context("spawn")) as pool:
            replaying = [pool.submit(oracle_replay, seq) for seq in replay_jobs(
                [run for _, run in served])]
            reading = [pool.submit(journal_read_back, run["journal_dir"],
                                   run["journal"]["batches"]) for _, run in served]
            replays = dict(f.result() for f in replaying)
            read_back = [f.result() for f in reading]
        replay_s = time.perf_counter() - t0
        for (label, run), (disk, differ) in zip(served, read_back):
            check(not differ, f"supervised role, {label}: the journal on disk holds other "
                  f"transactions than its ring at versions {differ}")
            mismatches, _, shed = check_role_run(run, disk, replays)
            rec = {"mismatches": mismatches, "launches": run["launches"],
                   "wall_s": run["wall_s"], "wall_txn_per_s": txns_total / run["wall_s"],
                   "engine_s": run["engine_s"], "journal_s": run["journal_s"],
                   "dispatches": run["dispatches"], "journal_shed": shed,
                   "seconds": run["seconds"]}
            stack, log = run["stack"], run["log"]
            if stack is not None:
                st = stack.health_stats()
                inj = log["injector"].injected
                faults = log["faults"]
                rewarms = log["rewarms"]
                rec.update(stats={k: v for k, v in st.items() if k != "device"},
                           transitions=log["transitions"], faults=faults, injected=dict(inj),
                           rewarms=len(rewarms), rewarm_failures=sum(not ok for *_, ok in rewarms),
                           rewarm_ms=[round(ms, 3) for ms, _, _ in rewarms],
                           rewarm_captures=sum(c for _, c, _ in rewarms))
                check(faults["other"] == 0, f"supervised role, {label}: {faults['other']} "
                      f"dispatch faults came from the card itself: {log.get('other_errors')}")
                check(sum(faults.values()) == st["dispatch_faults"]
                      and faults["injected"] == inj["exceptions"]
                      and faults["watchdog"] == inj["hangs"],
                      f"supervised role, {label}: dispatch_faults {st['dispatch_faults']} is not "
                      f"the injector's {inj} plus the buggify sites' ({faults})")
                check(rec["rewarm_captures"] == 0,
                      f"supervised role, {label}: rewarms captured {rec['rewarm_captures']} graphs")
                if label == "fault_free":
                    check(st["state"] == "healthy" and st["dispatch_faults"] == 0
                          and st["probe_mismatches"] == 0 and st["oracle_batches"] == 0
                          and st["probes"] == st["batches"],
                          f"supervised role, fault-free: {st}")
                elif label == "faults":
                    arcs = set(log["transitions"])
                    check({("suspect", "healthy"), ("failed", "probation"),
                           ("probation", "healthy")} <= arcs and st["probe_mismatches"] == 0,
                          f"supervised role, faults: transitions {log['transitions']}, {st}")
                else:
                    check(st["state"] == "quarantined" and st["probe_mismatches"] >= 1,
                          f"supervised role, flips: {st}")
            out["runs"][label] = rec
            print(f"supervised role, {label} [{card}]: {txns_total} txns in {len(batches)} "
                  f"batches at depth 2, {mismatches} replies off the oracle replay of its "
                  f"journal; wall {rec['wall_txn_per_s']:.0f} txn/s (the bare role on the same "
                  f"traffic {out['runs'].get('bare', {}).get('wall_txn_per_s', float('nan')):.0f}"
                  f", the role phase's depth-2 run {role_depth2:.0f} on its own traffic); "
                  f"{run['launches']} fixpoint launches; {run['dispatches']} dispatches under "
                  f"sync debug \"error\" ({run['seconds']:.1f} s)", flush=True)
            if stack is not None:
                print(f"  transitions {rec['transitions']}; stats {rec['stats']}; faults by "
                      f"cause {rec['faults']} (injector {rec['injected']}); {rec['rewarms']} "
                      f"rewarms ({rec['rewarm_failures']} failed) {rec['rewarm_ms']} ms, "
                      f"{rec['rewarm_captures']} captures", flush=True)
    check(eng.perf.captures == captures0, "the card engine captured in the supervised phase")
    out.update(replay_wait_s=replay_s, oracle_replays=len(replays),
               launches={label: rec["launches"] for label, rec in out["runs"].items()})
    return out


#: the crash phase: the columnar generator at the ladder's sizes, 12
#: batches; child A serves the first CRASH_KILL_AFTER and is killed, child
#: B recovers and serves the rest. Snapshots every 3 batches' versions
#: (batches 0, 3 and 6; the two newest kept), so the journal suffix
#: replayed over the newest snapshot is batches 7 and 8
CRASH_SIZES = [200, 512, 1024, 2048, 300, 900, 1800, 256, 700, 1500, 2048, 400]
CRASH_KILL_AFTER = 9
CRASH_SNAPSHOT_EVERY = 3 * VERSION_STEP
CRASH_SEED = SEED + 8
#: seconds a crash child may take to report (a restart recaptures ~10 s)
CRASH_CHILD_TIMEOUT_S = 600


def crash_traffic():
    import numpy as np

    return columnar_traffic(np.random.default_rng(CRASH_SEED), CRASH_SIZES, {})


def crash_child(which, directory, device, t_spawn, conn):
    """One process of the crash phase (spawn context). "A" (first boot):
    a BlackboxJournal with fsync_interval=1 in `directory`, a ProgramCache
    in `directory`/progcache, a supervised columnar engine warmed up, a
    SnapshotManager; serves the first CRASH_KILL_AFTER batches, reports
    with the journal still open and waits to be killed. "B" (restart): the
    same journal and cache, the engine built without warmup, recover(),
    then the remaining batches. The supervisor runs at probe_rate 0 with
    no faults injected, so a card error would surface as a dispatch fault
    and an oracle-served batch: each child holds its supervisor HEALTHY
    with 0 dispatch faults, 0 failovers and 0 oracle batches (B after the
    recovery and again after serving), and the fixpoint launched on the
    card while it served. Each reports its clocks (wall seconds since
    `t_spawn`, the parent's clock just before start()) over `conn`."""
    t_enter = time.time()
    import pickle

    import torch

    from foundationdb_tpu_torch.core import blackbox, buggify, progcache
    from foundationdb_tpu_torch.fault import (FaultInjectingEngine, FaultRates, ResilienceConfig,
                                              ResilientEngine, handoff, recovery)
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    from foundationdb_tpu_torch.ops import fixpoint_cuda as fc
    from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine
    from foundationdb_tpu_torch.sim.loop import set_scheduler
    from foundationdb_tpu_torch.sim.simulator import Simulator

    rep = {"which": which, "imports_s": time.time() - t_enter, "start_s": t_enter - t_spawn}
    dev = torch.device(device)
    t0 = time.time()
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize()
    rep["cuda_init_s"] = time.time() - t0
    sim = Simulator(CRASH_SEED)
    buggify.disable()
    blackbox.install(blackbox.BlackboxJournal(directory, fsync_interval=1, proc=which))
    cache = progcache.install(progcache.ProgramCache(os.path.join(directory, "progcache")))
    t0 = time.time()
    engine = TorchConflictEngine(ck.KernelConfig(), device=dev, ladder=LADDER, scan_sizes=SCANS,
                                 device_time_sample_rate=0.0)
    stack = ResilientEngine(
        FaultInjectingEngine(engine, rates=FaultRates(exception=0, hang=0, slow=0, outage=0,
                                                      flip=0)),
        ResilienceConfig(probe_rate=0.0, **SUPERVISOR))
    rep["build_s"] = time.time() - t0
    batches = crash_traffic()
    verdicts = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def healthy(when):
        st = stack.health_stats()
        rep.setdefault("health", {})[when] = {k: v for k, v in st.items() if k != "device"}
        check(st["state"] == "healthy" and st["dispatch_faults"] == 0 and st["failovers"] == 0
              and st["oracle_batches"] == 0 and st["rewarm_failures"] == 0,
              f"crash child {which}, {when}: the supervisor left the card ({st})")

    def served_on_card(part, first_clock=None):
        fc.FIXPOINT.reset_counts()
        t0 = time.time()
        sim.sched.run_until(sim.sched.spawn(serve(part, first_clock)), until=1e9)
        sync()
        rep["serve_s"] = time.time() - t0
        rep["launches"] = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
        check(rep["launches"] > 0 and fc.FIXPOINT.plain_cuda_calls == 0,
              f"crash child {which}: {rep['launches']} kernel launches serving, "
              f"{fc.FIXPOINT.plain_cuda_calls} plain fixpoints on CUDA tensors")
        healthy("after serving")

    async def serve(part, first_clock=None):
        for txns, v, old in part:
            got = [int(x) for x in await stack.resolve(txns, v, old)]
            blackbox.record_batch(txns, v, old, got, engine="torch")
            verdicts[v] = got
            if mgr is not None:
                mgr.note_batch(stack, v)
            if first_clock is not None and "first_batch_s" not in rep:
                rep["first_batch_s"] = time.time() - t_spawn

    mgr = None
    if which == "A":
        t0 = time.time()
        stack.warmup()
        sync()
        rep["warmup_s"] = time.time() - t0
        rep["warm_captures"] = engine.perf.captures
        mgr = recovery.SnapshotManager(directory, interval=CRASH_SNAPSHOT_EVERY, proc="A")
        served_on_card(batches[:CRASH_KILL_AFTER])
        rep["snapshots"] = {k: v for k, v in mgr.stats.items()}
        rep["journal_fsyncs"] = blackbox.active().fsyncs
        prog = next(iter(engine._programs.values()))
        try:
            pickle.dumps(prog.graphs[False] if prog.graphs else prog)
            rep["graph_pickle"] = "pickled"
        except Exception as e:   # the finding: a captured graph has no serialized form
            rep["graph_pickle"] = f"{type(e).__name__}: {e}"
    else:
        clocks = {"snapshot_load_s": 0.0, "snapshot_replay_s": 0.0, "journal_read_s": 0.0}

        def timed(fn, key):
            def run(*a, **k):
                t = time.time()
                try:
                    return fn(*a, **k)
                finally:
                    clocks[key] += time.time() - t
            return run

        replay_slice = handoff.replay_slice

        async def timed_replay(*a, **k):
            t = time.time()
            try:
                return await replay_slice(*a, **k)
            finally:
                sync()
                clocks["snapshot_replay_s"] += time.time() - t

        recovery.latest_snapshot = timed(recovery.latest_snapshot, "snapshot_load_s")
        blackbox_read = recovery.blackbox.read_journal
        recovery.blackbox.read_journal = timed(blackbox_read, "journal_read_s")
        handoff.replay_slice = timed_replay
        fc.FIXPOINT.reset_counts()
        t0 = time.time()
        res = sim.sched.run_until(sim.sched.spawn(recovery.recover(stack, directory, proc="B")),
                                  until=1e9)
        sync()
        recovery.blackbox.read_journal = blackbox_read
        handoff.replay_slice = replay_slice
        rep["recover_s"] = time.time() - t0
        rep["recovery"] = res.as_dict()
        rep["mismatch_detail"] = res.mismatch_detail
        rep["recovery_clocks"] = clocks
        rep["recovery_captures"] = engine.perf.captures
        rep["recovery_builds"] = {k: v for k, v in engine.perf_ledger.compiles.items()}
        rep["recovery_launches"] = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
        healthy("after recovery")
        served_on_card(batches[CRASH_KILL_AFTER:], True)
        rep["captures_after_serving"] = engine.perf.captures
    set_scheduler(None)
    rep["verdicts"] = verdicts
    rep["progcache"] = cache.summary()
    if which == "A":
        # the journal stays installed and open: the SIGKILL lands on what
        # fsync_interval=1 made durable, with no clean close behind it
        conn.send(rep)
        time.sleep(3600)
    blackbox.uninstall()
    conn.send(rep)


def crash_recovery_phase(card):
    """A kill -9 and a restart on one directory, each process its own
    (spawn context). Child A boots (warmup), serves CRASH_KILL_AFTER
    batches with the journal fsyncing every record and snapshots landing,
    and is killed with SIGKILL, journal open, once its last batch is
    durable. Child B restarts on the same directory: it builds its engine
    cold, runs recover() and serves the rest. Both hold their supervisor
    to the card (crash_child). Checks: complete mode, coverage, 0 verdict
    mismatches, B's verdicts equal the oracle's over the whole stream,
    and the journal holds the snapshot and recovery events. Prints the
    result, the blackout beside the budget, the restart's clock from
    process start to the first served batch, the captures the recovery
    made and both children's cache summaries (a port program has no
    serialized form, so the cache holds nothing: core/progcache.py)."""
    import signal
    import tempfile
    from multiprocessing import get_context

    from foundationdb_tpu_torch.core import blackbox
    from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
    from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine

    ctx = get_context("spawn")
    budget = float(SERVER_KNOBS.resolver_recovery_budget_ms)

    def child(which, directory):
        recv, send = ctx.Pipe(duplex=False)
        t_spawn = time.time()
        p = ctx.Process(target=crash_child, args=(which, directory, "cuda", t_spawn, send),
                        daemon=True)
        p.start()
        send.close()
        try:
            if not recv.poll(CRASH_CHILD_TIMEOUT_S):
                fail(f"crash phase: child {which} sent nothing in {CRASH_CHILD_TIMEOUT_S} s")
            rep = recv.recv()
        except EOFError:
            fail(f"crash phase: child {which} died (exit code {p.exitcode})")
        return p, rep

    batches = crash_traffic()
    oracle = OracleConflictEngine()
    want = {v: [int(x) for x in oracle.resolve(t, v, o)] for t, v, o in batches}
    out = {}
    with tempfile.TemporaryDirectory(prefix="crash-") as tmp:
        d = os.path.join(tmp, "resolver")
        a, rep_a = child("A", d)
        os.kill(a.pid, signal.SIGKILL)
        a.join(60)
        check(a.exitcode == -signal.SIGKILL, f"crash phase: child A ended with {a.exitcode}")
        check(sorted(rep_a["verdicts"]) == sorted(v for _, v, _ in batches[:CRASH_KILL_AFTER])
              and all(rep_a["verdicts"][v] == want[v] for v in rep_a["verdicts"]),
              "crash phase: child A's verdicts differ from the oracle's")
        check(rep_a["snapshots"]["written"] >= 2, f"crash phase: {rep_a['snapshots']}")
        check(rep_a["journal_fsyncs"] >= CRASH_KILL_AFTER,
              f"crash phase: child A's journal fsynced {rep_a['journal_fsyncs']} times for "
              f"{CRASH_KILL_AFTER} batches")
        out["A"] = {k: v for k, v in rep_a.items() if k != "verdicts"}
        b, rep = child("B", d)
        b.join(60)
        check(b.exitcode == 0, f"crash phase: child B ended with {b.exitcode}")
        r = rep["recovery"]
        later = sorted(v for _, v, _ in batches[CRASH_KILL_AFTER:])
        check(r["mode"] == "complete" and r["coverage_ok"] and r["verdict_mismatches"] == 0
              and r["error"] is None, f"crash phase, B: recovery {r} "
              f"{rep['mismatch_detail']}")
        check(sorted(rep["verdicts"]) == later
              and all(rep["verdicts"][v] == want[v] for v in later),
              f"crash phase, B: the restarted child's verdicts differ from the "
              "uninterrupted oracle's")
        kinds = {e.kind for e in blackbox.read_journal(d)}
        check({"snapshot", "recovery", "batch"} <= kinds,
              f"crash phase, B: the journal holds {sorted(kinds)}")
        c = rep["recovery_clocks"]
        replay_ms = (r["blackout_ms"] - r["warm_ms"]
                     - 1e3 * (c["snapshot_load_s"] + c["snapshot_replay_s"]
                              + c["journal_read_s"]))
        rep["breakdown_ms"] = {
            "start_to_main": rep["start_s"] * 1e3, "imports": rep["imports_s"] * 1e3,
            "cuda_init": rep["cuda_init_s"] * 1e3, "engine_build": rep["build_s"] * 1e3,
            "snapshot_load": c["snapshot_load_s"] * 1e3,
            "snapshot_replay": c["snapshot_replay_s"] * 1e3,
            "journal_read": c["journal_read_s"] * 1e3, "suffix_replay": replay_ms,
            "warm": r["warm_ms"], "to_first_batch": rep["first_batch_s"] * 1e3}
        out["B"] = {k: v for k, v in rep.items() if k != "verdicts"}
        bd = rep["breakdown_ms"]
        print(f"crash phase, B [{card}]: recovery {r}; blackout {r['blackout_ms']:.1f} "
              f"ms against the {budget:.0f} ms budget "
              f"({'within' if r['blackout_ms'] <= budget else 'over'}); process start to "
              f"the first served batch {bd['to_first_batch']:.1f} ms = spawn and main module "
              f"{bd['start_to_main']:.1f} + imports {bd['imports']:.1f} + CUDA init "
              f"{bd['cuda_init']:.1f} + engine build {bd['engine_build']:.1f} + snapshot load "
              f"{bd['snapshot_load']:.1f} + snapshot replay {bd['snapshot_replay']:.1f} + "
              f"journal read {bd['journal_read']:.1f} + suffix replay "
              f"{bd['suffix_replay']:.1f} + warm {bd['warm']:.1f} + the first batch; "
              f"{rep['recovery_captures']} graphs captured in the recovery "
              f"({rep['recovery_builds']} program builds), "
              f"{rep['captures_after_serving'] - rep['recovery_captures']} after; "
              f"{rep['recovery_launches']} fixpoint launches in the recovery, "
              f"{rep['launches']} serving; supervisor {rep['health']}; "
              f"progcache {rep['progcache']}", flush=True)
    print(f"crash phase, A [{card}]: first boot warmup {rep_a['warmup_s']:.2f} s "
          f"({rep_a['warm_captures']} graphs), {CRASH_KILL_AFTER} batches in "
          f"{rep_a['serve_s']:.2f} s ({rep_a['launches']} fixpoint launches), journal "
          f"fsyncs {rep_a['journal_fsyncs']}, snapshots {rep_a['snapshots']}, supervisor "
          f"{rep_a['health']}, killed with SIGKILL, journal open; "
          f"progcache {rep_a['progcache']}; pickling a captured graph: {rep_a['graph_pickle']}",
          flush=True)
    out["budget_ms"] = budget
    return out


#: the reshard phase's traffic: 64 hot keys as the scheduled phase's, set
#: in the middle of the pool so the split lands among them and a cold
#: transaction's 4 keys fall on both sides of it (cross-shard batches), in
#: 15-byte keys so a point write's end key (key + NUL, 16 bytes) fits the
#: 16-byte packed window and run rows read back exactly (run_slice); the
#: two-phase sweep over cross-shard batches is quadratic host Python, so
#: batches hold 200-512 txns
RESHARD_SIZES = [200, 300, 512]
RESHARD_BATCHES = (24, 12, 8)


def reshard_traffic(rng, n_batches, start_v):
    from foundationdb_tpu_torch.core.types import CommitTransaction, KeyRange

    out, now = [], start_v
    for b in range(n_batches):
        now += VERSION_STEP
        n = RESHARD_SIZES[b % len(RESHARD_SIZES)]
        lag = rng.integers(0, 2 * VERSION_STEP, size=n)
        hot = rng.random(n) < 0.5
        hot_key = rng.integers(0, SCHED_HOT_KEYS, size=n) + (POOL_KEYS - SCHED_HOT_KEYS) // 2
        cold = rng.integers(0, POOL_KEYS, size=(n, 4))
        txns = []
        for i in range(n):
            t = CommitTransaction(read_snapshot=int(max(0, now - lag[i])))
            keys = ([b"r/%013d" % hot_key[i]] * 2 if hot[i]
                    else [b"r/%013d" % k for k in cold[i]])
            for j, k in enumerate(keys):
                (t.read_conflict_ranges if j < len(keys) // 2
                 else t.write_conflict_ranges).append(KeyRange(k, k + b"\x00"))
            txns.append(t)
        out.append((txns, now, max(0, now - GC_LAG_BATCHES * VERSION_STEP)))
    return out


def reshard_phase(fc, card, rng, make_engine):
    """An ElasticResolverGroup whose engine_factory builds supervised
    tiered card engines (`make_engine()`), the active slot warmed and one
    spare prewarmed, in the port's simulator (buggify off). Skewed traffic
    (64 hot keys) runs until the ReshardController plans a split of the
    hot span, which it executes (pre-copy, freeze, delta, flip, unfreeze);
    more traffic over both shards (fast and two-phase batches); then the
    controller merges the two spans back (a merge plan given to execute():
    the planner merges only a pair under reshard_merge_share, which two
    shards never are) onto a recipient built inline, and more traffic.
    Each op runs while a concurrent task serves two more batches (the
    pre-copy sees new writes, the frozen delta replays them, and batches
    touching the moving range wait at the gate through the blackout).
    Every verdict equals one serial oracle's over the same stream, and
    each slot's journal replays clean (parity_check). Every supervisor
    the factory built (active slots, the spare, the inline recipient)
    ends HEALTHY with 0 dispatch faults, 0 failovers and 0 oracle
    batches, and the fixpoint launched on the card with no plain
    fixpoint on a CUDA tensor: no batch was served by the host oracle.
    Before each op, batch by batch, a donor's run_slice since a watermark
    taken just before the batch, after coalesce, equals its shadow_slice
    since the same point (or returns None / resync when a merge fell
    in the window, printed); each op needs at least one equal comparison
    of a non-empty slice. Every run_slice the controller makes is logged
    with the source the round used. Prints each op's blackout beside
    reshard_blackout_budget_ms, the batch counts, the launches per slot and
    the device memory."""
    import torch

    from foundationdb_tpu_torch.core import buggify
    from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
    from foundationdb_tpu_torch.fault import (FaultInjectingEngine, FaultRates, ResilienceConfig,
                                              ResilientEngine, handoff)
    from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine
    from foundationdb_tpu_torch.server import reshard
    from foundationdb_tpu_torch.sim.loop import set_scheduler
    from foundationdb_tpu_torch.sim.simulator import Simulator

    cuda = torch.cuda.is_available()
    budget = float(SERVER_KNOBS.reshard_blackout_budget_ms)
    launches, stacks, mem = {}, [], {"allocated_max": 0, "reserved_max": 0}

    def note_memory():
        if cuda:
            mem["allocated_max"] = max(mem["allocated_max"], torch.cuda.memory_allocated(),
                                       torch.cuda.max_memory_allocated())
            mem["reserved_max"] = max(mem["reserved_max"], torch.cuda.memory_reserved())

    def factory():
        inner = make_engine()
        sid = len(launches)
        launches[sid] = 0
        resolve = inner.resolve

        def counted(*a, **k):
            n0 = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
            try:
                return resolve(*a, **k)
            finally:
                launches[sid] += fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches - n0

        inner.resolve = counted
        inj = FaultInjectingEngine(inner, rates=FaultRates(exception=0, hang=0, slow=0,
                                                           outage=0, flip=0))
        stacks.append(ResilientEngine(inj, ResilienceConfig(probe_rate=0.0, **SUPERVISOR),
                                      record_journal=True))
        return inner, inj, stacks[-1]

    run_slice, rounds = handoff.run_slice, []

    def logged_run_slice(engine, begin, end, since_runs=None, since_epoch=None):
        got = run_slice(engine, begin, end, since_runs=since_runs, since_epoch=since_epoch)
        rounds.append("shadow (run_slice None)" if got is None
                      else "shadow (resync)" if got["resync"]
                      else f"runs ({len(got['entries'])} entries)")
        return got

    sim = Simulator(SEED + 14)
    buggify.disable()
    fc.FIXPOINT.reset_counts()
    t0 = time.perf_counter()
    group = reshard.ElasticResolverGroup(factory)
    group.warmup()
    group.prewarm_spares(1)
    warm_s = time.perf_counter() - t0
    note_memory()
    # the controller's clock is the wall clock: a blackout is the host and
    # card time from freeze to cutover (in virtual time it would read 0)
    ctl = reshard.ReshardController(group, now_fn=time.perf_counter, min_heat_batches=8)
    oracle = OracleConflictEngine()
    start = 10_000
    phases = []
    for n in RESHARD_BATCHES:
        phases.append(reshard_traffic(rng, n, start))
        start = phases[-1][-1][1]
    res = {"mismatches": 0, "batches": 0, "slice_checks": []}

    async def serve(part):
        for txns, v, old in part:
            got = [int(x) for x in await group.resolve(txns, v, old)]
            res["mismatches"] += got != [int(x) for x in oracle.resolve(txns, v, old)]
            res["batches"] += 1
            note_memory()

    async def slice_check(sids, begin, end, part):
        """For each batch of `part`: take each donor's run watermark and
        shadow version, serve the batch, then hold its run_slice since the
        watermark against its shadow_slice since the version, both
        coalesced. A merge in the window makes run_slice resync; at least
        one comparison must be equal and non-empty."""
        equal = 0
        for batch in part:
            marks = {sid: (handoff.run_watermarks(group.slots[sid].engine),
                           handoff.last_shadow_version(group.slots[sid].engine))
                     for sid in sids}
            await serve([batch])
            for sid, (wm, mv) in marks.items():
                eng = group.slots[sid].engine
                got = (None if wm is None
                       else run_slice(eng, begin, end, since_runs=wm[0], since_epoch=wm[1]))
                if got is None or got["resync"]:
                    res["slice_checks"].append((sid, "none" if got is None else "resync"))
                    continue
                runs = handoff.coalesce([(v, w) for v, w in got["entries"] if v > mv],
                                        begin, end)
                shadow = handoff.coalesce(handoff.shadow_slice(eng, begin, end, min_version=mv),
                                          begin, end)
                check(runs == shadow, f"reshard phase: slot {sid}'s run_slice differs from its "
                      f"shadow_slice after coalesce ({len(runs)} against {len(shadow)} entries)")
                res["slice_checks"].append((sid, f"equal ({len(runs)} entries)"))
                equal += len(runs) > 0
        check(equal > 0, f"reshard phase: no run_slice over [{begin}, {end}) came back equal "
              f"and non-empty ({res['slice_checks']})")

    async def reshard_under_load(plan, part, key):
        """Execute `plan` while a concurrent task serves `part`: donors take
        writes during the pre-copy, and batches touching the frozen range
        wait at the gate through the blackout."""
        rounds.clear()
        handoff.run_slice = logged_run_slice
        load = sim.sched.spawn(serve(part))
        try:
            op = await ctl.execute(plan)
        finally:
            handoff.run_slice = run_slice
        await load
        check(op is not None and op.state == "done", f"reshard phase: {plan['kind']} {op}")
        res[key] = list(rounds)

    async def go():
        p1, p2, p3 = phases
        await serve(p1[:-6])
        plan = ctl.plan()
        check(plan is not None and plan["kind"] == "split", f"reshard phase: plan {plan}")
        await slice_check([group.active_sids()[0]], plan["key"], None, p1[-6:-2])
        plan = ctl.plan()
        check(plan is not None and plan["kind"] == "split", f"reshard phase: plan {plan}")
        await reshard_under_load(plan, p1[-2:], "split_rounds")
        await serve(p2[:-6])
        await slice_check(group.active_sids(), b"", None, p2[-6:-2])
        await reshard_under_load({"kind": "merge", "span": 0}, p2[-2:], "merge_rounds")
        await serve(p3)

    t0 = time.perf_counter()
    try:
        sim.sched.run_until(sim.sched.spawn(go()), until=1e9)
    finally:
        set_scheduler(None)
        handoff.run_slice = run_slice
    serve_s = time.perf_counter() - t0
    checked, parity_mismatches = group.parity_check()
    check(res["mismatches"] == 0 and parity_mismatches == 0 and checked > 0,
          f"reshard phase: {res['mismatches']} batches off the serial oracle, "
          f"{parity_mismatches} of {checked} journal entries off the replay")
    check(ctl.executed == 2 and ctl.stalled == 0, f"reshard phase: {ctl.snapshot()['ops']}")
    stats = dict(group.extra_stats)
    check(stats["fast_batches"] > 0 and stats["two_phase_batches"] > 0,
          f"reshard phase: batch paths {stats}")
    health = [{k: v for k, v in st.health_stats().items() if k != "device"} for st in stacks]
    brief = [(h["state"], h["batches"], h["dispatch_faults"], h["oracle_batches"]) for h in health]
    check(len(stacks) >= 3 and all(
        h["state"] == "healthy" and h["dispatch_faults"] == 0 and h["failovers"] == 0
        and h["oracle_batches"] == 0 and h["rewarm_failures"] == 0 for h in health),
        f"reshard phase: a supervisor left the card ({health})")
    check(sum(launches.values()) > 0 and all(launches.values())
          and fc.FIXPOINT.plain_cuda_calls == 0,
          f"reshard phase: launches per slot {launches}, {fc.FIXPOINT.plain_cuda_calls} plain "
          "fixpoints on CUDA tensors")
    ops = [op.as_dict() for op in ctl.ops]
    out = {"ops": ops, "batches": res["batches"], "mismatches": res["mismatches"],
           "parity_checked": checked, "group": stats, "launches_by_slot": dict(launches),
           "launches": sum(launches.values()), "slice_checks": res["slice_checks"],
           "split_rounds": res["split_rounds"], "merge_rounds": res["merge_rounds"],
           "memory": mem, "warm_s": warm_s, "serve_s": serve_s, "budget_ms": budget,
           "windows": ctl.windows, "supervisors": health}
    for op in ops:
        print(f"reshard phase, {op['kind']} [{card}]: [{op['begin']}, {op['end'] or '+inf'}) "
              f"from slots {op['donor_sids']} to slot {op['recipient_sid']} "
              f"({'prewarmed' if op['prewarmed'] else 'built inline'}), epoch {op['epoch']} at "
              f"version {op['flip_version']}; {op['precopied']} batches pre-copied, "
              f"{op['delta']} in the frozen delta; blackout {op['blackout_ms']:.3f} ms "
              f"(wall, freeze to cutover) against the {budget:.0f} ms budget", flush=True)
    print(f"reshard phase [{card}]: {res['batches']} batches equal the serial oracle, "
          f"{checked} journal entries replay clean; {stats}; launches per slot {launches}; "
          f"supervisors (state, batches, dispatch faults, oracle batches) {brief}; "
          f"run_slice checks {res['slice_checks']}; split rounds {res['split_rounds']}, merge "
          f"rounds {res['merge_rounds']}; device memory allocated max "
          f"{mem['allocated_max']} B, reserved max {mem['reserved_max']} B; warm "
          f"{warm_s:.1f} s, served in {serve_s:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# the static simulated cluster with card resolvers
# ---------------------------------------------------------------------------

#: the specs the cluster phase runs with card resolvers, each at every seed
CLUSTER_SPECS = ("CycleTestCUDA", "CycleTest", "Serializability", "ConflictRangeCheck",
                 "RandomReadWrite", "AtomicOps")
CLUSTER_SEEDS = (1, 2)
#: the latency harness's points (the JAX package's bench.py latency curve,
#: bench.py:441-520): 6,000 txns each (a depth cut that makes room for the
#: real phase), depth 1 at bucket 512 at 0.85 of the serial
#: capacity, depth 2 at these (bucket, share of T / device_ms)
HARNESS_TXNS = 6_000
HARNESS_SERIAL = (512, 0.85)
HARNESS_PIPELINED = ((1024, 0.97), (1024, 1.0), (2048, 0.97), (2048, 1.0))


def clean_port_world():
    """Reset the port's process-global simulation state: the current
    scheduler, buggify, the journal, the program cache, the durability
    oracle, the fault registry, the telemetry hub and spans. A run and its
    oracle twin start from the same state."""
    from foundationdb_tpu_torch import fault
    from foundationdb_tpu_torch.core import blackbox, buggify, progcache, telemetry, trace
    from foundationdb_tpu_torch.sim import loop, validation

    loop.set_scheduler(None)
    buggify.disable()
    blackbox.uninstall()
    progcache.uninstall()
    validation.disable()
    fault._registry.clear()
    fault._recording = False
    telemetry.reset()
    trace.g_spans.enabled = False
    trace.g_spans.clear()
    trace.g_trace.clear()


def oracle_spec(name, seed):
    """A spec's oracle twin (run in a worker process): the spec with every
    resolver on OracleConflictEngine -> its SpecResult as a tuple."""
    import dataclasses

    from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine
    from foundationdb_tpu_torch.testing.specs import SPECS
    from foundationdb_tpu_torch.testing.workload import run_spec

    clean_port_world()
    spec = SPECS[name]()
    spec.cluster.engine_factory = OracleConflictEngine
    return dataclasses.astuple(run_spec(spec, seed))


def oracle_point(kw):
    """A harness point's oracle twin (run in a worker process): its
    as_dict() with the harness's default engine, the oracle."""
    from foundationdb_tpu_torch.pipeline.latency_harness import run_latency_under_load

    clean_port_world()
    return run_latency_under_load(**kw).as_dict()


def recording_factory(make, built):
    """A factory of engines from `make()`, each appended to `built` as a
    record {"engine", "batches"}: its resolve() (an instance attribute)
    records (version, new_oldest, transactions, verdicts) per call."""

    def factory():
        eng = make()
        rec = {"engine": eng, "batches": []}
        resolve = eng.resolve

        def recording(txns, now, new_oldest):
            verdicts = resolve(txns, now, new_oldest)
            rec["batches"].append((now, new_oldest, list(txns), [int(v) for v in verdicts]))
            return verdicts

        eng.resolve = recording
        built.append(rec)
        return eng

    return factory


def record_engine(eng):
    """The record {"engine", "calls", "resolving"} of `eng`, whose resolve()
    and clear() (instance attributes) from now on record (version,
    new_oldest, transactions, verdicts) and ("clear", version) in call
    order, for call_mismatches; "resolving" is true inside a resolve()."""
    rec = {"engine": eng, "calls": [], "resolving": False}
    resolve, clear = eng.resolve, eng.clear

    def recording(txns, now, new_oldest):
        rec["resolving"] = True
        try:
            verdicts = resolve(txns, now, new_oldest)
        finally:
            rec["resolving"] = False
        rec["calls"].append((now, new_oldest, list(txns), [int(v) for v in verdicts]))
        return verdicts

    def recording_clear(version):
        rec["calls"].append(("clear", version))
        return clear(version)

    eng.resolve, eng.clear = recording, recording_clear
    return rec


def recording_engines(make, built):
    """A factory of engines from `make()`, each appended to `built` as its
    record_engine record."""

    def factory():
        eng = make()
        built.append(record_engine(eng))
        return eng

    return factory


def call_mismatches(calls):
    """Calls of a recorded sequence whose verdicts differ from a fresh
    oracle's given the same sequence of resolve() calls, each (version,
    new_oldest, transactions, verdicts), and clear() calls, each
    ("clear", version)."""
    from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine

    oracle, bad = OracleConflictEngine(), 0
    for call in calls:
        if call[0] == "clear":
            oracle.clear(call[1])
            continue
        now, oldest, txns, verdicts = call
        bad += [int(v) for v in oracle.resolve(txns, now, oldest)] != list(verdicts)
    return bad


def harness_points(device_ms_by_bucket, pack_ms_per_txn, budget):
    """The harness points' arguments, bench.py's formulas: the serial point
    at 0.85 of 512 / (device + pack + 0.25 ms), the depth-2 points at their
    share of the device-paced capacity T / max(0.2, device_ms). Returns
    {label: run_latency_under_load arguments}."""
    dm = device_ms_by_bucket
    common = dict(pack_ms_per_txn=pack_ms_per_txn, n_txns=HARNESS_TXNS,
                  device_ms_by_bucket=dm, budget_ms=budget)
    T, util = HARNESS_SERIAL
    serial_cycle_ms = dm[T] + pack_ms_per_txn * T + 0.25
    points = {f"depth1_{T}_{util}": dict(common, depth=1, batch_txns=T, device_ms=dm[T],
                                         offered_txns_per_sec=util * T / (serial_cycle_ms / 1e3))}
    for T, util in HARNESS_PIPELINED:
        points[f"depth2_{T}_{util}"] = dict(common, depth=2, batch_txns=T, device_ms=dm[T],
                                            offered_txns_per_sec=util * T / (max(0.2, dm[T]) / 1e3))
    return points


def cluster_phase(fc, he, card, engine_cfg, device_ms_by_bucket, pack_ms_per_txn):
    """The port's static simulated cluster (server/cluster.py: master,
    proxy, tlog, storage servers, ratekeeper, clients) with resolvers on
    the card, in two parts.

    Specs: run_spec on each of CLUSTER_SPECS at each of CLUSTER_SEEDS with
    every resolver a TorchConflictEngine on the card at the specs'
    KernelConfig (make_engine_factory()); each run ends ok and equals its
    oracle twin (every resolver on OracleConflictEngine) in ok, metrics,
    seed and virtual time; every card engine's recorded (version,
    new_oldest, transactions, verdicts) replays through a fresh oracle
    with 0 mismatches.

    Harness: run_latency_under_load with a TorchConflictEngine at
    `engine_cfg` with the ladder and scans (sampling off) in the resolver,
    on the harness's own traffic (2 point reads and 2 point writes over
    its 8192-key pool), fed the card's figures: `device_ms_by_bucket` (the
    columnar phase's one-chunk replay ms per bucket) and
    `pack_ms_per_txn`. The points of harness_points(), then the fastest
    depth-2 point within resolver_p99_budget_ms (else the one with the
    lowest p99) once more with spans on, for the attribution. Each
    point's as_dict() equals its oracle twin's.

    The card runs are timed here. The phase returns its oracle twins as
    jobs for run_twins, which main calls after the last card run of the
    script, and finish(twins), which holds the card runs to them. Each spec and each point is a path: the fixpoint counts are zeroed just
    before it and read just after, and each path must launch the kernel
    with no plain fixpoint on a CUDA tensor; every engine built is on the
    card."""
    import dataclasses

    from foundationdb_tpu_torch.pipeline.latency_harness import (p99_budget_ms,
                                                                  run_latency_under_load)
    from foundationdb_tpu_torch.testing.specs import SPECS, make_engine_factory
    from foundationdb_tpu_torch.testing.workload import run_spec

    budget = p99_budget_ms()
    launches, built_all = {}, []
    spec_runs = {}
    for name in CLUSTER_SPECS:
        fc.FIXPOINT.reset_counts()
        for seed in CLUSTER_SEEDS:
            clean_port_world()
            built = []
            spec = SPECS[name]()
            spec.cluster.engine_factory = recording_factory(make_engine_factory(), built)
            t0 = time.perf_counter()
            res = run_spec(spec, seed)
            wall = time.perf_counter() - t0
            check(res.ok, f"cluster phase: spec {name} seed {seed} failed on the card: "
                  f"{res.metrics}")
            spec_runs[(name, seed)] = {
                "result": dataclasses.astuple(res), "wall_s": wall, "engines": len(built),
                "batches": sum(len(r["batches"]) for r in built),
                "txns": sum(len(t) for r in built for _, _, t, _ in r["batches"]),
                "captures": sum(r["engine"].perf.captures for r in built),
                "capture_s": sum(sum(r["engine"].perf_ledger.compile_ms.values())
                                 for r in built) / 1e3,
                "replay_mismatches": sum(call_mismatches(r["batches"]) for r in built)}
            built_all += built
        launches[f"cluster_spec_{name}"] = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
        check(launches[f"cluster_spec_{name}"] > 0 and fc.FIXPOINT.plain_cuda_calls == 0,
              f"cluster phase: spec {name} made {launches[f'cluster_spec_{name}']} fixpoint "
              f"launches, {fc.FIXPOINT.plain_cuda_calls} plain fixpoints on CUDA tensors")

    def engine():
        return he.TorchConflictEngine(engine_cfg, ladder=LADDER, scan_sizes=SCANS,
                                      device_time_sample_rate=0.0)

    def card_point(label, kw):
        clean_port_world()
        built = []
        fc.FIXPOINT.reset_counts()
        t0 = time.perf_counter()
        d = run_latency_under_load(engine_factory=recording_factory(engine, built),
                                   **kw).as_dict()
        wall = time.perf_counter() - t0
        launches[f"cluster_harness_{label}"] = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
        check(launches[f"cluster_harness_{label}"] > 0 and fc.FIXPOINT.plain_cuda_calls == 0,
              f"cluster phase: harness point {label} made "
              f"{launches[f'cluster_harness_{label}']} fixpoint launches, "
              f"{fc.FIXPOINT.plain_cuda_calls} plain fixpoints on CUDA tensors")
        built_all.extend(built)
        return {"args": kw, "result": d, "wall_s": wall,
                "wall_txn_per_s": HARNESS_TXNS / wall,
                "capture_s": sum(sum(r["engine"].perf_ledger.compile_ms.values())
                                 for r in built) / 1e3,
                "captures": sum(r["engine"].perf.captures for r in built),
                "batches": sum(len(r["batches"]) for r in built),
                "launches": launches[f"cluster_harness_{label}"]}

    points = {}
    for label, kw in harness_points(device_ms_by_bucket, pack_ms_per_txn, budget).items():
        points[label] = card_point(label, kw)
    pipelined = {k: p for k, p in points.items() if p["args"]["depth"] == 2}
    in_budget = {k: p for k, p in pipelined.items()
                 if p["result"]["errors"] == 0 and p["result"]["p99_ms"] <= budget}
    if in_budget:
        best = max(in_budget, key=lambda k: in_budget[k]["result"]["sustained_txns_per_sec"])
    else:
        best = min(pipelined, key=lambda k: pipelined[k]["result"]["p99_ms"])
    points["spans"] = card_point("spans", dict(points[best]["args"], collect_spans=True))
    points["spans"]["of"] = best
    points["spans"]["in_budget"] = bool(in_budget)
    check(points["spans"]["result"].get("attribution") is not None,
          "cluster phase: the spans point attributed no commit")

    engines_off_card = [type(r["engine"]).__name__ for r in built_all
                        if r["engine"].state["hkeys"].device.type != "cuda"]
    check(not engines_off_card, f"cluster phase: engines off the card: {engines_off_card}")

    jobs = {("cluster_spec", *key): (oracle_spec, *key) for key in spec_runs}
    jobs.update({("cluster_point", label): (oracle_point, p["args"])
                 for label, p in points.items()})

    def finish(all_twins):
        twins_spec = {key: all_twins[("cluster_spec", *key)] for key in spec_runs}
        twins_point = {label: all_twins[("cluster_point", label)] for label in points}
        for (name, seed), run in spec_runs.items():
            check(run["result"] == twins_spec[(name, seed)],
                  f"cluster phase: spec {name} seed {seed} on the card {run['result']} differs from "
                  f"its oracle twin {twins_spec[(name, seed)]}")
            check(run["replay_mismatches"] == 0,
                  f"cluster phase: spec {name} seed {seed}: {run['replay_mismatches']} recorded "
                  "batches differ from the oracle replay")
            ok, metrics, _, vt = run["result"]
            print(f"cluster spec {name} seed {seed} [{card}]: ok, equal to its oracle twin "
                  f"(virtual time {vt:.6f} s, {metrics}); {run['engines']} card resolvers served "
                  f"{run['batches']} batches / {run['txns']} txns, 0 replay mismatches; "
                  f"{run['captures']} graphs captured in {run['capture_s']:.2f} s; wall "
                  f"{run['wall_s']:.2f} s", flush=True)
        for label, p in points.items():
            check(p["result"] == twins_point[label],
                  f"cluster phase: harness point {label} on the card {p['result']} differs from its "
                  f"oracle twin {twins_point[label]}")
            r = p["result"]
            print(f"cluster harness {label} [{card}]: depth {r['depth']}, bucket {r['batch_txns']}, "
                  f"offered {r['offered_txns_per_sec']:.1f} txn/s: sustained "
                  f"{r['sustained_txns_per_sec']:.1f} txn/s, committed "
                  f"{r['sustained_committed_per_sec']:.1f} txn/s; virtual p50 {r['p50_ms']:.3f} ms "
                  f"p99 {r['p99_ms']:.3f} ms against the {budget} ms budget; {r['committed']} "
                  f"committed / {r['conflicted']} conflicted / {r['errors']} errors, mean fill "
                  f"{r['mean_batch_fill']}; wall {p['wall_s']:.2f} s ({p['wall_txn_per_s']:.0f} "
                  f"txn/s, {p['capture_s']:.2f} s of it capturing {p['captures']} graphs); "
                  f"{p['launches']} fixpoint launches; equal to its oracle twin", flush=True)
        att = points["spans"]["result"]["attribution"]
        print(f"  attribution [{card}] of {points['spans']['of']}"
              f"{'' if points['spans']['in_budget'] else ' (no depth-2 point in budget)'}: "
              f"{att['n_attributed']} commits, p50 {att['p50']['segments_ms']}, "
              f"p99 {att['p99']['segments_ms']}", flush=True)
        return {"specs": {f"{n}_{s}": r for (n, s), r in spec_runs.items()}, "points": points,
                "budget_ms": budget, "device_ms_by_bucket": device_ms_by_bucket,
                "pack_ms_per_txn": pack_ms_per_txn, "launches": launches}

    return jobs, finish


# ---------------------------------------------------------------------------
# dynamic cluster phase: coordinators, leader election, the cluster
# controller, workers, the master's epoch recovery, data distribution;
# every resolver recruited in every generation a card engine
# ---------------------------------------------------------------------------

#: the seeds each dynamic spec runs at with card resolvers (every dynamic
#: spec at seed 1; BackupCorrectness again at seed 2; the other seed-2
#: runs are cut to make room for the real phase)
DYNAMIC_SEEDS = {"BackupCorrectness": (1, 2)}
#: testing/specs.py's _nemesis_engine_factory supervisor
NEMESIS_SUPERVISOR = dict(dispatch_timeout=0.3, retry_budget=1, retry_backoff=0.05,
                          probe_rate=0.1, probation_batches=2, failover_min_batches=2)
#: history rows for the specs whose traffic outgrows the specs' KernelConfig
#: (capacity 1024): DataDistributionAttrition's bulk load writes 300 keys
#: inside one MVCC window, which overflows 1024 boundary rows
#: (conflict_capacity_exceeded) on the card as on the JAX package's engine
DYNAMIC_CAPACITY = {"DataDistributionAttrition": 4096}
#: the recovery-under-load run: the cluster's shape, its closed-loop
#: clients, the committed transactions it runs to, and its kills (the
#: share of RECOVERY_TXNS committed, the token the victim worker hosts).
#: The simulated cluster's durable storage applies ~100-130 txn/s of
#: virtual time; at 128 clients a transaction's two serial reads wait out
#: a 1-2 s storage lag and its commit falls past the 5 s MVCC window, so
#: the run stalls in transaction_too_old retries: 64 clients keep it busy
#: without that
RECOVERY_CLUSTER = dict(n_workers=6, n_tlogs=2, n_resolvers=2, n_proxies=1, n_storage=2)
RECOVERY_CLIENTS = 64
#: (a depth cut that makes room for the real phase, in the recovery run
#: and the backup run alike)
RECOVERY_TXNS = 1_000
RECOVERY_KILLS = ((0.30, "resolver.resolve"), (0.65, "proxy.commit"))
RECOVERY_SEED = SEED + 10
RECOVERY_UNTIL = 600.0
#: a supervisor's health counters, held equal between a card run and its
#: oracle twin engine by engine
HEALTH_KEYS = ("state", "batches", "dispatch_faults", "retries", "failovers", "swap_backs",
               "rewarm_failures", "oracle_batches", "probes", "probe_mismatches")


def supervised_card_factory(make, built, nemesis=False):
    """A dynamic cluster's engine factory over card engines from `make()`.

    Each call records the card engine's every resolve() and clear() (its
    instance attributes) in a record {"engine", "calls", "stack",
    "faults"} appended to `built`, and returns it supervised as the
    worker's recruitment would (fault.maybe_wrap's ResilientEngine(engine),
    built here so its faults can be sorted), or with `nemesis` as
    testing/specs.py's _nemesis_engine_factory does:
    ResilientEngine(FaultInjectingEngine(engine), its ResilienceConfig).
    Every supervisor keeps its journal (record_journal=True: the verdicts
    it emitted per batch, whoever served them), which draws nothing and
    changes no decision."""
    from foundationdb_tpu_torch.fault import (FaultInjectingEngine, ResilienceConfig,
                                              ResilientEngine)

    recorded = []
    record = recording_engines(make, recorded)

    def factory():
        eng = record()
        rec = recorded[-1]
        if nemesis:
            stack = ResilientEngine(FaultInjectingEngine(eng),
                                    ResilienceConfig(**NEMESIS_SUPERVISOR), record_journal=True)
        else:
            stack = ResilientEngine(eng, record_journal=True)
        rec["stack"] = stack
        sort_faults(stack, rec)
        built.append(rec)
        return stack

    return factory


def registered_health():
    """The health counters of every supervisor the run built, in the order
    it built them (fault.registered_engines())."""
    from foundationdb_tpu_torch.fault import registered_engines

    return [{k: e.health_stats().get(k, 0) for k in HEALTH_KEYS} for e in registered_engines()]


def engine_summary(rec):
    """One recorded card engine after its run: where its tensors live, its
    resolves and clears, captures and capture seconds, its supervisor's
    health and dispatch faults by cause; the replay mismatches of the
    card's own calls and of the supervisor's journal (the verdicts it
    emitted, one entry per batch)."""
    eng, stack = rec["engine"], rec["stack"]
    st = stack.health_stats()
    resolves = [c for c in rec["calls"] if c[0] != "clear"]
    journal = [(now, oldest, list(txns), verdicts)
               for now, txns, oldest, verdicts in stack.journal]
    return {"device": eng.state["hkeys"].device.type, "resolves": len(resolves),
            "clears": len(rec["calls"]) - len(resolves),
            "txns": sum(len(c[2]) for c in resolves),
            "largest_batch": max((len(c[2]) for c in resolves), default=0),
            "first_version": resolves[0][0] if resolves else None,
            "captures": eng.perf.captures,
            "capture_s": sum(eng.perf_ledger.compile_ms.values()) / 1e3,
            "health": {k: st.get(k, 0) for k in HEALTH_KEYS},
            "faults": dict(rec["faults"]), "other_errors": rec.get("other_errors", []),
            "mismatches": call_mismatches(rec["calls"]),
            "journal_batches": len(journal), "journal_mismatches": call_mismatches(journal)}


def recoveries():
    """The last recovery count a master reported to the cluster controller
    (the MasterRecoveredToCC trace events of the run)."""
    from foundationdb_tpu_torch.core.trace import g_trace

    return max((e["RecoveryCount"] for e in g_trace.find("MasterRecoveredToCC")), default=0)


def oracle_dynamic_spec(name, seed):
    """A dynamic spec's oracle twin (run in a worker process): the spec with
    its stock engine factory (the oracle; the injector over the oracle for
    DeviceNemesis) -> (its SpecResult as a tuple, the health counters of
    every supervisor it built)."""
    import dataclasses

    from foundationdb_tpu_torch.testing.specs import SPECS
    from foundationdb_tpu_torch.testing.workload import run_spec

    clean_port_world()
    res = dataclasses.astuple(run_spec(SPECS[name](), seed))
    return res, registered_health()


def dynamic_spec_run(fc, name, seed, make):
    """run_spec on one dynamic spec with every recruited resolver a card
    engine from `make()`, supervised as the worker or the nemesis factory
    would; the fixpoint counts zeroed just before it and read just after.
    Returns the run's result, recoveries, engines, captures, launches,
    wall seconds and each engine's summary."""
    import dataclasses

    from foundationdb_tpu_torch.testing.specs import SPECS
    from foundationdb_tpu_torch.testing.workload import run_spec

    clean_port_world()
    built = []
    spec = SPECS[name]()
    spec.dynamic.engine_factory = supervised_card_factory(make, built,
                                                          nemesis=name == "DeviceNemesis")
    fc.FIXPOINT.reset_counts()
    t0 = time.perf_counter()
    res = run_spec(spec, seed)
    wall = time.perf_counter() - t0
    launches = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
    plain = fc.FIXPOINT.plain_cuda_calls
    run = {"result": dataclasses.astuple(res), "recoveries": recoveries(), "wall_s": wall,
           "launches": launches, "plain_cuda_calls": plain,
           "engines": [engine_summary(r) for r in built]}
    built.clear()
    clean_port_world()   # drops the fault registry's engines of every generation
    return run


def check_engines(where, engines, twin_health):
    """The card engines of one run against the rules: each on the card,
    its own calls (clears included) and its supervisor's journal equal to
    a fresh oracle's replay (the journal holds every batch the supervisor
    answered: all it took but one cancelled by its role's death), no
    dispatch fault from
    the card, and every supervisor's health counters (batches, faults,
    retries, failovers, swap-backs, rewarm failures, oracle batches,
    probes) equal to the oracle twin's supervisor built at the same point
    of the run: a failover or an oracle batch is then one the oracle's run
    took too, from a buggify site or the injector, never the card's."""
    check(len(engines) == len(twin_health),
          f"{where}: {len(engines)} card engines, {len(twin_health)} in the oracle twin")
    for i, (e, want) in enumerate(zip(engines, twin_health)):
        at = f"{where} engine {i}"
        check(e["device"] == "cuda", f"{at} is on {e['device']}")
        check(e["mismatches"] == 0, f"{at}: {e['mismatches']} card calls differ from the oracle "
              "replay")
        check(0 <= e["health"]["batches"] - e["journal_batches"] <= 1
              and e["journal_mismatches"] == 0,
              f"{at}: the supervisor's journal holds {e['journal_batches']} of "
              f"{e['health']['batches']} batches, {e['journal_mismatches']} differ from the "
              "oracle replay")
        check(e["faults"]["other"] == 0, f"{at}: dispatch faults from the card: "
              f"{e['other_errors']}")
        check(e["health"] == want, f"{at}: supervisor health {e['health']} differs from the "
              f"oracle twin's {want}")


def check_dynamic_spec(name, seed, run, twin):
    """A card spec run against its oracle twin (its SpecResult, the health
    of its supervisors) and the phase's rules: ok, equal to the twin in ok,
    metrics, seed and virtual time (a card engine keeps keyspace heat, so
    DeviceNemesis's flight records each carry a heat snapshot the oracle's
    lack: its flight_heat_records must equal its flight_records and is the
    one metric the twin lacks), launches and no plain fixpoint on the
    card, and check_engines."""
    (ok, metrics, rseed, vt), twin_health = run["result"], twin[1]
    check(ok, f"dynamic phase: spec {name} seed {seed} failed on the card: {metrics}")
    if name == "DeviceNemesis":
        metrics = dict(metrics)
        heat = metrics.pop("flight_heat_records", None)
        check(heat == metrics.get("flight_records"),
              f"dynamic phase: {name} seed {seed}: {heat} flight records with heat of "
              f"{metrics.get('flight_records')}")
    check((ok, metrics, rseed, vt) == tuple(twin[0]),
          f"dynamic phase: spec {name} seed {seed} on the card {run['result']} differs from its "
          f"oracle twin {twin[0]}")
    check(run["launches"] > 0 and run["plain_cuda_calls"] == 0,
          f"dynamic phase: spec {name} seed {seed} made {run['launches']} fixpoint launches, "
          f"{run['plain_cuda_calls']} plain fixpoints on CUDA tensors")
    check_engines(f"dynamic phase: spec {name} seed {seed}", run["engines"], twin_health)


def pool_key(i):
    """Key i of the recovery run's 8192-key pool: 16 bytes, the bench's."""
    return b"bench/%010d" % i


async def pool_client(db, cid, rng, state, note_commit):
    """A closed-loop client of the recovery and backup runs: until
    state["committed"] reaches RECOVERY_TXNS, transactions of 2 point
    reads and 2 point writes over the 8192-key pool (keys drawn from
    `rng`), each retried until it commits; note_commit(version) counts
    each commit."""
    from foundationdb_tpu_torch.core import error

    n = 0
    while state["committed"] < RECOVERY_TXNS:
        reads = [pool_key(rng.random_int(0, POOL_KEYS)) for _ in range(2)]
        writes = [pool_key(rng.random_int(0, POOL_KEYS)) for _ in range(2)]
        tr = db.create_transaction()
        while True:
            try:
                for k in reads:
                    await tr.get(k)
                for k in writes:
                    tr.set(k, b"%03d.%05d" % (cid, n))
                version = await tr.commit()
                break
            except error.FDBError as e:
                await tr.on_error(e)
        n += 1
        note_commit(version)


def recovery_run(factory=None):
    """build_dynamic_cluster at RECOVERY_CLUSTER, resolvers from `factory`
    (the oracle when None), under RECOVERY_CLIENTS closed-loop clients,
    each transaction 2 point reads and 2 point writes over the 8192-key
    pool (keys drawn from the simulator's rng), until RECOVERY_TXNS have
    committed; REBOOT-kills the worker hosting each of RECOVERY_KILLS's
    tokens once its share has committed (the first worker with a handler
    token starting with it, as tests/test_recovery.py finds it). A fresh
    client then reads the whole pool.

    Returns {"twin": (committed, the final rows, virtual time, durability
    violations), "health" (registered_health()), "kills", "recoveries",
    "load_virtual_s", "load_wall_s"}:
    each kill with its victim and the virtual and wall ms to the first
    commit of the new epoch (the first commit whose version is over
    RECOVERY_VERSION_JUMP / 2 past every version acknowledged before the
    kill: a new epoch's versions start a jump past the recovery version)."""
    from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine
    from foundationdb_tpu_torch.server.cluster import (DynamicClusterConfig,
                                                       build_dynamic_cluster)
    from foundationdb_tpu_torch.server.master import RECOVERY_VERSION_JUMP
    from foundationdb_tpu_torch.sim import validation
    from foundationdb_tpu_torch.sim.actors import all_of
    from foundationdb_tpu_torch.sim.simulator import KillType

    clean_port_world()
    c = build_dynamic_cluster(seed=RECOVERY_SEED, cfg=DynamicClusterConfig(
        **RECOVERY_CLUSTER, engine_factory=factory or OracleConflictEngine))
    sim = c.sim
    rng = sim.sched.rng
    state = {"committed": 0, "max_version": 0}
    kills = []
    pending = list(RECOVERY_KILLS)

    def worker_hosting(prefix):
        for p in c.worker_procs:
            if any(tok.startswith(prefix) for tok in p.handlers):
                return p
        return None

    def note_commit(version):
        state["committed"] += 1
        for k in kills:
            if "first_commit_virtual_ms" not in k and version > k["version"] + RECOVERY_VERSION_JUMP // 2:
                k["first_commit_virtual_ms"] = (sim.sched.time - k["virtual"]) * 1e3
                k["first_commit_wall_ms"] = (time.perf_counter() - k["wall"]) * 1e3
                k["first_commit_version"] = version
        state["max_version"] = max(state["max_version"], version)
        if pending and state["committed"] >= pending[0][0] * RECOVERY_TXNS:
            share, prefix = pending.pop(0)
            victim = worker_hosting(prefix)
            check(victim is not None, f"recovery run: no live worker hosts {prefix}")
            kills.append({"share": share, "token": prefix, "victim": victim.address,
                          "committed": state["committed"], "version": state["max_version"],
                          "virtual": sim.sched.time, "wall": time.perf_counter()})
            sim.kill_process(victim, KillType.REBOOT)

    async def load():
        t_v, t_w = sim.sched.time, time.perf_counter()
        await all_of([sim.sched.spawn(pool_client(c.new_client(), i, rng, state, note_commit),
                                      name=f"client{i}")
                      for i in range(RECOVERY_CLIENTS)])
        state["load_virtual_s"] = sim.sched.time - t_v
        state["load_wall_s"] = time.perf_counter() - t_w

        async def read_all(tr):
            return await tr.get_range(pool_key(0), pool_key(POOL_KEYS), limit=POOL_KEYS + 1)

        return await c.new_client().run(read_all)

    rows = sim.run_until(sim.sched.spawn(load(), name="recovery-load"), until=RECOVERY_UNTIL)
    twin = (state["committed"], rows, sim.sched.time, len(validation.violations))
    out = {"twin": twin, "health": registered_health(), "kills": kills,
           "recoveries": recoveries(),
           "load_virtual_s": state["load_virtual_s"], "load_wall_s": state["load_wall_s"]}
    clean_port_world()
    return out


def oracle_recovery_run():
    """The recovery run's oracle twin (run in a worker process): its result
    and the health counters of its supervisors."""
    out = recovery_run()
    return out["twin"], out["health"]


def generations(engines):
    """The recorded card engines grouped into generations (the engines of
    one generation resolve the same versions from the same first one): per
    generation its engines, batches, mean and largest batch and captures."""
    gens = {}
    for e in engines:
        gens.setdefault(e["first_version"], []).append(e)
    out = []
    for first, es in sorted(gens.items(), key=lambda kv: (kv[0] is None, kv[0] or 0)):
        n = sum(e["resolves"] for e in es)
        out.append({"first_version": first, "engines": len(es), "batches": n,
                    "mean_batch": sum(e["txns"] for e in es) / n if n else 0.0,
                    "largest_batch": max(e["largest_batch"] for e in es),
                    "captures": sum(e["captures"] for e in es),
                    "capture_s": sum(e["capture_s"] for e in es)})
    return out


def dynamic_cluster_phase(fc, he, ck, card, recovery_cfg):
    """The port's dynamic simulated cluster (server/cluster.py
    DynamicCluster: coordinators, leader election, the cluster controller,
    workers, the master's epoch recovery, data distribution and resolution
    balancing) with every resolver recruited in every generation a card
    engine, in two parts.

    Specs: run_spec on every dynamic spec at its DYNAMIC_SEEDS with
    spec.dynamic.engine_factory a recording factory over
    make_engine_factory()'s card engines (the specs' KernelConfig; the
    capacity of DYNAMIC_CAPACITY where it is named), supervised as
    recruitment would, or for DeviceNemesis as its nemesis factory does;
    check_dynamic_spec holds each run.

    Recovery under load: recovery_run with card resolvers at
    `recovery_cfg` (the bench's KernelConfig, ladder and scans) in every
    generation, two kills forcing two epoch recoveries that recruit fresh
    card engines: equal to its oracle twin (committed count, the final
    keyspace, virtual time), no durability violation, check_engines.
    Reports committed txn/s in virtual and wall time, batches
    and captures per generation, each kill's virtual and wall ms to the
    first commit of the new epoch and the peak device memory.

    Returns the oracle twins as jobs for run_twins (after the last card
    run of the script) and finish(twins), which holds the runs to them."""
    import dataclasses

    import torch

    from foundationdb_tpu_torch.testing.specs import SPECS, make_engine_factory

    spec_cfg = ck.KernelConfig(key_words=4, capacity=1024, max_reads=256, max_writes=256,
                               max_txns=64)
    names = [n for n, make in SPECS.items() if make().dynamic is not None]
    runs, launches = {}, {}
    for name in names:
        make = (make_engine_factory(cfg=dataclasses.replace(spec_cfg,
                                                            capacity=DYNAMIC_CAPACITY[name]))
                if name in DYNAMIC_CAPACITY else make_engine_factory())
        for seed in DYNAMIC_SEEDS.get(name, (1,)):
            run = dynamic_spec_run(fc, name, seed, make)
            runs[(name, seed)] = run
            launches[f"dynamic_spec_{name}_{seed}"] = run["launches"]

    built = []
    factory = supervised_card_factory(
        lambda: he.TorchConflictEngine(recovery_cfg, ladder=LADDER, scan_sizes=SCANS,
                                       device_time_sample_rate=0.0), built)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.FIXPOINT.reset_counts()
    rec = recovery_run(factory)
    launches["dynamic_recovery"] = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
    rec["plain_cuda_calls"] = fc.FIXPOINT.plain_cuda_calls
    torch.cuda.synchronize()
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    rec["engines"] = [engine_summary(r) for r in built]
    built.clear()
    rec["generations"] = generations(rec["engines"])
    check(launches["dynamic_recovery"] > 0 and rec["plain_cuda_calls"] == 0,
          f"dynamic phase: the recovery run made {launches['dynamic_recovery']} fixpoint "
          f"launches, {rec['plain_cuda_calls']} plain fixpoints on CUDA tensors")

    jobs = {("dynamic_recovery",): (oracle_recovery_run,)}
    jobs.update({("dynamic_spec", *key): (oracle_dynamic_spec, *key) for key in runs})

    def finish(all_twins):
        rec_twin = all_twins[("dynamic_recovery",)]
        twins = {key: all_twins[("dynamic_spec", *key)] for key in runs}
        for (name, seed), run in runs.items():
            check_dynamic_spec(name, seed, run, twins[(name, seed)])
            es = run["engines"]
            faults = {k: sum(e["faults"][k] for e in es) for k in ("injected", "watchdog",
                                                                    "buggify", "other")}
            ok, metrics, _, vt = run["result"]
            print(f"dynamic spec {name} seed {seed} [{card}]: ok, equal to its oracle twin "
                  f"(virtual time {vt:.6f} s, {metrics}); {run['recoveries']} recoveries; "
                  f"{len(es)} card engines recruited, {sum(e['captures'] for e in es)} graphs "
                  f"captured in {sum(e['capture_s'] for e in es):.2f} s; "
                  f"{sum(e['resolves'] for e in es)} card batches, 0 replay mismatches; "
                  f"dispatch faults by cause {faults}, failovers "
                  f"{sum(e['health']['failovers'] for e in es)}, oracle batches "
                  f"{sum(e['health']['oracle_batches'] for e in es)} (as its twin's); "
                  f"{run['launches']} fixpoint launches; "
                  f"wall {run['wall_s']:.2f} s", flush=True)

        committed, rows, vt, violations = rec["twin"]
        twin_result, twin_health = rec_twin
        check(rec["twin"] == tuple(twin_result),
              f"dynamic phase: the recovery run on the card (committed {committed}, "
              f"{len(rows)} rows, virtual time {vt}) differs from its oracle twin (committed "
              f"{twin_result[0]}, {len(twin_result[1])} rows, virtual time {twin_result[2]})")
        check(violations == 0, f"dynamic phase: the recovery run broke durability {violations} times")
        check(committed >= RECOVERY_TXNS and len(rows) > 0,
              f"dynamic phase: the recovery run committed {committed}, read {len(rows)} rows")
        check(len(rec["kills"]) == len(RECOVERY_KILLS)
              and all("first_commit_virtual_ms" in k for k in rec["kills"]),
              f"dynamic phase: the recovery run's kills {rec['kills']} did not all reach a new epoch")
        check(len(rec["generations"]) >= 1 + len(RECOVERY_KILLS),
              f"dynamic phase: the recovery run recruited {len(rec['generations'])} generations")
        check_engines("dynamic phase: recovery run", rec["engines"], twin_health)
        print(f"dynamic recovery run [{card}]: {committed} committed by {RECOVERY_CLIENTS} "
              f"closed-loop clients in {rec['load_virtual_s']:.6f} virtual s "
              f"({committed / rec['load_virtual_s']:.1f} txn/s) and {rec['load_wall_s']:.2f} wall s "
              f"({committed / rec['load_wall_s']:.1f} txn/s); {rec['recoveries']} recoveries; "
              f"equal to its oracle twin ({len(rows)} rows, virtual time {vt:.6f} s), 0 durability "
              f"violations, 0 replay mismatches; peak device memory "
              f"{rec['max_memory_allocated'] / 2**20:.1f} MiB; {launches['dynamic_recovery']} "
              f"fixpoint launches", flush=True)
        for k in rec["kills"]:
            print(f"  kill of {k['token']} at {k['committed']} committed [{card}]: first commit of "
                  f"the new epoch {k['first_commit_virtual_ms']:.3f} virtual ms and "
                  f"{k['first_commit_wall_ms']:.1f} wall ms later", flush=True)
        for g in rec["generations"]:
            print(f"  generation from version {g['first_version']} [{card}]: {g['engines']} card "
                  f"engines, {g['batches']} batches (mean {g['mean_batch']:.1f} txns, largest "
                  f"{g['largest_batch']}), {g['captures']} graphs captured in "
                  f"{g['capture_s']:.2f} s", flush=True)
        rec["twin"] = {"committed": committed, "rows": len(rows), "virtual_time": vt,
                       "violations": violations}
        return {"specs": {f"{n}_{s}": r for (n, s), r in runs.items()}, "recovery": rec,
                "launches": launches}

    return jobs, finish


# ---------------------------------------------------------------------------
# bindings, backup and DR: the stack tester through a static cluster, a
# full-width backup under load restored into a second cluster, and a DR
# switchover; every resolver in every cluster a card engine
# ---------------------------------------------------------------------------

#: the stack tester's streams (tests/test_stacktester.py's seeds)
STACK_SEEDS = (201, 202)
#: the full-width backup run: two clusters of RECOVERY_CLUSTER's shape in
#: one simulation under RECOVERY_CLIENTS closed-loop clients, at the
#: recovery run's seed; the backup starts once BACKUP_START commits have
#: landed, snapshots in BACKUP_CHUNKS chunks with BACKUP_WORKERS workers,
#: and finishes once the load reaches RECOVERY_TXNS commits; the load's
#: rate before the backup is read from commit BACKUP_WARM (past the first
#: recovery) to BACKUP_START. At seed SEED + 11 the same load stalls the
#: simulated storage in transaction_too_old retries (~174 virtual s to 500
#: commits) and the tag claim's commit answers commit_unknown_result, which
#: the agent's retry then refuses as its own claim (both packages; ROADMAP
#: standing notes)
BACKUP_SEED = RECOVERY_SEED
BACKUP_WARM = 100
BACKUP_START = 500
BACKUP_CHUNKS = 8
BACKUP_WORKERS = 3
BACKUP_UNTIL = 900.0
#: tests/test_dr.py's switchover scenario and seed
DR_SEED = 201


def stack_run(seed, factory=None):
    """stacktester.generate_stream(seed) through build_cluster(ClusterConfig(
    n_resolvers=2, n_storage=2)) with resolvers from `factory` (the oracle
    when None): (instructions, commits, aborts, the journal, the final
    keyspace, virtual time). A commit that raised counts as an abort; the
    final keyspace read is not counted."""
    from foundationdb_tpu_torch.bindings.stacktester import final_state, generate_stream, run_stream
    from foundationdb_tpu_torch.core import error
    from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine
    from foundationdb_tpu_torch.server.cluster import ClusterConfig, build_cluster

    clean_port_world()
    c = build_cluster(seed=seed, cfg=ClusterConfig(n_resolvers=2, n_storage=2,
                                                   engine_factory=factory or OracleConflictEngine))
    db = c.new_client()
    stream = generate_stream(seed)
    counts = {"commits": 0, "aborts": 0}
    make = db.create_transaction

    def counted():
        tr = make()
        commit = tr.commit

        async def counting():
            try:
                version = await commit()
            except error.FDBError:
                counts["aborts"] += 1
                raise
            counts["commits"] += 1
            return version

        tr.commit = counting
        return tr

    async def go():
        db.create_transaction = counted
        journal = await run_stream(db, stream)
        db.create_transaction = make
        return journal, await final_state(db)

    journal, rows = c.sim.run_until(c.sim.sched.spawn(go(), name="stack"), until=600.0)
    out = (len(stream), counts["commits"], counts["aborts"], journal, rows, c.sim.sched.time)
    clean_port_world()
    return out


def backup_run(factory=None):
    """Two dynamic clusters of RECOVERY_CLUSTER's shape in one simulation,
    resolvers from `factory` (the oracle when None), and a blob container.
    RECOVERY_CLIENTS closed-loop clients (2 point reads and 2 point writes
    over the 8192-key pool, as recovery_run) run until RECOVERY_TXNS have
    committed; a BackupAgent starts once BACKUP_START have, snapshots
    (BACKUP_CHUNKS chunks, BACKUP_WORKERS workers) and finishes when the
    load is done; the source is read at the backup's end version and the
    backup restored into the second cluster, which is read back.

    Returns {"twin": (committed, end_version, the restored rows, virtual
    time, durability violations), "source_rows", "vend", "health"
    (registered_health()), "times" (virtual and wall seconds of the load
    from commit BACKUP_WARM to the backup's start, of the load from the
    start to its end, the snapshot, the finish and the restore),
    "committed_at_start", "committed_during", "snapshot_version",
    "start_version", "snapshot_bytes", "log_bytes", "objects"}."""
    from foundationdb_tpu_torch.backup import BackupAgent, BlobContainer
    from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine
    from foundationdb_tpu_torch.server.cluster import (DynamicCluster, DynamicClusterConfig,
                                                       build_dynamic_cluster)
    from foundationdb_tpu_torch.sim import validation
    from foundationdb_tpu_torch.sim.actors import all_of
    from foundationdb_tpu_torch.sim.loop import Promise

    clean_port_world()
    cfg = DynamicClusterConfig(**RECOVERY_CLUSTER, engine_factory=factory or OracleConflictEngine)
    src = build_dynamic_cluster(seed=BACKUP_SEED, cfg=cfg)
    sim = src.sim
    dst = DynamicCluster(sim, cfg)
    container = BlobContainer(sim.new_process("blobstore"))
    rng = sim.sched.rng
    state = {"committed": 0}
    times = {}
    started = Promise()

    def mark(label, t_v, t_w):
        times[label] = {"virtual_s": sim.sched.time - t_v, "wall_s": time.perf_counter() - t_w}

    def note_commit(_version):
        state["committed"] += 1
        if state["committed"] == BACKUP_WARM:
            state["warm_mark"] = (sim.sched.time, time.perf_counter())
        if state["committed"] == BACKUP_START:
            started.send()

    async def read_all(db, version=None):
        tr = db.create_transaction()
        if version is not None:
            tr.read_version = version
        return await tr.get_range(b"", b"\xff", limit=POOL_KEYS + 1, snapshot=True)

    async def scenario():
        async def clients():
            await all_of([sim.sched.spawn(pool_client(src.new_client(), i, rng, state,
                                                      note_commit), name=f"client{i}")
                          for i in range(RECOVERY_CLIENTS)])

        load = sim.sched.spawn(clients(), name="load")
        await started.future
        state["committed_at_start"] = state["committed"]
        mark("load_before_backup", *state["warm_mark"])
        db = src.new_client()
        agent = BackupAgent(sim, db, container.proc.address)
        t_v, t_w = sim.sched.time, time.perf_counter()
        await agent.start_backup()
        s_v, s_w = sim.sched.time, time.perf_counter()
        await agent.snapshot(chunks=BACKUP_CHUNKS, workers=BACKUP_WORKERS)
        mark("snapshot", s_v, s_w)
        await load
        mark("load_during_backup", t_v, t_w)
        state["committed_during"] = state["committed"] - state["committed_at_start"]
        f_v, f_w = sim.sched.time, time.perf_counter()
        await agent.finish_backup()
        mark("finish", f_v, f_w)
        source = await read_all(db, agent.end_version)
        r_v, r_w = sim.sched.time, time.perf_counter()
        vend = await agent.restore(dst.new_client())
        mark("restore", r_v, r_w)
        return agent, vend, source, await read_all(dst.new_client())

    agent, vend, source, restored = sim.run_until(sim.sched.spawn(scenario(), name="backup"),
                                                  until=BACKUP_UNTIL)
    objects = container._objects
    out = {"twin": (state["committed"], agent.end_version, restored, sim.sched.time,
                    len(validation.violations)),
           "source_rows": source, "vend": vend, "health": registered_health(), "times": times,
           "committed_at_start": state["committed_at_start"],
           "committed_during": state["committed_during"],
           "snapshot_version": agent.snapshot_version, "start_version": agent.start_version,
           "snapshot_bytes": sum(len(v) for k, v in objects.items() if k.startswith("range/")),
           "log_bytes": sum(len(v) for k, v in objects.items() if k.startswith("log/")),
           "objects": len(objects)}
    clean_port_world()
    return out


def oracle_backup_run():
    """The backup run's oracle twin (run in a worker process): its twin
    tuple, source rows and the health counters of its supervisors."""
    out = backup_run()
    return out["twin"], out["source_rows"], out["health"]


def dr_run(factory=None):
    """tests/test_dr.py's switchover (seed DR_SEED): a source dynamic
    cluster at the default DynamicClusterConfig and a destination
    (n_workers=5, n_tlogs=2, n_resolvers=1, n_storage=2) in one
    simulation, resolvers from `factory` (the oracle when None) in both. A
    DRAgent syncs 25 rows in 4 chunks, tails 20 live writes with atomic
    adds, waits for the destination to catch up, and switches over while
    10 writers straddle the switchover.

    Returns {"twin": (committed straddlers, locked straddlers, the fence
    version, the source's rows, the destination's rows, the code a user
    commit to the locked source drew, virtual time), "health"}."""
    from foundationdb_tpu_torch.backup.dr import DRAgent
    from foundationdb_tpu_torch.core import error
    from foundationdb_tpu_torch.core.types import MutationType
    from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine
    from foundationdb_tpu_torch.server.cluster import (DynamicCluster, DynamicClusterConfig,
                                                       build_dynamic_cluster)
    from foundationdb_tpu_torch.sim.actors import all_of
    from foundationdb_tpu_torch.sim.loop import delay, spawn

    clean_port_world()
    make = factory or OracleConflictEngine
    ca = build_dynamic_cluster(seed=DR_SEED, cfg=DynamicClusterConfig(engine_factory=make))
    sim = ca.sim
    cb = DynamicCluster(sim, DynamicClusterConfig(n_workers=5, n_tlogs=2, n_resolvers=1,
                                                  n_storage=2, engine_factory=make))
    db_a, db_b = ca.new_client(), cb.new_client()
    locked_code = error.database_locked("").code

    async def rows_of(db):
        async def r(tr):
            return await tr.get_range(b"", b"\xff", limit=100_000, snapshot=True)
        return await db.run(r)

    async def scenario():
        async def seed_rows(tr):
            for i in range(25):
                tr.set(b"pre/%03d" % i, b"v%d" % i)
            tr.set(b"ctr", (0).to_bytes(8, "little"))
        await db_a.run(seed_rows)

        async def stray(tr):
            tr.set(b"stray/x", b"1")
        await db_b.run(stray)

        agent = DRAgent(sim, db_a, db_b)
        await agent.start(chunks=4)
        for i in range(20):
            async def w(tr, i=i):
                tr.set(b"live/%03d" % i, b"x%d" % i)
                tr.atomic_op(b"ctr", (1).to_bytes(8, "little"), MutationType.ADD_VALUE)
            await db_a.run(w)
            await delay(0.1)
        tr = db_a.create_transaction()
        await agent.wait_for(await tr.get_read_version(), timeout=60.0)

        committed, locked = [], []

        async def straddler(i):
            async def w(tr2):
                tr2.set(b"straddle/%03d" % i, b"s%d" % i)
            try:
                await db_a.run(w)
                committed.append(i)
            except error.FDBError as e:
                if e.code == locked_code:
                    locked.append(i)

        tasks = [spawn(straddler(i), name=f"straddle{i}") for i in range(10)]
        await delay(0.05)
        fence = await agent.switchover()
        await all_of(tasks)

        async def wa(tr2):
            tr2.set(b"after/a", b"1")
        try:
            await db_a.run(wa)
            after_a = None
        except error.FDBError as e:
            after_a = e.code

        async def wb(tr2):
            tr2.set(b"after/b", b"1")
        await db_b.run(wb)
        return committed, locked, fence, await rows_of(db_a), await rows_of(db_b), after_a

    out = sim.run_until(sim.sched.spawn(scenario(), name="dr"), until=600.0)
    res = {"twin": out + (sim.sched.time,), "health": registered_health()}
    clean_port_world()
    return res


def oracle_dr_run():
    """The DR run's oracle twin (run in a worker process)."""
    out = dr_run()
    return out["twin"], out["health"]


def check_dr(twin):
    """tests/test_dr.py's checks of a switchover: every row the source
    holds is on the destination, each straddler either committed and
    reached the destination or drew database_locked and did not, the
    destination's stray key was wiped, the atomic adds landed once each,
    and the locked source refused a user commit with database_locked."""
    from foundationdb_tpu_torch.core import error

    committed, locked, _fence, rows_a, rows_b, after_a, _vt = twin
    b_map = dict(rows_b)
    lost = [k for k, v in rows_a if b_map.get(k) != v]
    check(not lost, f"DR: {len(lost)} source rows lost across the switchover: {lost[:4]}")
    check(all(b_map.get(b"straddle/%03d" % i) == b"s%d" % i for i in committed)
          and not any(b"straddle/%03d" % i in b_map for i in locked)
          and len(committed) + len(locked) == 10,
          f"DR: straddlers committed {committed}, locked {locked}")
    check(b"stray/x" not in b_map, "DR: the destination's stray key survived")
    check(b_map.get(b"ctr") == (20).to_bytes(8, "little"), f"DR: ctr is {b_map.get(b'ctr')!r}")
    check(after_a == error.database_locked("").code,
          f"DR: a user commit to the locked source drew {after_a}, not database_locked")


def bindings_backup_phase(fc, he, card, recovery_cfg):
    """The bindings, backup and DR (bindings/, backup/) with every resolver
    of every cluster a card engine, in three parts.

    Stack tester: generate_stream at each of STACK_SEEDS through a static
    cluster (two resolvers, make_engine_factory()'s card engines at the
    specs' KernelConfig, each call recorded): the journal and the final
    keyspace byte-equal to the oracle run's, with the same instructions,
    commits, aborts and virtual time; every card call equal to a fresh
    oracle's replay.

    Full-width backup: backup_run with card resolvers at `recovery_cfg`
    (the bench's KernelConfig, ladder and scans) in both clusters,
    supervised as recruitment would: the restored keyspace equal to the
    source read at the end version, the run equal to its oracle twin
    (commits, end version, restored rows, virtual time), no durability
    violation, check_engines. Reports committed txn/s in virtual time
    before and during the backup, snapshot, finish and restore virtual and
    wall seconds, rows restored, snapshot and log bytes moved, graphs
    captured, launches and peak device memory.

    DR switchover: dr_run with supervised card resolvers at the specs'
    KernelConfig in both clusters: check_dr, equal to its oracle twin,
    check_engines.

    Returns the oracle twins as jobs for run_twins (after the last card
    run of the script) and finish(twins), which holds the runs to them."""

    import torch

    from foundationdb_tpu_torch.testing.specs import make_engine_factory

    launches, stacks = {}, {}
    for seed in STACK_SEEDS:
        built = []
        fc.FIXPOINT.reset_counts()
        t0 = time.perf_counter()
        run = stack_run(seed, recording_factory(make_engine_factory(), built))
        wall = time.perf_counter() - t0
        launches[f"stack_{seed}"] = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
        stacks[seed] = {"run": run, "wall_s": wall, "plain_cuda_calls": fc.FIXPOINT.plain_cuda_calls,
                        "devices": [r["engine"].state["hkeys"].device.type for r in built],
                        "batches": sum(len(r["batches"]) for r in built),
                        "captures": sum(r["engine"].perf.captures for r in built),
                        "mismatches": sum(call_mismatches(r["batches"]) for r in built)}
        built.clear()

    built = []
    factory = supervised_card_factory(
        lambda: he.TorchConflictEngine(recovery_cfg, ladder=LADDER, scan_sizes=SCANS,
                                       device_time_sample_rate=0.0), built)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.FIXPOINT.reset_counts()
    t0 = time.perf_counter()
    bk = backup_run(factory)
    bk["wall_s"] = time.perf_counter() - t0
    launches["backup_run"] = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
    bk["plain_cuda_calls"] = fc.FIXPOINT.plain_cuda_calls
    torch.cuda.synchronize()
    bk["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    bk["engines"] = [engine_summary(r) for r in built]
    built.clear()

    built = []
    fc.FIXPOINT.reset_counts()
    t0 = time.perf_counter()
    dr = dr_run(supervised_card_factory(make_engine_factory(), built))
    dr["wall_s"] = time.perf_counter() - t0
    launches["dr_switchover"] = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
    dr["plain_cuda_calls"] = fc.FIXPOINT.plain_cuda_calls
    dr["engines"] = [engine_summary(r) for r in built]
    built.clear()
    for label, n in launches.items():
        check(n > 0, f"bindings/backup phase: {label} made no fixpoint launch")
    check(all(s["plain_cuda_calls"] == 0 for s in stacks.values())
          and bk["plain_cuda_calls"] == 0 and dr["plain_cuda_calls"] == 0,
          "bindings/backup phase: a plain fixpoint ran on CUDA tensors")

    jobs = {("backup_run",): (oracle_backup_run,), ("dr_run",): (oracle_dr_run,)}
    jobs.update({("stack", seed): (stack_run, seed) for seed in STACK_SEEDS})

    def finish(all_twins):
        bk_twin, dr_twin = all_twins[("backup_run",)], all_twins[("dr_run",)]
        stack_twins = {seed: all_twins[("stack", seed)] for seed in STACK_SEEDS}
        for seed, s in stacks.items():
            n, commits, aborts, journal, rows, vt = s["run"]
            check(s["run"] == stack_twins[seed],
                  f"bindings phase: stream {seed} on card resolvers (journal of {len(journal)}, "
                  f"{len(rows)} rows, {commits} commits, {aborts} aborts, virtual time {vt}) differs "
                  f"from its oracle twin")
            check(s["devices"] == ["cuda", "cuda"] and s["mismatches"] == 0 and s["batches"] > 0,
                  f"bindings phase: stream {seed}: engines on {s['devices']}, {s['mismatches']} of "
                  f"{s['batches']} card calls differ from the oracle replay")
            print(f"bindings phase, stack stream {seed} [{card}]: {n} instructions, {commits} "
                  f"commits, {aborts} aborts, journal of {len(journal)} entries and {len(rows)} "
                  f"final rows byte-equal to the oracle run's (virtual time {vt:.6f} s); "
                  f"{s['batches']} card batches, 0 replay mismatches, {s['captures']} graphs "
                  f"captured; {launches[f'stack_{seed}']} fixpoint launches; wall "
                  f"{s['wall_s']:.2f} s", flush=True)

        committed, vend, restored, vt, violations = bk["twin"]
        twin_result, twin_source, twin_health = bk_twin
        check(restored == bk["source_rows"] and len(restored) > 0,
              f"backup run: the restore holds {len(restored)} rows, the source at the end version "
              f"{len(bk['source_rows'])}, or they differ")
        check(bk["vend"] == vend, f"backup run: restore returned {bk['vend']}, the end version is "
              f"{vend}")
        check(bk["twin"] == tuple(twin_result) and bk["source_rows"] == twin_source,
              f"backup run on the card (committed {committed}, end version {vend}, {len(restored)} "
              f"rows, virtual time {vt}) differs from its oracle twin (committed {twin_result[0]}, "
              f"end version {twin_result[1]}, {len(twin_result[2])} rows, virtual time "
              f"{twin_result[3]})")
        check(violations == 0, f"backup run: {violations} durability violations")
        check(committed >= RECOVERY_TXNS, f"backup run: committed {committed}")
        check_engines("backup run", bk["engines"], twin_health)
        es = bk["engines"]
        tm = bk["times"]
        before = (bk["committed_at_start"] - BACKUP_WARM) / tm["load_before_backup"]["virtual_s"]
        during = bk["committed_during"] / tm["load_during_backup"]["virtual_s"]
        bk["txn_per_s_virtual"] = {"before_backup": before, "during_backup": during}
        print(f"backup run [{card}]: {committed} committed by {RECOVERY_CLIENTS} closed-loop clients "
              f"across two {RECOVERY_CLUSTER} clusters; {before:.1f} txn/s (virtual) before the "
              f"backup, {during:.1f} during it ({during / before:.4f}x); snapshot "
              f"{tm['snapshot']['virtual_s']:.6f} virtual s / {tm['snapshot']['wall_s']:.2f} wall s "
              f"({BACKUP_CHUNKS} chunks, {BACKUP_WORKERS} workers), finish "
              f"{tm['finish']['virtual_s']:.6f} / {tm['finish']['wall_s']:.2f}, restore "
              f"{tm['restore']['virtual_s']:.6f} / {tm['restore']['wall_s']:.2f}; {len(restored)} "
              f"rows restored equal to the source at end version {vend}; {bk['snapshot_bytes']} "
              f"snapshot bytes and {bk['log_bytes']} log bytes in {bk['objects']} objects; equal "
              f"to its oracle twin (virtual time {vt:.6f} s), 0 durability violations, "
              f"{sum(e['resolves'] for e in es)} card batches in {len(es)} engines, 0 replay "
              f"mismatches; {sum(e['captures'] for e in es)} graphs captured in "
              f"{sum(e['capture_s'] for e in es):.2f} s; peak device memory "
              f"{bk['max_memory_allocated'] / 2**20:.1f} MiB; {launches['backup_run']} fixpoint "
              f"launches; wall {bk['wall_s']:.2f} s", flush=True)

        check_dr(dr["twin"])
        twin_result, twin_health = dr_twin
        check(dr["twin"] == tuple(twin_result),
              f"DR run on the card {dr['twin'][:3]} (virtual time {dr['twin'][-1]}) differs from its "
              f"oracle twin {twin_result[:3]} (virtual time {twin_result[-1]})")
        check_engines("DR run", dr["engines"], twin_health)
        committed_s, locked_s, fence, rows_a, rows_b, _after, vt = dr["twin"]
        print(f"DR switchover [{card}]: {len(rows_a)} source rows all on the destination "
              f"({len(rows_b)} rows), straddlers {len(committed_s)} committed / {len(locked_s)} "
              f"locked out, fence version {fence}, the locked source refused a user commit with "
              f"database_locked; equal to its oracle twin (virtual time {vt:.6f} s); "
              f"{sum(e['resolves'] for e in dr['engines'])} card batches in {len(dr['engines'])} "
              f"engines, 0 replay mismatches; {launches['dr_switchover']} fixpoint launches; wall "
              f"{dr['wall_s']:.2f} s", flush=True)
        bk.pop("health")
        dr.pop("health")
        bk["twin"] = {"committed": committed, "end_version": vend, "rows": len(restored),
                      "virtual_time": vt, "violations": violations}
        bk.pop("source_rows")
        dr["twin"] = {"committed": len(committed_s), "locked": len(locked_s), "fence": fence,
                      "source_rows": len(rows_a), "destination_rows": len(rows_b),
                      "virtual_time": vt}
        return {"stacks": {seed: {k: v for k, v in s.items() if k != "run"} | {
                    "instructions": s["run"][0], "commits": s["run"][1], "aborts": s["run"][2]}
                           for seed, s in stacks.items()},
                "backup": bk, "dr": dr, "launches": launches}

    return jobs, finish


#: worker processes of the oracle twins of the cluster, dynamic cluster and
#: bindings/backup phases, which all run after the script's last card run
#: the real phase (20): the wall-clock cluster of REAL_PROCS OS-process
#: nodes over 127.0.0.1 TCP (real/cluster.py), every recruited resolver a
#: card engine at the node's default KernelConfig; the Cycle ring over
#: REAL_KEYS keys and REAL_TXNS transactions; then the launcher's backup
#: drill through a blobstore:// HTTPBlobServer
REAL_PROCS = 4
REAL_KEYS = 1000
REAL_TXNS = 500
REAL_LAUNCH_TIMEOUT_S = 420
#: where a node started by real_node_main writes its report when it takes
#: SIGTERM (the launcher stops its nodes with terminate())
REAL_REPORT_ENV = "CHIP_SMOKE_REAL_REPORTS"
#: the fault campaigns: real/nemesis.py's main() point for the card modes
#: (seed 11, 8 s), watchdog, journal and trace export on
REAL_CAMPAIGN_MODES = ("torch", "device_loop")
REAL_CAMPAIGN_SEED = 11
REAL_CAMPAIGN_S = 8.0
REAL_CRASH_SEED = 11
#: the scenario atlas at a short duration, seed as run_scenario_atlas's
REAL_SCENARIO_S = 3.5
REAL_SCENARIO_SEED = 4026


def card_counts(fc, engines, counter=None):
    """This process's fixpoint counts (of `counter`, default the
    single-table entry) and its card engines' facts."""
    counter = counter or fc.FIXPOINT
    return {"launches": counter.launches + counter.graph_launches,
            "plain_cuda_calls": counter.plain_cuda_calls,
            "devices": [str(getattr(e, "device", "cpu")) for e in engines],
            "captures": sum(getattr(getattr(e, "perf", None), "captures", 0) for e in engines)}


def real_node_main(argv):
    """A wall-clock node (real/node.py's main) whose engine factory
    records every engine it builds (recording_engines); on SIGTERM it
    writes its report (fixpoint counts, devices, graphs captured, every
    recorded call) to $CHIP_SMOKE_REAL_REPORTS/node-<port>.pkl and exits."""
    import pickle
    import signal

    from foundationdb_tpu_torch.ops import fixpoint_cuda as fc
    from foundationdb_tpu_torch.real import node

    built = []
    make = node.make_engine_factory

    def recording(kind, device=None):
        return recording_engines(make(kind, device), built)

    node.make_engine_factory = recording
    port = argv[argv.index("--port") + 1]
    out = Path(os.environ[REAL_REPORT_ENV]) / f"node-{port}.pkl"

    def dump(*_):
        rep = card_counts(fc, [r["engine"] for r in built])
        rep["calls"] = [r["calls"] for r in built]
        tmp = out.with_suffix(".tmp")
        tmp.write_bytes(pickle.dumps(rep))
        os.replace(tmp, out)
        os._exit(0)

    signal.signal(signal.SIGTERM, dump)
    return node.main(argv)


def instrument_chaos_engines(log):
    """Wrap real/nemesis.make_chaos_engine so every campaign stack built in
    this process is logged (`log["engines"]`: the inner engines) and its
    supervisor's dispatch faults are sorted by cause (sort_faults, into
    `log`)."""
    from foundationdb_tpu_torch.real import nemesis

    make = nemesis.make_chaos_engine
    log.setdefault("engines", [])
    log.setdefault("faults", {"injected": 0, "watchdog": 0, "buggify": 0, "other": 0})

    def logged(*a, **kw):
        inner, injector, supervised = make(*a, **kw)
        log["engines"].append(inner)
        sort_faults(supervised, log)
        return inner, injector, supervised

    nemesis.make_chaos_engine = logged
    return make


def crash_child_main(report_path, argv):
    """The crash campaign's recoverable child (real/nemesis.py main
    --serve-recover) with its engines instrumented: a thread writes this
    process's fixpoint counts, engines and faults to `report_path`.<pid>
    every 0.2 s (the first boot dies by SIGKILL) and on SIGTERM."""
    import signal
    import threading

    from foundationdb_tpu_torch.ops import fixpoint_cuda as fc
    from foundationdb_tpu_torch.real import nemesis

    log = {}
    instrument_chaos_engines(log)
    out = Path(f"{report_path}.{os.getpid()}")

    def write():
        rep = card_counts(fc, log["engines"])
        rep["faults"] = dict(log["faults"])
        rep["other_errors"] = list(log.get("other_errors", []))
        tmp = out.with_suffix(".tmp")
        tmp.write_text(json.dumps(rep))
        os.replace(tmp, out)

    def every():
        while True:
            time.sleep(0.2)
            write()

    def on_term(*_):
        write()
        os._exit(0)

    threading.Thread(target=every, daemon=True).start()
    signal.signal(signal.SIGTERM, on_term)
    return nemesis.main(argv)


def real_launch(argv, report_dir, timeout):
    """real/cluster.py's launcher in its own process, its nodes started
    through real_node_main; returns (exit code, stdout, wall s, the nodes'
    reports)."""
    import pickle
    import tempfile

    root = str(Path(__file__).resolve().parent)
    node_code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
                 "sys.exit(chip_smoke.real_node_main(sys.argv[1:]))" % root)
    code = ("import sys; sys.path.insert(0, %r); "
            "from foundationdb_tpu_torch.real import cluster; "
            "sys.exit(cluster.main(%r, node_cmd=[sys.executable, '-c', %r]))"
            % (root, argv, node_code))
    env = dict(os.environ, **{REAL_REPORT_ENV: report_dir})
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                       text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    reports = {p.stem: pickle.loads(p.read_bytes())
               for p in sorted(Path(report_dir).glob("node-*.pkl"))}
    return r.returncode, r.stdout + r.stderr, wall, reports


def check_real_nodes(label, reports):
    """Every node reported; each that built engines built them on the card
    and launched the fixpoint there, never the plain version on a CUDA
    tensor; every recorded call equals a fresh oracle's replay."""
    check(len(reports) == REAL_PROCS, f"{label}: {len(reports)} of {REAL_PROCS} nodes reported")
    card = {k: r for k, r in reports.items() if r["devices"]}
    check(card, f"{label}: no node recruited a resolver")
    summary = {"nodes": len(reports), "card_resolvers": 0, "batches": 0, "launches": 0,
               "captures": 0, "mismatches": 0}
    for k, r in card.items():
        check(all(d.startswith("cuda") for d in r["devices"]),
              f"{label}: {k}'s resolvers ran on {r['devices']}")
        check(r["launches"] > 0 and r["plain_cuda_calls"] == 0,
              f"{label}: {k} launched the fixpoint {r['launches']} times on the card, the plain "
              f"version {r['plain_cuda_calls']} times on CUDA tensors")
        bad = sum(call_mismatches(calls) for calls in r["calls"])
        check(bad == 0, f"{label}: {bad} of {k}'s resolve calls differ from the oracle's replay")
        summary["card_resolvers"] += len(r["devices"])
        summary["batches"] += sum(1 for calls in r["calls"] for c in calls if c[0] != "clear")
        summary["launches"] += r["launches"]
        summary["captures"] += r["captures"]
    return summary


def real_campaign(fc, mode, workdir, duration_s=REAL_CAMPAIGN_S, counter=None):
    """run_campaign at REAL_CAMPAIGN_SEED on card engine mode `mode` for
    `duration_s`, the watchdog, journal and trace export on; held to
    assert_slos, journal parity, the Chrome trace's schema, an explained
    incident set and forensics.explain of a resolved version; dispatch
    faults by cause, none from the card. `counter`: the fixpoint entry the
    mode launches (default the single-table one)."""
    counter = counter or fc.FIXPOINT
    from foundationdb_tpu_torch.core import blackbox
    from foundationdb_tpu_torch.real import nemesis
    from foundationdb_tpu_torch.tools import forensics, trace_export

    log = {}
    make = instrument_chaos_engines(log)
    trace_path = os.path.join(workdir, f"trace_{mode}.json")
    bb_dir = os.path.join(workdir, f"bb_{mode}")
    cfg = nemesis.NemesisConfig(seed=REAL_CAMPAIGN_SEED, engine_mode=mode,
                                duration_s=duration_s, trace_export=trace_path,
                                blackbox_dir=bb_dir, watchdog=True)
    counter.reset_counts()
    t0 = time.perf_counter()
    try:
        rep = nemesis.run_campaign(cfg)
    finally:
        nemesis.make_chaos_engine = make
    wall = time.perf_counter() - t0
    counts = card_counts(fc, log["engines"], counter)
    label = f"campaign {mode}"
    check(counts["devices"] and all(d.startswith("cuda") for d in counts["devices"]),
          f"{label}: engines on {counts['devices']}")
    check(counts["launches"] > 0 and counts["plain_cuda_calls"] == 0,
          f"{label}: {counts['launches']} fixpoint launches, {counts['plain_cuda_calls']} plain "
          "fixpoints on CUDA tensors")
    try:
        nemesis.assert_slos(rep, cfg)
    except AssertionError as e:
        # assert_slos ends its message with the whole report: print that on
        # a line of its own, so the failure's reason stays the last line
        reason, _, report = str(e).partition(": {")
        if report:
            print(f"{label}: the campaign report: {{{report}", file=sys.stderr, flush=True)
        fail(f"{label}: assert_slos: {reason}")
    check(rep.parity_checked > 0 and rep.parity_mismatches == 0,
          f"{label}: journal parity {rep.parity_mismatches} of {rep.parity_checked}")
    incidents = rep.incidents or []
    check(all(i["explained"] for i in incidents), f"{label}: an unexplained incident")
    with open(trace_path) as f:
        n_events = trace_export.validate_chrome_trace(json.load(f))
    events = blackbox.read_journal(bb_dir)
    versions = [e.payload.version for e in events if e.kind == "batch"]
    check(versions, f"{label}: the journal holds no batch")
    info = forensics.explain(events, versions[len(versions) // 2])
    lines = forensics.render_explain(info)
    check(lines and info["verdicts"], f"{label}: forensics.explain narrated nothing")
    faults = log["faults"]
    check(faults["injected"] >= 1, f"{label}: the device window injected no fault")
    check(faults["watchdog"] == 0 and faults["other"] == 0,
          f"{label}: dispatch faults not injected: {faults} {log.get('other_errors')}")
    return {"wall_s": wall, "p99_outside_ms": rep.p99_outside_ms,
            "budget_ms": cfg.resolved_budget_ms(), "n_outside": rep.n_outside,
            "parity_checked": rep.parity_checked, "committed": rep.counts.get("committed"),
            "engine_stats": rep.engine_stats, "faults": dict(faults),
            "incidents": len(incidents), "trace_events": n_events,
            "journal_batches": len(versions), "explained_version": info.get("version"),
            "engines": len(counts["devices"]), "captures": counts["captures"],
            "launches": counts["launches"], "chaos_counts": rep.chaos_counts}


def instrumented_crash_child_argv(report_path):
    """A stand-in for real/nemesis.py's _crash_child_argv that starts the
    recoverable child through crash_child_main (reports to
    `report_path`.<pid>)."""
    root = str(Path(__file__).resolve().parent)

    def instrumented(port, datadir, engine_mode, seed, disk_prob, device=None):
        argv = ["--serve-recover", str(port), "--datadir", datadir, "--child-engine",
                engine_mode, "--recovery-seed", str(seed), "--disk-prob", str(disk_prob)]
        if device is not None:
            argv += ["--device", str(device)]
        code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
                "sys.exit(chip_smoke.crash_child_main(%r, %r))" % (root, report_path, argv))
        return [sys.executable, "-c", code]

    return instrumented


def crash_children_checked(label, report_path):
    """The crash children's reports (both boots): each child's engines on
    the card, fixpoint launches and no plain fixpoint on a CUDA tensor, no
    dispatch fault but buggify's."""
    children = [json.loads(p.read_text())
                for p in sorted(Path(report_path).parent.glob(Path(report_path).name + ".*"))
                if p.suffix != ".tmp"]
    check(len(children) >= 2, f"{label}: {len(children)} child reports")
    for i, c in enumerate(children):
        check(c["devices"] and all(d.startswith("cuda") for d in c["devices"]),
              f"{label}: child {i}'s engines on {c['devices']}")
        check(c["launches"] > 0 and c["plain_cuda_calls"] == 0,
              f"{label}: child {i}: {c['launches']} fixpoint launches, {c['plain_cuda_calls']} "
              "plain fixpoints on CUDA tensors")
        check(c["faults"]["watchdog"] == 0 and c["faults"]["other"] == 0,
              f"{label}: child {i}'s dispatch faults {c['faults']} {c['other_errors']}")
    return children


def real_crash_campaign(workdir):
    """run_crash_campaign on a card engine, its recoverable child
    instrumented (crash_child_main): parity across the crash, complete
    recovery, and the restarted child served on the card; the blackout
    against resolver_recovery_budget_ms, reported, not gated."""
    from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
    from foundationdb_tpu_torch.real import nemesis

    report_path = os.path.join(workdir, "crash_child")
    argv_of = nemesis._crash_child_argv
    nemesis._crash_child_argv = instrumented_crash_child_argv(report_path)
    cfg = nemesis.crash_config(REAL_CRASH_SEED, engine_mode="torch",
                               datadir=os.path.join(workdir, "crash"))
    t0 = time.perf_counter()
    try:
        rep = nemesis.run_crash_campaign(cfg)
    finally:
        nemesis._crash_child_argv = argv_of
    wall = time.perf_counter() - t0
    label = "crash campaign"
    rec = rep.get("recovery") or {}
    check(rep.get("child_up") and rep.get("child_restarts", 0) >= 1
          and rep.get("child_pingable_after"), f"{label}: the child did not come back ({rep})")
    check(rep.get("parity_checked", 0) > 0 and rep.get("parity_mismatches", 1) == 0,
          f"{label}: parity {rep.get('parity_mismatches')} of {rep.get('parity_checked')}")
    check(rec.get("mode") == "complete" and rec.get("coverage_ok")
          and rec.get("verdict_mismatches", 1) == 0, f"{label}: recovery {rec}")
    check(rep.get("committed_post_restart", 0) > 0, f"{label}: no commit after the restart")
    children = crash_children_checked(label, report_path)
    return {"wall_s": wall, "blackout_ms": rec.get("blackout_ms"), "warm_ms": rec.get("warm_ms"),
            "budget_ms": float(SERVER_KNOBS.resolver_recovery_budget_ms),
            "campaign_budget_ms": cfg.resolved_budget_ms(),
            "span_blackouts_ms": rep.get("recovery_span_blackouts_ms"),
            "replayed_batches": rec.get("replayed_batches"),
            "snapshot_version": rec.get("snapshot_version"),
            "restart_serve_s": rep.get("restart_serve_s"),
            "parity_checked": rep.get("parity_checked"),
            "committed_post_restart": rep.get("committed_post_restart"),
            "children": children, "launches": sum(c["launches"] for c in children)}


def real_scenarios(fc):
    """The six recipes of the scenario atlas on the card's step engine at
    REAL_SCENARIO_S each (run_scenario): every scorecard SLO row passes,
    journal parity 0, every engine on the card."""
    from foundationdb_tpu_torch.real import nemesis, scenarios

    rows, launches = {}, 0
    for i, name in enumerate(scenarios.SCENARIOS):
        log = {}
        make = instrument_chaos_engines(log)
        fc.FIXPOINT.reset_counts()
        t0 = time.perf_counter()
        try:
            rep, row = scenarios.run_scenario(name, seed=REAL_SCENARIO_SEED + i * 10,
                                              engine_mode="torch", duration_s=REAL_SCENARIO_S)
        finally:
            nemesis.make_chaos_engine = make
        counts = card_counts(fc, log["engines"])
        label = f"scenario {name}"
        check(counts["devices"] and all(d.startswith("cuda") for d in counts["devices"]),
              f"{label}: engines on {counts['devices']}")
        check(counts["launches"] > 0 and counts["plain_cuda_calls"] == 0,
              f"{label}: {counts['launches']} fixpoint launches, {counts['plain_cuda_calls']} "
              "plain fixpoints on CUDA tensors")
        check(row["slo_pass"] == 1, f"{label}: scorecard {row}")
        check(rep.parity_checked > 0 and rep.parity_mismatches == 0,
              f"{label}: journal parity {rep.parity_mismatches} of {rep.parity_checked}")
        check(log["faults"]["watchdog"] == 0 and log["faults"]["other"] == 0,
              f"{label}: dispatch faults {log['faults']} {log.get('other_errors')}")
        launches += counts["launches"]
        rows[name] = {k: row[k] for k in ("p99_ms", "budget_ms", "abort_frac", "throttle_frac",
                                          "committed", "parity_checked", "reshards_executed")}
        rows[name].update(wall_s=time.perf_counter() - t0, engines=len(counts["devices"]),
                          captures=counts["captures"], launches=counts["launches"])
    return rows, launches


def real_phase(fc, card):
    """The wall-clock cluster and its campaigns on the card: the real
    cluster's Cycle run and backup drill (card resolvers in OS-process
    nodes over TCP), the fault campaigns on both card modes, the crash
    campaign and the scenario atlas. Returns the phase's report, its
    fixpoint launches by path in "launches"."""
    import shutil
    import tempfile

    out = {"launches": {}}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_real_")
    try:
        for label, argv in (
                ("real_cluster", ["--procs", str(REAL_PROCS), "--keys", str(REAL_KEYS),
                                  "--txns", str(REAL_TXNS), "--engine", "torch"]),
                ("real_backup", ["--procs", str(REAL_PROCS), "--backup", "--engine", "torch"])):
            reports = os.path.join(workdir, label)
            os.makedirs(reports)
            rc, text, wall, nodes = real_launch(argv, reports, REAL_LAUNCH_TIMEOUT_S)
            marker = ("backup->wipe->restore via blobstore verified" if label == "real_backup"
                      else "REAL CLUSTER OK")
            check(rc == 0 and marker in text, f"{label}: the launcher failed:\n{text[-3000:]}")
            s = check_real_nodes(label, nodes)
            s["wall_s"] = wall
            out[label] = s
            out["launches"][label] = s["launches"]
            print(f"  {label} [{card}]: {REAL_PROCS} nodes over TCP, {s['card_resolvers']} card "
                  f"resolvers, {s['batches']} batches equal to the oracle's replay, "
                  f"{s['launches']} fixpoint launches, {s['captures']} graphs; "
                  f"wall {wall:.1f} s", flush=True)
        for mode in REAL_CAMPAIGN_MODES:
            c = real_campaign(fc, mode, workdir)
            out[f"campaign_{mode}"] = c
            out["launches"][f"campaign_{mode}"] = c["launches"]
            print(f"  campaign {mode} [{card}]: p99 outside windows {c['p99_outside_ms']:.3f} ms "
                  f"against the {c['budget_ms']:.1f} ms budget (n={c['n_outside']}), parity "
                  f"{c['parity_checked']} batches, {c['committed']} commits, faults "
                  f"{c['faults']}, failovers {c['engine_stats'].get('failovers')} swap-backs "
                  f"{c['engine_stats'].get('swap_backs')}, {c['incidents']} incidents (all "
                  f"explained), {c['trace_events']} trace events, {c['engines']} engines, "
                  f"{c['captures']} graphs, {c['launches']} launches; wall {c['wall_s']:.1f} s",
                  flush=True)
        cr = real_crash_campaign(workdir)
        out["crash_campaign"] = cr
        out["launches"]["crash_campaign"] = cr["launches"]
        print(f"  crash campaign [{card}]: blackout {cr['blackout_ms']} ms (warm {cr['warm_ms']} "
              f"ms) against resolver_recovery_budget_ms {cr['budget_ms']:.0f} (reported, not "
              f"gated), {cr['replayed_batches']} batches replayed, parity "
              f"{cr['parity_checked']} batches, {cr['committed_post_restart']} commits after the "
              f"restart, {cr['launches']} launches; wall {cr['wall_s']:.1f} s", flush=True)
        rows, n = real_scenarios(fc)
        out["scenarios"] = rows
        out["launches"]["scenarios"] = n
        for name, row in rows.items():
            print(f"  scenario {name} [{card}]: p99 {row['p99_ms']} ms against "
                  f"{row['budget_ms']} ms, abort {row['abort_frac']}, {row['committed']} "
                  f"commits, parity {row['parity_checked']} batches, {row['engines']} engines, "
                  f"{row['launches']} launches; wall {row['wall_s']:.1f} s", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# the sharded phase: the stacked fixpoint entry, the sub-sharded
# engine, the sharded and mesh engines, the TPU8 specs, a mesh campaign
# ---------------------------------------------------------------------------

#: sub-shards of the sub-sharded engine; the sharded / mesh widths
SHARDED_S = 8
SHARDED_N = (1, 2, 4)
#: the sub-sharded, sharded and mesh engines' programs: the top bucket,
#: one chunk and (sub-sharded) a 2-chunk scan; a stacked step loops over
#: its sub-shards, so each capture holds S times a step's kernels
SHARDED_SCANS = (2,)
TPU8_SPECS = ("CycleTestTPU8", "RandomReadWriteTPU8")
TPU8_SEED = 1
MESH_CAMPAIGN_SHARDS = 2
STACKED_KERNEL = "commit_fixpoint_stacked_kernel"


def pool_splits(n: int):
    """Split keys that cut the columnar traffic's hot pool into n equal
    spans."""
    return [b"h/%014d" % (POOL_KEYS * i // n) for i in range(1, n)]


#: 8 sub-shards, most of the pool in two of them: splits outside the pool,
#: on pool keys and on prefixes of pool keys (a split key fits the 16-byte
#: compare window)
ADVERSARIAL_SPLITS = sorted({b"a", b"h/", b"h/0000000000010", b"h/%014d" % 100,
                             b"h/0000000000409", b"h/%014d" % 4096, b"i"})


def cpu_subsharded_twin(cfg_fields, splits, kw, batches):
    """A CPU SubshardedConflictEngine's pass over the card engine's
    batches (run in a worker process): its verdicts, heat snapshot and
    history stats."""
    import torch

    from foundationdb_tpu_torch.core.keyshard import KeyShardMap
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    from foundationdb_tpu_torch.ops import host_engine as he

    torch.set_num_threads(1)
    clean_port_world()
    eng = he.SubshardedConflictEngine(ck.KernelConfig(**cfg_fields), KeyShardMap(splits),
                                      device="cpu", ladder=(), scan_sizes=SHARDED_SCANS,
                                      device_time_sample_rate=0.0, **kw)
    verdicts = [[int(v) for v in eng.resolve(t, n, o)] for t, n, o in batches]
    return verdicts, eng.heat_snapshot(), eng.history_stats_snapshot()


def sharded_phase(ck, fc, he, pl, card, dev, cfg, engine_cfg, batches, serial, oracle_ref, rng):
    """The sharded resolver on the card.

    Kernel: sharded_kernel_phase at the bench shape with S in {1, 2, 8}
    and at the default KernelConfig with S = 8.

    Sub-sharded: SubshardedConflictEngine(S = 8) at the bench's
    KernelConfig (top bucket, scans of 2 chunks), with the pool split into
    8 equal spans ("uniform", heat 64; heat 0; tiered) and with
    ADVERSARIAL_SPLITS (heat 64), warmed up, on the columnar traffic
    through serve(): verdicts equal the oracle's and the single-table card
    engine's on every batch, the stacked entry on the path; the one-chunk
    program's device ms and kernels against a single-table engine at the
    same config, and txn/s of both in turns. A CPU twin of the uniform and
    the tiered engines (jobs for run_twins) holds their heat snapshots and
    history stats.

    Sharded and mesh: ShardedConflictEngine and MeshShardedConflictEngine
    (overlap serial and on) with N in SHARDED_N shards, every shard on
    the card, at the bench config, one-chunk programs: verdicts equal the
    oracle's, the mesh engines make no blocking sync and report
    mesh_stats; then a ResolverPipeline at depth 2 over the widest
    overlapped mesh engine (dispatch mode "mesh").

    Specs: CycleTestTPU8 and RandomReadWriteTPU8 at TPU8_SEED with the
    8-shard ShardedConflictEngine resolvers on the card; each recorded
    resolve replays through a fresh oracle; the oracle twins are jobs.

    Chaos: one mesh campaign (MESH_CAMPAIGN_SHARDS shards) for the other
    card campaigns' REAL_CAMPAIGN_S: the fault windows last as long at any
    duration, and a shorter run leaves barely the 50 acks outside them that
    assert_slos requires.

    Returns (results, twin jobs, finish(twins))."""
    import dataclasses
    import tempfile

    import torch

    from foundationdb_tpu_torch.core.keyshard import KeyShardMap
    from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
    from foundationdb_tpu_torch.parallel.mesh_engine import MeshShardedConflictEngine
    from foundationdb_tpu_torch.parallel.sharding import ShardedConflictEngine
    from foundationdb_tpu_torch.testing.specs import SPECS, make_engine_factory
    from foundationdb_tpu_torch.testing.workload import run_spec

    out = {"kernel": {}, "subsharded": {}, "mesh": {}, "launches": {}, "single_launches": {}}
    stacked = fc.FIXPOINT_STACKED

    # -- the stacked entry against its plain version -------------------------
    t0 = time.perf_counter()
    for label, kcfg, sizes in (("bench", cfg, (1, 2, SHARDED_S)), ("engine", engine_cfg, (SHARDED_S,))):
        for S in sizes:
            kp = sharded_kernel_phase(ck, fc, kcfg, dev, rng, S, n_batches=4)
            out["kernel"][f"{label}_S{S}"] = kp
            print(f"sharded kernel, {label} shape, S={S} [{card}]: {kp['batches']} batches "
                  f"bit-equal{' (and to the single-table entry)' if S == 1 else ''}, rounds "
                  f"median {kp['rounds_median']} max {kp['rounds_max']}; kernel_ms="
                  f"{kp['kernel_ms']:.4f} (call {kp['call_ms']:.4f}) plain_ms={kp['plain_ms']:.4f} "
                  f"bound_ms={kp['bound_ms']:.6f} ({kp['bound_by']}); txn indices in "
                  f"{'shared' if kp['wtx_in_smem'] else 'global'} memory, "
                  f"{kp['scratch_bytes']} scratch bytes", flush=True)
    out["kernel_s"] = time.perf_counter() - t0

    # -- the sub-sharded engine ----------------------------------------------
    references = [("the oracle", oracle_ref),
                  ("the single-table card engine", lambda b, *_: serial[b])]
    kw = dict(ladder=(), scan_sizes=SHARDED_SCANS, device_time_sample_rate=0.0)
    runs, snaps = {}, {}
    for label, splits, extra in (("uniform", pool_splits(SHARDED_S), {}),
                                 ("adversarial", ADVERSARIAL_SPLITS, {}),
                                 ("uniform_heat_off", pool_splits(SHARDED_S), {"heat_buckets": 0}),
                                 ("uniform_tiered", pool_splits(SHARDED_S),
                                  {"history_structure": "tiered"})):
        t0 = time.perf_counter()
        eng = he.SubshardedConflictEngine(cfg, KeyShardMap(splits), **kw, **extra)
        check(eng.n_shards == SHARDED_S, f"{label}: {eng.n_shards} sub-shards")
        warm = warmed(eng)
        check(eng.perf.captures == 2 * (1 + len(SHARDED_SCANS)),
              f"sub-sharded {label}: warmup captured {eng.perf.captures} graphs")
        sv, served = serve(ck, fc, eng, batches, f"sub-sharded S={SHARDED_S} {label}", references,
                           counter=stacked)
        served.update(warm)
        served["wall_s"] = time.perf_counter() - t0
        # what the CPU twins hold, taken before any timing pass re-serves
        # the traffic
        snaps[label] = (eng.heat_snapshot(), eng.history_stats_snapshot(), sv)
        runs[label] = (eng, sv, served)
        out["launches"][f"subsharded_{label}"] = served["launches"]
        print(f"sub-sharded S={SHARDED_S} {label} [{card}]: {served['txns']} txns in "
              f"{served['batches']} batches equal the oracle and the single-table card engine; "
              f"warmup {warm['warmup_s']:.2f} s; pack {served['pack_ms_per_batch']:.3f} dispatch "
              f"{served['dispatch_ms_per_batch']:.3f} force {served['force_ms_per_batch']:.3f} "
              f"ms/batch, {served['txn_per_s']:.0f} txn/s; {served['launches']} stacked launches, "
              f"{served['merges']} merges ({served['wall_s']:.1f} s)", flush=True)
    # a single table at the same config, and the one-chunk programs apart
    t0 = time.perf_counter()
    single = he.TorchConflictEngine(cfg, **kw)
    warmed(single)
    ssv, sserved = serve(ck, fc, single, batches, "single-table bench config", references)
    out["single_launches"]["sharded_single_table"] = sserved["launches"]
    sub, sub_sv, _ = runs["uniform"]
    programs = {}
    for label, e, kernel, fixpoints in (("single", single, FIXPOINT_KERNEL, 1),
                                        ("subsharded", sub, STACKED_KERNEL, 1)):
        prog = e._programs[(cfg.max_txns, 1)]
        pw = traced_replays(lambda: prog.run(False), 2, fixpoints, f"the {label} one-chunk program",
                            kernel)
        programs[label] = {"device_ms": pw["device_ms"], "kernels": pw["kernels"]}
    turns = {"single": [], "subsharded": []}
    for label, e, sv in (("single", single, ssv), ("subsharded", sub, sub_sv),
                         ("subsharded", sub, sub_sv), ("single", single, ssv)):
        turns[label].append(columnar_timing(e, batches, sv))
    out["subsharded"] = {k: v[2] for k, v in runs.items()}
    out["subsharded"]["single_table"] = sserved
    out["programs"] = programs
    out["turns"] = turns
    best = {k: max(r["txn_per_s"] for r in v) for k, v in turns.items()}
    out["txn_per_s_ratio"] = best["subsharded"] / best["single"]
    print(f"sub-sharded against one table, bench config [{card}]: one-chunk program "
          f"{programs['subsharded']['device_ms']:.4f} ms in {programs['subsharded']['kernels']:.0f} "
          f"kernels against {programs['single']['device_ms']:.4f} ms in "
          f"{programs['single']['kernels']:.0f}; txn/s in turns single "
          + " / ".join(f"{r['txn_per_s']:.0f}" for r in turns["single"]) + ", sub-sharded "
          + " / ".join(f"{r['txn_per_s']:.0f}" for r in turns["subsharded"])
          + f" ({out['txn_per_s_ratio']:.3f}x); ms/batch pack/dispatch/force single "
          + " / ".join(f"{turns['single'][0][k]:.3f}" for k in ("pack_ms_per_batch",
                                                               "dispatch_ms_per_batch",
                                                               "force_ms_per_batch"))
          + ", sub-sharded "
          + " / ".join(f"{turns['subsharded'][0][k]:.3f}" for k in ("pack_ms_per_batch",
                                                                   "dispatch_ms_per_batch",
                                                                   "force_ms_per_batch"))
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    del single

    # -- the sharded and mesh engines ----------------------------------------
    t0 = time.perf_counter()
    mesh_kw = dict(ladder=(), scan_sizes=(), device_time_sample_rate=0.0)
    widest = None
    for n in SHARDED_N:
        for family, extra in (("sharded", {}), ("mesh_serial", {"overlap": False}),
                              ("mesh_overlapped", {"overlap": True})):
            cls = ShardedConflictEngine if family == "sharded" else MeshShardedConflictEngine
            eng = cls(cfg, KeyShardMap(pool_splits(n)), devices=[dev] * n, **mesh_kw, **extra)
            warmed(eng)
            want_graphs = 2 if family == "sharded" else 3
            check(eng.perf.captures == want_graphs,
                  f"{family} N={n}: warmup captured {eng.perf.captures} graphs")
            label = f"{family} N={n}"
            sv, served = serve(ck, fc, eng, batches, label, [("the oracle", oracle_ref)],
                               counter=stacked)
            out["launches"][f"{family}_{n}"] = served["launches"]
            res = {k: served[k] for k in ("txns", "launches", "txn_per_s", "pack_ms_per_batch",
                                          "dispatch_ms_per_batch", "force_ms_per_batch")}
            if family != "sharded":
                check(eng.loop_stats["blocking_syncs"] == 0, f"{label} made a blocking sync")
                check(eng.mesh_stats["timed_exchanges"] > 0, f"{label} timed no exchange")
                res["mesh_stats"] = eng.mesh_stats_snapshot()
                res["device_view"] = eng.device_view()
                if n == max(SHARDED_N) and eng.overlap:
                    widest = (eng, sv)
            out["mesh"][label] = res
            print(f"{label} [{card}]: {served['txns']} txns equal the oracle; "
                  f"{served['txn_per_s']:.0f} txn/s; {served['launches']} stacked launches"
                  + (f"; mesh_stats {res['mesh_stats']}" if "mesh_stats" in res else ""),
                  flush=True)
    eng, sv = widest
    eng.base = eng.oldest_version = 0
    eng.clear(0)
    torch.cuda.synchronize()
    stacked.reset_counts()
    drains0 = dict(eng.loop_stats)
    pipe = pl.ResolverPipeline(eng, depth=2)
    tp = time.perf_counter()
    handles = [pipe.submit(txns, now, oldest) for txns, now, oldest in batches]
    got = [[int(v) for v in h.result()] for h in handles]
    wall = time.perf_counter() - tp
    check(got == sv, "the mesh pipeline's verdicts differ from serial resolve()")
    check(eng.loop_stats["blocking_syncs"] == drains0["blocking_syncs"],
          "the mesh pipeline made a blocking sync")
    batcher = getattr(pipe, "batcher", None)
    check(batcher is None or batcher.dispatch_mode == "mesh",
          "the mesh pipeline filed its EWMAs elsewhere")
    n_l = stacked.launches + stacked.graph_launches
    check(n_l > 0 and stacked.plain_cuda_calls == 0, f"the mesh pipeline made {n_l} launches")
    out["launches"]["mesh_pipeline"] = n_l
    out["mesh_pipeline"] = {"depth": 2, "txn_per_s": sum(len(t) for t, _, _ in batches) / wall,
                            "drains": {k: eng.loop_stats[k] - drains0[k]
                                       for k in ("units", "drained_nonblocking", "forced_waits",
                                                 "blocking_syncs")}}
    print(f"mesh pipeline, depth 2, N={max(SHARDED_N)} overlapped [{card}]: equal to serial "
          f"resolve(), {out['mesh_pipeline']['txn_per_s']:.0f} txn/s, drains "
          f"{out['mesh_pipeline']['drains']} ({time.perf_counter() - t0:.1f} s for the sharded "
          f"and mesh engines)", flush=True)
    del widest, eng

    # -- the TPU8 specs --------------------------------------------------------
    spec_runs = {}
    for name in TPU8_SPECS:
        clean_port_world()
        stacked.reset_counts()
        built = []
        spec = SPECS[name]()
        spec.cluster.engine_factory = recording_factory(
            make_engine_factory(mode="sharded", n_shards=8), built)
        t0 = time.perf_counter()
        res = run_spec(spec, TPU8_SEED)
        wall = time.perf_counter() - t0
        check(res.ok, f"sharded phase: spec {name} failed on the card: {res.metrics}")
        check(all(type(r["engine"]).__name__ == "ShardedConflictEngine"
                  and r["engine"].state["hkeys"].device.type == "cuda" for r in built),
              f"{name}: resolvers off the card or not sharded")
        n_l = stacked.launches + stacked.graph_launches
        check(n_l > 0 and stacked.plain_cuda_calls == 0, f"{name}: {n_l} stacked launches")
        out["launches"][f"spec_{name}"] = n_l
        spec_runs[name] = {"result": dataclasses.astuple(res), "wall_s": wall,
                           "engines": len(built),
                           "batches": sum(len(r["batches"]) for r in built),
                           "replay_mismatches": sum(call_mismatches(r["batches"]) for r in built),
                           "launches": n_l}
    clean_port_world()

    # -- a mesh chaos campaign -------------------------------------------------
    with tempfile.TemporaryDirectory() as workdir:
        SERVER_KNOBS.set_knob("resolver_mesh_devices", str(MESH_CAMPAIGN_SHARDS))
        try:
            camp = real_campaign(fc, "mesh", workdir, counter=stacked)
        finally:
            SERVER_KNOBS.set_knob("resolver_mesh_devices", "0")
    out["launches"]["campaign_mesh"] = camp["launches"]
    out["campaign_mesh"] = camp
    print(f"mesh campaign [{card}]: {MESH_CAMPAIGN_SHARDS} shards, {camp['wall_s']:.1f} s, p99 "
          f"outside the windows {camp['p99_outside_ms']:.2f} ms against {camp['budget_ms']} ms "
          f"(n={camp['n_outside']}), "
          f"journal parity over {camp['parity_checked']} batches, faults {camp['faults']}, "
          f"{camp['launches']} stacked launches", flush=True)
    clean_port_world()

    # -- twins -------------------------------------------------------------------
    cfg_fields = dataclasses.asdict(cfg)
    jobs = {("subsharded_cpu", label): (cpu_subsharded_twin, cfg_fields, pool_splits(SHARDED_S),
                                        extra, batches)
            for label, extra in (("uniform", {}), ("uniform_tiered",
                                                   {"history_structure": "tiered"}))}
    jobs.update({("cluster_spec", name, TPU8_SEED): (oracle_spec, name, TPU8_SEED)
                 for name in TPU8_SPECS})
    snaps = {label: snaps[label] for label in ("uniform", "uniform_tiered")}
    del runs

    def finish(twins):
        for label, (heat, hist, sv) in snaps.items():
            v, theat, thist = twins[("subsharded_cpu", label)]
            check(v == sv, f"sub-sharded {label}: the CPU engine's verdicts differ")
            check(heat == theat, f"sub-sharded {label}: the card's heat snapshot differs from the "
                  "CPU engine's")
            check(hist == thist, f"sub-sharded {label}: history stats differ from the CPU engine's")
        for name, run in spec_runs.items():
            twin = twins[("cluster_spec", name, TPU8_SEED)]
            check(run["result"] == twin, f"spec {name} on the card {run['result']} differs from "
                  f"its oracle twin {twin}")
            check(run["replay_mismatches"] == 0,
                  f"spec {name}: {run['replay_mismatches']} recorded batches differ from the "
                  "oracle replay")
            ok, metrics, _, vt = run["result"]
            print(f"spec {name} seed {TPU8_SEED} [{card}]: ok, equal to its oracle twin (virtual "
                  f"time {vt:.6f} s, {metrics}); {run['engines']} 8-shard card resolvers served "
                  f"{run['batches']} batches, 0 replay mismatches; {run['launches']} stacked "
                  f"launches; wall {run['wall_s']:.2f} s", flush=True)
        print(f"sharded phase [{card}]: the sub-sharded heat snapshots and history stats equal "
              f"their CPU twins", flush=True)
        out["specs"] = spec_runs
        return out

    return jobs, finish


# ---------------------------------------------------------------------------
# the tools phase: the benches bench.py drives, profile_kernel, the CLI and
# fdbbackup, on the card
# ---------------------------------------------------------------------------

#: bench.py's bucket_ladder section: its ladder over the bench CFG, its pool
TOOLS_LADDER = (512, 1024, 2048)
TOOLS_LADDER_ROUNDS = 2
TOOLS_LADDER_SEED = 2026
#: the floor, apply and heat programs' steps (bench.py: 256, 128 and 128;
#: cut to keep the phase near 150 s)
TOOLS_FLOOR_STEPS = 32
TOOLS_HEAT_STEPS = 64
#: profile_kernel's program steps at the bench shape (its STEPS: 256)
TOOLS_PROFILE_STEPS = 32
TOOLS_PROFILE_VARIANTS = ("full", "phases12", "sort", "fixpoint", "apply", "binsearch")
#: the CLI session over one dynamic cluster, and the commands whose text
#: reads the resolvers' engines (the rest must equal the oracle twin's)
TOOLS_CLI_SEED = 0
TOOLS_CLI_LINES = ("status", "set hello world", "get hello", "getrange a z", "clear hello",
                   "get hello", "set 0x00ff 0xdead", "getrange 0x00 0xff", "shards",
                   "telemetry", "perf", "heat")
TOOLS_ENGINE_LINES = ("telemetry", "perf", "heat")
TOOLS_BACKUP_SEED = 5


def tools_cfg512(ck):
    """bench.py's 512-txn production point (history_floor, loop_floor,
    conflict_heat): the bench capacity, 1024 point rows a group."""
    return ck.KernelConfig(key_words=4, capacity=24576, max_point_reads=1024,
                           max_point_writes=1024, max_reads=64, max_writes=64, max_txns=512)


def ladder_oracle_twin(sizes, pool, rounds, seed):
    """The ladder drive's oracle twin (run in a worker process): the
    oracle's verdicts on the drive's stream, batch by batch."""
    from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine
    from foundationdb_tpu_torch.tools.ladder_bench import ladder_stream

    oracle = OracleConflictEngine()
    return [[int(v) for v in oracle.resolve(*b)]
            for b in ladder_stream(sizes, pool, rounds, seed)]


def heat_cpu_twin(pool, n_batches):
    """The heat sweep's CPU twin (run in a worker process): run_conflict_heat
    on CPU engines at the same shape and seed, the overhead left out."""
    import torch

    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    from foundationdb_tpu_torch.tools.heat_bench import run_conflict_heat

    torch.set_num_threads(1)
    out = run_conflict_heat(tools_cfg512(ck), pool=pool, n_batches=n_batches, device="cpu",
                            overhead=False)
    return {"sweep": out["sweep"], "split": out["split"], "parity_ok": out["parity_ok"]}


def cli_session(seed, factory=None):
    """TOOLS_CLI_LINES through one Cli over a dynamic cluster whose
    resolvers `factory` builds (None: the oracle, the twin): {line: text}."""
    import io

    from foundationdb_tpu_torch.server.cluster import DynamicClusterConfig, build_dynamic_cluster
    from foundationdb_tpu_torch.tools.cli import Cli

    clean_port_world()
    kw = {} if factory is None else {"engine_factory": factory}
    cluster = build_dynamic_cluster(seed=seed, cfg=DynamicClusterConfig(**kw))
    out = io.StringIO()
    cli = Cli(cluster, out=out)
    cli.sim.run(until=3.0)
    texts = {}
    for line in TOOLS_CLI_LINES:
        out.seek(0)
        out.truncate(0)
        cli.run_command(line)
        texts[line] = out.getvalue()
    clean_port_world()
    return texts


def tool_main(module, argv):
    """A tool's main(argv) in this process: (exit code, standard output)."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"foundationdb_tpu_torch.tools.{module}")
    clean_port_world()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    clean_port_world()
    return rc, buf.getvalue()


def recorded_tool_main(fc, module, argv, built):
    """tool_main with the tool's engine_factory wrapped so that every engine
    it builds records its calls into `built` (recording_engines); the
    fixpoint counts zeroed just before and read just after."""
    import importlib

    mod = importlib.import_module(f"foundationdb_tpu_torch.tools.{module}")
    make = mod.engine_factory
    mod.engine_factory = lambda kind="torch", device=None: recording_engines(
        make(kind, device), built)
    fc.FIXPOINT.reset_counts()
    try:
        rc, text = tool_main(module, argv)
    finally:
        mod.engine_factory = make
    return rc, text, fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches


def card_engines_checked(where, fc, built):
    """Every recorded engine on the card, every call equal to a fresh
    oracle's replay, no plain fixpoint on CUDA tensors: (engines, calls)."""
    devices = {r["engine"].device.type for r in built}
    calls = sum(len(r["calls"]) for r in built)
    bad = sum(call_mismatches(r["calls"]) for r in built)
    check(built and devices == {"cuda"}, f"{where}: engines on {devices or 'nothing'}")
    check(calls > 0 and bad == 0, f"{where}: {bad} of {calls} card calls differ from the "
          f"oracle's replay")
    check(fc.FIXPOINT.plain_cuda_calls == 0, f"{where}: a plain fixpoint ran on CUDA tensors")
    return len(built), calls


def tools_phase(fc, he, ck, card, cfg):
    """The tools bench.py drives, and the operator tools, each through its
    entry point on the card, the fixpoint counts zeroed just before each
    path and read just after:

    ladder: ladder_bench.drive_bucket_ladder at bench.py's bucket_ladder
    section (the bench CFG, ladder 512/1024/2048, the 8192-key pool, two
    rounds): 0 builds and captures after warmup, every scan size served,
    every batch's verdicts held to the oracle twin's (after the last card
    run). floor: floor_bench.run_floor_sweep in both search modes at the
    512-txn production point and the bench capacity (occupancy 1/4, 1/2,
    3/4): device ms per batch against occupancy, equal verdicts across
    modes, 0 captures after warmup; run_apply_sweep (monolithic against
    tiered) and run_loop_floor (step against loop, verdicts equal, no
    blocking sync). heat: heat_bench.run_conflict_heat at the 512-txn
    point: concentration rises with s, the split within tolerance, heat on
    and off verdicts equal, device ms on against off; the sweep's
    snapshots held to CPU engines' (a twin). profile: profile_kernel's
    variants at the bench shape (ms per iteration; the fixpoint kernel
    equal to its plain version). skiplist: the native engine's txn/s on one
    host core. rewarm: recovery_bench.run_rewarm, cold and warm warmup in
    two fresh processes on the card, goal_met as JAX computes it. cli: a
    session of TOOLS_CLI_LINES over a dynamic cluster with card resolvers
    and `cli status` in one-shot mode: every card call equal to a fresh
    oracle's replay, the text of every command but the engine views equal
    to the oracle-resolver twin's. fdbbackup: `restore` and `dr` with card
    resolvers (the tool's default): restore equal to the source, no
    acknowledged commit lost, the JSON equal to the oracle twin's.

    Returns (twin jobs, finish(twins))."""
    import tempfile

    from foundationdb_tpu_torch.tools import (floor_bench, heat_bench, ladder_bench,
                                              profile_kernel, recovery_bench, skiplist_bench)

    res, launches, walls = {}, {}, {}

    def path(name, fn, kernel=True):
        """fn() as one path, timed; its fixpoint launches where it runs
        the kernel (`kernel`)."""
        fc.FIXPOINT.reset_counts()
        t0 = time.perf_counter()
        out = fn()
        walls[name] = time.perf_counter() - t0
        if kernel:
            launches[f"tools_{name}"] = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
        check(fc.FIXPOINT.plain_cuda_calls == 0 or name == "profile",
              f"tools phase, {name}: a plain fixpoint ran on CUDA tensors")
        return out

    verdicts = []
    lad = path("ladder", lambda: ladder_bench.drive_bucket_ladder(
        cfg, list(TOOLS_LADDER), pool=POOL_KEYS, steady_rounds=TOOLS_LADDER_ROUNDS,
        seed=TOOLS_LADDER_SEED, verdicts=verdicts))
    check(lad["device"].startswith("cuda"), f"ladder drive ran on {lad['device']}")
    check(lad["steady_state_compiles"] == 0 and lad["steady_state_captures"] == 0,
          f"ladder drive: {lad['steady_state_compiles']} builds and "
          f"{lad['steady_state_captures']} captures after warmup")
    check(all(lad["scan_dispatches"].get(str(c)) for c in (1, 2)),
          f"ladder drive: scan dispatches {lad['scan_dispatches']}")
    res["ladder"] = lad
    print(f"tools phase, ladder [{card}]: {len(verdicts)} batches of {lad['driven_batch_sizes']} "
          f"x{lad['rounds']}, bucket hits {lad['bucket_hits']}, scans {lad['scan_dispatches']}, "
          f"warmup {lad['warmup_ms']} ms ({lad['compiles_warmup']} builds, "
          f"{lad['captures_warmup']} captures), 0 after; resolve "
          f"{lad['resolve_ms_per_batch']} ms/batch ({walls['ladder']:.1f} s)", flush=True)

    c512 = tools_cfg512(ck)
    floor = path("floor_sweep", lambda: floor_bench.run_floor_sweep(
        c512, scan_steps=TOOLS_FLOOR_STEPS))
    check(all(p["verdicts_equal"] for p in floor["points"]),
          "floor sweep: fused_sort and bsearch verdicts differ")
    check(floor["steady_state_compiles"] == {"fused_sort": 0, "bsearch": 0},
          f"floor sweep: captures after warmup {floor['steady_state_compiles']}")
    check(all(p["fused_sort_ms"] and p["bsearch_ms"] for p in floor["points"]),
          "floor sweep: a point was not timed")
    res["floor_sweep"] = floor
    apply_cfg = ck.KernelConfig(key_words=4, capacity=cfg.capacity, max_point_reads=1024,
                                max_point_writes=64, max_reads=64, max_writes=16, max_txns=512)
    app = path("apply_sweep", lambda: floor_bench.run_apply_sweep(
        apply_cfg, scan_steps=TOOLS_FLOOR_STEPS), kernel=False)
    check(app["steady_state_compiles"] == {"monolithic": 0, "tiered": 0},
          f"apply sweep: captures after warmup {app['steady_state_compiles']}")
    res["apply_sweep"] = app
    lf = path("loop_floor", lambda: floor_bench.run_loop_floor(c512, n_batches=32,
                                                               pool=POOL_KEYS // 4))
    check(lf["parity_ok"] and lf["loop_stats"]["blocking_syncs"] == 0,
          f"loop floor: parity {lf['parity_ok']}, {lf['loop_stats']['blocking_syncs']} blocking "
          f"syncs")
    res["loop_floor"] = lf
    print(f"tools phase, history floor [{card}]: T={floor['batch_txns']} H={floor['capacity']} "
          f"({floor['scan_steps']}-step programs): " + "; ".join(
              f"n={p['n']} fused_sort {p['fused_sort_ms']} / bsearch {p['bsearch_ms']} ms"
              for p in floor["points"]) + f", auto picks {floor['auto_pick']}; apply "
          + "; ".join(f"n={p['n']} monolithic {p['monolithic_ms']} / tiered {p['tiered_ms']} ms"
                      for p in app["points"])
          + f"; loop floor step {lf['step_host_ms_per_batch']} / loop "
          f"{lf['loop_host_ms_per_batch']} host ms/batch ({walls['floor_sweep']:.1f} + "
          f"{walls['apply_sweep']:.1f} + {walls['loop_floor']:.1f} s)", flush=True)

    heat = path("heat", lambda: heat_bench.run_conflict_heat(
        c512, pool=POOL_KEYS // 4, n_batches=24, overhead_scan_steps=TOOLS_HEAT_STEPS))
    over = heat["overhead"]
    check(heat["concentration_monotone"], "heat sweep: concentration does not rise with s: "
          + str([r["concentration"] for r in heat["sweep"]]))
    check(heat["parity_ok"], "heat sweep: heat on and heat off verdicts differ")
    check(heat["split"] and heat["split"]["ok"], f"heat sweep: split {heat['split']}")
    check(over["heat_on_ms"] and over["heat_off_ms"] and over["steady_state_compiles"] == 0,
          f"heat overhead: {over}")
    res["heat"] = heat
    print(f"tools phase, heat [{card}]: concentration "
          + ", ".join(f"s={r['s']} {r['concentration']}" for r in heat["sweep"])
          + f"; split max dev {heat['split']['max_dev_frac']}; device ms/batch heat off "
          f"{over['heat_off_ms']} / on {over['heat_on_ms']} ({over['overhead_pct']}% against a "
          f"{over['budget_pct']}% budget) ({walls['heat']:.1f} s)", flush=True)

    import io

    prof = path("profile", lambda: profile_kernel.run(
        list(TOOLS_PROFILE_VARIANTS), steps=TOOLS_PROFILE_STEPS, out=io.StringIO()))
    launches["tools_profile"] -= prof.info.get("compare_launches", 0)
    check(prof.info.get("fixpoint_equal") is True,
          "profile_kernel: the fixpoint kernel differs from its plain version")
    check(all(prof.ms.get(v) for v in TOOLS_PROFILE_VARIANTS) and prof.ms.get("fixpoint_plain"),
          f"profile_kernel: variants without a time {prof.ms}")
    res["profile"] = {"card": prof.card, "steps": prof.steps, "ms_per_iter": prof.ms,
                      **prof.info}
    print(f"tools phase, profile_kernel [{card}]: steady rows {prof.info['steady_rows']}, "
          + ", ".join(f"{k} {v:.4f}" for k, v in prof.ms.items())
          + f" ms/iter ({prof.steps}-step programs); fixpoint kernel equal to plain "
          f"({walls['profile']:.1f} s)", flush=True)

    sk = path("skiplist", lambda: skiplist_bench.run("native", batches=40, txns=1000,
                                                     pool=POOL_KEYS, seed=7), kernel=False)
    res["skiplist"] = sk
    print(f"tools phase, skiplist [{card}]: native engine {sk['txns_per_sec']} txn/s on one "
          f"host core ({walls['skiplist']:.1f} s)", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip-smoke-rewarm-") as td:
        rw = path("rewarm", lambda: recovery_bench.run_rewarm(os.path.join(td, "progcache")))
    check(rw is not None, "rewarm: a child process failed")
    check(rw["device"].startswith("cuda"), f"rewarm ran on {rw['device']}")
    check(rw["goal_met"] is False and rw["warm"]["hits"] == 0,
          "rewarm: a captured program came off disk")
    launches["tools_rewarm"] = rw["cold"]["fixpoint_launches"] + rw["warm"]["fixpoint_launches"]
    res["rewarm"] = rw
    print(f"tools phase, rewarm [{card}]: cold {rw['cold']['warmup_ms']} ms, warm "
          f"{rw['warm']['warmup_ms']} ms ({rw['warm']['captures']} graphs recaptured, "
          f"{rw['warm']['errors']} programs refused by the cache), speedup "
          f"{rw['rewarm_speedup']}, goal_met {rw['goal_met']} ({walls['rewarm']:.1f} s)",
          flush=True)

    from foundationdb_tpu_torch.tools import fdbbackup

    built = []
    texts = path("cli_session", lambda: cli_session(TOOLS_CLI_SEED, recording_engines(
        fdbbackup.engine_factory("torch", "cuda"), built)))
    cli_engines = card_engines_checked("cli session", fc, built)
    built = []
    rc, one_shot, launches["tools_cli_one_shot"] = recorded_tool_main(fc, "cli", ["status"],
                                                                      built)
    check(rc == 0 and "recovery state     - fully_recovered" in one_shot,
          f"cli status (one-shot): exit {rc}, {one_shot!r}")
    one_shot_engines = card_engines_checked("cli status (one-shot)", fc, built)
    check("flops None, bytes None" in texts["perf"] and "compiles - warmup" in texts["perf"],
          f"cli perf over card resolvers: {texts['perf']!r}")
    check("hot ranges" in texts["heat"], f"cli heat over card resolvers: {texts['heat']!r}")
    res["cli"] = {"texts": texts, "one_shot": one_shot, "engines": cli_engines,
                  "one_shot_engines": one_shot_engines}
    print(f"tools phase, cli [{card}]: {len(TOOLS_CLI_LINES)} commands over {cli_engines[0]} card "
          f"resolvers ({cli_engines[1]} calls), `status` one-shot over {one_shot_engines[0]} "
          f"({one_shot_engines[1]} calls), 0 replay mismatches ({walls['cli_session']:.1f} s)",
          flush=True)

    backups = {}
    for personality in ("restore", "dr"):
        built = []
        t0 = time.perf_counter()
        rc, text, launches[f"tools_fdbbackup_{personality}"] = recorded_tool_main(
            fc, "fdbbackup", [personality, "--seed", str(TOOLS_BACKUP_SEED)], built)
        out = json.loads(text.strip().splitlines()[-1])
        check(rc == 0 and out.get("verified") is True,
              f"fdbbackup {personality} on card resolvers: exit {rc}, {out}")
        engines = card_engines_checked(f"fdbbackup {personality}", fc, built)
        backups[personality] = {"out": out, "engines": engines,
                                "wall_s": time.perf_counter() - t0}
        print(f"tools phase, fdbbackup {personality} [{card}]: {out} over {engines[0]} card "
              f"resolvers ({engines[1]} calls), 0 replay mismatches "
              f"({backups[personality]['wall_s']:.1f} s)", flush=True)
    res["fdbbackup"] = backups
    for name, n in launches.items():
        check(n > 0, f"tools phase: {name} made no fixpoint launch")
    res["launches"] = launches
    res["wall_s"] = walls

    sizes = lad["driven_batch_sizes"]
    jobs = {("tools", "ladder"): (ladder_oracle_twin, sizes, POOL_KEYS, TOOLS_LADDER_ROUNDS,
                                  TOOLS_LADDER_SEED),
            ("tools", "heat"): (heat_cpu_twin, POOL_KEYS // 4, 24),
            ("tools", "cli"): (cli_session, TOOLS_CLI_SEED),
            ("tools", "cli_one_shot"): (tool_main, "cli", ["--engine", "oracle", "status"])}
    for personality in ("restore", "dr"):
        jobs[("tools", personality)] = (tool_main, "fdbbackup", [
            personality, "--seed", str(TOOLS_BACKUP_SEED), "--engine", "oracle"])

    def finish(twins):
        want = twins[("tools", "ladder")]
        bad = sum(a != b for a, b in zip(verdicts, want))
        check(len(verdicts) == len(want) and bad == 0,
              f"ladder drive: {bad} of {len(verdicts)} batches differ from the oracle")
        cpu = twins[("tools", "heat")]
        for got, ref in zip(heat["sweep"], cpu["sweep"]):
            check(got == ref, f"heat sweep s={got['s']}: the card's row differs from the CPU "
                  f"engines' ({got['concentration']} against {ref['concentration']})")
        check(heat["split"] == cpu["split"] and cpu["parity_ok"],
              "heat sweep: the card's split differs from the CPU engines'")
        twin_texts = twins[("tools", "cli")]
        for line in TOOLS_CLI_LINES:
            if line not in TOOLS_ENGINE_LINES:
                check(texts[line] == twin_texts[line],
                      f"cli {line!r}: the card-resolver text differs from the oracle twin's: "
                      f"{texts[line]!r} against {twin_texts[line]!r}")
        rc, twin_one_shot = twins[("tools", "cli_one_shot")]
        check(rc == 0 and one_shot == twin_one_shot,
              "cli status (one-shot): the card-resolver text differs from the oracle twin's")
        for personality, b in backups.items():
            rc, text = twins[("tools", personality)]
            twin = json.loads(text.strip().splitlines()[-1])
            check(rc == 0 and b["out"] == twin,
                  f"fdbbackup {personality}: card {b['out']} against oracle twin {twin}")
        print(f"tools phase [{card}]: the ladder's {len(verdicts)} batches equal the oracle, the "
              f"heat sweep equals CPU engines', the cli text and fdbbackup results equal their "
              f"oracle twins; launches {launches}", flush=True)
        return res

    return jobs, finish


#: the smokes that build card engines, in the order the phase runs them
CARD_SMOKES = ("heat", "history", "perf", "reshard", "mesh", "crash")


def recording_new_engines(he, built):
    """A context manager: every card engine built inside it is appended to
    `built` as its record_engine record (the engines a smoke builds for
    itself). A pipeline's columnar_pack / columnar_dispatch outside
    resolve() records too: the batch at dispatch, its verdicts when its
    force() returns. "partial" turns true where the table changed by a path
    the record misses (a plan packed while a resolve() ran, a load_state,
    serve()); a replay then skips the record."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        init = he._CardEngine.__init__

        def recording_init(self, *a, **kw):
            init(self, *a, **kw)
            if "resolve" in self.__dict__:
                return
            rec = record_engine(self)
            rec["partial"] = False

            def marking(fn):
                def call(*a, **kw):
                    rec["partial"] = rec["partial"] or not rec["resolving"]
                    return fn(*a, **kw)
                return call

            def packing(fn):
                def call(txns, now, new_oldest):
                    plan = fn(txns, now, new_oldest)
                    if plan is not None and not rec["resolving"]:
                        plan["recorded"] = (now, new_oldest, list(txns))
                    return plan
                return call

            def dispatching(fn):
                def call(plan):
                    force = fn(plan)
                    if rec["resolving"]:
                        return force
                    if "recorded" not in plan:
                        rec["partial"] = True
                        return force
                    entry = [*plan["recorded"], None]
                    rec["calls"].append(entry)

                    def recording_force():
                        verdicts = force()
                        entry[3] = [int(v) for v in verdicts]
                        return verdicts

                    return recording_force
                return call

            for attr, wrap in (("columnar_pack", packing), ("columnar_dispatch", dispatching),
                               ("load_state", marking), ("serve", marking)):
                if hasattr(self, attr):
                    setattr(self, attr, wrap(getattr(self, attr)))
            built.append(rec)

        he._CardEngine.__init__ = recording_init
        try:
            yield built
        finally:
            he._CardEngine.__init__ = init

    return ctx()


def smokes_phase(fc, he, card):
    """The six smokes that build card engines (CARD_SMOKES), each through
    its run(device="cuda"), the fixpoint counts (both entries) zeroed just
    before each and read just after: each must launch the kernel, mesh the
    stacked entry. Every check of a smoke is gated, but history's apply
    speedup (check 1: printed beside its 1.5x bar, reported, not gated).
    The heat and perf smokes hold no verdict to the oracle themselves:
    every resolve of their engines is recorded and replayed through a
    fresh oracle (a twin). The crash smoke's child is instrumented
    (crash_child_main): both boots on the card, launching the kernel.

    Returns (twin jobs, finish(twins))."""
    import importlib
    import tempfile

    from foundationdb_tpu_torch.real import nemesis

    res, launches, stacked, walls, recorded = {}, {}, {}, {}, {}
    for name in CARD_SMOKES:
        mod = importlib.import_module(f"foundationdb_tpu_torch.tools.{name}_smoke")
        clean_port_world()
        fc.FIXPOINT.reset_counts()
        fc.FIXPOINT_STACKED.reset_counts()
        built = []
        t0 = time.perf_counter()
        if name == "crash":
            with tempfile.TemporaryDirectory(prefix="chip-smoke-crash-") as td:
                report_path = os.path.join(td, "crash_child")
                argv_of = nemesis._crash_child_argv
                nemesis._crash_child_argv = instrumented_crash_child_argv(report_path)
                try:
                    out = mod.run("cuda", workdir=td)
                finally:
                    nemesis._crash_child_argv = argv_of
                children = crash_children_checked("crash smoke", report_path)
            launches[name] = sum(c["launches"] for c in children)
        else:
            with recording_new_engines(he, built):
                out = mod.run("cuda")
            launches[name] = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
            stacked[name] = fc.FIXPOINT_STACKED.launches + fc.FIXPOINT_STACKED.graph_launches
        walls[name] = time.perf_counter() - t0
        clean_port_world()
        out.pop("_group", None)
        out.pop("group", None)
        res[name] = out
        check(out["device"].startswith("cuda"), f"{name}_smoke ran on {out['device']}")
        gated = [f for f in out["failures"]
                 if not (name == "history" and f.startswith("apply_scaling:"))]
        check(not gated, f"{name}_smoke on the card: {gated}")
        check(fc.FIXPOINT.plain_cuda_calls == 0 and fc.FIXPOINT_STACKED.plain_cuda_calls == 0,
              f"{name}_smoke: a plain fixpoint ran on CUDA tensors")
        if name == "mesh":
            check(stacked[name] > 0, f"mesh_smoke: {stacked[name]} stacked fixpoint launches")
        else:
            check(launches[name] > 0, f"{name}_smoke: {launches[name]} fixpoint launches")
        if built:
            devices = {r["engine"].device.type for r in built}
            check(devices == {"cuda"}, f"{name}_smoke: engines on {devices}")
        if name in ("heat", "perf"):
            recorded[name] = [r["calls"] for r in built if r["calls"] and not r["partial"]
                              and all(c[0] == "clear" or c[3] is not None for c in r["calls"])]
            check(recorded[name], f"{name}_smoke: no engine resolved a batch")
        print(f"smokes phase, {name}_smoke [{card}]: ok {out['ok']}, fixpoint launches "
              f"{launches[name]}, stacked {stacked.get(name, 0)}"
              + (f", {len(built)} card engines" if built else "")
              + f" ({walls[name]:.1f} s)", flush=True)

    hist = res["history"]
    points = hist.get("apply_scaling") or {}
    print(f"smokes phase, history apply scaling [{card}]: "
          + "; ".join(f"capacity {cap}: monolithic {p['monolithic_ms']} / tiered "
                      f"{p['tiered_ms']} device ms per batch, speedup {p['tiered_speedup']}x"
                      for cap, p in points.items())
          + " against the 1.5x bar (reported, not gated)"
          + (f": {[f for f in hist['failures'] if f.startswith('apply_scaling:')]}"
             if not hist["ok"] else ""), flush=True)
    check(len(points) == 2 and all(p["tiered_speedup"] for p in points.values()),
          f"history_smoke: the apply sweep was not timed on the card: {points}")
    peaks = [b for b in res["perf"]["peak_bytes"] if b]
    print(f"smokes phase [{card}]: heat {res['heat']['split_points']['max_dev']:.4f} split "
          f"deviation; perf peak bytes {min(peaks, default=None)}-{max(peaks, default=None)}, "
          f"sampled/floor {res['perf']['sampled_over_floor']}; "
          f"reshard blackouts {[round(op['blackout_ms'], 2) for op in res['reshard']['ops']]} "
          f"ms against {res['reshard']['budget_ms']}; mesh {res['mesh']['mesh']}; crash "
          f"blackout {res['crash']['recovery']['blackout_ms']} ms against "
          f"{res['crash']['budget_ms']}", flush=True)
    res["launches"] = launches
    res["stacked_launches"] = stacked
    res["wall_s"] = walls

    jobs = {("smokes", name, i): (call_mismatches, calls)
            for name, streams in recorded.items() for i, calls in enumerate(streams)}

    def finish(twins):
        for name, streams in recorded.items():
            bad = sum(twins[("smokes", name, i)] for i in range(len(streams)))
            n = sum(len(c) for c in streams)
            check(bad == 0, f"{name}_smoke: {bad} of {n} card calls differ from the oracle's "
                  "replay")
            res[f"{name}_oracle_calls"] = n
        print(f"smokes phase [{card}]: the heat and perf smokes' "
              f"{res.get('heat_oracle_calls')} + {res.get('perf_oracle_calls')} card calls equal "
              f"a fresh oracle's replay; launches {launches}, stacked {stacked}", flush=True)
        return res

    return jobs, finish


TWIN_WORKERS = 6


def run_twins(jobs):
    """Each job {key: (fn, *args)} in TWIN_WORKERS spawn-context worker
    processes, submitted in the order given (the longest first): returns
    ({key: fn(*args)}, wall seconds)."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    t0 = time.perf_counter()
    with ProcessPoolExecutor(TWIN_WORKERS, mp_context=get_context("spawn")) as pool:
        futures = {key: pool.submit(fn, *args) for key, (fn, *args) in jobs.items()}
        results = {key: f.result() for key, f in futures.items()}
    return results, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this script measures the port on an NVIDIA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from foundationdb_tpu_torch.native import build
        from foundationdb_tpu_torch.ops import conflict_kernel as ck
        from foundationdb_tpu_torch.ops import device_loop as dl
        from foundationdb_tpu_torch.ops import fixpoint_cuda as fc
        from foundationdb_tpu_torch.ops import host_engine as he
        from foundationdb_tpu_torch.ops import oracle as oracle_mod
        from foundationdb_tpu_torch import pipeline as pl
    except ImportError as e:
        fail(f"foundationdb_tpu_torch is not importable next to this script ({e})")

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {json.dumps({k: round(v, 3) for k, v in built.items()})} "
          f"({time.perf_counter() - t0:.3f} s incl. checks)", flush=True)
    for line in build.build_log("fixpoint").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)

    rng = np.random.default_rng(SEED)
    cfg = bench_cfg(ck)
    engine_cfg = ck.KernelConfig()
    results = {"card": card, "seed": SEED}

    # the kernel at the bench shape, and at the shape the engine path gives
    # it (the default KernelConfig the engine phase runs)
    for label, kcfg, n_batches in (("bench", cfg, 40), ("engine", engine_cfg, 16)):
        t0 = time.perf_counter()
        kp = kernel_phase(ck, fc, kcfg, dev, rng, n_batches=n_batches)
        results[f"kernel_phase_{label}"] = kp
        print(f"kernel phase, {label} shape [{card}]: {kp['batches']} batches bit-equal, "
              f"{kp['commits']} commits / {kp['aborts']} aborts ({kp['history_hit_txns']} "
              f"history hits), rounds median {kp['rounds_median']} max {kp['rounds_max']}; "
              f"kernel_ms={kp['kernel_ms']:.4f} (call {kp['call_ms']:.4f}, empty batch "
              f"{kp['empty_ms']:.4f}) plain_ms={kp['plain_ms']:.4f} "
              f"bound_ms={kp['bound_ms']:.6f} ({kp['bound_by']}) at {kp['rounds_timed']} rounds "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    kb, kp = results["kernel_phase_bench"], results["kernel_phase_engine"]

    t0 = time.perf_counter()
    cp = chain_phase(ck, fc, cfg, dev)
    results["chain_phase"] = cp
    print(f"deep-chain phase, bench shape [{card}]: {CHAIN_TXNS} txns bit-equal, "
          f"{cp['rounds']} rounds, kernel_ms={cp['kernel_ms']:.4f} (call {cp['call_ms']:.4f}) "
          f"({cp['kernel_ms'] / cp['rounds'] * 1e3:.2f} us per round), "
          f"bound_ms={cp['bound_ms']:.6f} ({cp['bound_by']}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    sp = step_phase(ck, cfg, dev, rng, steps=300)
    results["step_phase"] = sp
    print(f"step phase [{card}]: {sp['steps']} resolve_steps, {sp['ms_per_batch']:.4f} ms/batch, "
          f"{sp['txn_per_s']:.0f} txn/s, table {sp['table_rows']} rows "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    pr = sp["profile"]
    print(f"step profile [{card}]: {pr['wall_ms_per_step']:.4f} ms wall/step under the profiler, "
          f"{pr['device_ms_per_step']:.4f} ms in {pr['kernels_per_step']:.0f} kernels/step, "
          f"device busy share {pr['device_busy_share']}", flush=True)
    for name, ms in pr["top"]:
        print(f"  {ms:.4f} ms/step  {name}", flush=True)

    t0 = time.perf_counter()
    traffic = byte_traffic(rng, ENGINE_SIZES)
    captured, ep, router_verdicts = engine_phase(fc, he, oracle_mod, dev, engine_cfg, traffic,
                                                 oracle_batches=4)
    results["engine_phase"] = ep
    print(f"engine phase [{card}]: {ep['txns']} txns in {ep['batches']} resolve() batches "
          f"match the CPU engine ({ep['oracle_batches']} also the oracle): "
          f"{ep['committed']} committed / {ep['conflict']} conflict / {ep['too_old']} too old; "
          f"{ep['launches']} kernel launches ({ep['graph_launches']} in graph replays, "
          f"{ep['eager_launches']} eager); card resolve {ep['card_resolve_s']:.3f} s "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    _, tp = replay_phase(ck, fc, engine_cfg, captured["state"],
                         ck.batch_from_numpy(engine_cfg, captured["arrays"], dev))
    results["engine_traffic"] = tp
    print(f"engine-traffic replay [{card}]: the engine's largest chunk ({tp['txns']} txns, "
          f"{tp['valid_point_reads']} + {tp['valid_range_reads']} valid read rows of "
          f"{engine_cfg.rp} + {engine_cfg.max_reads}, {tp['nonzero_edge_words']} nonzero edge "
          f"words) bit-equal, {tp['rounds']} rounds, kernel_ms={tp['kernel_ms']:.4f} "
          f"(call {tp['call_ms']:.4f}) bound_ms={tp['bound_ms']:.6f} ({tp['bound_by']}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    gp = graph_step_phase(ck, fc, he, cfg, dev, rng, units=40)
    results["graph_step_phase"] = gp
    print(f"graph-step phase, bench shape [{card}]: {gp['chunks']} batches in {gp['units']} "
          f"replays of a captured {gp['C']}-step scan equal the eager step's statuses; "
          f"graph {gp['graph_ms_per_batch'][0]:.4f} / {gp['graph_ms_per_batch'][1]:.4f} ms/batch "
          f"({gp['graph_txn_per_s']:.0f} txn/s) against eager "
          f"{gp['eager_ms_per_batch'][0]:.4f} / {gp['eager_ms_per_batch'][1]:.4f} ms/batch "
          f"({gp['eager_txn_per_s']:.0f} txn/s); {gp['fixpoint_launches_per_replay']:.0f} "
          f"fixpoint launches counted and {gp['fixpoint_kernels_per_replay_traced']:.0f} in the "
          f"card's trace, {gp['kernels_per_replay']:.0f} kernels per replay, "
          f"{gp['replay_host_ms']:.4f} ms of host time to launch one; capture "
          f"{gp['capture_s']:.2f} s ({time.perf_counter() - t0:.1f} s)", flush=True)
    for label in ("graph", "eager"):
        pr = gp[f"{label}_profile"]
        print(f"  {label} profile [{card}]: {pr['wall_ms']:.4f} ms wall/batch, "
              f"{pr['device_ms']:.4f} ms device/batch, device busy share "
              f"{pr['device_busy_share']}, {pr['kernels']:.0f} kernels per {GRAPH_C} batches",
              flush=True)

    t0 = time.perf_counter()
    batches = columnar_traffic(rng, COLUMNAR_SIZES, READ_ONLY)
    ora = oracle_mod.OracleConflictEngine()
    oracle_verdicts = []

    def oracle_ref(b, txns, now, oldest):
        if b == len(oracle_verdicts):
            oracle_verdicts.append([int(v) for v in ora.resolve(txns, now, oldest)])
        return oracle_verdicts[b]

    router = he.TorchConflictEngine(engine_cfg)
    router._resolve_columnar = lambda *a: None
    router.warmup(scan_sizes=())
    # the same ladder on the CPU: the same chunks, so the same heat
    # aggregates merge in the same order
    cpu_mono = he.TorchConflictEngine(engine_cfg, device="cpu", ladder=LADDER, scan_sizes=SCANS)
    eng, serial, colp = columnar_engine_phase(ck, fc, he, engine_cfg, batches, "monolithic", [
        ("the oracle", oracle_ref),
        ("the general router", lambda b, txns, now, oldest: [
            int(v) for v in router.resolve(txns, now, oldest)]),
        ("the CPU engine", lambda b, txns, now, oldest: [
            int(v) for v in cpu_mono.resolve(txns, now, oldest)])])
    check(eng.cfg.heat_buckets == 64, f"the default engine runs {eng.cfg.heat_buckets} heat buckets")
    heat_snap = eng.heat_snapshot()
    check(heat_snap == cpu_mono.heat_snapshot(),
          "the card engine's heat snapshot differs from the CPU engine's")
    check(heat_snap["hot_ranges"] and heat_snap["split_points"],
          "the heat snapshot holds no hot range or split point")
    colp["heat_snapshot"] = {k: heat_snap[k] for k in ("batches", "occupancy", "verdicts",
                                                       "concentration", "split_points")}
    del router, cpu_mono
    results["columnar_engine_phase"] = colp
    columnar_report(card, colp, "the oracle, the general router and the CPU engine (heat "
                    "snapshot too)", time.perf_counter() - t0)

    t0 = time.perf_counter()
    eng0, serial0, colp0 = columnar_engine_phase(ck, fc, he, engine_cfg, batches, "monolithic", [
        ("the heat-on card engine", lambda b, *_: serial[b])], heat_buckets=0)
    check(eng0.heat is None and eng0.heat_snapshot() is None, "heat_buckets=0 left heat on")
    results["columnar_engine_heat_off_phase"] = colp0
    columnar_report(card, colp0, "the heat-on card engine", time.perf_counter() - t0)
    print(f"  heat per one-chunk replay [{card}]: kernel ms on/off "
          + ", ".join(f"{k} {colp['program_device_ms'][k]:.4f}/{colp0['program_device_ms'][k]:.4f}"
                      for k in colp['program_device_ms'])
          + "; kernels on/off "
          + ", ".join(f"{k} {colp['program_kernels'][k]:.0f}/{colp0['program_kernels'][k]:.0f}"
                      for k in colp['program_kernels'])
          + f"; bytes back per top-bucket chunk {colp['d2h_chunk_bytes']}/{colp0['d2h_chunk_bytes']}",
          flush=True)

    t0 = time.perf_counter()
    cpu_tiered = he.TorchConflictEngine(engine_cfg, device="cpu", ladder=LADDER, scan_sizes=SCANS,
                                        history_structure="tiered")
    teng, tserial, tcol = columnar_engine_phase(ck, fc, he, engine_cfg, batches, "tiered", [
        ("the oracle", oracle_ref),
        ("the monolithic card engine", lambda b, *_: serial[b]),
        ("the CPU tiered engine", lambda b, txns, now, oldest: [
            int(v) for v in cpu_tiered.resolve(txns, now, oldest)])])
    check(teng.heat_snapshot() == cpu_tiered.heat_snapshot(),
          "the tiered card engine's heat snapshot differs from the CPU tiered engine's")
    check(teng.history_stats_snapshot() == cpu_tiered.history_stats_snapshot(),
          "the tiered card engine's history stats differ from the CPU tiered engine's")
    tcol["history_stats"] = teng.history_stats_snapshot()
    del cpu_tiered
    results["tiered_columnar_engine_phase"] = tcol
    columnar_report(card, tcol, "the oracle, the monolithic card engine and the CPU tiered "
                    "engine", time.perf_counter() - t0)
    print(f"  tiered merges [{card}]: {tcol['merges']} merges inside replays "
          f"({tcol['if_nodes']} IF nodes captured, no host read of the predicate); top one-chunk "
          f"program {tcol['top_program_append_ms']:.4f} ms in {tcol['top_program_append_kernels']:.0f} "
          f"kernels appending, {tcol['top_program_merge_ms']:.4f} ms in "
          f"{tcol['top_program_merge_kernels']:.0f} kernels merging; _merge_runs alone "
          f"({tcol['merge_rows']} run rows) {tcol['merge_ms']:.4f} ms", flush=True)

    # the device loop, both structures: verdicts and heat against the
    # columnar card engines' first passes
    t0 = time.perf_counter()
    leng, lserial, lp = loop_engine_phase(ck, fc, dl, engine_cfg, batches, "monolithic", [
        ("the oracle", oracle_ref), ("the columnar card engine", lambda b, *_: serial[b])])
    check(leng.heat_snapshot() == eng.heat_snapshot(),
          "the loop engine's heat snapshot differs from the columnar card engine's")
    results["device_loop_phase"] = lp
    loop_report(card, lp, "the oracle and the columnar card engine (heat snapshot too)",
                time.perf_counter() - t0)
    t0 = time.perf_counter()
    tleng, tlserial, tlp = loop_engine_phase(ck, fc, dl, engine_cfg, batches, "tiered", [
        ("the oracle", oracle_ref), ("the tiered columnar card engine", lambda b, *_: tserial[b])])
    check(tleng.heat_snapshot() == teng.heat_snapshot(),
          "the tiered loop engine's heat snapshot differs from the tiered columnar engine's")
    check(tleng.history_stats_snapshot() == teng.history_stats_snapshot(),
          "the tiered loop engine's history stats differ from the tiered columnar engine's")
    results["tiered_device_loop_phase"] = tlp
    loop_report(card, tlp, "the oracle and the tiered columnar card engine (heat snapshot and "
                "history stats too)", time.perf_counter() - t0)

    # every engine again, once more, in turns (their first passes ran in this
    # order above)
    t0 = time.perf_counter()
    engines = (("monolithic", eng, serial), ("monolithic_heat_off", eng0, serial0),
               ("tiered", teng, tserial), ("device_loop", leng, lserial),
               ("tiered_device_loop", tleng, tlserial))
    turns = {"monolithic": [colp], "monolithic_heat_off": [colp0], "tiered": [tcol],
             "device_loop": [lp], "tiered_device_loop": [tlp]}
    for label, e, sv in engines:
        turns[label].append(columnar_timing(e, batches, sv))
    fields = ("pack_ms_per_batch", "dispatch_ms_per_batch", "force_ms_per_batch", "txn_per_s",
              "enqueue_ms_per_batch", "decode_ms_per_batch")
    results["columnar_turns"] = {k: [{f: r[f] for f in fields if f in r} for r in v]
                                 for k, v in turns.items()}
    for label, runs in results["columnar_turns"].items():
        print(f"  columnar turns, {label} [{card}]: " + "; ".join(
            f"pack {r['pack_ms_per_batch']:.4f} dispatch {r['dispatch_ms_per_batch']:.4f} force "
            f"{r['force_ms_per_batch']:.4f} ms/batch"
            + (f" (enqueue {r['enqueue_ms_per_batch']:.4f}, decode {r['decode_ms_per_batch']:.4f})"
               if "enqueue_ms_per_batch" in r else "")
            + f", {r['txn_per_s']:.0f} txn/s" for r in runs)
            + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    _, tep, _ = engine_phase(fc, he, oracle_mod, dev, engine_cfg, traffic, oracle_batches=4,
                             structure="tiered", card_reference=router_verdicts)
    results["tiered_engine_phase"] = tep
    print(f"tiered engine phase [{card}]: {tep['txns']} txns in {tep['batches']} resolve() "
          f"batches match the monolithic card engine and the CPU tiered engine "
          f"({tep['oracle_batches']} also the oracle); {tep['merges']} merges; "
          f"{tep['launches']} kernel launches ({tep['graph_launches']} in graph replays, "
          f"{tep['eager_launches']} eager); card resolve {tep['card_resolve_s']:.3f} s "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    pp = pipeline_phase(fc, pl, eng, batches, serial)
    results["pipeline_phase"] = pp
    print(f"pipeline phase [{card}]: depth 1-3, inline and executor packing, all equal serial "
          f"resolve(): " + ", ".join(f"{k} " + " / ".join(f"{x:.0f}" for x in v["txn_per_s"])
                                     + " txn/s" for k, v in pp.items() if k != "launches")
          + f"; {pp['launches']} kernel launches ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    tpp = pipeline_phase(fc, pl, teng, batches, tserial, runs=1, executors=(0,))
    results["tiered_pipeline_phase"] = tpp
    print(f"tiered pipeline phase [{card}]: depth 1-3, inline packing, all equal serial "
          f"resolve(): " + ", ".join(f"{k} " + " / ".join(f"{x:.0f}" for x in v["txn_per_s"])
                                     + " txn/s" for k, v in tpp.items() if k != "launches")
          + f"; {tpp['launches']} kernel launches ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    drains0 = dict(leng.loop_stats)
    lpp = pipeline_phase(fc, pl, leng, batches, lserial, runs=1, executors=(0,))
    check(leng.loop_stats["blocking_syncs"] == 0, "the loop pipeline made a blocking sync")
    lpp["drains"] = {k: leng.loop_stats[k] - drains0[k]
                     for k in ("units", "drained_nonblocking", "forced_waits", "blocking_syncs")}
    results["device_loop_pipeline_phase"] = lpp
    print(f"device loop pipeline phase [{card}]: depth 1-3, inline packing, all equal serial "
          f"resolve(): " + ", ".join(f"{k} " + " / ".join(f"{x:.0f}" for x in v["txn_per_s"])
                                     + " txn/s" for k, v in lpp.items()
                                     if k not in ("launches", "drains"))
          + f"; {lpp['launches']} kernel launches; drains {lpp['drains']} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    tele, spp = telemetry_phases(ck, fc, he, dl, pl, oracle_mod, card, engine_cfg, batches, rng, {
        "columnar": (eng, serial, colp), "tiered_columnar": (teng, tserial, tcol),
        "device_loop": (leng, lserial, lp), "tiered_device_loop": (tleng, tlserial, tlp)})
    results["telemetry_phase"] = tele
    results["scheduled_pipeline_phase"] = spp

    # the resolver role in the simulator, its pipelined service fed the
    # card's own pack clocks and sampled device ms per bucket
    def sampled(key):
        return {int(b): ms for b, ms in tele[key]["sampled_device_ms_per_chunk"].items()}

    clocks = {"columnar": {"pack_ms_per_txn": colp["pack_ms_per_batch"] * colp["batches"]
                           / colp["txns"], "device_ms_by_bucket": sampled("columnar")},
              "device_loop": {"pack_ms_per_txn": lp["pack_ms_per_batch"] * lp["batches"]
                              / lp["txns"], "device_ms_by_bucket": sampled("device_loop"),
                              "queue_enqueue_ms": lp["enqueue_ms_per_batch"],
                              "result_drain_ms": lp["decode_ms_per_batch"]}}
    t0 = time.perf_counter()
    role = resolver_role_phase(fc, pl, card, {"columnar": eng, "device_loop": leng, "gen2": eng0},
                               clocks, rng)
    role["clocks"] = clocks
    results["resolver_role_phase"] = role
    print(f"resolver role phase [{card}]: {len(role['runs'])} runs, {role['oracle_replays']} "
          f"oracle replays, launches {role['launches']} ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    t0 = time.perf_counter()
    sup = supervised_role_phase(fc, pl, card, eng, clocks["columnar"], rng,
                                role["runs"]["depth2"]["wall_txn_per_s"])
    results["supervised_role_phase"] = sup
    print(f"supervised role phase [{card}]: {len(sup['runs'])} runs of {sup['batches']} batches, "
          f"{sup['oracle_replays']} oracle replays, launches {sup['launches']} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    crash = crash_recovery_phase(card)
    results["crash_recovery_phase"] = crash
    crash_launches = {k: crash[k]["launches"] + crash[k].get("recovery_launches", 0)
                      for k in ("A", "B")}
    print(f"crash recovery phase [{card}]: launches {crash_launches} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    # its batches (RESHARD_SIZES, at most 512 txns) are one chunk each, so
    # its engines capture no multi-chunk scan
    rs = reshard_phase(fc, card, rng, lambda: he.TorchConflictEngine(
        engine_cfg, ladder=LADDER, scan_sizes=(), history_structure="tiered",
        device_time_sample_rate=0.0))
    results["reshard_phase"] = rs
    print(f"reshard phase [{card}]: {len(rs['ops'])} reshards, {rs['launches']} launches "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # the static cluster with card resolvers, the harness fed the columnar
    # phase's one-chunk replay ms per bucket and its pack ms per txn
    t0 = time.perf_counter()
    cl_jobs, cl_finish = cluster_phase(fc, he, card, engine_cfg, {
        int(k.split("x")[0]): ms for k, ms in colp["program_device_ms"].items()
        if k.endswith("x1")}, clocks["columnar"]["pack_ms_per_txn"])
    print(f"cluster phase card runs [{card}] ({time.perf_counter() - t0:.1f} s)", flush=True)

    # the dynamic cluster: every resolver recruited in every generation a
    # card engine, the specs' KernelConfig in the specs, the bench's in
    # the recovery run
    t0 = time.perf_counter()
    dyn_jobs, dyn_finish = dynamic_cluster_phase(fc, he, ck, card, cfg)
    print(f"dynamic cluster phase card runs [{card}] ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # the bindings, a full-width backup and a DR switchover, every resolver
    # of every cluster a card engine
    t0 = time.perf_counter()
    bb_jobs, bb_finish = bindings_backup_phase(fc, he, card, cfg)
    print(f"bindings/backup phase card runs [{card}] ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # the wall-clock cluster and its campaigns: card resolvers in OS-process
    # nodes over TCP, the fault, crash and scenario campaigns on card engines
    t0 = time.perf_counter()
    clean_port_world()
    real = real_phase(fc, card)
    clean_port_world()
    real["wall_s"] = time.perf_counter() - t0
    results["real_phase"] = real
    print(f"real phase [{card}]: launches {real['launches']} ({real['wall_s']:.1f} s)",
          flush=True)

    # the sharded resolver: the stacked entry, the sub-sharded, sharded and
    # mesh engines, the TPU8 specs and a mesh campaign
    t0 = time.perf_counter()
    sh_jobs, sh_finish = sharded_phase(ck, fc, he, pl, card, dev, cfg, engine_cfg, batches,
                                       serial, oracle_ref, rng)
    print(f"sharded phase card runs [{card}] ({time.perf_counter() - t0:.1f} s)", flush=True)

    # the tools bench.py drives, profile_kernel, the CLI and fdbbackup
    t0 = time.perf_counter()
    tl_jobs, tl_finish = tools_phase(fc, he, ck, card, cfg)
    print(f"tools phase card runs [{card}] ({time.perf_counter() - t0:.1f} s)", flush=True)

    # the six smokes that build card engines, each through its run()
    t0 = time.perf_counter()
    sm_jobs, sm_finish = smokes_phase(fc, he, card)
    print(f"smokes phase card runs [{card}] ({time.perf_counter() - t0:.1f} s)", flush=True)

    # the phases' oracle and CPU twins, after the last card run, the longest
    # (the backup run's and the recovery run's) first
    twins, twin_s = run_twins({**bb_jobs, **dyn_jobs, **sh_jobs, **tl_jobs, **cl_jobs,
                               **sm_jobs})
    print(f"oracle twins [{card}]: {len(twins)} runs in {TWIN_WORKERS} workers after the last "
          f"card run ({twin_s:.1f} s)", flush=True)
    cl = cl_finish(twins)
    results["cluster_phase"] = cl
    print(f"cluster phase [{card}]: {len(cl['specs'])} spec runs and {len(cl['points'])} harness "
          f"points equal to their oracle twins, launches {cl['launches']}", flush=True)
    dyn = dyn_finish(twins)
    results["dynamic_cluster_phase"] = dyn
    print(f"dynamic cluster phase [{card}]: {len(dyn['specs'])} spec runs and the recovery run "
          f"equal to their oracle twins, launches {dyn['launches']}", flush=True)
    bb = bb_finish(twins)
    results["bindings_backup_phase"] = bb
    print(f"bindings/backup phase [{card}]: {len(bb['stacks'])} stack streams, the backup run "
          f"and the DR switchover equal to their oracle twins, launches {bb['launches']}",
          flush=True)
    sh = sh_finish(twins)
    results["sharded_phase"] = sh
    tl = tl_finish(twins)
    results["tools_phase"] = tl
    smk = sm_finish(twins)
    results["smokes_phase"] = smk
    results["twin_s"] = twin_s

    kernels = {"kernels": [{
        "name": "commit_fixpoint",
        "route": "cuda",
        "source": "foundationdb_tpu_torch/csrc/fixpoint.cu",
        "replaces": "foundationdb_tpu/ops/fixpoint_pallas.py:336",
        "launches": sum(r["launches"] for r in (ep, gp, colp, colp0, pp, tep, tcol, tpp, lp, tlp,
                                                lpp, *(tele[k] for k in TELEMETRY_ENGINES),
                                                tele["default_rate"], spp))
                    + sum(role["launches"].values()) + sum(sup["launches"].values())
                    + sum(crash_launches.values()) + rs["launches"]
                    + sum(cl["launches"].values()) + sum(dyn["launches"].values())
                    + sum(bb["launches"].values()) + sum(real["launches"].values())
                    + sum(sh["single_launches"].values()) + sum(tl["launches"].values())
                    + sum(smk["launches"].values()),
        "launches_by_path": {"engine_general_router_graph": ep["graph_launches"],
                             "engine_general_router_eager": ep["eager_launches"],
                             "graph_step": gp["launches"], "columnar_engine": colp["launches"],
                             "pipeline": pp["launches"],
                             "tiered_engine_general_router_graph": tep["graph_launches"],
                             "tiered_engine_general_router_eager": tep["eager_launches"],
                             "tiered_columnar_engine": tcol["launches"],
                             "tiered_pipeline": tpp["launches"],
                             "columnar_engine_heat_off": colp0["launches"],
                             "device_loop": lp["launches"],
                             "tiered_device_loop": tlp["launches"],
                             "device_loop_pipeline": lpp["launches"],
                             "telemetry_columnar": tele["columnar"]["launches"],
                             "telemetry_tiered_columnar": tele["tiered_columnar"]["launches"],
                             "telemetry_device_loop": tele["device_loop"]["launches"],
                             "telemetry_tiered_device_loop":
                                 tele["tiered_device_loop"]["launches"],
                             "telemetry_default_rate": tele["default_rate"]["launches"],
                             "scheduled_pipeline": spp["launches"], **role["launches"],
                             **{f"supervised_role_{k}": v for k, v in sup["launches"].items()},
                             **{f"crash_child_{k}": v for k, v in crash_launches.items()},
                             "reshard": rs["launches"], **cl["launches"],
                             **dyn["launches"], **bb["launches"], **real["launches"],
                             **sh["single_launches"], **tl["launches"],
                             **{f"smokes_{k}": v for k, v in smk["launches"].items()}},
        "mismatches": 0,
        "max_abs_err": 0,
        "ms": kp["kernel_ms"],
        "plain_ms": kp["plain_ms"],
        "bound_ms": kp["bound_ms"],
        "bound_by": kp["bound_by"],
        "library_ms": None,
        "rounds": kp["rounds_timed"],
        "bench_shape": {"ms": kb["kernel_ms"], "plain_ms": kb["plain_ms"],
                        "bound_ms": kb["bound_ms"], "rounds": kb["rounds_timed"]},
        "engine_traffic_ms": tp["kernel_ms"],
        "engine_traffic_rounds": tp["rounds"],
        "chain_ms": cp["kernel_ms"],
        "chain_rounds": cp["rounds"],
    }, {
        "name": "commit_fixpoint_stacked",
        "route": "cuda",
        "source": "foundationdb_tpu_torch/csrc/fixpoint.cu",
        "replaces": "foundationdb_tpu/ops/fixpoint_pallas.py:336",
        "launches": sum(sh["launches"].values()) + sum(smk["stacked_launches"].values()),
        "launches_by_path": {**sh["launches"],
                             **{f"smokes_{k}": v for k, v in smk["stacked_launches"].items()}},
        "mismatches": 0,
        "max_abs_err": 0,
        "ms": sh["kernel"][f"engine_S{SHARDED_S}"]["kernel_ms"],
        "plain_ms": sh["kernel"][f"engine_S{SHARDED_S}"]["plain_ms"],
        "bound_ms": sh["kernel"][f"engine_S{SHARDED_S}"]["bound_ms"],
        "bound_by": sh["kernel"][f"engine_S{SHARDED_S}"]["bound_by"],
        "library_ms": None,
        "S": SHARDED_S,
        "rounds": sh["kernel"][f"engine_S{SHARDED_S}"]["rounds_timed"],
        "bench_shape": {f"S{S}": {k: sh["kernel"][f"bench_S{S}"][k]
                                  for k in ("kernel_ms", "plain_ms", "bound_ms", "rounds_timed")}
                        for S in (1, 2, SHARDED_S)},
    }]}
    results.update(kernels)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
