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
     engine serves the traffic twice more, in turns (monolithic, heat off,
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
     off, default and on in turns, three times; then the columnar and loop
     engines' sampled intervals against a torch.profiler trace of the same
     pass: the kernels, copies and idle time inside them, and where the
     idle time sits;
  12. scheduled pipeline phase: ResolverPipeline at depth 2 with a
     BudgetBatcher and a ConflictScheduler built with resolver_sched "on",
     over skewed traffic (pre-aborts retried at a fresh snapshot): the
     dispatched journal replays equal through a CPU engine and the oracle.
  13. resolver role phase: the port's Resolver role (server/resolver.py) in
     the port's simulator (sim/), buggify on, over the warmed engines above,
     on the columnar traffic with versions MAX_WRITE_TRANSACTION_LIFE_VERSIONS
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
     engines (a spare prewarmed) in the simulator; the ReshardController
     splits the hot span and later merges it back, each under concurrent
     load, over skewed traffic (64 hot keys): every verdict equals one
     serial oracle's; run_slice since a watermark equals shadow_slice after
     coalesce. Each blackout beside reshard_blackout_budget_ms, the batch
     paths, launches per slot, device memory.

Each path's kernel launches are counted from 0 just before it and read
just after (a captured graph's fixpoint launches are counted at each
replay: FIXPOINT.graph_launches, n for a loop replay at fill n); a path
that launched none fails. The graph-step, columnar and loop phases also
read a replay's fixpoint kernels from the card's trace (torch.profiler):
C per C-step graph and n per loop replay at fill n, or they fail.

It prints a `kernels` JSON line, the card line, and last
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


def profile_window(run, units: int):
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
            fixpoints += FIXPOINT_KERNEL in e.name
    return {"wall_ms": wall_us / units / 1e3, "device_ms": busy_us / units / 1e3,
            "device_busy_share": busy_us / wall_us if busy_us else None,
            "kernels": launches / units, "fixpoint_kernels": fixpoints / units}


def traced_replays(run, units: int, fixpoints: int, what: str):
    """profile_window over `units` calls of a graph replay that must run
    `fixpoints` fixpoint kernels on the card each. A trace that shows more
    fails; one that shows fewer is taken again, up to 3 traces in all,
    since a trace can lose kernel events (see device_ms)."""
    for attempt in range(1, 4):
        pw = profile_window(run, units)
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


def serve(ck, fc, eng, batches, label, references):
    """Every point-only batch through columnar_pack / columnar_dispatch /
    force, the dispatch under sync debug mode "error" (a synchronizing call
    there fails the phase); verdicts against each of `references`, [(name,
    fn(b, txns, now, oldest) -> verdicts)], on every batch. Fails on a
    capture after warmup, a path without kernel launches or with the plain
    fixpoint on CUDA tensors, or a host read of the merge or loop
    condition. Returns (verdicts per batch, totals)."""
    import torch

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
        fc.FIXPOINT.reset_counts()
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
        launches += fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
        plain += fc.FIXPOINT.plain_cuda_calls
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


TELEMETRY_TURNS = 3
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
    in the port's simulator (drive_role) on the columnar traffic with its
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
    batches = columnar_traffic(rng, COLUMNAR_SIZES, READ_ONLY, step=role_version_step())
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


def supervised_stack(card_engine, rates, probe_rate, log):
    """ResilientEngine(FaultInjectingEngine(card_engine)) with its dispatch
    faults sorted by cause (`log["faults"]`: injected exception, watchdog,
    buggify, other), its health transitions and its rewarms (ms, captures,
    ok) logged. Built inside the run's simulator."""
    from foundationdb_tpu_torch.core import error
    from foundationdb_tpu_torch.fault import (FaultInjectingEngine, FaultRates, ResilienceConfig,
                                              ResilientEngine)

    inj = FaultInjectingEngine(card_engine, rates=FaultRates(**rates))
    stack = ResilientEngine(inj, ResilienceConfig(probe_rate=probe_rate, **SUPERVISOR))
    log.update(faults={"injected": 0, "watchdog": 0, "buggify": 0, "other": 0},
               transitions=[], rewarms=[], injector=inj)
    dispatch_once, set_state, rewarm = stack._dispatch_once, stack._set_state, stack._rewarm_device

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

    stack._dispatch_once, stack._set_state, stack._rewarm_device = (counted_dispatch, logged_state,
                                                                    timed_rewarm)
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

    # every engine again, twice, in turns (their first passes ran in this
    # order above)
    t0 = time.perf_counter()
    engines = (("monolithic", eng, serial), ("monolithic_heat_off", eng0, serial0),
               ("tiered", teng, tserial), ("device_loop", leng, lserial),
               ("tiered_device_loop", tleng, tlserial))
    turns = {"monolithic": [colp], "monolithic_heat_off": [colp0], "tiered": [tcol],
             "device_loop": [lp], "tiered_device_loop": [tlp]}
    for _ in range(2):
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
    rs = reshard_phase(fc, card, rng, lambda: he.TorchConflictEngine(
        engine_cfg, ladder=LADDER, scan_sizes=SCANS, history_structure="tiered",
        device_time_sample_rate=0.0))
    results["reshard_phase"] = rs
    print(f"reshard phase [{card}]: {len(rs['ops'])} reshards, {rs['launches']} launches "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    kernels = {"kernels": [{
        "name": "commit_fixpoint",
        "route": "cuda",
        "source": "foundationdb_tpu_torch/csrc/fixpoint.cu",
        "replaces": "foundationdb_tpu/ops/fixpoint_pallas.py:336",
        "launches": sum(r["launches"] for r in (ep, gp, colp, colp0, pp, tep, tcol, tpp, lp, tlp,
                                                lpp, *(tele[k] for k in TELEMETRY_ENGINES),
                                                tele["default_rate"], spp))
                    + sum(role["launches"].values()) + sum(sup["launches"].values())
                    + sum(crash_launches.values()) + rs["launches"],
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
                             "reshard": rs["launches"]},
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
