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


def columnar_traffic(rng, sizes, read_only):
    """Point-only CommitTransactions (bench.py:46-49): 2 point reads and 2
    point writes per txn over one hot pool of POOL_KEYS 16-byte keys, with
    batches of `read_only` ({position: txns}) holding the reads alone.
    Versions advance VERSION_STEP a batch; the GC horizon trails by
    GC_LAG_BATCHES batches, and ~3% of snapshots lie behind it (too old).
    Each txn's wire block is encoded here, as a client encodes its commit
    request once: the timed pack is the resolver's."""
    from foundationdb_tpu_torch.core.types import CommitTransaction, KeyRange

    plan = [(n, False) for n in sizes]
    for pos in sorted(read_only):
        plan.insert(pos, (read_only[pos], True))
    out, now = [], 10_000
    for b, (n, reads_only) in enumerate(plan):
        now += VERSION_STEP
        oldest = max(0, now - GC_LAG_BATCHES * VERSION_STEP)
        lag = rng.integers(1, 2 * VERSION_STEP, size=n)
        old = rng.random(n) < 0.03
        lag[old] = rng.integers((GC_LAG_BATCHES + 1) * VERSION_STEP,
                                (GC_LAG_BATCHES + 2) * VERSION_STEP, size=int(old.sum()))
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
    64), warmed up; every point-only batch through serve(). Tiered:
    warmup() captures one IF node per step, merges run inside replays (at
    least twice) and the merge predicate is never read on the host."""
    import torch

    eng = he.TorchConflictEngine(cfg, ladder=LADDER, scan_sizes=SCANS,
                                 history_structure=structure, heat_buckets=heat_buckets)
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
    history structure and the default heat, warmed up: 2 graphs per bucket,
    each with one WHILE node (and under the tiered structure 2 IF nodes,
    one nested in the WHILE body); every point-only batch through serve(),
    no blocking sync. Then the top bucket's program alone: the card's trace
    must show one fixpoint kernel per filled chunk of a replay, at fill 1
    and fill Q; kernel ms per replay at each fill."""
    import torch

    eng = dl.DeviceLoopEngine(cfg, ladder=LADDER, history_structure=structure)
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

    def recording(bucket, per_chunks, packs=None):
        fills.append(len(per_chunks))
        return dispatch(bucket, per_chunks, packs)

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

    kernels = {"kernels": [{
        "name": "commit_fixpoint",
        "route": "cuda",
        "source": "foundationdb_tpu_torch/csrc/fixpoint.cu",
        "replaces": "foundationdb_tpu/ops/fixpoint_pallas.py:336",
        "launches": sum(r["launches"] for r in (ep, gp, colp, colp0, pp, tep, tcol, tpp, lp, tlp,
                                                lpp)),
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
                             "device_loop_pipeline": lpp["launches"]},
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
