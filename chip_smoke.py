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
     included; its verdicts must equal the same engine on the CPU on every
     batch and OracleConflictEngine on the first batches. The launch counts
     are zeroed just before and read just after: the kernel must have run,
     and the plain version must never have seen a CUDA tensor. The packed
     arrays of the engine's largest chunk are recorded on the way (a wrapper
     around the engine's _batch, installed by this script) and replayed
     through local_phases and the kernel: the shape users' batches give the
     kernel, most rows padding.

It prints a `kernels` JSON line, the card line, and last
{"ok": true, "device": {...}}. Any failed check exits non-zero with no
result line; so does a machine without CUDA, or a directory holding this
file without the package.
"""
from __future__ import annotations

import argparse
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
    reads also hit history."""
    import torch

    T = cfg.max_txns
    gc = max(now - GC_LAG_BATCHES * T, 0)
    out = dict(batch, now=now, gc=gc)
    if rng is None:
        out["rp_snap"] = torch.full_like(batch["rp_snap"], max(now - T // 2, 0))
        out["r_snap"] = torch.full_like(batch["r_snap"], max(now - T // 2, 0))
    else:
        snap = torch.from_numpy(now - rng.integers(1, 2 * T, size=T)).to(
            batch["rp_snap"].device, torch.int32).clamp_(min=0)
        out["rp_snap"] = snap[batch["rp_txn"].long()]
        out["r_snap"] = snap[batch["r_txn"].long()]
    return out, now + T - gc


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
        state, _ = ck.resolve_step(cfg, state, batch)
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
        state, overflow, _ = ck.apply_writes_and_gc(cfg, state, batch, got, wpos)
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
            state, out = ck.resolve_step(cfg, state, batch)
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


def engine_phase(ck, fc, he, oracle_mod, dev, rng, cfg, sizes, oracle_batches: int):
    """The main path: resolve() on the card vs the same engine on the CPU
    (every batch) and the oracle (the first `oracle_batches` batches)."""
    import torch

    gpu = he.TorchConflictEngine(cfg) if dev.type == "cuda" else he.TorchConflictEngine(cfg, device=dev)
    cpu = he.TorchConflictEngine(cfg, device="cpu")
    # record the packed arrays (and the table they meet) of the largest
    # chunk. Inside the timed resolve, so it takes only references: t_ok is
    # the host array, and a step returns a new table without writing the old.
    captured = {"txns": -1}
    packed = gpu._batch

    def recording_batch(per_shard):
        batch = packed(per_shard)
        n = int(per_shard[0]["t_ok"].sum())
        if n > captured["txns"]:
            captured.update(txns=n, batch=batch, state=gpu.state)
        return batch

    gpu._batch = recording_batch
    ora = oracle_mod.OracleConflictEngine()
    now, oldest = 10_000, 0
    counts = [0, 0, 0]
    gpu_s = 0.0
    fc.FIXPOINT.reset_counts()
    for b, n in enumerate(sizes):
        now += 4096
        if b % 2:
            oldest = now - 2 * 4096
        txns = byte_txns(rng, n, now, long_frac=0.02 if b % 3 == 1 else 0.0)
        t0 = time.perf_counter()
        got = [int(v) for v in gpu.resolve(txns, now, oldest)]
        torch.cuda.synchronize()
        gpu_s += time.perf_counter() - t0
        want = [int(v) for v in cpu.resolve(txns, now, oldest)]
        check(got == want, f"engine batch {b}: card and CPU verdicts differ at "
              f"{sum(g != w for g, w in zip(got, want))} of {n} txns")
        if b < oracle_batches:
            ref = [int(v) for v in ora.resolve(txns, now, oldest)]
            check(got == ref, f"engine batch {b}: verdicts differ from the oracle")
        for v in got:
            counts[v] += 1
    launches, plain_cuda = fc.FIXPOINT.launches, fc.FIXPOINT.plain_cuda_calls
    check(launches > 0, "the engine path never launched the fixpoint kernel")
    check(plain_cuda == 0, "the engine path ran the plain fixpoint on CUDA tensors")
    check(gpu._tier_has_writes, "no long-key write reached the host tier")
    check(min(counts) > 0, f"verdict mix lacks a class: {counts}")
    return captured, {"batches": len(sizes), "txns": sum(sizes), "oracle_batches": oracle_batches,
            "launches": launches, "conflict": counts[0], "too_old": counts[1],
            "committed": counts[2], "card_resolve_s": gpu_s}


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
        from foundationdb_tpu_torch.ops import fixpoint_cuda as fc
        from foundationdb_tpu_torch.ops import host_engine as he
        from foundationdb_tpu_torch.ops import oracle as oracle_mod
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
    captured, ep = engine_phase(ck, fc, he, oracle_mod, dev, rng, engine_cfg,
                                sizes=[256, 384, 512, 512, 1500, 3000, 4500, 6000],
                                oracle_batches=4)
    results["engine_phase"] = ep
    print(f"engine phase [{card}]: {ep['txns']} txns in {ep['batches']} resolve() batches "
          f"match the CPU engine ({ep['oracle_batches']} also the oracle): "
          f"{ep['committed']} committed / {ep['conflict']} conflict / {ep['too_old']} too old; "
          f"{ep['launches']} kernel launches; card resolve {ep['card_resolve_s']:.3f} s "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    _, tp = replay_phase(ck, fc, engine_cfg, captured["state"], captured["batch"])
    results["engine_traffic"] = tp
    print(f"engine-traffic replay [{card}]: the engine's largest chunk ({tp['txns']} txns, "
          f"{tp['valid_point_reads']} + {tp['valid_range_reads']} valid read rows of "
          f"{engine_cfg.rp} + {engine_cfg.max_reads}, {tp['nonzero_edge_words']} nonzero edge "
          f"words) bit-equal, {tp['rounds']} rounds, kernel_ms={tp['kernel_ms']:.4f} "
          f"(call {tp['call_ms']:.4f}) bound_ms={tp['bound_ms']:.6f} ({tp['bound_by']}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    kernels = {"kernels": [{
        "name": "commit_fixpoint",
        "route": "cuda",
        "source": "foundationdb_tpu_torch/csrc/fixpoint.cu",
        "replaces": "foundationdb_tpu/ops/fixpoint_pallas.py:336",
        "launches": ep["launches"],
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
