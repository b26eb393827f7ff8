"""Keyspace-heat bench driver (bench.py `conflict_heat` section;
docs/observability.md "Keyspace heat & occupancy").

Port of ``foundationdb_tpu/tools/heat_bench.py``.

Three proofs (the heat smoke drives the same code at toy sizes; bench.py
runs it at the 512-txn production point):

  1. SKEW TRACKING — a Zipf(s) workload fleet (seeded rank-Zipf over a
     hot pool, ranks mapped to keys through a seeded PERMUTATION so hot
     keys scatter across the keyspace like hashed production keys) drives
     a heat-on engine per s in {0, 0.9, 1.2}; the aggregator's measured
     hot-range concentration must increase with s.
  2. SPLIT PLANNING — at s = 0.9 the suggested equal-load split points
     must partition the measured write+conflict load within tolerance
     across the proposed shards.
  3. OVERHEAD + PARITY — device ms/batch with heat on vs off at the same
     shape (floor_bench's methodology: synthesized table, read-only
     batches, one captured graph of `scan_steps` steps per side, a warm
     replay first, CUDA events) must stay under the budget (< 3% at the
     production point), and the verdict streams of a heat-on and a
     heat-off engine over the IDENTICAL transaction stream must be
     bit-identical.

The engines run on the card unless `device="cpu"` is passed. On the CPU
the overhead's device ms are None (not measured), and so is its `ok`.

    python -m foundationdb_tpu_torch.tools.heat_bench [--device cpu]
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops import conflict_kernel as ck

#: CPU-sized default shape (the smoke); bench.py passes the 512 production
#: shape instead
SMOKE_CFG = ck.KernelConfig(key_words=4, capacity=4096, max_txns=128,
                            max_point_reads=512, max_point_writes=512,
                            max_reads=32, max_writes=32)
#: device-time overhead budget for heat-on vs heat-off (acceptance: < 3%
#: at the 512 production point)
OVERHEAD_BUDGET_PCT = 3.0


def zipf_ranks(n_keys: int, s: float, rng: np.random.Generator,
               size: int) -> np.ndarray:
    """`size` Zipf(s) ranks over 0..n_keys-1 (s = 0 -> uniform), inverse
    CDF like real/workload.zipf_cdf but vectorized."""
    if s <= 0:
        return rng.integers(0, n_keys, size=size)
    w = np.arange(1, n_keys + 1, dtype=np.float64) ** (-s)
    cdf = np.cumsum(w) / np.sum(w)
    return np.searchsorted(cdf, rng.random(size)).clip(0, n_keys - 1)


def zipf_point_txns(n: int, pool: int, s: float, rng: np.random.Generator,
                    version: int, perm: Optional[np.ndarray] = None,
                    reads: int = 2, writes: int = 2):
    """n point-conflict transactions whose keys are Zipf(s)-skewed over a
    `pool`-key space. `perm` maps rank -> key index (hot keys scatter like
    hashed production keys instead of clustering at the low end)."""
    from ..core.types import CommitTransaction, KeyRange

    if perm is None:
        perm = np.arange(pool)
    ranks = zipf_ranks(pool, s, rng, n * (reads + writes))
    ks = perm[ranks].reshape(n, reads + writes)
    txns = []
    for t in range(n):
        tr = CommitTransaction(read_snapshot=max(0, version - 50))
        for i in range(reads):
            k = b"heat/%08d" % ks[t, i]
            tr.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
        for i in range(writes):
            k = b"heat/%08d" % ks[t, reads + i]
            tr.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
        txns.append(tr)
    return txns


def drive_zipf_stream(engine, *, s: float, pool: int, n_batches: int,
                      seed: int = 2028,
                      perm: Optional[np.ndarray] = None) -> List[List[int]]:
    """Drive `n_batches` Zipf(s) batches through an engine; returns the
    verdict stream (the on/off parity witness)."""
    rng = np.random.default_rng(seed)
    if perm is None:
        perm = np.random.default_rng(seed + 1).permutation(pool)
    version = 1_000
    verdicts = []
    T = engine.cfg.max_txns
    for _ in range(n_batches):
        txns = zipf_point_txns(T, pool, s, rng, version, perm=perm)
        version += max(64, T)
        verdicts.append(
            [int(v) for v in engine.resolve(txns, version,
                                            max(0, version - 100_000))])
    return verdicts


def measure_heat_overhead(cfg: ck.KernelConfig, *, scan_steps: int = 64,
                          occupancy_frac: float = 0.5, reps: int = 8,
                          heat_buckets: int = 64, seed: int = 2029,
                          device=None) -> Dict:
    """Device ms/batch for `cfg` with heat off vs on, floor_bench's
    methodology (synthesized table at fixed occupancy, read-only batches
    so every timed step runs at the same state, one captured program per
    side, warm first). Both programs are built and warmed up front, then
    timed INTERLEAVED with min-over-reps per side, so both sides see the
    same noise environment."""
    from .floor_bench import (ScanProgram, _CompileCounter, _read_batch, _table_state,
                              bench_device)
    from .sharded_bench import card_line

    dev = bench_device(device)
    rng = np.random.default_rng(seed)
    n = max(1, int(occupancy_frac * cfg.capacity))
    batch = ck.batch_from_numpy(cfg, _read_batch(cfg, rng, n), dev)
    runs = {}
    for label, hb in (("heat_off", 0), ("heat_on", heat_buckets)):
        mcfg = dataclasses.replace(cfg, heat_buckets=hb)

        def step(st, _i, _cfg=mcfg, _batch=batch):
            st, o = ck.resolve_step(_cfg, st, _batch, False)
            return st, o["n"]

        prog = ScanProgram(step, _table_state(cfg, n, dev), scan_steps)
        prog.run()                     # warm: the first replay
        runs[label] = prog
    counter = _CompileCounter()
    best: Dict[str, Optional[float]] = {label: None for label in runs}
    for _ in range(reps):
        for label, prog in runs.items():
            ms = prog.run()
            if ms is not None:
                per = ms / scan_steps
                best[label] = per if best[label] is None else min(best[label], per)
    compiles = counter.close()
    off, on = best["heat_off"], best["heat_on"]
    pct = (on - off) / off * 100 if off else None
    return {
        "card": card_line(dev),
        "device": str(dev),
        "batch_txns": cfg.max_txns,
        "capacity": cfg.capacity,
        "heat_buckets": heat_buckets,
        "scan_steps": scan_steps,
        "heat_off_ms": None if off is None else round(off, 4),
        "heat_on_ms": None if on is None else round(on, 4),
        "overhead_pct": None if pct is None else round(pct, 2),
        "budget_pct": OVERHEAD_BUDGET_PCT,
        "ok": None if pct is None else pct < OVERHEAD_BUDGET_PCT,
        #: post-warmup captures across the whole timed phase (both modes)
        "steady_state_compiles": compiles,
    }


def run_conflict_heat(
    cfg: Optional[ck.KernelConfig] = None,
    *,
    skews: Sequence[float] = (0.0, 0.9, 1.2),
    n_batches: int = 24,
    pool: int = 2048,
    heat_buckets: int = 64,
    split_tolerance: float = 0.2,
    overhead_scan_steps: int = 128,
    seed: int = 2028,
    device=None,
    overhead: bool = True,
) -> Dict:
    """The `conflict_heat` bench section. Returns skew sweep (measured
    concentration per Zipf s), split-point balance at s = 0.9, the
    heat-on/off overhead measurement (`overhead=False` leaves it out), and
    the on/off abort-set parity witness."""
    from ..ops.host_engine import TorchConflictEngine

    cfg = cfg or SMOKE_CFG
    perm = np.random.default_rng(seed + 1).permutation(pool)
    sweep = []
    split = None
    parity_ok = True
    for s in skews:
        eng = TorchConflictEngine(cfg, heat_buckets=heat_buckets, device=device)
        eng.warmup()
        got = drive_zipf_stream(eng, s=s, pool=pool, n_batches=n_batches,
                                seed=seed, perm=perm)
        agg = eng.heat
        counts = agg.verdict_totals
        done = counts["committed"] + counts["conflicts"] + counts["too_old"]
        row = {
            "s": s,
            "concentration": round(agg.concentration(), 4),
            "top_share": round(agg.hot_ranges(top_n=1)[0]["share"], 4),
            "abort_frac": round(counts["conflicts"] / max(1, done), 4),
            "occupancy_frac": round(agg.occupancy_frac(), 4),
            "gc_reclaimed": agg.gc_reclaimed_total,
        }
        if abs(s - 0.9) < 1e-9:
            # the acceptance split check + the report `cli heat` renders
            shards = 8
            balance = agg.split_balance(shards)
            mean = 1.0 / shards
            max_dev = (max(abs(f - mean) for f in balance) / mean
                       if balance else float("inf"))
            split = {
                "s": s,
                "shards": shards,
                "split_points": [k.decode("latin-1")
                                 for k in agg.split_points(shards)],
                "balance": [round(f, 4) for f in balance],
                "max_dev_frac": round(max_dev, 4),
                "tolerance": split_tolerance,
                "ok": max_dev <= split_tolerance,
            }
            row["heat"] = agg.snapshot()
            # on/off abort-set parity over the identical stream (the
            # bit-identical witness in the artifact)
            eng_off = TorchConflictEngine(cfg, heat_buckets=0, device=device)
            eng_off.warmup()
            want = drive_zipf_stream(eng_off, s=s, pool=pool,
                                     n_batches=n_batches, seed=seed,
                                     perm=perm)
            parity_ok = parity_ok and (got == want)
        sweep.append(row)
    conc = [r["concentration"] for r in sweep]
    over = (measure_heat_overhead(cfg, scan_steps=overhead_scan_steps,
                                  heat_buckets=heat_buckets, device=device)
            if overhead else None)
    return {
        "device": str(eng.device),
        "heat_buckets": heat_buckets,
        "pool": pool,
        "n_batches": n_batches,
        "batch_txns": cfg.max_txns,
        "sweep": sweep,
        #: the acceptance monotonicity: concentration tracks the fleet's s
        "concentration_monotone": all(a < b for a, b in zip(conc, conc[1:])),
        "split": split,
        "overhead": over,
        "parity_ok": parity_ok,
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_conflict_heat(device=args.device)
    print(json.dumps({"metric": "conflict_heat", **out}))
    ok = (out["concentration_monotone"] and out["parity_ok"]
          and out["overhead"]["ok"] is not False
          and (out["split"] or {}).get("ok", False))
    return 0 if ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
