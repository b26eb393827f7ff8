"""Bucket-ladder serving-path driver shared by bench.py's `bucket_ladder`
section and the bench smoke (tools/bench_smoke.py).

Port of ``foundationdb_tpu/tools/ladder_bench.py``.

Drives a warmed bucketed engine (ops/host_engine.py) with mixed-size
batches of point-conflict transactions — sizes straddling every bucket
boundary plus multi-chunk batches that exercise the fused chunk-scan
dispatch (on the card: one replay of the captured C-chunk scan graph,
where JAX ran a fused lax.scan) — and reports the engine's EnginePerf
counters: per-bucket chunk hits, fused-scan dispatch histogram, warmup
cost, and the compile count split into warmup vs steady state. A
"compile" in the port is a program build (`perf.compiles`), and on the
card each build captures CUDA graphs (`perf.captures`); both are split
the same way. A non-zero steady-state count means the serving path built
or captured a program the ladder was supposed to make impossible; the
bench smoke fails on it.

The engine runs on the card unless `device="cpu"` is passed (and raises
where there is no card); the result names its device.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np


def drive_batch_sizes(buckets: Sequence[int], top_chunks: int = 2) -> List[int]:
    """Mixed serving sizes: every bucket boundary straddled (k-1, k, k+1 —
    the k+1 batch selects the next bucket up, or for the top bucket splits
    into a second chunk) plus one multi-chunk batch (top_chunks full
    top-bucket chunks + a tail) that the engine must fuse into one scan
    dispatch."""
    sizes: List[int] = []
    for k in buckets:
        sizes.extend([k - 1, k, k + 1])
    top = max(buckets)
    sizes.append(top_chunks * top + max(1, top // 8))
    return sizes


def make_point_txns(n: int, pool: int, rng: np.random.Generator,
                    version: int, reads: int = 2, writes: int = 2):
    """n point-conflict transactions over a `pool`-key hot pool (the bench
    workload shape); all-point so the engine's columnar fast path packs
    them without per-range Python."""
    from ..core.types import CommitTransaction, KeyRange

    txns = []
    ks = rng.integers(0, pool, size=(n, reads + writes))
    for t in range(n):
        tr = CommitTransaction(read_snapshot=max(0, version - 50))
        for i in range(reads):
            k = b"lad/%08d" % ks[t, i]
            tr.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
        for i in range(writes):
            k = b"lad/%08d" % ks[t, reads + i]
            tr.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
        txns.append(tr)
    return txns


def ladder_stream(sizes: Sequence[int], pool: int, steady_rounds: int, seed: int):
    """The drive's batches in order, `steady_rounds` passes over `sizes`:
    (txns, version, new_oldest) each, from one rng of `seed`."""
    rng = np.random.default_rng(seed)
    version = 1_000
    for _ in range(steady_rounds):
        for n in sizes:
            txns = make_point_txns(n, pool, rng, version)
            version += max(64, n)
            yield txns, version, max(0, version - 100_000)


def drive_bucket_ladder(
    cfg,
    ladder: Sequence[int],
    *,
    pool: int = 4096,
    steady_rounds: int = 2,
    seed: int = 2026,
    scan_sizes: Sequence[int] = (2, 4, 8),
    oracle_check: bool = False,
    engine: Optional[object] = None,
    device=None,
    verdicts: Optional[list] = None,
) -> Dict:
    """Warm a bucketed TorchConflictEngine at `cfg` + `ladder` on `device`
    (None: the card), drive mixed batch sizes through the columnar serving
    path for `steady_rounds`, and return the `bucket_ladder` bench section.
    `oracle_check` additionally replays every batch through the CPU oracle
    and reports abort-set parity. `verdicts`, where given, collects every
    batch's verdicts (the cross-package twin's witness)."""
    from ..ops.host_engine import TorchConflictEngine
    from ..ops.oracle import OracleConflictEngine

    if engine is None:
        engine = TorchConflictEngine(cfg, ladder=ladder, scan_sizes=scan_sizes, device=device)
    engine.warmup()
    compiles_warmup = engine.perf.compiles
    captures_warmup = engine.perf.captures

    oracle = OracleConflictEngine() if oracle_check else None
    parity_ok = True
    sizes = drive_batch_sizes([b.max_txns for b in engine.buckets])
    host_ms = 0.0
    n_batches = 0
    for txns, version, new_oldest in ladder_stream(sizes, pool, steady_rounds, seed):
        t0 = time.perf_counter()
        got = engine.resolve(txns, version, new_oldest)
        host_ms += (time.perf_counter() - t0) * 1e3
        n_batches += 1
        if verdicts is not None:
            verdicts.append([int(x) for x in got])
        if oracle is not None:
            want = oracle.resolve(txns, version, new_oldest)
            if [int(x) for x in got] != [int(x) for x in want]:
                parity_ok = False
    steady_compiles = engine.perf.compiles - compiles_warmup

    out = {
        "device": str(engine.device),
        "ladder": [b.max_txns for b in engine.buckets],
        "scan_sizes": list(engine._scan_sizes),
        "warmup_ms": round(engine.perf.warmup_ms, 1),
        "compiles_warmup": compiles_warmup,
        #: the zero-steady-state-compiles claim, measured on the driven mix
        "steady_state_compiles": steady_compiles,
        "captures_warmup": captures_warmup,
        "steady_state_captures": engine.perf.captures - captures_warmup,
        "bucket_hits": {str(k): v
                        for k, v in sorted(engine.perf.bucket_hits.items())},
        "scan_dispatches": {str(k): v
                            for k, v in sorted(engine.perf.scan_dispatches.items())},
        "driven_batch_sizes": sizes,
        "rounds": steady_rounds,
        "resolve_ms_per_batch": round(host_ms / max(1, n_batches), 3),
        "arena_misses": engine.arena.misses if engine.arena is not None else None,
    }
    if oracle is not None:
        out["oracle_parity_ok"] = parity_ok
    return out


def main(argv=None) -> int:
    """bench.py's bucket_ladder section on the card (the bench's CFG, ladder
    512/1024/2048, an 8192-key pool), or at the bench smoke's toy shape
    with --device cpu; every batch checked against the oracle."""
    import argparse
    import json

    from ..ops.conflict_kernel import KernelConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        cfg = KernelConfig(key_words=4, capacity=2048, max_txns=128, max_point_reads=256,
                           max_point_writes=256, max_reads=32, max_writes=32)
        ladder, pool = [32, 64], 512
    else:
        cfg = KernelConfig(key_words=4, capacity=24576, max_point_reads=8192,
                           max_point_writes=8192, max_reads=256, max_writes=256, max_txns=4096)
        ladder, pool = [512, 1024, 2048], 8192
    out = drive_bucket_ladder(cfg, ladder, pool=pool, oracle_check=True, device=args.device)
    print(json.dumps({"metric": "bucket_ladder", **out}))
    ok = (out["oracle_parity_ok"] and out["steady_state_compiles"] == 0
          and out["steady_state_captures"] == 0)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
