"""The `-r skiplisttest` analog (SkipList.cpp:1412-1502): drive the CPU
resolver engines with the reference self-benchmark's shape — randomized
batches over a hot key pool — and print transactions/sec.

Port of ``foundationdb_tpu/tools/skiplist_bench.py``.

    python -m foundationdb_tpu_torch.tools.skiplist_bench [--engine native|oracle]
        [--batches N] [--txns N]

The native C++ engine (ops/native_engine.py, built with ``c++`` at first
use) is the framework's CPU baseline; the card engine's throughput is
judged against the same transaction shape. Both engines run on one host
core, so the line it prints names the device "cpu". `--engine native`
raises where there is no C++ compiler: nothing falls back to the oracle.
"""
from __future__ import annotations

import argparse
import json
import time

from ..core.rng import DeterministicRandom
from ..core.types import CommitTransaction, KeyRange


def make_batches(n_batches: int, txns_per_batch: int, pool: int, seed: int):
    # the sanctioned entropy source (core/rng.py): bench reruns at the same
    # seed replay the exact stream, so a perf regression bisects against an
    # identical workload
    rng = DeterministicRandom(seed)
    keys = [b"sl/%08d" % i for i in range(pool)]
    batches = []
    version = 1000
    for _ in range(n_batches):
        version += txns_per_batch
        txns = []
        for _t in range(txns_per_batch):
            tr = CommitTransaction(read_snapshot=version - rng.random_int(1, 2000))
            for _ in range(2):
                k = keys[rng.random_int(0, pool)]
                tr.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            for _ in range(2):
                k = keys[rng.random_int(0, pool)]
                tr.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            txns.append(tr)
        batches.append((txns, version, max(0, version - 5_000_000)))
    return batches


def run(engine: str = "native", batches: int = 200, txns: int = 1000, pool: int = 8192,
        seed: int = 7) -> dict:
    """Resolve the stream on one host core; the result line main prints."""
    if engine == "native":
        from ..ops.native_engine import NativeConflictEngine

        eng = NativeConflictEngine()
    else:
        from ..ops.oracle import OracleConflictEngine

        eng = OracleConflictEngine()

    stream = make_batches(batches, txns, pool, seed)
    # warm (build/load, allocator)
    eng.resolve(*stream[0])
    t0 = time.perf_counter()
    committed = 0
    for b_txns, now, oldest in stream[1:]:
        for s in eng.resolve(b_txns, now, oldest):
            committed += int(s) == 2
    dt = time.perf_counter() - t0
    n = (len(stream) - 1) * txns
    return {
        "engine": eng.name,
        "device": "cpu",
        "txns_per_sec": round(n / dt),
        "batches_per_sec": round((len(stream) - 1) / dt, 1),
        "committed_fraction": round(committed / n, 4),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("native", "oracle"), default="native")
    ap.add_argument("--batches", type=int, default=200)
    ap.add_argument("--txns", type=int, default=1000)
    ap.add_argument("--pool", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.engine, args.batches, args.txns, args.pool, args.seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
