"""Sub-sharded resolution on one card: S = 8 key-range sub-shards against
one table, on the same transaction stream.

    python -m foundationdb_tpu_torch.tools.sharded_bench [--device cuda]

Port of ``foundationdb_tpu/tools/sharded_bench.py``. The JAX bench ran an
8-shard mesh of virtual CPU devices against one engine to price the
sharded step's total compute; on the card the question is the one the
JAX package's sub-sharding answered for a TPU: do S small tables (S sorts
of N/S rows, 1/S-sized edge blocks) beat one big one? The engines here
are TorchConflictEngine (S = 1), SubshardedConflictEngine and
ShardedConflictEngine (S = 8), all at the bench's point-only shape
(2 point reads and 2 point writes a txn over a 4096-key pool), warmed up,
served through columnar_pack / columnar_dispatch / force in turns (s1, s8
sub-sharded, s8 sharded, twice), each checked against the oracle on its
first pass. Prints one JSON line with the card's name and power limit:
txn/s per engine and the ratios to s1. It runs on the card by default and
raises where there is none; `--device cpu` runs the same on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

T = 2048                    # txns a batch, the ladder's top bucket
POOL = 4096
N_BATCHES = 4
SEED = 7


def card_line(device) -> str:
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def point_stream(rng, n_batches: int, n_txns: int, pool: int):
    from ..core.types import CommitTransaction, KeyRange

    out = []
    for _ in range(n_batches):
        txns = []
        for _ in range(n_txns):
            t = CommitTransaction()
            for group in (t.read_conflict_ranges, t.read_conflict_ranges,
                          t.write_conflict_ranges, t.write_conflict_ranges):
                k = b"%06d" % rng.integers(0, pool)
                group.append(KeyRange(k, k + b"\x00"))
            txns.append(t)
        out.append(txns)
    return out


def serve(engine, streams, now: int, oracle=None):
    """Every batch through pack / dispatch / force; (txn/s, next version,
    mismatches against `oracle` where given)."""
    mism = total = 0
    t0 = time.perf_counter()
    for txns in streams:
        for tr in txns:
            tr.read_snapshot = now - T
        old = max(0, now - 8 * T)
        got = engine.columnar_dispatch(engine.columnar_pack(txns, now, old))()
        if oracle is not None:
            want = oracle.resolve(txns, now, old)
            mism += sum(int(a) != int(b) for a, b in zip(got, want))
        total += len(txns)
        now += T
    return total / (time.perf_counter() - t0), now, mism


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..core.keyshard import KeyShardMap
    from ..ops.conflict_kernel import KernelConfig
    from ..ops.host_engine import SubshardedConflictEngine, TorchConflictEngine
    from ..ops.oracle import OracleConflictEngine
    from ..parallel.sharding import ShardedConflictEngine

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("sharded_bench runs on the card and CUDA is not available; "
                           "pass --device cpu to run it on the CPU")
    cfg = KernelConfig(key_words=4, capacity=16384, max_point_reads=4096,
                       max_point_writes=4096, max_reads=32, max_writes=32, max_txns=T)
    splits = KeyShardMap([b"%06d" % ((POOL * i) // 8) for i in range(1, 8)])
    kw = dict(device=device, ladder=(), scan_sizes=(), heat_buckets=0,
              device_time_sample_rate=0.0)
    engines = {"s1": TorchConflictEngine(cfg, **kw),
               "s8_subsharded": SubshardedConflictEngine(cfg, splits, **kw),
               "s8_sharded": ShardedConflictEngine(cfg, splits, **kw)}
    streams = point_stream(np.random.default_rng(SEED), N_BATCHES, T, POOL)
    res = {"card": card_line(device), "device": str(device), "batch_txns": T,
           "txn_per_s": {k: [] for k in engines}, "mismatches": {}}
    for name, eng in engines.items():
        eng.warmup()
        _, _, res["mismatches"][name] = serve(eng, streams, 10 * T, OracleConflictEngine())
    now = 10 * T + N_BATCHES * T
    for _ in range(2):
        for name, eng in engines.items():
            rate, _, _ = serve(eng, streams, now)
            res["txn_per_s"][name].append(round(rate, 1))
        now += N_BATCHES * T
    best = {k: max(v) for k, v in res["txn_per_s"].items()}
    res["ratio_to_s1"] = {k: round(v / best["s1"], 3) for k, v in best.items() if k != "s1"}
    print(json.dumps(res))
    return 0 if not any(res["mismatches"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
