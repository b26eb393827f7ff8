"""Measured mesh resolution on one card: the mesh engine's split scan /
exchange units at N = 1, 2, 4, 8 shards, and its overlapped ring against
the serialized one.

    python -m foundationdb_tpu_torch.tools.mesh_bench [--device cuda]

Port of ``foundationdb_tpu/tools/mesh_bench.py``. The JAX bench timed a
psum chain over a mesh of XLA devices; the port keeps every shard of an
engine on one device, where the shards' planes are summed inside the
stacked fixpoint, so there is no collective to time apart. Instead:

  * `stacked_fixpoint_ms`: the CUDA kernel's stacked entry on the
    exchange's own inputs at each width (device ms per launch, CUDA
    events around launches queued behind a spin kernel);
  * `scaling`: per width, the mesh engine in SERIALIZED mode over the same
    point-txn stream, forced one batch behind (the ResolverPipeline's
    discipline): parity against the oracle on a first pass, then txn/s,
    the measured scan interval (dispatch to the scan program seen done)
    and exchange interval (scan done to the unit done) from the engine's
    own result-ring stamps on a timed pass;
  * `overlap_ab`: the widest engine overlapped against serialized on the
    same driver, in turns (serial, overlapped, overlapped, serial), with
    the overlapped engine's drains by kind (blocking_syncs must be 0).

Prints one JSON line with the card's name and power limit. It runs on the
card by default and raises where there is none; `--device cpu` runs the
same on the CPU (no kernel time there).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import deque

from .sharded_bench import card_line, point_stream

WIDTHS = (1, 2, 4, 8)
T = 512
POOL = 2048
N_BATCHES = 4
REPS = 3
SEED = 11


def kernel_ms(fn, calls: int = 20, samples: int = 5) -> float:
    """Device ms per call of `calls` calls queued behind a spin kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    spin = 10_000_000
    while len(times) < samples:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        ahead = not a.query()
        torch.cuda.synchronize()
        if ahead:
            times.append(a.elapsed_time(b) / calls)
        else:
            spin *= 2
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..core.keyshard import KeyShardMap
    from ..ops import conflict_kernel as ck
    from ..ops import fixpoint_cuda as fc
    from ..ops.conflict_kernel import KernelConfig
    from ..ops.oracle import OracleConflictEngine
    from ..parallel.mesh_engine import MeshShardedConflictEngine

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mesh_bench runs on the card and CUDA is not available; "
                           "pass --device cpu to run it on the CPU")
    cfg = KernelConfig(key_words=4, capacity=4096, max_point_reads=1152,
                       max_point_writes=1152, max_reads=8, max_writes=8, max_txns=T)
    streams = point_stream(np.random.default_rng(SEED), N_BATCHES, T, POOL)

    def make(n, overlap):
        return MeshShardedConflictEngine(
            cfg, KeyShardMap.uniform(n), devices=[device] * n, ladder=(), scan_sizes=(),
            overlap=overlap, heat_buckets=0, device_time_sample_rate=0.0).warmup()

    def run_pipelined(engine, reps, oracle=None):
        now, mism, checked = 1000, 0, 0

        def settle(force, want):
            nonlocal mism, checked
            got = force()
            if want is not None:
                checked += len(got)
                mism += sum(int(g) != int(w) for g, w in zip(got, want))

        for txns in streams:            # warm: fill the tables
            for tr in txns:
                tr.read_snapshot = now - T
            got = engine.resolve(txns, now, max(0, now - 200_000))
            if oracle is not None:
                settle(lambda: got, oracle.resolve(txns, now, max(0, now - 200_000)))
            now += T
        t0 = time.perf_counter()
        total, pending = 0, deque()
        for _ in range(reps):
            for txns in streams:
                for tr in txns:
                    tr.read_snapshot = now - T
                old = max(0, now - 200_000)
                plan = engine.columnar_pack(txns, now, old)
                want = oracle.resolve(txns, now, old) if oracle is not None else None
                force = engine.columnar_dispatch(plan)
                while len(pending) > 1:
                    settle(*pending.popleft())
                pending.append((force, want))
                now += T
                total += len(txns)
        while pending:
            settle(*pending.popleft())
        return total / (time.perf_counter() - t0), {"checked": checked, "mismatches": mism}

    res = {"card": card_line(device), "device": str(device), "batch_txns": T,
           "stacked_fixpoint_ms": {}, "scaling": {}}
    for n in WIDTHS:
        eng = make(n, overlap=False)
        _, parity = run_pipelined(eng, 1, OracleConflictEngine())
        for k in ("scan_ms_total", "exchange_ms_total", "timed_exchanges"):
            eng.mesh_stats[k] = 0
        rate, _ = run_pipelined(eng, REPS)
        ms = eng.mesh_stats
        timed = max(1, int(ms["timed_exchanges"]))
        res["scaling"][str(n)] = {
            "txn_per_s": round(rate, 1),
            "scan_ms": round(ms["scan_ms_total"] / timed, 4),
            "exchange_ms": round(ms["exchange_ms_total"] / timed, 4),
            "timed_batches": timed,
            "blocking_syncs": int(eng.loop_stats["blocking_syncs"]),
            "parity": parity,
        }
        if device.type == "cuda":
            # the stacked entry on the inputs of one exchange at this width
            scan, _ = eng._programs[(T, 1)]
            b = scan.batch()
            hist, edges, _ = scan.out
            res["stacked_fixpoint_ms"][str(n)] = round(kernel_ms(
                lambda: fc.commit_fixpoint_stacked_kernel(cfg, b["t_ok"][0], hist, edges, b)), 5)
        if parity["mismatches"]:
            print(json.dumps(res))
            return 1
    serial, over = make(WIDTHS[-1], overlap=False), make(WIDTHS[-1], overlap=True)
    rates = {"serial": [], "overlapped": []}
    for label, eng in (("serial", serial), ("overlapped", over), ("overlapped", over),
                       ("serial", serial)):
        rates[label].append(round(run_pipelined(eng, REPS)[0], 1))
    res["overlap_ab"] = {
        "overlapped_txn_per_s": rates["overlapped"], "serialized_txn_per_s": rates["serial"],
        "speedup": round(max(rates["overlapped"]) / max(rates["serial"]), 3),
        **{k: int(over.loop_stats[k]) for k in ("drained_nonblocking", "forced_waits",
                                                "blocking_syncs")}}
    print(json.dumps(res))
    return 0 if res["overlap_ab"]["blocking_syncs"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
