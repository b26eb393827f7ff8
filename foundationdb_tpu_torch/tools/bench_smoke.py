"""Bench smoke: a mini perf-path check at toy sizes, seconds not
minutes, so perf wiring breaks loudly rather than only in the full bench.

Port of ``foundationdb_tpu/tools/bench_smoke.py``. It runs on the card
unless given `--device cpu`:

    python -m foundationdb_tpu_torch.tools.bench_smoke [--device cpu]

Runs the same code paths as bench.py's perf sections at toy sizes:

  * bucket_ladder — a warmed 3-bucket TorchConflictEngine driven with
    batch sizes straddling every bucket boundary (tools/ladder_bench.py),
    abort sets replayed through the CPU oracle, and the program builds and
    graph captures asserted flat in steady state;
  * latency_under_load — a mini latency curve through the e2e sim
    cluster (pipeline/latency_harness.py) with INJECTED device times and
    a per-bucket ladder table, production point filtered by the
    resolver_p99_budget_ms knob;
  * history_floor — the occupancy sweep of tools/floor_bench.py at toy
    sizes, asserting ZERO post-warmup captures for BOTH history-search
    modes (docs/perf.md "History search modes") and cross-mode abort-set
    parity on a driven batch stream;
  * device_loop — the device-resident loop engine (ops/device_loop.py)
    driven against step dispatch over identical streams: loop-vs-step
    abort-set parity canary, ZERO post-warmup builds and captures (one
    loop program per bucket), and the zero-blocking-sync assertion via the
    loop's sync-counting shim
    (`loop_stats`: blocking_syncs == 0, the pipelined drive drains the
    result ring entirely through the non-blocking poll), plus the
    loop_floor step-vs-loop host-time comparison at toy size.

Prints one JSON line naming its device; any failed check exits
non-zero. Timings are not asserted — this checks wiring, parity, and the
zero-recompile claim, not speed.
"""
from __future__ import annotations

import json
import sys


def run(device: str = "cuda") -> dict:
    """Every check; the result line main prints."""
    from ..ops import conflict_kernel as ck
    from ..pipeline.latency_harness import p99_budget_ms, run_latency_under_load
    from .floor_bench import bench_device
    from .ladder_bench import drive_bucket_ladder

    dev = bench_device(device)
    failures = []

    cfg = ck.KernelConfig(key_words=4, capacity=2048, max_txns=128,
                          max_point_reads=256, max_point_writes=256,
                          max_reads=32, max_writes=32)
    # scan_sizes (2,): one fused size keeps the smoke's warmup to 6
    # compiles (~half the default ladder) while still proving the fused
    # dispatch path end to end
    ladder = drive_bucket_ladder(cfg, [32, 64], pool=512, steady_rounds=2,
                                 scan_sizes=(2,), oracle_check=True, device=dev)
    if ladder["steady_state_compiles"] != 0:
        failures.append(
            f"steady_state_compiles={ladder['steady_state_compiles']} != 0")
    if ladder["steady_state_captures"] != 0:
        failures.append(
            f"steady_state_captures={ladder['steady_state_captures']} != 0")
    if not ladder["oracle_parity_ok"]:
        failures.append("abort-set parity vs CPU oracle failed")
    if not ladder["scan_dispatches"].get("2"):
        failures.append("multi-chunk batch never took a fused-scan dispatch")

    # History-search floor (docs/perf.md): both modes warmed, then timed
    # with the capture counter listening — any post-warmup capture fails
    # the smoke. Timings are not asserted; the wiring and the
    # zero-recapture claim are.
    from .floor_bench import run_floor_sweep

    floor = run_floor_sweep(occupancy_fracs=(0.25, 0.75), scan_steps=24, device=dev)
    for mode, cnt in sorted(floor["steady_state_compiles"].items()):
        if cnt:
            failures.append(
                f"history_floor {mode}: {cnt} post-warmup captures")
    if not all(p["verdicts_equal"] for p in floor["points"]):
        failures.append("history_floor: fused_sort and bsearch verdicts differ")
    if floor["auto_pick"] != "bsearch":
        failures.append(
            f"history_floor: auto picked {floor['auto_pick']} for a batch "
            "far under capacity (expected bsearch)")
    # cross-mode abort-set parity on a driven engine stream (the tier-1
    # suite covers this broadly; the smoke keeps a canary in CI's quick lane)
    import numpy as np

    from ..ops.host_engine import TorchConflictEngine
    from .ladder_bench import make_point_txns

    engines = {m: TorchConflictEngine(cfg, history_search=m, device=dev)
               for m in ("fused_sort", "bsearch")}
    rng = np.random.default_rng(11)
    version = 500
    for n in (16, 64, 128):
        txns = make_point_txns(n, 256, rng, version)
        version += 200
        got = {m: [int(x) for x in e.resolve(txns, version, version - 400)]
               for m, e in engines.items()}
        if got["fused_sort"] != got["bsearch"]:
            failures.append(f"history-search cross-mode mismatch at n={n}")
            break

    # Device-resident loop (docs/perf.md "Device-resident loop"): loop
    # engine vs step engine over the identical mixed-size stream. Warmup
    # builds one loop program per bucket; the steady drive then runs under
    # the capture counter — any capture is a rebuild the loop programs
    # were supposed to make impossible.
    from ..ops.device_loop import DeviceLoopEngine
    from ..pipeline.resolver_pipeline import ResolverPipeline
    from .floor_bench import _CompileCounter, run_loop_floor

    loop_eng = DeviceLoopEngine(cfg, ladder=[32, 64], device=dev).warmup()
    step_eng = TorchConflictEngine(cfg, ladder=[32, 64], scan_sizes=(), device=dev).warmup()
    loop_builds = loop_eng.perf.compiles
    counter = _CompileCounter()
    version = 5_000
    loop_parity = True
    for _ in range(2):
        for n in (16, 31, 32, 33, 63, 64, 65, 128, 290):
            txns = make_point_txns(n, 256, rng, version)
            version += max(64, n)
            new_oldest = max(0, version - 100_000)
            got = [int(x) for x in loop_eng.resolve(txns, version, new_oldest)]
            want = [int(x) for x in step_eng.resolve(txns, version, new_oldest)]
            if got != want:
                loop_parity = False
    steady_compiles = counter.close() + loop_eng.perf.compiles - loop_builds
    if steady_compiles:
        failures.append(
            f"device_loop: {steady_compiles} post-warmup builds and captures")
    if not loop_parity:
        failures.append("device_loop: loop-vs-step abort-set mismatch")
    if loop_eng.perf.compiles != len(loop_eng.buckets):
        failures.append(
            f"device_loop: {loop_eng.perf.compiles} loop bodies for "
            f"{len(loop_eng.buckets)} buckets (want one per bucket)")
    # pipelined drive: the whole result ring must drain through the
    # NON-BLOCKING poll (steady-state zero-host-sync claim) — blocking
    # syncs are never acceptable, in any phase
    import time as _time

    pipe = ResolverPipeline(loop_eng, depth=3)
    handles = []
    for _ in range(8):
        txns = make_point_txns(64, 256, rng, version)
        version += 128
        handles.append(pipe.submit(txns, version, max(0, version - 100_000)))
    deadline = _time.perf_counter() + 30.0
    while loop_eng._ring and _time.perf_counter() < deadline:
        loop_eng.poll()
        _time.sleep(0.002)
    if loop_eng._ring:
        failures.append("device_loop: result ring never drained via poll()")
    for h in handles:
        h.result()
    if loop_eng.loop_stats["blocking_syncs"]:
        failures.append(
            f"device_loop: {loop_eng.loop_stats['blocking_syncs']} blocking "
            "host syncs (want 0)")
    if not loop_eng.loop_stats["drained_nonblocking"]:
        failures.append("device_loop: nothing drained non-blockingly")
    loop_floor = run_loop_floor(
        ck.KernelConfig(key_words=4, capacity=2048, max_txns=128,
                        max_point_reads=256, max_point_writes=256,
                        max_reads=32, max_writes=32),
        n_batches=8, pool=256, device=dev)
    if not loop_floor["parity_ok"]:
        failures.append("loop_floor: loop-vs-step abort-set mismatch")
    if loop_floor["loop_stats"]["blocking_syncs"]:
        failures.append("loop_floor: blocking host syncs in the loop drive")
    device_loop = {
        "steady_state_compiles": steady_compiles,
        "loop_bodies_compiled": loop_eng.perf.compiles,
        "buckets": [b.max_txns for b in loop_eng.buckets],
        "parity_ok": loop_parity,
        "loop_stats": dict(loop_eng.loop_stats),
        "dispatch_mode_hits": dict(loop_eng.perf.dispatch_mode_hits),
        "loop_floor": loop_floor,
    }

    # Mini latency curve: injected service times (the harness's time model
    # is virtual), bucket table + budget knob exactly as bench.py wires
    # them. Offered load near each shape's device-paced capacity.
    budget = p99_budget_ms()
    dev_by_bucket = {64: 0.45, 128: 0.8}
    points = []
    for T, depth in ((64, 1), (64, 2), (128, 2)):
        r = run_latency_under_load(
            depth=depth, batch_txns=T, device_ms=dev_by_bucket[T],
            pack_ms_per_txn=0.0006,
            offered_txns_per_sec=0.9 * T / (dev_by_bucket[T] / 1e3),
            n_txns=1_200,
            device_ms_by_bucket=dev_by_bucket, budget_ms=budget,
        )
        d = r.as_dict()
        points.append(d)
        if d["errors"]:
            failures.append(f"harness point depth={depth} T={T}: "
                            f"{d['errors']} transport/cluster errors")
    fitting = [p for p in points if p["depth"] >= 2 and p["p99_ms"] <= budget]
    production = (max(fitting, key=lambda p: p["sustained_txns_per_sec"])
                  if fitting else None)
    under_load = {"budget_p99_ms": budget,
                  "budget_knob": "resolver_p99_budget_ms",
                  "points": points,
                  "production_point": production}

    return {"metric": "bench_smoke", "device": str(dev), "ok": not failures,
           "failures": failures,
           "bucket_ladder": ladder, "history_floor": floor,
           "device_loop": device_loop,
           "latency_under_load": under_load}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.device)
    print(json.dumps(out))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
