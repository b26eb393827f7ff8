"""Performance-observatory smoke: the observatory's wiring, in seconds,
so it breaks loudly rather than only at the next recorded bench
(docs/observability.md "Performance observatory").

Port of ``foundationdb_tpu/tools/perf_smoke.py``. It runs on the card
unless given `--device cpu`:

    python -m foundationdb_tpu_torch.tools.perf_smoke [--device cpu]

Asserts, at toy sizes:

  * **build & memory ledger** — warmup populates the ring with one
    record per built program, every record carries the (bucket, search
    mode, dispatch mode, kind) key and a duration, and on the card the
    memory analysis lands (peak bytes > 0). The port's ledger carries no
    flop count (`flops` is None by design), and on the CPU no memory
    analysis either: there the smoke says so instead of failing;
  * **sampling is observational** — abort sets are bit-identical with
    device-time sampling off vs at 100%, the loop engine's
    `blocking_syncs` stays 0 with sampling enabled, and the steady-state
    drive makes ZERO program builds or graph captures with sampling on;
  * **sampled timing sanity** — the sampled enqueue→ready per-batch ms
    lands within a (generous) factor of the loop_floor host-time figure
    measured in the same process over the same stream: the two are
    different quantities (device interval vs host wall), but an
    order-of-magnitude disagreement means a stamp is on the wrong side of
    a drain;
  * **trend gate** — tools/bench_history.py parses every committed
    BENCH_r*.json and the regression gate is green (the series is the
    reference package's bench artifacts: the gate judges them, and
    states none of them as the port's).

Prints one JSON line naming its device; any failed check exits non-zero.
"""
from __future__ import annotations

import json
import sys


def run(device: str = "cuda") -> dict:
    """Every check; the result line main prints."""
    import numpy as np

    from ..core import perfledger
    from ..ops import conflict_kernel as ck
    from ..ops.device_loop import DeviceLoopEngine
    from ..ops.host_engine import TorchConflictEngine
    from .floor_bench import _CompileCounter, bench_device, run_loop_floor
    from .ladder_bench import make_point_txns

    dev = bench_device(device)
    failures, notes = [], []
    cfg = ck.KernelConfig(key_words=4, capacity=2048, max_txns=128,
                          max_point_reads=256, max_point_writes=256,
                          max_reads=32, max_writes=32)

    # -- ledger populated on warmup, schema + analysis fields ---------------
    eng = TorchConflictEngine(cfg, ladder=[32, 64], scan_sizes=(2,),
                              device_time_sample_rate=1.0, device=dev).warmup()
    rows = eng.perf_ledger.rows()
    if len(rows) != eng.perf.compiles:
        failures.append(f"ledger rows {len(rows)} != builds "
                        f"{eng.perf.compiles}")
    for r in rows:
        missing = [f for f in perfledger.RECORD_FIELDS if f not in r]
        if missing:
            failures.append(f"ledger record missing fields {missing}")
            break
        if r["kind"] != "warmup":
            failures.append(f"warmup build recorded as {r['kind']!r}")
            break
    peak = [r["peak_bytes"] for r in rows]
    if dev.type == "cuda":
        if not rows or not all(peak):
            failures.append(f"card memory analysis missing from ledger (peak={peak})")
    else:
        notes.append("on the CPU the ledger carries no memory analysis "
                     f"(peak_bytes {sorted(set(map(str, peak)))})")
    notes.append("the port's ledger carries no flop count "
                 f"(flops {sorted({str(r['flops']) for r in rows})})")

    # -- sampling observational: on/off abort parity, zero builds -----------
    off = TorchConflictEngine(cfg, ladder=[32, 64], scan_sizes=(2,),
                              device_time_sample_rate=0.0, device=dev).warmup()
    loop_on = DeviceLoopEngine(cfg, ladder=[32, 64],
                               device_time_sample_rate=1.0, device=dev).warmup()
    rng = np.random.default_rng(13)
    engines = (eng, off, loop_on)
    builds = sum(e.perf.compiles for e in engines)
    counter = _CompileCounter()
    version = 2_000
    parity = True
    for _ in range(2):
        for n in (16, 31, 32, 33, 64, 65, 128, 250):
            txns = make_point_txns(n, 256, rng, version)
            version += max(64, n)
            new_oldest = max(0, version - 100_000)
            got = [int(x) for x in eng.resolve(txns, version, new_oldest)]
            want = [int(x) for x in off.resolve(txns, version, new_oldest)]
            lgot = [int(x) for x in loop_on.resolve(txns, version, new_oldest)]
            if got != want or lgot != want:
                parity = False
    loop_on.drain_loop()
    steady = counter.close() + sum(e.perf.compiles for e in engines) - builds
    if not parity:
        failures.append("sampling on/off abort-set parity failed")
    if steady:
        failures.append(f"{steady} post-warmup builds and captures with sampling on")
    if loop_on.loop_stats["blocking_syncs"]:
        failures.append(
            f"{loop_on.loop_stats['blocking_syncs']} blocking syncs with "
            "sampling enabled (want 0)")
    sampled = eng.perf.device_time_ms_by_bucket()
    loop_sampled = loop_on.perf.device_time_ms_by_bucket()
    if not sampled or not loop_sampled:
        failures.append("100% sampling produced no device-time samples "
                        f"(step={sampled}, loop={loop_sampled})")

    # -- sampled timing within sanity bounds of the loop_floor figure -------
    floor = run_loop_floor(cfg, n_batches=8, pool=256, device=dev)
    top = cfg.max_txns
    sample_ms = loop_sampled.get(top) or max(loop_sampled.values(), default=0)
    step_ms = floor["step_host_ms_per_batch"]
    ratio = None
    if sample_ms and step_ms:
        ratio = sample_ms / step_ms
        if not (0.02 <= ratio <= 50.0):
            failures.append(
                f"sampled device ms {sample_ms:.3f} implausible vs "
                f"loop_floor step host ms {step_ms:.3f} (ratio {ratio:.2f})")
    if floor["loop_stats"]["blocking_syncs"]:
        failures.append("loop_floor drive hit blocking syncs")

    # -- the trend gate parses + passes on the committed series -------------
    from . import bench_history

    series = []
    try:
        series = bench_history.load_series(bench_history.find_repo_root())
        trends = bench_history.build_trends(series)
        if not series:
            failures.append("no BENCH_r*.json artifacts found")
        elif not trends["ok"]:
            failures.append(f"bench_history gate red: {trends['failures']}")
    except Exception as e:  # noqa: BLE001 — the smoke must name the break
        failures.append(f"bench_history failed: {type(e).__name__}: {e}")
        trends = None

    return {"metric": "perf_smoke", "device": str(dev), "ok": not failures,
            "failures": failures, "notes": notes,
            "ledger_rows": len(rows), "peak_bytes": peak,
            "steady_state_compiles": steady,
            "sampled_step_ms": sampled, "sampled_loop_ms": loop_sampled,
            "sampled_over_floor": ratio,
            "loop_floor_step_host_ms": floor["step_host_ms_per_batch"],
            "loop_floor_loop_host_ms": floor["loop_host_ms_per_batch"],
            "artifacts": len(series) if trends else 0,
            "trend_gate_ok": trends["ok"] if trends else None}


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
