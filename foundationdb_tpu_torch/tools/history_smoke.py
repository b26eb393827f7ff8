"""Incremental-history smoke: the tiered history's contract, in seconds.

Port of ``foundationdb_tpu/tools/history_smoke.py``. It runs on the card
unless given `--device cpu`:

    python -m foundationdb_tpu_torch.tools.history_smoke [--device cpu]

Four checks, each loud on failure (docs/perf.md "Incremental history
maintenance"):

  1. APPLY COST SCALES WITH BATCH, NOT CAPACITY — the isolated
     `apply_writes_and_gc` sweep (tools/floor_bench.run_apply_sweep) at
     two capacities, small-touch batches: the tiered structure must beat
     the monolithic re-merge at the larger table, and its advantage must
     GROW with capacity (the monolithic apply pays the capacity-H
     re-merge every batch; the tiered apply pays the batch). On the card
     the sweep's figures are device ms of captured replays; on the CPU
     they are host ms of the eager runs, the fastest of HOST_REPS turns.
  2. ZERO POST-WARMUP BUILDS WITH TIERS — a warmed tiered engine serves
     a mixed stream spanning several lazy compactions without a single
     program build or graph capture.
  3. PARITY CANARY — monolithic, tiered/fused_sort and tiered/bsearch
     engines replay one randomized GC-advancing stream against the
     reference CPU oracle, bit-identical verdicts every batch.
  4. PROMETHEUS EXPOSITION PARSES — the hub text now carrying the
     `history.*` gauges passes the strict line parser and exposes
     the `fdbtpu_history` family, with the driven engine's merge counter
     visible.

Prints one JSON line naming its device; any failed check exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time

from ..core import telemetry
from ..core.rng import DeterministicRandom
from ..core.types import CommitTransaction, KeyRange
from ..ops import conflict_kernel as ck
from ..ops.host_engine import TorchConflictEngine
from ..ops.oracle import OracleConflictEngine
from .floor_bench import _CompileCounter, run_apply_sweep
from .heat_smoke import strict_parse_prometheus

#: two-capacity scaling probe: 512-txn-point write shape scaled down to
#: smoke size, small-touch (the batch can touch 2*w_all = 96 rows; the
#: tables hold 4k / 16k)
SWEEP_SHAPE = dict(key_words=4, max_txns=16, max_point_reads=64,
                   max_point_writes=32, max_reads=8, max_writes=8)
CAPACITIES = (4096, 16384)
#: floor for the large-table speedup (the reference's bar, kept as it is)
MIN_SPEEDUP_LARGE = 1.5
#: timed turns of each sweep program on the CPU (the card times one replay)
HOST_REPS = 5

PARITY_CFG = ck.KernelConfig(key_words=2, capacity=512, max_reads=64,
                             max_writes=64, max_txns=16)


def apply_scaling_points(device="cuda") -> dict:
    """The sweep's point at each capacity ({capacity: point}); raises
    AssertionError where the tiered apply recaptured after warmup."""
    by_cap = {}
    for cap in CAPACITIES:
        cfg = ck.KernelConfig(capacity=cap, **SWEEP_SHAPE)
        out = run_apply_sweep(cfg, occupancy_fracs=(0.75,), scan_steps=24,
                              device=device, host_reps=HOST_REPS)
        by_cap[cap] = out["points"][-1]
        assert out["steady_state_compiles"]["tiered"] == 0, (
            f"tiered apply recaptured post-warmup at capacity {cap}: "
            f"{out['steady_state_compiles']}")
    return by_cap


def check_apply_scaling(device="cuda", by_cap=None) -> dict:
    """Check 1 over apply_scaling_points (measured here unless given);
    returns them, raising AssertionError where a bar is missed."""
    by_cap = by_cap if by_cap is not None else apply_scaling_points(device)
    small, large = by_cap[CAPACITIES[0]], by_cap[CAPACITIES[-1]]
    assert large["tiered_speedup"] is not None and small["tiered_speedup"] is not None, \
        f"the apply sweep was not timed: {by_cap}"
    print(f"  apply scaling: tiered {large['tiered_ms']}ms vs monolithic "
          f"{large['monolithic_ms']}ms at 75% of {CAPACITIES[-1]} rows "
          f"({large['tiered_speedup']}x against a {MIN_SPEEDUP_LARGE}x bar, was "
          f"{small['tiered_speedup']}x at {CAPACITIES[0]} rows)")
    assert large["tiered_speedup"] >= MIN_SPEEDUP_LARGE, (
        f"tiered apply speedup {large['tiered_speedup']} < "
        f"{MIN_SPEEDUP_LARGE} at capacity {CAPACITIES[-1]} "
        f"(mono {large['monolithic_ms']}ms, tiered {large['tiered_ms']}ms)")
    assert large["tiered_speedup"] > small["tiered_speedup"], (
        "tiered advantage must grow with capacity (apply scaling with the "
        f"table, not the batch?): {small['tiered_speedup']} at "
        f"{CAPACITIES[0]} vs {large['tiered_speedup']} at {CAPACITIES[-1]}")
    return by_cap


def _random_key(rng, alphabet=b"ab\x00\xff", maxlen=6):
    n = rng.random_int(0, maxlen + 1)
    return bytes(rng.random_choice(alphabet) for _ in range(n))


def _random_txn(rng, version_floor, version_now):
    t = CommitTransaction()
    t.read_snapshot = rng.random_int(max(0, version_floor - 40), version_now)
    for ranges, allow_empty in ((t.read_conflict_ranges, True),
                                (t.write_conflict_ranges, False)):
        for _ in range(rng.random_int(0, 4)):
            a, b = _random_key(rng), _random_key(rng)
            if a > b:
                a, b = b, a
            if a == b and not allow_empty:
                b = a + b"\x00"
            ranges.append(KeyRange(a, b))
    return t


def _stream(seed, batches=30):
    rng = DeterministicRandom(seed)
    now, oldest = 10, 0
    for _ in range(batches):
        now += rng.random_int(1, 30)
        if rng.random01() < 0.3:
            oldest = max(oldest, now - rng.random_int(20, 120))
        txns = [_random_txn(rng, oldest, now)
                for _ in range(rng.random_int(1, 13))]
        yield txns, now, oldest


def parity_engines(device="cuda") -> dict:
    """The canary's three engines: {"monolithic", "tiered/fused_sort",
    "tiered/bsearch"} (the fused_sort one keeps 16 heat buckets)."""
    tiered_cfg = dataclasses.replace(PARITY_CFG, history_structure="tiered",
                                     history_runs=3)
    return {
        "monolithic": TorchConflictEngine(PARITY_CFG, ladder=(), device=device),
        "tiered/fused_sort": TorchConflictEngine(
            dataclasses.replace(tiered_cfg, history_search="fused_sort"),
            ladder=(), heat_buckets=16, device=device),
        "tiered/bsearch": TorchConflictEngine(
            dataclasses.replace(tiered_cfg, history_search="bsearch"),
            ladder=(), device=device),
    }


def check_parity_and_compiles(device="cuda", verdicts=None) -> TorchConflictEngine:
    """Returns the driven tiered engine — the caller MUST hold it until
    after check_prometheus: the telemetry hub keeps only weakrefs.
    `verdicts`: a list that receives, per batch, {name: verdicts} of the
    oracle and every engine."""
    oracle = OracleConflictEngine()
    engines = parity_engines(device)
    # one monotone stream; the first batches warm every program (build,
    # capture and first merge), then the counters police the rest — which
    # still spans several 3-run compaction cycles
    counter = builds = None
    for i, (txns, now, oldest) in enumerate(_stream(4, batches=30)):
        if i == 6:
            counter = _CompileCounter()
            builds = sum(e.perf.compiles for e in engines.values())
        want = [int(x) for x in oracle.resolve(txns, now, oldest)]
        row = {"oracle": want}
        for name, eng in engines.items():
            got = [int(x) for x in eng.resolve(txns, now, oldest)]
            row[name] = got
            assert got == want, f"{name} diverged from oracle: {got} != {want}"
        if verdicts is not None:
            verdicts.append(row)
    seen = counter.close() + sum(e.perf.compiles for e in engines.values()) - builds
    assert seen == 0, f"{seen} post-warmup builds and captures serving tiers"
    hot = engines["tiered/fused_sort"]
    hist = hot.heat.history_snapshot()
    assert hist["appends"] > 0 and hist["merges"] > 0, (
        f"stream never exercised the run stack: {hist}")
    print(f"  parity: 30 batches bit-identical across monolithic + 2 tiered "
          f"modes, {hist['merges']} compactions, {seen} builds and captures")
    return hot


def check_prometheus() -> None:
    telemetry.hub().sync()
    text = telemetry.hub().prometheus_text()
    n = strict_parse_prometheus(text)
    assert "# TYPE fdbtpu_history gauge" in text, "no history family exposed"
    merge_lines = [ln for ln in text.splitlines()
                   if ln.startswith("fdbtpu_history") and "merges" in ln]
    assert any(not ln.rstrip().endswith(" 0") for ln in merge_lines), (
        f"history merge gauges all zero: {merge_lines}")
    print(f"  prometheus: {n} samples parse strictly, fdbtpu_history "
          "family present with live merge counts")


def run(device: str = "cuda") -> dict:
    """Every check; the result line main prints. A failure's text starts
    with its check's name (apply_scaling, parity_and_compiles,
    prometheus)."""
    from .floor_bench import bench_device

    dev = bench_device(device)
    t0 = time.perf_counter()
    telemetry.reset()
    print(f"history-smoke [{dev}] (docs/perf.md):")
    failures = []
    out = {"metric": "history_smoke", "device": str(dev)}
    try:
        points = apply_scaling_points(dev)
        out["apply_scaling"] = {str(k): v for k, v in points.items()}
        check_apply_scaling(dev, points)
    except AssertionError as e:
        failures.append(f"apply_scaling: {e}")
    live = None
    try:
        live = check_parity_and_compiles(dev)   # held: the hub weakrefs it
        check_prometheus()
    except AssertionError as e:
        failures.append(f"{'prometheus' if live is not None else 'parity_and_compiles'}: {e}")
    del live
    out.update(ok=not failures, failures=failures,
               seconds=round(time.perf_counter() - t0, 3))
    return out


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
