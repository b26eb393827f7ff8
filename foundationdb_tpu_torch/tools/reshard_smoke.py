"""Online-resharding smoke: the live elasticity loop end to end, in seconds.

Port of ``foundationdb_tpu/tools/reshard_smoke.py``. One process, no
sockets; its shard engines are the torch engine mode's miniature ladder,
on the card unless given `--device cpu` (`--engine-mode oracle` skips the
build-discipline check):

    python -m foundationdb_tpu_torch.tools.reshard_smoke [--device cpu]

Synthetic drift drives the live elasticity loop end-to-end against REAL
engines (docs/elasticity.md):

  1. SPLIT EXECUTES — a hot window planted in the upper keyspace pushes
     the hottest shard's measured share over `reshard_split_share`; the
     controller must split it at the heat-suggested key on the live
     group, with the handoff's pre-copy/delta protocol completing and
     the epoch flipping.
  2. MERGE EXECUTES — the hot window then moves to the lower keyspace;
     the abandoned shards cool (decayed heat) until an adjacent pair
     drops under `reshard_merge_share` and the controller folds them.
  3. BLACKOUT WITHIN BUDGET — every executed reshard's freeze -> cutover
     interval stays under `reshard_blackout_budget_ms`, by the
     controller's clocks AND the emitted reshard.blackout span segments.
  4. ZERO POST-WARMUP BUILDS ON UNTOUCHED SHARDS — after engine warmup,
     serving + resharding must not build a program or capture a graph
     in steady state on ANY shard (`perf.*.compiles_steady` == 0
     group-wide): recipients come warmed (on the card: captured) from
     the spare pool, and shards the handoff never touched keep their
     built ladder.
  5. PARITY + EXPOSITION — every shard engine's journal replays
     bit-identical through a clean oracle (handoff adoption batches
     included), and the hub exposition (now carrying the
     `fdbtpu_reshard` family) passes the strict line parser.

Prints one JSON line naming its device; any failed check exits non-zero.
"""
from __future__ import annotations

import asyncio
import json
import sys
import time

from ..core import telemetry
from ..core.knobs import SERVER_KNOBS
from ..core.trace import g_spans
from ..core.types import CommitTransaction, KeyRange

POOL = 512
BATCH = 32
HOT_FRAC = 0.8
HOT_WINDOW = 48


def _key(i: int) -> bytes:
    return b"rs/%06d" % (i % POOL)


async def _drive(engine_mode: str, device=None) -> dict:
    """Run the three drift phases on the scheduler and RETURN the record
    — never raise here: a non-FDBError escaping a scheduler task strands
    the bridged future, so every assertion lives in main()."""
    from ..core.rng import DeterministicRandom
    from ..real.nemesis import make_chaos_engine
    from ..server.reshard import ElasticResolverGroup, ReshardController
    from ..sim.loop import TaskPriority, current_scheduler, delay

    rng = DeterministicRandom(2027)
    group = ElasticResolverGroup(lambda: make_chaos_engine(engine_mode, device=device))
    group.warmup()
    group.prewarm_spares(2)
    ctl = ReshardController(group)
    ctl.start(current_scheduler())

    v = 0
    hot = {"base": 3 * POOL // 4}

    async def batch() -> None:
        nonlocal v
        v += 100
        txns = []
        for _ in range(BATCH):
            def draw() -> bytes:
                if rng.random01() < HOT_FRAC:
                    return _key(hot["base"] + rng.random_int(0, HOT_WINDOW))
                return _key(rng.random_int(0, POOL))
            ks, ws = [draw(), draw()], [draw(), draw()]
            txns.append(CommitTransaction(
                read_snapshot=max(0, v - rng.random_int(0, 300)),
                read_conflict_ranges=[KeyRange(k, k + b"\x00") for k in ks],
                write_conflict_ranges=[KeyRange(k, k + b"\x00") for k in ws]))
        await group.resolve(txns, v, max(0, v - 40_000))
        await delay(0.002, TaskPriority.PROXY_COMMIT_BATCHER)

    def done_kinds() -> list:
        return [op.kind for op in ctl.ops if op.state == "done"]

    async def run_until(pred, budget_s: float) -> None:
        t_stop = time.monotonic() + budget_s
        while not pred() and time.monotonic() < t_stop:
            await batch()

    # phase 1: a hot window in the upper keyspace -> the single shard's
    # share breaches reshard_split_share -> first SPLIT
    await run_until(lambda: "split" in done_kinds(), 20.0)
    # phase 2: the window jumps to the very top — now inside ONE of the
    # two shards, whose share breaches again -> second split (a 2-shard
    # group can never merge: the pair's combined share is 1.0)
    hot["base"] = POOL - HOT_WINDOW - 1
    await run_until(lambda: done_kinds().count("split") >= 2, 20.0)
    # phase 3: the window abandons the top for the bottom — the upper
    # shards' decayed heat drops an adjacent pair under
    # reshard_merge_share -> MERGE
    hot["base"] = POOL // 8
    await run_until(lambda: "merge" in done_kinds(), 25.0)

    ctl.stop()
    snap = ctl.snapshot()
    snap["_group"] = group          # keep alive for the caller's checks
    snap["_controller"] = ctl
    snap["_versions"] = v
    return snap


def check_blackouts(snap: dict) -> None:
    budget = float(SERVER_KNOBS.reshard_blackout_budget_ms)
    done = [op for op in snap["ops"] if op["state"] == "done"]
    assert done, "no completed reshards"
    worst = max(op["blackout_ms"] for op in done)
    assert worst <= budget, \
        f"blackout {worst:.2f} ms over budget {budget} ms: {done}"
    spans = [rec for rec in g_spans.spans
             if rec.get("Name") == "reshard.blackout"]
    assert len(spans) >= len(done), \
        f"{len(spans)} reshard.blackout spans for {len(done)} reshards"
    span_worst = max(rec["blackout_ms"] for rec in spans)
    assert span_worst <= budget, \
        f"span-measured blackout {span_worst:.2f} ms over budget"
    print(f"  blackouts: {len(done)} reshard(s), worst "
          f"{worst:.2f} ms (budget {budget:g} ms), span-verified")


def check_steady_compiles(snap: dict) -> None:
    telemetry.hub().sync()
    metrics = telemetry.hub().tdmetrics.metrics
    steady = {name: int(m.value) for name, m in metrics.items()
              if name.startswith("perf.") and name.endswith("compiles_steady")}
    assert steady, "no perf ledger series (device engines expected)"
    hot = {k: v for k, v in steady.items() if v}
    assert not hot, f"steady-state builds during resharding: {hot}"
    print(f"  steady compiles: 0 across {len(steady)} engine ledger(s) "
          "(untouched shards kept their built ladder)")


def check_parity(snap: dict) -> None:
    checked, mismatches = snap["_group"].parity_check()
    assert checked > 0 and mismatches == 0, \
        f"journal parity: {mismatches} mismatches over {checked}"
    print(f"  parity: {checked} shard-journal batches replay bit-identical "
          "through clean oracles (handoff batches included)")


def check_prometheus(snap: dict) -> None:
    from .heat_smoke import strict_parse_prometheus

    text = telemetry.hub().prometheus_text()
    n = strict_parse_prometheus(text)
    assert "# TYPE fdbtpu_reshard gauge" in text, "no reshard family"
    assert any(ln.startswith("fdbtpu_reshard") and "executed" in ln
               for ln in text.splitlines()), "no executed gauge"
    print(f"  prometheus: {n} samples parse strictly, "
          "fdbtpu_reshard family present")


def check_resharding(engine_mode: str = "torch", device=None) -> dict:
    """The drift phases and checks 1-5; raises AssertionError on a miss.
    Returns the controller's snapshot (ops, epoch, stalls) and the parity
    count."""
    from ..real.runtime import RealScheduler, sim_to_aio
    from ..sim.loop import TaskPriority, set_scheduler

    telemetry.reset()
    spans_were = g_spans.enabled
    g_spans.enabled = True
    g_spans.clear()
    sched = RealScheduler(seed=5)
    set_scheduler(sched)

    async def run() -> dict:
        loop_task = asyncio.ensure_future(sched.run_async())
        task = sched.spawn(_drive(engine_mode, device),
                           TaskPriority.DEFAULT_ENDPOINT, name="smoke")
        try:
            return await sim_to_aio(task)
        finally:
            sched.shutdown()
            loop_task.cancel()

    try:
        snap = asyncio.run(run())
        done = [op["kind"] for op in snap["ops"] if op["state"] == "done"]
        print(f"  elasticity: {done} over {snap['_versions'] // 100} "
              f"batches, epoch {snap['epoch']}, stalled {snap['stalled']}")
        ops_ctx = snap["ops"]
        assert "split" in done, f"no split executed: {ops_ctx}"
        assert "merge" in done, f"no merge executed: {ops_ctx}"
        assert snap["stalled"] == 0, f"stalled reshards: {ops_ctx}"
        check_blackouts(snap)
        if engine_mode != "oracle":
            check_steady_compiles(snap)
        check_parity(snap)
        check_prometheus(snap)
    finally:
        g_spans.enabled = spans_were
        set_scheduler(None)
    checked, _ = snap["_group"].parity_check()
    return {"ops": [{k: op.get(k) for k in ("kind", "state", "blackout_ms")}
                    for op in snap["ops"]],
            "epoch": snap["epoch"], "stalled": snap["stalled"],
            "batches": snap["_versions"] // 100, "parity_checked": checked,
            "_group": snap["_group"]}


def run(device: str = "cuda", engine_mode: str = "torch") -> dict:
    """Every check; the result line main prints (the group rides along
    under "_group" for a caller that inspects its engines)."""
    import torch

    from .floor_bench import bench_device

    dev = bench_device(device)
    if dev.type == "cpu" and engine_mode != "oracle":
        # a CPU engine in a wall-clock loop shares the host's cores (as a
        # node does, real/node.py)
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    print(f"reshard-smoke [{dev}, {engine_mode}] (docs/elasticity.md):")
    failures, res = [], {}
    try:
        res = check_resharding(engine_mode, dev)
    except AssertionError as e:
        failures.append(str(e))
    print(f"reshard-smoke {'OK' if not failures else 'FAILED'} in "
          f"{time.perf_counter() - t0:.1f}s")
    return {"metric": "reshard_smoke", "device": str(dev), "engine_mode": engine_mode,
            "ok": not failures, "failures": failures,
            "budget_ms": float(SERVER_KNOBS.reshard_blackout_budget_ms), **res,
            "seconds": round(time.perf_counter() - t0, 3)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine-mode", default="torch",
                    help="torch | device_loop | oracle (oracle skips the "
                         "build-discipline check)")
    args = ap.parse_args(argv)
    out = run(args.device, args.engine_mode)
    out.pop("_group", None)
    print(json.dumps(out, default=str))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
