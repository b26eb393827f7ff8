"""Crash-stop recovery economics: the bench.py `recovery` section.

Port of ``foundationdb_tpu/tools/recovery_bench.py``.

Three figures price what fault/recovery.py + core/progcache.py bought
(docs/fault_tolerance.md "Crash-stop recovery"):

  * **rewarm** — cold build vs progcache-warm load of the same bucket
    ladder, each measured in a FRESH subprocess (the honest restart
    shape: nothing built in one process can leak into the other, and the
    second process really does read the directory the first one wrote).
    The engine is a TorchConflictEngine on the card (`--device cpu` runs
    it on the CPU). JAX's acceptance bar is kept as JAX computes it: >= 5x
    with zero compiles in the warm run. On the card it is not met, by
    design: a captured CUDA graph has no serialized form
    (core/progcache.serialize_program raises for every program, counted
    under `errors`), so the warm child rebuilds and recaptures every
    program, and `goal_met` is False. The two warmup ms price that
    recapture.

  * **replay** — snapshot + differential journal-suffix replay vs
    full-journal replay into the same fresh supervised engine (the PAM
    trade, PAPERS.md): identical recorded stream, identical verdicts
    (mismatches MUST be 0 on both arms), wall-clock blackout compared.

  * **crash** — one real kill -9 campaign (real/nemesis.py --crash,
    oracle engines for a fast boot): the restarted child's measured
    recovery blackout vs `resolver_recovery_budget_ms`, with the
    cross-crash oracle replay parity witnessed in the artifact.

    python -m foundationdb_tpu_torch.tools.recovery_bench [--device cpu]   # JSON
    python -m foundationdb_tpu_torch.tools.recovery_bench --rewarm-child DIR
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

#: the rewarm subprocess's ladder: enough distinct programs that the
#: warmup is dominated by the build (cold) / load (warm)
REWARM_LADDER = [128, 256]
REWARM_TXNS = 512
#: the checkout's root: the rewarm children import the package from it
REPO_ROOT = str(Path(__file__).resolve().parent.parent.parent)


def _rewarm_child(directory: str, device: str = "cuda") -> None:
    """One process lifetime of the restart arc: install the on-disk
    program cache, build + warm the laddered engine on `device`, report
    what the warmup cost and where the programs came from. Run twice
    against the same directory, the first call IS the cold build (and
    tries to populate the cache), the second is the progcache-warm
    rewarm."""
    from ..core import progcache
    from ..ops import conflict_kernel as ck
    from ..ops import fixpoint_cuda
    from ..ops.host_engine import TorchConflictEngine
    from .floor_bench import bench_device
    from .sharded_bench import card_line

    dev = bench_device(device)
    pc = progcache.install(progcache.ProgramCache(directory))
    cfg = ck.KernelConfig(
        key_words=4, capacity=2048,
        max_point_reads=2 * REWARM_TXNS, max_point_writes=2 * REWARM_TXNS,
        max_reads=64, max_writes=64, max_txns=REWARM_TXNS)
    t0 = time.perf_counter()
    eng = TorchConflictEngine(cfg, ladder=list(REWARM_LADDER), device=dev).warmup()
    ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps({
        "card": card_line(dev),
        "device": str(dev),
        "warmup_ms": round(ms, 3),
        "compiles": int(eng.perf.compiles),
        "captures": int(eng.perf.captures),
        #: the fixpoint launches of this process (eager, or captured)
        "fixpoint_launches": fixpoint_cuda.FIXPOINT.launches + fixpoint_cuda.FIXPOINT.graph_launches,
        **{k: pc.stats[k] for k in
           ("hits", "misses", "stores", "poisoned", "unverifiable", "errors")},
    }))


def run_rewarm(directory: str, timeout_s: int = 900, device: str = "cuda") -> Optional[dict]:
    """Cold vs progcache-warm rewarm, two fresh subprocesses."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO_ROOT, env.get("PYTHONPATH", "")) if p)

    def child() -> Optional[dict]:
        r = subprocess.run(
            [sys.executable, "-m", "foundationdb_tpu_torch.tools.recovery_bench",
             "--rewarm-child", directory, "--device", device],
            capture_output=True, timeout=timeout_s, env=env, text=True)
        if r.returncode != 0:
            return None
        return json.loads(r.stdout.strip().splitlines()[-1])

    cold = child()
    warm = child() if cold else None
    if not cold or not warm or warm["warmup_ms"] <= 0:
        return None
    speedup = cold["warmup_ms"] / warm["warmup_ms"]
    return {
        "card": cold["card"], "device": cold["device"],
        "ladder": list(REWARM_LADDER), "batch_txns": REWARM_TXNS,
        "cold": cold, "warm": warm,
        "rewarm_speedup": round(speedup, 2),
        # the acceptance bar: >= 5x faster AND the warm run compiled
        # nothing (every program came off disk)
        "goal_met": bool(speedup >= 5.0 and warm["compiles"] == 0
                         and warm["hits"] >= 1),
    }


def run_replay_compare(directory: str, n_batches: int = 400,
                       snap_after: int = 360) -> Optional[dict]:
    """Snapshot + suffix replay vs full-journal replay, same stream.
    The stream is long relative to the suffix on purpose: the snapshot
    is bounded by distinct keys (the coalesced interval map) while the
    full replay grows with history — the PAM trade being priced."""
    from ..core import blackbox, buggify, telemetry
    from ..fault import recovery
    from ..fault.inject import FaultInjectingEngine, FaultRates
    from ..fault.resilient import ResilienceConfig, ResilientEngine
    from ..ops.oracle import OracleConflictEngine
    from ..sim.loop import set_scheduler
    from ..sim.simulator import Simulator

    def engine():
        injector = FaultInjectingEngine(
            OracleConflictEngine(),
            rates=FaultRates(exception=0, hang=0, slow=0, flip=0, outage=0))
        return ResilientEngine(injector, ResilienceConfig(
            dispatch_timeout=0.5, retry_budget=2, retry_backoff=0.02,
            probe_rate=0.0, probation_batches=2, failover_min_batches=2))

    import random

    from ..core.types import CommitTransaction, KeyRange

    rng = random.Random(203)
    stream = []
    v = 0
    for _ in range(n_batches):
        v += rng.randrange(40, 120)
        txns = []
        for _ in range(rng.randrange(2, 6)):
            t = CommitTransaction(
                read_snapshot=max(0, v - rng.randrange(1, 400)))
            k = b"r/%03d" % rng.randrange(96)
            t.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            t.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            txns.append(t)
        stream.append((txns, v, max(0, v - 2000)))

    sim = Simulator(203)
    # the simulator arms BUGGIFY, whose journal-write sites would drop
    # events mid-measurement — this is a timing section, not a fault one
    buggify.disable()
    telemetry.reset()
    blackbox.uninstall()
    blackbox.install(blackbox.BlackboxJournal(directory))
    out = {"batches": n_batches}
    try:
        live = engine()

        async def go():
            for i, (txns, bv, old) in enumerate(stream):
                verdicts = [int(x) for x in await live.resolve(txns, bv, old)]
                blackbox.record_batch(txns, bv, old, verdicts,
                                      engine="oracle")
                if i == snap_after:
                    snap = recovery.capture(live, proc="bench")
                    acct = recovery.write_snapshot(directory, snap)
                    out["snapshot_version"] = snap.version
                    out["snapshot_bytes"] = acct["bytes"] if acct else None
            with_snap = await recovery.recover(engine(), directory,
                                               warm=False, proc="bench")
            for _v, path in recovery.snapshot_paths(directory):
                os.remove(path)
            full = await recovery.recover(engine(), directory,
                                          warm=False, proc="bench")
            return with_snap, full

        done = sim.sched.run_until(sim.sched.spawn(go()), until=100000)
        if not done:
            return None
        with_snap, full = done
        for label, res in (("snapshot_replay", with_snap),
                           ("full_replay", full)):
            out[label] = {
                "ms": round(res.blackout_ms, 3),
                "replayed": res.replayed_batches,
                "mismatches": res.verdict_mismatches,
                "mode": res.mode,
            }
        out["parity_ok"] = (with_snap.verdict_mismatches == 0
                            and full.verdict_mismatches == 0
                            and with_snap.error is None
                            and full.error is None)
        if with_snap.blackout_ms > 0:
            out["speedup"] = round(full.blackout_ms / with_snap.blackout_ms,
                                   2)
    finally:
        blackbox.uninstall()
        set_scheduler(None)
        telemetry.reset()
    return out


def run_crash_blackout(workdir: str, seed: int = 61) -> Optional[dict]:
    """One real kill -9 campaign (oracle engines) and what the restart
    cost: the measured recovery blackout vs the budget knob, the
    cross-crash replay parity, and whether assert_crash_slos holds."""
    from ..core.knobs import SERVER_KNOBS
    from ..real.nemesis import (assert_crash_slos, crash_config,
                                run_crash_campaign)

    cfg = crash_config(seed, engine_mode="oracle",
                       datadir=os.path.join(workdir, "node0"),
                       warm_s=1.5, post_s=0.8, rate_tps=80.0)
    rep = run_crash_campaign(cfg)
    slo_ok, slo_err = True, None
    try:
        assert_crash_slos(rep, cfg)
    except AssertionError as e:
        slo_ok, slo_err = False, str(e)
    rec = rep.get("recovery") or {}
    spans = rep.get("recovery_span_blackouts_ms") or []
    return {
        "engine_mode": "oracle",
        "mode": rec.get("mode"),
        "blackout_ms": rec.get("blackout_ms"),
        "span_blackout_ms_max": max(spans) if spans else None,
        "budget_ms": float(SERVER_KNOBS.resolver_recovery_budget_ms),
        "snapshot_version": rec.get("snapshot_version"),
        "replayed_batches": rec.get("replayed_batches"),
        "progcache_hits": rec.get("progcache_hits"),
        "child_restarts": rep.get("child_restarts"),
        "parity_checked": rep.get("parity_checked"),
        "parity_mismatches": rep.get("parity_mismatches"),
        "slo_ok": slo_ok, "slo_error": slo_err,
    }


def run_recovery_bench(device: str = "cuda") -> dict:
    """The full `recovery` artifact section; each sub-measurement is
    exception-guarded so one sick arm never drops the others."""
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="fdbtpu-recbench-") as td:
        for name, fn in (
                ("rewarm",
                 lambda: run_rewarm(os.path.join(td, "progcache"), device=device)),
                ("replay",
                 lambda: run_replay_compare(os.path.join(td, "journal"))),
                ("crash",
                 lambda: run_crash_blackout(os.path.join(td, "crash")))):
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 — mirror the sibling
                #                     bench sections' guard discipline
                out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rewarm-child", metavar="DIR", default=None,
                    help="internal: one rewarm process lifetime")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the rewarm engines (cpu to run them on the CPU)")
    args = ap.parse_args(argv)
    if args.rewarm_child:
        _rewarm_child(args.rewarm_child, args.device)
        return 0
    print(json.dumps(run_recovery_bench(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
