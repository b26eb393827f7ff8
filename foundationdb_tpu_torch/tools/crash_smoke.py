"""Crash-stop recovery smoke: kill -9 -> recover inside budget, in seconds.

Port of ``foundationdb_tpu/tools/crash_smoke.py``. One parent and one
supervised child; the child's engine is the torch engine mode's miniature
ladder, on the card unless given `--device cpu`:

    python -m foundationdb_tpu_torch.tools.crash_smoke [--device cpu]

Runs ONE seeded crash-restart campaign (the real/nemesis.py --crash
machinery) end to end —

  1. a recoverable commit-server child boots COLD into a durable
     directory (journal at fsync_interval=1, cadenced engine-state
     snapshots, on-disk progcache), serves real commits over TCP, is
     killed -9 mid-load under injected disk faults, and is supervised
     back up by monitor.Child;
  2. the restart RECOVERS — newest readable snapshot + differential
     journal replay + rewarm — inside `resolver_recovery_budget_ms`,
     asserted from the journaled RecoveryResult AND the span-verified
     `recovery.blackout` fetched from the child's own span ring over RPC.
     The port's program cache refuses every build (a captured CUDA graph
     has no serialized form): the rewarm rebuilds, and the smoke requires
     that the replayed suffix was served without a cache hit, where the
     reference requires hits;
  3. the whole retained batch stream — both boots, across the crash —
     replays bit-identical through a clean serial oracle;
  4. `cli recovery` renders the arc from the journal directory and from
     the report JSON (the operator path, not just the library).

Everything it writes goes under a fresh temporary directory, or under
`workdir` where the caller passes one. Prints one JSON line naming its
device; any failed check exits non-zero.
"""
from __future__ import annotations

import io
import json
import os
import sys
import tempfile

SEED = 29


def check_crash(device="cuda", workdir=None, result=None) -> dict:
    """Checks 1-4; raises AssertionError on a miss. Returns `result` (a
    new dict unless given) holding the campaign's report, its budget and
    the rendered `cli recovery` text, each stored as soon as it exists."""
    result = {} if result is None else result
    from ..real.nemesis import assert_crash_slos, crash_config, run_crash_campaign
    from .cli import Cli

    tmp = workdir or tempfile.mkdtemp(prefix="fdb_tpu_crash_smoke_")
    datadir = os.path.join(tmp, "node0")
    cfg = crash_config(SEED, engine_mode="torch", datadir=datadir,
                       warm_s=2.0, post_s=1.0, device=str(device))
    print(f"crash-smoke: crash-restart campaign (torch on {device}, kill -9 "
          "mid-load, disk faults on) ...", flush=True)
    rep = result["report"] = run_crash_campaign(cfg)
    result["budget_ms"] = cfg.resolved_budget_ms()
    report_path = os.path.join(tmp, "report.json")
    with open(report_path, "w") as f:
        json.dump({"campaigns": [rep]}, f, default=str)
    assert_crash_slos(rep, cfg)
    rec = rep.get("recovery") or {}
    print(f"  recovered: mode={rec.get('mode')} "
          f"snap v{rec.get('snapshot_version')} + "
          f"{rec.get('replayed_batches')} replayed batch(es), "
          f"blackout {rec.get('blackout_ms')}ms "
          f"(budget {cfg.resolved_budget_ms():.0f}ms), "
          f"progcache {rec.get('progcache_hits')} hit(s)", flush=True)
    # the port's cache refuses every build, so a restart rewarms by
    # rebuilding: a hit would mean a program came off disk
    assert rec.get("progcache_hits", 0) == 0, \
        f"the restart took a program off the cache: {rec}"
    print(f"  parity: {rep['parity_checked']} batch(es) across the crash "
          f"verdict-identical; disk faults injected: "
          f"{(rep.get('disk') or {}).get('injected')}", flush=True)

    # the operator path: render the durable arc from both sources
    out = io.StringIO()
    cli = Cli.__new__(Cli)
    cli.out = out
    cli.do_recovery([datadir])
    cli.do_recovery([report_path])
    rendered = result["rendered"] = out.getvalue()
    sys.stdout.write(rendered)
    assert "last recovery: mode=complete" in rendered, rendered
    assert "blackout" in rendered, rendered
    assert "snapshot(s)" in rendered, rendered
    print("CRASH SMOKE OK", flush=True)
    return result


def run(device: str = "cuda", workdir=None) -> dict:
    """Every check; the result line main prints."""
    import time

    from .floor_bench import bench_device

    dev = bench_device(device)
    t0 = time.perf_counter()
    failures, res = [], {}
    try:
        check_crash(dev, workdir, res)
    except AssertionError as e:
        failures.append(str(e))
    rep = res.get("report") or {}
    rec = rep.get("recovery") or {}
    return {"metric": "crash_smoke", "device": str(dev), "ok": not failures,
            "failures": failures,
            "recovery": {k: rec.get(k) for k in (
                "mode", "coverage_ok", "blackout_ms", "warm_ms", "replayed_batches",
                "snapshot_version", "progcache_hits", "verdict_mismatches")},
            "budget_ms": res.get("budget_ms"),
            "span_blackouts_ms": rep.get("recovery_span_blackouts_ms"),
            "parity_checked": rep.get("parity_checked"),
            "parity_mismatches": rep.get("parity_mismatches"),
            "child_restarts": rep.get("child_restarts"),
            "committed_post_restart": rep.get("committed_post_restart"),
            "seconds": round(time.perf_counter() - t0, 3)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None,
                    help="where the durable directory and the report go "
                         "(default: a fresh temporary directory)")
    args = ap.parse_args(argv)
    out = run(args.device, args.workdir)
    print(json.dumps(out, default=str))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
