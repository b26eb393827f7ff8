"""Conflict-scheduler smoke: the scheduler's contract, in seconds.

Port of ``foundationdb_tpu/tools/sched_smoke.py``. It resolves through the
CPU oracle and touches no device; `--device` is taken only so that every
smoke shares one command line:

    python -m foundationdb_tpu_torch.tools.sched_smoke [--device cpu]

Four checks, each loud on failure (docs/scheduling.md):

  1. ABORT FRACTION DROPS ON A PLANTED HOT-KEY WORKLOAD — the same
     contended stream (small hot pool, stale snapshots, pre-aborts
     retried at a refreshed snapshot like the client contract) must
     serve a materially lower abort fraction with the scheduler ON than
     with it off, at an equal-or-better commit count.
  2. PARITY CANARY — the scheduled arm's dispatched-batch journal
     replays bit-for-bit through a CLEAN serial oracle: scheduling
     changes admission order, never resolution.
  3. PROMETHEUS EXPOSITION PARSES — the hub text now carries `sched.*`
     series; the `fdbtpu_sched` family must be present and the whole
     exposition must pass the strict line parser (heat_smoke's).
  4. DISABLED PATH IS INERT — `enabled=False` selects FIFO slices,
     touches no predictor state, registers no telemetry series.

Prints one JSON line; any failed check exits non-zero.
"""
from __future__ import annotations

import json
import sys
import time

from ..core import telemetry
from ..core.rng import DeterministicRandom
from ..core.types import CommitTransaction, KeyRange, TransactionCommitResult
from ..ops.oracle import OracleConflictEngine
from ..pipeline.scheduler import ConflictScheduler, SchedConfig
from .heat_smoke import strict_parse_prometheus

#: the planted contention pool: sized so hot-writer arrivals (~half the
#: stream) stay within one lane head per key per tick — contention the
#: scheduler can actually schedule around, not structural oversubscription
HOT_KEYS = 8
COLD_KEYS = 512
BATCHES = 120
CAP = 16
COMMITTED = int(TransactionCommitResult.COMMITTED)


def _txn(snap: int, key: bytes, write: bool) -> CommitTransaction:
    t = CommitTransaction(read_snapshot=int(snap))
    t.read_conflict_ranges.append(KeyRange(key, key + b"\x00"))
    if write:
        t.write_conflict_ranges.append(KeyRange(key, key + b"\x00"))
    return t


def _arrivals(rng, version: int, n: int = 12):
    """Hot read-modify-writes (70%) + cold traffic, snapshots up to 30
    versions stale — the doom rule's fuel."""
    out = []
    for _ in range(n):
        snap = version - rng.random_int(0, 30)
        if rng.random01() < 0.5:
            out.append(_txn(snap, b"hot/%02d" % rng.random_int(0, HOT_KEYS),
                            write=True))
        else:
            out.append(_txn(snap,
                            b"cold/%04d" % rng.random_int(0, COLD_KEYS),
                            write=rng.random01() < 0.5))
    return out


def _run_arm(sched_on: bool, seed: int = 17):
    """One arm of the A/B: the contended stream through scheduler +
    serial oracle, pre-aborts retried at a refreshed snapshot. Returns
    (committed, conflicted, preaborts, journal, scheduler)."""
    rng = DeterministicRandom(seed)
    cfg = SchedConfig.from_knobs()
    cfg.enabled = sched_on
    cfg.probe_interval = 8
    s = ConflictScheduler(cfg, name="smoke_on" if sched_on else "smoke")
    engine = OracleConflictEngine()
    committed = conflicted = preaborts = 0
    journal, pending, version = [], [], 1000
    for _b in range(BATCHES):
        version += 8
        pending.extend(_arrivals(rng, version))
        plan = s.select(pending, CAP)
        pending = plan.remaining
        preaborts += len(plan.preaborts)
        for txn, _rng in plan.preaborts:
            # the client contract: refresh the read version and retry
            retry = CommitTransaction(read_snapshot=version)
            retry.read_conflict_ranges = list(txn.read_conflict_ranges)
            retry.write_conflict_ranges = list(txn.write_conflict_ranges)
            pending.append(retry)
        batch = plan.dispatch
        if not batch:
            continue
        verdicts = [int(v) for v in engine.resolve(batch, version, 0)]
        journal.append((version, tuple(batch), 0, tuple(verdicts)))
        s.observe_batch(batch, verdicts, version)
        committed += sum(1 for v in verdicts if v == COMMITTED)
        conflicted += sum(1 for v in verdicts if v != COMMITTED)
    pending.extend(s.flush())
    if pending:
        version += 8
        batch = pending[:CAP]
        verdicts = [int(v) for v in engine.resolve(batch, version, 0)]
        journal.append((version, tuple(batch), 0, tuple(verdicts)))
        committed += sum(1 for v in verdicts if v == COMMITTED)
        conflicted += sum(1 for v in verdicts if v != COMMITTED)
    return committed, conflicted, preaborts, journal, s


def check_abort_reduction(arms=None):
    """`arms`: the two arms' results, (off, on) as _run_arm returns them,
    where the caller already ran them."""
    off, on = arms or (_run_arm(False), _run_arm(True))
    c_off, x_off, _p, _j, _s = off
    c_on, x_on, preaborts, journal, sched = on
    frac_off = x_off / max(c_off + x_off, 1)
    frac_on = x_on / max(c_on + x_on, 1)
    assert preaborts > 0, "scheduler ON never pre-aborted on a hot stream"
    assert sched.counters["laned"] > 0, "no hot writer was ever laned"
    assert frac_on < frac_off * 0.7, (
        f"abort_frac did not drop: off={frac_off:.4f} on={frac_on:.4f}")
    assert c_on >= c_off, (
        f"scheduler ON served fewer commits: {c_on} < {c_off}")
    print(f"  abort reduction: off {frac_off:.4f} -> on {frac_on:.4f} "
          f"({preaborts} pre-aborts, commits {c_off} -> {c_on})")
    return journal, sched


def check_parity(journal) -> None:
    clean = OracleConflictEngine()
    for version, txns, oldest, verdicts in journal:
        want = [int(v) for v in clean.resolve(list(txns), version, oldest)]
        assert want == list(verdicts), (
            f"scheduled-order replay diverged at v{version}")
    print(f"  parity: {len(journal)} scheduled batches replay "
          "bit-for-bit through a clean oracle")


def check_prometheus(sched) -> None:
    hub = telemetry.hub()
    hub.sync()
    text = hub.prometheus_text()
    n = strict_parse_prometheus(text)
    assert "# TYPE fdbtpu_sched gauge" in text, "no sched family exposed"
    # the family prefix is the metric name; the series label carries the
    # scheduler label + counter (e.g. series="smoke_on.preaborts")
    assert f'series="{sched.label}.preaborts"' in text, (
        "\n".join(ln for ln in text.splitlines() if "sched" in ln)[:400])
    print(f"  prometheus: {n} samples parse strictly, sched family present")


def check_disabled_path() -> None:
    telemetry.reset()
    s = ConflictScheduler(SchedConfig(enabled=False))
    assert s.label is None, "disabled scheduler registered telemetry"
    pending = [_txn(100, b"k%d" % i, write=True) for i in range(6)]
    plan = s.select(pending, 4)
    assert plan.dispatch == pending[:4] and plan.remaining == pending[4:]
    assert not plan.preaborts
    assert all(v == 0 for v in s.counters.values())
    assert s.predictor.scores == {} and not s.lanes
    telemetry.hub().sync()
    assert not any(name.startswith("sched.")
                   for name in telemetry.hub().tdmetrics.metrics), \
        "sched series synced with the scheduler disabled"
    print("  disabled path: FIFO passthrough, no state, no hub series")


def run(device: str = "host") -> dict:
    """Every check; the result line main prints. `device` is only named
    in the line: the oracle resolves on the host."""
    t0 = time.perf_counter()
    telemetry.reset()
    print("sched-smoke (docs/scheduling.md):")
    failures = []
    off, on = _run_arm(False), _run_arm(True)
    c_on, x_on, preaborts, journal, sched = on
    steps = (("abort_reduction", lambda: check_abort_reduction((off, on))),
             ("parity", lambda: check_parity(journal)),
             ("prometheus", lambda: check_prometheus(sched)),
             ("disabled_path", check_disabled_path))
    for name, fn in steps:
        try:
            fn()
        except AssertionError as e:
            failures.append(f"{name}: {e}")
    return {"metric": "sched_smoke", "device": str(device), "ok": not failures,
            "failures": failures,
            "off": {"committed": off[0], "conflicted": off[1]},
            "on": {"committed": c_on, "conflicted": x_on, "preaborts": preaborts,
                   "batches": len(journal)},
            "seconds": round(time.perf_counter() - t0, 3)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="taken for a uniform command line; the smoke "
                         "resolves on the host's oracle")
    ap.parse_args(argv)
    out = run("host")
    print(json.dumps(out))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
