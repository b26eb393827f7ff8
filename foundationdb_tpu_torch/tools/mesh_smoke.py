"""Measured-mesh smoke: the mesh engine's split -> exchange -> apply arc.

Port of ``foundationdb_tpu/tools/mesh_smoke.py``. One process, no sockets.
The reference forces 8 XLA host devices; the port stacks the mesh's 8
shards on ONE device (its `devices` list repeats it: every shard's table
lives there, and the shards' fixpoints run in one launch of the stacked
entry), on the card unless given `--device cpu`:

    python -m foundationdb_tpu_torch.tools.mesh_smoke [--device cpu]

Drives the mesh engine end to end on REAL engines (docs/perf.md
"Measured mesh resolution"):

  1. PARITY — every batch resolved by the mesh-backed elastic group is
     compared against a serial oracle live, pre- AND post- a device-shard
     epoch flip whose moving history slides through the ordinary
     fault/handoff.py replay; every shard journal replays bit-identical
     afterwards too.
  2. NON-BLOCKING RING — the overlapped exchange retires through the
     result ring with `blocking_syncs == 0` group-wide (the same drain
     discipline bar the device loop holds).
  3. ZERO POST-WARMUP BUILDS — warmup covers every dispatched program;
     steady state never builds a program or captures a graph
     (`perf.*.compiles_steady == 0`).
  4. MEASURED EXCHANGE — every active mesh slot reports timed exchange
     intervals (`timed_exchanges > 0`) and its per-shard device view,
     MESH_SHARDS shards on the one device.
  5. MEASURED-SPLIT ADOPTION — a skewed stream's heat histogram yields
     equal-load split keys; `measured_shard_map` adopts them (and they
     differ from the byte-uniform fallback).
  6. EXPOSITION — the hub's prometheus text carries the `fdbtpu_mesh`
     family and passes the strict line parser.

Prints one JSON line naming its device; any failed check exits non-zero.
"""
from __future__ import annotations

import asyncio
import json
import sys
import time

POOL = 384
BATCH = 24
#: shards of every mesh engine the elastic group builds (the reference's 8
#: forced host devices; here all on one device)
MESH_SHARDS = 8


def _key(i: int) -> bytes:
    return b"ms/%06d" % (i % POOL)


async def _drive(device=None) -> dict:
    """Pre-flip traffic, a live device-shard epoch flip through the
    handoff replay, post-flip traffic — parity against a serial oracle
    on every batch. Assertions live in main() (a non-FDBError escaping a
    scheduler task strands the bridged future)."""
    from ..core.rng import DeterministicRandom
    from ..core.keyshard import KeyShardMap
    from ..core.types import CommitTransaction, KeyRange
    from ..fault import handoff
    from ..ops.oracle import OracleConflictEngine
    from ..real.nemesis import make_chaos_engine
    from ..server.reshard import ElasticResolverGroup
    from ..sim.loop import TaskPriority, delay

    rng = DeterministicRandom(3031)
    group = ElasticResolverGroup(lambda: make_chaos_engine("mesh", device=device))
    group.warmup()
    extra = group.new_slot()
    fn = getattr(extra.engine, "warmup", None)
    if fn is not None:
        fn()
    oracle = OracleConflictEngine()

    v = 0
    mismatches = 0
    checked = 0

    async def batch() -> None:
        nonlocal v, mismatches, checked
        v += 100
        txns = []
        for _ in range(BATCH):
            ks = [_key(rng.random_int(0, POOL)) for _ in range(2)]
            ws = [_key(rng.random_int(0, POOL)) for _ in range(2)]
            txns.append(CommitTransaction(
                read_snapshot=max(0, v - rng.random_int(0, 300)),
                read_conflict_ranges=[KeyRange(k, k + b"\x00") for k in ks],
                write_conflict_ranges=[KeyRange(k, k + b"\x00") for k in ws]))
        got = await group.resolve(txns, v, max(0, v - 40_000))
        want = oracle.resolve(txns, v, max(0, v - 40_000))
        checked += len(got)
        mismatches += sum(int(g) != int(w) for g, w in zip(got, want))
        await delay(0.002, TaskPriority.PROXY_COMMIT_BATCHER)

    for _ in range(30):
        await batch()

    # the device-shard epoch flip: the moving range's history slides into
    # the recipient MESH slot through the ordinary handoff replay
    split_key = _key(POOL // 2)
    entries = handoff.coalesce(
        handoff.shadow_slice(group.slots[0].engine, split_key, None),
        split_key, None)
    await handoff.replay_slice(extra.engine, entries)
    flip_v = v + 50
    e = group.emap.flip(KeyShardMap([split_key]), flip_v)
    group._assign[e] = [group.slots[0].sid, extra.sid]
    v = flip_v

    for _ in range(30):
        await batch()

    return {"group": group, "versions": v, "epoch": group.emap.epoch,
            "handoff_entries": len(entries),
            "live_checked": checked, "live_mismatches": mismatches}


def check_live_parity(rec: dict) -> None:
    assert rec["live_checked"] > 0, "no verdicts compared"
    assert rec["live_mismatches"] == 0, \
        f"{rec['live_mismatches']} live mismatches of {rec['live_checked']}"
    checked, mism = rec["group"].parity_check()
    assert checked > 0 and mism == 0, \
        f"journal parity: {mism} mismatches over {checked}"
    print(f"  parity: {rec['live_checked']} live verdicts + {checked} "
          f"journal batches bit-identical across epoch flip "
          f"(handoff moved {rec['handoff_entries']} entries)")


def check_ring(rec: dict) -> None:
    st = rec["group"].loop_stats
    assert st is not None, "mesh slots exposed no loop stats"
    assert st.get("units", 0) > 0, st
    assert st.get("blocking_syncs", 0) == 0, \
        f"mesh ring fell back to a blocking sync: {st}"
    print(f"  ring: {int(st['units'])} units, "
          f"{int(st['drained_nonblocking'])} drained non-blocking, "
          "blocking_syncs=0 group-wide")


def check_steady_compiles(rec: dict) -> None:
    from ..core import telemetry

    telemetry.hub().sync()
    metrics = telemetry.hub().tdmetrics.metrics
    steady = {name: int(m.value) for name, m in metrics.items()
              if name.startswith("perf.") and name.endswith("compiles_steady")}
    assert steady, "no perf ledger series (mesh engines expected)"
    hot = {k: v for k, v in steady.items() if v}
    assert not hot, f"steady-state builds under mesh traffic: {hot}"
    print(f"  steady builds: 0 across {len(steady)} engine ledger(s) "
          "(warmup covered every dispatched program)")


def check_mesh_stats(rec: dict) -> dict:
    from ..core import telemetry

    meshes = telemetry.hub().snapshot().get("meshes") or {}
    assert meshes, "no mesh engines registered with the hub"
    timed = sum(int(m.get("timed_exchanges", 0)) for m in meshes.values())
    assert timed > 0, f"no measured exchange intervals: {meshes}"
    view = rec["group"].device_view()
    assert view, "mesh group reported no device view"
    devs = {row["device"] for row in view}
    shards = {int(m.get("n_shards", 0)) for m in meshes.values()}
    assert shards == {MESH_SHARDS}, \
        f"mesh engines span {shards} shards, expected {MESH_SHARDS}"
    assert len(devs) == 1, f"the shards of one mesh span devices {devs}"
    print(f"  measured exchange: {timed} timed intervals across "
          f"{len(meshes)} mesh engine(s); device view covers "
          f"{len(devs)} device(s) x {len(view)} shard rows")
    return {"timed_exchanges": timed, "mesh_engines": len(meshes),
            "devices": sorted(map(str, devs)), "shard_rows": len(view)}


def check_split_adoption(device=None) -> list:
    from ..core.keyshard import KeyShardMap
    from ..core.rng import DeterministicRandom
    from ..core.types import CommitTransaction, KeyRange
    from ..ops.conflict_kernel import KernelConfig
    from ..parallel.mesh_engine import MeshShardedConflictEngine, \
        measured_shard_map

    cfg = KernelConfig(key_words=2, capacity=512, max_reads=128,
                       max_writes=128, max_txns=32)
    eng = MeshShardedConflictEngine(
        cfg, KeyShardMap.uniform(4), devices=[device] * 4,
        ladder=(), scan_sizes=(), heat_buckets=32)
    rng = DeterministicRandom(77)
    v = 0
    for _ in range(25):
        v += 100
        txns = []
        for _ in range(16):
            # 70% of load inside the top quarter of the keyspace:
            # equal-load splits must crowd into the hot window (keys stay
            # short — <= key_words * 4 bytes — so every txn rides the
            # mesh dispatch unit whose exchange carries the heat plane)
            i = (POOL - POOL // 4 + rng.random_int(0, POOL // 4)
                 if rng.random01() < 0.7 else rng.random_int(0, POOL))
            k = b"%06d" % i
            txns.append(CommitTransaction(
                read_snapshot=max(0, v - rng.random_int(0, 200)),
                read_conflict_ranges=[KeyRange(k, k + b"\x00")],
                write_conflict_ranges=[KeyRange(k, k + b"\x00")]))
        eng.resolve(txns, v, max(0, v - 20_000))
    measured = measured_shard_map(eng.heat, 4)
    uniform = KeyShardMap.uniform(4)
    assert measured.n_shards == 4
    assert measured.begins != uniform.begins, \
        "skewed heat produced the uniform fallback — no measured adoption"
    print("  split adoption: measured equal-load keys "
          f"{[k.decode(errors='replace') for k in measured.begins[1:]]} "
          "(differ from byte-uniform)")
    return list(measured.begins[1:])


def check_prometheus() -> None:
    from ..core import telemetry
    from .heat_smoke import strict_parse_prometheus

    text = telemetry.hub().prometheus_text()
    n = strict_parse_prometheus(text)
    assert "# TYPE fdbtpu_mesh gauge" in text, "no fdbtpu_mesh family"
    lines = [ln for ln in text.splitlines() if ln.startswith("fdbtpu_mesh")]
    assert any("blocking_syncs" in ln for ln in lines), lines[:5]
    assert any("last_collective_us" in ln for ln in lines), lines[:5]
    for ln in lines:
        if "blocking_syncs" in ln:
            assert float(ln.split()[-1]) == 0, f"non-zero sync gauge: {ln}"
    print(f"  prometheus: {n} samples parse strictly, fdbtpu_mesh family "
          f"present ({len(lines)} gauges, blocking_syncs all 0)")


def check_mesh(device=None) -> dict:
    """The drive and checks 1-6; raises AssertionError on a miss. Every
    mesh engine of the group spans MESH_SHARDS shards on `device`
    (the `resolver_mesh_devices` knob, restored afterwards)."""
    from ..core import telemetry
    from ..core.knobs import SERVER_KNOBS
    from ..real.runtime import RealScheduler, sim_to_aio
    from ..sim.loop import TaskPriority, set_scheduler

    telemetry.reset()
    sched = RealScheduler(seed=7)
    set_scheduler(sched)
    knob_was = SERVER_KNOBS.resolver_mesh_devices
    SERVER_KNOBS.set_knob("resolver_mesh_devices", str(MESH_SHARDS))

    async def run() -> dict:
        loop_task = asyncio.ensure_future(sched.run_async())
        task = sched.spawn(_drive(device), TaskPriority.DEFAULT_ENDPOINT,
                           name="mesh-smoke")
        try:
            return await sim_to_aio(task)
        finally:
            sched.shutdown()
            loop_task.cancel()

    out = {}
    try:
        rec = asyncio.run(run())
        out["group"] = rec["group"]
        out["live_checked"] = rec["live_checked"]
        out["handoff_entries"] = rec["handoff_entries"]
        check_live_parity(rec)
        check_ring(rec)
        out["loop_stats"] = dict(rec["group"].loop_stats)
        check_steady_compiles(rec)
        out["mesh"] = check_mesh_stats(rec)
    finally:
        SERVER_KNOBS.set_knob("resolver_mesh_devices", str(knob_was))
        set_scheduler(None)
    out["split_adoption"] = [k.hex() for k in check_split_adoption(device)]
    check_prometheus()
    return out


def run(device: str = "cuda") -> dict:
    """Every check; the result line main prints (the group rides along
    under "group" for a caller that inspects its engines)."""
    import torch

    from .floor_bench import bench_device

    dev = bench_device(device)
    if dev.type == "cpu":
        # a CPU engine in a wall-clock loop shares the host's cores (as a
        # node does, real/node.py)
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    print(f"mesh-smoke [{dev}] (docs/perf.md \"Measured mesh resolution\"):")
    failures, res = [], {}
    try:
        res = check_mesh(dev)
    except AssertionError as e:
        failures.append(str(e))
    print(f"mesh-smoke {'OK' if not failures else 'FAILED'} in "
          f"{time.perf_counter() - t0:.1f}s")
    return {"metric": "mesh_smoke", "device": str(dev), "ok": not failures,
            "failures": failures, **res, "seconds": round(time.perf_counter() - t0, 3)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.device)
    out.pop("group", None)
    print(json.dumps(out, default=str))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
