"""The port's crash-stop recovery and program cache against the JAX package's.

  * tests/test_recovery.py's epoch-flip parity and torn-snapshot fallback
    (snapshot + differential journal replay through a fresh supervised
    engine), run on each package's stack from the same seed: equal
    RecoveryResults (wall-clock fields aside), equal snapshot files byte
    for byte, equal probe verdicts after the recovery;
  * recover() into a CPU TorchConflictEngine (bare and supervised) from a
    directory the JAX stack wrote: complete, 0 mismatches, and it continues
    the JAX engine's verdict stream;
  * EngineSnapshot wire bytes equal across the packages, SnapshotManager
    cadence and pruning, the RecoveryTracker on the hub;
  * the program cache: entry bytes for one payload equal JAX's with the
    fingerprint held fixed, poisoned / torn / rotted entries quarantined in
    both alike, a stale fingerprint a clean miss, keys separated by history
    structure and run geometry (tests/test_progcache_history.py), and a
    port program (nothing of which loads from disk) counted unverifiable;
  * DiskFaults draws and TornWrite prefixes equal across the packages.

Verdicts are exact: tolerance 0 everywhere.
"""
import dataclasses
import os
import random

import pytest
import torch
from jax.experimental import serialize_executable

from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine
from torch_sim_world import BOTH, JAX, PORT, clean_world

torch.set_num_threads(1)

RES_CFG = dict(dispatch_timeout=0.5, retry_budget=2, retry_backoff=0.02, probe_rate=0.0,
               probation_batches=2, failover_min_batches=2)
#: RecoveryResult fields that read the wall clock
WALL = ("blackout_ms", "warm_ms")


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def supervised(P, inner=None):
    """tests/test_recovery.py's _resilient_oracle over package P (or over
    `inner`), every device-fault rate zeroed."""
    inj = P.inject.FaultInjectingEngine(
        inner if inner is not None else P.oracle.OracleConflictEngine(),
        rates=P.inject.FaultRates(exception=0, hang=0, slow=0, flip=0, outage=0))
    return P.resilient.ResilientEngine(inj, P.resilient.ResilienceConfig(**RES_CFG))


def point_batches(P, n, pool, seed, start_v=0):
    """tests/test_recovery.py's _point_batches from package P's types."""
    rng = random.Random(seed)
    v = start_v
    out = []
    for _ in range(n):
        v += rng.randrange(40, 120)
        txns = []
        for _ in range(rng.randrange(2, 6)):
            t = P.types.CommitTransaction(read_snapshot=max(0, v - rng.randrange(1, 400)))
            k = b"r/%03d" % rng.randrange(pool)
            t.read_conflict_ranges.append(P.types.KeyRange(k, k + b"\x00"))
            t.write_conflict_ranges.append(P.types.KeyRange(k, k + b"\x00"))
            txns.append(t)
        out.append((txns, v, max(0, v - 2000)))
    return out


def crash_sim(P):
    sim = P.simulator.Simulator(47)
    P.buggify.disable()
    return sim


def drive(P, sim, coro):
    try:
        return sim.sched.run_until(sim.sched.spawn(coro), until=100000)
    finally:
        P.loop.set_scheduler(None)


async def resolved(engine, txns, v, old):
    r = engine.resolve(txns, v, old)
    if hasattr(r, "__await__"):
        r = await r
    return [int(x) for x in r]


def live_run(P, directory, stream, flip_v=None, interval=400):
    """Serve `stream` through a supervised oracle with a journal and a
    SnapshotManager in `directory` (the flip recorded at `flip_v`).
    Returns the live engine and the snapshot manager."""
    P.blackbox.install(P.blackbox.BlackboxJournal(str(directory)))
    live = supervised(P)
    mgr = P.recovery.SnapshotManager(str(directory), interval=interval, proc="t")

    async def go():
        for txns, v, old in stream:
            verdicts = await resolved(live, txns, v, old)
            P.blackbox.record_batch(txns, v, old, verdicts,
                                    epoch=(0 if flip_v is None or v < flip_v else 1),
                                    engine="oracle")
            mgr.note_batch(live, v)
            if v == flip_v:
                op = type("Op", (), dict(id=1, kind="split", begin="", end=None, donor_sids=[0],
                                         recipient_sid=1, blackout_ms=3.0, error=None))()
                P.blackbox.record_reshard(op, "flip", epoch=1, flip_version=v)
    return live, mgr, go()


def epoch_flip_recovery(P, directory):
    sim = crash_sim(P)
    stream = point_batches(P, 30, 64, seed=51)
    probes = point_batches(P, 8, 64, seed=52, start_v=stream[-1][1])
    live, mgr, serve = live_run(P, directory, stream, flip_v=stream[14][1])
    out = {}

    async def go():
        await serve
        fresh = supervised(P)
        res = await P.recovery.recover(fresh, str(directory), warm=False)
        out["result"] = {k: v for k, v in res.as_dict().items() if k not in WALL}
        out["probes"] = [(await resolved(live, t, v, o), await resolved(fresh, t, v, o))
                         for t, v, o in probes]
        return res

    res = drive(P, sim, go())
    P.blackbox.uninstall()
    out["snapshots"] = {os.path.basename(p): open(p, "rb").read()
                        for _, p in P.recovery.snapshot_paths(str(directory))}
    out["mgr"] = {k: v for k, v in mgr.stats.items() if k != "ms"}
    events = P.blackbox.read_journal(str(directory))
    out["kinds"] = sorted({e.kind for e in events})
    rec = [e for e in events if e.kind == "recovery"][-1].payload
    out["journaled"] = (rec.mode, rec.verdict_mismatches)
    out["last_version"] = stream[-1][1]
    return res, out


def test_recover_bit_parity_across_epoch_flip_equals_jax(tmp_path):
    """Snapshot + differential replay converges to an engine that continues
    the uninterrupted one's stream bit for bit, across a journal window with
    a reshard epoch flip, in both packages with equal results and equal
    snapshot files."""
    res, port = epoch_flip_recovery(PORT, tmp_path / "port")
    clean_world()
    _, jax_ = epoch_flip_recovery(JAX, tmp_path / "jax")
    assert port == jax_
    R = PORT.recovery
    assert res.error is None and res.mode == R.MODE_COMPLETE and res.coverage_ok
    assert res.snapshot_version >= 0 and res.replayed_batches > 0
    assert res.verdict_mismatches == 0 and res.recovered_version == port["last_version"]
    assert port["mgr"]["written"] >= 1 and len(port["snapshots"]) <= 2
    assert all(a == b for a, b in port["probes"])
    assert "snapshot" in port["kinds"] and "recovery" in port["kinds"]
    assert port["journaled"] == ("complete", 0)


def torn_snapshot(P, directory):
    sim = crash_sim(P)
    P.blackbox.install(P.blackbox.BlackboxJournal(str(directory)))
    live = supervised(P)
    stream = point_batches(P, 12, 48, seed=61)
    out = {}

    async def go():
        for txns, v, old in stream:
            verdicts = await resolved(live, txns, v, old)
            P.blackbox.record_batch(txns, v, old, verdicts, engine="oracle")
        snap = P.recovery.capture(live, proc="t")
        acct = P.recovery.write_snapshot(str(directory), snap)
        good = open(acct["path"], "rb").read()
        torn = P.recovery.snapshot_path(str(directory), snap.version + 999)
        with open(torn, "wb") as f:
            f.write(good[: len(good) // 2])
        out["torn_read"] = P.recovery.read_snapshot(torn)
        out["latest"] = P.recovery.latest_snapshot(str(directory)).version
        out["snapshot_version"] = snap.version
        out["bytes"] = good
        res = await P.recovery.recover(supervised(P), str(directory), warm=False)
        out["result"] = {k: v for k, v in res.as_dict().items() if k not in WALL}

    drive(P, sim, go())
    P.blackbox.uninstall()
    return out


def test_torn_snapshot_tail_falls_back_equals_jax(tmp_path):
    """A torn newest snapshot is rejected by crc and recovery falls back to
    the previous readable one, still converging clean, in both packages."""
    port = torn_snapshot(PORT, tmp_path / "port")
    clean_world()
    assert port == torn_snapshot(JAX, tmp_path / "jax")
    assert port["torn_read"] is None and port["latest"] == port["snapshot_version"]
    r = port["result"]
    assert r["error"] is None and r["mode"] == "complete" and r["coverage_ok"]
    assert r["snapshot_version"] == port["snapshot_version"] and r["verdict_mismatches"] == 0


def small_cfg(**kw):
    return tck.KernelConfig(key_words=2, capacity=1024, max_reads=64, max_writes=64,
                            max_txns=32, **kw)


@pytest.mark.parametrize("target", ["bare", "supervised", "bare_tiered"])
def test_recover_cpu_engine_from_jax_written_directory(tmp_path, target):
    """The JAX stack serves, journals and snapshots; a fresh process's
    port recovers a CPU TorchConflictEngine from that directory: complete,
    covered, 0 mismatches, and it answers the JAX engine's next batches
    with the JAX engine's verdicts."""
    sim = crash_sim(JAX)
    stream = point_batches(JAX, 30, 64, seed=51)
    live, _, serve = live_run(JAX, tmp_path, stream, flip_v=stream[14][1])
    drive(JAX, sim, serve)
    JAX.blackbox.uninstall()
    probes = point_batches(JAX, 8, 64, seed=52, start_v=stream[-1][1])
    sim = crash_sim(JAX)
    want = drive(JAX, sim, _probe_all(live, probes))
    clean_world()

    sim = crash_sim(PORT)
    structure = "tiered" if target == "bare_tiered" else None
    engine = TorchConflictEngine(small_cfg(), device="cpu", ladder=(32,),
                                 history_structure=structure)
    if target == "supervised":
        engine = supervised(PORT, engine)
    res = drive(PORT, sim, PORT.recovery.recover(engine, str(tmp_path), warm=True))
    assert res.error is None and res.mode == "complete" and res.coverage_ok
    assert res.verdict_mismatches == 0 and res.replayed_batches > 0
    assert res.recovered_version == stream[-1][1]
    port_probes = point_batches(PORT, 8, 64, seed=52, start_v=stream[-1][1])
    sim = crash_sim(PORT)
    assert drive(PORT, sim, _probe_all(engine, port_probes)) == want


async def _probe_all(engine, probes):
    return [await resolved(engine, t, v, o) for t, v, o in probes]


def test_engine_snapshot_bytes_equal_and_round_trip(tmp_path):
    """capture() of the same shadow gives equal wire bytes and equal FBSN
    files in both packages; each package reads the other's file."""
    snaps = {}
    for P in BOTH:
        sim = crash_sim(P)
        live = supervised(P)

        async def go():
            for t, v, o in point_batches(P, 20, 32, seed=81):
                await resolved(live, t, v, o)
            return P.recovery.capture(live, proc="p")   # stamped with virtual time
        snap = drive(P, sim, go())
        acct = P.recovery.write_snapshot(str(tmp_path / P.name), snap)
        snaps[P.name] = (P.wire.dumps(snap), open(acct["path"], "rb").read(),
                         os.path.basename(acct["path"]), snap)
        clean_world()
    (pw, pf, pn, psnap), (jw, jf, jn, _) = snaps[PORT.name], snaps[JAX.name]
    assert pw == jw and pf == jf and pn == jn
    assert psnap.entries and psnap.version > 0
    cross = PORT.recovery.read_snapshot(str(tmp_path / JAX.name / jn))
    assert dataclasses.asdict(cross) == dataclasses.asdict(psnap)
    back = JAX.recovery.read_snapshot(str(tmp_path / PORT.name / pn))
    assert JAX.wire.dumps(back) == jw


def test_snapshot_manager_cadence_prune_and_tracker(tmp_path):
    """SnapshotManager writes at its version cadence, keeps `keep` files,
    journals each; the RecoveryTracker registers with the hub and reads
    in-flight age; recovery from an empty directory is cold."""
    sim = crash_sim(PORT)
    PORT.blackbox.install(PORT.blackbox.BlackboxJournal(str(tmp_path)))
    live = supervised(PORT)
    mgr = PORT.recovery.SnapshotManager(str(tmp_path), interval=300, keep=2)

    async def go():
        for t, v, o in point_batches(PORT, 40, 32, seed=91):
            await resolved(live, t, v, o)
            mgr.note_batch(live, v)
    drive(PORT, sim, go())
    PORT.blackbox.uninstall()
    assert mgr.stats["written"] >= 3 and mgr.stats["errors"] == 0
    assert len(PORT.recovery.snapshot_paths(str(tmp_path))) == 2
    kinds = [e.kind for e in PORT.blackbox.read_journal(str(tmp_path))]
    assert kinds.count("snapshot") == mgr.stats["written"]

    tracker = PORT.recovery.RecoveryTracker(now_fn=lambda: 5.0)
    assert tracker.label.startswith("recovery")
    assert PORT.telemetry.hub().recovery_source(tracker.label) is tracker
    tracker.begin()
    tracker.now_fn = lambda: 7.5
    assert tracker.in_flight() and tracker.in_flight_age_s() == 2.5
    sim = crash_sim(PORT)
    empty = tmp_path / "empty"
    empty.mkdir()
    res = drive(PORT, sim, PORT.recovery.recover(supervised(PORT), str(empty), warm=False,
                                                 tracker=tracker))
    assert res.mode == PORT.recovery.MODE_COLD and res.error is None
    assert not tracker.in_flight() and tracker.recoveries == 1 and tracker.failures == 0


# -- the program cache ----------------------------------------------------------

FINGERPRINT = "fixed|backend"
PAYLOAD = (b"\x00program-bytes\xff" * 7, "in-tree", ("out", 3))
KEY = dict(engine="torch", bucket=512, n_chunks=4, search_mode="fused_sort",
           dispatch_mode="step")


@pytest.fixture
def fixed_serializer(monkeypatch):
    """Hold both packages' fingerprint fixed and give both caches the same
    loadable serializer: JAX's serialize_executable pair, the port's
    serialize_program / load_program pair."""
    loaded = []

    def load(payload, in_tree, out_tree):
        loaded.append((payload, in_tree, out_tree))
        return ("program", payload)

    monkeypatch.setattr(serialize_executable, "serialize", lambda compiled: PAYLOAD)
    monkeypatch.setattr(serialize_executable, "deserialize_and_load", load)
    monkeypatch.setattr(PORT.progcache, "serialize_program", lambda compiled: PAYLOAD)
    monkeypatch.setattr(PORT.progcache, "load_program", load)
    for P in BOTH:
        monkeypatch.setattr(P.progcache, "backend_fingerprint", lambda *a: FINGERPRINT)
    return loaded


def test_progcache_entry_bytes_equal_jax(tmp_path, fixed_serializer):
    """One payload, the fingerprint held fixed: the same key, the same file
    name and the same entry bytes; each package loads the other's entry."""
    out = {}
    for P in BOTH:
        cache = P.progcache.ProgramCache(str(tmp_path / P.name))
        key = cache.key(**KEY, structure="tiered:8x256")
        assert cache.store(key, object())
        out[P.name] = (key, cache.entries(), open(cache._path(key), "rb").read(),
                       {k: v for k, v in cache.stats.items() if not k.endswith("_ms")})
    assert out[PORT.name] == out[JAX.name]
    key, _, data, stats = out[PORT.name]
    assert data.startswith(b"FBPC\x01") and stats["stores"] == 1
    port_cache = PORT.progcache.ProgramCache(str(tmp_path / JAX.name))
    assert port_cache.load(key) == ("program", PAYLOAD[0])
    assert port_cache.stats["hits"] == 1


@pytest.mark.parametrize("damage", ["poison", "torn", "rot"])
def test_progcache_damaged_entry_quarantined_like_jax(tmp_path, fixed_serializer, damage):
    """A bad magic, a torn frame or a flipped bit is a miss that removes the
    entry and counts it poisoned, in both packages alike."""
    out = {}
    for P in BOTH:
        cache = P.progcache.ProgramCache(str(tmp_path / P.name))
        key = cache.key(**KEY)
        cache.store(key, object())
        path = cache._path(key)
        data = bytearray(open(path, "rb").read())
        if damage == "poison":
            data[:4] = b"XXXX"
        elif damage == "torn":
            data = data[: len(data) - 9]
        else:
            data[len(data) // 2] ^= 0x10
        open(path, "wb").write(bytes(data))
        got = cache.load(key)
        out[P.name] = (got, os.path.exists(path),
                       {k: v for k, v in cache.stats.items() if not k.endswith("_ms")})
    assert out[PORT.name] == out[JAX.name]
    got, exists, stats = out[PORT.name]
    assert got is None and not exists and stats["poisoned"] == 1 and stats["misses"] == 1


def test_progcache_disk_rot_caught_at_read(tmp_path, fixed_serializer):
    """DiskFaults' bit rot on the progcache surface: store succeeds (the
    write does), and the crc quarantines the entry at load."""
    rot = PORT.inject.DiskFaults(PORT.inject.DiskFaultRates(rot=1.0), seed=5)
    cache = PORT.progcache.ProgramCache(str(tmp_path), disk=rot)
    key = cache.key(**KEY)
    assert cache.store(key, object()) and rot.injected == {"progcache.rot": 1}
    assert cache.load(key) is None and cache.stats["poisoned"] == 1


def test_progcache_stale_fingerprint_is_a_clean_miss(tmp_path, fixed_serializer, monkeypatch):
    """An entry under another toolchain's fingerprint is never loaded and
    never quarantined: a miss, the old entry left in place."""
    cache = PORT.progcache.ProgramCache(str(tmp_path))
    cache.store(cache.key(**KEY), object())
    old = set(cache.entries())
    monkeypatch.setattr(PORT.progcache, "backend_fingerprint", lambda *a: "other|toolchain")
    assert cache.load(cache.key(**KEY)) is None
    assert cache.stats["misses"] == 1 and cache.stats["poisoned"] == 0
    assert set(cache.entries()) == old


def test_progcache_key_separates_history_structure():
    """tests/test_progcache_history.py's key separation: monolithic vs
    tiered vs another run geometry never collide, the monolithic spelling
    hashes like a key without `structure`, and the backend fingerprint
    separates a CPU program from a card program."""
    cache = PORT.progcache.ProgramCache("/tmp/unused-keys-only")
    base = dict(engine="torch", bucket=32, n_chunks=1, search_mode="fused_sort",
                dispatch_mode="step")
    keys = [cache.key(structure=s, **base)
            for s in ("", "tiered:8x256", "tiered:4x256", "tiered:8x512")]
    assert cache.key(**base) == keys[0] and len(set(keys)) == 4
    fp = PORT.progcache.backend_fingerprint(torch.device("cpu"))
    assert fp == f"{torch.__version__}|cpu"


def test_engine_history_fingerprints_equal_jax():
    """The engine-side spelling the key consumes equals the JAX engine's:
    "" monolithic, "tiered:<runs>x<rows>" tiered, run geometry included."""
    from foundationdb_tpu.ops.conflict_kernel import KernelConfig
    from foundationdb_tpu.ops.host_engine import JaxConflictEngine

    for runs in (8, 4):
        jcfg = KernelConfig(key_words=2, capacity=256, max_reads=64, max_writes=64,
                            max_txns=16, history_runs=runs)
        pcfg = tck.KernelConfig(key_words=2, capacity=256, max_reads=64, max_writes=64,
                                max_txns=16, history_runs=runs)
        for structure in (None, "tiered"):
            p = TorchConflictEngine(pcfg, device="cpu", history_structure=structure)
            j = JaxConflictEngine(jcfg, history_structure=structure)
            assert p._history_fingerprint() == j._history_fingerprint()
            assert p._progcache_fingerprint() == j._progcache_fingerprint() == ""
            if structure:
                assert p._history_fingerprint() == f"tiered:{p.cfg.run_slots}x{p.cfg.run_rows}"


def warm_build(structure=None, runs=8):
    kw = {} if structure is None else {"history_structure": structure}
    return TorchConflictEngine(small_cfg(history_runs=runs), device="cpu", ladder=(),
                               scan_sizes=(2,), **kw).warmup()


def test_port_programs_are_unverifiable_and_miss(tmp_path):
    """A port program has no serialized form: every build is a miss, the
    cache refuses to store it (counted under errors; nothing reaches
    verification, nothing is published), the next engine builds again,
    and the ledger files misses, not compiles. A payload planted under a
    key does not load either."""
    PORT.progcache.install(PORT.progcache.ProgramCache(str(tmp_path)))
    first = warm_build()
    s = dict(PORT.progcache.active().stats)
    assert first.perf.compiles == 2 and s["misses"] == 2 and s["hits"] == 0
    assert s["errors"] == 2 and s["unverifiable"] == 0 and s["stores"] == 0
    assert PORT.progcache.active().entries() == []
    again = warm_build()
    assert again.perf.compiles == 2 and PORT.progcache.active().stats["misses"] == 4
    assert again.perf_ledger.progcache == {"miss": 2}
    with pytest.raises(TypeError, match="CUDA has no serialized form"):
        PORT.progcache.serialize_program(first._programs[(32, 1)])
    with pytest.raises(ValueError, match="CUDA has no serialized form"):
        PORT.progcache.load_program(b"", "_Program", None)


@pytest.mark.parametrize("flip", [("tiered", 8), ("monolithic_vs_runs", 4)])
def test_structure_and_run_geometry_flip_are_clean_misses(tmp_path, fixed_serializer, flip):
    """tests/test_progcache_history.py's flips, with a loadable serializer
    standing in for one: a tiered (or other-geometry) build never loads
    the other build's entries — misses, zero hits, zero poisoned — and a
    same-structure rebuild loads everything back without building."""
    PORT.progcache.install(PORT.progcache.ProgramCache(str(tmp_path)))
    structure, runs = flip
    if structure == "tiered":
        warm_build(None)
        other = lambda: warm_build("tiered")
    else:
        warm_build("tiered", runs=8)
        other = lambda: warm_build("tiered", runs=runs)
    s = PORT.progcache.active().stats
    assert s["stores"] >= 1 and s["hits"] == 0
    other()
    assert s["hits"] == 0 and s["poisoned"] == 0 and s["misses"] >= 2
    stores = s["stores"]
    again = other()
    assert s["hits"] >= 1 and s["stores"] == stores and again.perf.compiles == 0


def test_disk_faults_draw_like_jax():
    """The same seed and rates give the same per-write decisions, bytes,
    torn prefixes, ENOSPC raises and counters in both packages; from_knobs
    reads the chaos_disk_* knobs."""
    out = {}
    for P in BOTH:
        df = P.inject.DiskFaults(P.inject.DiskFaultRates(stall=0.1, torn=0.2, enospc=0.2,
                                                         rot=0.3), seed=123,
                                 sleep_fn=lambda s: None)
        log = []
        for i in range(60):
            data = bytes(range(i % 7, i % 7 + 40))
            try:
                log.append(("ok", df.apply(("journal", "snapshot", "progcache")[i % 3], data)))
            except P.inject.TornWrite as e:
                log.append(("torn", e.prefix))
            except OSError as e:
                log.append(("oserror", e.errno))
        out[P.name] = (log, df.injected, dataclasses.asdict(P.inject.DiskFaultRates.from_knobs()))
    assert out[PORT.name] == out[JAX.name]
    assert {k.split(".")[1] for k in out[PORT.name][1]} == {"stall", "torn", "enospc", "rot"}
