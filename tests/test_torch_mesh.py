"""MeshShardedConflictEngine (parallel/mesh_engine.py): the port against
the JAX package on the CPU.

The cases of tests/test_mesh_parity.py with the port's engine, its shards
all on the CPU, and JAX's on its 8 virtual devices beside it where the
case drives both: N in {1, 2, 4, 8} with heat and sampled device timing on
(verdicts equal the oracle's and JAX's; warmup builds every program, the
split "scan" / "exchange" pair under its own progcache variant; no
compile after warmup; 0 blocking syncs; measured exchanges), the ladder
boundary, adversarial splits, `measured_shard_map` adoption (equal to
JAX's from the same heat), and an ElasticResolverGroup of mesh slots in
each package's simulator (duplicate in-flight versions answered and
journaled once; batches straddling a device-shard epoch flip, the moving
range's history handed off by replay; the device view) — each group run
equal to JAX's. The service's "mesh" dispatch mode files its EWMAs under
"mesh", as JAX's does. Every comparison is exact.
"""
import jax
import pytest
import torch

from foundationdb_tpu.core.keyshard import KeyShardMap as JKeyShardMap
from foundationdb_tpu.core.rng import DeterministicRandom
from foundationdb_tpu.core.types import CommitTransaction, KeyRange
from foundationdb_tpu.ops.conflict_kernel import KernelConfig
from foundationdb_tpu.ops.oracle import OracleConflictEngine
from foundationdb_tpu.parallel import mesh_engine as jme
from foundationdb_tpu_torch.core import progcache
from foundationdb_tpu_torch.core.keyshard import KeyShardMap
from foundationdb_tpu_torch.parallel import mesh_engine as tme

from test_kernel_parity import random_txn
from test_torch_conflict_kernel import port_cfg
from test_torch_reshard import CFG as RES_CFG, batch_stream, drive, make_sim
from torch_sim_world import JAX, PORT, clean_world

torch.set_num_threads(1)

SMALL = KernelConfig(key_words=2, capacity=512, max_reads=128, max_writes=128, max_txns=32)


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def ints(xs):
    return [int(x) for x in xs]


def port_mesh(cfg, n, splits=None, **kw):
    sm = KeyShardMap(splits) if splits is not None else KeyShardMap.uniform(n)
    kw.setdefault("ladder", ())
    kw.setdefault("scan_sizes", (2,))
    return tme.MeshShardedConflictEngine(port_cfg(cfg), sm, devices=["cpu"] * sm.n_shards, **kw)


def jax_mesh(cfg, n, splits=None, **kw):
    sm = JKeyShardMap(splits) if splits is not None else JKeyShardMap.uniform(n)
    mesh = jax.make_mesh((sm.n_shards,), ("shard",), devices=jax.devices()[:sm.n_shards])
    kw.setdefault("ladder", ())
    kw.setdefault("scan_sizes", (2,))
    return jme.MeshShardedConflictEngine(cfg, sm, mesh, **kw)


def random_stream(seed, batches=14, txns_per_batch=10):
    rng = DeterministicRandom(seed)
    now, oldest, out = 10, 0, []
    for _ in range(batches):
        now += rng.random_int(1, 30)
        if rng.random01() < 0.3:
            oldest = max(oldest, now - rng.random_int(20, 120))
        out.append(([random_txn(rng, oldest, now, True)
                     for _ in range(rng.random_int(1, txns_per_batch + 1))], now, oldest))
    return out


def point_batch(rng, v, n_txns, pool=200):
    txns = []
    for _ in range(n_txns):
        t = CommitTransaction(read_snapshot=max(0, v - rng.random_int(1, 40)))
        for _ in range(rng.random_int(1, 3)):
            k = b"%05d" % rng.random_int(0, pool)
            t.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
        for _ in range(rng.random_int(0, 2)):
            k = b"%05d" % rng.random_int(0, pool)
            t.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
        txns.append(t)
    return txns


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("overlap", [True, False])
def test_mesh_matches_oracle_and_jax_heat_and_sampling_on(n, overlap):
    eng = port_mesh(SMALL, n, heat_buckets=16, device_time_sample_rate=1.0, overlap=overlap)
    eng.warmup()
    assert sorted(eng._programs) == [(32, 1), (32, 2)]
    compiles = eng.perf.compiles
    assert compiles == 3                       # scan + exchange, the 2-chunk scan
    variants = [r for r in eng.perf_ledger.rows()]
    assert len(variants) == 3
    jeng = jax_mesh(SMALL, n, heat_buckets=16, device_time_sample_rate=1.0, overlap=overlap)
    ora = OracleConflictEngine()
    for txns, now, oldest in random_stream(50 + n):
        want = ints(ora.resolve(txns, now, oldest))
        assert ints(eng.resolve(txns, now, oldest)) == want
        assert ints(jeng.resolve(txns, now, oldest)) == want
    rng = DeterministicRandom(150 + n)
    v = 2000
    for _ in range(5):
        v += rng.random_int(5, 30)
        txns = point_batch(rng, v, rng.random_int(4, 40))
        want = ints(ora.resolve(txns, v, max(0, v - 500)))
        assert ints(eng.resolve(txns, v, max(0, v - 500))) == want
        assert ints(jeng.resolve(txns, v, max(0, v - 500))) == want
    assert eng.perf.compiles == compiles, "mesh dispatch built a program after warmup"
    assert eng.loop_stats["blocking_syncs"] == 0 and eng.loop_stats["units"] > 0
    assert eng.mesh_stats["n_devices"] == eng.mesh_stats["n_shards"] == n
    assert eng.mesh_stats["timed_exchanges"] > 0
    assert eng.mesh_stats["last_collective_ms"] >= 0.0
    assert eng.heat is not None and eng.heat.batches > 0 and eng.perf.device_time
    assert eng.heat_snapshot() == jeng.heat_snapshot()
    assert eng.perf.scan_dispatches == jeng.perf.scan_dispatches
    assert sorted(eng.mesh_stats_snapshot()) == sorted(jeng.mesh_stats_snapshot())
    assert eng.ring_depth() == 0 or overlap
    assert [sorted(r) for r in eng.device_view()] == [sorted(r) for r in jeng.device_view()]


def test_mesh_bucket_ladder_boundaries():
    """Batch sizes k-1, k, k+1 around a k = 32 ladder bucket: the bucket
    flips exactly at the boundary, verdicts equal the oracle's either side."""
    big = KernelConfig(key_words=2, capacity=512, max_reads=256, max_writes=256, max_txns=64)
    eng = port_mesh(big, 8, ladder=[32], scan_sizes=())
    assert [b.max_txns for b in eng.buckets] == [32, 64]
    oracle = OracleConflictEngine()
    rng = DeterministicRandom(61)
    v = 10
    for repeat in range(2):
        for k in (31, 32, 33):
            v += rng.random_int(5, 20)
            txns = point_batch(rng, v, k)
            assert ints(eng.resolve(txns, v, max(0, v - 100))) == \
                ints(oracle.resolve(txns, v, max(0, v - 100))), (repeat, k)
    assert eng.perf.bucket_hits[32] > 0 and eng.perf.bucket_hits[64] > 0


def test_mesh_adversarial_splits_on_frequent_keys():
    eng = port_mesh(SMALL, 8, splits=[b"\x00", b"a", b"a\x00", b"ab", b"b", b"b\x00", b"\xff"])
    oracle = OracleConflictEngine()
    for txns, now, oldest in random_stream(71, batches=16):
        assert ints(eng.resolve(txns, now, oldest)) == ints(oracle.resolve(txns, now, oldest))


def test_measured_shard_map_adoption_equals_jax():
    """A cold aggregator falls back to uniform; after traffic the measured
    split set equals JAX's from the same stream."""
    eng = port_mesh(SMALL, 4, heat_buckets=16)
    jeng = jax_mesh(SMALL, 4, heat_buckets=16)
    m = tme.measured_shard_map(eng.heat, 4)
    assert m.n_shards == 4 and m.begins == KeyShardMap.uniform(4).begins
    for txns, now, oldest in random_stream(81, batches=12):
        eng.resolve(txns, now, oldest)
        jeng.resolve(txns, now, oldest)
    m2, j2 = tme.measured_shard_map(eng.heat, 4), jme.measured_shard_map(jeng.heat, 4)
    assert m2.n_shards == 4 and m2.begins == j2.begins
    assert tme.measured_shard_map(None, 3).begins == KeyShardMap.uniform(3).begins


def test_mesh_knobs_and_progcache_key(tmp_path):
    assert tme.mesh_overlap_requested() and tme.mesh_device_count("cpu") == 1
    PORT.knobs.SERVER_KNOBS.set_knob("resolver_mesh_overlap", "serial")
    PORT.knobs.SERVER_KNOBS.set_knob("resolver_mesh_devices", "3")
    try:
        assert not tme.mesh_overlap_requested() and tme.mesh_device_count("cpu") == 3
        eng = tme.MeshShardedConflictEngine(port_cfg(SMALL), device="cpu", ladder=())
        assert eng.n_shards == 3 and not eng.overlap
        PORT.knobs.SERVER_KNOBS.set_knob("resolver_mesh_overlap", "sometimes")
        with pytest.raises(ValueError, match="resolver_mesh_overlap"):
            tme.mesh_overlap_requested()
    finally:
        PORT.knobs.reset_all()
    cache = progcache.ProgramCache(str(tmp_path))
    progcache.install(cache)
    try:
        eng = port_mesh(SMALL, 2, scan_sizes=())
        eng.warmup()
        rows = [r for r in eng.perf_ledger.rows() if r.get("kind") == "progcache"]
        assert eng._progcache_fingerprint() == "mesh:2/1"
        keys = {cache.key(engine="mesh", bucket=32, n_chunks=1, search_mode="fused_sort",
                          dispatch_mode="mesh", mesh="mesh:2/1", variant=v, device=eng.device)
                for v in ("scan", "exchange")}
        assert len(keys) == 2
        assert cache.stats["misses"] == 2 and cache.stats["errors"] == 2, (cache.stats, rows)
    finally:
        progcache.uninstall()


# ---------------------------------------------------------------------------
# the elastic group over mesh slots, in each package's simulator
# ---------------------------------------------------------------------------

def mesh_factory(P):
    cfg = KernelConfig(key_words=2, capacity=512, max_reads=128, max_writes=128, max_txns=32)

    def make():
        if P is PORT:
            inner = tme.MeshShardedConflictEngine(port_cfg(cfg), KeyShardMap.uniform(2),
                                                  devices=["cpu", "cpu"], ladder=(),
                                                  scan_sizes=())
        else:
            inner = jme.MeshShardedConflictEngine(
                cfg, JKeyShardMap.uniform(2),
                jax.make_mesh((2,), ("shard",), devices=jax.devices()[:2]),
                ladder=(), scan_sizes=())
        inj = P.inject.FaultInjectingEngine(inner, rates=P.inject.FaultRates(
            exception=0, hang=0, slow=0, flip=0, outage=0))
        return inner, inj, P.resilient.ResilientEngine(
            inj, P.resilient.ResilienceConfig(**RES_CFG), record_journal=True)
    return make


def duplicates(P):
    sim = make_sim(P, 19)
    group = P.reshard.ElasticResolverGroup(mesh_factory(P))
    batches = batch_stream(P, 91, 8)
    out = []

    async def go():
        txns, v, old = batches[0]
        a = await group.resolve(txns, v, old)
        b = await group.resolve(txns, v, old)
        out.append((ints(a), ints(b)))
        for txns2, v2, old2 in batches[1:]:
            out.append(ints(await group.resolve(txns2, v2, old2)))
        out.append(ints(await group.resolve(txns, v, old)))
    drive(P, sim, go())
    versions = [v for v, _t, _o, _vd in group.slots[0].engine.journal]
    assert len(versions) == len(set(versions)), "a duplicate delivery re-applied a version"
    assert group.loop_stats is not None and group.loop_stats.get("blocking_syncs", 0) == 0
    assert out[0][0] == out[0][1] == out[-1]
    return out, versions


def test_mesh_group_duplicate_in_flight_versions_equal_jax():
    port = duplicates(PORT)
    clean_world()
    assert port == duplicates(JAX)


def straddle(P):
    sim = make_sim(P, 19)
    group = P.reshard.ElasticResolverGroup(mesh_factory(P))
    extra = group.new_slot()
    clean = P.oracle.OracleConflictEngine()
    pre = batch_stream(P, 92, 8)
    flip_v = pre[-1][1] + 10
    post = [(t, v + flip_v, o) for t, v, o in batch_stream(P, 93, 8)]
    straddler = batch_stream(P, 94, 1, pool=25)[-1]
    got_all = []

    async def go():
        for txns, v, old in pre:
            got = ints(await group.resolve(txns, v, old))
            assert got == ints(clean.resolve(txns, v, old))
            got_all.append(got)
        entries = P.handoff.coalesce(
            P.handoff.shadow_slice(group.slots[0].engine, b"k/030", None), b"k/030", None)
        assert entries, "no history to hand off"
        await P.handoff.replay_slice(extra.engine, entries)
        e = group.emap.flip(P.keyshard.KeyShardMap([b"k/030"]), flip_v)
        group._assign[e] = [group.slots[0].sid, extra.sid]
        txns, v, old = straddler
        assert v < flip_v
        got = ints(await group.resolve(txns, v, old))
        assert got == ints(clean.resolve(txns, v, old))
        got_all.append(got)
        for txns, v, old in post:
            assert group.emap.entry_for_version(v)[0] == e
            got = ints(await group.resolve(txns, v, old))
            assert got == ints(clean.resolve(txns, v, old))
            got_all.append(got)
    drive(P, sim, go())
    assert group.loop_stats.get("blocking_syncs", 0) == 0
    view = group.device_view()
    assert view and {row["sid"] for row in view} == {group.slots[0].sid, extra.sid}
    return got_all, sorted({(row["sid"], row["shard"], row["span_begin"]) for row in view})


def test_mesh_group_epoch_flip_straddle_equals_jax():
    port = straddle(PORT)
    clean_world()
    assert port == straddle(JAX)


def test_service_mesh_dispatch_mode_equals_jax():
    """PipelineConfig(dispatch_mode="mesh"): the BudgetBatcher files its
    EWMAs under "mesh", as JAX's service does, and the mode is served."""
    def case(P, engine):
        svc = P.pipeline.PipelinedResolverService(
            P.pipeline.PipelineConfig(depth=2, max_batch_txns=32, dispatch_mode="mesh",
                                      device_ms_by_bucket={32: 0.5},
                                      queue_enqueue_ms=0.1, result_drain_ms=0.05), engine)
        return svc.cfg.dispatch_mode, svc.batcher.dispatch_mode

    assert case(PORT, port_mesh(SMALL, 2)) == case(JAX, jax_mesh(SMALL, 2)) == ("mesh", "mesh")
