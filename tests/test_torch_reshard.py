"""The port's online resharding against the JAX package's.

tests/test_reshard.py's cases, each written once over a package namespace
(torch_sim_world) and run on both packages from the same seeds: the
epoched shard map (flip routing, GC, wire round trip, wire bytes equal
across the packages), split points and split_key_within, the elastic
group's 2- and 3-shard parity with one serial oracle (fast and two-phase
paths), a no-trigger group equal to a plain supervised engine,
straddling batches under their submission epoch, duplicate in-flight
versions resolved once, the controller's live split then merge with its
blackouts and EWMA migration, and the handoff primitives (clip_range,
coalesce, shadow_slice, migrate_ewmas) and rebalance_admission. Each
port run must give the JAX assertions' outcome and equal the JAX run:
verdicts, group stats, ops, spans and journal events.

Beyond the mirror: run_slice off a CPU tiered TorchConflictEngine equals
run_slice off a JAX tiered engine on the same stream, equals the shadow
slice after coalesce, and a split whose slot engines are CPU tiered port
engines holds to the serial oracle.

Verdicts are exact: tolerance 0 everywhere.
"""
import dataclasses
import random

import pytest
import torch

from foundationdb_tpu.ops.conflict_kernel import KernelConfig
from foundationdb_tpu.ops.host_engine import JaxConflictEngine
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine
from torch_sim_world import BOTH, JAX, PORT, clean_world

torch.set_num_threads(1)

CFG = dict(dispatch_timeout=0.5, retry_budget=2, retry_backoff=0.02, probe_rate=0.0,
           probation_batches=2, failover_min_batches=2)


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def oracle_factory(P, inner_factory=None):
    """tests/test_reshard.py's oracle_factory over package P: (inner,
    injector, supervised engine with its journal on), rates zeroed."""
    def make():
        inner = inner_factory() if inner_factory else P.oracle.OracleConflictEngine()
        inj = P.inject.FaultInjectingEngine(inner, rates=P.inject.FaultRates(
            exception=0, hang=0, slow=0, flip=0, outage=0))
        return inner, inj, P.resilient.ResilientEngine(inj, P.resilient.ResilienceConfig(**CFG),
                                                       record_journal=True)
    return make


def make_sim(P, seed=17):
    sim = P.simulator.Simulator(seed)
    P.buggify.disable()
    return sim


def drive(P, sim, coro):
    try:
        return sim.sched.run_until(sim.sched.spawn(coro), until=100000)
    finally:
        P.loop.set_scheduler(None)


def batch_stream(P, seed, n, pool=60, prefix=b"k", span_frac=0.2):
    """tests/test_reshard.py's batch_stream (points and wide ranges that
    straddle splits) from package P's types."""
    rng = random.Random(seed)
    KR = P.types.KeyRange
    v = 0
    out = []
    for _ in range(n):
        v += rng.randrange(20, 100)
        txns = []
        for _ in range(rng.randrange(1, 6)):
            t = P.types.CommitTransaction(read_snapshot=max(0, v - rng.randrange(1, 300)))
            for _ in range(rng.randrange(1, 3)):
                a = rng.randrange(pool)
                if rng.random() < span_frac:
                    b = min(pool, a + rng.randrange(2, pool // 2))
                    t.read_conflict_ranges.append(KR(b"%s/%03d" % (prefix, a),
                                                     b"%s/%03d" % (prefix, b)))
                else:
                    k = b"%s/%03d" % (prefix, a)
                    t.read_conflict_ranges.append(KR(k, k + b"\x00"))
            for _ in range(rng.randrange(0, 3)):
                a = rng.randrange(pool)
                if rng.random() < span_frac:
                    b = min(pool, a + rng.randrange(2, pool // 4))
                    t.write_conflict_ranges.append(KR(b"%s/%03d" % (prefix, a),
                                                      b"%s/%03d" % (prefix, b)))
                else:
                    k = b"%s/%03d" % (prefix, a)
                    t.write_conflict_ranges.append(KR(k, k + b"\x00"))
            txns.append(t)
        out.append((txns, v, max(0, v - 1500)))
    return out


def hot_batches(P, n, pool, hot_lo, hot_hi, seed, start_v=0, frac=0.85):
    rng = random.Random(seed)
    v = start_v
    out = []
    for _ in range(n):
        v += 100
        txns = []
        for _ in range(24):
            a = rng.randrange(hot_lo, hot_hi) if rng.random() < frac else rng.randrange(pool)
            k = b"k/%03d" % a
            txns.append(P.types.CommitTransaction(
                read_snapshot=max(0, v - rng.randrange(1, 200)),
                read_conflict_ranges=[P.types.KeyRange(k, k + b"\x00")],
                write_conflict_ranges=[P.types.KeyRange(k, k + b"\x00")]))
        out.append((txns, v, max(0, v - 2000)))
    return out


def ints(xs):
    return [int(x) for x in xs]


def manual_split(P, group, splits, sids_of):
    e = group.emap.flip(P.keyshard.KeyShardMap(splits), 1)
    group._assign[e] = sids_of
    return e


def both(fn, *args):
    """Run fn(P, *args) on the port, then on JAX; assert equal; return the
    port's result."""
    port = fn(PORT, *args)
    clean_world()
    assert port == fn(JAX, *args)
    return port


# -- the epoched shard map ------------------------------------------------------

def epoched_map(P):
    K = P.keyshard
    em = K.EpochedKeyShardMap(K.KeyShardMap([]))
    out = [em.epoch, em.current().n_shards,
           em.flip(K.KeyShardMap([b"m"]), 500), em.flip(K.KeyShardMap([b"g", b"m"]), 900)]
    out += [em.map_for_version(v).n_shards for v in (499, 500, 899, 900)]
    out.append(em.entry_for_version(700)[0])
    em.gc(600)
    out.append([e for e, _fv, _m in em.epochs])
    out.append(em.map_for_version(600).n_shards)
    em.gc(2000)
    out.append([e for e, _fv, _m in em.epochs])
    em2 = K.EpochedKeyShardMap(K.KeyShardMap([]))
    em2.flip(K.KeyShardMap([b"m"]), 500)
    em2.flip(K.KeyShardMap([b"g", b"m", b"t"]), 900)
    raw = P.wire.dumps(em2)
    back = P.wire.loads(raw)
    out += [raw, [(e, fv, m.begins) for e, fv, m in back.epochs], back.as_dict() == em2.as_dict()]
    out.append(P.wire.dumps(K.KeyShardMap([b"a", b"q"])))
    out.append(K.KeyShardMap.uniform(4).begins)
    out.append(K.KeyShardMap.from_split_points([b"", b"b", b"b"], 3).begins)
    out.append(K.KeyShardMap([b"g", b"m"]).shard_of_key(b"h"))
    return out


def test_epoched_map_flip_routing_gc_and_wire_equal_jax():
    out = both(epoched_map)
    assert out[:4] == [0, 1, 1, 2]
    assert out[4:8] == [1, 2, 2, 3] and out[8] == 1
    assert out[9] == [1, 2] and out[10] == 2 and out[11] == [2]
    assert out[14] is True


def test_epoched_map_flip_must_advance():
    K = PORT.keyshard
    em = K.EpochedKeyShardMap(K.KeyShardMap([]))
    em.flip(K.KeyShardMap([b"m"]), 900)
    with pytest.raises(ValueError, match="not above newest"):
        em.flip(K.KeyShardMap([b"z"]), 900)


def split_key_within(P):
    agg = P.heatmap.KeyRangeHeatAggregator(key_words=4, capacity=0, buckets=0, decay=1.0)
    T = P.types
    for i in range(16):
        k = b"q/%03d" % i
        agg.observe_batch([T.CommitTransaction(read_snapshot=1, write_conflict_ranges=[
            T.KeyRange(k, k + b"\x00")])], [int(T.TransactionCommitResult.COMMITTED)],
            version=10 + i)
    return (agg.split_key_within(b"q/000", b"q/016"), agg.split_key_within(b"q/003", b"q/004"),
            agg.split_points(4), agg.split_balance(2, [b"q/008"]))


def test_split_key_within_span_equals_jax():
    k, none, _, _ = both(split_key_within)
    assert k is not None and b"q/000" < k < b"q/016" and none is None


# -- elastic group resolution parity ---------------------------------------------

def group_parity(P, splits, seed):
    sim = make_sim(P)
    group = P.reshard.ElasticResolverGroup(oracle_factory(P))
    extra = [group.new_slot() for _ in splits]
    manual_split(P, group, splits, [group.slots[0].sid] + [s.sid for s in extra])
    clean = P.oracle.OracleConflictEngine()
    got = []

    async def go():
        for txns, v, old in batch_stream(P, seed, 40):
            g = ints(await group.resolve(txns, v, old))
            assert g == ints(clean.resolve(txns, v, old)), v
            got.append(g)
    drive(P, sim, go())
    return got, dict(group.extra_stats), group.parity_check(), group.stats, \
        group.health_stats()["per_shard"]


@pytest.mark.parametrize("splits,seed", [([b"k/030"], 5), ([b"k/020", b"k/040"], 9)])
def test_elastic_group_parity_vs_serial_oracle_equals_jax(splits, seed):
    """Verdicts of a 2- and a 3-shard group (fast path and the cross-shard
    two-phase exchange) equal one serial oracle's, and the JAX group's."""
    _, extra, (checked, mismatches), _, _ = both(group_parity, splits, seed)
    assert extra["two_phase_batches"] > 0 and extra["fast_batches"] > 0
    assert checked > 0 and mismatches == 0


def no_trigger(P):
    sim = make_sim(P)
    plain = oracle_factory(P)()[2]
    group = P.reshard.ElasticResolverGroup(oracle_factory(P))
    ctl = P.reshard.ReshardController(group, min_heat_batches=10**9)
    got_group, got_plain = [], []

    async def go():
        for txns, v, old in batch_stream(P, 13, 30):
            got_plain.append(ints(await plain.resolve(txns, v, old)))
            got_group.append(ints(await group.resolve(txns, v, old)))
            assert ctl.plan() is None
    drive(P, sim, go())
    aborts = lambda eng: [ints(vd) for _v, _t, _o, vd in eng.journal]
    return (got_group, got_plain, aborts(group.slots[0].engine), aborts(plain), ctl.executed,
            group.emap.epoch)


def test_elastic_no_trigger_bit_identical_to_plain_engine_equals_jax():
    gg, gp, ag, ap, executed, epoch = both(no_trigger)
    assert gg == gp and ag == ap and executed == 0 and epoch == 0


def straddling(P):
    sim = make_sim(P)
    group = P.reshard.ElasticResolverGroup(oracle_factory(P))
    extra = group.new_slot()
    clean = P.oracle.OracleConflictEngine()
    pre = batch_stream(P, 21, 10)
    flip_v = pre[-1][1] + 10
    post = [(t, v + flip_v, o) for t, v, o in batch_stream(P, 22, 10)]
    straddler = batch_stream(P, 23, 1, pool=25)[-1]
    got = []

    async def go():
        for txns, v, old in pre:
            g = ints(await group.resolve(txns, v, old))
            assert g == ints(clean.resolve(txns, v, old))
            got.append(g)
        entries = P.handoff.coalesce(
            P.handoff.shadow_slice(group.slots[0].engine, b"k/030", None), b"k/030", None)
        assert entries, "no history to hand off"
        await P.handoff.replay_slice(extra.engine, entries)
        e = group.emap.flip(P.keyshard.KeyShardMap([b"k/030"]), flip_v)
        group._assign[e] = [group.slots[0].sid, extra.sid]
        txns, v, old = straddler
        assert v < flip_v and group.emap.entry_for_version(v)[0] == 0
        g = ints(await group.resolve(txns, v, old))
        assert g == ints(clean.resolve(txns, v, old))
        got.append(g)
        for txns, v, old in post:
            assert group.emap.entry_for_version(v)[0] == e
            g = ints(await group.resolve(txns, v, old))
            assert g == ints(clean.resolve(txns, v, old))
            got.append(g)
        return entries
    entries = drive(P, sim, go())
    return got, entries


def test_straddling_batches_resolve_under_submission_epoch_equals_jax():
    got, entries = both(straddling)
    assert len(got) == 21 and entries


def duplicates(P):
    sim = make_sim(P)
    group = P.reshard.ElasticResolverGroup(oracle_factory(P))
    batches = batch_stream(P, 31, 12)

    async def go():
        txns, v, old = batches[0]
        a = ints(await group.resolve(txns, v, old))
        assert a == ints(await group.resolve(txns, v, old))
        for txns2, v2, old2 in batches[1:]:
            await group.resolve(txns2, v2, old2)
        txns3, v3, old3 = batch_stream(P, 32, 1)[0]
        v3 += batches[-1][1]
        f1 = sim.sched.spawn(group.resolve(txns3, v3, old3))
        f2 = sim.sched.spawn(group.resolve(txns3, v3, old3))
        r1, r2 = ints(await f1), ints(await f2)
        assert r1 == r2
        assert ints(await group.resolve(txns, v, old)) == a
        return a, r1
    out = drive(P, sim, go())
    versions = [v for v, _t, _o, _vd in group.slots[0].engine.journal]
    return out, versions, sim.sched.tasks_run


def test_duplicate_in_flight_versions_resolve_once_equals_jax():
    _, versions, _ = both(duplicates)
    assert len(versions) == len(set(versions)), "a duplicate delivery re-applied a version"


# -- the live handoff ----------------------------------------------------------

def split_then_merge(P, journal_dir, factory=None):
    sim = make_sim(P)
    P.trace.g_spans.enabled = True
    P.trace.g_spans.clear()
    P.blackbox.install(P.blackbox.BlackboxJournal(str(journal_dir), fresh=True))
    budget = float(P.knobs.SERVER_KNOBS.reshard_blackout_budget_ms)
    group = P.reshard.ElasticResolverGroup(
        factory or oracle_factory(P),
        make_batcher=lambda: P.resolver_pipeline.BudgetBatcher([16, 48]))
    group.prewarm_spares(1)
    ctl = P.reshard.ReshardController(group, min_heat_batches=5)
    ctl._last_done = -100.0
    clean = P.oracle.OracleConflictEngine()
    pool = 96
    phase1 = hot_batches(P, 30, pool, 60, 92, seed=41)
    v0 = phase1[-1][1]
    got = []

    async def serve(batches):
        for txns, v, old in batches:
            g = ints(await group.resolve(txns, v, old))
            assert g == ints(clean.resolve(txns, v, old)), v
            got.append(g)

    async def go():
        await serve(phase1)
        plan = ctl.plan()
        assert plan is not None and plan["kind"] == "split", plan
        op = await ctl.execute(plan)
        assert op is not None and op.state == "done", op
        assert op.prewarmed and op.flip_version == v0 + 1 and group.emap.epoch == 1
        assert op.blackout_ms <= budget and op.precopied > 0
        await serve(hot_batches(P, 20, pool, 0, pool, seed=42, start_v=v0, frac=0.0))
        checked, mismatches = group.parity_check()
        assert checked > 0 and mismatches == 0
        v = v0 + 20 * 100
        plan = None
        for _ in range(60):
            batches = hot_batches(P, 5, 40, 0, 8, seed=43, start_v=v)
            await serve(batches)
            v = batches[-1][1]
            plan = ctl.plan()
            if plan is not None and plan["kind"] == "merge":
                break
        if plan is not None and plan["kind"] == "merge":
            op2 = await ctl.execute(plan)
            assert op2 is not None and op2.state == "done", op2
            await serve(hot_batches(P, 10, 40, 0, 40, seed=44, start_v=v, frac=0.0))
    drive(P, sim, go())
    P.blackbox.uninstall()
    P.trace.g_spans.enabled = False
    spans = [s for s in P.trace.g_spans.spans if s["Name"].startswith("reshard.")]
    snap = ctl.snapshot()
    events = [(e.kind, e.seq, dataclasses.asdict(e.payload))
              for e in P.blackbox.read_journal(str(journal_dir)) if e.kind == "reshard"]
    return {"verdicts": got, "ops": [op.as_dict() for op in ctl.ops],
            "executed": ctl.executed, "stalled": ctl.stalled,
            "over_budget": ctl.blackout_over_budget, "windows": ctl.windows,
            "group": dict(group.extra_stats), "parity": group.parity_check(),
            "epoch_map": group.emap.as_dict(), "snapshot_epoch": snap["epoch"],
            "reshard_events": events, "spans": spans,
            "world": (sim.sched.rng.random01(), sim.sched.time, sim.sched.tasks_run)}


def test_controller_split_then_merge_live_handoff_equals_jax(tmp_path):
    """Hot load -> split plan -> pre-copy / freeze / delta / flip -> verdicts
    stay oracle-equal through the cutover; the load cools -> merge; the
    blackouts are in budget; the ops, windows, journal events and spans
    equal the JAX controller's."""
    port = split_then_merge(PORT, tmp_path / "port")
    clean_world()
    jax_ = split_then_merge(JAX, tmp_path / "jax")
    assert port == jax_
    assert port["executed"] >= 1 and port["stalled"] == 0 and port["over_budget"] == 0
    assert any(w["kind"] == "reshard" for w in port["windows"])
    assert any(w["kind"] == "reshard_arc" for w in port["windows"])
    assert port["parity"][0] > 0 and port["parity"][1] == 0
    assert {e[2]["phase"] for e in port["reshard_events"]} >= {"warm", "precopy", "frozen",
                                                               "flip", "done"}
    assert {s["Name"] for s in port["spans"]} == {"reshard.warm", "reshard.precopy",
                                                  "reshard.transfer", "reshard.cutover",
                                                  "reshard.blackout"}


# -- the handoff primitives ----------------------------------------------------

def test_clip_range():
    for P in BOTH:
        h = P.handoff
        assert h.clip_range(b"a", b"m", b"c", b"t") == (b"c", b"m")
        assert h.clip_range(b"a", b"c", b"c", b"t") is None
        assert h.clip_range(b"x", b"z", b"c", None) == (b"x", b"z")
        assert h.clip_range(b"a", b"b", b"c", None) is None


def coalesce_case(P):
    rng = random.Random(55)
    entries = []
    v = 0
    for _ in range(60):
        v += rng.randrange(5, 40)
        writes = []
        for _ in range(rng.randrange(1, 4)):
            a = rng.randrange(40)
            writes.append((b"h/%03d" % a, b"h/%03d" % (a + rng.randrange(1, 6))))
        entries.append((v, tuple(writes)))
    coalesced = P.handoff.coalesce(entries, b"h/", b"h/\xff")
    assert len(coalesced) <= len(entries)

    def replay(entry_list):
        o = P.oracle.OracleConflictEngine()
        for ver, writes in entry_list:
            o.resolve([P.types.CommitTransaction(read_snapshot=ver, write_conflict_ranges=[
                P.types.KeyRange(b, e) for b, e in writes])], ver, 0)
        return o

    prng = random.Random(56)
    probes = []
    for _ in range(200):
        k = b"h/%03d" % prng.randrange(44)
        probes.append(P.types.CommitTransaction(read_snapshot=prng.randrange(v + 1),
                                                read_conflict_ranges=[P.types.KeyRange(
                                                    k, k + b"\x00")]))
    raw = ints(replay(entries).resolve(probes, v + 10, 0))
    coal = ints(replay(coalesced).resolve(probes, v + 10, 0))
    assert raw == coal
    return coalesced, raw


def test_coalesce_preserves_effective_history_equals_jax():
    coalesced, _ = both(coalesce_case)
    assert coalesced


def shadow_slices(P):
    sim = make_sim(P)
    eng = oracle_factory(P)()[2]

    async def go():
        for txns, v, old in batch_stream(P, 61, 15):
            await eng.resolve(txns, v, old)
    drive(P, sim, go())
    full = P.handoff.shadow_slice(eng, b"", None)
    lo = P.handoff.shadow_slice(eng, b"k/020", b"k/040")
    wm = P.handoff.last_shadow_version(eng)
    return full, lo, wm, max(e[0] for e in eng._shadow), \
        P.handoff.shadow_slice(eng, b"", None, min_version=wm)


def test_shadow_slice_clips_and_watermarks_equals_jax():
    full, lo, wm, newest, after = both(shadow_slices)
    assert full
    for _v, writes in lo:
        for b, e in writes:
            assert b >= b"k/020" and e <= b"k/040"
    assert wm >= max(v for v, _w in full) and wm == newest and after == []


def migrate(P):
    B = P.resolver_pipeline.BudgetBatcher
    src, dst = B([16, 48]), B([16, 48])
    src.observe(16, 5.0)
    src.observe(48, 9.0)
    key16 = next(k for k in src.ewma_ms if k[0] == 16)
    dst.observe(16, 2.0)
    before = dst.ewma_ms[key16]
    copied = P.handoff.migrate_ewmas(src, dst)
    key48 = next(k for k in src.ewma_ms if k[0] == 48)
    return (copied, dst.ewma_ms[key16] == before, dst.ewma_ms[key48] == src.ewma_ms[key48],
            P.handoff.migrate_ewmas(None, dst), sorted(dst.ewma_ms.items()))


def test_migrate_ewmas_recipient_keys_win_equals_jax():
    copied, kept, moved, none, _ = both(migrate)
    assert copied >= 1 and kept and moved and none == 0


def rebalance(P):
    agg = P.heatmap.KeyRangeHeatAggregator(key_words=4, capacity=0, buckets=0, decay=1.0)
    T = P.types
    txns = [T.CommitTransaction(read_snapshot=1, write_conflict_ranges=[
        T.KeyRange(k, k + b"\x00")]) for k in [b"hot/%05d" % i for i in range(30)]
            + [b"cold/%05d" % i for i in range(10)]]
    agg.observe_batch(txns, [int(T.TransactionCommitResult.COMMITTED)] * len(txns), version=10)

    class Admission:
        """The admission attributes rebalance_admission reads and sets."""
        def __init__(self):
            self.admitted, self.rejected, self.weights = {"idle": 3}, {}, {}

    adm = Admission()
    weights = P.reshard.rebalance_admission(adm, agg)
    return weights, adm.weights


def test_rebalance_admission_weights_follow_heat_equals_jax():
    """rebalance_admission on any object with the admission's attributes
    (the JAX test's TenantAdmission comes with the ratekeeper)."""
    weights, set_weights = both(rebalance)
    assert weights["hot"] > weights["cold"] > weights["idle"] > 0
    assert set_weights == weights
    assert sum(weights.values()) / len(weights) == pytest.approx(1.0)
    assert weights["hot"] > 1.0 > weights["idle"]


# -- run_slice off the engines' run planes -------------------------------------------

TCFG = dict(key_words=2, capacity=1024, max_reads=64, max_writes=64, max_txns=32,
            history_runs=8)


def tiered_stream(P, seed=71, n=6, pool=48):
    """Point writes (and reads) over a k/NNN pool: few enough batches that
    the 8 run slots hold them all, no merge."""
    rng = random.Random(seed)
    out = []
    v = 0
    for _ in range(n):
        v += 50
        txns = []
        for _ in range(rng.randrange(4, 12)):
            k = b"k/%03d" % rng.randrange(pool)
            w = b"k/%03d" % rng.randrange(pool)
            txns.append(P.types.CommitTransaction(
                read_snapshot=max(0, v - rng.randrange(1, 80)),
                read_conflict_ranges=[P.types.KeyRange(k, k + b"\x00")],
                write_conflict_ranges=[P.types.KeyRange(w, w + b"\x00")]))
        out.append((txns, v, 0))
    return out


def run_slices(P, engine_factory):
    sim = make_sim(P)
    eng = oracle_factory(P, engine_factory)()[2]

    async def go():
        marks = P.handoff.run_watermarks(eng)
        for txns, v, old in tiered_stream(P):
            await eng.resolve(txns, v, old)
        full = P.handoff.run_slice(eng, b"k/010", b"k/030")
        delta = P.handoff.run_slice(eng, b"k/010", b"k/030", since_runs=marks[0],
                                    since_epoch=marks[1])
        shadow = P.handoff.coalesce(P.handoff.shadow_slice(eng, b"k/010", b"k/030"),
                                    b"k/010", b"k/030")
        return marks, full, delta, shadow, P.handoff.run_watermarks(eng)
    return drive(P, sim, go())


def test_run_slice_off_cpu_tiered_engine_equals_jax_and_shadow():
    """run_slice reads the tiered engine's un-merged runs back as
    range-clipped, version-grouped entries: the CPU port engine's equal the
    JAX tiered engine's, and after coalesce they equal the shadow slice's."""
    port = run_slices(PORT, lambda: TorchConflictEngine(tck.KernelConfig(**TCFG), device="cpu",
                                                        history_structure="tiered"))
    clean_world()
    jax_ = run_slices(JAX, lambda: JaxConflictEngine(KernelConfig(**TCFG),
                                                     history_structure="tiered"))
    assert port == jax_
    marks, full, delta, shadow, after = port
    assert marks == ([0], 0) and full is not None and not full["resync"]
    assert full["entries"] and delta["entries"] == full["entries"]
    assert PORT.handoff.coalesce(full["entries"], b"k/010", b"k/030") == shadow
    assert after[0][0] == len(tiered_stream(PORT))


def test_run_slice_none_for_monolithic_and_window_truncated_keys():
    """A monolithic donor cannot serve the run path (None: the group uses
    the shadow), and neither can a run row whose key the packed window
    truncated."""
    sim = make_sim(PORT)
    mono = oracle_factory(PORT, lambda: TorchConflictEngine(tck.KernelConfig(**TCFG),
                                                             device="cpu"))()[2]
    long_cfg = dict(TCFG, key_words=1)
    tiered = oracle_factory(PORT, lambda: TorchConflictEngine(
        tck.KernelConfig(**long_cfg), device="cpu", history_structure="tiered"))()[2]
    T = PORT.types
    async def go():
        # a range write whose end key is longer than the packed window:
        # its run row holds the truncated end
        txn = T.CommitTransaction(read_snapshot=10, write_conflict_ranges=[
            T.KeyRange(b"k/", b"k/0123456789")])
        await mono.resolve([txn], 20, 0)
        await tiered.resolve([txn], 20, 0)
    drive(PORT, sim, go())
    assert PORT.handoff.run_watermarks(mono) is None
    assert PORT.handoff.run_slice(mono, b"", None) is None
    assert PORT.handoff.run_slice(tiered, b"", None) is None


def test_split_over_cpu_tiered_port_engines_holds_to_serial_oracle(tmp_path):
    """The live split with every slot a supervised CPU tiered port engine:
    the pre-copy reads the donor's runs (run_slice), and every verdict
    equals the serial oracle's and the oracle-slot group's."""
    def factory():
        return oracle_factory(PORT, lambda: TorchConflictEngine(
            tck.KernelConfig(key_words=2, capacity=4096, max_reads=64, max_writes=64,
                             max_txns=32, history_runs=8),
            device="cpu", history_structure="tiered", ladder=()))()
    engines = split_then_merge(PORT, tmp_path / "tiered", factory)
    clean_world()
    oracles = split_then_merge(PORT, tmp_path / "oracle")
    assert engines["verdicts"] == oracles["verdicts"]
    assert engines["parity"][1] == 0 and engines["executed"] >= 1


def tiered_engine_factory(P):
    """A small tiered engine of package P (the port's on the CPU)."""
    fields = dict(key_words=4, capacity=16384, max_txns=256, max_reads=16, max_writes=16,
                  max_point_reads=512, max_point_writes=512)
    if P is PORT:
        return lambda: TorchConflictEngine(tck.KernelConfig(**fields), device="cpu", ladder=(),
                                           scan_sizes=(2,), history_structure="tiered")

    def jax_engine():
        # a program takes the table as an argument: engines of one config
        # share them (one compile per program for the module)
        eng = JaxConflictEngine(KernelConfig(**fields), ladder=(), scan_sizes=(2,),
                                history_structure="tiered")
        eng._programs = _JAX_TIERED_PROGRAMS
        return eng
    return jax_engine


_JAX_TIERED_PROGRAMS = {}


def split_under_load(P, concurrent=1, seed=2026):
    """A split of a group of supervised tiered engines while one batch is
    served concurrently: the pre-copy's delta round reads that batch off
    the donor's runs (run_slice) and leaves it to the frozen transfer.
    Returns the versions whose verdicts differ from the serial oracle's,
    the op's pre-copy / delta counts and each run_slice's (resync,
    entries)."""
    import numpy as np

    sim = make_sim(P)
    group = P.reshard.ElasticResolverGroup(oracle_factory(P, tiered_engine_factory(P)))
    group.prewarm_spares(1)
    ctl = P.reshard.ReshardController(group, min_heat_batches=8)
    ctl._last_done = -100.0
    oracle = P.oracle.OracleConflictEngine()
    rng = np.random.default_rng(seed)
    T = P.types

    def traffic(n, start):
        out, now = [], start
        for b in range(n):
            now += 5000
            k = (20, 30, 50)[b % 3]
            lag, hot = rng.integers(0, 10000, size=k), rng.random(k) < 0.5
            hk, cold = rng.integers(0, 64, size=k) + 4064, rng.integers(0, 8192, size=(k, 4))
            txns = []
            for i in range(k):
                t = T.CommitTransaction(read_snapshot=int(max(0, now - lag[i])))
                keys = [b"r/%013d" % hk[i]] * 2 if hot[i] else [b"r/%013d" % x for x in cold[i]]
                for j, key in enumerate(keys):
                    (t.read_conflict_ranges if j < len(keys) // 2
                     else t.write_conflict_ranges).append(T.KeyRange(key, key + b"\x00"))
                txns.append(t)
            out.append((txns, now, max(0, now - 20000)))
        return out

    first = traffic(24, 10000)
    later = traffic(6, first[-1][1])
    bad, slices = [], []
    run_slice = P.handoff.run_slice

    def logged(*a, **k):
        got = run_slice(*a, **k)
        slices.append(None if got is None else (got["resync"], len(got["entries"])))
        return got

    async def serve(part):
        for txns, v, old in part:
            if ints(await group.resolve(txns, v, old)) != ints(oracle.resolve(txns, v, old)):
                bad.append(v)

    async def go():
        await serve(first[:-concurrent])
        plan = ctl.plan()
        P.handoff.run_slice = logged
        load = sim.sched.spawn(serve(first[-concurrent:]))
        try:
            op = await ctl.execute(plan)
        finally:
            P.handoff.run_slice = run_slice
        await load
        await serve(later)
        return op

    op = drive(P, sim, go())
    return bad, op.state, op.precopied, op.delta, slices


def test_split_under_load_over_tiered_engines_keeps_the_run_delta():
    """The pre-copy round that finds the delta small leaves it to a later
    replay. The port keeps that round's run watermark, so its catch-up
    round (before the freeze) replays the batch served during the pre-copy,
    the frozen transfer finds nothing left, and every verdict equals the
    serial oracle's. The reference advances the watermark on that round,
    replays nothing in the transfer, and its recipient misses a committed
    write of the moving range: a verdict after the flip differs from the
    serial oracle's (a standing note on the reference)."""
    bad, state, precopied, delta, slices = split_under_load(PORT)
    assert bad == [] and state == "done" and precopied > 0 and delta == 0
    assert slices and all(s is not None and not s[0] for s in slices)
    clean_world()
    jbad, jstate, jprecopied, jdelta, _ = split_under_load(JAX)
    assert jstate == "done" and jdelta == 0 and jbad, "the reference lost no delta here"
    # the one batch the reference loses is the one the port's catch-up replays
    assert precopied == jprecopied + 1


# -- a difference by design: the batch in flight lands before the freeze -----

def split_with_slow_batches(P, batch_s=0.03, gap_s=0.01, seed=45):
    """A split while each batch takes `batch_s` of virtual time to resolve
    (a loaded host's eager resolve, in the simulator) and the next arrives
    `gap_s` after it: the controller reaches its freeze with a batch in
    flight. Returns (the verdicts served, the versions whose verdicts
    differ from the serial oracle's, the op)."""
    sim = make_sim(P)
    group = P.reshard.ElasticResolverGroup(oracle_factory(P))
    group.prewarm_spares(1)
    ctl = P.reshard.ReshardController(group, min_heat_batches=5)
    ctl._last_done = -100.0
    oracle = P.oracle.OracleConflictEngine()
    pool = 96
    warm = hot_batches(P, 30, pool, 60, 92, seed=seed)
    load = hot_batches(P, 40, pool, 60, 92, seed=seed + 1, start_v=warm[-1][1])
    got, bad = [], []
    fast = group._resolve_fast

    async def slow_fast(*a, **k):
        await P.loop.delay(batch_s)
        return await fast(*a, **k)

    async def serve(batches, gap=0.0):
        for txns, v, old in batches:
            g = ints(await group.resolve(txns, v, old))
            if g != ints(oracle.resolve(txns, v, old)):
                bad.append(v)
            got.append(g)
            if gap:
                await P.loop.delay(gap)

    async def go():
        await serve(warm)
        plan = ctl.plan()
        assert plan is not None and plan["kind"] == "split", plan
        group._resolve_fast = slow_fast
        load_task = sim.sched.spawn(serve(load, gap=gap_s))
        await P.loop.delay(batch_s / 2)
        op = await ctl.execute(plan)
        await load_task
        return op

    op = drive(P, sim, go())
    return got, bad, op


def test_batch_in_flight_lands_before_the_freeze_and_the_verdicts_equal_jax():
    """The port waits out the batch in flight before it freezes
    (server/reshard.py, `await g.quiesce()` ahead of `g.freeze`); the
    reference freezes first and waits for it inside the blackout. With
    every batch taking 30 virtual ms, both packages give the serial
    oracle's verdicts, the same verdicts, the same batches replayed in
    all, and the port's blackout leaves the in-flight wait out. The batch
    that lands in that wait is replayed by the port's catch-up round before
    the freeze, and by the reference's frozen transfer."""
    pgot, pbad, pop = split_with_slow_batches(PORT)
    clean_world()
    jgot, jbad, jop = split_with_slow_batches(JAX)
    assert pbad == [] and jbad == [] and pgot == jgot
    assert pop.state == jop.state == "done"
    assert pop.precopied + pop.delta == jop.precopied + jop.delta
    assert pop.delta == 0 < jop.delta
    # a replay takes no virtual time: the port's blackout is empty, the
    # reference's holds what was left of the batch in flight
    assert pop.blackout_ms == 0.0 < jop.blackout_ms


@pytest.mark.parametrize("seed,gap_s", [(47, 0.005), (48, 0.02)])
def test_catch_up_round_leaves_the_frozen_transfer_empty_equals_jax(seed, gap_s):
    """The port replays what the pre-copy rounds left while the donors
    still serve (server/reshard.py's catch-up round); the reference leaves
    it to the frozen transfer, inside the blackout. With slow batches
    arriving `gap_s` apart, both packages give the serial oracle's
    verdicts and replay the same batches in all; the port's frozen
    transfer replays none of them and its blackout is empty."""
    pgot, pbad, pop = split_with_slow_batches(PORT, gap_s=gap_s, seed=seed)
    clean_world()
    jgot, jbad, jop = split_with_slow_batches(JAX, gap_s=gap_s, seed=seed)
    assert pbad == [] and jbad == [] and pgot == jgot
    assert pop.state == jop.state == "done"
    assert pop.precopied + pop.delta == jop.precopied + jop.delta
    assert pop.delta == 0 < jop.delta
    assert pop.blackout_ms == 0.0 < jop.blackout_ms
