"""The port's conflict scheduler (foundationdb_tpu_torch.pipeline.scheduler)
against the JAX package's.

  * The scenarios of tests/test_scheduler.py (predictor weights, decay and
    prune; the doom rule; inert FIFO when off; pre-aborts with the probe
    cadence; lanes and their single-writer drain; the reorder; separation
    and its defer bound; the window tail; probe settlement; the epoch
    flip; flush; the telemetry family) run on both modules: the same
    plans (as positions in the pending window), counters, predictor state
    and hub series.
  * A scheduled contended stream (the `_drive` pattern of
    tests/test_scheduler.py) through the port's TorchConflictEngine and
    DeviceLoopEngine on the CPU, with the port's oracle as the shadow:
    verdicts equal per batch, the journal replays clean through a fresh
    OracleConflictEngine, pre-aborts and lanes happen, and the journal
    (versions, transactions, verdicts) equals JAX's scheduler driving
    JAX's oracle on the same seed.

Tolerance 0: every compared value is a count, a key, a version, a score
computed by the same float operations, or a verdict.
"""
import types

import pytest
import torch

from foundationdb_tpu.core import rng as jrng
from foundationdb_tpu.core import telemetry as jtelemetry
from foundationdb_tpu.core import types as jtypes
from foundationdb_tpu.ops.oracle import OracleConflictEngine as JaxOracle
from foundationdb_tpu.pipeline import scheduler as jsched
from foundationdb_tpu_torch.core import rng as trng
from foundationdb_tpu_torch.core import telemetry as ttelemetry
from foundationdb_tpu_torch.core import types as ttypes
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops.device_loop import DeviceLoopEngine
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine
from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine
from foundationdb_tpu_torch.pipeline import scheduler as tsched

torch.set_num_threads(1)

JAX = types.SimpleNamespace(name="jax", sched=jsched, types=jtypes, telemetry=jtelemetry,
                            rng=jrng)
PORT = types.SimpleNamespace(name="torch", sched=tsched, types=ttypes, telemetry=ttelemetry,
                             rng=trng)


@pytest.fixture(autouse=True)
def _fresh_hubs():
    jtelemetry.reset()
    ttelemetry.reset()
    yield
    jtelemetry.reset()
    ttelemetry.reset()


def _txn(ns, snap, reads=(), writes=()):
    t = ns.types.CommitTransaction()
    t.read_snapshot = int(snap)
    for k in reads:
        t.read_conflict_ranges.append(ns.types.KeyRange(k, k + b"\x00"))
    for k in writes:
        t.write_conflict_ranges.append(ns.types.KeyRange(k, k + b"\x00"))
    return t


def _cfg(ns, **kw):
    kw.setdefault("enabled", True)
    return ns.sched.SchedConfig(**kw)


def _heat_up(sched, key, last_write=None, bumps=3):
    for _ in range(bumps):
        sched.predictor.observe_witness(key, last_write)


def pos(entries, pool):
    """Plan entries as positions in `pool` (identity, not equality)."""
    ids = [id(e) for e in pool]
    return [ids.index(id(e)) for e in entries]


def plan_of(plan, pool):
    return (pos(plan.dispatch, pool), [(pos([e], pool)[0], r) for e, r in plan.preaborts],
            pos(plan.remaining, pool), dict(plan.decided), plan.preabort_ranges,
            plan.lane_ranges)


def committed(ns):
    return int(ns.types.TransactionCommitResult.COMMITTED)


def conflict(ns):
    return int(ns.types.TransactionCommitResult.CONFLICT)


# ---------------------------------------------------------------------------
# the scenarios, each run on both modules
# ---------------------------------------------------------------------------

def sc_predictor_weights_decay_and_floor(ns):
    p = ns.sched.ConflictPredictor(hot_score=4.0, decay=0.5)
    p.observe_witness(b"w")
    p.observe_conflict(b"c")
    p.note_commit(b"k", 100)
    out = [p.score_of(b"w"), p.score_of(b"c"), p.score_of(b"k"), dict(p.last_write)]
    p.tick()
    out.append(p.score_of(b"w"))
    for _ in range(20):
        p.tick()
    assert p.score_of(b"k") == 0.0 and b"k" not in p.last_write
    return out + [dict(p.scores), dict(p.last_write)]


def sc_predictor_doom_rule(ns):
    p = ns.sched.ConflictPredictor(hot_score=4.0, decay=1.0)
    p.observe_witness(b"h", 200)
    p.observe_witness(b"h")
    out = [p.doomed_range(_txn(ns, 150, reads=[b"h"])),
           p.doomed_range(_txn(ns, 200, reads=[b"h"]))]
    assert out == [b"h", None]
    p2 = ns.sched.ConflictPredictor(hot_score=4.0, decay=1.0)
    p2.observe_conflict(b"h")
    p2.last_write[b"h"] = 200
    out.append(p2.doomed_range(_txn(ns, 150, reads=[b"h"])))
    p.observe_witness(b"h", 180)
    assert p.last_write[b"h"] == 200
    return out + [p.snapshot(), p.hot_ranges()]


def sc_predictor_note_commit_keeps_hot(ns):
    p = ns.sched.ConflictPredictor(hot_score=4.0, decay=0.98)
    for v in range(200):
        p.tick()
        p.note_commit(b"h", 1000 + v)
    assert p.is_hot(b"h")
    return p.score_of(b"h"), dict(p.last_write)


def sc_predictor_prune(ns):
    P = ns.sched.ConflictPredictor
    p = P(hot_score=4.0, decay=1.0)
    for i in range(P.MAX_TRACKED + 200):
        key = b"k%05d" % i
        p.scores[key] = float(i)
        p.last_write[key] = i
    p.prune()
    assert len(p.scores) == P.MAX_TRACKED and set(p.last_write) <= set(p.scores)
    return sorted(p.scores)[:3], len(p.last_write)


def sc_disabled_select_is_inert_fifo(ns):
    s = ns.sched.ConflictScheduler(ns.sched.SchedConfig(enabled=False))
    pending = [_txn(ns, 10, writes=[b"a"]), _txn(ns, 11), _txn(ns, 12)]
    plan = s.select(pending, 2)
    assert plan.dispatch == pending[:2] and plan.remaining == pending[2:]
    assert all(v == 0 for v in s.counters.values()) and s.label is None
    s.observe_batch(pending[:2], [committed(ns)] * 2, 100)
    assert s.predictor.scores == {}
    return plan_of(plan, pending), dict(s.counters)


def sc_preabort_probe_cadence(ns):
    s = ns.sched.ConflictScheduler(_cfg(ns, probe_interval=3, lane_max=0))
    _heat_up(s, b"h", last_write=500)
    doomed = [_txn(ns, 400, reads=[b"h"]) for _ in range(6)]
    plan = s.select(doomed, 16)
    assert len(plan.preaborts) == 4 and len(plan.dispatch) == 2
    fresh = [_txn(ns, 500, reads=[b"h"])]
    plan2 = s.select(fresh, 16)
    assert len(plan2.dispatch) == 1 and not plan2.preaborts
    return plan_of(plan, doomed), plan_of(plan2, fresh), dict(s.counters)


def sc_lane_capture_and_drain(ns):
    s = ns.sched.ConflictScheduler(_cfg(ns, preabort=False, probe_interval=10**9))
    _heat_up(s, b"h")
    writers = [_txn(ns, 100 + i, writes=[b"h"]) for i in range(3)]
    cold = [_txn(ns, 100, writes=[b"c%d" % i]) for i in range(2)]
    pool = writers + cold
    plan = s.select(pool, 16)
    assert plan.dispatch == cold + [writers[0]]
    plan2 = s.select(plan.remaining, 16)
    plan3 = s.select([], 16)
    assert plan2.dispatch == [writers[1]] and plan3.dispatch == [writers[2]]
    assert s.pending_laned() == 0
    return plan_of(plan, pool), plan_of(plan2, pool), plan_of(plan3, pool), dict(s.counters)


def sc_reorder_is_deterministic(ns):
    def schedule():
        ns.telemetry.reset()
        s = ns.sched.ConflictScheduler(_cfg(ns, lane_max=0, preabort=False,
                                            probe_interval=10**9))
        _heat_up(s, b"h", last_write=50)
        pending = [_txn(ns, 100, writes=[b"h"]), _txn(ns, 100, reads=[b"h"]),
                   _txn(ns, 100, writes=[b"c"]), _txn(ns, 100, reads=[b"h"], writes=[b"c2"])]
        return plan_of(s.select(pending, 16), pending), dict(s.counters)

    first = schedule()
    assert first[0][0] == [1, 2, 3, 0]
    assert schedule() == first
    return first


def sc_separation_defers_then_forces(ns):
    s = ns.sched.ConflictScheduler(_cfg(ns, lane_max=0, preabort=False,
                                        probe_interval=10**9, defer_max=2))
    _heat_up(s, b"h")
    b = _txn(ns, 50, writes=[b"h"])
    out = []
    for snap in (101, 102, 103):
        pool = [_txn(ns, snap, writes=[b"h"]), b]
        out.append(plan_of(s.select(pool, 16), pool))
    assert out[-1][0] == [0, 1] and s.counters["forced"] == 1
    return out, dict(s.counters)


def sc_window_tail_rides_untouched(ns):
    s = ns.sched.ConflictScheduler(_cfg(ns, window=4))
    pending = [_txn(ns, 100, writes=[b"c%d" % i]) for i in range(8)]
    plan = s.select(pending, 2)
    assert plan.remaining[-4:] == pending[4:] and s.counters["examined"] == 4
    return plan_of(plan, pending), dict(s.counters)


def sc_observe_batch_settles_probes(ns):
    s = ns.sched.ConflictScheduler(_cfg(ns, probe_interval=1, lane_max=0))
    _heat_up(s, b"h", last_write=500)
    t1, t2 = _txn(ns, 400, reads=[b"h"]), _txn(ns, 400, reads=[b"h"])
    plan = s.select([t1, t2], 16)
    s.observe_batch([t1, t2], [conflict(ns), committed(ns)], 600)
    assert s.counters["probe_ok"] == 1 and s.counters["mispredicts"] == 1
    t3 = _txn(ns, 550, reads=[b"w"], writes=[b"w"])
    s.observe_batch([t3], [committed(ns)], 700)
    assert s.predictor.last_write[b"w"] == 700
    return (plan_of(plan, [t1, t2]), dict(s.counters), s.mispredict_frac(),
            dict(s.predictor.scores), dict(s.predictor.last_write))


def sc_epoch_flip_drains_lanes(ns):
    s = ns.sched.ConflictScheduler(_cfg(ns, preabort=False, probe_interval=10**9))
    _heat_up(s, b"h")
    writers = [_txn(ns, 100 + i, writes=[b"h"]) for i in range(4)]
    late = _txn(ns, 200, writes=[b"h"])
    pool = writers + [late]
    plan = s.select(writers, 16)
    plans = [plan_of(plan, pool)]
    dispatched = list(plan.dispatch)
    s.notify_epoch(7)
    pending = late
    for _ in range(6):
        plan = s.select([pending] if pending is not None else [], 16)
        plans.append(plan_of(plan, pool))
        dispatched += plan.dispatch
        pending = None if pending not in plan.remaining else pending
    assert {id(w) for w in writers} <= {id(e) for e in dispatched}
    assert s.pending_laned() == 0 and [lane.epoch for lane in s.lanes.values()] == [7]
    s.notify_epoch(7)
    return plans, dict(s.counters), [lane.as_dict() for lane in s.lanes.values()]


def sc_flush_returns_laned_in_order(ns):
    s = ns.sched.ConflictScheduler(_cfg(ns, preabort=False, probe_interval=10**9, lane_max=4))
    _heat_up(s, b"a")
    _heat_up(s, b"b")
    pool = [_txn(ns, 1, writes=[b"a"]), _txn(ns, 2, writes=[b"a"]), _txn(ns, 3, writes=[b"b"])]
    plan = s.select(pool, 1)
    out = s.flush()
    assert out == [pool[1], pool[2]] and not s.lanes
    return plan_of(plan, pool), pos(out, pool), dict(s.counters)


def sc_telemetry_family(ns):
    s = ns.sched.ConflictScheduler(_cfg(ns, probe_interval=10**9))
    assert s.label is not None
    _heat_up(s, b"h", last_write=500)
    s.select([_txn(ns, 400, reads=[b"h"])], 16)
    hub = ns.telemetry.hub()
    hub.sync()
    text = hub.prometheus_text()
    assert "fdbtpu_sched" in text
    snap = hub.snapshot()["sched"][s.label]
    return ({k: m.value for k, m in hub.tdmetrics.metrics.items()}, snap,
            [ln for ln in text.splitlines() if "sched" in ln])


SCENARIOS = [sc_predictor_weights_decay_and_floor, sc_predictor_doom_rule,
             sc_predictor_note_commit_keeps_hot, sc_predictor_prune,
             sc_disabled_select_is_inert_fifo, sc_preabort_probe_cadence,
             sc_lane_capture_and_drain, sc_reorder_is_deterministic,
             sc_separation_defers_then_forces, sc_window_tail_rides_untouched,
             sc_observe_batch_settles_probes, sc_epoch_flip_drains_lanes,
             sc_flush_returns_laned_in_order, sc_telemetry_family]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_scenario_equals_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_sched_config_reads_the_knobs():
    from foundationdb_tpu.core import knobs as jknobs
    from foundationdb_tpu_torch.core import knobs as tknobs

    JK, TK = jknobs.SERVER_KNOBS, tknobs.SERVER_KNOBS
    saved = (dict(JK._values), dict(TK._values))
    try:
        for reg, make in ((JK, jknobs._make_server_knobs), (TK, tknobs._make_server_knobs)):
            reg._values.clear()
            reg._values.update(make().as_dict())
        assert tsched.SchedConfig.from_knobs() == tsched.SchedConfig()
        for reg in (JK, TK):
            reg.set_knob("resolver_sched", "on")
            reg.set_knob("resolver_sched_window", "64")
            reg.set_knob("resolver_sched_probe_interval", "0")
        t, j = tsched.SchedConfig.from_knobs(), jsched.SchedConfig.from_knobs()
        assert t.as_dict() == j.as_dict() and t.enabled and t.probe_interval == 1
    finally:
        for reg, values in zip((JK, TK), saved):
            reg._values.clear()
            reg._values.update(values)


# ---------------------------------------------------------------------------
# a scheduled stream through the port's engines
# ---------------------------------------------------------------------------

def _contended_stream(ns, n_arrivals, version, hot, rng):
    out = []
    for _ in range(n_arrivals):
        snap = version - rng.random_int(0, 30)
        if rng.random01() < 0.7:
            k = hot[rng.random_int(0, len(hot))]
            out.append(_txn(ns, snap, reads=[k], writes=[k]))
        else:
            k = b"cold%04d" % rng.random_int(0, 512)
            out.append(_txn(ns, snap, reads=[k], writes=[k] if rng.random01() < 0.5 else []))
    return out


def drive(ns, engine, shadow, sched_on, seed, start_version, batches=30, cap=16):
    """tests/test_scheduler.py `_drive`: the contended stream through
    scheduler + engine, the shadow's verdicts required per batch;
    pre-aborted txns retry at a refreshed snapshot. Returns (journal,
    scheduler, end_version)."""
    rng = ns.rng.DeterministicRandom(seed)
    s = ns.sched.ConflictScheduler(_cfg(ns, enabled=sched_on, probe_interval=8))
    journal, pending, version = [], [], int(start_version)
    hot = [b"h%02d" % i for i in range(3)]

    def resolve(batch):
        oldest = max(0, version - 400)
        want = [int(v) for v in shadow.resolve(batch, version, oldest)]
        got = [int(v) for v in engine.resolve(batch, version, oldest)]
        assert got == want, f"engine diverged from the oracle at v{version}"
        journal.append((version, tuple(batch), oldest, tuple(want)))
        return want

    for _b in range(batches):
        version += 8
        pending.extend(_contended_stream(ns, 12, version, hot, rng))
        plan = s.select(pending, cap)
        pending = plan.remaining
        for txn, _rng in plan.preaborts:
            pending.append(_txn(ns, version, reads=[r.begin for r in txn.read_conflict_ranges],
                                writes=[r.begin for r in txn.write_conflict_ranges]))
        if not plan.dispatch:
            continue
        want = resolve(plan.dispatch)
        s.observe_batch(plan.dispatch, want, version)
    pending.extend(s.flush())
    if pending:
        version += 8
        resolve(pending[:cap])
    return journal, s, version


def replay_journal(journal):
    """Every dispatched batch through one fresh serial oracle, in order:
    (batches checked, mismatches)."""
    oracle = OracleConflictEngine()
    mismatches = 0
    for version, batch, oldest, want in journal:
        got = tuple(int(v) for v in oracle.resolve(list(batch), version, oldest))
        mismatches += got != want
    return len(journal), mismatches


def journal_form(journal):
    return [(v, old, want, tuple((t.read_snapshot,
                                  tuple(r.begin for r in t.read_conflict_ranges),
                                  tuple(r.begin for r in t.write_conflict_ranges))
                                 for t in batch))
            for v, batch, old, want in journal]


CFG = tck.KernelConfig(key_words=2, capacity=4096, max_reads=128, max_writes=128, max_txns=32)


@pytest.mark.parametrize("family", ["torch", "device_loop"])
def test_scheduled_stream_through_the_port_engine_replays_clean(family):
    engine = (TorchConflictEngine(CFG, device="cpu") if family == "torch"
              else DeviceLoopEngine(CFG, device="cpu")).warmup()
    shadow = OracleConflictEngine()
    j_off, s_off, v = drive(PORT, engine, shadow, False, seed=7, start_version=1000, batches=12)
    j_on, s_on, _ = drive(PORT, engine, shadow, True, seed=7, start_version=v + 100)
    assert s_on.counters["preaborts"] > 0 and s_on.counters["laned"] > 0
    assert s_off.counters["ticks"] == 0
    journal = j_off + j_on
    assert replay_journal(journal) == (len(journal), 0)
    if family == "device_loop":
        engine.drain_loop()
        assert engine.loop_stats["blocking_syncs"] == 0
    # the same seed through JAX's scheduler over JAX's oracle: the same
    # schedule, so the same journal
    joracle = JaxOracle()
    jj_off, _, jv = drive(JAX, joracle, JaxOracle(), False, seed=7, start_version=1000,
                          batches=12)
    jj_on, js_on, _ = drive(JAX, joracle, JaxOracle(), True, seed=7, start_version=jv + 100)
    assert journal_form(journal) == journal_form(jj_off + jj_on)
    assert s_on.counters == js_on.counters
    assert engine.perf.compiles == len(engine.perf_ledger.rows())
