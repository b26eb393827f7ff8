"""The port's knobs, rng, buggify, trace, tdmetric and stats modules against
the JAX package's.

  * knobs: every (name, default) of SERVER_KNOBS, CLIENT_KNOBS and
    FLOW_KNOBS, the set of randomized knobs, randomize() under five seeds
    and set_knob's parsing, on fresh registries (the process-global ones
    are never touched);
  * rng: DeterministicRandom's sequences under five seeds;
  * buggify: off by default, and the same firing sequence once enabled;
  * trace: the unit cases of tests/test_trace_spans.py (observer isolation,
    the file sink, disabled spans allocating nothing, process names and
    export, enabled spans), run on both modules with equal results;
  * tdmetric: the unit cases of tests/test_tdmetric.py on both modules
    (its logger cases need the database, which the port has not ported);
  * stats: counters and their trace event on both, and the periodic
    logger's events under each package's simulator;
  * span_now(): the wall clock without a scheduler, each simulator's
    virtual time inside one.

Every compared value is an integer, a string or a float computed the same
way: tolerance 0. Excluded: span Begin/End stamps (wall clock; each case
compares names, trace ids and details only).
"""
import io
import time

import pytest

from foundationdb_tpu.core import buggify as jbuggify
from foundationdb_tpu.core import knobs as jknobs
from foundationdb_tpu.core import rng as jrng
from foundationdb_tpu.core import stats as jstats
from foundationdb_tpu.core import tdmetric as jtdmetric
from foundationdb_tpu.core import trace as jtrace
from foundationdb_tpu_torch.core import buggify as tbuggify
from foundationdb_tpu_torch.core import knobs as tknobs
from foundationdb_tpu_torch.core import rng as trng
from foundationdb_tpu_torch.core import stats as tstats
from foundationdb_tpu_torch.core import tdmetric as ttdmetric
from foundationdb_tpu_torch.core import trace as ttrace

SEEDS = (0, 1, 7, 2026, 99991)
REGISTRIES = ("_make_server_knobs", "_make_client_knobs", "_make_flow_knobs")


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", REGISTRIES)
def test_knob_registries_equal(make):
    j, t = getattr(jknobs, make)(), getattr(tknobs, make)()
    assert list(t.as_dict().items()) == list(j.as_dict().items())
    assert list(t._randomizers) == list(j._randomizers)
    for name, value in j.as_dict().items():
        assert type(getattr(t, name)) is type(value), name


def test_global_registries_hold_the_defaults():
    for make, name in zip(REGISTRIES, ("SERVER_KNOBS", "CLIENT_KNOBS", "FLOW_KNOBS")):
        assert getattr(tknobs, name).as_dict() == getattr(tknobs, make)().as_dict() \
            == getattr(jknobs, make)().as_dict()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("make", REGISTRIES)
def test_knob_randomize_equal(make, seed):
    j, t = getattr(jknobs, make)(), getattr(tknobs, make)()
    j.randomize(jrng.DeterministicRandom(seed))
    t.randomize(trng.DeterministicRandom(seed))
    assert t.as_dict() == j.as_dict()
    j.randomize(jrng.DeterministicRandom(seed), probability=1.0)
    t.randomize(trng.DeterministicRandom(seed), probability=1.0)
    assert t.as_dict() == j.as_dict()


@pytest.mark.parametrize("raw", ["1", "0", "true", "on", "off", "7", "-3", "0.25", "1e3", "x"])
def test_set_knob_parses_equally(raw):
    j, t = jknobs._make_server_knobs(), tknobs._make_server_knobs()
    for name in j.as_dict():
        outcome = []
        for reg in (j, t):
            try:
                reg.set_knob(name, raw)
                outcome.append(("ok", reg.as_dict()[name]))
            except ValueError as e:
                outcome.append(("ValueError", str(e)))
        assert outcome[0] == outcome[1], (name, raw)
    with pytest.raises(KeyError):
        t.set_knob("no_such_knob", raw)


# ---------------------------------------------------------------------------
# rng and buggify
# ---------------------------------------------------------------------------

def rng_sequence(mod, seed):
    r = mod.DeterministicRandom(seed)
    out = [r.seed]
    for _ in range(50):
        out += [r.random01(), r.random_int(-5, 1000), r.random_int64(0, 1 << 62),
                r.coinflip(), r.random_unique_id(), r.random_alpha_numeric(6),
                r.random_bytes(5), r.random_choice("abcdefg")]
    lst = list(range(30))
    r.shuffle(lst)
    f = r.fork()
    return out + [lst, f.seed, f.random01()]


@pytest.mark.parametrize("seed", SEEDS)
def test_deterministic_random_sequences_equal(seed):
    assert rng_sequence(trng, seed) == rng_sequence(jrng, seed)


def buggify_draws(mod, rng_mod, seed):
    mod.disable()
    off = [mod.buggify() for _ in range(10)]
    mod.enable(rng_mod.DeterministicRandom(seed))
    try:
        # two call sites, each activated (or not) once, then drawn from
        sites = [[mod.buggify() for _ in range(200)]]
        sites.append([mod.buggify() for _ in range(200)])
        probe = [mod.test_probe(i % 3 == 0, "port-probe") for i in range(9)]
    finally:
        mod.disable()
    return off, sites, probe


@pytest.mark.parametrize("seed", SEEDS)
def test_buggify_equal_and_off_by_default(seed):
    assert not tbuggify.is_enabled()
    t = buggify_draws(tbuggify, trng, seed)
    j = buggify_draws(jbuggify, jrng, seed)
    assert t == j
    assert t[0] == [False] * 10
    assert not tbuggify.is_enabled()


# ---------------------------------------------------------------------------
# trace: the unit cases of tests/test_trace_spans.py on both modules
# ---------------------------------------------------------------------------

def case_observer_isolation(tr):
    tc = tr.TraceCollector()
    seen_a, seen_b = [], []
    tc.observers.append(seen_a.append)
    tc.observers.append(lambda e: (_ for _ in ()).throw(RuntimeError("boom")))
    tc.observers.append(seen_b.append)
    tc.emit({"Severity": tr.Severity.INFO, "Type": "X"})
    tc.emit({"Severity": tr.Severity.INFO, "Type": "Y"})
    assert [e["Type"] for e in tc.events] == ["X", "Y"]
    assert [e["Type"] for e in seen_a] == ["X", "Y"]
    assert [e["Type"] for e in seen_b] == ["X", "Y"]
    assert tc.observer_errors == 2
    return [e["Type"] for e in tc.events], tc.observer_errors


class _FlushTrackingSink(io.StringIO):
    def __init__(self):
        super().__init__()
        self.flushes = 0

    def flush(self):
        self.flushes += 1
        super().flush()


def case_file_sink_flushes(tr):
    tc = tr.TraceCollector()
    sink = _FlushTrackingSink()
    tc.file = sink
    tc.emit({"Severity": tr.Severity.INFO, "Type": "Quiet"})
    flushes = [sink.flushes]
    tc.emit({"Severity": tr.Severity.ERROR, "Type": "Bad"})
    flushes.append(sink.flushes)
    tc.close()
    flushes.append(sink.flushes)
    assert flushes == [0, 1, 2] and tc.file is None
    assert "Quiet" in sink.getvalue() and "Bad" in sink.getvalue()
    tc.emit({"Severity": tr.Severity.INFO, "Type": "After"})
    assert tc.find("After")
    return flushes, sink.getvalue()


def case_raising_file_sink(tr):
    class BrokenSink:
        def write(self, _s):
            raise OSError("disk full")

    tc = tr.TraceCollector()
    tc.file = BrokenSink()
    tc.emit({"Severity": tr.Severity.ERROR, "Type": "Z"})
    assert tc.find("Z")
    return [e["Type"] for e in tc.find("Z")]


def case_disabled_spans_allocate_nothing(tr):
    tr.g_spans.enabled = False
    before_alloc = tr.span_allocations[0]
    before_spans = len(tr.g_spans.spans)
    ctx = tr.TraceContext(trace_id="r0.1", parent="client.commit")
    for i in range(1000):
        sp = tr.span("resolver.device_dispatch", i)
        sp.child("x").finish()
        sp.finish()
        tr.span_event("resolver.retry", i, 0.0, 1.0)
        with tr.span("engine.host_pack", i):
            pass
        with tr.use_trace_context(ctx):
            assert tr.current_trace_context() is ctx
            tr.span_event("client.commit", ctx.trace_id, 0.0, 1.0)
    assert tr.span("anything") is tr.NULL_SPAN
    assert tr.span_allocations[0] == before_alloc
    assert len(tr.g_spans.spans) == before_spans
    return tr.span_allocations[0] - before_alloc


def case_process_name_and_export(tr):
    tr.g_spans.enabled = True
    try:
        tr.g_spans.clear()
        tr.set_process_name("proc-a")
        tr.span_event("phase.x", 1, 0.0, 1.0)
        tr.span_event("phase.y", 1, 1.0, 2.0, Proc="explicit-b")
        with tr.span("phase.z", trace_id=2):
            pass
        ring = tr.export_spans()
        assert ring["proc"] == "proc-a"
        by_name = {s["Name"]: s for s in ring["spans"]}
        assert by_name["phase.x"]["Proc"] == "proc-a"
        assert by_name["phase.y"]["Proc"] == "explicit-b"
        assert by_name["phase.z"]["Proc"] == "proc-a"
        return ring["proc"], [(s["Name"], s["Trace"], s["Proc"]) for s in ring["spans"]]
    finally:
        tr.set_process_name("")
        tr.g_spans.enabled = False
        tr.g_spans.clear()


def case_enabled_spans_record(tr):
    tr.g_spans.enabled = True
    try:
        tr.g_spans.clear()
        with tr.span("phase.a", trace_id=7):
            pass
        tr.span_event("phase.b", 7, 1.0, 2.5, detail="x")
        assert isinstance(tr.span("phase.c", 7), tr.Span)
        by = tr.g_spans.durations_by_trace()[7]
        assert by["phase.b"] == 1.5
        assert "phase.a" in by and "phase.a.t0" in by
        return sorted(by), [(s["Name"], s["Trace"], s.get("detail"))
                            for s in tr.g_spans.for_trace(7)]
    finally:
        tr.g_spans.enabled = False
        tr.g_spans.clear()


def case_trace_event_and_batch(tr):
    tc = tr.g_trace
    n0 = len(tc.events)
    tr.TraceEvent("PortCase", id=3).detail("K", 1).error(ValueError("v")).log()
    ev = tc.events[n0]
    b = tr.TraceBatch()
    b.add_event("Probe", 9, "here")
    b.add_attach("Attach", 9, 10)
    ids = [tr.next_trace_id().split(".")[0][:1] for _ in range(2)]
    tc.events[n0:] = []
    return ({k: v for k, v in ev.items() if k != "Time"},
            [e["Type"] for e in b.timeline(9)], ids, tr.SPANS_TOKEN,
            tr.TraceContext(1, "p").sampled)


TRACE_CASES = [case_observer_isolation, case_file_sink_flushes, case_raising_file_sink,
               case_disabled_spans_allocate_nothing, case_process_name_and_export,
               case_enabled_spans_record, case_trace_event_and_batch]


@pytest.mark.parametrize("case", TRACE_CASES, ids=lambda c: c.__name__)
def test_trace_cases_equal(case):
    assert case(ttrace) == case(jtrace)


def test_span_now_reads_the_wall_clock_without_a_simulator():
    """With no active scheduler span_now() is time.perf_counter(); inside a
    port simulation it is the scheduler's virtual time, equal to the JAX
    package's span_now() inside the JAX simulation at the same step."""
    import time

    from torch_sim_world import BOTH, PORT, clean_world

    clean_world()
    t0 = time.perf_counter()
    now = ttrace.span_now()
    assert t0 <= now <= time.perf_counter()
    seen = []
    try:
        for P in BOTH:
            sim = P.simulator.Simulator(5)
            stamps = []

            async def actor(P=P, sim=sim, stamps=stamps):
                for i in range(4):
                    await P.loop.delay(0.25 * (i + 1) + sim.sched.rng.random01())
                    stamps.append((sim.sched.time, P.trace.span_now()))

            sim.run_until(sim.sched.spawn(actor()))
            seen.append(stamps)
            clean_world()
    finally:
        clean_world()
    assert seen[0] == seen[1]
    assert all(t == s for t, s in seen[0]) and seen[0][-1][0] > 2.5
    t0 = time.perf_counter()
    assert PORT.loop._current is None and t0 <= ttrace.span_now() <= time.perf_counter()


# ---------------------------------------------------------------------------
# tdmetric and stats
# ---------------------------------------------------------------------------

def case_tdmetric_semantics(td):
    t = {"now": 0.0}
    col = td.TDMetricCollection(now=lambda: t["now"])
    m = col.int64("proxy.commits")
    m.set(5)
    t["now"] = 1.0
    m.set(5)
    m.increment(3)
    t["now"] = 2.0
    m.set(2)
    entries = list(m.buffer)
    assert entries == [(0.0, 5), (1.0, 8), (2.0, 2)]
    at = [col.value_at("proxy.commits", x, entries) for x in (0.5, 1.5, 9.0)]
    assert at == [5, 8, 2]
    ev = col.continuous("proxy.events")
    ev.log(7)
    ev.log(9)
    flag = col.bool("proxy.flag")
    flag.set(3)
    drained = col.drain_all()
    assert set(drained) == {"proxy.commits", "proxy.events", "proxy.flag"}
    assert col.drain_all() == {}
    return entries, at, drained


def case_record_during_drain(td):
    t = {"now": 0.0}
    col = td.TDMetricCollection(now=lambda: t["now"])
    m = col.continuous("interleave.events")
    m.log(1)
    drained = col.drain_all()
    m.log(2)
    m.log(3)
    assert [v for _t, v in m.buffer] == [2, 3]
    drained2 = col.drain_all()
    assert [v for _t, v in drained2["interleave.events"]] == [2, 3]
    return drained, drained2


def case_max_buffered_trimming(td):
    t = {"now": 0.0}
    col = td.TDMetricCollection(now=lambda: t["now"])
    m = col.continuous("bound.events")
    extra = 250
    for i in range(td.MAX_BUFFERED + extra):
        t["now"] = float(i)
        m.log(i)
    assert len(m.buffer) == td.MAX_BUFFERED
    values = [v for _t, v in m.buffer]
    assert values == list(range(extra, td.MAX_BUFFERED + extra))
    lvl = col.int64("bound.level")
    for i in range(td.MAX_BUFFERED + extra):
        t["now"] = float(i)
        lvl.set(i + 1)
    assert len(lvl.buffer) == td.MAX_BUFFERED
    return values[:3], values[-3:], list(lvl.buffer)[-3:]


@pytest.mark.parametrize("case", [case_tdmetric_semantics, case_record_during_drain,
                                  case_max_buffered_trimming], ids=lambda c: c.__name__)
def test_tdmetric_cases_equal(case):
    assert case(ttdmetric) == case(jtdmetric)


def stats_case(st, td, tr):
    col = td.TDMetricCollection(now=lambda: 1.0)
    cc = st.CounterCollection("Resolver", id="r1", tdmetrics=col)
    cc.add("batches")
    cc.add("batches", 4)
    cc.counter("txns").add(40)
    n0 = len(tr.g_trace.events)
    cc.trace(2.0)
    ev = tr.g_trace.events[n0]
    tr.g_trace.events[n0:] = []
    return (cc.as_dict(), {k: v for k, v in ev.items() if k != "Time"},
            {k: m.value for k, m in col.metrics.items()},
            cc.counter("txns").rate_since_last(0.0))


def logger_events(P):
    """CounterCollection.run_logger under package P's simulator, the trace
    clock set to the simulation's: the `ResolverMetrics` events it logs."""
    sim = P.simulator.Simulator(9)
    P.trace.set_time_source(lambda: sim.sched.time)
    n0 = len(P.trace.g_trace.events)
    try:
        cc = P.stats.CounterCollection("Resolver", id="r1")

        async def work():
            for i in range(5):
                cc.add("batches")
                cc.add("txns", 10 * i)
                await P.loop.delay(1.5 + sim.sched.rng.random01())

        sim.sched.spawn(cc.run_logger(2.0))
        sim.sched.spawn(work())
        sim.run(until=9.0)
        return [e for e in P.trace.g_trace.events[n0:] if e["Type"] == "ResolverMetrics"]
    finally:
        del P.trace.g_trace.events[n0:]
        P.trace.set_time_source(time.monotonic)


def test_stats_equal_and_logger_needs_the_simulator():
    """Counters and their trace event equal the JAX package's; the periodic
    logger runs on each package's simulator clock and logs equal
    `*Metrics` events (times, values, rates)."""
    from torch_sim_world import JAX, PORT, clean_world

    assert stats_case(tstats, ttdmetric, ttrace) == stats_case(jstats, jtdmetric, jtrace)
    clean_world()
    try:
        got, want = logger_events(PORT), logger_events(JAX)
    finally:
        clean_world()
    assert got == want
    assert [e["Time"] for e in got] == [2.0, 4.0, 6.0, 8.0]
    assert got[-1]["batches"] == 5 and got[-1]["txns"] == 100
