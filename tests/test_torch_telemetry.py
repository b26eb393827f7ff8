"""The port's telemetry hub, perf ledger, sampled device timing, engine
spans, BudgetBatcher and pipeline wiring against the JAX package's.

  * TorchConflictEngine and DeviceLoopEngine (device="cpu") against
    JaxConflictEngine and JAX's DeviceLoopEngine on one stream (every
    ladder bucket, GC cadences, general-router batches), at heat 0 and 8,
    monolithic and tiered, warmed or built on first use, with the
    knob-chosen ladder, search mode, structure, heat, sample rate and
    loop engine too. After every batch these agree: verdicts, the hub's
    deterministic series, the perf-ledger row keys (engine, bucket,
    n_chunks, search mode, dispatch mode, kind), the device_time sample
    and chunk counts per bucket (at rates 0.25 and the knob default
    0.0625), and the span names and counts per trace id; and the port's
    verdicts equal a port engine's with spans and sampling off.
  * The BudgetBatcher fed the same observations gives the same targets
    and EWMA keys; a ResolverPipeline with a batcher and a conflict
    scheduler wires them as JAX's does (EWMA keys, scheduler counters and
    predictor state, pipeline.force spans).
  * A hub built with the watchdog_enabled knob set attaches the watchdog.

Counts, keys, names and verdicts compare with tolerance 0. Excluded from
the series, by name: compile_us_* and device_time_us.* (wall times),
loop wait_us (wall time), loop drained_nonblocking / forced_waits (which
drain finds a ticket depends on when the device finished), and perf
peak_hbm_bytes / flops_total / bytes_accessed_total (XLA's analysis of a
compiled program; the port records none on the CPU). Excluded from spans:
Begin / End and the ms details.
"""
import collections
import dataclasses
import random

import numpy as np
import pytest
import torch

from foundationdb_tpu.core import knobs as jknobs
from foundationdb_tpu.core import telemetry as jtelemetry
from foundationdb_tpu.core import trace as jtrace
from foundationdb_tpu.core.knobs import SERVER_KNOBS as JKNOBS
from foundationdb_tpu.core.types import CommitTransaction, KeyRange
from foundationdb_tpu.ops import device_loop as jdl
from foundationdb_tpu.ops import host_engine as jhe
from foundationdb_tpu.ops.oracle import OracleConflictEngine
from foundationdb_tpu.pipeline import resolver_pipeline as jrp
from foundationdb_tpu.pipeline import scheduler as jsched
from foundationdb_tpu_torch.core import knobs as tknobs
from foundationdb_tpu_torch.core import perfledger as tperfledger
from foundationdb_tpu_torch.core import telemetry as ttelemetry
from foundationdb_tpu_torch.core import trace as ttrace
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS as TKNOBS
from foundationdb_tpu_torch.ops import device_loop as tdl
from foundationdb_tpu_torch.ops import host_engine as the
from foundationdb_tpu_torch.pipeline import resolver_pipeline as trp
from foundationdb_tpu_torch.pipeline import scheduler as tsched
from test_device_loop import CFG, LADDER, boundary_gc_stream
from test_torch_conflict_kernel import port_cfg
from test_torch_engine import ints

torch.set_num_threads(1)

EXCLUDED_SERIES = ("compile_us_", "device_time_us.", "wait_us", "drained_nonblocking",
                   "forced_waits", "peak_hbm_bytes", "flops_total", "bytes_accessed_total")


@pytest.fixture(autouse=True)
def clean_state():
    """Fresh hubs, span collection off and empty, knobs at their defaults
    and restored after: every one of these is process-global in both
    packages."""
    saved = (dict(JKNOBS._values), dict(TKNOBS._values))
    for reg, make in ((JKNOBS, jknobs._make_server_knobs), (TKNOBS, tknobs._make_server_knobs)):
        reg._values.clear()
        reg._values.update(make().as_dict())
    for mod in (jtelemetry, ttelemetry):
        mod.reset()
    for tr in (jtrace, ttrace):
        tr.g_spans.enabled = False
        tr.g_spans.clear()
    yield
    for reg, values in zip((JKNOBS, TKNOBS), saved):
        reg._values.clear()
        reg._values.update(values)
    for mod in (jtelemetry, ttelemetry):
        mod.reset()
    for tr in (jtrace, ttrace):
        tr.g_spans.enabled = False
        tr.g_spans.clear()


def set_knobs(knobs):
    for name, value in knobs.items():
        JKNOBS.set_knob(name, value)
        TKNOBS.set_knob(name, value)


def undefined_concentrations(hub):
    """The `heat.<label>.concentration_x1000` series of the heat
    aggregators whose index is undefined (fewer than two ranges, or no
    load): the JAX hub exports them as 0, the port's leaves them out
    (a difference by design: ROADMAP)."""
    out = set()
    for label, ref in hub._heat.items():
        agg = ref()
        if agg is None:
            continue
        loads = [float(w[1] + w[2]) for w in agg._w.values()]
        if len(loads) < 2 or not any(x > 0 for x in loads):
            out.add(f"heat.{label}.concentration_x1000")
    return out


def series(mod):
    """The hub's synced series {name: value}, engine labels normalized
    ("jax.N" / "torch.N" -> "E.N"), the excluded series dropped, and on
    the JAX hub the undefined concentrations it exports as 0."""
    hub = mod.hub()
    hub.sync()
    undefined = undefined_concentrations(hub) if mod is jtelemetry else set()
    out = {}
    for name, m in hub.tdmetrics.metrics.items():
        if any(x in name for x in EXCLUDED_SERIES):
            continue
        if name in undefined:
            assert m.value == 0, name
            continue
        out[name.replace(".jax.", ".E.").replace(".torch.", ".E.")] = m.value
    return out


def ledger_keys(eng):
    return [({"jax": "E", "torch": "E"}.get(r["engine"], r["engine"]), r["bucket"],
             r["n_chunks"], r["search_mode"], r["dispatch_mode"], r["kind"])
            for r in eng.perf_ledger.rows()]


def samples(eng):
    return {b: (d["samples"], d["chunks"]) for b, d in eng.perf.device_time.items()}


def span_counts(tr):
    return collections.Counter((s.get("Trace"), s["Name"]) for s in tr.g_spans.spans)


def stream(seed=11):
    """Every ladder bucket and a multi-chunk top batch, GC cadences,
    general-router batches (JAX CommitTransactions; both engines take
    them)."""
    return list(boundary_gc_stream(seed, extra_random=2))


#: (kind, structure, heat, sample rate (None = knob), warm, knobs)
CASES = {
    "step_mono_heat0_r025": ("step", "monolithic", 0, 0.25, True, {}),
    "step_tiered_heat8_default": ("step", "tiered", 8, None, False, {}),
    "loop_mono_heat8_r025": ("loop", "monolithic", 8, 0.25, True, {}),
    "loop_tiered_heat0_default": ("loop", "tiered", 0, None, True, {}),
    "knobs_loop": ("knob", "monolithic", None, None, True, {
        "resolver_bucket_ladder": "32,64", "resolver_history_search_mode": "bsearch",
        "resolver_history_structure": "tiered", "resolver_history_runs": "4",
        "resolver_heat_buckets": "8", "resolver_device_loop": "pallas",
        "resolver_device_time_sample_rate": "0.25"}),
    "knobs_step": ("knob", "monolithic", None, None, False, {
        "resolver_bucket_ladder": "32", "resolver_history_search_mode": "fused_sort",
        "resolver_heat_buckets": "8"}),
}


def build_pair(kind, structure, heat, rate, knobs):
    set_knobs(knobs)
    jcfg = CFG if structure == "monolithic" else dataclasses.replace(
        CFG, history_structure="tiered", history_runs=3)
    tcfg = port_cfg(jcfg)
    if kind == "knob":
        jeng = jhe.make_engine(jhe.default_engine_mode(), jcfg)
        teng = the.make_engine(the.default_engine_mode(), tcfg, device="cpu")
        return jeng, teng
    kw = dict(ladder=LADDER, heat_buckets=heat, device_time_sample_rate=rate)
    if kind == "step":
        return (jhe.JaxConflictEngine(jcfg, scan_sizes=(2,), **kw),
                the.TorchConflictEngine(tcfg, device="cpu", scan_sizes=(2,), **kw))
    return jdl.DeviceLoopEngine(jcfg, **kw), tdl.DeviceLoopEngine(tcfg, device="cpu", **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_series_ledger_samples_and_spans_equal_jax(case):
    kind, structure, heat, rate, warm, knobs = CASES[case]
    jeng, teng = build_pair(kind, structure, heat, rate, knobs)
    # the same stream through a port engine with spans and sampling off
    quiet = the.make_engine("torch" if teng.dispatch_mode == "step" else "device_loop",
                            teng.cfg, device="cpu", ladder=[b.max_txns for b in teng.buckets],
                            device_time_sample_rate=0.0, heat_buckets=teng.cfg.heat_buckets,
                            **({"scan_sizes": teng._scan_sizes}
                               if teng.dispatch_mode == "step" else {}))
    assert quiet.cfg == teng.cfg
    # the engines under test register with fresh hubs, in the same order
    for mod in (jtelemetry, ttelemetry):
        mod.reset()
    jeng, teng = build_pair(kind, structure, heat, rate, knobs)
    assert type(teng).__name__ == type(jeng).__name__.replace("Jax", "Torch")
    assert teng.cfg.heat_buckets == jeng.cfg.heat_buckets
    assert teng.history_structure == jeng.history_structure
    assert teng.history_search_modes() == jeng.history_search_modes()
    assert [b.max_txns for b in teng.buckets] == [b.max_txns for b in jeng.buckets]
    assert teng._sample_every == jeng._sample_every > 0
    assert teng.dispatch_mode == jeng.dispatch_mode
    if warm:
        jeng.warmup()
        teng.warmup()
    assert series(ttelemetry) == series(jtelemetry)
    assert ledger_keys(teng) == ledger_keys(jeng)
    jtrace.g_spans.enabled = ttrace.g_spans.enabled = True
    oracle = OracleConflictEngine()
    for b, (txns, v, old) in enumerate(stream()):
        got = ints(teng.resolve(txns, v, old))
        ttrace.g_spans.enabled = False
        assert got == ints(quiet.resolve(txns, v, old)), b
        ttrace.g_spans.enabled = True
        assert got == ints(jeng.resolve(txns, v, old)) == ints(oracle.resolve(txns, v, old)), b
        assert series(ttelemetry) == series(jtelemetry), b
        assert ledger_keys(teng) == ledger_keys(jeng), b
        assert samples(teng) == samples(jeng), b
        assert span_counts(ttrace) == span_counts(jtrace), b
    # the 1-in-N cadence over every columnar dispatch unit
    assert sum(s for s, _ in samples(teng).values()) == \
        sum(teng.perf.scan_dispatches.values()) // teng._sample_every
    names = {n for _, n in span_counts(ttrace)}
    assert names >= {"engine.host_pack", "engine.force" if teng.dispatch_mode == "step"
                     else "engine.result_drain"}
    assert ("engine.device_time" in names) == bool(samples(teng))
    assert teng.perf.compiles == jeng.perf.compiles == len(teng.perf_ledger.rows())
    assert {r["kind"] for r in teng.perf_ledger.rows()} == ({"warmup"} if warm else {"steady"})
    assert all(r["duration_ms"] > 0 and r["peak_bytes"] is None and r["flops"] is None
               for r in teng.perf_ledger.rows())
    assert quiet.perf.device_time == {} and quiet.perf_ledger.rows()
    tperf, jperf = teng.perf.as_dict(), jeng.perf.as_dict()
    for key in ("compiles", "bucket_hits", "scan_dispatches", "search_modes", "search_mode_hits",
                "dispatch_mode_hits", "verdicts", "device_time_samples", "warmed",
                "recent_dispatches"):
        assert tperf[key] == jperf[key], key
    assert [(r["bucket"], r["scan"], r["txns"]) for r in teng.perf.recent] == \
        [(r["bucket"], r["scan"], r["txns"]) for r in jeng.perf.recent]
    assert all(r["force_ms"] is not None for r in teng.perf.recent)
    snap_t, snap_j = ttelemetry.hub().snapshot(), jtelemetry.hub().snapshot()
    assert sorted(k for k, v in snap_t.items() if v) == sorted(k for k, v in snap_j.items() if v)
    text = ttelemetry.hub().prometheus_text()
    assert "fdbtpu_engine" in text and "fdbtpu_perf" in text


def test_sample_cadence_and_ledger_size_match():
    from foundationdb_tpu.core import perfledger as jperfledger

    for rate in (None, 0.0, 0.0625, 0.25, 0.3, 1.0, 2.0):
        assert tperfledger.sample_every_from_rate(rate) == jperfledger.sample_every_from_rate(rate)
    assert tperfledger.sample_every_from_rate(None) == 16
    assert tperfledger.ledger_size_from_knobs() == jperfledger.ledger_size_from_knobs() == 128
    assert tperfledger.RECORD_FIELDS == jperfledger.RECORD_FIELDS
    t, j = tperfledger.PerfLedger(size=3), jperfledger.PerfLedger(size=3)
    for i in range(5):
        kw = dict(engine="e", bucket=32 * (i + 1), n_chunks=1, search_mode="bsearch",
                  dispatch_mode="step", kind="warmup" if i < 3 else "steady",
                  duration_ms=1.5 + i)
        t.record_compile(analysis=tperfledger.analyze_program(1000 * i or None), **kw)
        j.record_compile(analysis={"flops": None, "bytes_accessed": None,
                                   "peak_bytes": 1000 * i or None,
                                   "generated_code_bytes": None}, **kw)
    assert t.snapshot() == j.snapshot()
    assert [tuple(r) for r in t.rows()] == [tuple(r) for r in j.rows()]


def test_watchdog_knob_raises_until_the_watchdog_is_ported():
    """The knob now attaches the port's watchdog, as the JAX hub does (the
    name is kept from when the port raised here)."""
    from foundationdb_tpu_torch.core import watchdog as twatchdog

    TKNOBS.set_knob("watchdog_enabled", "true")
    try:
        assert isinstance(ttelemetry.TelemetryHub().watchdog, twatchdog.Watchdog)
    finally:
        TKNOBS.set_knob("watchdog_enabled", "false")
    assert ttelemetry.TelemetryHub().watchdog is None


# ---------------------------------------------------------------------------
# the BudgetBatcher and the pipeline
# ---------------------------------------------------------------------------

def test_budget_batcher_targets_equal():
    rng = np.random.default_rng(5)
    ladder = [32, 64, 128, 256]
    kw = dict(budget_ms=4.0, pack_ms_per_txn=0.001, alpha=0.3, seed_ms={64: 1.0, 256: 9.0},
              bucket_modes={32: "bsearch", 64: "bsearch"})
    j, t = jrp.BudgetBatcher(ladder, **kw), trp.BudgetBatcher(ladder, **kw)
    assert t.as_dict() == j.as_dict()
    for step in range(120):
        bucket = int(rng.choice(ladder))
        ms = float(rng.gamma(2.0, bucket / 64.0))
        mode = None if step % 7 else "fused_sort"
        j.observe(bucket, ms, mode)
        t.observe(bucket, ms, mode)
        if step == 40:
            for b in (j, t):
                b.set_bucket_modes({32: "fused_sort", 128: "bsearch"})
        if step == 80:
            for b in (j, t):
                b.set_dispatch_mode("loop")
        for depth in (1, 2, 3):
            assert t.target_batch_txns(depth) == j.target_batch_txns(depth), step
            assert t.predicted_ms(bucket, depth) == j.predicted_ms(bucket, depth)
        assert t.target_batch_txns(2, degraded=True) == j.target_batch_txns(2, degraded=True)
        assert t.bucket_of(bucket - 1) == j.bucket_of(bucket - 1)
    assert t.as_dict() == j.as_dict()
    assert series(ttelemetry) == series(jtelemetry)
    with pytest.raises(ValueError):
        trp.BudgetBatcher([])
    default = trp.BudgetBatcher(ladder)
    assert default.budget_ms == float(TKNOBS.resolver_p99_budget_ms)
    assert default.alpha == float(TKNOBS.resolver_latency_ewma_alpha)


_JAX_PROGRAMS = {}


def _txn(snap, reads=(), writes=()):
    t = CommitTransaction(read_snapshot=int(snap))
    t.read_conflict_ranges.extend(KeyRange(k, k + b"\x00") for k in reads)
    t.write_conflict_ranges.extend(KeyRange(k, k + b"\x00") for k in writes)
    return t


def hot_batches(seed, n_batches=10):
    """Skewed point traffic (JAX CommitTransactions): read-modify-writes
    of 3 hot keys among cold ones, snapshots up to 30 versions stale."""
    rng = random.Random(seed)
    v, out = 1000, []
    for _ in range(n_batches):
        v += 8
        txns = []
        for _ in range(rng.randrange(20, 60)):
            snap = v - rng.randrange(0, 30)
            k = (b"h%02d" % rng.randrange(3) if rng.random() < 0.6
                 else b"cold%04d" % rng.randrange(512))
            txns.append(_txn(snap, reads=[k], writes=[k]))
        out.append((txns, v, max(0, v - 400)))
    return out


@pytest.mark.parametrize("depth", [1, 3])
def test_pipeline_with_batcher_and_scheduler_wires_as_jax(depth):
    """The pipeline adopts the engine's bucket modes and dispatch mode, the
    force wall time lands on the batch's chunk buckets, observe_batch
    trains the scheduler on every forced batch, and pipeline.force spans
    carry each batch's version: the same as JAX's pipeline on JAX's
    engine (keys and counters; the EWMA values are wall times)."""
    jcfg = dataclasses.replace(CFG, heat_buckets=8)
    jeng = jhe.JaxConflictEngine(jcfg, ladder=LADDER, scan_sizes=(2,))
    jeng._programs = _JAX_PROGRAMS.setdefault(jcfg, {})
    teng = the.TorchConflictEngine(port_cfg(jcfg), device="cpu", ladder=LADDER, scan_sizes=(2,))
    pipes, scheds, batchers = [], [], []
    for rp, sched, eng in ((jrp, jsched, jeng), (trp, tsched, teng)):
        batcher = rp.BudgetBatcher([32, 64, 128], budget_ms=1e9)
        cs = sched.ConflictScheduler(sched.SchedConfig(enabled=True), heat=eng.heat)
        pipes.append(rp.ResolverPipeline(eng, depth=depth, batcher=batcher, conflict_sched=cs))
        scheds.append(cs)
        batchers.append(batcher)
    assert batchers[1].bucket_modes == batchers[0].bucket_modes
    assert batchers[1].dispatch_mode == batchers[0].dispatch_mode == "step"
    jtrace.g_spans.enabled = ttrace.g_spans.enabled = True
    got = [[], []]
    for txns, v, old in hot_batches(7 + depth):
        for i, pipe in enumerate(pipes):
            got[i].append(pipe.submit(txns, v, old))
    for i, pipe in enumerate(pipes):
        pipe.drain()
        got[i] = [ints(h.result()) for h in got[i]]
    assert got[1] == got[0]
    assert sorted(batchers[1].ewma_ms) == sorted(batchers[0].ewma_ms)
    assert all(v > 0 for v in batchers[1].ewma_ms.values())
    assert pipes[1].suggested_batch_txns() == pipes[0].suggested_batch_txns() == \
        max(t for t, _, _ in batchers[1].ewma_ms)
    assert scheds[1].counters == scheds[0].counters
    assert scheds[1].predictor.scores == scheds[0].predictor.scores
    assert scheds[1].predictor.last_write == scheds[0].predictor.last_write
    assert scheds[1].predictor.scores
    forces = [[s["Trace"] for s in tr.g_spans.by_name("pipeline.force")] for tr in (jtrace, ttrace)]
    assert forces[1] == forces[0] and len(forces[1]) == len(got[1])
    assert span_counts(ttrace) == span_counts(jtrace)
    assert series(ttelemetry).keys() == series(jtelemetry).keys()
