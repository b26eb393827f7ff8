"""Keyspace heat in the port against the JAX package's.

  * heat_of and the witness context local_phases adds to `edges`, step by
    step over 40-step streams in both search modes and both history
    structures, GC and no-GC batches interleaved; the chunk scan's stacked
    heat against JAX's scan;
  * the host aggregator (foundationdb_tpu_torch.core.heatmap) against the
    JAX package's on the same merged aggregates and the same transactions;
  * TorchConflictEngine(device="cpu") against JaxConflictEngine at the same
    heat settings: heat_snapshot() and history_stats_snapshot() over the
    general router and the columnar ladder, and the default heat buckets.

Every quantity is an integer or a float computed by the same operations in
the same order: tolerance 0.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from foundationdb_tpu.core import heatmap as jheatmap
from foundationdb_tpu.ops import conflict_kernel as jck
from foundationdb_tpu.ops.host_engine import JaxConflictEngine
from foundationdb_tpu.ops.oracle import OracleConflictEngine
from foundationdb_tpu_torch.core import heatmap as theatmap
from foundationdb_tpu_torch.core import types as ttypes
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine
from test_torch_conflict_kernel import SMALL, eq, port_cfg, synth_batch, to_jax
from test_torch_columnar import CFG as LCFG
from test_torch_columnar import stream as columnar_stream
from test_torch_engine import ints, short_stream

torch.set_num_threads(1)

MODES = ("fused_sort", "bsearch")
STRUCTURES = ("monolithic", "tiered")
B = 8
ESMALL = jck.KernelConfig(key_words=2, capacity=512, max_reads=64, max_writes=64, max_txns=16)

_JIT = {}


def jfn(name, cfg):
    k = (name, cfg)
    if k not in _JIT:
        _JIT[k] = jax.jit({
            "local": lambda s, b: jck.local_phases(cfg, s, b),
            "step": lambda s, b: jck.resolve_step(cfg, s, b),
            "scan": lambda s, b: jck.resolve_step_scan(cfg, s, b),
        }[name])
    return _JIT[k]


def heat_cfg(structure, mode="auto", buckets=B):
    cfg = dataclasses.replace(SMALL, history_search=mode, heat_buckets=buckets)
    if structure == "tiered":
        cfg = dataclasses.replace(cfg, history_structure="tiered", history_runs=3)
    return cfg


def check_heat(theat, jheat, where):
    assert theat.keys() == jheat.keys(), where
    for k in jheat:
        assert eq(theat[k], jheat[k]), (where, k)


def check_state(tstate, jstate):
    assert tstate.keys() == jstate.keys()
    for k in jstate:
        assert eq(tstate[k], jstate[k]), k


def heat_stream(cfg, seed, steps=40):
    """(batch arrays, gc) per step: GC every third batch, versions rebased
    after it, a read-only batch every seventh."""
    rng = random.Random(seed)
    now = 100
    for trial in range(steps):
        now += rng.randrange(5, 20)
        gc = now - rng.randrange(30, 60) if trial % 3 == 2 else 0
        batch_np = synth_batch(rng, cfg, now, gc)
        if trial % 7 == 6:
            batch_np["wp_valid"][:] = False
            batch_np["w_valid"][:] = False
        yield batch_np, gc
        if gc > 0:
            now -= gc


@pytest.mark.parametrize("structure", STRUCTURES)
@pytest.mark.parametrize("mode", MODES)
def test_heat_of_and_witness_context_match_jax(mode, structure):
    """resolve_step's heat aggregate and local_phases' heat_* edges equal
    JAX's on every step of a 40-step stream, padding rows included; the
    stream reaches history and intra-batch witnesses, GC reclaims and (under
    the tiered structure) merges."""
    cfg = heat_cfg(structure, mode)
    tcfg = port_cfg(cfg)
    js, ts = jck.initial_state(cfg), tck.initial_state(tcfg)
    seen = {"hist_witness": 0, "batch_witness": 0, "reclaimed": 0, "merges": 0}
    for trial, (batch_np, gc) in enumerate(heat_stream(cfg, 50 + len(mode) + len(structure))):
        jb = to_jax(batch_np)
        tb = tck.batch_from_numpy(tcfg, batch_np, "cpu")
        _, je, _ = jfn("local", cfg)(js, jb)
        _, te, _ = tck.local_phases(tcfg, ts, tb)
        for k in ("heat_hhit_p", "heat_hver_p", "heat_hhit_r", "heat_hver_r"):
            assert eq(te[k], je[k]), (trial, k)
        js, jout = jfn("step", cfg)(js, jb)
        ts, tout = tck.resolve_step(tcfg, ts, tb, gc > 0)
        assert eq(tout["status"], jout["status"]), trial
        check_state(ts, js)
        check_heat(tout["heat"], jout["heat"], trial)
        wv = np.asarray(jout["heat"]["wit_ver"])
        hit = np.asarray(je["heat_hhit_p"])
        seen["hist_witness"] += int(hit.any())
        seen["batch_witness"] += int(np.any(wv == int(batch_np["now"])))
        seen["reclaimed"] += int(np.asarray(jout["heat"]["counts"])[3] > 0)
        seen["merges"] += int(tout.get("merged", torch.tensor(False)))
    assert seen["hist_witness"] and seen["batch_witness"] and seen["reclaimed"], seen
    assert structure == "monolithic" or seen["merges"], seen


def test_heat_without_range_rows_and_shapes():
    """Rr == 0: the range-row witness context is empty, as JAX makes it;
    heat_shapes is heat_struct's table (bounds as int64 words)."""
    cfg = dataclasses.replace(SMALL, max_reads=0, max_writes=0, heat_buckets=4)
    tcfg = port_cfg(cfg)
    rng = random.Random(3)
    batch_np = synth_batch(rng, cfg, 100, 0)
    js, ts = jck.initial_state(cfg), tck.initial_state(tcfg)
    _, je, _ = jfn("local", cfg)(js, to_jax(batch_np))
    _, te, _ = tck.local_phases(tcfg, ts, tck.batch_from_numpy(tcfg, batch_np, "cpu"))
    assert te["heat_hhit_r"].shape == (0,) and te["heat_hver_r"].dtype == torch.int32
    assert eq(te["heat_hver_p"], je["heat_hver_p"])
    for structure in STRUCTURES:
        c = heat_cfg(structure)
        shapes = tck.heat_shapes(port_cfg(c))
        want = jck.heat_struct(c)
        assert shapes.keys() == want.keys()
        for k, (shape, dtype) in shapes.items():
            assert shape == want[k].shape, k
            assert dtype == (torch.int64 if k == "bounds" else torch.int32), k
    assert tck.heat_shapes(port_cfg(SMALL)) == {}


@pytest.mark.parametrize("structure", STRUCTURES)
@pytest.mark.parametrize("gc_last", [False, True])
def test_scan_stacks_heat_like_jax(structure, gc_last):
    """resolve_step_scan stacks the per-chunk aggregates [C, ...] as JAX's
    lax.scan does."""
    cfg = heat_cfg(structure)
    tcfg = port_cfg(cfg)
    rng = random.Random(8 + gc_last)
    js, ts = jck.initial_state(cfg), tck.initial_state(tcfg)
    for rnd in range(3):
        chunks = [synth_batch(rng, cfg, 100 + 30 * rnd + c, 0) for c in range(3)]
        if gc_last:
            chunks[-1]["gc"] = np.asarray(60 + 30 * rnd, np.int32)
        stacked = {k: np.stack([c[k] for c in chunks]) for k in chunks[0]}
        js, jout = jfn("scan", cfg)(js, to_jax(stacked))
        per = [tck.batch_from_numpy(tcfg, c, "cpu") for c in chunks]
        ts, tout = tck.resolve_step_scan(
            tcfg, ts, {k: torch.stack([p[k] for p in per]) for k in per[0]}, gc_last)
        assert eq(tout["status"], jout["status"])
        check_heat(tout["heat"], jout["heat"], rnd)
        check_state(ts, js)


# ---------------------------------------------------------------------------
# the host aggregator
# ---------------------------------------------------------------------------

def test_aggregator_constants_equal_the_knob_defaults():
    """The port reads the heat settings from its own knob registry, as the
    JAX package reads its: the same four knobs, the same defaults."""
    from foundationdb_tpu.core.knobs import SERVER_KNOBS
    from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS as TSERVER_KNOBS

    assert theatmap.heat_buckets_from_knobs() == jheatmap.heat_buckets_from_knobs() == 64
    tagg = theatmap.aggregator_for(port_cfg(heat_cfg("monolithic")))
    jagg = jheatmap.aggregator_for(heat_cfg("monolithic"))
    assert tagg.decay == jagg.decay == TSERVER_KNOBS.resolver_heat_decay \
        == SERVER_KNOBS.resolver_heat_decay
    assert tagg.default_split_shards() == jagg.default_split_shards() \
        == SERVER_KNOBS.resolver_heat_split_shards
    assert tagg._split_hysteresis() == jagg._split_hysteresis() \
        == SERVER_KNOBS.resolver_heat_split_hysteresis
    assert theatmap.aggregator_for(port_cfg(SMALL)) is None


@pytest.mark.parametrize("structure", STRUCTURES)
def test_aggregator_matches_jax_on_the_same_aggregates(structure):
    """Both aggregators merge the JAX step's aggregates of one stream (the
    port's keys as int64 words, JAX's as uint32) and agree on every read:
    the snapshot (hot ranges, split points and balance, attribution,
    history counters), brief(), split_key_within, attribution_for and the
    drained witnesses; then the host-fed observe_batch on the same
    transactions and verdicts."""
    cfg = heat_cfg(structure)
    tcfg = port_cfg(cfg)
    jagg = jheatmap.aggregator_for(cfg)
    tagg = theatmap.aggregator_for(tcfg)
    js, ts = jck.initial_state(cfg), tck.initial_state(tcfg)
    for trial, (batch_np, gc) in enumerate(heat_stream(cfg, 17)):
        js, jout = jfn("step", cfg)(js, to_jax(batch_np))
        ts, tout = tck.resolve_step(tcfg, ts, tck.batch_from_numpy(tcfg, batch_np, "cpu"), gc > 0)
        jagg.merge({k: np.asarray(v) for k, v in jout["heat"].items()}, base=1000 * trial,
                   version=trial)
        tagg.merge({k: v.numpy() for k, v in tout["heat"].items()}, base=1000 * trial,
                   version=trial)
        if trial % 10 == 9:
            assert tagg.snapshot() == jagg.snapshot(), trial
            assert tagg.drain_witnesses() == jagg.drain_witnesses(), trial
    assert tagg.snapshot(top_n=3) == jagg.snapshot(top_n=3)
    assert tagg.brief() == jagg.brief() == tagg.snapshot(brief=True)
    assert tagg.history_snapshot() == jagg.history_snapshot()
    assert structure == "monolithic" or tagg.history_merges_total > 0
    for s in (2, 3, 8):
        assert tagg.split_points(s) == jagg.split_points(s)
        assert tagg.split_balance(s) == jagg.split_balance(s)
    keys = sorted(tagg._w)
    assert tagg.split_key_within(keys[0], None) == jagg.split_key_within(keys[0], None)
    assert tagg.attribution_for(39) == jagg.attribution_for(39)
    assert tagg.concentration() == jagg.concentration() > 0
    tagg.reset_weights()
    jagg.reset_weights()
    assert tagg.snapshot() == jagg.snapshot()

    # host-fed merges: the same CommitTransactions through both aggregators
    ora = OracleConflictEngine()
    for txns, now, oldest in short_stream(9, batches=12):
        verdicts = ints(ora.resolve(txns, now, oldest))
        ttxns = [ttypes.CommitTransaction(
            read_snapshot=t.read_snapshot,
            read_conflict_ranges=[ttypes.KeyRange(r.begin, r.end) for r in t.read_conflict_ranges],
            write_conflict_ranges=[ttypes.KeyRange(r.begin, r.end)
                                   for r in t.write_conflict_ranges]) for t in txns]
        jagg.observe_batch(txns, verdicts, version=now)
        tagg.observe_batch(ttxns, verdicts, version=now)
    assert tagg.snapshot() == jagg.snapshot()
    assert tagg.drain_witnesses() == jagg.drain_witnesses()


def test_aggregator_prunes_like_jax():
    """More distinct boundary keys than MAX_RANGES: both keep the same
    heaviest ranges."""
    K = 2
    jagg = jheatmap.KeyRangeHeatAggregator(K, 4096, 16, decay=0.9)
    tagg = theatmap.KeyRangeHeatAggregator(K, 4096, 16, decay=0.9)
    rng = np.random.default_rng(5)
    for b in range(60):
        bounds = np.zeros((16, K + 1), np.uint32)
        bounds[:, 0] = np.sort(rng.integers(0, 2**32, 16, dtype=np.uint64)).astype(np.uint32)
        bounds[:, K] = 4
        heat = {"bounds": bounds, "hist": rng.integers(0, 5, (16, 3)).astype(np.int32),
                "counts": rng.integers(0, 9, 4).astype(np.int32), "occupancy": np.int32(b),
                "wit_ver": rng.integers(-5, 5, 16).astype(np.int32),
                "wit_bucket": rng.integers(-1, 16, 16).astype(np.int32)}
        jagg.merge(heat, base=b, version=b)
        tagg.merge({**heat, "bounds": heat["bounds"].astype(np.int64)}, base=b, version=b)
    assert len(tagg._w) == len(jagg._w) == jheatmap.KeyRangeHeatAggregator.MAX_RANGES
    assert tagg.snapshot() == jagg.snapshot()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_default_heat_buckets_and_precedence():
    """The port's engine resolves heat as JAX's _resolve_heat does: the
    argument, then a nonzero cfg.heat_buckets, then 64; 0 turns it off."""
    base = port_cfg(ESMALL)
    for cfg_b, arg, want in ((0, None, 64), (16, None, 16), (16, 4, 4), (0, 0, 0), (16, 0, 0)):
        jcfg = dataclasses.replace(ESMALL, heat_buckets=cfg_b)
        port = TorchConflictEngine(dataclasses.replace(base, heat_buckets=cfg_b), device="cpu",
                                   heat_buckets=arg)
        jeng = JaxConflictEngine(jcfg, heat_buckets=arg)
        assert port.cfg.heat_buckets == jeng.cfg.heat_buckets == want
        assert (port.heat is None) == (jeng.heat is None) == (want == 0)
        assert all(b.heat_buckets == want for b in port.buckets)
    assert TorchConflictEngine(base, device="cpu").heat_snapshot()["buckets"] == 64
    assert TorchConflictEngine(base, device="cpu", heat_buckets=0).heat_snapshot() is None
    with pytest.raises(ValueError, match="heat_buckets must be >= 0"):
        TorchConflictEngine(base, device="cpu", heat_buckets=-1)
    tck.check_supported(dataclasses.replace(base, heat_buckets=64))


def test_unknown_heat_layout_raises():
    eng = TorchConflictEngine(port_cfg(ESMALL), device="cpu", heat_buckets=4)
    for layout in ("s", "cs", "sc", "x"):
        with pytest.raises(ValueError, match="unknown heat layout"):
            eng._merge_heat({"bounds": np.zeros((1, 4, 3))}, layout=layout)


def engines_at_equal_heat(cfg, structure, **kw):
    port = TorchConflictEngine(port_cfg(cfg), device="cpu", heat_buckets=B,
                               history_structure=structure, **kw)
    jeng = JaxConflictEngine(cfg, heat_buckets=B, history_structure=structure, **kw)
    return port, jeng


def check_engines(port, jeng, batches, every=5):
    ora = OracleConflictEngine()
    for b, (txns, now, oldest) in enumerate(batches):
        want = ints(ora.resolve(txns, now, oldest))
        assert ints(port.resolve(txns, now, oldest)) == want, b
        assert ints(jeng.resolve(txns, now, oldest)) == want, b
        if b % every == every - 1:
            assert port.heat_snapshot() == jeng.heat_snapshot(), b
            assert port.history_stats_snapshot() == jeng.history_stats_snapshot(), b
    assert port.heat_snapshot() == jeng.heat_snapshot()
    assert port.heat_snapshot(top_n=2, brief=True) == jeng.heat_snapshot(top_n=2, brief=True)
    assert port.history_stats_snapshot() == jeng.history_stats_snapshot()


@pytest.mark.parametrize("structure", STRUCTURES)
def test_engine_general_router_heat_matches_jax(structure):
    """Range and empty reads: every batch takes the general router (fused
    step, heat merged per chunk; split-step chunks emit none, as in JAX)."""
    port, jeng = engines_at_equal_heat(ESMALL, structure, ladder=())
    check_engines(port, jeng, list(short_stream(13, batches=30)))
    snap = port.heat_snapshot()
    assert snap["batches"] > 0 and snap["hot_ranges"] and snap["recent_attribution"]
    if structure == "tiered":
        stats = port.history_stats_snapshot()
        assert stats["merges"] > 0 and stats["merges"] == port.perf.merges
        assert stats["appends"] > 0


@pytest.mark.parametrize("structure", STRUCTURES)
def test_engine_columnar_ladder_heat_matches_jax(structure):
    """Point-only batches over the bucket ladder and chunk scans (heat
    merged per chunk of each scan, in order), two batches through the
    general router."""
    port, jeng = engines_at_equal_heat(LCFG, structure, ladder=[32, 64], scan_sizes=(2,))
    check_engines(port, jeng, columnar_stream(29, stale=0.1), every=4)
    assert port.perf.scan_dispatches.get(2, 0) > 0
    assert port.perf.bucket_hits == dict(jeng.perf.bucket_hits)
    assert port.heat_snapshot()["verdicts"] == jeng.heat_snapshot()["verdicts"]
    if structure == "tiered":
        assert port.history_stats_snapshot()["merges"] == port.perf.merges > 0


def test_heat_changes_no_verdict():
    """Heat on and heat off give the same verdicts on one stream."""
    on = TorchConflictEngine(port_cfg(ESMALL), device="cpu", ladder=())
    off = TorchConflictEngine(port_cfg(ESMALL), device="cpu", ladder=(), heat_buckets=0)
    for txns, now, oldest in short_stream(44, batches=20):
        assert ints(on.resolve(txns, now, oldest)) == ints(off.resolve(txns, now, oldest))
    assert on.heat_snapshot()["batches"] > 0 and off.heat is None
