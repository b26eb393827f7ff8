"""The tiered sorted-run history of the port against the JAX package's.

Functions first: the run probe, the lazy merge and the tiered apply on the
same states and batches return what foundationdb_tpu.ops.conflict_kernel
returns, element for element, padding rows included; then resolve_step
streams at the run geometries tests/test_history_tiered.py pins; then
TorchConflictEngine(device="cpu") with history_structure="tiered" against
JaxConflictEngine (tiered) and the oracle, and the port's ResolverPipeline
against the JAX package's. Every quantity is an integer: tolerance 0.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.core import types as jtypes
from foundationdb_tpu.core.types import CommitTransaction, KeyRange
from foundationdb_tpu.ops import conflict_kernel as jck
from foundationdb_tpu.ops.host_engine import JaxConflictEngine
from foundationdb_tpu.ops.oracle import OracleConflictEngine
from foundationdb_tpu.pipeline import ResolverPipeline as JaxPipeline
from foundationdb_tpu_torch.core import types as ttypes
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine
from foundationdb_tpu_torch.pipeline import ResolverPipeline
from test_torch_conflict_kernel import SMALL, bits_eq, eq, key, port_cfg, synth_batch, to_jax
from test_torch_engine import ints, short_stream
from test_torch_pipeline import pipelined, serial_verdicts
from test_torch_pipeline import make_batches as pipeline_batches

torch.set_num_threads(1)

MODES = ("fused_sort", "bsearch")
TIERED = dataclasses.replace(SMALL, history_structure="tiered", history_runs=3)
#: the engine configs of tests/test_history_tiered.py:37-39
ESMALL = jck.KernelConfig(key_words=2, capacity=512, max_reads=64, max_writes=64, max_txns=16)
ETIERED = dataclasses.replace(ESMALL, history_structure="tiered", history_runs=3)

_JIT = {}


def jfn(name, cfg):
    """The JAX package's tiered functions, jitted once per config."""
    k = (name, cfg)
    if k not in _JIT:
        _JIT[k] = jax.jit({
            "probe": lambda s, b, e: jck._tiered_read_probe(
                cfg, s, b["rpb"], b["rp_valid"], b["rb"], b["re"], b["r_valid"], e),
            "merge": lambda s: jck._merge_runs(cfg, s["hkeys"], s["hvers"], s["n"], s["rkeys"],
                                               s["rvers"], s["rn"], s["nruns"]),
            "apply": lambda s, b, ub, ue, u: jck._tiered_apply(cfg, s, b, ub, ue, u),
            "local": lambda s, b: jck.local_phases(cfg, s, b),
            "step": lambda s, b: jck.resolve_step(cfg, s, b),
        }[name])
    return _JIT[k]


def check_state(tstate, jstate):
    assert tstate.keys() == jstate.keys()
    for k in jstate:
        assert eq(tstate[k], jstate[k]), k


def packed(keys, cfg):
    return jck.keypack.pack_keys(keys, cfg.key_words)


def synth_state(cfg, rng, n_base, nruns, n_keys=24, width=2, run_version=61, min_key_run=False,
                point_runs=False):
    """A tiered table in numpy: n_base sorted distinct base keys (row 0 the
    minimal key b'') at versions in [-1, 60]; `nruns` active runs, each a
    union of disjoint intervals over the same key space (some on base
    keys) as alternating (begin, version) / (end, NEG) rows, a newer
    version per run; slots past nruns and rows past rn[j] all-ones / NEG.
    `min_key_run`: run 0's first interval begins at b''. `point_runs`:
    every interval is one key [k, k+'\\x00'), so runs cover no base row
    and a merge adds two rows per interval."""
    H, K, NR, RC = cfg.capacity, cfg.lanes, cfg.run_slots, cfg.run_rows
    draws = min(4 * n_keys, 4 * (H + NR * RC))
    pool = sorted({key(rng, n_keys, width) for _ in range(draws)} - {b""})
    base = [b""] + sorted(rng.sample(pool, min(n_base - 1, len(pool))))
    hkeys = np.zeros((H, K), np.uint32)
    hkeys[:len(base)] = packed(base, cfg)
    hvers = np.full((H,), jck.NEG_VERSION, np.int32)
    hvers[:len(base)] = [rng.randrange(-1, 61) for _ in base]
    rkeys = np.full((NR, RC, K), 0xFFFFFFFF, np.uint32)
    rvers = np.full((NR, RC), jck.NEG_VERSION, np.int32)
    rn = np.zeros((NR,), np.int32)
    for j in range(nruns):
        if point_runs:
            ends = [e for k in sorted(rng.sample(pool, RC // 2)) for e in (k, k + b"\x00")]
        else:
            ends = sorted(rng.sample(pool, 2 * rng.randrange(1, min(len(pool), RC) // 2 + 1)))
        if j == 0 and min_key_run:
            ends[0] = b""
        rkeys[j, :len(ends)] = packed(ends, cfg)
        rvers[j, :len(ends):2] = run_version + j
        rn[j] = len(ends)
    return {"hkeys": hkeys, "hvers": hvers, "n": np.int32(len(base)), "rkeys": rkeys,
            "rvers": rvers, "rn": rn, "nruns": np.int32(nruns)}


def jax_state(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def empty_read_at_min(batch_np):
    """Make range read row 0 the empty read [b'', b'') of txn 0."""
    batch_np["rb"][0] = 0
    batch_np["re"][0] = 0
    batch_np["r_txn"][0] = 0
    batch_np["r_snap"][0] = 0
    batch_np["r_valid"][0] = True
    return batch_np


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_read_probe_and_local_phases_match_jax(mode):
    """The batched run probe equals the JAX per-run loop, and local_phases
    with the runs folded in equals the JAX function, in both search modes:
    full and partial run stacks, an empty stack, and the empty read at b''
    against a run that begins at b''."""
    cfg = dataclasses.replace(TIERED, history_search=mode)
    tcfg = port_cfg(cfg)
    rng = random.Random(41 if mode == "bsearch" else 40)
    hits = 0
    for trial in range(9):
        st = synth_state(cfg, rng, n_base=rng.randrange(1, 40), nruns=trial % (cfg.run_slots + 1),
                         min_key_run=trial % 2 == 1)
        batch_np = synth_batch(rng, cfg, 100, 0)
        if trial % 2:
            batch_np = empty_read_at_min(batch_np)
        js, jb = jax_state(st), to_jax(batch_np)
        ts, tb = tck.state_from_numpy(tcfg, st, "cpu"), tck.batch_from_numpy(tcfg, batch_np, "cpu")
        empty_r = ~tck._key_less(tb["rb"], tb["re"])
        jvp, jvr = jfn("probe", cfg)(js, jb, jnp.asarray(empty_r.numpy()))
        tvp, tvr = tck._tiered_read_probe(tcfg, ts, tb["rpb"], tb["rp_valid"], tb["rb"],
                                          tb["re"], tb["r_valid"], empty_r)
        assert eq(tvp, jvp) and eq(tvr, jvr), trial
        hits += int((tvp > 0).sum() + (tvr > 0).sum())
        jh, je, jw = jfn("local", cfg)(js, jb)
        th, te, tw = tck.local_phases(tcfg, ts, tb)
        assert eq(th, jh), trial
        for k in ("ovw", "ovrp"):
            assert bits_eq(te[k], je[k]), (trial, k)
        for k in ("gid_rp", "gid_wp"):
            assert eq(te[k], je[k]), (trial, k)
        for k in jw:
            assert eq(tw[k], jw[k]), (trial, k)
    assert hits > 0


@pytest.mark.parametrize("case", ["partial", "full", "overflow", "empty"])
def test_merge_runs_matches_jax(case):
    """_merge_runs on the same base and run stack: merged keys, versions,
    m_n, overflow and the dropped count, padding rows included. "overflow"
    puts a nearly full base under runs of new keys, so m_n > H."""
    cfg = TIERED
    tcfg = port_cfg(cfg)
    rng = random.Random({"partial": 1, "full": 2, "overflow": 3, "empty": 4}[case])
    for trial in range(4):
        if case == "overflow":
            st = synth_state(cfg, rng, n_base=cfg.capacity - 8, nruns=cfg.run_slots,
                             n_keys=10**6, width=6, point_runs=True)
        else:
            nruns = {"partial": 1 + trial % 2, "full": cfg.run_slots, "empty": 0}[case]
            st = synth_state(cfg, rng, n_base=rng.randrange(1, 60), nruns=nruns)
        if trial == 3:
            st["rvers"][st["rvers"] != jck.NEG_VERSION] = -1    # after a GC rebase
        jout = jfn("merge", cfg)(jax_state(st))
        ts = tck.state_from_numpy(tcfg, st, "cpu")
        tout = tck._merge_runs(tcfg, ts["hkeys"], ts["hvers"], ts["n"], ts["rkeys"],
                               ts["rvers"], ts["rn"], ts["nruns"])
        for name, t, j in zip(("mkeys", "mvers", "m_n", "overflow", "dropped"), tout, jout):
            assert eq(t, j), (case, trial, name)
        assert bool(tout[3]) == (case == "overflow"), (case, trial)


def union_rows(cfg, rng, u):
    """u disjoint sorted intervals as the padded (ub_keys, ue_keys) [Wa, K]
    of phase 3 (rows past u are zero, as phase 3 leaves them)."""
    Wa, K = cfg.w_all, cfg.lanes
    ends = sorted({key(rng, 10**4, 4) for _ in range(8 * u)})[:2 * u]
    ub = np.zeros((Wa, K), np.uint32)
    ue = np.zeros((Wa, K), np.uint32)
    if u:
        ub[:u] = packed(ends[0::2], cfg)
        ue[:u] = packed(ends[1::2], cfg)
    return ub, ue


@pytest.mark.parametrize("case,nruns,u,gc", [
    ("append", 1, 5, 0),
    ("merge", 3, 7, 0),
    ("read_only_full_stack", 3, 0, 0),
    ("read_only_gc", 2, 0, 40),
    ("gc_neg_gaps", 2, 4, 40),
    ("merge_gc", 3, 3, 30),
    ("merge_overflow", 3, 9, 0),
])
def test_tiered_apply_matches_jax(case, nruns, u, gc):
    """_tiered_apply on the same state, union and batch: every state array,
    overflow and reclaimed; the merge flag is the JAX do_merge predicate."""
    cfg = TIERED
    tcfg = port_cfg(cfg)
    rng = random.Random(sum(case.encode()))
    if case == "merge_overflow":
        st = synth_state(cfg, rng, n_base=cfg.capacity - 8, nruns=nruns, n_keys=10**6, width=6,
                         point_runs=True)
    else:
        st = synth_state(cfg, rng, n_base=rng.randrange(1, 60), nruns=nruns, n_keys=10**4,
                         width=4)
    batch_np = synth_batch(rng, cfg, 100, gc)
    ub, ue = union_rows(cfg, rng, u)
    jns, jov, jrec = jfn("apply", cfg)(jax_state(st), to_jax(batch_np), jnp.asarray(ub),
                                       jnp.asarray(ue), jnp.asarray(u, jnp.int32))
    ts = tck.state_from_numpy(tcfg, st, "cpu")
    tns, tov, trec, merged = tck._tiered_apply(
        tcfg, ts, tck.batch_from_numpy(tcfg, batch_np, "cpu"),
        torch.from_numpy(ub.astype(np.int64)), torch.from_numpy(ue.astype(np.int64)),
        torch.tensor(u), gc > 0)
    check_state(tns, jns)
    assert bool(tov) == bool(jov) and int(trec) == int(jrec)
    assert bool(merged) == (u > 0 and nruns >= cfg.run_slots)
    assert bool(tov) == (case == "merge_overflow")
    if gc:
        rv = tns["rvers"].numpy()
        assert (rv == jck.NEG_VERSION).any() and (rv[rv != jck.NEG_VERSION] >= -1).all()


def test_run_if_branches_on_the_host_for_cpu_tensors():
    """run_if on CPU tensors is a host branch (no host-read count, which
    counts syncs on the card); an IF node asked for outside
    graph_if.bodies raises before it touches the card."""
    from foundationdb_tpu_torch.ops import graph_if

    ran = []
    reads = tck.MERGE.host_reads
    for flag in (False, True):
        tck.run_if(torch.tensor(flag), lambda: ran.append(flag))
    assert ran == [True] and tck.MERGE.host_reads == reads
    with pytest.raises(RuntimeError, match="bodies"):
        with graph_if.if_node(torch.tensor(True)):
            pass


def test_tiered_state_round_trip_and_geometry():
    """initial_state and the shape table carry the run planes only under
    the tiered structure, as state_struct does; bucket() keeps the run
    geometry; the rejected geometries raise the JAX package's messages."""
    tcfg = port_cfg(TIERED)
    js = {k: np.asarray(v) for k, v in jck.initial_state(TIERED, version_rel=7,
                                                          first_key=b"k").items()}
    ts = tck.initial_state(tcfg, version_rel=7, first_key=b"k")
    check_state(ts, js)
    back = tck.state_to_numpy(ts)
    assert back["rkeys"].dtype == np.uint32 and np.array_equal(back["rkeys"], js["rkeys"])
    for name, struct in jck.state_struct(TIERED).items():
        assert tck.state_shapes(tcfg)[name][0] == struct.shape, name
    assert set(tck.state_shapes(port_cfg(SMALL))) == {"hkeys", "hvers", "n"}
    wide = port_cfg(dataclasses.replace(TIERED, max_txns=128))
    b = wide.bucket(32)
    assert (b.run_slots, b.run_rows) == (wide.run_slots, wide.run_rows)
    assert set(tck.state_shapes(b)) == set(tck.state_shapes(wide))
    for bad in (dict(history_run_rows=8), dict(history_runs=1)):
        jcfg = dataclasses.replace(SMALL, history_structure="tiered", **bad)
        with pytest.raises(ValueError) as want:
            jck.resolved_history_structure(jcfg)
        with pytest.raises(ValueError) as got:
            tck.resolved_history_structure(port_cfg(jcfg))
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError) as eng_err:
            TorchConflictEngine(port_cfg(jcfg), device="cpu")
        assert str(eng_err.value) == str(want.value)


# ---------------------------------------------------------------------------
# resolve_step streams
# ---------------------------------------------------------------------------

#: (history_runs, history_run_rows): tests/test_history_tiered.py:144-150
GEOMETRIES = [(2, 0), (3, 0), (8, 0), (4, 2 * SMALL.w_all)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("runs,rows", GEOMETRIES)
def test_resolve_step_stream_matches_jax(mode, runs, rows):
    """40 batches through resolve_step: statuses, overflow and every state
    array (run planes included) equal after every step; merges, GC batches
    and read-only batches all occur."""
    cfg = dataclasses.replace(SMALL, history_search=mode, history_structure="tiered",
                              history_runs=runs, history_run_rows=rows)
    tcfg = port_cfg(cfg)
    rng = random.Random(100 * runs + rows % 97)
    js, ts = jck.initial_state(cfg), tck.initial_state(tcfg)
    now, merges, read_only = 100, 0, 0
    for trial in range(40):
        now += rng.randrange(5, 20)
        gc = now - rng.randrange(30, 60) if trial % 3 == 2 else 0
        batch_np = synth_batch(rng, cfg, now, gc)
        if trial % 7 == 6:
            batch_np["wp_valid"][:] = False
            batch_np["w_valid"][:] = False
            read_only += 1
        js, jout = jfn("step", cfg)(js, to_jax(batch_np))
        ts, tout = tck.resolve_step(tcfg, ts, tck.batch_from_numpy(tcfg, batch_np, "cpu"), gc > 0)
        assert eq(tout["status"], jout["status"]), trial
        assert bool(tout["overflow"]) == bool(jout["overflow"]), trial
        check_state(ts, js)
        merges += int(tout["merged"])
        if gc > 0:
            now -= gc
    assert merges >= 40 // (runs + 2) and read_only > 0


# ---------------------------------------------------------------------------
# the engine and the pipeline
# ---------------------------------------------------------------------------

def three_way(cfg, stream, **kw):
    """The port's tiered engine (CPU), the JAX tiered engine and the oracle
    over one stream, both engines with heat off: equal verdicts on every
    batch and equal history stats after it."""
    port = TorchConflictEngine(port_cfg(cfg), device="cpu", heat_buckets=0, **kw)
    jeng = JaxConflictEngine(cfg, heat_buckets=0, **kw)
    ora = OracleConflictEngine()
    for b, (txns, now, oldest) in enumerate(stream):
        want = ints(ora.resolve(txns, now, oldest))
        assert ints(port.resolve(txns, now, oldest)) == want, b
        assert ints(jeng.resolve(txns, now, oldest)) == want, b
    assert port.history_stats_snapshot() == jeng.history_stats_snapshot()
    return port, jeng


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [5, 21])
def test_engine_random_streams(mode, seed):
    cfg = dataclasses.replace(ETIERED, history_search=mode)
    port, _ = three_way(cfg, short_stream(seed, batches=35), ladder=())
    assert port.history_structure == "tiered" and port.perf.merges > 0


def wtxn(version, ranges, types=jtypes):
    t = types.CommitTransaction(read_snapshot=version)
    for b, e in ranges:
        t.write_conflict_ranges.append(types.KeyRange(b, e))
    return t


@pytest.mark.parametrize("mode", MODES)
def test_empty_read_at_minimal_key_regression(mode):
    """tests/test_history_tiered.py:107: a run whose union begins at b''
    answers for the empty read [b'', b'')."""
    cfg = port_cfg(dataclasses.replace(ETIERED, history_search=mode))
    port = TorchConflictEngine(cfg, device="cpu", ladder=())
    assert ints(port.resolve([wtxn(100, [(b"", b"x")])], 100, 0)) == [2]
    r = CommitTransaction(read_snapshot=50, read_conflict_ranges=[KeyRange(b"", b"")])
    fresh = CommitTransaction(read_snapshot=100, read_conflict_ranges=[KeyRange(b"", b"")])
    assert ints(port.resolve([r, fresh], 120, 0)) == [0, 2]


def test_engine_structure_argument_and_stats():
    """history_structure= wins over the config; the stats rows are JAX's
    with heat off (identity rows, zero counters)."""
    port = TorchConflictEngine(port_cfg(ESMALL), device="cpu", history_structure="tiered",
                               heat_buckets=0)
    jeng = JaxConflictEngine(ESMALL, heat_buckets=0, history_structure="tiered")
    assert port.history_structure == jeng.history_structure == "tiered"
    assert port.history_stats_snapshot() == jeng.history_stats_snapshot()
    mono = TorchConflictEngine(port_cfg(ETIERED), device="cpu", history_structure="monolithic")
    assert mono.history_structure == "monolithic" and mono.history_run_snapshots() is None
    assert mono.history_stats_snapshot()["run_slots"] == 0
    with pytest.raises(ValueError, match="unknown history_structure"):
        TorchConflictEngine(port_cfg(ESMALL), device="cpu", history_structure="lsm")


def test_tier_compaction_boundaries():
    """tests/test_history_tiered.py:135: a 2-slot stack and the minimum
    legal run plane stay oracle-exact through the engine."""
    two_slot = dataclasses.replace(ESMALL, history_structure="tiered", history_runs=2)
    tight = dataclasses.replace(ESMALL, history_structure="tiered", history_runs=4,
                                history_run_rows=2 * ESMALL.w_all)
    for cfg in (two_slot, tight):
        port, _ = three_way(cfg, short_stream(33, batches=40), ladder=())
        assert port.perf.merges > 0


def test_bucket_ladder_boundary_stream():
    """tests/test_history_tiered.py:191: batch sizes around the 32-txn
    bucket with GC advancing mid-stream: oracle-exact, and the same
    bucket_hits and scan_dispatches as the JAX engine."""
    cfg = dataclasses.replace(
        jck.KernelConfig(key_words=2, capacity=1024, max_reads=256, max_writes=256, max_txns=64),
        history_structure="tiered", history_runs=3)
    rng = random.Random(71)
    stream, now, oldest = [], 10, 0
    for b, size in enumerate([31, 32, 33, 64, 31, 33, 64, 32]):
        now += rng.randrange(5, 30)
        if b % 3 == 2:
            oldest = max(oldest, now - 60)
        stream.append(([_point_txn(rng, oldest, now) for _ in range(size)], now, oldest))
    port, jeng = three_way(cfg, stream, ladder=(32,), scan_sizes=(2,))
    assert port.perf.bucket_hits == dict(jeng.perf.bucket_hits)
    assert port.perf.scan_dispatches == dict(jeng.perf.scan_dispatches)
    assert sum(port.perf.bucket_hits.values()) > 0


def _point_txn(rng, oldest, now):
    """Point reads and writes only (the columnar path's traffic)."""
    t = CommitTransaction(read_snapshot=rng.randrange(max(0, oldest - 40), now))
    for _ in range(rng.randrange(0, 3)):
        k = b"p%03d" % rng.randrange(90)
        t.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
    for _ in range(rng.randrange(0, 3)):
        k = b"p%03d" % rng.randrange(90)
        t.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
    return t


def test_load_state_from_jax_tiered_engine():
    """A JAX tiered engine's table, run planes included, crosses into the
    port mid-stream (with a partly filled run stack); both continue with
    equal verdicts."""
    batches = list(short_stream(31, batches=26))
    jeng = JaxConflictEngine(ETIERED, heat_buckets=0, ladder=())
    for txns, now, oldest in batches[:13]:
        jeng.resolve(txns, now, oldest)
    jst = {k: np.asarray(v) for k, v in jeng.state.items()}
    assert 0 < int(jst["nruns"]) and int(jst["rn"].sum()) > 0
    port = TorchConflictEngine(port_cfg(ETIERED), device="cpu", ladder=())
    port.load_state(jst, jeng.base, jeng.oldest_version, jeng.tier_map)
    check_state(port.state, jst)
    for b, (txns, now, oldest) in enumerate(batches[13:]):
        assert ints(port.resolve(txns, now, oldest)) == ints(jeng.resolve(txns, now, oldest)), b
    assert port.perf.merges > 0


def test_run_snapshots_and_intervals_match_jax():
    """history_run_snapshot / run_intervals of the port's engine equal the
    JAX engine's: the full export, the since_runs delta, and the resync a
    merge forces on a held watermark (tests/test_history_tiered.py:252)."""
    cfg = dataclasses.replace(ETIERED, history_runs=4)
    port = TorchConflictEngine(port_cfg(cfg), device="cpu", ladder=())
    jeng = JaxConflictEngine(cfg, heat_buckets=0, ladder=())

    def both(txns, v):
        assert ints(port.resolve(txns, v, 0)) == ints(jeng.resolve(txns, v, 0)) == [2] * len(txns)

    def same(since=None):
        (ps,), (js,) = port.history_run_snapshots(since), jeng.history_run_snapshots(since)
        assert ps["structure"] == js["structure"] and ps["nruns"] == js["nruns"]
        assert len(ps["runs"]) == len(js["runs"])
        for (pk, pv), (jk, jv) in zip(ps["runs"], js["runs"]):
            assert pk.dtype == np.uint32 and np.array_equal(pk, jk) and np.array_equal(pv, jv)
        pi = [(a.tolist(), b.tolist(), v) for a, b, v in tck.run_intervals(ps)]
        ji = [(a.tolist(), b.tolist(), v) for a, b, v in jck.run_intervals(js)]
        assert pi == ji
        return ps

    for v, ranges in [(20, [(b"a", b"c"), (b"m", b"p")]), (35, [(b"b", b"d")]),
                      (50, [(b"", b"a\x00")])]:
        both([wtxn(v, ranges)], v)
    full = same()
    assert full["nruns"] == 3 and len(list(tck.run_intervals(full))) == 4
    both([wtxn(60, [(b"x", b"y")])], 60)
    delta = same([full["nruns"]])
    assert len(delta["runs"]) == 1
    for i, v in enumerate(range(70, 76)):
        both([wtxn(v, [(b"k%d" % i, b"k%d\x00" % i)])], v)
    after = same([delta["nruns"]])
    assert after["nruns"] < delta["nruns"] and port.perf.merges > 0     # resync


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_serves_tiered_engine(depth):
    """The port's ResolverPipeline over a tiered engine (ladder, scans)
    equals the JAX pipeline over a JAX tiered engine and the oracle; at
    depth 2 with packing on an executor thread too."""
    from concurrent.futures import ThreadPoolExecutor

    from test_torch_pipeline import CFG, LADDER, SCANS
    cfg = dataclasses.replace(CFG, history_structure="tiered", history_runs=3)
    batches = pipeline_batches(701 + depth, ttypes)
    jbatches = pipeline_batches(701 + depth, jtypes)
    from foundationdb_tpu.ops.oracle import OracleConflictEngine as JaxOracle
    want = serial_verdicts(jbatches, JaxOracle())

    def engines():
        eng = TorchConflictEngine(port_cfg(cfg), device="cpu", ladder=LADDER, scan_sizes=SCANS)
        jeng = JaxConflictEngine(cfg, ladder=list(LADDER), scan_sizes=SCANS, heat_buckets=0)
        return eng, jeng

    eng, jeng = engines()
    assert pipelined(ResolverPipeline, eng, batches, depth) == want
    assert pipelined(JaxPipeline, jeng, jbatches, depth) == want
    assert eng.perf.merges > 0
    assert eng.perf.scan_dispatches == dict(jeng.perf.scan_dispatches)
    assert eng.perf.bucket_hits == dict(jeng.perf.bucket_hits)
    if depth == 2:
        ex = ThreadPoolExecutor(1)
        try:
            eng, _ = engines()
            assert pipelined(ResolverPipeline, eng, batches, depth, ex) == want
        finally:
            ex.shutdown()
