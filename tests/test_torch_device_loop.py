"""The port's device-resident loop engine against the JAX package's.

  * decode_status_bits against status_of (both packages);
  * resolve_server_loop against JAX's over a Q-chunk slot at every fill
    level 1..Q, GC on the last chunk or none, both history structures: the
    bitmaps, overflow, heat planes (zero past the filled prefix) and table;
  * DeviceLoopEngine(device="cpu") against JAX's DeviceLoopEngine, the
    step engine and the oracle on the scenarios of tests/test_device_loop.py:
    batch sizes straddling every ladder bucket with GC cadences and general-
    router batches, the pipeline at depth 1-3 with a non-blocking drain,
    a kill / drain mid-queue then clear(); the drain accounting; the long-
    key split-step path; make_engine("device_loop").

Verdicts are compared, never compile counts. Tolerance 0.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict_kernel as jck
from foundationdb_tpu.ops import device_loop as jdl
from foundationdb_tpu.ops.oracle import OracleConflictEngine
from foundationdb_tpu_torch.core.types import TransactionCommitResult as R
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops import device_loop as tdl
from foundationdb_tpu_torch.ops import host_engine as the
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine
from foundationdb_tpu_torch.pipeline import ResolverPipeline
from test_device_loop import CFG, LADDER, SMALL, boundary_gc_stream, point_txns
from test_torch_conflict_kernel import SMALL as KSMALL
from test_torch_conflict_kernel import bits_eq, eq, port_cfg, synth_batch
from test_torch_engine import LONG, ints, long_stream

torch.set_num_threads(1)

STRUCTURES = ("monolithic", "tiered")
Q = 4
HEAT = 8
#: the JAX loop engines' compiled programs, shared by engines of one config
_JAX_PROGRAMS = {}


def tiered(cfg, runs=3):
    return dataclasses.replace(cfg, history_structure="tiered", history_runs=runs)


def test_decode_status_bits_matches_status_of():
    """Exhaustively at word boundaries (T = 70, three words, a ragged
    tail): the port's decode of uint32 words and of int32 words holding
    their bits equals JAX's decode and both packages' status_of."""
    T = 70
    rng = np.random.default_rng(7)
    commit = rng.integers(0, 2, size=(3, T)).astype(bool)
    too = rng.integers(0, 2, size=(3, T)).astype(bool)
    cw = tck._pack_bits(torch.from_numpy(commit), (T + 31) // 32).numpy()
    tw = tck._pack_bits(torch.from_numpy(too), (T + 31) // 32).numpy()
    want = np.asarray(jck.status_of(too, commit))
    assert np.array_equal(tdl.decode_status_bits(cw, tw, T), want)
    assert np.array_equal(tdl.decode_status_bits(cw.view(np.uint32), tw.view(np.uint32), T), want)
    assert np.array_equal(jdl.decode_status_bits(cw.view(np.uint32), tw.view(np.uint32), T), want)
    assert np.array_equal(
        tck.status_of(torch.from_numpy(too), torch.from_numpy(commit)).numpy(), want)
    assert set(np.unique(want)) == {int(R.CONFLICT), int(R.TOO_OLD), int(R.COMMITTED)}


_JLOOP = {}


def jloop(cfg):
    if cfg not in _JLOOP:
        _JLOOP[cfg] = jax.jit(lambda s, b, n: jck.resolve_server_loop(cfg, s, b, n))
    return _JLOOP[cfg]


@pytest.mark.parametrize("structure", STRUCTURES)
@pytest.mark.parametrize("gc_last", [False, True])
def test_server_loop_matches_jax(structure, gc_last):
    """Fill levels 1..Q of one slot in turn on one evolving table (rows past
    the fill hold other batches, which neither side may read): bitmaps,
    overflow, heat planes and table equal JAX's after every dispatch; keys
    cross as int32 bits, as in the loop program's inputs."""
    cfg = dataclasses.replace(KSMALL, heat_buckets=HEAT)
    if structure == "tiered":
        cfg = tiered(cfg, runs=2)
    tcfg = port_cfg(cfg)
    rng = random.Random(31 + gc_last)
    js, ts = jck.initial_state(cfg), tck.initial_state(tcfg)
    now = 100
    merges = 0
    for rnd in range(2):
        for n in range(1, Q + 1):
            chunks = []
            for c in range(Q):
                now += rng.randrange(3, 9) if c < n else 0
                gc = now - 40 if gc_last and c == n - 1 and now > 60 else 0
                chunks.append(synth_batch(rng, cfg, now, gc))
            stacked = {k: np.stack([c[k] for c in chunks]) for k in chunks[0]}
            js, jout = jloop(cfg)(js, {k: jnp.asarray(v) for k, v in stacked.items()},
                                  jnp.int32(n))
            inputs = {k: torch.from_numpy(np.ascontiguousarray(
                v.view(np.int32) if k in tck.KEY_FIELDS else v)) for k, v in stacked.items()}
            ts, tout = tck.resolve_server_loop(tcfg, ts, inputs, torch.tensor(n, dtype=torch.int32),
                                               bool(stacked["gc"][n - 1] > 0))
            assert bits_eq(tout["commit_bits"], jout["commit_bits"]), (rnd, n)
            assert bits_eq(tout["too_old_bits"], jout["too_old_bits"]), (rnd, n)
            assert bool(tout["overflow"]) == bool(jout["overflow"])
            assert tout["heat"].keys() == jout["heat"].keys()
            for k in jout["heat"]:
                assert eq(tout["heat"][k], jout["heat"][k]), (rnd, n, k)
            assert not tout["commit_bits"][n:].any() and not tout["heat"]["hist"][n:].any()
            for k in js:
                assert eq(ts[k], js[k]), (rnd, n, k)
            merges += int(tout.get("merged", torch.zeros(1)).sum())
            if stacked["gc"][n - 1] > 0:
                now -= int(stacked["gc"][n - 1])
    assert structure == "monolithic" or merges > 0


def test_server_loop_runs_only_the_filled_prefix():
    """run_while's host loop (the CPU form of the WHILE node) runs n - 1
    body iterations; a CPU loop reads no device value."""
    reads = tck.LOOP.host_reads
    calls = []
    i = torch.zeros((), dtype=torch.int64)
    tck.run_while(lambda: i < 3, lambda: (calls.append(int(i)), i.add_(1)))
    assert calls == [0, 1, 2] and tck.LOOP.host_reads == reads
    tck.run_while(lambda: i < 3, lambda: calls.append(-1))
    assert calls == [0, 1, 2]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def jax_loop(cfg, **kw):
    eng = jdl.DeviceLoopEngine(cfg, heat_buckets=HEAT, **kw)
    eng._programs = _JAX_PROGRAMS.setdefault((cfg, tuple(kw.get("ladder") or ())), {})
    return eng


def fills_seen(eng):
    """Wrap the engine's dispatch to record each unit's chunk count."""
    seen = []
    dispatch = eng._dispatch_unit

    def recording(bucket, per_chunks, packs=None, **kw):
        seen.append(len(per_chunks))
        return dispatch(bucket, per_chunks, packs, **kw)

    eng._dispatch_unit = recording
    return seen


@pytest.mark.parametrize("structure", STRUCTURES)
def test_loop_vs_jax_loop_step_and_oracle_boundaries_and_gc(structure):
    """tests/test_device_loop.py:117: every bucket boundary, gc=0 / gc>0
    cadences and general-router batches (empty and true range reads):
    verdicts equal JAX's loop engine, the port's step engine and the
    oracle; so do heat_snapshot() and history_stats_snapshot() at equal
    heat; one program per bucket, no blocking sync, fills 1..Q all used."""
    cfg = CFG if structure == "monolithic" else tiered(CFG)
    loop = tdl.DeviceLoopEngine(port_cfg(cfg), device="cpu", ladder=LADDER,
                                heat_buckets=HEAT).warmup()
    assert len(loop._programs) == len(loop.buckets) == 3 and loop.perf.captures == 0
    step = TorchConflictEngine(port_cfg(cfg), device="cpu", ladder=LADDER, scan_sizes=(),
                               heat_buckets=HEAT)
    jeng = jax_loop(cfg, ladder=LADDER)
    oracle = OracleConflictEngine()
    fills = fills_seen(loop)
    batches = list(boundary_gc_stream(11, extra_random=8))
    # and slots of 3 and 4 chunks: 3 and 4 top-bucket chunks, then 5
    rng, v = random.Random(12), batches[-1][1]
    for n in (3 * CFG.max_txns, 4 * CFG.max_txns + 5):
        v += 200
        batches.append((point_txns(rng, n, v), v, v - 1000))
    for txns, v, old in batches:
        got = ints(loop.resolve(txns, v, old))
        assert got == ints(oracle.resolve(txns, v, old))
        assert got == ints(step.resolve(txns, v, old))
        assert got == ints(jeng.resolve(txns, v, old))
    assert loop.loop_stats["blocking_syncs"] == 0
    assert set(fills) >= set(range(1, Q + 1)), fills
    assert loop.heat_snapshot() == jeng.heat_snapshot() == step.heat_snapshot()
    assert loop.history_stats_snapshot() == jeng.history_stats_snapshot()
    assert loop.perf.bucket_hits == dict(jeng.perf.bucket_hits)
    assert len(loop._programs) == 3
    if structure == "tiered":
        assert loop.perf.merges == step.perf.merges > 0


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_loop_through_pipeline_nonblocking_drain(depth):
    """tests/test_device_loop.py:149: pipelined loop dispatch equals the
    serial oracle; the ring drains through poll() alone, with no blocking
    sync."""
    rng = random.Random(40 + depth)
    stream, v = [], 0
    for _ in range(12):
        v += rng.randrange(50, 200)
        stream.append((point_txns(rng, rng.randrange(4, 30), v), v, max(0, v - 1500)))
    oracle = OracleConflictEngine()
    want = [ints(oracle.resolve(*s)) for s in stream]
    loop = tdl.DeviceLoopEngine(port_cfg(SMALL), device="cpu")
    pipe = ResolverPipeline(loop, depth=depth)
    handles = [pipe.submit(*s) for s in stream]
    while loop._ring:
        loop.poll()
    assert [ints(h.result()) for h in handles] == want
    assert loop.loop_stats["blocking_syncs"] == 0 and loop.loop_stats["forced_waits"] == 0
    assert loop.loop_stats["drained_nonblocking"] == loop.loop_stats["units"] > 0
    assert loop.ring_depth() == 0 and loop.slots_in_flight() == 0


def test_kill_drain_mid_queue_and_clear():
    """tests/test_device_loop.py:182: drain_loop() mid-stream empties the
    ring with verdicts kept; clear() drains, then resets the table; the
    engine keeps the oracle's verdicts after both, and so does JAX's loop
    engine on the same stream."""
    rng = random.Random(91)
    oracle = OracleConflictEngine()
    loop = tdl.DeviceLoopEngine(port_cfg(SMALL), device="cpu", heat_buckets=HEAT)
    jeng = jax_loop(SMALL)
    pipe = ResolverPipeline(loop, depth=3)
    v, handles, stream = 0, [], []
    for i in range(9):
        v += rng.randrange(50, 200)
        s = (point_txns(rng, rng.randrange(4, 30), v), v, max(0, v - 1500))
        stream.append(s)
        handles.append(pipe.submit(*s))
        if i == 4:
            loop.drain_loop()
            assert not loop._ring
    got = [ints(h.result()) for h in handles]
    assert got == [ints(oracle.resolve(*s)) for s in stream]
    assert got == [ints(jeng.resolve(*s)) for s in stream]
    pipe.drain()
    loop.clear(0)
    jeng.clear(0)
    oracle = OracleConflictEngine()
    assert not loop._ring
    v2 = 0
    for _ in range(3):
        v2 += 120
        txns = point_txns(rng, 12, v2)
        want = ints(oracle.resolve(txns, v2, 0))
        assert ints(loop.resolve(txns, v2, 0)) == want == ints(jeng.resolve(txns, v2, 0))
    assert loop.heat_snapshot() == jeng.heat_snapshot()


class _SlowEvent:
    """A ticket event that lands after `polls` queries, or at synchronize()."""

    def __init__(self, polls):
        self.polls = polls
        self.synced = False

    def query(self):
        self.polls -= 1
        return self.synced or self.polls < 0

    def synchronize(self):
        self.synced = True


def test_drain_accounting_kinds():
    """A result that lands while the host waits is a forced wait; one that
    outlasts the deadline is a blocking sync; a ready one drains without
    either; a refilled slot drains its previous ticket first."""
    loop = tdl.DeviceLoopEngine(port_cfg(SMALL), device="cpu", queue_slots=2, queue_depth=2)
    rng = random.Random(5)
    events = iter([_SlowEvent(3), _SlowEvent(10**9), _SlowEvent(1)])
    launch = tdl._LoopProgram.launch

    def slow(self, slot, n, gc_last, timing=None):
        launch(self, slot, n, gc_last, timing)
        return next(events)

    tdl._LoopProgram.launch = slow
    try:
        loop.drain_deadline_s = 0.5
        f1 = loop.columnar_dispatch(loop.columnar_pack(point_txns(rng, 5, 100), 100, 0))
        assert loop.ring_depth() == 1 and loop.slots_in_flight() == 1
        f1()
        assert loop.loop_stats["forced_waits"] == 1 and loop.loop_stats["blocking_syncs"] == 0
        loop.drain_deadline_s = 0.0
        f2 = loop.columnar_dispatch(loop.columnar_pack(point_txns(rng, 5, 200), 200, 0))
        f2()
        assert loop.loop_stats["forced_waits"] == 2 and loop.loop_stats["blocking_syncs"] == 1
        f3 = loop.columnar_dispatch(loop.columnar_pack(point_txns(rng, 5, 300), 300, 0))
        assert loop.ring_depth() == 1      # not ready at its dispatch's poll
        assert loop.poll() == 1 and loop.loop_stats["drained_nonblocking"] == 1
        f3()
    finally:
        tdl._LoopProgram.launch = launch
    snap = loop.loop_stats_snapshot()
    assert snap["units"] == 3 and snap["ring_depth"] == 0 and snap["slots_in_flight"] == 0
    assert loop._pool.queue_depth == 2 and len(loop._pool._slots[SMALL.max_txns]) == 2


def test_long_keys_split_step_drains_the_loop():
    """Long keys take the split-step path, which drains the ring first:
    verdicts equal the oracle's and the step engine's."""
    loop = tdl.DeviceLoopEngine(port_cfg(LONG), device="cpu", heat_buckets=HEAT)
    step = TorchConflictEngine(port_cfg(LONG), device="cpu", heat_buckets=HEAT)
    oracle = OracleConflictEngine()
    for txns, now, oldest in long_stream(2):
        want = ints(oracle.resolve(txns, now, oldest))
        assert ints(loop.resolve(txns, now, oldest)) == want == ints(step.resolve(txns, now, oldest))
    assert loop._tier_has_writes and loop.heat_snapshot() == step.heat_snapshot()


def test_tiered_run_snapshots_drain_and_match_the_step_engine():
    cfg = port_cfg(tiered(SMALL))
    loop = tdl.DeviceLoopEngine(cfg, device="cpu")
    step = TorchConflictEngine(cfg, device="cpu")
    rng = random.Random(12)
    v = 0
    for _ in range(6):
        v += 150
        txns = point_txns(rng, 20, v)
        assert ints(loop.resolve(txns, v, 0)) == ints(step.resolve(txns, v, 0))
    a, b = loop.history_run_snapshots(), step.history_run_snapshots()
    assert a[0]["nruns"] == b[0]["nruns"] > 0
    for (ka, va), (kb, vb) in zip(a[0]["runs"], b[0]["runs"]):
        assert np.array_equal(ka, kb) and np.array_equal(va, vb)


def test_make_engine_device_loop():
    assert the.ENGINE_MODES == ("torch", "device_loop")
    eng = the.make_engine("device_loop", port_cfg(SMALL), device="cpu", queue_slots=3)
    assert isinstance(eng, tdl.DeviceLoopEngine) and eng.queue_slots == 3
    assert eng.name == "device_loop" and eng.cfg.heat_buckets == 64
    assert isinstance(the.make_engine("torch", port_cfg(SMALL), device="cpu"), TorchConflictEngine)
    with pytest.raises(ValueError, match="unknown engine mode"):
        the.make_engine("mesh", port_cfg(SMALL), device="cpu")
    assert eng._split_run(9) == [3, 3, 3] and eng._split_run(4) == [3, 1]
