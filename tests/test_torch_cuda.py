"""The port's CUDA fixpoint kernel on the card, against its plain version,
and the engine's serving path there: captured (bucket, C) graphs against
the eager step (monolithic and tiered history: the tiered merge is a
conditional node; the heat planes too), no captures after warmup(), the
static table under load_state and clear(), and a dispatch with no host
sync; then the loop engine's server program (a WHILE node, the tiered
merge's IF node nested in its body) against the eager loop, its warmup
and its sync-free dispatch; then the telemetry: every unit timed with
CUDA events at sample rate 1.0 and spans on with no host sync, one
perf-ledger row per captured program, the loop's samples landing through
poll(), and a conflict-scheduled stream on the loop engine; the resolver
role, the supervisor, the simulated clusters (static and dynamic: card
resolvers recruited in every generation), a backup restored onto card
resolvers and a stack-tester stream, over card engines; the sharded
engines and the stacked entry; and the tools: a ladder drive, the
profile_kernel fixpoint variant and `cli status` over card resolvers.

Every test here needs an NVIDIA card and skips without one. The file
imports neither jax nor the JAX package, so it runs on a machine that has
only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(--noconftest: tests/conftest.py sets up jax for the rest of the suite.)
All quantities are integers: every comparison is exact.
"""
import ctypes
import dataclasses
import random

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch.core.types import CommitTransaction, KeyRange
from foundationdb_tpu_torch.ops import conflict_kernel as ck
from foundationdb_tpu_torch.ops import fixpoint_cuda as fc
from foundationdb_tpu_torch.ops import graph_if
from foundationdb_tpu_torch.ops import oracle as toracle
from foundationdb_tpu_torch.ops.device_loop import DeviceLoopEngine
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine

torch.set_num_threads(1)

CONFIGS = (
    ck.KernelConfig(key_words=2, capacity=512, max_txns=32, max_point_reads=128,
                    max_point_writes=128, max_reads=32, max_writes=32),
    ck.KernelConfig(key_words=4, capacity=4096, max_txns=256, max_point_reads=512,
                    max_point_writes=512, max_reads=64, max_writes=96),
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def synth_batch(rng, cfg, now_rel, pool=120):
    """Every row class filled, rows grouped by ascending txn, keys from a
    pool of `pool` keys."""
    T = cfg.max_txns
    ntx = rng.randrange(2, T + 1)
    rows = {k: [] for k in ("rpk", "rps", "rpt", "rb", "re", "rs", "rt",
                            "wpk", "wpt", "wb", "we", "wt")}

    def key():
        return (b"%03d" if pool <= 1000 else b"%07d") % rng.randrange(pool)

    for t in range(ntx):
        snap = now_rel - rng.randrange(1, 40)
        for _ in range(rng.randrange(0, 4)):
            if len(rows["rpk"]) < cfg.rp:
                rows["rpk"].append(key()); rows["rps"].append(snap); rows["rpt"].append(t)
        if rng.random() < 0.4 and len(rows["rb"]) < cfg.max_reads:
            a, b = sorted([key(), key()])
            rows["rb"].append(a); rows["re"].append(b + b"\x00")
            rows["rs"].append(snap); rows["rt"].append(t)
        for _ in range(rng.randrange(0, 3)):
            if len(rows["wpk"]) < cfg.wp:
                rows["wpk"].append(key()); rows["wpt"].append(t)
        if rng.random() < 0.3 and len(rows["wb"]) < cfg.max_writes:
            a, b = sorted([key(), key()])
            rows["wb"].append(a); rows["we"].append(b + b"\x00"); rows["wt"].append(t)
    t_ok = np.zeros((T,), bool)
    t_ok[:ntx] = True
    for t in rng.sample(range(ntx), k=min(3, ntx)):
        if rng.random() < 0.3:
            t_ok[t] = False
    return ck.build_batch_arrays(
        cfg, rows["rpk"], rows["rps"], rows["rpt"], rows["rb"], rows["re"], rows["rs"],
        rows["rt"], rows["wpk"], rows["wpt"], rows["wb"], rows["we"], rows["wt"],
        t_ok, np.zeros((T,), bool), now_rel, 0)


def chain_rows(build, cfg, n, kind="point"):
    """A deep chain of n txns, n-1 links: txn i reads the key txn i-1
    writes, so the fixpoint settles one link per round and takes
    links + 1 = n rounds (the last one finds no change). kind="point":
    point reads of point writes (the gid term). kind="range": range reads
    of range writes (even writers, ovw) and point writes (odd, ovrp).
    `build` is a build_batch_arrays (the port's or the JAX package's)."""
    T = cfg.max_txns
    assert n <= T
    key = [b"c%05d" % i for i in range(n)]
    rp_k, rp_t, r_b, r_e, r_t, wp_k, wp_t, w_b, w_e, w_t = ([] for _ in range(10))
    for i in range(n):
        if i and kind == "point":
            rp_k.append(key[i - 1]); rp_t.append(i)
        elif i:
            r_b.append(key[i - 1]); r_e.append(key[i - 1] + b"\x00"); r_t.append(i)
        if kind == "range" and i % 2 == 0:
            w_b.append(key[i]); w_e.append(key[i] + b"\x00"); w_t.append(i)
        else:
            wp_k.append(key[i]); wp_t.append(i)
    t_ok = np.zeros((T,), bool)
    t_ok[:n] = True
    return build(cfg, rp_k, [0] * len(rp_k), rp_t, r_b, r_e, [0] * len(r_b), r_t,
                 wp_k, wp_t, w_b, w_e, w_t, t_ok, np.zeros((T,), bool), 10, 0)


def dense_rows(build, cfg, n):
    """n txns that each range-read and range-write one wide range holding
    every point key, with the point groups spread over them: every read
    row has an edge to every writer of an earlier txn, so about half of
    all edge words are nonzero (the compacted list's worst case)."""
    T = cfg.max_txns
    assert n <= T
    lists = {g: [] for g in ("rp_k", "rp_t", "r_t", "wp_k", "wp_t", "w_t")}
    for i in range(n):
        for g, cap, keyed in (("rp", cfg.rp, True), ("r", cfg.max_reads, False),
                              ("wp", cfg.wp, True), ("w", cfg.max_writes, False)):
            for j in range(cap // n + (i < cap % n)):
                lists[g + "_t"].append(i)
                if keyed:
                    lists[g + "_k"].append(b"k%04d" % ((7 * i + j) % 997))
    nr, nw = len(lists["r_t"]), len(lists["w_t"])
    t_ok = np.zeros((T,), bool)
    t_ok[:n] = True
    return build(cfg, lists["rp_k"], [0] * len(lists["rp_k"]), lists["rp_t"],
                 [b"a"] * nr, [b"z"] * nr, [0] * nr, lists["r_t"],
                 lists["wp_k"], lists["wp_t"], [b"a"] * nw, [b"z"] * nw, lists["w_t"],
                 t_ok, np.zeros((T,), bool), 10, 0)


def fixpoint_rounds(cfg, t_ok, hist, edges, batch):
    """Rounds the plain version runs (the kernel's round count): one first
    round, then one per change, at most T+1."""
    base = t_ok & ~(hist > 0)
    c, rounds = base, 0
    while True:
        nxt = base & ~(ck._blocked_txns(cfg, edges, batch, c) > 0)
        rounds += 1
        if torch.equal(nxt, c) or rounds > cfg.max_txns:
            return rounds
        c = nxt


def kernel_vs_plain(card, cfg, arrays):
    """(kernel verdicts, plain verdicts, kernel rounds, plain rounds) for one
    packed batch on a fresh table: the plain side on the CPU."""
    batch = ck.batch_from_numpy(cfg, arrays, "cpu")
    hist, edges, _ = ck.local_phases(cfg, ck.initial_state(cfg), batch)
    want = fc.commit_fixpoint(cfg, batch["t_ok"], hist, edges, batch)
    dbatch = {k: (v.to(card) if isinstance(v, torch.Tensor) else v) for k, v in batch.items()}
    got = fc.commit_fixpoint(cfg, dbatch["t_ok"], hist.to(card),
                             {k: v.to(card) for k, v in edges.items()}, dbatch)
    torch.cuda.synchronize()
    return (got.cpu(), want, int(fc.FIXPOINT.last_rounds.item()),
            fixpoint_rounds(cfg, batch["t_ok"], hist, edges, batch))


#: deep chains and the dense batch need room: T=1024, 1024 rows per group
WIDE = ck.KernelConfig(key_words=2, capacity=8192, max_txns=1024, max_point_reads=1024,
                       max_point_writes=1024, max_reads=1024, max_writes=1024)
#: 4 rows per txn in every group, 128-word edge rows: the dense batch's
#: nonzero words pass the shared-memory capacity of the compacted lists
DENSE = ck.KernelConfig(key_words=2, capacity=16384, max_txns=1024, max_point_reads=4096,
                        max_point_writes=4096, max_reads=4096, max_writes=4096)
#: read rows (200 + 72) that fill 8 slices of 32 rows unevenly
RAGGED = ck.KernelConfig(key_words=2, capacity=2048, max_txns=96, max_point_reads=200,
                         max_point_writes=160, max_reads=72, max_writes=40)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["point", "range"])
def test_kernel_deep_chain(card, kind):
    n = WIDE.max_txns
    got, want, rounds, plain_rounds = kernel_vs_plain(card, WIDE, chain_rows(
        ck.build_batch_arrays, WIDE, n, kind))
    assert torch.equal(got, want)
    assert rounds == plain_rounds == (n - 1) + 1
    assert torch.equal(want[:n], torch.arange(n) % 2 == 0)


@pytest.mark.cuda
def test_kernel_large_gid_table(card):
    """A table of 2^21 rows: the round-tagged gid table has ~2M slots, of
    which a batch touches a few hundred."""
    cfg = ck.KernelConfig(key_words=2, capacity=2**21, max_txns=256, max_point_reads=512,
                          max_point_writes=512, max_reads=64, max_writes=64)
    got, want, rounds, plain_rounds = kernel_vs_plain(
        card, cfg, chain_rows(ck.build_batch_arrays, cfg, cfg.max_txns))
    assert torch.equal(got, want) and rounds == plain_rounds == cfg.max_txns
    got, want, rounds, plain_rounds = kernel_vs_plain(
        card, cfg, synth_batch(random.Random(9), cfg, 100))
    assert torch.equal(got, want) and rounds == plain_rounds


@pytest.mark.cuda
def test_kernel_dense_edges(card):
    """About half of all edge words nonzero: the compacted lists pass their
    shared-memory capacity and continue in the global spill."""
    plan = fc.launch_plan(DENSE)
    arrays = dense_rows(ck.build_batch_arrays, DENSE, DENSE.max_txns)
    edges = ck.local_phases(DENSE, ck.initial_state(DENSE), ck.batch_from_numpy(
        DENSE, arrays, "cpu"))[1]
    nonzero = int((edges["ovw"] != 0).sum() + (edges["ovrp"] != 0).sum())
    assert nonzero > plan["cluster"] * plan["entry_cap"]
    got, want, rounds, plain_rounds = kernel_vs_plain(card, DENSE, arrays)
    assert torch.equal(got, want) and rounds == plain_rounds


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [WIDE, RAGGED], ids=["wide", "ragged"])
def test_kernel_no_valid_rows(card, cfg):
    arrays = chain_rows(ck.build_batch_arrays, cfg, 0)
    arrays["t_ok"][:] = True
    got, want, rounds, _ = kernel_vs_plain(card, cfg, arrays)
    assert torch.equal(got, want) and bool(got.all()) and rounds == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CONFIGS + (RAGGED, ck.KernelConfig()),
                         ids=["small", "medium", "ragged", "default"])
def test_kernel_matches_plain(card, cfg):
    """Kernel on the card vs plain version on the CPU, same local_phases
    outputs, on an evolving table."""
    rng = random.Random(17)
    state = ck.initial_state(cfg)
    fc.FIXPOINT.reset_counts()
    n = 24 if cfg.max_txns <= 256 else 6
    for trial in range(n):
        batch = ck.batch_from_numpy(cfg, synth_batch(rng, cfg, 100 + trial), "cpu")
        hist, edges, _ = ck.local_phases(cfg, state, batch)
        want = fc.commit_fixpoint(cfg, batch["t_ok"], hist, edges, batch)
        dbatch = {k: (v.to(card) if isinstance(v, torch.Tensor) else v) for k, v in batch.items()}
        dedges = {k: v.to(card) for k, v in edges.items()}
        got = fc.commit_fixpoint(cfg, dbatch["t_ok"], hist.to(card), dedges, dbatch)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), trial
        assert 1 <= int(fc.FIXPOINT.last_rounds.item()) <= cfg.max_txns + 1
        state, _ = ck.resolve_step(cfg, state, batch, False)
    assert fc.FIXPOINT.launches == n and fc.FIXPOINT.plain_cuda_calls == 0


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(card):
    cfg = CONFIGS[0]
    batch = ck.batch_from_numpy(cfg, synth_batch(random.Random(3), cfg, 100), card)
    state = ck.initial_state(cfg, device=card)
    hist, edges, _ = ck.local_phases(cfg, state, batch)
    with pytest.raises(ValueError):
        fc.commit_fixpoint_kernel(cfg, batch["t_ok"], hist.to(torch.int64), edges, batch)
    with pytest.raises(ValueError):
        fc.commit_fixpoint_kernel(cfg, batch["t_ok"], hist, dict(edges, ovw=edges["ovw"].t()), batch)
    odd = ck.KernelConfig(key_words=2, capacity=512, max_txns=40, max_reads=32, max_writes=32)
    with pytest.raises(ValueError):
        fc.commit_fixpoint(odd, batch["t_ok"], hist, edges, batch)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CONFIGS + (ck.KernelConfig(),), ids=["small", "medium", "default"])
def test_card_schedules_the_cluster(card, cfg):
    """The card holds at least one cluster of the launch plan's shape, and
    the answer is asked once per card and shape."""
    plan = fc.launch_plan(cfg)
    n = ctypes.c_int(0)
    with torch.cuda.device(card):
        assert fc.FIXPOINT.lib().fdb_fixpoint_active_clusters(
            plan["cluster"], plan["smem_bytes"], ctypes.byref(n)) == 0
        assert n.value >= 1
        fc.FIXPOINT.check_schedulable(plan, torch.device("cuda", torch.cuda.current_device()))
    assert any(key[1:] == (plan["cluster"], plan["smem_bytes"])
               for key in fc.FIXPOINT._schedulable)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(card):
    """resolve() on the card (the default device) vs the CPU engine, long
    keys included, and the kernel carries the card's path."""
    cfg = CONFIGS[1]
    rng = random.Random(5)
    gpu, cpu = TorchConflictEngine(cfg), TorchConflictEngine(cfg, device="cpu")
    assert gpu.device.type == "cuda"
    fc.FIXPOINT.reset_counts()
    now = 100
    for b in range(12):
        now += rng.randrange(10, 60)
        txns = []
        for _ in range(rng.randrange(1, 300)):
            t = CommitTransaction(read_snapshot=max(0, now - rng.randrange(1, 80)))
            for _ in range(rng.randrange(0, 3)):
                k = b"k%04d" % rng.randrange(400)
                if b % 4 == 3 and rng.random() < 0.1:
                    k = b"L/" + k + b"x" * 40
                t.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            for _ in range(rng.randrange(0, 3)):
                k = b"k%04d" % rng.randrange(400)
                t.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            txns.append(t)
        oldest = max(0, now - 100)
        assert [int(v) for v in gpu.resolve(txns, now, oldest)] == \
            [int(v) for v in cpu.resolve(txns, now, oldest)], b
    assert fc.FIXPOINT.launches > 0 and fc.FIXPOINT.plain_cuda_calls == 0


# ---------------------------------------------------------------------------
# the serving path: captured (bucket, C) programs
# ---------------------------------------------------------------------------

#: T = 256 over a ladder (64, 128); scans of 2 and 4 chunks
LADDER_CFG = CONFIGS[1]
LADDER = (64, 128)
SCANS = (2, 4)


def point_batches(seed, sizes, pool=600, lag=400, old_frac=0.05):
    """(txns, now, new_oldest) of point-only transactions; the GC horizon
    trails by ~4 batches and `old_frac` of the snapshots lie behind it."""
    rng = random.Random(seed)
    now, out = 1000, []
    for n in sizes:
        now += lag
        txns = []
        for _ in range(n):
            back = rng.randrange(5 * lag, 6 * lag) if rng.random() < old_frac else rng.randrange(1, 2 * lag)
            t = CommitTransaction(read_snapshot=max(0, now - back))
            for _ in range(2):
                k = b"p%05d" % rng.randrange(pool)
                t.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            for _ in range(2):
                k = b"p%05d" % rng.randrange(pool)
                t.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
            txns.append(t)
        out.append((txns, now, max(0, now - 4 * lag)))
    return out


@pytest.mark.cuda
def test_if_node_runs_its_body_only_when_its_predicate_holds(card):
    """A captured graph with an IF node (graph_if): replays with the
    predicate false leave the body's output as it was; with it true the
    body (a sort, a scan, a copy into a buffer made before the node) runs;
    work after the node sees the body's result."""
    from foundationdb_tpu_torch.ops import graph_if

    x = torch.randint(0, 1000, (100_000,), device=card)
    out = torch.zeros_like(x)
    after = torch.zeros_like(x)
    pred = torch.zeros((), dtype=torch.bool, device=card)

    def body():
        out.copy_(torch.cummax(torch.sort(x, stable=True).values, 0).values + 1)

    body()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    nodes = graph_if.GRAPH_IF.nodes
    with graph_if.bodies([(torch.cuda.Stream(), torch.cuda.graph_pool_handle())]), \
            torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        with graph_if.if_node(pred):
            body()
        after.copy_(out * 2)
    assert graph_if.GRAPH_IF.nodes == nodes + 1
    want = torch.cummax(torch.sort(x, stable=True).values, 0).values + 1
    for flag in (False, True, False, True):
        out.zero_()
        pred.fill_(flag)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want if flag else torch.zeros_like(x)), flag
        assert torch.equal(after, 2 * out), flag
    with pytest.raises(RuntimeError, match="bodies"):
        with graph_if.if_node(pred):
            pass


#: the same shapes under the tiered structure, two run slots: merges come
#: every other write-bearing chunk, so they fall inside multi-chunk replays
TIERED_LADDER_CFG = dataclasses.replace(LADDER_CFG, history_structure="tiered", history_runs=2)
STRUCTURES = {"monolithic": LADDER_CFG, "tiered": TIERED_LADDER_CFG}


def replay_vs_eager(prog, eng, gc_last):
    """Replay `prog` on the engine's table and run resolve_step_scan eagerly
    on the card from a copy of the same table and inputs: statuses,
    overflow and merge flags and the whole table (run planes included) must
    be equal. Returns the eager outputs."""
    before = {k: v.clone() for k, v in eng.state.items()}
    want_state, want = ck.resolve_step_scan(prog.bucket, before, prog.batches(), gc_last)
    launches = fc.FIXPOINT.graph_launches
    prog.run(gc_last)
    torch.cuda.synchronize()
    where = (prog.bucket.max_txns, prog.C, gc_last)
    assert fc.FIXPOINT.graph_launches - launches == prog.C
    assert torch.equal(prog.status, want["status"]), where
    assert torch.equal(prog.overflow, want["overflow"]), where
    if prog.merged is not None:
        assert torch.equal(prog.merged, want["merged"]), where
    assert prog.heat.keys() == want.get("heat", {}).keys()
    for k in prog.heat:
        assert torch.equal(prog.heat[k], want["heat"][k]), (where, k)
    for k in eng.state:
        assert torch.equal(eng.state[k], want_state[k]), (where, k)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_graph_replay_equals_eager_step(card, structure):
    """Every (bucket, C) program, both GC variants: a replay gives the
    statuses, overflow flags and table of resolve_step_scan run eagerly on
    the card from the same table and inputs. Tiered: some chunks are read
    only, and merges fall inside replays, past their first chunk."""
    eng = TorchConflictEngine(STRUCTURES[structure], ladder=LADDER, scan_sizes=SCANS).warmup()
    rng = random.Random(21)
    now, mid_scan_merges, read_only = 100, 0, 0
    for (t, C), prog in sorted(eng._programs.items()):
        for r, gc_last in enumerate((False, True, False)):
            now += 50
            for c in range(C):
                arrays = synth_batch(rng, prog.bucket, now)
                if (r + c) % 3 == 2:
                    arrays["wp_valid"][:] = False
                    arrays["w_valid"][:] = False
                    read_only += 1
                arrays["gc"] = np.asarray(now - 120 if gc_last and c == C - 1 else 0, np.int32)
                prog.load(c, arrays, None)
            want = replay_vs_eager(prog, eng, gc_last)
            if "merged" in want:
                mid_scan_merges += int(want["merged"][1:].any())
            if gc_last:
                now -= 120          # versions rebase onto the horizon
    assert eng.perf.captures == 2 * len(eng._programs)
    assert read_only > 0
    assert (mid_scan_merges > 0) == (structure == "tiered")


@pytest.mark.cuda
def test_tiered_replay_through_an_overflowing_merge(card):
    """A tiered 2-chunk program on a 512-row table fed point writes of
    distinct keys (no range clears, which would shrink the table) until a
    merge overflows: replay and eager step agree on the flag and on the
    truncated table."""
    cfg = dataclasses.replace(CONFIGS[0], history_structure="tiered", history_runs=2)
    eng = TorchConflictEngine(cfg, scan_sizes=(2,)).warmup()
    prog = eng._programs[(cfg.max_txns, 2)]
    rng = random.Random(13)
    now = 100
    for _ in range(40):
        now += 50
        for c in range(2):
            arrays = synth_batch(rng, cfg, now, pool=10**6)
            arrays["w_valid"][:] = False
            prog.load(c, arrays, None)
        want = replay_vs_eager(prog, eng, False)
        if bool(want["overflow"].any()):
            assert bool(want["merged"][want["overflow"]].all())
            return
    pytest.fail("no merge overflowed the table")


@pytest.mark.cuda
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_no_captures_after_warmup(card, structure):
    """Steady traffic over every bucket and scan size, range batches
    included, captures nothing after warmup(); verdicts equal the oracle's.
    Tiered: merges happen, all inside replays (no host read of the merge
    predicate)."""
    eng = TorchConflictEngine(STRUCTURES[structure], ladder=LADDER, scan_sizes=SCANS).warmup()
    captured = eng.perf.captures
    assert captured == 2 * 3 * 3
    ora = toracle.OracleConflictEngine()
    batches = point_batches(3, [20, 40, 70, 250, 600, 1700, 30, 900])
    batches[5][0][7].read_conflict_ranges.append(KeyRange(b"p00010", b"p00090"))
    host_reads = ck.MERGE.host_reads
    for b, (txns, now, oldest) in enumerate(batches):
        assert [int(v) for v in eng.resolve(txns, now, oldest)] == \
            [int(v) for v in ora.resolve(txns, now, oldest)], b
    assert eng.perf.captures == captured
    assert all(v > 0 for v in eng.perf.bucket_hits.values())
    assert all(eng.perf.scan_dispatches.get(c, 0) > 0 for c in (1, 2, 4))
    assert ck.MERGE.host_reads == host_reads
    assert (eng.perf.merges > 0) == (structure == "tiered")


@pytest.mark.cuda
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_load_state_and_clear_then_graph_resolves(card, structure):
    """The table's static buffers (run planes included) take load_state
    and clear(): graph resolves after either give the oracle's (and the
    CPU engine's) verdicts."""
    cfg = STRUCTURES[structure]
    batches = point_batches(8, [120, 300, 700, 60, 400, 900, 250, 500])
    cpu = TorchConflictEngine(cfg, device="cpu", ladder=LADDER, scan_sizes=SCANS)
    ora = toracle.OracleConflictEngine()
    for txns, now, oldest in batches[:4]:
        cpu.resolve(txns, now, oldest)
        ora.resolve(txns, now, oldest)
    gpu = TorchConflictEngine(cfg, ladder=LADDER, scan_sizes=SCANS).warmup()
    gpu.resolve(*batches[-1])            # a table the load must replace
    gpu.load_state(ck.state_to_numpy(cpu.state), cpu.base, cpu.oldest_version, cpu.tier_map)
    for b, (txns, now, oldest) in enumerate(batches[4:]):
        want = [int(v) for v in ora.resolve(txns, now, oldest)]
        assert [int(v) for v in gpu.resolve(txns, now, oldest)] == want, b
        assert [int(v) for v in cpu.resolve(txns, now, oldest)] == want, b
    later = point_batches(9, [300, 800, 50])
    shift = batches[-1][1] + 1000
    gpu.clear(shift)
    ora.clear(shift)
    for b, (txns, now, oldest) in enumerate(later):
        for t in txns:
            t.read_snapshot += shift
        want = [int(v) for v in ora.resolve(txns, now + shift, oldest + shift)]
        assert [int(v) for v in gpu.resolve(txns, now + shift, oldest + shift)] == want, b


@pytest.mark.cuda
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_columnar_dispatch_makes_no_host_sync(card, structure):
    """Pack, copy in, replay, copy out: no synchronizing call between the
    host and the card until force(), the tiered merge branch included."""
    eng = TorchConflictEngine(STRUCTURES[structure], ladder=LADDER, scan_sizes=SCANS).warmup()
    ora = toracle.OracleConflictEngine()
    for txns, now, oldest in point_batches(4, [70, 900, 200, 1500]):
        plan = eng.columnar_pack(txns, now, oldest)
        assert plan is not None
        torch.cuda.set_sync_debug_mode("error")
        try:
            force = eng.columnar_dispatch(plan)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert [int(v) for v in force()] == [int(v) for v in ora.resolve(txns, now, oldest)]


@pytest.mark.cuda
def test_packer_build_raises_without_a_compiler(card, tmp_path, monkeypatch):
    import shutil

    from foundationdb_tpu_torch.native import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler found"):
        build.load("fastpack")


# ---------------------------------------------------------------------------
# the loop engine: a WHILE node over the filled prefix of a queue slot
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_while_node_runs_its_body_while_its_condition_holds(card):
    """A captured graph with a WHILE node over a device counter whose bound
    the replay reads from a device scalar: the body (an index_select, a sort
    and an index_copy_ into row i of a buffer made before the node) runs
    exactly n times for n = 0..5, with an IF node nested in the body that
    runs on odd i only; work after the node sees the body's rows."""
    Q = 5
    x = torch.randint(0, 1000, (Q, 4096), device=card)
    out = torch.zeros_like(x)
    odd = torch.zeros(Q, dtype=torch.int64, device=card)
    after = torch.zeros((), dtype=torch.int64, device=card)
    n = torch.zeros((), dtype=torch.int64, device=card)
    levels = [(torch.cuda.Stream(), torch.cuda.graph_pool_handle()) for _ in range(2)]

    def program():
        out.zero_()
        odd.zero_()
        i = torch.zeros((), dtype=torch.int64, device=card)

        def body():
            sel = i.reshape(1)
            row = torch.sort(x.index_select(0, sel)[0]).values + i
            out.index_copy_(0, sel, row[None])
            ck.run_if((i % 2) == 1, lambda: odd.index_fill_(0, sel, 1))
            i.add_(1)

        ck.run_while(lambda: i < n, body)
        after.copy_(out.sum())

    program()          # eager on the card: host reads of both conditions
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    whiles, ifs = graph_if.GRAPH_IF.while_nodes, graph_if.GRAPH_IF.nodes
    with graph_if.bodies(levels), \
            torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        program()
    assert graph_if.GRAPH_IF.while_nodes == whiles + 1 and graph_if.GRAPH_IF.nodes == ifs + 1
    srt = torch.sort(x, dim=1).values + torch.arange(Q, device=card)[:, None]
    for k in (3, 0, 5, 1, 4):
        n.fill_(k)
        graph.replay()
        torch.cuda.synchronize()
        want = torch.where(torch.arange(Q, device=card)[:, None] < k, srt, 0)
        assert torch.equal(out, want), k
        assert odd.tolist() == [int(j < k and j % 2 == 1) for j in range(Q)], k
        assert int(after) == int(want.sum()), k


#: the loop engine's shapes: T = 256 over a ladder (64, 128), 3-chunk slots
LOOP_Q = 3


def loop_replay_vs_eager(prog, eng, n, gc_last):
    """Replay the loop program at fill n and run resolve_server_loop eagerly
    on the card from a copy of the same table and inputs: bitmaps,
    overflow, merge flags, heat planes and the whole table must be equal.
    Returns the eager outputs."""
    before = {k: v.clone() for k, v in eng.state.items()}
    prog.n_chunks.fill_(n)
    want_state, want = ck.resolve_server_loop(prog.bucket, before, prog.inputs, prog.n_chunks,
                                              gc_last)
    launches = fc.FIXPOINT.graph_launches
    prog.graphs[gc_last].replay()
    fc.FIXPOINT.graph_launches += n
    torch.cuda.synchronize()
    where = (prog.bucket.max_txns, n, gc_last)
    assert fc.FIXPOINT.graph_launches - launches == n
    for k in ("commit_bits", "too_old_bits", "overflow", "merged"):
        if k in want:
            assert torch.equal(prog.out[k], want[k]), (where, k)
    for k in want.get("heat", {}):
        assert torch.equal(prog.out["heat"][k], want["heat"][k]), (where, k)
    for k in eng.state:
        assert torch.equal(eng.state[k], want_state[k]), (where, k)
    return want


def load_loop_inputs(prog, rows):
    for name, t in prog.inputs.items():
        for c, arrays in enumerate(rows):
            a = np.asarray(arrays[name])
            if name in ck.KEY_FIELDS:
                a = np.ascontiguousarray(a, np.uint32).view(np.int32)
            t[c].copy_(torch.from_numpy(np.ascontiguousarray(a).reshape(t[c].shape)))


@pytest.mark.cuda
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_loop_replay_equals_eager_loop(card, structure):
    """Every bucket's loop program, every fill level 1..Q, both GC
    variants: a replay equals the eager loop on the card (heat on).
    Tiered: merges fall inside the WHILE body (past chunk 0)."""
    eng = DeviceLoopEngine(STRUCTURES[structure], ladder=LADDER, queue_slots=LOOP_Q).warmup()
    assert eng.cfg.heat_buckets == 64
    rng = random.Random(31)
    now, body_merges = 100, 0
    for key, prog in sorted(eng._programs.items()):
        for n in range(1, LOOP_Q + 1):
            for gc_last in (False, True):
                now += 50
                rows = []
                for c in range(LOOP_Q):
                    arrays = synth_batch(rng, prog.bucket, now)
                    arrays["gc"] = np.asarray(now - 120 if gc_last and c == n - 1 else 0,
                                              np.int32)
                    rows.append(arrays)
                load_loop_inputs(prog, rows)
                want = loop_replay_vs_eager(prog, eng, n, gc_last)
                if "merged" in want:
                    body_merges += int(want["merged"][:n - 1].any())
                if gc_last:
                    now -= 120
    assert eng.perf.captures == 2 * len(eng._programs) == 6
    assert (body_merges > 0) == (structure == "tiered")


@pytest.mark.cuda
def test_loop_replay_through_an_overflowing_merge_in_the_body(card):
    """Tiered loop program on a 512-row table fed distinct point writes
    until a merge inside the WHILE body overflows: replay and eager loop
    agree on the flag and the truncated table."""
    cfg = dataclasses.replace(CONFIGS[0], history_structure="tiered", history_runs=2)
    eng = DeviceLoopEngine(cfg, queue_slots=LOOP_Q).warmup()
    prog = eng._programs[(cfg.max_txns, -1)]
    rng = random.Random(13)
    now = 100
    for _ in range(40):
        now += 50
        rows = []
        for c in range(LOOP_Q):
            arrays = synth_batch(rng, cfg, now, pool=10**6)
            arrays["w_valid"][:] = False
            rows.append(arrays)
        load_loop_inputs(prog, rows)
        want = loop_replay_vs_eager(prog, eng, LOOP_Q, False)
        if bool(want["overflow"]) and bool(want["merged"][:LOOP_Q - 1].any()):
            return
    pytest.fail("no merge inside the WHILE body overflowed the table")


@pytest.mark.cuda
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_loop_no_captures_after_warmup(card, structure):
    """warmup() captures 2 graphs per bucket, each with one WHILE node (and
    under the tiered structure 2 IF nodes, one nested in the WHILE body);
    steady traffic over every bucket and fill level, range batches
    included, captures nothing more and reads no loop or merge condition
    on the host; verdicts equal the oracle's."""
    whiles, ifs = graph_if.GRAPH_IF.while_nodes, graph_if.GRAPH_IF.nodes
    eng = DeviceLoopEngine(STRUCTURES[structure], ladder=LADDER, queue_slots=LOOP_Q).warmup()
    assert eng.perf.captures == 6 and graph_if.GRAPH_IF.while_nodes - whiles == 6
    assert graph_if.GRAPH_IF.nodes - ifs == (12 if structure == "tiered" else 0)
    ora = toracle.OracleConflictEngine()
    batches = point_batches(3, [20, 40, 70, 250, 600, 1700, 30, 900])
    batches[5][0][7].read_conflict_ranges.append(KeyRange(b"p00010", b"p00090"))
    reads = (ck.MERGE.host_reads, ck.LOOP.host_reads)
    for b, (txns, now, oldest) in enumerate(batches):
        assert [int(v) for v in eng.resolve(txns, now, oldest)] == \
            [int(v) for v in ora.resolve(txns, now, oldest)], b
    assert eng.perf.captures == 6
    assert (ck.MERGE.host_reads, ck.LOOP.host_reads) == reads
    assert all(v > 0 for v in eng.perf.bucket_hits.values())
    assert (eng.perf.merges > 0) == (structure == "tiered")
    assert eng.loop_stats["blocking_syncs"] == 0
    snap = eng.heat_snapshot()
    assert snap["batches"] > 0 and snap["hot_ranges"]


@pytest.mark.cuda
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_loop_dispatch_makes_no_host_sync(card, structure):
    """Slot fill, copies in, replay, copies of the results to the slot's
    pinned buffers, the event: no synchronizing call until force(); the
    heat snapshot equals the step engine's on the CPU."""
    eng = DeviceLoopEngine(STRUCTURES[structure], ladder=LADDER, queue_slots=LOOP_Q).warmup()
    cpu = TorchConflictEngine(STRUCTURES[structure], device="cpu", ladder=LADDER)
    ora = toracle.OracleConflictEngine()
    for txns, now, oldest in point_batches(4, [70, 900, 200, 1500]):
        plan = eng.columnar_pack(txns, now, oldest)
        assert plan is not None
        torch.cuda.set_sync_debug_mode("error")
        try:
            force = eng.columnar_dispatch(plan)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = [int(v) for v in ora.resolve(txns, now, oldest)]
        assert [int(v) for v in force()] == want
        assert [int(v) for v in cpu.resolve(txns, now, oldest)] == want
    assert eng.loop_stats["blocking_syncs"] == 0
    assert eng.heat_snapshot() == cpu.heat_snapshot()
    assert eng.history_stats_snapshot() == cpu.history_stats_snapshot()


# ---------------------------------------------------------------------------
# telemetry on the card: sampled device timing, the perf ledger, spans, the
# conflict scheduler
# ---------------------------------------------------------------------------

def engine_of(family, structure, **kw):
    if family == "torch":
        return TorchConflictEngine(STRUCTURES[structure], ladder=LADDER, scan_sizes=SCANS, **kw)
    return DeviceLoopEngine(STRUCTURES[structure], ladder=LADDER, queue_slots=LOOP_Q, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["torch", "device_loop"])
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_sampled_timing_and_spans_make_no_host_sync(card, family, structure):
    """At sample rate 1.0 with spans on, every dispatch unit is timed with
    CUDA events and the dispatch still makes no synchronizing call; the
    verdicts equal the oracle's and an engine's with both off; no blocking
    sync on the loop."""
    from foundationdb_tpu_torch.core import telemetry
    from foundationdb_tpu_torch.core.trace import g_spans

    telemetry.reset()
    eng = engine_of(family, structure, device_time_sample_rate=1.0).warmup()
    quiet = engine_of(family, structure, device_time_sample_rate=0.0).warmup()
    ora = toracle.OracleConflictEngine()
    g_spans.clear()
    g_spans.enabled = True
    try:
        for txns, now, oldest in point_batches(5, [70, 900, 200, 1500, 40]):
            plan = eng.columnar_pack(txns, now, oldest)
            torch.cuda.set_sync_debug_mode("error")
            try:
                force = eng.columnar_dispatch(plan)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            got = [int(v) for v in force()]
            g_spans.enabled = False
            assert got == [int(v) for v in quiet.resolve(txns, now, oldest)]
            g_spans.enabled = True
            assert got == [int(v) for v in ora.resolve(txns, now, oldest)]
    finally:
        g_spans.enabled = False
    units = sum(eng.perf.scan_dispatches.values())
    assert sum(d["samples"] for d in eng.perf.device_time.values()) == units > 0
    assert all(d["ms_total"] > 0 for d in eng.perf.device_time.values())
    names = {s["Name"] for s in g_spans.spans}
    assert {"engine.host_pack", "engine.device_time"} <= names
    assert len(g_spans.by_name("engine.device_time")) == units
    assert all(s["device_ms"] > 0 for s in g_spans.by_name("engine.device_time"))
    g_spans.clear()
    if family == "device_loop":
        assert eng.loop_stats["blocking_syncs"] == 0
        assert "engine.result_drain" in names and "engine.queue_enqueue" in names
    telemetry.hub().sync()
    assert "fdbtpu_engine" in telemetry.hub().prometheus_text()


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["torch", "device_loop"])
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_ledger_row_per_captured_program(card, family, structure):
    """warmup() files one perf-ledger row per program (two captured graphs
    each), kind "warmup", with its capture time and a peak device-memory
    reading; nothing is filed in steady state."""
    eng = engine_of(family, structure).warmup()
    rows = eng.perf_ledger.rows()
    assert len(rows) == len(eng._programs) == eng.perf.compiles
    assert eng.perf.captures == 2 * len(rows)
    assert all(r["kind"] == "warmup" and r["duration_ms"] > 0 and r["peak_bytes"] > 0
               and r["flops"] is None for r in rows)
    assert eng.perf_ledger.snapshot()["peak_bytes"] == max(r["peak_bytes"] for r in rows)
    for txns, now, oldest in point_batches(6, [70, 900, 200]):
        eng.resolve(txns, now, oldest)
    assert len(eng.perf_ledger.rows()) == len(rows) and eng.perf.warmed


@pytest.mark.cuda
def test_loop_samples_land_through_poll(card):
    """A sampled loop unit's time is read where poll() finishes its ticket
    (Event.query() true), before anything forces the batch."""
    import time

    eng = DeviceLoopEngine(LADDER_CFG, ladder=LADDER, queue_slots=LOOP_Q,
                           device_time_sample_rate=1.0).warmup()
    txns, now, oldest = point_batches(7, [900])[0]
    force = eng.columnar_dispatch(eng.columnar_pack(txns, now, oldest))
    units = eng.loop_stats["units"]
    deadline = time.monotonic() + 30
    while eng.ring_depth() and time.monotonic() < deadline:
        eng.poll()
        time.sleep(1e-3)
    assert eng.ring_depth() == 0
    assert sum(d["samples"] for d in eng.perf.device_time.values()) == units > 0
    assert eng.loop_stats["forced_waits"] == eng.loop_stats["blocking_syncs"] == 0
    assert [int(v) for v in force()] == [
        int(v) for v in toracle.OracleConflictEngine().resolve(txns, now, oldest)]


@pytest.mark.cuda
def test_scheduled_stream_on_the_loop_engine(card):
    """A contended stream scheduled by the ConflictScheduler (pre-aborts,
    lanes) through the loop engine on the card: verdicts equal the oracle's
    batch by batch, no blocking sync."""
    from foundationdb_tpu_torch.core.rng import DeterministicRandom
    from foundationdb_tpu_torch.pipeline.scheduler import ConflictScheduler, SchedConfig

    cfg = ck.KernelConfig(key_words=2, capacity=4096, max_reads=128, max_writes=128,
                          max_txns=32)
    eng = DeviceLoopEngine(cfg).warmup()
    ora = toracle.OracleConflictEngine()
    sched = ConflictScheduler(SchedConfig(enabled=True, probe_interval=8))
    rng = DeterministicRandom(11)
    hot = [b"h%02d" % i for i in range(3)]

    def txn(snap, k, write=True):
        t = CommitTransaction(read_snapshot=snap)
        t.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
        if write:
            t.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
        return t

    pending, version = [], 1000
    for _ in range(25):
        version += 8
        for _ in range(12):
            snap = version - rng.random_int(0, 30)
            if rng.random01() < 0.7:
                pending.append(txn(snap, hot[rng.random_int(0, 3)]))
            else:
                pending.append(txn(snap, b"cold%04d" % rng.random_int(0, 512),
                                   rng.random01() < 0.5))
        plan = sched.select(pending, 16)
        # a pre-aborted txn retries at a fresh snapshot
        pending = plan.remaining + [txn(version, t.read_conflict_ranges[0].begin,
                                        bool(t.write_conflict_ranges))
                                    for t, _ in plan.preaborts]
        if plan.dispatch:
            oldest = max(0, version - 400)
            want = [int(v) for v in ora.resolve(plan.dispatch, version, oldest)]
            assert [int(v) for v in eng.resolve(plan.dispatch, version, oldest)] == want
            sched.observe_batch(plan.dispatch, want, version)
    eng.drain_loop()
    assert eng.loop_stats["blocking_syncs"] == 0
    assert sched.counters["preaborts"] > 0 and sched.counters["laned"] > 0


ROLE_CFG = ck.KernelConfig(key_words=4, capacity=16384, max_txns=256, max_reads=16,
                           max_writes=16, max_point_reads=512, max_point_writes=512)


def role_on_card(tmp_path, engine, depth, **pipeline_kw):
    """chip_smoke's drive_role at a small size: the proxy sends
    each batch over the simulated network to the role over `engine` on the
    card, every 4th twice; the role's journal is read back and replayed
    through the oracle, and every reply must equal the replay."""
    import numpy as np

    import chip_smoke as cs
    from foundationdb_tpu_torch import pipeline as pl

    batches = cs.columnar_traffic(np.random.default_rng(7), [20, 60, 300, 120, 700], {3: 90},
                                  step=cs.role_version_step())
    pipeline = None if depth is None else pl.PipelineConfig(
        depth=depth, pack_ms_per_txn=0.001,
        device_ms_by_bucket={32: 1.0, 64: 1.5, 128: 2.0, 256: 3.0}, **pipeline_kw)
    run = cs.drive_role(fc, engine, batches, tmp_path / "journal", "card role",
                        pipeline=pipeline)
    mismatches, _, _ = cs.replay_and_check(run)
    return run, mismatches


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [None, 2], ids=["serial", "depth2"])
def test_resolver_role_on_the_card_matches_the_oracle_replay(card, tmp_path, depth):
    """The resolver role in the port's simulator over TorchConflictEngine on
    the card, serially and pipelined at depth 2: 0 replies off the oracle
    replay of its journal, the fixpoint kernel launched, every dispatch
    free of host syncs (sync debug "error"), nothing captured after
    warmup()."""
    eng = TorchConflictEngine(ROLE_CFG, ladder=(32, 64, 128), scan_sizes=(2, 4),
                              device_time_sample_rate=0.0).warmup()
    captures = eng.perf.captures
    run, mismatches = role_on_card(tmp_path, eng, depth)
    assert mismatches == 0 and run["launches"] > 0 and run["dispatches"] >= 6
    assert eng.perf.captures == captures


@pytest.mark.cuda
def test_loop_resolver_role_on_the_card_makes_no_blocking_sync(card, tmp_path):
    """The loop engine behind the service's device_loop mode at depth 2: the
    oracle replay's verdicts, no blocking sync."""
    eng = DeviceLoopEngine(ROLE_CFG, ladder=(32, 64, 128), device_time_sample_rate=0.0).warmup()
    run, mismatches = role_on_card(tmp_path, eng, 2, dispatch_mode="device_loop",
                                   queue_enqueue_ms=0.2, result_drain_ms=0.1)
    assert mismatches == 0 and run["launches"] > 0
    assert eng.loop_stats["blocking_syncs"] == 0


@pytest.mark.cuda
def test_fault_free_supervised_role_on_the_card(card, tmp_path):
    """The role over ResilientEngine(FaultInjectingEngine(card engine)) with
    no faults, buggify off and probe_rate 1.0 (chip_smoke's supervised
    run (a) at a small size): every reply equals the oracle replay of its
    journal, every batch is probed and agrees, no dispatch fault, no
    oracle batch, no host sync in a dispatch, nothing captured."""
    import numpy as np

    import chip_smoke as cs
    from foundationdb_tpu_torch import pipeline as pl

    eng = TorchConflictEngine(ROLE_CFG, ladder=(32, 64, 128), scan_sizes=(2, 4),
                              device_time_sample_rate=0.0).warmup()
    captures = eng.perf.captures
    batches = cs.columnar_traffic(np.random.default_rng(9), [20, 60, 200, 120, 250, 90], {},
                                  step=cs.role_version_step())
    log = {}
    run = cs.drive_role(
        fc, eng, batches, tmp_path / "journal", "supervised card role",
        pipeline=pl.PipelineConfig(depth=2, pack_ms_per_txn=0.001,
                                   device_ms_by_bucket={32: 1.0, 64: 1.5, 128: 2.0, 256: 3.0}),
        supervise=lambda e: cs.supervised_stack(
            e, dict(exception=0, hang=0, slow=0, outage=0, flip=0), 1.0, log),
        buggify_on=False)
    mismatches, _, _ = cs.replay_and_check(run)
    st = run["stack"].health_stats()
    assert mismatches == 0 and run["launches"] > 0
    assert st["state"] == "healthy" and st["dispatch_faults"] == 0
    assert st["oracle_batches"] == 0 and st["probe_mismatches"] == 0
    assert st["probes"] == st["batches"] == len(batches)
    assert sum(log["faults"].values()) == 0 and eng.perf.captures == captures


@pytest.mark.cuda
def test_run_slice_on_the_card_equals_the_cpu_engine(card):
    """run_slice reads a tiered card engine's run planes back (a copy to
    the host, outside any dispatch): its entries equal a CPU tiered
    engine's on the same stream, whole and since a watermark."""
    from foundationdb_tpu_torch.fault import handoff

    cfg = ck.KernelConfig(key_words=2, capacity=1024, max_reads=64, max_writes=64,
                          max_txns=32, history_runs=8)
    engines = [TorchConflictEngine(cfg, device=d, history_structure="tiered")
               for d in ("cuda", "cpu")]
    rng = random.Random(71)
    out = [[], []]
    v = 0
    for b in range(6):
        v += 50
        txns = []
        for _ in range(rng.randrange(4, 12)):
            k, w = b"k/%03d" % rng.randrange(48), b"k/%03d" % rng.randrange(48)
            txns.append(CommitTransaction(read_snapshot=max(0, v - rng.randrange(1, 80)),
                                          read_conflict_ranges=[KeyRange(k, k + b"\x00")],
                                          write_conflict_ranges=[KeyRange(w, w + b"\x00")]))
        verdicts = [[int(x) for x in e.resolve(txns, v, 0)] for e in engines]
        assert verdicts[0] == verdicts[1]
        if b == 2:
            marks = [handoff.run_watermarks(e) for e in engines]
    for i, e in enumerate(engines):
        out[i].append(handoff.run_slice(e, b"k/010", b"k/030"))
        out[i].append(handoff.run_slice(e, b"", None, since_runs=marks[i][0],
                                        since_epoch=marks[i][1]))
    assert out[0] == out[1]
    assert out[0][0]["entries"] and out[0][1]["entries"] and not out[0][1]["resync"]


@pytest.mark.cuda
def test_recover_into_a_card_engine(card, tmp_path):
    """A supervised oracle serves with a journal and snapshots; recover()
    rebuilds a card engine from the directory: complete, 0 mismatches,
    and it continues the live engine's verdict stream."""
    from foundationdb_tpu_torch.core import blackbox, buggify
    from foundationdb_tpu_torch.fault import (FaultInjectingEngine, FaultRates, ResilienceConfig,
                                              ResilientEngine, recovery)
    from foundationdb_tpu_torch.sim.loop import set_scheduler
    from foundationdb_tpu_torch.sim.simulator import Simulator

    rng = random.Random(51)

    def batches(n, v):
        out = []
        for _ in range(n):
            v += rng.randrange(40, 120)
            txns = []
            for _ in range(rng.randrange(2, 6)):
                k = b"r/%03d" % rng.randrange(64)
                txns.append(CommitTransaction(read_snapshot=max(0, v - rng.randrange(1, 400)),
                                              read_conflict_ranges=[KeyRange(k, k + b"\x00")],
                                              write_conflict_ranges=[KeyRange(k, k + b"\x00")]))
            out.append((txns, v, max(0, v - 2000)))
        return out

    sim = Simulator(47)
    buggify.disable()
    blackbox.install(blackbox.BlackboxJournal(str(tmp_path)))
    try:
        live = ResilientEngine(
            FaultInjectingEngine(toracle.OracleConflictEngine(),
                                 rates=FaultRates(exception=0, hang=0, slow=0, flip=0, outage=0)),
            ResilienceConfig(dispatch_timeout=0.5, retry_budget=2, retry_backoff=0.02,
                             probe_rate=0.0, probation_batches=2, failover_min_batches=2))
        mgr = recovery.SnapshotManager(str(tmp_path), interval=400)
        stream = batches(30, 0)
        probes = batches(8, stream[-1][1])
        engine = TorchConflictEngine(ck.KernelConfig(key_words=2, capacity=1024, max_reads=64,
                                                     max_writes=64, max_txns=32), ladder=(32,))

        async def go():
            for txns, v, old in stream:
                got = [int(x) for x in await live.resolve(txns, v, old)]
                blackbox.record_batch(txns, v, old, got, engine="oracle")
                mgr.note_batch(live, v)
            res = await recovery.recover(engine, str(tmp_path))
            pairs = [([int(x) for x in await live.resolve(t, v, o)],
                      [int(x) for x in engine.resolve(t, v, o)]) for t, v, o in probes]
            return res, pairs

        res, pairs = sim.sched.run_until(sim.sched.spawn(go()), until=100000)
    finally:
        set_scheduler(None)
        blackbox.uninstall()
    assert mgr.stats["written"] >= 1
    assert res.error is None and res.mode == "complete" and res.coverage_ok
    assert res.verdict_mismatches == 0 and res.replayed_batches > 0
    assert all(a == b for a, b in pairs)


@pytest.mark.cuda
def test_cycle_spec_with_card_resolvers_equals_the_oracle(card):
    """CycleTestCUDA with both resolvers on the card equals the same spec
    and seed with oracle resolvers (ok, metrics, seed, virtual time), and
    the card ran the fixpoint kernel."""
    from foundationdb_tpu_torch.testing.specs import SPECS, make_engine_factory
    from foundationdb_tpu_torch.testing.workload import run_spec

    built = []
    factory = make_engine_factory()

    def card_engine():
        built.append(factory())
        return built[-1]

    spec = SPECS["CycleTestCUDA"]()
    spec.cluster.engine_factory = card_engine
    fc.FIXPOINT.reset_counts()
    res = run_spec(spec, 7)
    launches = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
    twin = SPECS["CycleTestCUDA"]()
    twin.cluster.engine_factory = toracle.OracleConflictEngine
    assert res.ok
    assert dataclasses.astuple(res) == dataclasses.astuple(run_spec(twin, 7))
    assert [e.state["hkeys"].device.type for e in built] == ["cuda", "cuda"]
    assert launches > 0 and fc.FIXPOINT.plain_cuda_calls == 0


@pytest.mark.cuda
def test_harness_point_with_a_card_resolver_equals_the_oracle(card):
    """One latency-harness point (depth 2, bucket 1024, 3000 txns) with the
    resolver on the card gives the same result as with the oracle."""
    from foundationdb_tpu_torch.pipeline.latency_harness import run_latency_under_load

    kw = dict(depth=2, batch_txns=1024, device_ms=0.45, pack_ms_per_txn=0.0006,
              offered_txns_per_sec=2_000_000.0, n_txns=3000,
              device_ms_by_bucket={512: 0.3, 1024: 0.45})
    cfg = ck.KernelConfig(key_words=4, capacity=16384, max_txns=1024, max_point_reads=2048,
                          max_point_writes=2048, max_reads=64, max_writes=64)
    fc.FIXPOINT.reset_counts()
    got = run_latency_under_load(engine_factory=lambda: TorchConflictEngine(
        cfg, ladder=(512,), device_time_sample_rate=0.0), **kw).as_dict()
    launches = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
    assert got == run_latency_under_load(**kw).as_dict()
    assert got["errors"] == 0 and launches > 0 and fc.FIXPOINT.plain_cuda_calls == 0


@pytest.mark.cuda
def test_dynamic_spec_with_card_resolvers_equals_the_oracle(card):
    """CycleTestAttrition at seed 1 with every resolver that recruitment
    builds, in every generation, a card engine (make_engine_factory())
    equals the same spec and seed with oracle resolvers (ok, metrics,
    seed, virtual time); the kills recruited fresh card engines and the
    card ran the fixpoint kernel."""
    from foundationdb_tpu_torch.testing.specs import SPECS, make_engine_factory
    from foundationdb_tpu_torch.testing.workload import run_spec

    built = []
    factory = make_engine_factory()

    def card_engine():
        built.append(factory())
        return built[-1]

    spec = SPECS["CycleTestAttrition"]()
    spec.dynamic.engine_factory = card_engine
    fc.FIXPOINT.reset_counts()
    res = run_spec(spec, 1)
    launches = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
    plain = fc.FIXPOINT.plain_cuda_calls
    assert res.ok
    assert dataclasses.astuple(res) == dataclasses.astuple(run_spec(SPECS["CycleTestAttrition"](), 1))
    assert len(built) > 2 and {e.state["hkeys"].device.type for e in built} == {"cuda"}
    assert launches > 0 and plain == 0


@pytest.mark.cuda
def test_kill_resolver_mid_run_with_card_resolvers(card):
    """tests/test_recovery.py's kill of the process hosting resolver.resolve
    mid-run, with card resolvers: the counter reaches its target through
    the epoch recovery, the recovery recruited fresh card engines, and
    those served batches of the new epoch."""
    from foundationdb_tpu_torch.server.cluster import DynamicClusterConfig, build_dynamic_cluster
    from foundationdb_tpu_torch.sim.simulator import KillType
    from foundationdb_tpu_torch.testing.specs import make_engine_factory

    built = []
    factory = make_engine_factory()

    def card_engine():
        eng = factory()
        rec = {"engine": eng, "batches": 0}
        resolve = eng.resolve

        def counting(*a):
            rec["batches"] += 1
            return resolve(*a)

        eng.resolve = counting
        built.append(rec)
        return eng

    c = build_dynamic_cluster(seed=37, cfg=DynamicClusterConfig(engine_factory=card_engine))
    sim, db = c.sim, c.new_client()

    async def work():
        n = 0
        while n < 12:
            async def bump(tr):
                m = int(await tr.get(b"k") or b"0") + 1
                tr.set(b"k", str(m).encode())
                return m
            n = await db.run(bump)
        return n

    fc.FIXPOINT.reset_counts()
    task = sim.sched.spawn(work(), name="w")
    sim.run(until=10.0)
    victim = next(p for p in c.worker_procs
                  if any(t.startswith("resolver.resolve") for t in p.handlers))
    before = len(built)
    sim.kill_process(victim, KillType.REBOOT)
    assert sim.run_until(task, until=240.0) >= 12
    fresh = built[before:]
    assert fresh and all(r["batches"] > 0 for r in fresh)
    assert {r["engine"].state["hkeys"].device.type for r in built} == {"cuda"}
    assert fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches > 0
    assert fc.FIXPOINT.plain_cuda_calls == 0


@pytest.mark.cuda
def test_backup_spec_with_card_resolvers_equals_the_oracle(card):
    """BackupCorrectness at seed 1 with every resolver recruited in the
    source cluster and in the restore's destination cluster a card engine
    (make_engine_factory(); the destination takes the source's factory)
    equals the same spec and seed with oracle resolvers (ok, metrics,
    seed, virtual time), and the card ran the fixpoint kernel."""
    from foundationdb_tpu_torch.testing.specs import SPECS, make_engine_factory
    from foundationdb_tpu_torch.testing.workload import run_spec

    built = []
    factory = make_engine_factory()

    def card_engine():
        built.append(factory())
        return built[-1]

    spec = SPECS["BackupCorrectness"]()
    spec.dynamic.engine_factory = card_engine
    fc.FIXPOINT.reset_counts()
    res = run_spec(spec, 1)
    launches = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
    plain = fc.FIXPOINT.plain_cuda_calls
    n_source = spec.dynamic.n_resolvers
    assert res.ok and res.metrics.get("backups") == 1
    assert dataclasses.astuple(res) == dataclasses.astuple(run_spec(SPECS["BackupCorrectness"](), 1))
    assert len(built) > n_source and {e.state["hkeys"].device.type for e in built} == {"cuda"}
    assert launches > 0 and plain == 0


@pytest.mark.cuda
def test_stack_stream_with_card_resolvers_equals_the_oracle(card):
    """tests/test_stacktester.py's conformance at seed 201: the stream run
    through a static cluster with both resolvers on the card gives the
    oracle run's journal and final keyspace."""
    from foundationdb_tpu_torch.bindings.stacktester import final_state, generate_stream, run_stream
    from foundationdb_tpu_torch.server.cluster import ClusterConfig, build_cluster
    from foundationdb_tpu_torch.testing.specs import make_engine_factory

    def run_with(engine_factory, stream):
        c = build_cluster(seed=201, cfg=ClusterConfig(n_resolvers=2, n_storage=2,
                                                      engine_factory=engine_factory))
        db = c.new_client()

        async def go():
            return await run_stream(db, stream), await final_state(db)

        return c.sim.run_until(c.sim.sched.spawn(go(), name="stack"), until=600.0)

    stream = generate_stream(201)
    fc.FIXPOINT.reset_counts()
    got = run_with(make_engine_factory(), stream)
    launches = fc.FIXPOINT.launches + fc.FIXPOINT.graph_launches
    assert got == run_with(toracle.OracleConflictEngine, stream)
    assert launches > 0 and fc.FIXPOINT.plain_cuda_calls == 0


# ---------------------------------------------------------------------------
# the stacked fixpoint entry and the sharded engines
# ---------------------------------------------------------------------------

def stacked_vs_plain(card, cfg, S, seed, n=4):
    """The stacked entry on the card against its plain version on the CPU,
    on the stacked step's own inputs over evolving sub-shard tables; at
    S = 1 also against the single-table entry. Returns the rounds seen."""
    rng = random.Random(seed)
    state = ck._stack([ck.initial_state(cfg) for _ in range(S)])
    rounds = []
    for trial in range(n):
        per = [synth_batch(rng, cfg, 100 + trial) for _ in range(S)]
        for b in per[1:]:
            b["t_ok"], b["t_too_old"] = per[0]["t_ok"], per[0]["t_too_old"]
        batch = ck._stack([ck.batch_from_numpy(cfg, b, "cpu") for b in per])
        hist, edges, wpos = ck.detect_step_stacked(cfg, state, batch)
        want = fc.commit_fixpoint_stacked(cfg, batch["t_ok"][0], hist, edges, batch)
        dbatch = {k: v.to(card) for k, v in batch.items()}
        dedges = {k: v.to(card) for k, v in edges.items()}
        got = fc.commit_fixpoint_stacked(cfg, dbatch["t_ok"][0], hist.to(card), dedges, dbatch)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (S, trial)
        rounds.append(int(fc.FIXPOINT_STACKED.last_rounds.item()))
        if S == 1:
            one = fc.commit_fixpoint_kernel(cfg, dbatch["t_ok"][0], hist[0].to(card),
                                            {k: v[0] for k, v in dedges.items()},
                                            {k: v[0] for k, v in dbatch.items()})
            torch.cuda.synchronize()
            assert torch.equal(one, got), trial
            assert int(fc.FIXPOINT.last_rounds.item()) == rounds[-1]
        state, _ = ck.apply_step_stacked(cfg, state, batch, want, wpos, False)
    return rounds


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 8])
@pytest.mark.parametrize("cfg", CONFIGS + (RAGGED,), ids=["small", "medium", "ragged"])
def test_stacked_kernel_matches_plain(card, cfg, S):
    """The stacked entry equals its plain version element for element, in
    one launch per call; at S = 1 it equals the single-table entry."""
    fc.FIXPOINT_STACKED.reset_counts()
    rounds = stacked_vs_plain(card, cfg, S, seed=S * 31, n=4)
    assert all(1 <= r <= cfg.max_txns + 1 for r in rounds)
    assert fc.FIXPOINT_STACKED.launches == 4 and fc.FIXPOINT_STACKED.plain_cuda_calls == 0


@pytest.mark.cuda
def test_stacked_kernel_deep_chain_in_one_sub_shard(card):
    """A deep chain in the last of 4 sub-shards, the others empty: one round
    per link, as the plain version runs."""
    cfg, S, n = WIDE, 4, WIDE.max_txns
    chain = chain_rows(ck.build_batch_arrays, cfg, n)
    empty = chain_rows(ck.build_batch_arrays, cfg, 0)
    empty["t_ok"], empty["t_too_old"] = chain["t_ok"], chain["t_too_old"]
    batch = ck._stack([ck.batch_from_numpy(cfg, b, "cpu") for b in [empty] * (S - 1) + [chain]])
    state = ck._stack([ck.initial_state(cfg) for _ in range(S)])
    hist, edges, _ = ck.detect_step_stacked(cfg, state, batch)
    want = fc.commit_fixpoint_stacked(cfg, batch["t_ok"][0], hist, edges, batch)
    got = fc.commit_fixpoint_stacked(cfg, batch["t_ok"][0].to(card), hist.to(card),
                                     {k: v.to(card) for k, v in edges.items()},
                                     {k: v.to(card) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and int(fc.FIXPOINT_STACKED.last_rounds.item()) == n
    assert torch.equal(want[:n], torch.arange(n) % 2 == 0)


@pytest.mark.cuda
def test_stacked_kernel_refuses_what_it_cannot_hold(card):
    cfg = CONFIGS[0]
    assert fc.supported(cfg, 8) and not fc.supported(dataclasses.replace(cfg, max_txns=33), 2)
    with pytest.raises(ValueError, match="stacked"):
        fc.launch_plan_stacked(ck.KernelConfig(max_txns=1 << 16, max_point_reads=1 << 16,
                                               max_point_writes=1 << 16), 64)
    batch = ck._stack([ck.batch_from_numpy(cfg, synth_batch(random.Random(1), cfg, 9), card)
                       for _ in range(2)])
    hist, edges, _ = ck.detect_step_stacked(
        cfg, ck._stack([ck.initial_state(cfg, device=card) for _ in range(2)]), batch)
    with pytest.raises(ValueError, match="hist"):
        fc.commit_fixpoint_stacked_kernel(cfg, batch["t_ok"][0], hist.to(torch.int64), edges,
                                          batch)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["subsharded", "sharded", "mesh"])
def test_sharded_engines_on_card_match_cpu(card, mode):
    """The sharded engine families on the card (graph-captured stacked
    programs; the mesh engine's split scan / exchange pair) against the
    same engine on the CPU and the oracle, every dispatch without a host
    sync, the stacked entry on the path and never the plain version."""
    from foundationdb_tpu_torch.core.keyshard import KeyShardMap
    from foundationdb_tpu_torch.ops.host_engine import make_engine

    cfg = LADDER_CFG
    shards = KeyShardMap([b"p00150", b"p00300", b"p00450"])
    kw = dict(shards=shards, ladder=LADDER, scan_sizes=SCANS, heat_buckets=8)
    gpu = make_engine(mode, cfg, **kw).warmup()
    cpu = make_engine(mode, cfg, device="cpu", **kw)
    ora = toracle.OracleConflictEngine()
    fc.FIXPOINT_STACKED.reset_counts()
    captures = gpu.perf.captures
    for txns, now, oldest in point_batches(41, [30, 200, 700, 90, 1000, 5]):
        plan = gpu.columnar_pack(txns, now, oldest)
        torch.cuda.set_sync_debug_mode("error")
        try:
            force = gpu.columnar_dispatch(plan)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = [int(v) for v in force()]
        assert got == [int(v) for v in cpu.resolve(txns, now, oldest)]
        assert got == [int(v) for v in ora.resolve(txns, now, oldest)]
    assert gpu.perf.captures == captures, "captured after warmup"
    assert fc.FIXPOINT_STACKED.graph_launches > 0
    assert fc.FIXPOINT_STACKED.plain_cuda_calls == 0
    assert gpu.heat_snapshot() == cpu.heat_snapshot()
    if mode == "mesh":
        assert gpu.loop_stats["blocking_syncs"] == 0


@pytest.mark.cuda
def test_ladder_drive_on_card_equals_the_oracle(card):
    """tools/ladder_bench's drive on a card engine: every batch's verdicts
    equal the oracle's, every bucket and the 2-chunk scan serve, and
    nothing is built or captured after warmup()."""
    from foundationdb_tpu_torch.tools.ladder_bench import drive_bucket_ladder

    cfg = ck.KernelConfig(key_words=4, capacity=2048, max_txns=128, max_point_reads=256,
                          max_point_writes=256, max_reads=32, max_writes=32)
    out = drive_bucket_ladder(cfg, [32, 64], pool=512, steady_rounds=2, scan_sizes=(2,),
                              oracle_check=True)
    assert out["device"].startswith("cuda") and out["oracle_parity_ok"]
    assert out["steady_state_compiles"] == 0 and out["steady_state_captures"] == 0
    assert out["captures_warmup"] > 0 and out["scan_dispatches"]["2"] > 0


@pytest.mark.cuda
def test_profile_kernel_fixpoint_variant_equals_plain(card):
    """profile_kernel's fixpoint variant at the bench shape: the kernel's
    verdicts equal the plain version's on the same inputs, and the captured
    program of its loop replays and is timed."""
    import io

    from foundationdb_tpu_torch.tools import profile_kernel

    out = io.StringIO()
    p = profile_kernel.run(["fixpoint"], steps=4, out=out)
    assert p.info["fixpoint_equal"] is True
    assert p.ms["fixpoint"] > 0 and "ms/iter" in out.getvalue()


@pytest.mark.cuda
def test_cli_status_over_card_resolvers_equals_oracle_text(card, capsys):
    """`cli status` in one-shot mode: the cluster's resolvers are card
    engines by default, and the text equals an oracle-resolver twin's."""
    from foundationdb_tpu_torch.tools import cli

    assert cli.main(["status"]) == 0
    card_text = capsys.readouterr().out
    assert cli.main(["--engine", "oracle", "status"]) == 0
    assert card_text == capsys.readouterr().out
    assert "recovery state     - fully_recovered" in card_text


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 40])
def test_fixpoint_kernel_pads_part_words_equal_to_plain(card, T):
    """A batch of T % 32 != 0 txns runs the kernel padded to whole 32-txn
    words: committed bits equal the plain version's on the same inputs, in
    one launch, and a T=16 card engine (history_smoke's parity shape)
    resolves like the oracle."""
    cfg = ck.KernelConfig(key_words=2, capacity=512, max_txns=T, max_reads=64, max_writes=64)
    rng = random.Random(T)
    state = ck.initial_state(cfg, device=card)
    for now in (100, 140, 180):
        batch = ck.batch_from_numpy(cfg, synth_batch(rng, cfg, now), card)
        hist, edges, _ = ck.local_phases(cfg, state, batch)
        before = fc.FIXPOINT.launches
        got = fc.commit_fixpoint_kernel(cfg, batch["t_ok"], hist, edges, batch)
        want = fc.commit_fixpoint_plain(cfg, batch["t_ok"], hist, edges, batch)
        assert got.shape == (T,) and torch.equal(got, want)
        assert fc.FIXPOINT.launches == before + 1
    eng = TorchConflictEngine(cfg, ladder=(), device=card)
    ora = toracle.OracleConflictEngine()
    for i, n in enumerate((3, T, 9)):
        txns = [CommitTransaction(read_snapshot=100 + i,
                                  read_conflict_ranges=[KeyRange(b"k%d" % (j % 5), b"k%d\x00" % (j % 5))],
                                  write_conflict_ranges=[KeyRange(b"k%d" % ((j + 1) % 5),
                                                                  b"k%d\x00" % ((j + 1) % 5))])
                for j in range(n)]
        got = [int(v) for v in eng.resolve(txns, 200 + 50 * i, 0)]
        assert got == [int(v) for v in ora.resolve(txns, 200 + 50 * i, 0)]


@pytest.mark.cuda
def test_heat_smoke_disabled_path_over_captured_programs(card):
    """heat_smoke's disabled path on the card: a heat_buckets=0 engine
    builds no aggregator, the step's outputs carry no heat, and no program
    its warmup captured holds a heat buffer."""
    from foundationdb_tpu_torch.tools import heat_smoke

    out = heat_smoke.check_disabled_path(card)
    assert out["captured_programs"] > 0
    assert "heat" not in out["resolve"]
    assert not any(k.startswith("heat_") for k in out["edges"])


@pytest.mark.cuda
def test_perf_smoke_ledger_peak_bytes_on_card(card):
    """perf_smoke on the card: one ledger row per captured build, every
    row's peak_bytes above 0 (flops None by design), sampling on/off
    parity, no build or capture after warmup, no blocking sync."""
    from foundationdb_tpu_torch.tools import perf_smoke

    out = perf_smoke.run("cuda")
    assert out["ok"], out["failures"]
    assert out["ledger_rows"] > 0 and all(b and b > 0 for b in out["peak_bytes"])
    assert out["steady_state_compiles"] == 0
