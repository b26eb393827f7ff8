"""The port's sharded resolver against the JAX package, on the CPU.

  * the sharded native passes (csrc/fastpack.c conflict_counts_sharded /
    build_point_rows_sharded, via wire_pass1_sharded and
    wire_chunk_arrays_sharded) give the JAX passes' arrays, over uniform
    and adversarial splits, into fresh and into reused arena buffers;
  * the stacked step — commit_fixpoint_stacked, detect / fix / apply, the
    heat aggregates, resolve_step_stacked and its chunk scan — equals the
    JAX functions element for element, padding rows included, at S in
    {1, 2, 8}; commit_fixpoint's allreduce hook combines shards as the
    stacked sum does;
  * parallel/sharding.py's programs equal JAX's shard_map programs on its
    8 virtual devices, and ShardedConflictEngine equals the oracle and the
    JAX ShardedConflictEngine (tests/test_sharded_parity.py,
    test_columnar_sharded.py, test_long_keys.py:150,
    test_bucket_ladder.py:145), the sharded columnar path taken;
  * shards on distinct devices are placed as groups; a group that names
    two devices raises.

Inputs are made from seeds. Every comparison is exact (integers and bools).
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.core.keyshard import KeyShardMap as JKeyShardMap
from foundationdb_tpu.core.rng import DeterministicRandom
from foundationdb_tpu.core.types import CommitTransaction, KeyRange
from foundationdb_tpu.ops import conflict_kernel as jck
from foundationdb_tpu.ops import host_engine as jhe
from foundationdb_tpu.ops.oracle import OracleConflictEngine
from foundationdb_tpu.parallel import sharding as jsh
from foundationdb_tpu_torch.core.keyshard import KeyShardMap
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops import host_engine as the
from foundationdb_tpu_torch.parallel import sharding as tsh

from test_kernel_parity import random_txn
from test_torch_conflict_kernel import eq, port_cfg, synth_batch

torch.set_num_threads(1)

SMALL = jck.KernelConfig(key_words=2, capacity=512, max_txns=32, max_point_reads=128,
                         max_point_writes=128, max_reads=32, max_writes=32)
WINDOW = 8


def ints(verdicts):
    return [int(v) for v in verdicts]


# ---------------------------------------------------------------------------
# the sharded native passes
# ---------------------------------------------------------------------------

def point_txn(rng, v, pool=64, nr=2, nw=2, prefix=b"", stale=0.1):
    t = CommitTransaction(read_snapshot=max(0, v - (rng.randrange(3000, 5000)
                                                    if rng.random() < stale
                                                    else rng.randrange(1, 40))))
    for _ in range(nr):
        k = prefix + b"%04d" % rng.randrange(pool)
        t.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
    for _ in range(nw):
        k = prefix + b"%04d" % rng.randrange(pool)
        t.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
    return t


def splits_blob(splits):
    offs = np.zeros((len(splits) + 1,), np.int64)
    np.cumsum([len(s) for s in splits], out=offs[1:])
    return b"".join(splits), offs


@pytest.mark.parametrize("splits", [
    [b"0032"],
    [b"0008", b"0016", b"0024", b"0032", b"0040", b"0048", b"0056"],
    [b"00", b"0020\x00", b"0040"],          # prefix splits on generated keys
    [b"\x00", b"0", b"0063", b"0063\x00", b"1"],
])
def test_sharded_wire_passes_match_jax(splits):
    rng = random.Random(len(splits))
    S = len(splits) + 1
    sb, so = splits_blob(splits)
    pcfg = port_cfg(SMALL)
    arena = the.HostPackArena()
    for trial in range(4):
        n = rng.randrange(1, 60)
        txns = [point_txn(rng, 10_000) for _ in range(n)]
        blocks = [t.conflict_wire_block() for t in txns]
        got = the.wire_pass1_sharded(WINDOW, blocks, sb, so, S)
        want = jhe.wire_pass1_sharded(WINDOW, blocks, sb, so, S)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        blob, offs, rp_cnt, wp_cnt = got
        skip = (np.array([rng.random() < 0.2 for _ in range(n)])
                & (rp_cnt.sum(axis=1) > 0)).astype(np.uint8)
        snap_rel = np.array([rng.randrange(-1, 500) for _ in range(n)], np.int32)
        eff_r = np.where(skip[:, None], 0, rp_cnt).astype(np.int32)
        t0 = rng.randrange(0, n)
        t1 = rng.randrange(t0 + 1, min(n, t0 + 20) + 1)
        now_rel, gc_rel = 700 + trial, trial % 2 * 50
        jper = jhe.wire_chunk_arrays_sharded(SMALL, blob, offs, t0, t1, skip, snap_rel, eff_r,
                                             now_rel, gc_rel, sb, so, S)
        bufs, lease = arena.lease(pcfg, S)
        for tper in (the.wire_chunk_arrays_sharded(pcfg, blob, offs, t0, t1, skip, snap_rel,
                                                   eff_r, now_rel, gc_rel, sb, so, S),
                     the.wire_chunk_arrays_sharded(pcfg, blob, offs, t0, t1, skip, snap_rel,
                                                   eff_r, now_rel, gc_rel, sb, so, S,
                                                   bufs=bufs)):
            assert len(tper) == len(jper) == S
            for tarr, jarr in zip(tper, jper):
                assert tarr.keys() == jarr.keys()
                n_rp, n_wp = int(jarr["rp_valid"].sum()), int(jarr["wp_valid"].sum())
                prefix = {"rpb": n_rp, "rp_snap": n_rp, "rp_txn": n_rp, "wpb": n_wp,
                          "wp_txn": n_wp}
                for k, want_arr in jarr.items():
                    got_arr, want_arr = np.asarray(tarr[k]), np.asarray(want_arr)
                    assert got_arr.dtype == want_arr.dtype, k
                    assert got_arr.shape == want_arr.shape, k
                    cut = prefix.get(k)
                    if cut is None:
                        assert np.array_equal(got_arr, want_arr), k
                    else:
                        assert np.array_equal(got_arr[:cut], want_arr[:cut]), k
        lease.release()


# ---------------------------------------------------------------------------
# the stacked step, element for element
# ---------------------------------------------------------------------------

def stacked_inputs(seed, cfg, S, n_warm=2, heat=0):
    """A stacked table warmed by JAX's resolve_step_stacked and the next
    stacked batch: S batches over one txn space (t_ok / t_too_old / now /
    gc replicated). Returns (jax cfg, np state, np batch)."""
    jcfg = dataclasses.replace(cfg, heat_buckets=heat)
    rng = random.Random(seed)
    first_keys = [b""] + [b"%02d" % (24 * s // S) for s in range(1, S)]
    state = {k: np.stack([np.asarray(jck.initial_state(jcfg, 0, first_keys[s])[k])
                          for s in range(S)])
             for k in jck.initial_state(jcfg, 0)}

    def batch(now, gc):
        per = [synth_batch(rng, jcfg, now, gc) for _ in range(S)]
        for b in per[1:]:
            b["t_ok"], b["t_too_old"] = per[0]["t_ok"], per[0]["t_too_old"]
        return {k: np.stack([np.asarray(b[k]) for b in per]) for k in per[0]}

    step = jax.jit(lambda st, b: jck.resolve_step_stacked(jcfg, st, b))
    now = 50
    for i in range(n_warm):
        st, _ = step({k: jnp.asarray(v) for k, v in state.items()},
                     {k: jnp.asarray(v) for k, v in batch(now, 0).items()})
        state = {k: np.asarray(v) for k, v in st.items()}
        now += 40
    return jcfg, state, batch(now, 20 if seed % 2 else 0)


def to_port(cfg, np_tree):
    """The port's stacked state or batch from JAX's numpy arrays."""
    S = next(iter(np_tree.values())).shape[0]
    shards = [{k: v[s] for k, v in np_tree.items()} for s in range(S)]
    if "hkeys" in np_tree:
        return tck._stack([tck.state_from_numpy(cfg, a, "cpu") for a in shards])
    return tck._stack([tck.batch_from_numpy(cfg, a, "cpu") for a in shards])


def assert_tree_eq(got, want, what):
    """Equal leaves; JAX's uint32 words (bit words, key words) against the
    port's int32 bits or zero-extended int64 words by their 32 bits."""
    assert sorted(got) == sorted(want), what
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_eq(got[k], want[k], f"{what}.{k}")
            continue
        w = np.asarray(want[k])
        g = got[k]
        if w.dtype == np.uint32 and g.dtype == torch.int32:
            w = w.view(np.int32)
        assert eq(g, w), f"{what}.{k}"


@pytest.mark.parametrize("S", [1, 2, 8])
@pytest.mark.parametrize("heat", [0, 8])
def test_stacked_step_equals_jax(S, heat):
    jcfg, st_np, b_np = stacked_inputs(S * 10 + heat + 1, SMALL, S, heat=heat)
    pcfg = port_cfg(jcfg)
    jst = {k: jnp.asarray(v) for k, v in st_np.items()}
    jb = {k: jnp.asarray(v) for k, v in b_np.items()}
    pst, pb = to_port(pcfg, st_np), to_port(pcfg, b_np)
    gc = bool(b_np["gc"][0] > 0)

    jhist, jedges, jwpos = jax.jit(lambda s, b: jck.detect_step_stacked(jcfg, s, b))(jst, jb)
    phist, pedges, pwpos = tck.detect_step_stacked(pcfg, pst, pb)
    assert eq(phist, jhist)
    assert_tree_eq({k: v for k, v in pedges.items()}, dict(jedges), "edges")
    assert_tree_eq(pwpos, dict(jwpos), "wpos")

    jc = jax.jit(lambda t, h, e, b: jck.commit_fixpoint_stacked(jcfg, t, h, e, b))(
        jb["t_ok"][0], jhist, jedges, jb)
    pc = tck.commit_fixpoint_stacked(pcfg, pb["t_ok"][0], phist, pedges, pb)
    assert eq(pc, jc)
    assert eq(tck.fix_step_stacked(pcfg, pb["t_ok"][0], phist, pedges, pb), jc)

    jnew, jov = jax.jit(lambda s, b, c, w: jck.apply_step_stacked(jcfg, s, b, c, w))(
        jst, jb, jc, jwpos)
    pnew, pov = tck.apply_step_stacked(pcfg, to_port(pcfg, st_np), pb, pc, pwpos, gc)
    assert_tree_eq(pnew, dict(jnew), "apply state")
    assert eq(pov, jov)

    jnew2, jout = jax.jit(lambda s, b: jck.resolve_step_stacked(jcfg, s, b))(jst, jb)
    pnew2, pout = tck.resolve_step_stacked(pcfg, to_port(pcfg, st_np), pb, gc)
    assert_tree_eq(pnew2, dict(jnew2), "step state")
    assert_tree_eq({k: v for k, v in pout.items() if k != "merged"},
                   {k: (dict(v) if isinstance(v, dict) else v) for k, v in jout.items()},
                   "step out")


@pytest.mark.parametrize("S", [1, 2, 8])
def test_stacked_scan_equals_jax(S):
    jcfg, st_np, b0 = stacked_inputs(77 + S, SMALL, S, heat=4)
    _, _, b1 = stacked_inputs(78 + S, SMALL, S, n_warm=0, heat=4)
    b1["now"] = b0["now"] + 10
    b1["gc"] = np.full_like(b1["gc"], 5)
    b0["gc"] = np.zeros_like(b0["gc"])
    C = 2
    bs = {k: np.stack([b0[k], b1[k]]) for k in b0}              # [C, S, ...]
    pcfg = port_cfg(jcfg)
    jnew, jout = jax.jit(lambda s, b: jck.resolve_step_stacked_scan(jcfg, s, b))(
        {k: jnp.asarray(v) for k, v in st_np.items()}, {k: jnp.asarray(v) for k, v in bs.items()})
    pb = {k: torch.stack([to_port(pcfg, b0)[k], to_port(pcfg, b1)[k]]) for k in b0}
    pnew, pout = tck.resolve_step_stacked_scan(pcfg, to_port(pcfg, st_np), pb, True)
    assert pout["status"].shape == (C, jcfg.max_txns)
    assert_tree_eq(pnew, dict(jnew), "scan state")
    assert_tree_eq(pout, {k: (dict(v) if isinstance(v, dict) else v) for k, v in jout.items()},
                   "scan out")


def test_stacked_shapes_equal_jax_structs():
    for cfg in (SMALL, dataclasses.replace(SMALL, history_structure="tiered", heat_buckets=8)):
        pcfg = port_cfg(cfg)
        for stack in ((), (3,), (2, 5)):
            for pfn, jfn in ((tck.state_shapes, jck.state_struct),
                             (tck.batch_shapes, jck.batch_struct),
                             (tck.heat_shapes, jck.heat_struct)):
                p, j = pfn(pcfg, stack), jfn(cfg, stack)
                if pfn is tck.heat_shapes and not cfg.heat_buckets:
                    assert p == {}          # the port's heat-off programs carry none
                    continue
                assert sorted(p) == sorted(j), pfn.__name__
                for k in j:
                    assert p[k][0] == tuple(j[k].shape), (pfn.__name__, k, stack)


@pytest.mark.parametrize("hook", ["identity", "doubled", "silenced"])
def test_allreduce_hook_equals_jax(hook):
    """commit_fixpoint's allreduce hook combines one shard's per-round
    blocked counts as JAX's does: the same hook in both packages gives the
    same verdicts (identity: the one-shard fixpoint; doubled: counts stay
    > 0 exactly where they were; silenced: no intra-batch blocking)."""
    fn = {"identity": lambda x: x, "doubled": lambda x: 2 * x, "silenced": lambda x: 0 * x}[hook]
    jcfg, st_np, b_np = stacked_inputs(5, SMALL, 1)
    pcfg = port_cfg(jcfg)
    jst = {k: jnp.asarray(v[0]) for k, v in st_np.items()}
    jb = {k: jnp.asarray(v[0]) for k, v in b_np.items()}
    pst = tck.state_from_numpy(pcfg, {k: v[0] for k, v in st_np.items()}, "cpu")
    pb = tck.batch_from_numpy(pcfg, {k: v[0] for k, v in b_np.items()}, "cpu")
    jh, je, _ = jax.jit(lambda s_, b_: jck.local_phases(jcfg, s_, b_))(jst, jb)
    ph, pe, _ = tck.local_phases(pcfg, pst, pb)
    want = jax.jit(lambda t, h, e, b_: jck.commit_fixpoint(jcfg, t, h, e, b_, allreduce=fn))(
        jb["t_ok"], jh, je, jb)
    got = tck.commit_fixpoint(pcfg, pb["t_ok"], ph, pe, pb, allreduce=fn)
    assert eq(got, want)
    if hook == "identity":
        assert eq(got, tck.commit_fixpoint(pcfg, pb["t_ok"], ph, pe, pb))
    if hook == "silenced":
        assert eq(got, pb["t_ok"] & ~(ph > 0))


# ---------------------------------------------------------------------------
# parallel/sharding.py's programs against JAX's shard_map programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [8])
def test_sharded_programs_equal_jax_shard_map(S):
    jcfg, st_np, b_np = stacked_inputs(40 + S, SMALL, S, heat=4)
    pcfg = port_cfg(jcfg)
    mesh = jax.make_mesh((S,), ("shard",), devices=jax.devices()[:S])
    devs = ["cpu"] * S
    gc = bool(b_np["gc"][0] > 0)
    jst = {k: jnp.asarray(v) for k, v in st_np.items()}
    jb = {k: jnp.asarray(v) for k, v in b_np.items()}
    jnew, jout = jsh.make_sharded_step(jcfg, mesh)(jst, jb)
    pnew, pout = tsh.make_sharded_step(pcfg, devs)(to_port(pcfg, st_np), to_port(pcfg, b_np), gc)
    assert_tree_eq(pnew, dict(jnew), "sharded state")
    assert_tree_eq({k: v for k, v in pout.items() if k != "merged"},
                   {k: (dict(v) if isinstance(v, dict) else v) for k, v in jout.items()},
                   "sharded out")

    jscan = jax.jit(jsh.make_mesh_scan_step(jcfg, mesh))(jst, jb)
    pscan = tsh.make_mesh_scan_step(pcfg, devs)(to_port(pcfg, st_np), to_port(pcfg, b_np))
    assert eq(pscan[0], jscan[0])
    assert_tree_eq(pscan[1], dict(jscan[1]), "scan edges")
    assert_tree_eq(pscan[2], dict(jscan[2]), "scan wpos")
    jx_new, jx_out = jax.jit(jsh.make_mesh_exchange_step(jcfg, mesh))(jst, jb, *jscan)
    px_new, px_out = tsh.make_mesh_exchange_step(pcfg, devs)(
        to_port(pcfg, st_np), to_port(pcfg, b_np), *pscan, gc)
    assert_tree_eq(px_new, dict(jx_new), "exchange state")
    for k in ("status", "overflow"):
        assert eq(px_out[k], jx_out[k]), k
    assert_tree_eq(px_out["heat"], dict(jx_out["heat"]), "exchange heat")

    jdet, jfix, japp = jsh.make_sharded_split_steps(jcfg, mesh)
    pdet, pfix, papp = tsh.make_sharded_split_steps(pcfg, devs)
    jh, je, jw = jdet(jst, jb)
    ph, pe, pw = pdet(to_port(pcfg, st_np), to_port(pcfg, b_np))
    t_ok = np.broadcast_to(b_np["t_ok"][0], (S,) + b_np["t_ok"][0].shape).copy()
    jc = jfix(jnp.asarray(t_ok), jh, je, jb)
    pc = pfix(torch.from_numpy(t_ok), ph, pe, to_port(pcfg, b_np))
    assert eq(pc, jc)
    ja_new, ja_ov = japp(jst, jb, jc, jw)
    pa_new, pa_ov = papp(to_port(pcfg, st_np), to_port(pcfg, b_np), pc, pw, gc)
    assert_tree_eq(pa_new, dict(ja_new), "split apply")
    assert eq(pa_ov, ja_ov)


def test_distinct_devices_raise():
    """Shards on distinct devices are placed as groups (sharding.placement,
    tests/test_torch_groups.py); what still raises is a group that names
    two devices, group indices that are not contiguous runs numbered in
    shard order, and an empty device list."""
    with pytest.raises(ValueError, match="names two devices"):
        tsh.placement(["cpu", "cuda:1"], [0, 0])
    with pytest.raises(ValueError, match="names two devices"):
        tsh.ShardedConflictEngine(port_cfg(SMALL), KeyShardMap([b"m"]),
                                  devices=["cuda:0", "cuda:1"], groups=[0, 0])
    with pytest.raises(ValueError, match="not contiguous"):
        tsh.placement(["cpu"] * 3, [0, 1, 0])
    with pytest.raises(ValueError, match="at least one device"):
        tsh.placement([])
    assert tsh.placement(["cpu", "cpu", torch.device("cpu")]) == [
        tsh.Group(torch.device("cpu"), 0, 3)]
    assert [(g.device.index, g.lo, g.hi) for g in tsh.placement(["cuda:0", "cuda:1"])] == [
        (0, 0, 1), (1, 1, 2)]


# ---------------------------------------------------------------------------
# ShardedConflictEngine against the oracle and JAX's engine
# ---------------------------------------------------------------------------

def port_sharded(cfg, shard_map, **kw):
    return tsh.ShardedConflictEngine(port_cfg(cfg), shard_map,
                                     devices=["cpu"] * shard_map.n_shards, **kw)


def jax_sharded(cfg, splits, **kw):
    sm = JKeyShardMap(splits)
    mesh = jax.make_mesh((sm.n_shards,), ("shard",), devices=jax.devices()[:sm.n_shards])
    return jsh.ShardedConflictEngine(cfg, sm, mesh, **kw)


def random_stream(seed, batches, txns_per_batch=10, allow_empty_reads=True):
    rng = DeterministicRandom(seed)
    now, oldest, out = 10, 0, []
    for _ in range(batches):
        now += rng.random_int(1, 30)
        if rng.random01() < 0.3:
            oldest = max(oldest, now - rng.random_int(20, 120))
        out.append(([random_txn(rng, oldest, now, allow_empty_reads)
                     for _ in range(rng.random_int(1, txns_per_batch + 1))], now, oldest))
    return out


CASES = {
    "one_shard": [],
    "two_shards_inside_alphabet": [b"b"],
    "eight_uniform": None,
    "eight_adversarial": [b"\x00", b"a", b"a\x00", b"ab", b"b", b"b\x00", b"\xff"],
}
SPAN = jck.KernelConfig(key_words=2, capacity=512, max_reads=128, max_writes=128, max_txns=32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_engine_matches_oracle_and_jax(case):
    """tests/test_sharded_parity.py's cases (wide ranges straddling every
    shard included), with the JAX ShardedConflictEngine beside."""
    splits = CASES[case] if CASES[case] is not None else \
        JKeyShardMap.uniform(8).begins[1:]
    eng = port_sharded(SPAN, KeyShardMap(splits), ladder=(), heat_buckets=0)
    jeng = jax_sharded(SPAN, splits, ladder=(), heat_buckets=0)
    ora = OracleConflictEngine()
    for b, (txns, now, oldest) in enumerate(random_stream(31 + len(splits), 14)):
        want = ints(ora.resolve(txns, now, oldest))
        assert ints(eng.resolve(txns, now, oldest)) == want, (case, b)
        assert ints(jeng.resolve(txns, now, oldest)) == want, (case, b)
    assert eng._progcache_fingerprint() == f"mesh:{eng.n_shards}/1"


COLUMNAR_CASES = {
    "uniform_eight": (None, b"", 2, 2, 64, 12),
    "adversarial": ([b"00", b"0020\x00", b"0040"], b"", 2, 2, 64, 12),
    "skewed_chunking": (None, b"\xf0", 8, 8, 32, 6),
}


@pytest.mark.parametrize("case", sorted(COLUMNAR_CASES))
def test_sharded_columnar_matches_oracle_and_jax(case, monkeypatch):
    """tests/test_columnar_sharded.py's cases: the sharded columnar path is
    taken, and its verdicts equal the oracle's, JAX's and the port's own
    general router's."""
    splits, prefix, nr, nw, pool, batches = COLUMNAR_CASES[case]
    if splits is None:
        splits = JKeyShardMap.uniform(4 if case == "adversarial" else 8).begins[1:]
    eng = port_sharded(SPAN, KeyShardMap(splits), heat_buckets=0)
    router = port_sharded(SPAN, KeyShardMap(splits), heat_buckets=0)
    router.columnar_pack = lambda *a: None
    jeng = jax_sharded(SPAN, splits, heat_buckets=0)
    ora = OracleConflictEngine()
    taken = []
    orig = the.wire_pass1_sharded
    monkeypatch.setattr(the, "wire_pass1_sharded",
                        lambda *a: taken.append(1) or orig(*a))
    rng = random.Random(len(case))
    now, oldest = 10, 0
    for b in range(batches):
        now += rng.randrange(1, 30)
        if rng.random() < 0.3:
            oldest = max(oldest, now - rng.randrange(20, 120))
        txns = [point_txn(rng, now, pool=pool, nr=nr, nw=nw, prefix=prefix, stale=0.0)
                for _ in range(rng.randrange(1, 12))]
        want = ints(ora.resolve(txns, now, oldest))
        assert ints(eng.resolve(txns, now, oldest)) == want, (case, b)
        assert ints(router.resolve(txns, now, oldest)) == want, (case, b)
        assert ints(jeng.resolve(txns, now, oldest)) == want, (case, b)
    assert taken, "the sharded columnar path was never taken"


def test_sharded_long_key_parity():
    """tests/test_long_keys.py:150: long keys drive the split-step path
    (stacked detect / fix / apply) of a 4-shard engine."""
    from test_long_keys import CFG as LK_CFG, random_stream as lk_stream

    splits = [b"L/", b"b/", b"s/"]
    eng = port_sharded(LK_CFG, KeyShardMap(splits))
    jeng = jax_sharded(LK_CFG, splits)
    ora = OracleConflictEngine()
    for txns, now, oldest in lk_stream(11, n_batches=8):
        want = ints(ora.resolve(txns, now, oldest))
        assert ints(eng.resolve(txns, now, oldest)) == want
        assert ints(jeng.resolve(txns, now, oldest)) == want


def test_sharded_bucket_ladder_boundaries():
    """tests/test_bucket_ladder.py:145: batch sizes straddling the 32-txn
    bucket, GC advancing: verdicts equal the oracle's and JAX's, every
    bucket serves."""
    from test_bucket_ladder import CFG as BL_CFG, LADDER, SCAN_SIZES, boundary_stream

    splits = [b"bl/0080"]
    eng = port_sharded(BL_CFG, KeyShardMap(splits), ladder=LADDER, scan_sizes=SCAN_SIZES)
    jeng = jax_sharded(BL_CFG, splits, ladder=list(LADDER), scan_sizes=SCAN_SIZES)
    ora = OracleConflictEngine()
    for txns, now, oldest in boundary_stream(1802):
        want = ints(ora.resolve(txns, now, oldest))
        assert ints(eng.resolve(txns, now, oldest)) == want
        assert ints(jeng.resolve(txns, now, oldest)) == want
    assert all(v > 0 for v in eng.perf.bucket_hits.values()), eng.perf.bucket_hits
    assert eng.perf.bucket_hits == jeng.perf.bucket_hits
    assert eng.perf.scan_dispatches.get(2, 0) > 0
