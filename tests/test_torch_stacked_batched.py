"""The stacked step batched over its sub-shards, as JAX's vmap runs it.

  * detect_step_stacked, apply_step_stacked, resolve_step_stacked and
    resolve_step_stacked_scan equal JAX's vmapped functions element for
    element at S in {1, 2, 3, 8}, monolithic and tiered, in both history
    search modes, heat off and on, GC on and off, over uneven sub-shards:
    an empty one, one near capacity that alone overflows, read-only ones
    and, under the tiered structure, full run stacks that merge beside
    stacks that append or stay (state, overflow and the port's merge flags
    also against a per-sub-shard run of the single-table apply);
  * the step runs one op sequence over the leading [S] axis: the aten ops
    resolve_step_stacked dispatches on the CPU are as many at S = 1, 2
    and 8;
  * the S = 1 stacked step is the single table's resolve_step, array for
    array.

Inputs are made from seeds. Every comparison is exact (integers and bools).
"""
import collections
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from foundationdb_tpu.ops import conflict_kernel as jck
from foundationdb_tpu_torch.ops import conflict_kernel as tck

from test_torch_conflict_kernel import eq, port_cfg, synth_batch
from test_torch_sharded import SMALL, assert_tree_eq, stacked_inputs, to_port
from test_torch_tiered import synth_state

torch.set_num_threads(1)

_JIT = {}


def jfns(cfg):
    """JAX's stacked functions, jitted once per config; "apply_each" is the
    vmap of apply_writes_and_gc with each sub-shard's overflow and
    reclaimed count."""
    if cfg not in _JIT:
        _JIT[cfg] = {
            "detect": jax.jit(lambda s, b: jck.detect_step_stacked(cfg, s, b)),
            "fix": jax.jit(lambda t, h, e, b: jck.commit_fixpoint_stacked(cfg, t, h, e, b)),
            "apply": jax.jit(lambda s, b, c, w: jck.apply_step_stacked(cfg, s, b, c, w)),
            "apply_each": jax.jit(lambda s, b, c, w: jax.vmap(
                lambda st, bb, ww: jck.apply_writes_and_gc(cfg, st, bb, c, ww))(s, b, w)),
            "step": jax.jit(lambda s, b: jck.resolve_step_stacked(cfg, s, b)),
            "scan": jax.jit(lambda s, b: jck.resolve_step_stacked_scan(cfg, s, b)),
        }
    return _JIT[cfg]


def kinds(S):
    """The sub-shards of an S-stack: "normal" (a random table and batch),
    "empty" (a fresh table, a batch without rows), "full" (a table H - 8
    rows deep whose batch writes 12 new keys: it alone overflows),
    "readonly" (a random table, a batch without writes)."""
    return {1: ["normal"], 2: ["normal", "empty"], 3: ["normal", "empty", "full"],
            8: ["normal", "empty", "normal", "full", "normal", "normal", "readonly",
                "normal"]}[S]


def uneven_inputs(jcfg, S, seed):
    """(np state [S, ...], np batches (gc 0, gc > 0) [S, ...]) over the
    sub-shards of kinds(S), one txn space (t_ok / t_too_old / now / gc
    replicated). Under the tiered structure normal sub-shard s holds s % (NR
    + 1) runs (full stacks merge where their batch writes) and the full one
    a full stack of point runs over new keys, so its merge overflows."""
    rng = random.Random(seed)
    tiered = jcfg.history_structure == "tiered"
    NR, H = jcfg.history_runs, jcfg.capacity
    planes = set(jck.initial_state(jcfg, 0))
    states = []
    for s, kind in enumerate(kinds(S)):
        if kind == "empty":
            st = {k: np.asarray(v) for k, v in jck.initial_state(jcfg, 0).items()}
        elif kind == "full":
            st = synth_state(jcfg, rng, n_base=H - 8, nruns=NR if tiered else 0,
                             n_keys=10**6, width=6, point_runs=True)
        else:
            st = synth_state(jcfg, rng, n_base=rng.randrange(1, 60),
                             nruns=s % (NR + 1) if tiered else 0)
        states.append({k: v for k, v in st.items() if k in planes})
    state = {k: np.stack([st[k] for st in states]) for k in states[0]}

    last = jcfg.max_txns - 1

    def random_batch(now, gc):
        # rows of txns below `last` only: txn `last` is the full sub-shard's
        # writer, with no reads anywhere, so its writes commit
        while True:
            b = synth_batch(rng, jcfg, now, gc)
            if all(not (b[f"{g}_valid"] & (b[f"{g}_txn"] == last)).any()
                   for g in ("rp", "r", "wp", "w")):
                return b

    def batch(now, gc):
        master = random_batch(now, gc)
        master["t_ok"][last], master["t_too_old"][last] = True, False
        per = []
        for kind in kinds(S):
            if kind == "full":
                keys = sorted({b"%06d" % rng.randrange(10**6) for _ in range(12)})
                b = jck.build_batch_arrays(jcfg, [], [], [], [], [], [], [], keys,
                                           [last] * len(keys), [], [], [], master["t_ok"],
                                           master["t_too_old"], now_rel=now, gc_rel=gc)
            elif kind == "empty":
                b = jck.build_batch_arrays(jcfg, [], [], [], [], [], [], [], [], [], [], [], [],
                                           master["t_ok"], master["t_too_old"],
                                           now_rel=now, gc_rel=gc)
            else:
                b = random_batch(now, gc)
                if kind == "readonly":
                    b["wp_valid"][:] = False
                    b["w_valid"][:] = False
            b["t_ok"], b["t_too_old"] = master["t_ok"], master["t_too_old"]
            per.append(b)
        return {k: np.stack([np.asarray(b[k]) for b in per]) for k in per[0]}

    # snapshots trail `now` by 1-40 versions, so reads hit the tables'
    # versions (base -1..60, runs 61 and up)
    return state, (batch(70, 0), batch(80, 25))


def jx(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def plain(tree):
    return {k: (plain(v) if isinstance(v, dict) else v) for k, v in dict(tree).items()}


#: (S, structure, history_search, heat): every S, structure, mode and heat
#: setting, each pair of values in some case
CASES = [
    (1, "monolithic", "bsearch", 0), (1, "tiered", "fused_sort", 8),
    (2, "monolithic", "fused_sort", 8), (2, "tiered", "bsearch", 0),
    (3, "monolithic", "bsearch", 8), (3, "tiered", "fused_sort", 0),
    (8, "monolithic", "fused_sort", 0), (8, "tiered", "bsearch", 8),
]


@pytest.mark.parametrize("S,structure,mode,heat", CASES)
def test_batched_stacked_step_equals_jax(S, structure, mode, heat):
    jcfg = dataclasses.replace(SMALL, history_structure=structure, history_search=mode,
                               heat_buckets=heat, history_runs=3)
    pcfg = port_cfg(jcfg)
    f = jfns(jcfg)
    st_np, batches = uneven_inputs(jcfg, S, seed=S * 100 + heat + len(mode) + len(structure))
    overflowed = []
    for b_np in batches:
        gc = bool(b_np["gc"][0] > 0)
        jst, jb = jx(st_np), jx(b_np)
        pb = to_port(pcfg, b_np)

        jhist, jedges, jwpos = f["detect"](jst, jb)
        phist, pedges, pwpos = tck.detect_step_stacked(pcfg, to_port(pcfg, st_np), pb)
        assert eq(phist, jhist)
        assert_tree_eq(pedges, dict(jedges), "edges")
        assert_tree_eq(pwpos, dict(jwpos), "wpos")

        jc = f["fix"](jb["t_ok"][0], jhist, jedges, jb)
        pc = tck.fix_step_stacked(pcfg, pb["t_ok"][0], phist, pedges, pb)
        assert eq(pc, jc)

        jnew, jov = f["apply"](jst, jb, jc, jwpos)
        pnew, pov = tck.apply_step_stacked(pcfg, to_port(pcfg, st_np), pb, pc, pwpos, gc)
        assert_tree_eq(pnew, dict(jnew), "apply state")
        assert eq(pov, jov)

        # each sub-shard's overflow and reclaimed count, and the merge flags
        # against the single-table apply run sub-shard by sub-shard
        _, jov_s, jrec_s = f["apply_each"](jst, jb, jc, jwpos)
        _, pov_s, prec_s, pmerged = tck._apply_stacked(pcfg, to_port(pcfg, st_np), pb, pc,
                                                       pwpos, gc)
        assert eq(pov_s, jov_s) and eq(prec_s, jrec_s)
        overflowed.append(np.asarray(jov_s))
        pst = to_port(pcfg, st_np)
        for s in range(S):
            one = tck._shard(pst, s)
            snew, sov, srec, smerged = tck._apply_writes(pcfg, one, tck._shard(pb, s), pc,
                                                         tck._shard(pwpos, s), gc)
            assert_tree_eq(snew, {k: v[s] for k, v in jnew.items()}, f"sub-shard {s}")
            assert bool(sov) == bool(jov_s[s]) and int(srec) == int(jrec_s[s])
            if structure == "tiered":
                assert bool(smerged) == bool(pmerged[s]), s
        if structure == "tiered" and S >= 3:
            merged = pmerged.numpy()
            assert merged.any() and not merged.all(), merged

        jnew2, jout = f["step"](jst, jb)
        pnew2, pout = tck.resolve_step_stacked(pcfg, to_port(pcfg, st_np), pb, gc)
        assert_tree_eq(pnew2, dict(jnew2), "step state")
        assert_tree_eq({k: v for k, v in pout.items() if k != "merged"}, plain(jout), "step out")
        if structure == "tiered":
            assert eq(pout["merged"], pmerged)

    if S >= 3:
        # the near-capacity sub-shard, and it alone, overflows
        want = np.array([k == "full" for k in kinds(S)])
        assert any(np.array_equal(o, want) for o in overflowed), overflowed

    # two chunks, the GC horizon on the last
    bs = {k: np.stack([batches[0][k], batches[1][k]]) for k in batches[0]}
    jnew, jout = f["scan"](jx(st_np), jx(bs))
    pbs = {k: torch.stack([to_port(pcfg, batches[0])[k], to_port(pcfg, batches[1])[k]])
           for k in batches[0]}
    pnew, pout = tck.resolve_step_stacked_scan(pcfg, to_port(pcfg, st_np), pbs, True)
    assert_tree_eq(pnew, dict(jnew), "scan state")
    assert_tree_eq({k: v for k, v in pout.items() if k != "merged"}, plain(jout), "scan out")


class _OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside the mode."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("structure", ["monolithic", "tiered"])
@pytest.mark.parametrize("heat", [0, 8])
def test_stacked_step_is_one_op_sequence_over_s(structure, heat):
    """resolve_step_stacked dispatches as many aten ops at S = 1, 2 and 8:
    no op runs once per sub-shard. Every sub-shard holds the same table
    and batch, so the plain fixpoint runs as many rounds and the tiered
    merge branch (taken: full run stacks, a write-bearing batch) is taken
    at every S."""
    jcfg = dataclasses.replace(SMALL, history_structure=structure, heat_buckets=heat,
                               history_runs=3)
    pcfg = port_cfg(jcfg)
    _, st_np, b_np = stacked_inputs(31 + heat, jcfg, 1, heat=heat)
    if structure == "tiered":
        st_np = {k: v[None] for k, v in synth_state(jcfg, random.Random(heat), n_base=30,
                                                     nruns=3).items()}
    counts = {}
    for S in (1, 2, 8):
        st = {k: v.repeat((S,) + (1,) * (v.dim() - 1)) for k, v in to_port(pcfg, st_np).items()}
        b = {k: v.repeat((S,) + (1,) * (v.dim() - 1)) for k, v in to_port(pcfg, b_np).items()}
        with _OpCount() as m:
            _, out = tck.resolve_step_stacked(pcfg, st, b, True)
        if structure == "tiered":
            assert bool(out["merged"].all())
        counts[S] = m.ops
    assert counts[1] == counts[2] == counts[8], {
        op: [counts[S][op] for S in (1, 2, 8)] for op in set().union(*counts.values())
        if len({counts[S][op] for S in (1, 2, 8)}) > 1}


@pytest.mark.parametrize("structure", ["monolithic", "tiered"])
@pytest.mark.parametrize("mode", ["fused_sort", "bsearch"])
@pytest.mark.parametrize("heat", [0, 8])
def test_s1_stacked_step_is_the_single_table_step(structure, mode, heat):
    """resolve_step_stacked at S = 1 equals resolve_step on the same table
    and batch: table, statuses, overflow, merge flag and heat, array for
    array, over three steps (the last with a GC horizon). The single
    table's batch also carries a host value beside its tensors, as
    chip_smoke's do; the step passes it by."""
    jcfg = dataclasses.replace(SMALL, history_structure=structure, history_search=mode,
                               heat_buckets=heat, history_runs=2)
    pcfg = port_cfg(jcfg)
    rng = random.Random(len(structure) + len(mode) + heat)
    single = tck.initial_state(pcfg)
    stacked = tck._stack([tck.initial_state(pcfg)])
    for i in range(3):
        b = tck.batch_from_numpy(pcfg, synth_batch(rng, jcfg, 50 + 40 * i, 30 * (i == 2)),
                                 "cpu")
        stacked, sout = tck.resolve_step_stacked(pcfg, stacked, tck._stack([b]), i == 2)
        single, out = tck.resolve_step(pcfg, single, dict(b, _gc=30 * (i == 2)), i == 2)
        for k, v in single.items():
            assert torch.equal(stacked[k][0], v), (i, k)
        assert torch.equal(sout["status"], out["status"]), i
        assert torch.equal(sout["overflow"], out["overflow"]), i
        assert torch.equal(sout["n"][0], out["n"]), i
        assert sorted(sout) == sorted(out)
        if "merged" in out:
            assert torch.equal(sout["merged"][0], out["merged"]), i
        for k, v in out.get("heat", {}).items():
            assert torch.equal(sout["heat"][k][0], v), (i, k)
