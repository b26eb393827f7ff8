"""SubshardedConflictEngine: S key-range sub-shards on ONE device, the port
against the JAX package on the CPU.

The cases of tests/test_subsharded.py (mixed ranges over uniform, straddled
and adversarial prefix splits; long keys through the split-step path), of
tests/test_heat.py:104 (heat on and off, the shard axis folded through one
merge per chunk), tests/test_history_tiered.py:168 (tiered history on one
and two sub-shards) and tests/test_bucket_ladder.py:154 (ladder
boundaries with chunk scans): verdicts equal the oracle's and JAX's
SubshardedConflictEngine's on the same stream, heat snapshots and history
stats equal JAX's at equal heat. The heat layouts "s", "cs" and "sc" of
_merge_heat merge the same aggregates into the same snapshot as JAX's.
Every comparison is exact.
"""
import random

import numpy as np
import pytest
import torch

from foundationdb_tpu.core.keyshard import KeyShardMap as JKeyShardMap
from foundationdb_tpu.ops import host_engine as jhe
from foundationdb_tpu.ops.oracle import OracleConflictEngine
from foundationdb_tpu_torch.core.keyshard import KeyShardMap
from foundationdb_tpu_torch.ops import host_engine as the

from test_subsharded import CFG, mixed_txn
from test_torch_conflict_kernel import port_cfg

torch.set_num_threads(1)


def ints(verdicts):
    return [int(v) for v in verdicts]


def pair(cfg, splits, **kw):
    """The port's engine on the CPU and JAX's, same shards and options."""
    return (the.SubshardedConflictEngine(port_cfg(cfg), KeyShardMap(splits), device="cpu", **kw),
            jhe.SubshardedConflictEngine(cfg, JKeyShardMap(splits), **kw))


@pytest.mark.parametrize("splits", [
    [b"24"],                              # 2 sub-shards
    [b"08", b"16", b"24"],                # 4, ranges straddle
    [b"08", b"08\x00", b"2", b"240"],     # adversarial prefix splits
])
def test_subsharded_mixed_parity(splits):
    eng, jeng = pair(CFG, splits, heat_buckets=0)
    ora = OracleConflictEngine()
    rng = random.Random(sum(splits[0]))
    now, oldest = 10, 0
    for b in range(18):
        now += rng.randrange(1, 30)
        if rng.random() < 0.3:
            oldest = max(oldest, now - rng.randrange(20, 100))
        txns = [mixed_txn(rng, now) for _ in range(rng.randrange(1, 10))]
        want = ints(ora.resolve(txns, now, oldest))
        assert ints(eng.resolve(txns, now, oldest)) == want, b
        assert ints(jeng.resolve(txns, now, oldest)) == want, b
    assert eng.stack == len(splits) + 1 and eng.state["hkeys"].shape[0] == eng.stack


def test_subsharded_long_key_split_step():
    """Long keys force the split-step path (detect / fix / apply stacked)."""
    from test_long_keys import CFG as LK_CFG, random_stream

    eng, jeng = pair(LK_CFG, [b"L/", b"b/", b"s/"])
    ora = OracleConflictEngine()
    for txns, now, oldest in random_stream(7, n_batches=8):
        want = ints(ora.resolve(txns, now, oldest))
        assert ints(eng.resolve(txns, now, oldest)) == want, now
        assert ints(jeng.resolve(txns, now, oldest)) == want, now


def test_heat_parity_subsharded():
    """tests/test_heat.py:104: heat on and off give the oracle's verdicts,
    one merge per chunk folds the shard axis (verdict totals count each
    transaction once), the capacity gauge sums the sub-shards' tables, and
    the snapshot and history stats equal JAX's engine's at equal heat."""
    from test_heat import BOUNDARY_SIZES, CFG as H_CFG, HEAT_B, drive_pair

    splits = [b"ht/00080"]
    on, jon = pair(H_CFG, splits, heat_buckets=HEAT_B)
    off = the.SubshardedConflictEngine(port_cfg(H_CFG), KeyShardMap(splits), device="cpu",
                                       heat_buckets=0)
    v_on, v_off, want = drive_pair(on, off, seed=903)
    assert v_on == v_off == want
    j_on, _, _ = drive_pair(jon, OracleConflictEngine(), seed=903)
    assert j_on == want
    assert sum(on.heat.verdict_totals.values()) == sum(len(b) for b in v_on)
    assert on.heat.batches >= len(BOUNDARY_SIZES * 2)
    assert on.heat.capacity == 2 * H_CFG.capacity
    assert on.heat_snapshot() == jon.heat_snapshot()
    assert on.history_stats_snapshot() == jon.history_stats_snapshot()


def test_tiered_dispatch_surfaces_parity():
    """tests/test_history_tiered.py:168: the sub-sharded engine serves the
    tiered history, on one sub-shard and on two, with oracle-exact
    verdicts; the run snapshots per sub-shard equal JAX's."""
    from test_history_tiered import TIERED, parity_stream

    port = {"sub1": the.SubshardedConflictEngine(port_cfg(TIERED), KeyShardMap([]),
                                                 device="cpu"),
            "sub2": the.SubshardedConflictEngine(port_cfg(TIERED), KeyShardMap([b"b"]),
                                                 device="cpu")}
    jax_ = {"jsub2": jhe.SubshardedConflictEngine(TIERED, JKeyShardMap([b"b"]))}
    parity_stream(47, {**port, **jax_}, batches=20)
    assert port["sub2"].history_structure == "tiered"
    snaps, jsnaps = port["sub2"].history_run_snapshots(), jax_["jsub2"].history_run_snapshots()
    assert len(snaps) == len(jsnaps) == 2
    for a, b in zip(snaps, jsnaps):
        assert a["nruns"] == b["nruns"]
        for (ka, va), (kb, vb) in zip(a["runs"], b["runs"]):
            assert np.array_equal(ka, kb) and np.array_equal(va, vb)
    assert port["sub2"].history_stats_snapshot() == jax_["jsub2"].history_stats_snapshot()


def test_subsharded_bucket_ladder_boundaries():
    """tests/test_bucket_ladder.py:154: ladder buckets, 2-chunk scans
    (heat layout "cs"), warmed: the oracle's verdicts, and JAX's bucket
    hits and scan dispatches."""
    from test_bucket_ladder import CFG as BL_CFG, SCAN_SIZES, boundary_stream

    eng, jeng = pair(BL_CFG, [b"bl/0080"], ladder=[64], scan_sizes=SCAN_SIZES)
    eng.warmup()
    assert sorted(eng._programs) == [(64, 1), (64, 2), (128, 1), (128, 2)]
    ora = OracleConflictEngine()
    for txns, now, oldest in boundary_stream(1803):
        want = ints(ora.resolve(txns, now, oldest))
        assert ints(eng.resolve(txns, now, oldest)) == want
        assert ints(jeng.resolve(txns, now, oldest)) == want
    assert eng.perf.scan_dispatches.get(2, 0) > 0
    assert eng.perf.bucket_hits == jeng.perf.bucket_hits
    assert eng.perf.scan_dispatches == jeng.perf.scan_dispatches
    assert eng.heat_snapshot() == jeng.heat_snapshot()


@pytest.mark.parametrize("layout", ["s", "cs", "sc"])
def test_shard_heat_layouts_merge_as_jax(layout):
    """_merge_heat's shard layouts: the same aggregates, merged by the
    port's engine and JAX's, give equal snapshots; a shard axis folds
    through one merge (verdict totals count each transaction once)."""
    from test_heat import CFG as H_CFG

    S, C, B, T = 2, 3, 8, H_CFG.max_txns
    rng = np.random.default_rng(len(layout) * 7 + ord(layout[0]))
    lead = {"s": (S,), "cs": (C, S), "sc": (S, C)}[layout]
    K = H_CFG.key_words + 1
    keys = np.sort(rng.integers(0, 1 << 20, size=lead + (B,)), axis=-1)
    bounds = np.zeros(lead + (B, K), np.uint32)
    bounds[..., 0] = keys
    bounds[..., K - 1] = 4
    # verdict counts are per chunk, replicated across the shard axis
    cnt = rng.integers(0, 50, size=(1 if layout == "s" else C,))
    per_chunk = np.stack([cnt, cnt // 2, cnt // 4, 0 * cnt], axis=-1)       # [chunks, 4]
    counts = {"s": per_chunk[0], "cs": per_chunk[:, None, :],
              "sc": per_chunk[None, :, :]}[layout]
    heat = {
        "bounds": bounds,
        "hist": rng.integers(0, 9, size=lead + (B, 3)).astype(np.int32),
        "counts": np.broadcast_to(counts, lead + (4,)).astype(np.int32).copy(),
        "occupancy": rng.integers(1, 100, size=lead).astype(np.int32),
        "wit_ver": np.full(lead + (T,), -(2 ** 30), np.int32),
        "wit_bucket": np.full(lead + (T,), -1, np.int32),
    }
    heat["wit_ver"][..., 3] = 17
    heat["wit_bucket"][..., 3] = 1
    port = the.SubshardedConflictEngine(port_cfg(H_CFG), KeyShardMap([b"m"]), device="cpu",
                                        heat_buckets=B)
    jeng = jhe.SubshardedConflictEngine(H_CFG, JKeyShardMap([b"m"]), heat_buckets=B)
    for e in (port, jeng):
        e._merge_heat(heat, version=1000, base=900, layout=layout)
    assert port.heat_snapshot() == jeng.heat_snapshot()
    assert port.heat.verdict_totals == jeng.heat.verdict_totals
    assert port.heat.batches == (C if layout != "s" else 1)


def test_make_engine_subsharded():
    cfg = port_cfg(CFG)
    eng = the.make_engine("subsharded", cfg, shards=KeyShardMap([b"1", b"2"]), device="cpu")
    assert isinstance(eng, the.SubshardedConflictEngine) and eng.name == "subsharded"
    assert eng.n_shards == eng.stack == 3
    assert eng.heat is not None and eng.heat.capacity == 3 * cfg.capacity
    assert [st["hkeys"].shape for st in eng._device_states_for_snapshot()] == \
        [(cfg.capacity, cfg.lanes)] * 3
    eng.clear(500)
    assert int(eng.state["hvers"][:, 0].max()) == 500 and int(eng.state["n"].sum()) == 3


@pytest.mark.parametrize("engine_kind", ["sharded", "subsharded"])
def test_cross_mode_parity_bucket_boundaries(engine_kind):
    """tests/test_bucket_ladder.py:284's sharded kinds: fused_sort and
    bsearch engines emit the oracle's abort sets across every bucket
    boundary and both GC cadences, the arena off on one side
    (test_bucket_ladder.py:161); the search-mode picks equal JAX's."""
    from foundationdb_tpu_torch.parallel.sharding import ShardedConflictEngine
    from test_bucket_ladder import CFG as BL_CFG, LADDER, SCAN_SIZES, gc_interleaved_stream

    def make(mode, arena=True):
        if engine_kind == "sharded":
            return ShardedConflictEngine(port_cfg(BL_CFG), KeyShardMap([b"bl/0080"]),
                                         devices=["cpu", "cpu"], ladder=LADDER,
                                         scan_sizes=SCAN_SIZES, history_search=mode,
                                         arena=arena)
        return the.SubshardedConflictEngine(port_cfg(BL_CFG), KeyShardMap([b"bl/0080"]),
                                            device="cpu", ladder=[64], scan_sizes=SCAN_SIZES,
                                            history_search=mode, arena=arena)

    fused, bsearch = make("fused_sort"), make("bsearch", arena=False)
    assert bsearch.arena is None and fused.arena is not None
    ora = OracleConflictEngine()
    for i, (txns, v, old) in enumerate(gc_interleaved_stream(7300)):
        want = ints(ora.resolve(txns, v, old))
        assert ints(bsearch.resolve(txns, v, old)) == want, i
        assert ints(fused.resolve(txns, v, old)) == want, i
    jeng = jhe.SubshardedConflictEngine(BL_CFG, JKeyShardMap([b"bl/0080"]), ladder=[64],
                                        scan_sizes=SCAN_SIZES)
    auto = make(None)
    if engine_kind == "subsharded":
        assert auto.history_search_modes() == jeng.history_search_modes()
