"""The port's columnar serving path on the CPU against the JAX package.

  * the native wire passes (csrc/fastpack.c via wire_pass1 and
    wire_chunk_arrays) give the JAX passes' arrays, over every valid prefix
    and every int lane, into fresh and into reused (stale) arena buffers;
  * TorchConflictEngine with the bucket ladder and chunk scans gives the
    verdicts of the same engine's general router, of JaxConflictEngine with
    the same ladder and scan sizes, and of the oracle — on multi-chunk
    batches over every bucket, with GC, too-old transactions, and batches
    that must take the general router (a long key, a range) — and the JAX
    engine's bucket_hits and scan_dispatches;
  * arena=False gives the same verdicts; the ladder helpers equal JAX's;
  * the packer's build raises without a C compiler.

Every comparison is exact.
"""
import dataclasses
import random
import shutil

import numpy as np
import pytest
import torch

from foundationdb_tpu.core.types import CommitTransaction, KeyRange
from foundationdb_tpu.ops import host_engine as jhe
from foundationdb_tpu.ops.conflict_kernel import KernelConfig
from foundationdb_tpu.ops.oracle import OracleConflictEngine
from foundationdb_tpu_torch.core import error as terror
from foundationdb_tpu_torch.native import build
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops import host_engine as the
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine

torch.set_num_threads(1)

#: T = 128 over a ladder (32, 64): three buckets, each a multiple of 32
CFG = KernelConfig(key_words=2, capacity=2048, max_txns=128, max_reads=32,
                   max_writes=32, max_point_reads=256, max_point_writes=256)
LADDER = (32, 64)
SCANS = (2, 4)
WINDOW = 8    # 4 * key_words
#: every bucket boundary straddled, multi-chunk batches (up to 7 chunks of
#: the top bucket, so scan-4, scan-2 and single units all occur)
SIZES = [31, 32, 33, 63, 64, 65, 127, 128, 129, 300, 5, 900, 40]


def port_cfg(cfg):
    fields = dataclasses.asdict(cfg)
    fields.pop("fixpoint")
    return tck.KernelConfig(**fields)


def ints(verdicts):
    return [int(v) for v in verdicts]


def point_txn(rng, v, pool=300, stale=0.0):
    """2-ish point reads and writes over a hot pool; `stale` of the
    snapshots lag far enough to be too old."""
    lag = rng.randrange(5000, 9000) if rng.random() < stale else rng.randrange(1, 1500)
    t = CommitTransaction(read_snapshot=max(0, v - lag))
    for _ in range(rng.randrange(0, 4)):
        k = b"k/%04d" % rng.randrange(pool)
        t.read_conflict_ranges.append(KeyRange(k, k + b"\x00"))
    for _ in range(rng.randrange(0, 3)):
        k = b"k/%04d" % rng.randrange(pool)
        t.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
    return t


def stream(seed, sizes=SIZES, stale=0.1, fallbacks=True):
    """(txns, now, new_oldest) batches; the GC horizon trails by ~4 batches.
    With `fallbacks`, one batch carries a long key and one a range."""
    rng = random.Random(seed)
    v, out = 1000, []
    for b, n in enumerate(sizes):
        v += 1200
        txns = [point_txn(rng, v, stale=stale) for _ in range(n)]
        if fallbacks and b == 4:
            t = txns[rng.randrange(n)]
            k = b"L" * 20
            t.write_conflict_ranges.append(KeyRange(k, k + b"\x00"))
        if fallbacks and b == 8:
            t = txns[rng.randrange(n)]
            t.read_conflict_ranges.append(KeyRange(b"k/0100", b"k/0120"))
        out.append((txns, v, max(0, v - 4 * 1200) if b % 2 else 0))
    return out


# ---------------------------------------------------------------------------
# the native wire passes
# ---------------------------------------------------------------------------

def blocks_of(txns):
    return [t.conflict_wire_block() for t in txns]


@pytest.mark.parametrize("seed", range(4))
def test_wire_passes_match_jax(seed):
    rng = random.Random(seed)
    pcfg = port_cfg(CFG)
    arena = the.HostPackArena()
    for trial in range(6):
        n = rng.randrange(1, 100)
        txns = [point_txn(rng, 10_000, stale=0.2) for _ in range(n)]
        got = the.wire_pass1(WINDOW, blocks_of(txns))
        want = jhe.wire_pass1(WINDOW, blocks_of(txns))
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        blob, offs, rp_cnt, wp_cnt = got
        skip = (np.array([rng.random() < 0.2 for _ in range(n)]) & (rp_cnt > 0)).astype(np.uint8)
        snap_rel = np.array([rng.randrange(-1, 500) for _ in range(n)], np.int32)
        eff_r = np.where(skip, 0, rp_cnt).astype(np.int32)
        t0 = rng.randrange(0, n)
        t1 = rng.randrange(t0 + 1, min(n, t0 + 40) + 1)
        now_rel, gc_rel = 700 + trial, trial % 2 * 50
        jarr = jhe.wire_chunk_arrays(CFG, blob, offs, t0, t1, skip, snap_rel, eff_r,
                                     now_rel, gc_rel)
        # into fresh buffers, then into pooled ones holding an earlier
        # chunk's stale rows
        bufs, lease = arena.lease(pcfg)
        for tarr in (the.wire_chunk_arrays(pcfg, blob, offs, t0, t1, skip, snap_rel,
                                           eff_r, now_rel, gc_rel),
                     the.wire_chunk_arrays(pcfg, blob, offs, t0, t1, skip, snap_rel,
                                           eff_r, now_rel, gc_rel, bufs=bufs)):
            assert tarr.keys() == jarr.keys()
            n_rp, n_wp = int(jarr["rp_valid"].sum()), int(jarr["wp_valid"].sum())
            prefix = {"rpb": n_rp, "rp_snap": n_rp, "rp_txn": n_rp, "wpb": n_wp, "wp_txn": n_wp}
            for k, want_arr in jarr.items():
                got_arr = tarr[k]
                assert got_arr.dtype == want_arr.dtype and got_arr.shape == want_arr.shape, k
                cut = prefix.get(k)
                if cut is None:
                    assert np.array_equal(got_arr, want_arr), k
                else:
                    assert np.array_equal(got_arr[:cut], want_arr[:cut]), k
        lease.release()


@pytest.mark.parametrize("odd", ["range", "empty_read", "long_key", "long_write"])
def test_wire_pass1_rejects_what_the_router_must_take(odd):
    rng = random.Random(3)
    txns = [point_txn(rng, 5000) for _ in range(5)]
    t = txns[2]
    if odd == "range":
        t.read_conflict_ranges.append(KeyRange(b"a", b"b"))
    elif odd == "empty_read":
        t.read_conflict_ranges.append(KeyRange(b"a", b"a"))
    elif odd == "long_key":
        t.read_conflict_ranges.append(KeyRange(b"x" * 9, b"x" * 9 + b"\x00"))
    else:
        t.write_conflict_ranges.append(KeyRange(b"y" * 30, b"y" * 30 + b"\x00"))
    assert the.wire_pass1(WINDOW, blocks_of(txns)) is None
    assert jhe.wire_pass1(WINDOW, blocks_of(txns)) is None
    eng = TorchConflictEngine(port_cfg(CFG), device="cpu")
    assert eng.columnar_pack(txns, 6000, 0) is None


# ---------------------------------------------------------------------------
# the ladder helpers
# ---------------------------------------------------------------------------

def test_ladder_helpers_match_jax():
    jeng = jhe.JaxConflictEngine(CFG, ladder=list(LADDER), scan_sizes=SCANS, heat_buckets=0)
    teng = TorchConflictEngine(port_cfg(CFG), device="cpu", ladder=LADDER, scan_sizes=SCANS,
                               heat_buckets=0)
    assert [port_cfg(b) for b in jeng.buckets] == teng.buckets
    for n in range(0, 40):
        assert teng._split_run(n) == jeng._split_run(n), n
    rng = random.Random(9)
    for _ in range(300):
        args = (rng.randrange(1, 129), rng.randrange(0, 257), rng.randrange(0, 257))
        assert teng.bucket_for(*args) == port_cfg(jeng.bucket_for(*args)), args
    single = TorchConflictEngine(port_cfg(CFG), device="cpu", heat_buckets=0)
    assert single.buckets == [port_cfg(CFG)]


def test_cpu_warmup_builds_every_program_and_captures_nothing():
    eng = TorchConflictEngine(port_cfg(CFG), device="cpu", ladder=LADDER, scan_sizes=SCANS)
    eng.warmup()
    assert sorted(eng._programs) == sorted((t, c) for t in (32, 64, 128) for c in (1, 2, 4))
    for txns, now, oldest in stream(5, sizes=[40, 300])[:2]:
        eng.resolve(txns, now, oldest)
    assert eng.perf.captures == 0
    assert len(eng._programs) == 9


def test_ensure_warm_builds_the_used_buckets():
    eng = TorchConflictEngine(port_cfg(CFG), device="cpu", ladder=LADDER, scan_sizes=SCANS)
    eng.ensure_warm()
    assert eng._programs == {}              # nothing served yet: nothing to warm
    eng.resolve(*stream(6, sizes=[20], fallbacks=False)[0])
    eng.ensure_warm()
    assert sorted(eng._programs) == [(32, 1), (32, 2), (32, 4)]
    eng.ensure_warm(used_only=False)
    assert len(eng._programs) == 9


def test_arena_pools_and_reuses_pack_sets():
    pcfg = port_cfg(CFG)
    arena = the.HostPackArena()
    arena.prefill(pcfg, 3)
    leases = [arena.lease(pcfg)[1] for _ in range(4)]
    assert arena.misses == 1                # the fourth found the pool empty
    packs = {id(lease.pack) for lease in leases}
    for lease in leases:
        lease.release()
        lease.release()                     # a second release is a no-op
    again = [arena.lease(pcfg)[1] for _ in range(4)]
    assert {id(lease.pack) for lease in again} == packs and arena.misses == 1
    bufs, _ = arena.lease(pcfg)
    assert set(bufs) >= set(the.input_shapes(pcfg)) and bufs["rpb"].shape == (pcfg.rp, pcfg.lanes)
    assert bufs["rpb"].dtype == np.uint32


# ---------------------------------------------------------------------------
# verdicts
# ---------------------------------------------------------------------------

def four_way(batches, arena=True):
    """Port columnar (ladder + scans), port general router, JAX engine with
    the same ladder and scan sizes, and the oracle, batch by batch."""
    pcfg = port_cfg(CFG)
    fast = TorchConflictEngine(pcfg, device="cpu", ladder=LADDER, scan_sizes=SCANS, arena=arena)
    router = TorchConflictEngine(pcfg, device="cpu")
    router._resolve_columnar = lambda *a: None
    jeng = jhe.JaxConflictEngine(CFG, ladder=list(LADDER), scan_sizes=SCANS, heat_buckets=0)
    ora = OracleConflictEngine()
    counts = [0, 0, 0]
    for b, (txns, now, oldest) in enumerate(batches):
        want = ints(ora.resolve(txns, now, oldest))
        assert ints(fast.resolve(txns, now, oldest)) == want, ("columnar", b)
        assert ints(router.resolve(txns, now, oldest)) == want, ("router", b)
        assert ints(jeng.resolve(txns, now, oldest)) == want, ("jax", b)
        for x in want:
            counts[x] += 1
    assert min(counts) > 0, counts
    return fast, jeng


def test_columnar_verdicts_and_counters_match_jax():
    fast, jeng = four_way(stream(11))
    assert fast.perf.bucket_hits == dict(jeng.perf.bucket_hits)
    assert fast.perf.scan_dispatches == dict(jeng.perf.scan_dispatches)
    assert all(fast.perf.bucket_hits[t] > 0 for t in (32, 64, 128))
    assert all(fast.perf.scan_dispatches.get(c, 0) > 0 for c in (1, 2, 4))
    assert fast.perf.verdicts == jeng.perf.verdicts
    assert fast._tier_has_writes           # the long key reached the host tier


def test_columnar_without_arena():
    """arena=False packs into fresh buffers per chunk: same verdicts."""
    batches = stream(12, sizes=[300, 129, 64, 900], fallbacks=False)
    pcfg = port_cfg(CFG)
    a = TorchConflictEngine(pcfg, device="cpu", ladder=LADDER, scan_sizes=SCANS, arena=False)
    b = TorchConflictEngine(pcfg, device="cpu", ladder=LADDER, scan_sizes=SCANS)
    ora = OracleConflictEngine()
    assert a.arena is None
    for txns, now, oldest in batches:
        want = ints(ora.resolve(txns, now, oldest))
        assert ints(a.resolve(txns, now, oldest)) == want
        assert ints(b.resolve(txns, now, oldest)) == want
    assert a.perf.bucket_hits == b.perf.bucket_hits


def test_general_router_chunk_then_columnar_on_one_program():
    """A range chunk writes the range rows of the top bucket's single-chunk
    program; the next columnar chunk there must see them zeroed."""
    pcfg = port_cfg(CFG)
    eng = TorchConflictEngine(pcfg, device="cpu")
    ora = OracleConflictEngine()
    rng = random.Random(4)
    v = 1000
    for b in range(6):
        v += 500
        txns = [point_txn(rng, v) for _ in range(40)]
        if b % 2 == 0:
            txns[3].write_conflict_ranges.append(KeyRange(b"k/0010", b"k/0090"))
            txns[7].read_conflict_ranges.append(KeyRange(b"k/0050", b"k/0250"))
        assert ints(eng.resolve(txns, v, 0)) == ints(ora.resolve(txns, v, 0)), b
    prog = eng._programs[(128, 1)]
    assert prog.cold_dirty == [False]
    assert not any(prog.inputs[k][0].any() for k in the.COLD_FIELDS)


def test_columnar_errors_carry_the_reference_codes():
    pcfg = port_cfg(CFG)
    eng = TorchConflictEngine(pcfg, device="cpu")
    big = CommitTransaction()
    big.write_conflict_ranges = [KeyRange(b"w%03d" % i, b"w%03d\x00" % i) for i in range(257)]
    with pytest.raises(terror.FDBError) as e:
        eng.columnar_pack([big], 10, 0)
    assert e.value.code == 2000          # one txn > caps
    tiny = dataclasses.replace(pcfg, capacity=16)
    eng = TorchConflictEngine(tiny, device="cpu")
    txns = []
    for i in range(12):
        t = CommitTransaction()
        t.write_conflict_ranges = [KeyRange(b"%02d%d" % (i, j), b"%02d%d\x00" % (i, j))
                                   for j in range(2)]
        txns.append(t)
    with pytest.raises(terror.FDBError) as e:
        eng.resolve(txns, 10, 0)
    assert e.value.code == 2101          # overflow, raised at force time


def test_packer_build_raises_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler found"):
        build.load("fastpack")
