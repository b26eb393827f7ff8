"""The storage parts of the port's static cluster against the JAX package's.

tests/test_indexedset.py, test_keyrangemap.py and test_kvstore.py (with
test_disk.py's DiskQueue cases) written once as `case(P)` over a
package's modules and run on both packages: the same operations give the
same results, and every SimDisk file holds the same bytes (durable and
pending) at the end. IndexedSet is the storage server's byte sample,
KeyRangeMap the client's location cache, DiskQueue and SSTableStore the
durable branches of the tlog and the storage server.

Every compared value is an int, bytes, a string or a float computed the
same way in both packages: tolerance 0 (exact equality).
"""
import random

import pytest

from torch_sim_world import JAX, PORT, clean_world


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def both(case, *args):
    """case(P, *args) on the port, then on JAX; returns both outcomes."""
    out = []
    for P in (PORT, JAX):
        clean_world()
        out.append(case(P, *args))
    return out


def disk_bytes(disk):
    """Every file of a SimDisk: its durable bytes and its pending writes."""
    return {n: (bytes(f.durable), list(f.pending)) for n, f in sorted(disk.files.items())}


def drive(sim, coro, until=300.0):
    return sim.run_until(sim.sched.spawn(coro), until=until)


# ---------------------------------------------------------------------------
# IndexedSet
# ---------------------------------------------------------------------------

def case_indexedset_basic_ops_and_sums(P):
    s = P.indexedset.IndexedSet()
    seen = [s.total(), len(s), s.split_key()]
    s.insert(b"b", 10)
    s.insert(b"d", 30)
    s.insert(b"a", 5)
    seen += [s.total(), len(s), s.get(b"d"), s.get(b"zz"), s.sum_below(b"d"),
             s.insert(b"d", 7), s.total(), s.erase(b"a"), s.erase(b"a"),
             list(s.items()), s.erase_range(b"a", b"z"), s.total(), len(s)]
    assert seen[3:] == [45, 3, 30, None, 15, 30, 22, 5, None, [(b"b", 10), (b"d", 7)], 17, 0, 0]
    return seen


def case_indexedset_split_key_and_prefix_sums(P):
    rng = random.Random(5)
    seen = []
    for _ in range(50):
        s = P.indexedset.IndexedSet()
        model = {}
        for _k in range(rng.randrange(1, 60)):
            k = b"%04d" % rng.randrange(200)
            w = rng.randrange(1, 500)
            s.insert(k, w)
            model[k] = w
        total, acc, want = sum(model.values()), 0, None
        for k in sorted(model):
            acc += model[k]
            if acc * 2 >= total:
                want = k
                break
        assert s.split_key() == want and s.total() == total
        seen.append((s.split_key(), s.total(), [s.sum_below(p) for p in sorted(model)[:10]]))
    return seen


def case_indexedset_degenerate_priority_chain(P):
    counter = iter(range(10 ** 9))
    orig = P.indexedset._priority
    P.indexedset._priority = lambda key: next(counter)
    try:
        s = P.indexedset.IndexedSet()
        n = 20000
        for i in range(n):
            s.insert(b"%06d" % i, 1)
        seen = [len(s), s.total(), s.sum_below(b"%06d" % (n // 2)), s.split_key(),
                s.erase(b"%06d" % 3), s.erase_range(b"%06d" % 100, b"%06d" % 15000),
                len(s), next(iter(s.items()))]
    finally:
        P.indexedset._priority = orig
    assert seen == [n, n, n // 2, b"%06d" % (n // 2 - 1), 1, 14900, n - 1 - 14900, (b"000000", 1)]
    return seen


def case_indexedset_randomized_vs_model(P):
    rng = random.Random(9)
    s = P.indexedset.IndexedSet()
    model, seen = {}, []
    for _ in range(500):
        r = rng.random()
        if r < 0.55:
            k = b"%04d" % rng.randrange(150)
            w = rng.randrange(1, 100)
            seen.append(s.insert(k, w))
            assert seen[-1] == model.get(k)
            model[k] = w
        elif r < 0.8:
            k = b"%04d" % rng.randrange(150)
            seen.append(s.erase(k))
            assert seen[-1] == model.pop(k, None)
        else:
            a, b = sorted([b"%04d" % rng.randrange(150), b"%04d" % rng.randrange(150)])
            seen.append(s.erase_range(a, b))
            assert seen[-1] == sum(v for k, v in model.items() if a <= k < b)
            for k in [k for k in model if a <= k < b]:
                del model[k]
        assert (s.total(), len(s)) == (sum(model.values()), len(model))
    assert list(s.items()) == sorted(model.items())
    return seen, list(s.items()), s.split_key()


def test_indexedset_priorities_are_equal():
    keys = [b"", b"a", b"\xff" * 9, b"key/%05d" % 77]
    assert [PORT.indexedset._priority(k) for k in keys] == [JAX.indexedset._priority(k) for k in keys]


# ---------------------------------------------------------------------------
# KeyRangeMap
# ---------------------------------------------------------------------------

def case_keyrangemap_insert_lookup_coalesce(P):
    m = P.keyrangemap.KeyRangeMap(default=None)
    seen = [m[b"anything"]]
    m.insert(b"b", b"d", "X")
    m.insert(b"f", b"h", "Y")
    seen += [m[k] for k in (b"a", b"b", b"c", b"d", b"f", b"h")]
    m.insert(b"d", b"f", "X")
    seen.append(m.range_containing(b"c"))
    m.insert(b"c", b"e", "Z")
    seen.append(list(m.ranges()))
    m.insert(b"g", None, "W")
    seen += [m[b"zzz"], m[b"g"], m[b"f"], list(m.ranges())]
    assert seen[7] == (b"b", b"f", "X")
    assert seen[8] == [(b"", b"b", None), (b"b", b"c", "X"), (b"c", b"e", "Z"),
                       (b"e", b"f", "X"), (b"f", b"h", "Y"), (b"h", None, None)]
    return seen


def case_keyrangemap_intersecting_clips(P):
    m = P.keyrangemap.KeyRangeMap(default=0)
    m.insert(b"b", b"d", 1)
    m.insert(b"d", b"f", 2)
    seen = [list(m.intersecting(b"c", b"e")), list(m.intersecting(b"x", b"x"))]
    assert seen == [[(b"c", b"d", 1), (b"d", b"e", 2)], []]
    return seen


def case_keyrangemap_randomized_vs_model(P):
    rng = random.Random(7)
    m = P.keyrangemap.KeyRangeMap(default=-1)
    points = [b"%03d" % i for i in range(60)]
    model = {p: -1 for p in points}
    seen = []
    for _ in range(300):
        a, b = sorted([b"%03d" % rng.randrange(60), b"%03d" % rng.randrange(60)])
        if a == b:
            continue
        v = rng.randrange(5)
        m.insert(a, b, v)
        for p in points:
            if a <= p < b:
                model[p] = v
        for p in rng.sample(points, 8):
            assert m[p] == model[p], p
        vals = [v2 for (_b, _e, v2) in m.ranges()]
        assert all(vals[i] != vals[i + 1] for i in range(len(vals) - 1))
        seen.append(list(m.ranges()))
    return seen


# ---------------------------------------------------------------------------
# DiskQueue
# ---------------------------------------------------------------------------

def case_disk_queue_roundtrip_and_pop(P):
    sim = P.simulator.Simulator(seed=3)
    disk = sim.disk_for("x")

    async def work():
        q = P.disk_queue.DiskQueue(disk, "q")
        assert await q.recover() == []
        offs = [await q.push(b"entry%d" % i) for i in range(5)]
        await q.commit()
        await q.pop_to(offs[1])
        entries = await P.disk_queue.DiskQueue(disk, "q").recover()
        return offs, entries

    out = drive(sim, work())
    assert [p for _, p in out[1]] == [b"entry2", b"entry3", b"entry4"]
    return out, sim.sched.time, disk_bytes(disk)


def case_disk_queue_tears_stop_at_last_commit(P):
    seen = []
    for seed in range(25):
        sim = P.simulator.Simulator(seed=seed)
        disk = sim.disk_for("x")

        async def work():
            q = P.disk_queue.DiskQueue(disk, "q")
            await q.recover()
            for i in range(3):
                await q.push(b"durable%d" % i)
            await q.commit()
            for i in range(3):
                await q.push(b"maybe%d" % i)
            return True

        drive(sim, work())
        disk.crash(sim.sched.rng)
        torn = disk_bytes(disk)

        async def recover():
            return [p for _, p in await P.disk_queue.DiskQueue(disk, "q").recover()]

        got = drive(sim, recover())
        assert got[:3] == [b"durable0", b"durable1", b"durable2"], (seed, got)
        for i, p in enumerate(got[3:]):
            assert p == b"maybe%d" % i, (seed, got)
        seen.append((got, torn, disk_bytes(disk)))
    return seen


def case_disk_queue_compaction_preserves_logical_offsets(P):
    sim = P.simulator.Simulator(seed=5)
    disk = sim.disk_for("x")

    async def work():
        q = P.disk_queue.DiskQueue(disk, "q")
        await q.recover()
        payload = b"x" * 1024
        offs = [await q.push(b"%04d" % i + payload) for i in range(200)]
        await q.commit()
        await q.pop_to(offs[149])
        q2 = P.disk_queue.DiskQueue(disk, "q")
        first = [p[:4] for _, p in await q2.recover()]
        assert first == [b"%04d" % i for i in range(150, 200)]
        await q2.pop_to(offs[151])
        after = [(o, p[:4]) for o, p in await P.disk_queue.DiskQueue(disk, "q").recover()]
        return offs, first, after

    return drive(sim, work()), sim.sched.time, disk_bytes(disk)


# ---------------------------------------------------------------------------
# SSTableStore
# ---------------------------------------------------------------------------

def model_apply(model, ops):
    for op in ops:
        if op[0] == 0:
            model[op[1]] = op[2]
        else:
            for k in [k for k in model if op[1] <= k < op[2]]:
                del model[k]


def case_kvstore_basic_set_get_clear_reopen(P):
    sim = P.simulator.Simulator(seed=3)
    disk = sim.disk_for("kv")
    SST = P.kvstore.SSTableStore

    async def work():
        st = await SST.open(disk, "db")
        st.set(b"a", b"1")
        st.set(b"b", b"2")
        st.set(b"c", b"3")
        await st.commit()
        seen = [await st.get(b"b")]
        st.clear_range(b"b", b"c")
        await st.commit()
        seen += [await st.get(b"b"), await st.get(b"c"), await st.get_range(b"", b"\xff", 10)]
        st2 = await SST.open(disk, "db")
        seen += [await st2.get(b"a"), await st2.get(b"b"), await st2.get_range(b"", b"\xff", 10)]
        return seen

    seen = drive(sim, work())
    assert seen[3] == ([(b"a", b"1"), (b"c", b"3")], False) and seen[6] == seen[3]
    return seen, sim.sched.time, disk_bytes(disk)


def case_kvstore_randomized_vs_model_with_flushes(P, seed):
    sim = P.simulator.Simulator(seed=seed)
    disk = sim.disk_for("kv")
    rng = random.Random(seed)

    async def work():
        st = await P.kvstore.SSTableStore.open(disk, "db")
        st.FLUSH_BYTES = 4096
        st.MAX_RUNS = 3
        model, seen = {}, []
        for batch in range(60):
            ops = []
            for _ in range(rng.randrange(1, 20)):
                if rng.random() < 0.8:
                    ops.append((0, b"k%04d" % rng.randrange(500),
                                (b"v%06d" % rng.randrange(10**6)) * rng.randrange(1, 4)))
                else:
                    a, b = sorted([b"k%04d" % rng.randrange(500), b"k%04d" % rng.randrange(500)])
                    ops.append((1, a, b + b"\x00"))
            for op in ops:
                if op[0] == 0:
                    st.set(op[1], op[2])
                else:
                    st.clear_range(op[1], op[2])
            model_apply(model, ops)
            await st.commit()
            if batch % 7 == 0:
                a, b = sorted([b"k%04d" % rng.randrange(500), b"k%04d" % rng.randrange(500)])
                b = b + b"\xff"
                want = sorted((k, v) for k, v in model.items() if a <= k < b)
                got, _ = await st.get_range(a, b, 10_000)
                got_r, _ = await st.get_range(a, b, 10_000, reverse=True)
                assert got == want and got_r == list(reversed(want)), batch
                for _ in range(5):
                    k = b"k%04d" % rng.randrange(500)
                    assert await st.get(k) == model.get(k), (batch, k)
                seen.append((len(st._runs), len(got)))
        want = sorted(model.items())
        page, more = await st.get_range(b"", b"\xff", 7)
        assert page == want[:7] and more == (len(want) > 7)
        st2 = await P.kvstore.SSTableStore.open(disk, "db")
        got, _ = await st2.get_range(b"", b"\xff", 100_000)
        assert got == want
        return seen, got

    return drive(sim, work(), until=3000.0), sim.sched.time, disk_bytes(disk)


def case_kvstore_crash_loses_only_unacked_batches(P, seed):
    sim = P.simulator.Simulator(seed=seed)
    disk = sim.disk_for("kv")
    rng = random.Random(seed)
    committed_states = []

    async def work():
        st = await P.kvstore.SSTableStore.open(disk, "db")
        st.FLUSH_BYTES = 2048
        st.MAX_RUNS = 3
        model = {}
        for batch in range(rng.randrange(5, 25)):
            ops = []
            for _ in range(rng.randrange(1, 10)):
                if rng.random() < 0.85:
                    ops.append((0, b"k%03d" % rng.randrange(80),
                                b"v%05d.%03d" % (rng.randrange(10**5), batch)))
                else:
                    a, b = sorted([b"k%03d" % rng.randrange(80), b"k%03d" % rng.randrange(80)])
                    ops.append((1, a, b + b"\x00"))
            for op in ops:
                if op[0] == 0:
                    st.set(op[1], op[2])
                else:
                    st.clear_range(op[1], op[2])
            model_apply(model, ops)
            await st.commit()
            committed_states.append(sorted(model.items()))
        return True

    drive(sim, work(), until=3000.0)
    disk.crash(sim.sched.rng)
    torn = disk_bytes(disk)

    async def readback():
        st = await P.kvstore.SSTableStore.open(disk, "db")
        got, _ = await st.get_range(b"", b"\xff", 100_000)
        return got

    got = drive(sim, readback(), until=3000.0)
    assert got == committed_states[-1]
    return got, torn, sim.sched.time, disk_bytes(disk)


def case_kvstore_streaming_compaction(P):
    sim = P.simulator.Simulator(seed=51)
    disk = sim.disk_for("kv")
    N = 3000
    VAL = b"v" * 64

    async def work():
        st = await P.kvstore.SSTableStore.open(disk, "db")
        st.FLUSH_BYTES = 8192
        st.MAX_RUNS = 3
        model = {}
        for i in range(N):
            k = b"k%05d" % (i % (N // 2))
            st.set(k, VAL + b"%05d" % i)
            model[k] = VAL + b"%05d" % i
            if i % 50 == 49:
                await st.commit()
        st.clear_range(b"k00100", b"k00200")
        for k in [k for k in model if b"k00100" <= k < b"k00200"]:
            del model[k]
        await st.commit()
        for _ in range(400):
            if st._compact_task is None and len(st._runs) <= st.MAX_RUNS:
                break
            await P.loop.delay(0.05)
        assert 0 < st.compact_peak_items < N // 4, st.compact_peak_items
        got, _ = await st.get_range(b"", b"\xff", 100_000)
        assert got == sorted(model.items())
        return st.compact_peak_items, got

    peak, want = drive(sim, work(), until=3000.0)
    disk.crash(sim.sched.rng)

    async def readback():
        st = await P.kvstore.SSTableStore.open(disk, "db")
        got, _ = await st.get_range(b"", b"\xff", 100_000)
        return got

    got = drive(sim, readback(), until=3000.0)
    assert got == want
    return peak, got, sim.sched.time, disk_bytes(disk)


@pytest.mark.parametrize("case", [
    case_indexedset_basic_ops_and_sums,
    case_indexedset_split_key_and_prefix_sums,
    case_indexedset_degenerate_priority_chain,
    case_indexedset_randomized_vs_model,
    case_keyrangemap_insert_lookup_coalesce,
    case_keyrangemap_intersecting_clips,
    case_keyrangemap_randomized_vs_model,
    case_disk_queue_roundtrip_and_pop,
    case_disk_queue_tears_stop_at_last_commit,
    case_disk_queue_compaction_preserves_logical_offsets,
    case_kvstore_basic_set_get_clear_reopen,
    case_kvstore_streaming_compaction,
], ids=lambda f: f.__name__[len("case_"):])
def test_storage_part(case):
    port, jax_ = both(case)
    assert port == jax_


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_kvstore_randomized_vs_model_with_flushes(seed):
    port, jax_ = both(case_kvstore_randomized_vs_model_with_flushes, seed)
    assert port == jax_


@pytest.mark.parametrize("seed", [20, 23, 27])
def test_kvstore_crash_loses_only_unacked_batches(seed):
    port, jax_ = both(case_kvstore_crash_loses_only_unacked_batches, seed)
    assert port == jax_
