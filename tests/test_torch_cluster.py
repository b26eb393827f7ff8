"""The port's static cluster against the JAX package's.

Every case of tests/test_transaction_system.py is written once as
`case(P)` over a package's modules and run on both packages: the values a
client reads, the commit versions, the versionstamps and the errors it
sees, the virtual time at the end and every storage server's data (its
versioned store at its latest version, its version and its byte sample)
must be equal. The card-engine case runs the port's TorchConflictEngine on
the CPU against JaxConflictEngine at the same KernelConfig. A
coordinator-addressed Database finds the dynamic cluster's proxies through
its coordinators.

Every compared value is an int, bytes, a string or a float computed the
same way in both packages: tolerance 0 (exact equality).
"""
import struct

import pytest

from torch_sim_world import JAX, PORT, both, clean_world, world_state


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def err(e):
    return (type(e).__name__, e.code, e.name)


def storage_state(c):
    """Each storage server's data at the end of a run."""
    out = []
    for s in c.storages:
        v = s.version.get()
        out.append((s.tag, s.shard.begin, s.shard.end, v,
                    s.store.snapshot_items(v), list(s.byte_sample.items())))
    return out


def run(c, coro, until=600.0):
    """Drive `coro` to its end; the result with the run's end state."""
    task = c.sim.sched.spawn(coro)
    result = c.sim.run_until(task, until=until)
    return result, c.sim.sched.time, storage_state(c)


def case_set_and_get(P):
    c = P.cluster.build_cluster(seed=1)
    db = c.new_client()

    async def work():
        tr = db.create_transaction()
        tr.set(b"hello", b"world")
        v = await tr.commit()
        assert v > 0
        tr2 = db.create_transaction()
        return v, await tr2.get(b"hello"), await tr2.get(b"missing")

    out = run(c, work())
    assert out[0][1:] == (b"world", None)
    return out


def case_read_your_writes_overlay(P):
    c = P.cluster.build_cluster(seed=2)
    db = c.new_client()
    ADD = P.types.MutationType.ADD_VALUE

    async def work():
        seen = []
        tr = db.create_transaction()
        tr.set(b"k", b"v0")
        seen.append(await tr.commit())
        tr = db.create_transaction()
        seen.append(await tr.get(b"k"))
        tr.set(b"k", b"v1")
        seen.append(await tr.get(b"k"))
        tr.clear(b"k")
        seen.append(await tr.get(b"k"))
        tr.atomic_op(b"ctr", (5).to_bytes(8, "little"), ADD)
        seen.append(await tr.get(b"ctr"))
        seen.append(await tr.commit())
        tr = db.create_transaction()
        seen += [await tr.get(b"k"), await tr.get(b"ctr")]
        return seen

    out = run(c, work())
    five = (5).to_bytes(8, "little")
    assert [out[0][i] for i in (1, 2, 3, 4, 6, 7)] == [b"v0", b"v1", None, five, None, five]
    return out


def case_conflicting_writers_abort_and_retry(P):
    c = P.cluster.build_cluster(seed=3)
    db1, db2 = c.new_client(), c.new_client()

    async def racer(db, delta):
        async def body(tr):
            cur = await tr.get(b"counter")
            n = int.from_bytes(cur or b"\x00", "big")
            tr.set(b"counter", (n + delta).to_bytes(4, "big"))
            return tr

        tr = await db.run(body)
        return tr.committed_version

    async def work():
        tr = db1.create_transaction()
        tr.set(b"counter", (0).to_bytes(4, "big"))
        first = await tr.commit()
        t1 = c.sim.sched.spawn(racer(db1, 1))
        t2 = c.sim.sched.spawn(racer(db2, 1))
        v1, v2 = await t1, await t2
        final = await db1.create_transaction().get(b"counter")
        return first, v1, v2, final

    out = run(c, work())
    assert int.from_bytes(out[0][3], "big") == 2
    return out


def case_direct_conflict_is_not_committed(P):
    c = P.cluster.build_cluster(seed=4)
    db = c.new_client()

    async def work():
        setup = db.create_transaction()
        setup.set(b"x", b"0")
        v0 = await setup.commit()
        t1 = db.create_transaction()
        t2 = db.create_transaction()
        reads = (await t1.get(b"x"), await t2.get(b"x"))
        t1.set(b"x", b"1")
        t2.set(b"x", b"2")
        v1 = await t1.commit()
        try:
            await t2.commit()
            e2 = None
        except P.error.FDBError as e:
            e2 = err(e)
        return v0, reads, v1, e2

    out = run(c, work())
    assert out[0][3][2] == "not_committed"
    return out


def case_range_read_and_clear_across_storage_shards(P):
    c = P.cluster.build_cluster(seed=5, cfg=P.cluster.ClusterConfig(n_storage=4))
    db = c.new_client()
    keys = [bytes([b]) + b"key" for b in (10, 80, 150, 220)]

    async def work():
        tr = db.create_transaction()
        for i, k in enumerate(keys):
            tr.set(k, b"v%d" % i)
        v0 = await tr.commit()
        tr = db.create_transaction()
        got = await tr.get_range(b"", b"\xff")
        tr.clear_range(keys[1], keys[3])
        got2 = await tr.get_range(b"", b"\xff")
        v1 = await tr.commit()
        got3 = await db.create_transaction().get_range(b"", b"\xff")
        return v0, got, got2, v1, got3

    out = run(c, work())
    assert out[0][1] == [(k, b"v%d" % i) for i, k in enumerate(keys)]
    assert [k for k, _ in out[0][4]] == [keys[0], keys[3]]
    return out


def case_reverse_range_read_with_limit(P):
    c = P.cluster.build_cluster(seed=8, cfg=P.cluster.ClusterConfig(n_storage=2))
    db = c.new_client()

    async def work():
        tr = db.create_transaction()
        for b in (10, 100, 200, 240):
            tr.set(bytes([b]), b"v%d" % b)
        v = await tr.commit()
        got = await db.create_transaction().get_range(b"\x00", b"\xfe", limit=2, reverse=True)
        return v, got

    out = run(c, work())
    assert out[0][1] == [(bytes([240]), b"v240"), (bytes([200]), b"v200")]
    return out


def case_atomic_add_concurrent_no_conflicts(P):
    c = P.cluster.build_cluster(seed=6)
    db = c.new_client()

    async def adder():
        tr = db.create_transaction()
        tr.atomic_op(b"sum", (1).to_bytes(8, "little"), P.types.MutationType.ADD_VALUE)
        return await tr.commit()

    async def work():
        tasks = [c.sim.sched.spawn(adder()) for _ in range(10)]
        versions = [await t for t in tasks]
        return versions, await db.create_transaction().get(b"sum")

    out = run(c, work())
    assert int.from_bytes(out[0][1], "little") == 10
    return out


def cycle_run(c, N, prefix, width, clients, txns_per_client):
    """The Cycle workload over cluster `c`: a ring permutation of N keys
    `prefix` + a `width`-digit index, each txn rotates three links;
    returns the ring read back and the commit versions in completion
    order."""
    db = c.new_client()
    versions = []
    fmt = b"%%0%dd" % width

    def key(i):
        return prefix + fmt % i

    async def body(tr):
        r = c.sim.sched.rng.random_int(0, N)
        p1 = int(await tr.get(key(r)))
        p2 = int(await tr.get(key(p1)))
        p3 = int(await tr.get(key(p2)))
        tr.set(key(r), fmt % p2)
        tr.set(key(p1), fmt % p3)
        tr.set(key(p2), fmt % p1)
        return tr

    async def client_loop(d, n):
        for _ in range(n):
            tr = await d.run(body)
            versions.append(tr.committed_version)

    async def work():
        tr = db.create_transaction()
        for i in range(N):
            tr.set(key(i), fmt % ((i + 1) % N))
        await tr.commit()
        tasks = [c.sim.sched.spawn(client_loop(c.new_client(), txns_per_client))
                 for _ in range(clients)]
        for t in tasks:
            await t
        got = await db.create_transaction().get_range(prefix, prefix[:-1] + b"0")
        nxt = {int(k[-width:]): int(v) for k, v in got}
        seen, at = set(), 0
        for _ in range(N):
            assert at not in seen
            seen.add(at)
            at = nxt[at]
        assert at == 0 and len(got) == N  # closed ring through all N keys
        return got, versions

    return run(c, work())


def case_cycle_invariant(P, n_resolvers, n_storage):
    c = P.cluster.build_cluster(
        seed=100 + n_resolvers,
        cfg=P.cluster.ClusterConfig(n_resolvers=n_resolvers, n_storage=n_storage))
    return cycle_run(c, 8, b"cycle/", 3, 3, 10)


@pytest.mark.parametrize("n_resolvers,n_storage", [(1, 1), (2, 2), (4, 4)])
def test_cycle_invariant(n_resolvers, n_storage):
    port, jax_ = both(case_cycle_invariant, n_resolvers, n_storage)
    assert port == jax_


def test_cycle_with_card_conflict_engine_on_cpu():
    """test_cycle_with_tpu_conflict_engine's wiring: both resolvers run the
    port's TorchConflictEngine (on the CPU here) against JAX's
    JaxConflictEngine at the same KernelConfig, through the full commit
    pipeline."""
    from foundationdb_tpu.ops.conflict_kernel import KernelConfig as JaxKernelConfig
    from foundationdb_tpu.ops.host_engine import JaxConflictEngine
    from foundationdb_tpu_torch.ops.conflict_kernel import KernelConfig
    from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine

    shape = dict(key_words=4, capacity=512, max_reads=128, max_writes=128, max_txns=32)
    factories = {PORT.name: lambda: TorchConflictEngine(KernelConfig(**shape), device="cpu"),
                 JAX.name: lambda: JaxConflictEngine(JaxKernelConfig(**shape))}
    engines = {}

    def case(P):
        def factory():
            eng = factories[P.name]()
            engines.setdefault(P.name, []).append(eng)
            return eng

        c = P.cluster.build_cluster(seed=77, cfg=P.cluster.ClusterConfig(
            n_resolvers=2, n_storage=2, engine_factory=factory))
        return cycle_run(c, 6, b"c/", 2, 2, 5)

    port, jax_ = both(case)
    assert port == jax_
    assert [type(e).__name__ for e in engines[PORT.name]] == ["TorchConflictEngine"] * 2


def case_grv_sees_all_prior_commits(P):
    c = P.cluster.build_cluster(seed=9)
    db = c.new_client()

    async def work():
        seen = []
        for i in range(20):
            tr = db.create_transaction()
            tr.set(b"seq", b"%d" % i)
            v = await tr.commit()
            got = await db.create_transaction().get(b"seq")
            assert got == b"%d" % i
            seen.append((v, got))
        return seen

    return run(c, work())


def case_determinism_of_whole_cluster_run(P, seed):
    c = P.cluster.build_cluster(seed=seed)
    db = c.new_client()
    events = []

    async def work():
        for i in range(10):
            tr = db.create_transaction()
            tr.set(b"k%d" % (i % 3), b"%d" % i)
            v = await tr.commit()
            events.append((c.sim.sched.time, v))
        return True

    run(c, work())
    P.loop.set_scheduler(None)
    return events


def test_determinism_of_whole_cluster_run():
    port42, jax42 = both(case_determinism_of_whole_cluster_run, 42)
    port43, jax43 = both(case_determinism_of_whole_cluster_run, 43)
    assert port42 == jax42 and port43 == jax43
    assert port42 != port43
    clean_world()
    assert case_determinism_of_whole_cluster_run(PORT, 42) == port42


def case_versionstamped_key_and_value(P):
    c = P.cluster.build_cluster(seed=31)
    db = c.new_client()
    MT = P.types.MutationType

    async def work():
        tr = db.create_transaction()
        raw_key = b"vs/k" + b"\x00" * 10 + struct.pack("<i", 4)
        tr.atomic_op(raw_key, b"payload", MT.SET_VERSIONSTAMPED_KEY)
        raw_val = b"\x00" * 10 + b"tail" + struct.pack("<i", 0)
        tr.atomic_op(b"vs/v", raw_val, MT.SET_VERSIONSTAMPED_VALUE)
        v = await tr.commit()
        stamp = tr.get_versionstamp()
        tr2 = db.create_transaction()
        return v, stamp, await tr2.get(b"vs/k" + stamp), await tr2.get(b"vs/v")

    out = run(c, work())
    v, stamp, got_key, got_val = out[0]
    assert len(stamp) == 10 and int.from_bytes(stamp[:8], "big") == v
    assert got_key == b"payload" and got_val == stamp + b"tail"
    return out


def case_versionstamp_read_is_unreadable(P):
    c = P.cluster.build_cluster(seed=32)
    db = c.new_client()

    async def work():
        tr = db.create_transaction()
        tr.atomic_op(b"u", b"\x00" * 10 + struct.pack("<i", 0),
                     P.types.MutationType.SET_VERSIONSTAMPED_VALUE)
        try:
            await tr.get(b"u")
            return None
        except P.error.FDBError as e:
            return err(e)

    out = run(c, work())
    assert out[0][1] == 1036
    return out


def case_range_read_truncation_narrows_conflict(P):
    c = P.cluster.build_cluster(seed=33)
    db = c.new_client()

    async def work():
        setup = db.create_transaction()
        for i in range(20):
            setup.set(b"nr/%02d" % i, b"x")
        v0 = await setup.commit()
        tr = db.create_transaction()
        rows = await tr.get_range(b"nr/", b"nr0", limit=5)
        w = db.create_transaction()
        w.set(b"nr/19", b"y")
        vw = await w.commit()
        tr.set(b"nr/out", b"done")
        return v0, rows, vw, await tr.commit()   # must NOT conflict

    out = run(c, work())
    assert len(out[0][1]) == 5
    return out


def case_versionstamp_bad_offset_rejected_client_side(P):
    c = P.cluster.build_cluster(seed=33)
    tr = c.new_client().create_transaction()
    MT = P.types.MutationType
    seen = []
    for key, param, op in (
            (b"k", b"abcde", MT.SET_VERSIONSTAMPED_VALUE),
            (b"k", b"\x00" * 10 + struct.pack("<i", 7), MT.SET_VERSIONSTAMPED_VALUE),
            (b"prefix" + b"\x00" * 10 + struct.pack("<i", -1), b"v",
             MT.SET_VERSIONSTAMPED_KEY)):
        with pytest.raises(P.error.FDBError) as e:
            tr.atomic_op(key, param, op)
        seen.append(err(e.value))
    return seen


@pytest.mark.parametrize("case", [
    case_set_and_get,
    case_read_your_writes_overlay,
    case_conflicting_writers_abort_and_retry,
    case_direct_conflict_is_not_committed,
    case_range_read_and_clear_across_storage_shards,
    case_reverse_range_read_with_limit,
    case_atomic_add_concurrent_no_conflicts,
    case_grv_sees_all_prior_commits,
    case_versionstamped_key_and_value,
    case_versionstamp_read_is_unreadable,
    case_range_read_truncation_narrows_conflict,
    case_versionstamp_bad_offset_rejected_client_side,
], ids=lambda f: f.__name__[len("case_"):])
def test_transaction_system_case(case):
    port, jax_ = both(case)
    assert port == jax_


def test_storage_state_covers_every_replica():
    """The end-state comparison reads every replica of every team."""
    c = PORT.cluster.build_cluster(seed=5, cfg=PORT.cluster.ClusterConfig(
        n_storage=2, storage_replication=2))
    db = c.new_client()

    async def work():
        tr = db.create_transaction()
        tr.set(b"\x10a", b"1")
        tr.set(b"\xa0b", b"2")
        return await tr.commit()

    _, _, state = run(c, work())
    assert len(state) == 4
    assert [[kv for kv in s[4]] for s in state] == [[(b"\x10a", b"1")]] * 2 + [[(b"\xa0b", b"2")]] * 2


def test_coordinator_addressed_database_waits_for_the_dynamic_cluster():
    """A Database given only coordinator addresses (the cluster file)
    elects its view of the cluster controller, waits until the dynamic
    cluster has recovered and fetches the proxies from it: it commits and
    reads back, equal to JAX's with the same seed (values, versions,
    virtual time, disks and trace)."""
    def case(P):
        c = P.cluster.build_dynamic_cluster(seed=1)
        proc = c.sim.new_process("client-x")
        db = P.database.Database(c.sim.net, proc.address, coordinator_addrs=c.coordinators)
        assert db.proxy_addrs == []

        async def work():
            tr = db.create_transaction()
            tr.set(b"hello", b"world")
            v = await tr.commit()
            tr2 = db.create_transaction()
            return v, await tr2.get(b"hello"), list(db.proxy_addrs)

        out = c.sim.run_until(c.sim.sched.spawn(work()), until=120.0)
        assert out[1] == b"world" and out[2]
        return out, world_state(P, c.sim)

    port, jax_ = both(case)
    assert port == jax_
