"""Continuous DR: the port's DRAgent and database lock against the JAX
package's.

The cases of tests/test_dr.py, written once as `case(P)` and run on both
packages: a DR agent streams the source's mutation-log tag into a second
cluster of the same simulation, and its switchover fences the source with
the database lock and loses nothing (writers straddling it either commit
and reach the destination, or fail with database_locked and do not); and
a locked database rejects user commits with database_locked while
lock-aware transactions pass. Each case returns both clusters' user
keyspaces, the straddlers' outcomes, the fence version and what the
simulation leaves behind (virtual time, scheduler steps, rng state, every
disk's bytes, trace events); the port's must equal the JAX package's.

Every compared value is bytes, an int, a bool, a string or a float
computed the same way in both packages: tolerance 0 (exact equality).
"""
import pytest

from torch_sim_world import both, clean_world, world_state


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def two_clusters(P, seed):
    a = P.cluster.build_dynamic_cluster(seed=seed, cfg=P.cluster.DynamicClusterConfig())
    b = P.cluster.DynamicCluster(a.sim, P.cluster.DynamicClusterConfig(
        n_workers=5, n_tlogs=2, n_resolvers=1, n_storage=2))
    return a.sim, a, b


async def read_user_keyspace(db):
    async def r(tr):
        return await tr.get_range(b"", b"\xff", limit=100_000, snapshot=True)
    return await db.run(r)


def dr_switchover(P, seed=201):
    """tests/test_dr.py's switchover scenario over package P: returns
    (committed straddlers, locked straddlers, fence version, the source's
    rows, the destination's rows, the simulation)."""
    sim, ca, cb = two_clusters(P, seed)
    db_a, db_b = ca.new_client(), cb.new_client()
    locked_code = P.error.database_locked("").code

    async def scenario():
        async def seed_rows(tr):
            for i in range(25):
                tr.set(b"pre/%03d" % i, b"v%d" % i)
            tr.set(b"ctr", (0).to_bytes(8, "little"))
        await db_a.run(seed_rows)

        async def stray(tr):
            tr.set(b"stray/x", b"1")
        await db_b.run(stray)

        agent = P.dr.DRAgent(sim, db_a, db_b)
        await agent.start(chunks=4)
        for i in range(20):
            async def w(tr, i=i):
                tr.set(b"live/%03d" % i, b"x%d" % i)
                tr.atomic_op(b"ctr", (1).to_bytes(8, "little"), P.types.MutationType.ADD_VALUE)
            await db_a.run(w)
            await P.loop.delay(0.1)

        tr = db_a.create_transaction()
        await agent.wait_for(await tr.get_read_version(), timeout=60.0)

        committed, locked = [], []

        async def straddler(i):
            async def w(tr2):
                tr2.set(b"straddle/%03d" % i, b"s%d" % i)
            try:
                await db_a.run(w)
                committed.append(i)
            except P.error.FDBError as e:
                if e.code == locked_code:
                    locked.append(i)

        tasks = [P.loop.spawn(straddler(i), name=f"straddle{i}") for i in range(10)]
        await P.loop.delay(0.05)
        fence = await agent.switchover()
        await P.actors.all_of(tasks)

        # after the switchover the source rejects user writes, the
        # destination takes them
        async def wa(tr2):
            tr2.set(b"after/a", b"1")
        with pytest.raises(P.error.FDBError) as ei:
            await db_a.run(wa)
        assert ei.value.code == locked_code

        async def wb(tr2):
            tr2.set(b"after/b", b"1")
        await db_b.run(wb)
        return (committed, locked, fence, await read_user_keyspace(db_a),
                await read_user_keyspace(db_b))

    out = sim.run_until(sim.sched.spawn(scenario(), name="dr"), until=600.0)
    return out, sim


def check_nothing_lost(committed, locked, rows_a, rows_b):
    b_map = dict(rows_b)
    for k, v in rows_a:
        assert b_map.get(k) == v, f"lost {k!r} across switchover"
    for i in committed:
        assert b_map.get(b"straddle/%03d" % i) == b"s%d" % i
    for i in locked:
        assert (b"straddle/%03d" % i) not in b_map
    assert b"stray/x" not in b_map, "destination ghost key survived DR"
    assert b_map[b"ctr"] == (20).to_bytes(8, "little")
    assert len(committed) + len(locked) == 10


def case_switchover_loses_nothing(P):
    (committed, locked, fence, rows_a, rows_b), sim = dr_switchover(P)
    check_nothing_lost(committed, locked, rows_a, rows_b)
    return (committed, locked, fence, rows_a, rows_b), world_state(P, sim)


def case_locked_database_rejects_user_commits_only(P):
    c = P.cluster.build_dynamic_cluster(seed=202, cfg=P.cluster.DynamicClusterConfig())
    db = c.new_client()
    locked_code = P.error.database_locked("").code

    async def scenario():
        async def w(tr):
            tr.set(b"k", b"1")
        await db.run(w)
        fence = await P.dr.lock_database(db)
        with pytest.raises(P.error.FDBError) as ei:
            await db.run(w)
        assert ei.value.code == locked_code

        async def mgmt(tr):
            tr.set_lock_aware()
            tr.set(b"k", b"2")
        await db.run(mgmt)

        async def r(tr):
            return await tr.get(b"k")
        while_locked = await db.run(r)
        await P.dr.unlock_database(db)
        await db.run(w)
        return fence, ei.value.code, while_locked, await db.run(r)

    out = c.sim.run_until(c.sim.sched.spawn(scenario(), name="lock"), until=240.0)
    assert out[1:] == (locked_code, b"2", b"1")
    return out, world_state(P, c.sim)


@pytest.mark.parametrize("case", [
    case_switchover_loses_nothing,
    case_locked_database_rejects_user_commits_only,
], ids=lambda f: f.__name__[len("case_"):])
def test_dr_case(case):
    port, jax_ = both(case)
    assert port == jax_
