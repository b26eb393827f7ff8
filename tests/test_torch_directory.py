"""The directory layer: the port's DirectoryLayer against the JAX package's.

The cases of tests/test_directory.py, written once as `case(P)` and run on
both packages: the high-contention allocator draws its candidates from the
simulator's rng, so equal simulations allocate equal prefixes. Each case
returns what its scenario saw (allocated prefixes, listings, moves,
removes), the final keyspace (the directory's node subspace included) and
what the simulation leaves behind (virtual time, scheduler steps, rng
state, disks, trace events); the port's must equal the JAX package's.

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


def drive(c, coro, until=120.0):
    return c.sim.run_until(c.sim.sched.spawn(coro, name="dir"), until=until)


async def keyspace(db):
    async def r(tr):
        return await tr.get_range(b"", b"\xff", limit=100_000, snapshot=True)
    return await db.run(r)


def case_lifecycle(P):
    c = P.cluster.build_cluster(seed=51, cfg=P.cluster.ClusterConfig(n_storage=2))
    db, dl, DirectoryError = c.new_client(), P.directory.DirectoryLayer(), P.directory.DirectoryError

    async def scenario():
        async def create(tr):
            users = await dl.create_or_open(tr, ("app", "users"))
            events = await dl.create_or_open(tr, ("app", "events"), layer=b"log")
            tr.set(users.pack((42,)), b"alice")
            tr.set(events.pack((1,)), b"login")
            return users.raw_prefix, events.raw_prefix
        up, ep = await db.run(create)
        assert up != ep and not up.startswith(ep) and not ep.startswith(up)

        async def reopen(tr):
            users = await dl.open(tr, ("app", "users"))
            assert users.raw_prefix == up
            assert await tr.get(users.pack((42,))) == b"alice"
            with pytest.raises(DirectoryError):
                await dl.open(tr, ("app", "events"), layer=b"queue")
            ev = await dl.open(tr, ("app", "events"), layer=b"log")
            assert ev.raw_prefix == ep
            return sorted(await dl.list(tr, ("app",)))
        listed = await db.run(reopen)
        assert listed == ["events", "users"]

        async def guards(tr):
            with pytest.raises(DirectoryError):
                await dl.create(tr, ("app", "users"))
            with pytest.raises(DirectoryError):
                await dl.open(tr, ("nope",))
            return True
        assert await db.run(guards)
        return up, ep, listed, await keyspace(db)

    return drive(c, scenario()), world_state(P, c.sim)


def case_move_keeps_data(P):
    c = P.cluster.build_cluster(seed=53, cfg=P.cluster.ClusterConfig(n_storage=2))
    db, dl, DirectoryError = c.new_client(), P.directory.DirectoryLayer(), P.directory.DirectoryError

    async def scenario():
        async def setup(tr):
            d = await dl.create_or_open(tr, ("a", "b"))
            tr.set(d.pack(("k",)), b"v")
            return d.raw_prefix
        prefix = await db.run(setup)

        async def mv(tr):
            return (await dl.move(tr, ("a", "b"), ("c",))).raw_prefix
        moved = await db.run(mv)
        assert moved == prefix   # data never moves

        async def check(tr):
            d = await dl.open(tr, ("c",))
            assert await tr.get(d.pack(("k",))) == b"v"
            assert not await dl.exists(tr, ("a", "b"))
            with pytest.raises(DirectoryError):
                await dl.move(tr, ("c",), ("c", "inside"))
            return True
        assert await db.run(check)
        return prefix, moved, await keyspace(db)

    return drive(c, scenario()), world_state(P, c.sim)


def case_remove_subtree(P):
    c = P.cluster.build_cluster(seed=57, cfg=P.cluster.ClusterConfig(n_storage=2))
    db, dl = c.new_client(), P.directory.DirectoryLayer()

    async def scenario():
        async def setup(tr):
            d1 = await dl.create_or_open(tr, ("root", "x"))
            d2 = await dl.create_or_open(tr, ("root", "x", "y"))
            tr.set(d1.pack((1,)), b"one")
            tr.set(d2.pack((2,)), b"two")
            return d1.raw_prefix, d2.raw_prefix
        p1, p2 = await db.run(setup)
        before = await keyspace(db)

        async def rm(tr):
            return await dl.remove(tr, ("root", "x"))
        removed = await db.run(rm)
        assert removed is True

        async def check(tr):
            assert not await dl.exists(tr, ("root", "x"))
            assert not await dl.exists(tr, ("root", "x", "y"))
            assert await tr.get_range(p1, p1 + b"\xff") == []
            assert await tr.get_range(p2, p2 + b"\xff") == []
            return await dl.remove(tr, ("root", "x"))
        again = await db.run(check)
        assert again is False
        return p1, p2, before, removed, again, await keyspace(db)

    return drive(c, scenario()), world_state(P, c.sim)


def case_allocator_uniqueness_under_contention(P):
    c = P.cluster.build_cluster(seed=59, cfg=P.cluster.ClusterConfig(n_resolvers=2, n_storage=2))
    sim, dl = c.sim, P.directory.DirectoryLayer()
    prefixes = []

    async def client(cid):
        db = c.new_client()
        for i in range(6):
            async def mk(tr, i=i):
                return (await dl.create_or_open(tr, ("c%d" % cid, "d%d" % i))).raw_prefix
            prefixes.append(await db.run(mk))
        return True

    tasks = [sim.sched.spawn(client(i), name=f"alloc{i}") for i in range(4)]
    assert sim.run_until(P.actors.all_of(tasks), until=300.0)
    assert len(set(prefixes)) == len(prefixes)
    ps = sorted(prefixes)
    for a, b in zip(ps, ps[1:]):
        assert not b.startswith(a), (a, b)
    rows = sim.run_until(sim.sched.spawn(keyspace(c.new_client()), name="read"), until=400.0)
    return prefixes, rows, world_state(P, sim)


@pytest.mark.parametrize("case", [
    case_lifecycle,
    case_move_keeps_data,
    case_remove_subtree,
    case_allocator_uniqueness_under_contention,
], ids=lambda f: f.__name__[len("case_"):])
def test_directory_case(case):
    port, jax_ = both(case)
    assert port == jax_
