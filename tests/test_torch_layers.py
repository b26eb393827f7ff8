"""The sample layers: the port's PubSub, bulk loader, read_all, Vector and
FdbSet against the JAX package's.

The cases of tests/test_layers.py, written once as `case(P)` and run on
both packages. Each case returns what its scenario read back (fetched
messages, subscriptions, loaded rows, pages, container contents), the
final keyspace and what the simulation leaves behind (virtual time,
scheduler steps, rng state, disks, trace events); the port's must equal
the JAX package's.

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


def drive(c, coro, until=180.0):
    return c.sim.run_until(c.sim.sched.spawn(coro, name="layers"), until=until)


async def keyspace(db):
    async def r(tr):
        return await tr.get_range(b"", b"\xff", limit=100_000, snapshot=True)
    return await db.run(r)


def cluster(P, seed):
    c = P.cluster.build_cluster(seed=seed, cfg=P.cluster.ClusterConfig(n_storage=2))
    return c, c.new_client()


def case_pubsub_feeds_inboxes(P):
    c, db = cluster(P, 61)
    ps = P.layers.PubSub()
    seen = []

    async def scenario():
        async def setup(tr):
            await ps.create_feed(tr, b"news")
            await ps.create_feed(tr, b"sports")
            await ps.subscribe(tr, b"alice", b"news")
            await ps.subscribe(tr, b"alice", b"sports")
            await ps.subscribe(tr, b"bob", b"news")
        await db.run(setup)

        async def post(tr):
            return [await ps.post(tr, b"news", b"n0"), await ps.post(tr, b"news", b"n1"),
                    await ps.post(tr, b"sports", b"s0")]
        seen.append(await db.run(post))
        for inbox in (b"alice", b"alice", b"bob"):
            seen.append(await db.run(lambda tr, inbox=inbox: ps.fetch(tr, inbox)))

        async def post2(tr):
            await ps.post(tr, b"news", b"n2")
        await db.run(post2)
        seen.append(await db.run(lambda tr: ps.fetch(tr, b"alice")))

        async def bad(tr):
            with pytest.raises(KeyError):
                await ps.post(tr, b"ghost", b"x")
            return "refused"
        seen.append(await db.run(bad))

        async def unsub(tr):
            await ps.unsubscribe(tr, b"alice", b"news")
            return await ps.subscriptions(tr, b"alice")
        seen.append(await db.run(unsub))
        return await keyspace(db)

    rows = drive(c, scenario())
    assert seen == [[0, 1, 0], [(b"news", 0, b"n0"), (b"news", 1, b"n1"), (b"sports", 0, b"s0")],
                    [], [(b"news", 0, b"n0"), (b"news", 1, b"n1")], [(b"news", 2, b"n2")],
                    "refused", [b"sports"]]
    return seen, rows, world_state(P, c.sim)


def case_pubsub_busy_feed_does_not_starve(P):
    c, db = cluster(P, 65)
    ps = P.layers.PubSub()
    fetched = []

    async def scenario():
        async def setup(tr):
            await ps.create_feed(tr, b"aaa")
            await ps.create_feed(tr, b"zzz")
            await ps.subscribe(tr, b"in", b"aaa")
            await ps.subscribe(tr, b"in", b"zzz")
            await ps.post(tr, b"zzz", b"rare")
        await db.run(setup)
        for _round in range(3):
            async def refill(tr):
                for _ in range(5):
                    await ps.post(tr, b"aaa", b"spam")
            await db.run(refill)
            got = await db.run(lambda tr: ps.fetch(tr, b"in", limit=4))
            fetched.append(got)
            if any(f == b"zzz" for (f, _s, _p) in got):
                return True
        return False

    assert drive(c, scenario()), "busy early feed starved the quiet one"
    return fetched, world_state(P, c.sim)


def case_bulk_load_parallel_workers(P):
    c, db = cluster(P, 62)
    rows = [(b"bulk/%05d" % i, b"v%05d" % i) for i in range(500)]

    async def scenario():
        n = await P.layers.bulk_load(db, rows, batch_size=40, workers=4)
        got = await keyspace(db)
        return n, got, await P.layers.bulk_load(db, [], workers=2)

    n, got, empty = drive(c, scenario())
    assert (n, got, empty) == (500, rows, 0)
    return n, got, world_state(P, c.sim)


def case_layer_reads_paginate(P):
    c, db = cluster(P, 64)
    s = P.layers.FdbSet(P.bindings.Subspace((b"big",)))

    async def scenario():
        async def fill(tr):
            for i in range(25):
                s.add(tr, i)
        await db.run(fill)

        async def check(tr):
            lo, hi = s.ss.range()
            rows = await P.layers_util.read_all(tr, lo, hi, page=10)   # 3 pages
            return rows, await s.members(tr)
        return await db.run(check)

    rows, members = drive(c, scenario())
    assert len(rows) == 25 and members == list(range(25))
    return rows, members, world_state(P, c.sim)


def case_vector_and_set_containers(P):
    c, db = cluster(P, 63)
    vec = P.layers.Vector(P.bindings.Subspace((b"vec",)), default=b"-")
    s = P.layers.FdbSet(P.bindings.Subspace((b"set",)))

    async def scenario():
        async def fill(tr):
            pushed = [await vec.push(tr, b"a"), await vec.push(tr, b"b")]
            vec.set(tr, 4, b"e")          # sparse: holes 2,3
            s.add(tr, "x")
            s.add(tr, 7)
            s.add(tr, "x")                # idempotent
            return pushed
        pushed = await db.run(fill)

        async def check(tr):
            out = [await vec.size(tr), await vec.get(tr, 3), await vec.items(tr),
                   await vec.pop(tr), await vec.size(tr), await vec.pop(tr), await vec.size(tr)]
            with pytest.raises(ValueError):
                await vec.items(tr, max_items=2)   # dense-read OOM guard
            out += [await s.contains(tr, "x"), await s.contains(tr, 7),
                    await s.contains(tr, "y")]
            s.discard(tr, 7)
            return out + [await s.members(tr)]
        return pushed, await db.run(check), await keyspace(db)

    pushed, out, rows = drive(c, scenario())
    assert pushed == [0, 1]
    assert out == [5, b"-", [b"a", b"b", b"-", b"-", b"e"], b"e", 4, b"-", 3,
                   True, True, False, ["x"]]
    return pushed, out, rows, world_state(P, c.sim)


@pytest.mark.parametrize("case", [
    case_pubsub_feeds_inboxes,
    case_pubsub_busy_feed_does_not_starve,
    case_bulk_load_parallel_workers,
    case_layer_reads_paginate,
    case_vector_and_set_containers,
], ids=lambda f: f.__name__[len("case_"):])
def test_layers_case(case):
    port, jax_ = both(case)
    assert port == jax_
