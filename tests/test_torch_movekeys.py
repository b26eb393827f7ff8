"""The system keyspace and MoveKeys: shards moved transactionally between
teams of the dynamic cluster; the port against the JAX package.

Every case of tests/test_movekeys.py is written once as `case(P)` and run
on both packages: the `\\xff/keyServers/` rows, the move and exclude
replies, the values read, the errors and what the simulation leaves behind
(virtual time, scheduler steps, rng state, disks, trace events) must be
equal.

Every compared value is an int, bytes, a string or a float computed the
same way in both packages: tolerance 0 (exact equality).
"""
import pytest

from torch_sim_world import both, clean_world, world_state


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def endpoint(P, cluster, prefix):
    for p in cluster.worker_procs:
        for tok in p.handlers:
            if tok.startswith(prefix):
                return P.network.Endpoint(p.address, tok)
    return None


def storage_addrs(cluster):
    return {p.address for p in cluster.worker_procs
            if any(t.startswith("storage.getValue") for t in p.handlers)}


def boot(P, seed, **kw):
    cfg = dict(n_workers=9, n_tlogs=2, n_resolvers=2, n_storage=2)
    cfg.update(kw)
    return P.cluster.build_dynamic_cluster(seed=seed, cfg=P.cluster.DynamicClusterConfig(**cfg))


def move(P, sim, db, ep, begin, dest, timeout):
    return sim.net.request(db.client_addr, ep,
                           P.masterserver.MoveShardRequest(begin=begin, dest_workers=dest),
                           P.loop.TaskPriority.MOVE_KEYS, timeout=timeout)


def case_key_servers_seeded(P):
    c = boot(P, 61)
    sim, db, sk = c.sim, c.new_client(), P.system_keys

    async def read_meta():
        async def r(tr):
            return await tr.get_range(sk.KEY_SERVERS_PREFIX, sk.KEY_SERVERS_PREFIX + b"\xff")
        for _ in range(100):
            rows = await db.run(r)
            if len(rows) >= 2:
                return rows
            await P.loop.delay(0.5)
        return []

    rows = sim.run_until(sim.sched.spawn(read_meta()), until=120.0)
    decoded = [(sk.shard_begin_of(k), sk.decode_key_servers(v)) for k, v in rows]
    assert len(rows) == 2 and decoded[0][0] == b""
    assert all(len(team) == 1 and extra == () for _, (team, extra) in decoded)
    return rows, decoded, world_state(P, sim)


def case_move_shard_end_to_end(P):
    c = boot(P, 67)
    sim, db = c.sim, c.new_client()

    async def scenario():
        async def w(tr):
            for i in range(30):
                tr.set(b"k%03d" % i, b"v%d" % i)
        await db.run(w)
        ep = endpoint(P, c, P.masterserver.MOVE_SHARD_TOKEN)
        before = storage_addrs(c)
        free = [p.address for p in c.worker_procs if p.alive and p.address not in before][:1]
        assert ep is not None and free
        reply = await move(P, sim, db, ep, b"", free, 120.0)
        assert reply["team"][0][1] == free[0]

        async def r(tr):
            return [await tr.get(b"k%03d" % i) for i in range(30)]
        got = await db.run(r)

        async def w2(tr):
            tr.set(b"k000", b"after-move")
        await db.run(w2)

        async def r2(tr):
            return await tr.get(b"k000")
        return reply, got, await db.run(r2), free[0]

    reply, got, after, new_addr = sim.run_until(sim.sched.spawn(scenario()), until=600.0)
    sim.run(until=610.0)
    assert got == [b"v%d" % i for i in range(30)] and after == b"after-move"
    assert new_addr in storage_addrs(c)
    return reply, got, after, sorted(storage_addrs(c)), world_state(P, sim)


def case_move_shard_under_load(P):
    c = boot(P, 71)
    sim, db = c.sim, c.new_client()

    async def load():
        for _ in range(24):
            async def bump(tr):
                v = await tr.get(b"ctr")
                tr.set(b"ctr", str(int(v or b"0") + 1).encode())
            await db.run(bump)
            await P.loop.delay(0.4)
        return True

    async def mover():
        await P.loop.delay(2.0)
        ep = endpoint(P, c, P.masterserver.MOVE_SHARD_TOKEN)
        if ep is None:
            return None
        before = storage_addrs(c)
        free = [p.address for p in c.worker_procs if p.alive and p.address not in before][:1]
        return await move(P, sim, db, ep, b"", free, 240.0)

    t_load = sim.sched.spawn(load(), name="load")
    t_move = sim.sched.spawn(mover(), name="move")
    assert sim.run_until(t_load, until=600.0)
    assert t_move.is_ready and t_move.get()

    async def read_back():
        async def r(tr):
            return await tr.get(b"ctr")
        return await db.run(r)

    got = sim.run_until(sim.sched.spawn(read_back()), until=900.0)
    assert got == b"24"
    return t_move.get(), got, world_state(P, sim)


def case_move_rejects_bad_requests(P):
    c = boot(P, 73)
    sim, db = c.sim, c.new_client()

    async def scenario():
        ep = None
        for _ in range(100):
            ep = endpoint(P, c, P.masterserver.MOVE_SHARD_TOKEN)
            if ep is not None:
                break
            await P.loop.delay(0.5)
        out = {}
        try:
            await move(P, sim, db, ep, b"nope", ["x"], 30.0)
        except P.error.FDBError as e:
            out["bad_begin"] = e.name
        busy = sorted(storage_addrs(c))
        try:
            await move(P, sim, db, ep, b"", [busy[0]], 30.0)
        except P.error.FDBError as e:
            out["busy_dest"] = e.name
        return out

    got = sim.run_until(sim.sched.spawn(scenario()), until=240.0)
    assert got == {"bad_begin": "client_invalid_operation", "busy_dest": "client_invalid_operation"}
    return got, world_state(P, sim)


def case_exclude_drains_worker(P):
    c = boot(P, 79, n_workers=10)
    sim, db = c.sim, c.new_client()
    EX = P.masterserver.ExcludeServersRequest

    async def scenario():
        async def w(tr):
            for i in range(20):
                tr.set(b"x%03d" % i, b"v%d" % i)
        await db.run(w)
        ep = None
        for _ in range(100):
            ep = endpoint(P, c, P.masterserver.EXCLUDE_TOKEN)
            if ep is not None:
                break
            await P.loop.delay(0.5)
        victim = sorted(storage_addrs(c))[0]
        reply = await sim.net.request(db.client_addr, ep, EX(addresses=[victim]),
                                      P.loop.TaskPriority.MOVE_KEYS, timeout=240.0)
        assert victim in reply["excluded"] and reply["moved"]

        async def r(tr):
            return [await tr.get(b"x%03d" % i) for i in range(20)]
        got = await db.run(r)
        await P.loop.delay(2.0)
        drained = victim not in storage_addrs(c)
        reply2 = await sim.net.request(db.client_addr, ep, EX(addresses=[victim], exclude=False),
                                       P.loop.TaskPriority.MOVE_KEYS, timeout=60.0)
        assert victim not in reply2["excluded"]
        return reply, got, drained, reply2

    reply, got, drained, reply2 = sim.run_until(sim.sched.spawn(scenario()), until=900.0)
    assert got == [b"v%d" % i for i in range(20)] and drained
    return reply, got, reply2, world_state(P, sim)


@pytest.mark.parametrize("case", [
    case_key_servers_seeded,
    case_move_shard_end_to_end,
    case_move_shard_under_load,
    case_move_rejects_bad_requests,
    case_exclude_drains_worker,
], ids=lambda f: f.__name__[len("case_"):])
def test_movekeys_case(case):
    port, jax_ = both(case)
    assert port == jax_
