"""`configure` and the database configuration in `\\xff/conf/`: the port
against the JAX package.

Every case of tests/test_configure.py is written once as `case(P)` and
run on both packages: the team replication reached, the role counts the
next recovery recruits, the rows read, the errors and what the simulation
leaves behind (virtual time, scheduler steps, rng state, disks, trace
events) must be equal.

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


def drive(sim, coro, until=600.0):
    return sim.run_until(sim.sched.spawn(coro), until=until)


def case_configure_double_grows_teams_under_load(P):
    """single -> double under live load: every shard ends with 2 healthy
    replicas and the data is exact."""
    c = P.cluster.build_dynamic_cluster(seed=301, cfg=P.cluster.DynamicClusterConfig(n_workers=10))
    sim, db = c.sim, c.new_client()
    done = {"writes": 0}

    async def load():
        for i in range(60):
            async def w(tr, i=i):
                tr.set(b"cfg/%03d" % i, b"v%d" % i)
            while True:
                try:
                    await db.run(w)
                    break
                except P.error.FDBError:
                    await P.loop.delay(0.3)
            done["writes"] += 1
            await P.loop.delay(0.25)
        return True

    async def configure():
        await P.loop.delay(2.0)
        await P.management.change_configuration(db, mode="double")
        return True

    t_load = sim.sched.spawn(load(), name="load")
    t_cfg = sim.sched.spawn(configure(), name="cfg")
    assert sim.run_until(t_load, until=600.0)
    assert t_cfg.is_ready and t_cfg.get()

    async def wait_teams():
        for _ in range(240):
            doc = await db.get_status()
            shards = doc.get("data", {}).get("shards", [])
            if shards and all(s["replication"] == 2 and s["healthy"] for s in shards):
                return shards
            await P.loop.delay(1.0)
        return None

    shards = drive(sim, wait_teams(), until=sim.sched.time + 400.0)
    assert shards

    async def read_all():
        async def r(tr):
            return await tr.get_range(b"cfg/", b"cfg/\xff", limit=1000)
        return await db.run(r)

    got = drive(sim, read_all())
    assert got == [(b"cfg/%03d" % i, b"v%d" % i) for i in range(60)] and done["writes"] == 60
    return shards, got, world_state(P, sim)


def case_configure_role_counts_apply_at_next_recovery(P):
    c = P.cluster.build_dynamic_cluster(seed=302, cfg=P.cluster.DynamicClusterConfig(n_workers=8))
    sim, db = c.sim, c.new_client()

    async def scenario():
        async def w(tr):
            tr.set(b"k", b"v")
        await db.run(w)
        await P.management.change_configuration(db, proxies=2, resolvers=1)
        for _ in range(240):
            doc = await db.get_status()
            roles = (doc or {}).get("cluster", {}).get("roles")
            if roles and len(roles.get("proxies", [])) == 2 \
                    and len(roles.get("resolvers", [])) == 1:
                async def r(tr):
                    return await tr.get(b"k")
                return roles, await db.run(r)
            await P.loop.delay(1.0)
        return None

    got = drive(sim, scenario())
    assert got is not None and got[1] == b"v"
    return got, world_state(P, sim)


def case_configure_rejects_unknown_keys(P):
    c = P.cluster.build_dynamic_cluster(seed=303, cfg=P.cluster.DynamicClusterConfig())
    sim, db = c.sim, c.new_client()

    async def scenario():
        out = []
        for kw in ({"bogus": 3}, {"mode": "quadruple"}):
            try:
                await P.management.change_configuration(db, **kw)
                out.append("accepted")
            except P.error.FDBError as e:
                out.append((e.code, e.name))
        return out

    got = drive(sim, scenario(), until=120.0)
    assert "accepted" not in got
    return got, world_state(P, sim)


@pytest.mark.parametrize("case", [
    case_configure_double_grows_teams_under_load,
    case_configure_role_counts_apply_at_next_recovery,
    case_configure_rejects_unknown_keys,
], ids=lambda f: f.__name__[len("case_"):])
def test_configure_case(case):
    port, jax_ = both(case)
    assert port == jax_
