"""Multiple proxies and the GRV causality confirmation: the port against
the JAX package.

Every case of tests/test_multiproxy.py is written once as `case(P)` and
run on both packages (the static cluster with 2-3 proxies, and the dynamic
cluster with 3 recruited proxies under a proxy kill): the values read,
the errors and what the simulation leaves behind (virtual time, scheduler
steps, rng state, disks, trace events) must be equal.

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


def drive(P, sim, coro, until):
    return sim.run_until(sim.sched.spawn(coro, name="s"), until=until)


def case_causal_consistency_across_proxies(P):
    """A commit acked through proxy A is visible to a transaction started
    afterwards through proxy B."""
    c = P.cluster.build_cluster(seed=23, cfg=P.cluster.ClusterConfig(n_storage=2, n_proxies=2))
    sim = c.sim
    db_a = P.database.Database(sim.net, sim.new_process("clientA").address,
                               [c.proxy_procs[0].address])
    db_b = P.database.Database(sim.net, sim.new_process("clientB").address,
                               [c.proxy_procs[1].address])

    async def scenario():
        seen = []
        for i in range(10):
            async def w(tr, i=i):
                tr.set(b"causal", b"%d" % i)
            await db_a.run(w)

            async def r(tr):
                return await tr.get(b"causal")
            seen.append(await db_b.run(r))
        return seen

    got = drive(P, sim, scenario(), 120.0)
    assert got == [b"%d" % i for i in range(10)]
    return got, world_state(P, sim)


def case_grv_stalls_when_peer_proxy_dead_static(P):
    """With a peer proxy unreachable, GRVs fail retryably instead of
    serving a maybe-stale version."""
    c = P.cluster.build_cluster(seed=29, cfg=P.cluster.ClusterConfig(n_storage=2, n_proxies=2))
    sim = c.sim
    db_a = P.database.Database(sim.net, sim.new_process("clientA").address,
                               [c.proxy_procs[0].address])

    async def warm():
        async def w(tr):
            tr.set(b"k", b"v")
        await db_a.run(w)
        return True

    assert drive(P, sim, warm(), 60.0)
    sim.kill_process(c.proxy_procs[1], P.simulator.KillType.KILL_INSTANTLY)

    async def read_once():
        tr = db_a.create_transaction()
        try:
            await tr.get_read_version()
            return "served"
        except P.error.FDBError as e:
            return ("retryable" if e.is_retryable() else "fatal", e.name)

    got = drive(P, sim, read_once(), 120.0)
    assert got[0] == "retryable"
    return got, world_state(P, sim)


def case_three_proxies_survive_proxy_kill(P):
    """Dynamic cluster with proxies=3 under a targeted proxy kill: the
    epoch turns over and the workload completes."""
    c = P.cluster.build_dynamic_cluster(seed=41, cfg=P.cluster.DynamicClusterConfig(
        n_workers=8, n_tlogs=2, n_resolvers=2, n_proxies=3, n_storage=2))
    sim = c.sim
    db = c.new_client()

    async def work():
        for _ in range(10):
            async def bump(tr):
                v = await tr.get(b"n")
                tr.set(b"n", str(int(v or b"0") + 1).encode())
            await db.run(bump)
            await P.loop.delay(1.0)
        return True

    task = sim.sched.spawn(work(), name="w")
    sim.run(until=5.0)
    victims = [p for p in c.worker_procs if any(t.startswith("proxy.commit") for t in p.handlers)]
    assert len(victims) == 3
    sim.kill_process(victims[0], P.simulator.KillType.REBOOT)
    assert sim.run_until(task, until=300.0)

    async def read_back():
        async def r(tr):
            return await tr.get(b"n")
        return await db.run(r)

    got = drive(P, sim, read_back(), 600.0)
    assert got == b"10"
    return victims[0].address, got, world_state(P, sim)


def case_commits_spread_across_proxies(P):
    """Clients pick proxies at random: with 3 proxies more than one sees
    traffic, and the counter is exact."""
    c = P.cluster.build_cluster(seed=47, cfg=P.cluster.ClusterConfig(n_storage=2, n_proxies=3))
    sim = c.sim
    db = c.new_client()

    async def work():
        for _ in range(30):
            async def bump(tr):
                v = await tr.get(b"n")
                tr.set(b"n", str(int(v or b"0") + 1).encode())
            await db.run(bump)

        async def r(tr):
            return await tr.get(b"n")
        return await db.run(r)

    got = drive(P, sim, work(), 240.0)
    assert got == b"30"
    commits = [p.stats.as_dict().get("txn_commit_in", 0) for p in c.proxies]
    assert sum(1 for n in commits if n > 0) >= 2
    return got, commits, world_state(P, sim)


@pytest.mark.parametrize("case", [
    case_causal_consistency_across_proxies,
    case_grv_stalls_when_peer_proxy_dead_static,
    case_three_proxies_survive_proxy_kill,
    case_commits_spread_across_proxies,
], ids=lambda f: f.__name__[len("case_"):])
def test_multiproxy_case(case):
    port, jax_ = both(case)
    assert port == jax_
