"""Storage replication: teams, read failover, the consistency check, a
replica lost for good under the dynamic cluster, and the load balancer's
queue model; the port against the JAX package.

Every case of tests/test_replication.py is written once as `case(P)` and
run on both packages: the values read, the replicas' data, the spec
results, the request counts and what the simulation leaves behind
(virtual time, scheduler steps, rng state, disks, trace events) must be
equal.

Every compared value is a bool, an int, bytes, a string or a float
computed the same way in both packages: tolerance 0 (exact equality).
"""
import dataclasses

import pytest

from torch_sim_world import both, clean_world, sims_built, world_state


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def drive(sim, coro, until):
    return sim.run_until(sim.sched.spawn(coro, name="s"), until=until)


def case_replicated_cluster_serves_and_replicates(P):
    c = P.cluster.build_cluster(seed=11, cfg=P.cluster.ClusterConfig(n_storage=2,
                                                                     storage_replication=2))
    sim = c.sim
    db = c.new_client()

    async def work():
        async def w(tr):
            for i in range(20):
                tr.set(b"%02d" % i, b"v%d" % i)
                tr.set(b"\xc0key%02d" % i, b"w%d" % i)
        await db.run(w)

        async def r(tr):
            return [await tr.get(b"%02d" % i) for i in range(20)]
        return await db.run(r)

    got = drive(sim, work(), 60.0)
    assert got == [b"v%d" % i for i in range(20)]
    sim.run(until=70.0)
    replicas = []
    for team in c.storage_teams:
        stores = [st for st in c.storages if st.tag in {t for t, _ in team}]
        v = max(st.version.get() for st in stores)
        data = [st.store.range_at(b"", b"\xff\xff", v, 1000, False)[0] for st in stores]
        assert len(stores) == 2 and data[0] == data[1] and data[0]
        replicas.append(data)
    return got, replicas, world_state(P, sim)


def case_reads_survive_replica_death(P):
    c = P.cluster.build_cluster(seed=13, cfg=P.cluster.ClusterConfig(n_storage=2,
                                                                     storage_replication=2))
    sim = c.sim
    db = c.new_client()

    async def write():
        async def w(tr):
            for i in range(10):
                tr.set(b"k%02d" % i, b"v%d" % i)
        await db.run(w)
        return True

    assert drive(sim, write(), 60.0)
    for team in c.storage_teams:
        proc = next(st.proc for st in c.storages if st.tag == team[0][0])
        sim.kill_process(proc, P.simulator.KillType.KILL_INSTANTLY)

    async def read_many():
        async def r(tr):
            return [await tr.get(b"k%02d" % i) for i in range(10)]
        out = None
        for _ in range(4):
            out = await db.run(r)
        return out

    got = drive(sim, read_many(), 120.0)
    assert got == [b"v%d" % i for i in range(10)]
    return got, world_state(P, sim)


def case_consistency_check_catches_divergence(P):
    """Corrupt one replica directly: the consistency check fails the spec."""
    W = P.workloads

    def spec(cycle):
        return P.workload.Spec(title="ccheck", workloads=[
            (cycle, {"nodes": 6, "transactions": 6}), (W.ConsistencyCheckWorkload, {})],
            cluster=P.cluster.ClusterConfig(n_storage=2, storage_replication=2), client_count=1)

    class CorruptOneReplica(W.CycleWorkload):
        name = "CorruptOneReplica"

        async def start(self, db):
            await super().start(db)
            st = self.ctx.cluster.storages[0]
            st.store.set(b"corrupt-key", b"only-on-one-replica", st.version.get())

    out = []
    for cycle in (W.CycleWorkload, CorruptOneReplica):
        clean_world()
        with sims_built(P) as sims:
            res = P.workload.run_spec(spec(cycle), 17)
        out.append((dataclasses.astuple(res), world_state(P, sims[0])))
    assert out[0][0][0] and not out[1][0][0]
    return out


def case_dynamic_cluster_survives_unrestored_storage_death(P):
    """Cycle churn with a storage replica killed and never restored
    (REBOOT_AND_DELETE wipes its disk): the counter is exact and the
    consistency check passes on the surviving replicas."""
    cfg = P.cluster.DynamicClusterConfig(n_workers=8, n_tlogs=2, n_resolvers=2, n_storage=2,
                                         storage_replication=2)
    sim = P.simulator.Simulator(31)
    cluster = P.cluster.DynamicCluster(sim, cfg)
    db = cluster.new_client()

    async def work():
        for _ in range(12):
            async def bump(tr):
                v = await tr.get(b"ctr")
                tr.set(b"ctr", str(int(v or b"0") + 1).encode())
            await db.run(bump)
            await P.loop.delay(1.0)
        return True

    task = sim.sched.spawn(work(), name="w")
    sim.run(until=6.0)
    victim = next(p for p in cluster.worker_procs
                  if any(t.startswith("storage.") for t in p.handlers))
    sim.kill_process(victim, P.simulator.KillType.REBOOT_AND_DELETE)
    assert sim.run_until(task, until=300.0)

    async def read_back():
        async def r(tr):
            return await tr.get(b"ctr")
        return await db.run(r)

    got = drive(sim, read_back(), 600.0)
    assert got == b"12"

    async def ccheck():
        ctx = P.workload.WorkloadContext(cluster, 0, 1, sim.sched.rng, {})
        return await P.workloads.ConsistencyCheckWorkload(ctx).check(cluster.new_client())

    checked = drive(sim, ccheck(), 900.0)
    assert checked
    return victim.address, got, checked, world_state(P, sim)


def case_queue_model_prefers_fast_replica(P):
    """The latency model steers reads to the faster replica and still
    explores the slow one now and then."""
    sim = P.simulator.Simulator(seed=11)
    counts = {"slow:1": 0, "fast:1": 0}
    LAT = {"slow:1": 0.050, "fast:1": 0.002}

    class FakeNet:
        def request(self, src, ep, payload, priority, timeout=None):
            counts[ep.address] += 1
            f = P.loop.Future()
            sim.sched.at(sim.sched.time + LAT[ep.address],
                         lambda: (not f.is_ready) and f._set(b"ok"),
                         P.loop.TaskPriority.DEFAULT_ENDPOINT)
            return f

    db = P.database.Database(FakeNet(), "client")

    async def go():
        for _ in range(40):
            assert await db.storage_request(["slow:1", "fast:1"], "tok", None,
                                            hedge=False) == b"ok"
        return True

    assert drive(sim, go(), 60.0)
    assert counts["fast:1"] > counts["slow:1"] * 2 and counts["slow:1"] >= 2, counts
    return counts, sim.sched.time, sim.sched.rng._r.getstate()


@pytest.mark.parametrize("case", [
    case_replicated_cluster_serves_and_replicates,
    case_reads_survive_replica_death,
    case_consistency_check_catches_divergence,
    case_dynamic_cluster_survives_unrestored_storage_death,
    case_queue_model_prefers_fast_replica,
], ids=lambda f: f.__name__[len("case_"):])
def test_replication_case(case):
    port, jax_ = both(case)
    assert port == jax_
