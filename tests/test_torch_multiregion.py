"""Multi-region: the primary datacenter dies wholesale and the dynamic
cluster fails over to the survivor; the port against the JAX package.

Every case of tests/test_multiregion.py is written once as `case(P)` and
run on both packages (two DCs, a satellite tlog outside the primary,
cross-DC storage teams, a coordinator majority outside dc0, inter-DC
latency): the rows read, the failover's virtual duration, the status
document's placement and what the simulation leaves behind (virtual time,
scheduler steps, rng state, disks, trace events, the durability oracle's
violations) must be equal.

Every compared value is an int, bytes, a string or a float computed the
same way in both packages: tolerance 0 (exact equality).
"""
import pytest

from torch_sim_world import both, clean_world, world_state

REGION_CFG = dict(n_workers=10, n_coordinators=5, n_tlogs=3, satellite_logs=1, n_resolvers=2,
                  n_storage=2, storage_replication=2, n_dcs=2, inter_dc_latency=0.003)


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def case_dc0_loss_fails_over_and_loses_nothing(P):
    c = P.cluster.build_dynamic_cluster(seed=511, cfg=P.cluster.DynamicClusterConfig(**REGION_CFG))
    sim = c.sim
    db = c.new_client()
    out = {}

    async def scenario():
        for i in range(20):
            async def w(tr, i=i):
                tr.set(b"r/%03d" % i, b"v%d" % i)
            await db.run(w)
        victims = [p for p in c.coord_procs + c.worker_procs if p.alive and p.dc_id == "dc0"]
        for p in victims:
            sim.kill_process(p, P.simulator.KillType.KILL_INSTANTLY)
        t_kill = sim.sched.time
        out["killed"] = [p.address for p in victims]

        async def rw(tr):
            got = await tr.get(b"r/000")
            assert got == b"v0", got
            tr.set(b"r/after", b"survived")
        while True:
            try:
                await db.run(rw)
                break
            except P.error.FDBError:
                await P.loop.delay(0.5)
        out["failover_seconds"] = sim.sched.time - t_kill

        async def readall(tr):
            return await tr.get_range(b"r/", b"r/\xff", limit=1000)
        out["rows"] = await db.run(readall)
        for p in victims:
            sim.revive_process(p)
        await P.loop.delay(5.0)
        out["rows_after_revive"] = await db.run(readall)
        return True

    assert sim.run_until(sim.sched.spawn(scenario(), name="region"), until=900.0)
    want = sorted([(b"r/%03d" % i, b"v%d" % i) for i in range(20)] + [(b"r/after", b"survived")])
    assert out["rows"] == want and out["rows_after_revive"] == want
    assert out["killed"] and out["failover_seconds"] < 60
    assert P.validation.violations == []
    return out, world_state(P, sim)


def case_satellite_placement_spans_dcs(P):
    c = P.cluster.build_dynamic_cluster(seed=512, cfg=P.cluster.DynamicClusterConfig(**REGION_CFG))
    sim = c.sim
    db = c.new_client()

    async def wait_status():
        while True:
            doc = await db.get_status()
            if doc and doc.get("cluster", {}).get("roles"):
                return doc
            await P.loop.delay(0.5)

    doc = sim.run_until(sim.sched.spawn(wait_status(), name="s"), until=240.0)
    by_addr = {p.address: p.dc_id for p in c.worker_procs}
    tlog_dcs = sorted({by_addr[a] for a in doc["cluster"]["roles"]["tlogs"]})
    shard_dcs = [sorted({by_addr[a] for a in sh["replicas"]}) for sh in doc["data"]["shards"]]
    assert len(tlog_dcs) == 2 and all(len(d) == 2 for d in shard_dcs)
    return doc["cluster"]["roles"], doc["data"]["shards"], world_state(P, sim)


@pytest.mark.parametrize("case", [
    case_dc0_loss_fails_over_and_loses_nothing,
    case_satellite_placement_spans_dcs,
], ids=lambda f: f.__name__[len("case_"):])
def test_multiregion_case(case):
    port, jax_ = both(case)
    assert port == jax_
