"""Restarts: the dynamic cluster finds its data after reboots; the port
against the JAX package.

Every case of tests/test_restart.py is written once as `case(P)` and run
on both packages: the rows read after each reboot and what the simulation
leaves behind (virtual time, scheduler steps, rng state, every disk's
bytes: the coordinators' registers, the tlogs' DiskQueues, the storage
engines' snapshots and WALs, torn by the kills; trace events) must be
equal. A reboot reads the records back from disk through the port's wire
registry, so a record name or registrar missing from it shows here.

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


def drive(sim, coro, until=120.0):
    return sim.run_until(sim.sched.spawn(coro), until=until)


def write_rows(db, n, prefix=b"r"):
    async def go():
        async def w(tr):
            for i in range(n):
                tr.set(prefix + b"%03d" % i, b"val%03d" % i)
        await db.run(w)
        return True
    return go()


def read_rows(db, prefix=b"r"):
    async def go():
        async def r(tr):
            return await tr.get_range(prefix, prefix + b"\xff")
        return await db.run(r)
    return go()


def rows(n):
    return [(b"r%03d" % i, b"val%03d" % i) for i in range(n)]


def case_full_cluster_reboot_finds_data(P):
    c = P.cluster.build_dynamic_cluster(seed=61, cfg=P.cluster.DynamicClusterConfig())
    sim, db = c.sim, c.new_client()
    assert drive(sim, write_rows(db, 20))
    sim.run(until=sim.sched.time + 2.0)
    for p in c.coord_procs + c.worker_procs:
        sim.kill_process(p, P.simulator.KillType.REBOOT)
    got = drive(sim, read_rows(db), until=sim.sched.time + 240.0)
    assert got == rows(20)
    return got, world_state(P, sim)


def case_storage_host_reboot_recovers_from_disk(P):
    c = P.cluster.build_dynamic_cluster(seed=62, cfg=P.cluster.DynamicClusterConfig())
    sim, db = c.sim, c.new_client()
    assert drive(sim, write_rows(db, 30))
    victim = next(p for p in c.worker_procs if any(t.startswith("storage.") for t in p.handlers))
    sim.kill_process(victim, P.simulator.KillType.REBOOT)
    got = drive(sim, read_rows(db), until=sim.sched.time + 240.0)
    assert got == rows(30)
    return victim.address, got, world_state(P, sim)


def case_all_tlogs_dead_then_reboot_recovers(P):
    c = P.cluster.build_dynamic_cluster(seed=63, cfg=P.cluster.DynamicClusterConfig())
    sim, db = c.sim, c.new_client()
    assert drive(sim, write_rows(db, 15))
    tlog_procs = [p for p in c.worker_procs
                  if any(t.startswith("tlog.commit") for t in p.handlers)]
    assert len(tlog_procs) >= 2
    for p in tlog_procs:
        sim.kill_process(p, P.simulator.KillType.REBOOT)
    got = drive(sim, read_rows(db), until=sim.sched.time + 240.0)
    assert got == rows(15)
    return [p.address for p in tlog_procs], got, world_state(P, sim)


def case_repeated_whole_cluster_reboots_deterministic(P):
    def run_once(seed):
        c = P.cluster.build_dynamic_cluster(seed=seed, cfg=P.cluster.DynamicClusterConfig())
        sim, db = c.sim, c.new_client()
        assert drive(sim, write_rows(db, 10))
        reads = []
        for _ in range(2):
            sim.run(until=sim.sched.time + 1.0)
            for p in c.coord_procs + c.worker_procs:
                sim.kill_process(p, P.simulator.KillType.REBOOT)
            reads.append(drive(sim, read_rows(db), until=sim.sched.time + 240.0))
            assert reads[-1] == rows(10)
        return reads, world_state(P, sim)

    first = run_once(64)
    clean_world()
    assert run_once(64) == first
    return first


@pytest.mark.parametrize("case", [
    case_full_cluster_reboot_finds_data,
    case_storage_host_reboot_recovers_from_disk,
    case_all_tlogs_dead_then_reboot_recovers,
    case_repeated_whole_cluster_reboots_deterministic,
], ids=lambda f: f.__name__[len("case_"):])
def test_restart_case(case):
    port, jax_ = both(case)
    assert port == jax_
