"""Epoch recovery end to end: cluster controller election, recruitment and
the master's recovery of a new generation after a kill; the port against
the JAX package.

The cases of tests/test_recovery.py's first part (boot and first commits,
a kill of the process hosting each transaction role mid-run, determinism,
committed data surviving a tlog failover, the durable epoch lock of a
tlog) are written once as `case(P)` and run on both packages: the counter
values, the rows read, the errors and what the simulation leaves behind
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


def boot_cluster(P, seed, **kw):
    return P.cluster.build_dynamic_cluster(seed=seed, cfg=P.cluster.DynamicClusterConfig(**kw))


async def incr(tr, key=b"ctr"):
    n = int(await tr.get(key) or b"0") + 1
    tr.set(key, str(n).encode())
    return n


def worker_hosting(cluster, prefix):
    """The first worker process with a handler token starting with prefix."""
    for p in cluster.worker_procs:
        for tok in p.handlers:
            if tok.startswith(prefix):
                return p
    return None


def case_boot_and_first_commits(P):
    c = boot_cluster(P, 21)
    sim, db = c.sim, c.new_client()

    async def work():
        return [await db.run(incr) for _ in range(5)]

    got = sim.run_until(sim.sched.spawn(work(), name="w"), until=60.0)
    assert got == [1, 2, 3, 4, 5]
    return got, world_state(P, sim)


def case_kill_transaction_role_mid_run(P, victim_prefix):
    c = boot_cluster(P, 37)
    sim, db = c.sim, c.new_client()

    async def work():
        n = 0
        while n < 12:
            async def bump(tr):
                m = int(await tr.get(b"k") or b"0") + 1
                tr.set(b"k", str(m).encode())
                return m
            n = await db.run(bump)
        return n

    task = sim.sched.spawn(work(), name="w")
    sim.run(until=10.0)
    victim = worker_hosting(c, victim_prefix)
    assert victim is not None
    sim.kill_process(victim, P.simulator.KillType.REBOOT)
    got = sim.run_until(task, until=240.0)
    assert got >= 12
    return victim.address, got, world_state(P, sim)


def case_recovery_is_deterministic(P):
    def run_once(seed):
        c = boot_cluster(P, seed)
        sim, db = c.sim, c.new_client()

        async def work():
            return [await db.run(incr) for _ in range(6)]

        task = sim.sched.spawn(work(), name="w")
        sim.run(until=8.0)
        victim = worker_hosting(c, "tlog.commit")
        if victim is not None:
            sim.kill_process(victim, P.simulator.KillType.REBOOT)
        return sim.run_until(task, until=240.0), world_state(P, sim)

    first = run_once(5150)
    clean_world()
    assert run_once(5150) == first
    return first


def case_committed_data_survives_tlog_failover(P):
    c = boot_cluster(P, 77, n_tlogs=2)
    sim, db = c.sim, c.new_client()

    async def write_phase():
        async def w(tr):
            for i in range(10):
                tr.set(b"d%02d" % i, b"v%d" % i)
        await db.run(w)
        return True

    assert sim.run_until(sim.sched.spawn(write_phase(), name="wp"), until=60.0)
    victim = worker_hosting(c, "tlog.commit")
    sim.kill_process(victim, P.simulator.KillType.REBOOT)
    sim.run(until=30.0)

    async def read_phase():
        async def r(tr):
            return [await tr.get(b"d%02d" % i) for i in range(10)]
        return await db.run(r)

    got = sim.run_until(sim.sched.spawn(read_phase(), name="rp"), until=240.0)
    assert got == [b"v%d" % i for i in range(10)]
    return victim.address, got, world_state(P, sim)


def case_locked_tlog_stays_locked_across_reboot(P):
    """The epoch lock is durable: a locked replica that reboots keeps
    rejecting pushes."""
    M = P.messages
    sim = P.simulator.Simulator(seed=91)
    proc = sim.new_process("tlog-host")
    disk = sim.disk_for(proc.address)

    def commit(prev, v):
        return M.TLogCommitRequest(prev_version=prev, version=v, messages={0: []},
                                   gen_id=(1, 7), known_committed=0)

    async def push(tlog, prev, v):
        try:
            await tlog.commit(commit(prev, v))
            return "accepted"
        except P.error.FDBError as e:
            return e.name

    async def scenario():
        tlog = P.tlog.TLog(proc, gen_id=(1, 7), queue=P.disk_queue.DiskQueue(disk, "tlog-1.7.0"),
                           store_name="tlog-1.7.0")
        await tlog.persist_initial("")
        first = await push(tlog, 0, 5)
        await tlog.lock(M.TLogLockRequest())
        locked = await push(tlog, 5, 6)
        tlog.unregister()
        restored = await P.tlog.TLog.restore(proc, disk, "tlog-1.7.0.meta")
        assert restored is not None and restored.stopped
        return first, locked, await push(restored, 5, 6)

    got = sim.run_until(sim.sched.spawn(scenario(), name="s"), until=60.0)
    assert got[0] == "accepted" and "accepted" not in got[1:]
    return got, world_state(P, sim)


@pytest.mark.parametrize("case", [
    case_boot_and_first_commits,
    case_recovery_is_deterministic,
    case_committed_data_survives_tlog_failover,
    case_locked_tlog_stays_locked_across_reboot,
], ids=lambda f: f.__name__[len("case_"):])
def test_epoch_recovery_case(case):
    port, jax_ = both(case)
    assert port == jax_


@pytest.mark.parametrize("victim_prefix", [
    "master.getCommitVersion",
    "proxy.commit",
    "resolver.resolve",
    "tlog.commit",
])
def test_kill_transaction_role_mid_run(victim_prefix):
    port, jax_ = both(case_kill_transaction_role_mid_run, victim_prefix)
    assert port == jax_
