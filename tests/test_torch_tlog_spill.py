"""The tlog spill tier under the dynamic cluster: the port against the
JAX package.

Both cases of tests/test_tlog_spill.py are written once as `case(P)` and
run on both packages with the same tiny spill knob: which tlogs spilled,
their spill watermarks and memory, the rows a revived replica serves and
what the simulation leaves behind (virtual time, scheduler steps, rng
state, every disk's bytes: the tlogs' queues and spill stores; trace
events) must be equal. clean_world() resets the knob between packages.

Every compared value is an int, bytes, a string or a float computed the
same way in both packages: tolerance 0 (exact equality).
"""
import pytest

from torch_sim_world import both, clean_world, world_state

ROWS = 120
VAL = b"x" * 200


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def drive(sim, coro, until=240.0):
    return sim.run_until(sim.sched.spawn(coro), until=until)


def live_tlogs(cluster):
    return [h.__self__ for p in cluster.worker_procs for tok, h in list(p.handlers.items())
            if tok.startswith("tlog.commit")]


def storage_procs(cluster):
    return [p for p in cluster.worker_procs
            if any(t.startswith("storage.getValue") for t in p.handlers)]


def fill(db, rows=ROWS):
    async def go():
        for base in range(0, rows, 10):
            async def w(tr, base=base):
                for i in range(base, min(base + 10, rows)):
                    tr.set(b"sp/%04d" % i, VAL + b"%04d" % i)
            await db.run(w)
        return True
    return go()


def read_all(db):
    async def go():
        async def r(tr):
            return await tr.get_range(b"sp/", b"sp/\xff")
        return await db.run(r)
    return go()


WANT = [(b"sp/%04d" % i, VAL + b"%04d" % i) for i in range(ROWS)]


def case_spill_bounds_memory_with_lagging_storage(P):
    P.knobs.SERVER_KNOBS._values["tlog_spill_bytes"] = 4096
    c = P.cluster.build_dynamic_cluster(seed=81, cfg=P.cluster.DynamicClusterConfig())
    sim, db = c.sim, c.new_client()
    assert drive(sim, fill(db, 30))
    sim.run(until=sim.sched.time + 1.0)
    victim = storage_procs(c)[0]
    sim.kill_process(victim, P.simulator.KillType.KILL_INSTANTLY)
    assert drive(sim, fill(db, ROWS))
    sim.run(until=sim.sched.time + 2.0)
    spilled = [(t.spilled_version, t._mem_bytes) for t in live_tlogs(c) if t.spilled_version > 0]
    assert spilled and all(mem <= 4096 * 2 for _, mem in spilled)
    sim.revive_process(victim)
    got = drive(sim, read_all(db), until=sim.sched.time + 300.0)
    assert got == WANT
    return spilled, world_state(P, sim)


def case_spill_survives_tlog_reboot(P):
    P.knobs.SERVER_KNOBS._values["tlog_spill_bytes"] = 4096
    c = P.cluster.build_dynamic_cluster(seed=82, cfg=P.cluster.DynamicClusterConfig())
    sim, db = c.sim, c.new_client()
    assert drive(sim, fill(db, 20))
    victim = storage_procs(c)[0]
    sim.kill_process(victim, P.simulator.KillType.KILL_INSTANTLY)
    assert drive(sim, fill(db))
    sim.run(until=sim.sched.time + 2.0)
    spilled = [t.spilled_version for t in live_tlogs(c)]
    assert any(v > 0 for v in spilled)
    for p in [p for p in c.worker_procs if any(t.startswith("tlog.commit") for t in p.handlers)]:
        sim.kill_process(p, P.simulator.KillType.REBOOT)
    sim.revive_process(victim)
    got = drive(sim, read_all(db), until=sim.sched.time + 300.0)
    assert got == WANT
    return spilled, world_state(P, sim)


@pytest.mark.parametrize("case", [
    case_spill_bounds_memory_with_lagging_storage,
    case_spill_survives_tlog_reboot,
], ids=lambda f: f.__name__[len("case_"):])
def test_tlog_spill_case(case):
    port, jax_ = both(case)
    assert port == jax_
