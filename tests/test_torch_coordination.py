"""Coordinators, coordinated state and leader election: the port against
the JAX package.

Every case of tests/test_coordination.py is written once as `case(P)` over
a package's modules and run on both packages: what each step returns
(cstate values, errors, election events and the monitored leader) and
what the simulation leaves behind (virtual time, scheduler steps, rng
state, the coordinators' disk bytes, trace events) must be equal. The
cstate's records (`DBCoreState`, `Generation`) go through the port's
wire registry onto the coordinators' SimDisks, so equal disks mean equal
record bytes.

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


def err(e):
    return (type(e).__name__, e.code, e.name)


def make_coords(P, sim, n=3):
    procs = [sim.new_process(f"coord{i}") for i in range(n)]
    servers = [P.coordination.CoordinationServer(p) for p in procs]
    return procs, servers


def run(P, sim, coro, until):
    return sim.run_until(sim.sched.spawn(coro), until=until), world_state(P, sim)


def case_cstate_read_write_roundtrip(P):
    sim = P.simulator.Simulator(seed=1)
    procs, _ = make_coords(P, sim)
    addrs = [p.address for p in procs]
    client = sim.new_process("master0")
    CS, DB = P.coordinated_state.CoordinatedState, P.coordinated_state.DBCoreState

    async def work():
        cs = CS(sim.net, client.address, addrs, salt=1)
        first = await cs.read()
        st = DB(recovery_count=1)
        await cs.set_exclusive(st)
        got = await CS(sim.net, client.address, addrs, salt=2).read()
        assert first is None and got == st
        return got.recovery_count, P.wire.dumps(got)

    return run(P, sim, work(), 30.0)


def case_cstate_survives_coordinator_minority_failure(P):
    sim = P.simulator.Simulator(seed=2)
    procs, _ = make_coords(P, sim, n=3)
    addrs = [p.address for p in procs]
    client = sim.new_process("m")
    CS, DB = P.coordinated_state.CoordinatedState, P.coordinated_state.DBCoreState

    async def work():
        cs = CS(sim.net, client.address, addrs, salt=1)
        await cs.read()
        await cs.set_exclusive(DB(recovery_count=7))
        sim.kill_process(procs[0])
        got = await CS(sim.net, client.address, addrs, salt=2).read()
        assert got.recovery_count == 7
        return P.wire.dumps(got)

    return run(P, sim, work(), 30.0)


def case_cstate_exclusive_write_conflict(P):
    """Two masters racing: the one whose read generation is superseded
    fails its write (the split-brain guard)."""
    sim = P.simulator.Simulator(seed=3)
    procs, _ = make_coords(P, sim)
    addrs = [p.address for p in procs]
    m1, m2 = sim.new_process("m1"), sim.new_process("m2")
    CS, DB = P.coordinated_state.CoordinatedState, P.coordinated_state.DBCoreState

    async def work():
        a = CS(sim.net, m1.address, addrs, salt=1)
        b = CS(sim.net, m2.address, addrs, salt=2)
        await a.read()
        await b.read()
        await b.set_exclusive(DB(recovery_count=2))
        try:
            await a.set_exclusive(DB(recovery_count=1))
        except P.error.FDBError as e:
            return err(e)
        return "written"

    out = run(P, sim, work(), 30.0)
    assert out[0] != "written"
    return out


def case_cstate_sequential_writes_survive_reordered_delivery(P, monkeypatch):
    """One master's sequential writes stay ordered on every coordinator:
    the first value's frame, stalled on one coordinator until the second
    has applied, loses there, and no quorum read resurrects it."""
    coord = P.coordination
    TP = P.loop.TaskPriority
    sim = P.simulator.Simulator(seed=7)
    DB = P.coordinated_state.DBCoreState
    v1 = DB(recovery_count=5)
    v2 = DB(recovery_count=5, generations=("new-gen-marker",))
    orig = coord.CoordinationServer._gen_write
    victim = {}

    async def reordering_write(self, req):
        if self.proc.address == victim.get("addr") and req.value == v1:
            await P.loop.delay(1.0, TP.COORDINATION)
        return await orig(self, req)

    monkeypatch.setattr(coord.CoordinationServer, "_gen_write", reordering_write)
    procs, servers = make_coords(P, sim)
    addrs = [p.address for p in procs]
    client = sim.new_process("m")
    victim["addr"] = procs[2].address

    async def work():
        cs = P.coordinated_state.CoordinatedState(sim.net, client.address, addrs, salt=1)
        await cs.read()
        await cs.set_exclusive(v1)
        await cs.set_exclusive(v2)
        await P.loop.delay(3.0)
        reg = servers[2].regs.get(P.coordinated_state.CSTATE_KEY)
        assert reg is not None and reg.value == v2, reg
        got = await P.coordinated_state.CoordinatedState(sim.net, client.address, addrs,
                                                         salt=2).read()
        assert got == v2, got
        return P.wire.dumps(got), [P.wire.dumps(s.regs[P.coordinated_state.CSTATE_KEY].value)
                                    for s in servers]

    return run(P, sim, work(), 60.0)


def case_leader_election_single_winner_and_failover(P):
    sim = P.simulator.Simulator(seed=4)
    procs, _ = make_coords(P, sim)
    addrs = [p.address for p in procs]
    c1, c2 = sim.new_process("cc1"), sim.new_process("cc2")
    LE, LeaderInfo = P.leader_election, P.coordination.LeaderInfo
    events = []

    async def candidate(proc, info):
        while True:
            await LE.try_become_leader(sim.net, proc.address, addrs, info)
            events.append(("elected", info.id, sim.sched.time))
            await LE.hold_leadership(sim.net, proc.address, addrs, info)
            events.append(("lost", info.id, sim.sched.time))

    c1.actors.add(sim.sched.spawn(candidate(c1, LeaderInfo(c1.address, id=1)), name="cand1"))
    c2.actors.add(sim.sched.spawn(candidate(c2, LeaderInfo(c2.address, id=2)), name="cand2"))
    observer = sim.new_process("obs")
    leader_var = P.actors.AsyncVar(None)
    observer.actors.add(sim.sched.spawn(
        LE.monitor_leader(sim.net, observer.address, addrs, leader_var), name="mon"))
    sim.run(until=10.0)
    held = {}
    for kind, cid, _t in events:
        held[cid] = held.get(cid, 0) + (1 if kind == "elected" else -1)
    assert {cid for cid, n in held.items() if n > 0} == {1}
    first = leader_var.get().id
    sim.kill_process(c1)
    sim.run(until=30.0)
    assert ("elected", 2) in [e[:2] for e in events] and leader_var.get().id == 2
    return events, first, leader_var.get().id, world_state(P, sim)


def case_cstate_durable_across_coordinator_reboot(P):
    """The generation registers live on each coordinator's disk: a REBOOT
    kill of every coordinator keeps the coordinated state."""
    sim = P.simulator.Simulator(seed=5)
    procs = [sim.new_process(f"coord{i}") for i in range(3)]

    def boot(simu, proc):
        async def go():
            P.coordination.CoordinationServer(proc)
        return go()

    for p in procs:
        sim._boot_fns[p.address] = boot
        sim.boot(p)
    sim.run(until=0.5)
    addrs = [p.address for p in procs]
    client = sim.new_process("m")
    CS, DB = P.coordinated_state.CoordinatedState, P.coordinated_state.DBCoreState

    async def write():
        cs = CS(sim.net, client.address, addrs, salt=1)
        await cs.read()
        await cs.set_exclusive(DB(recovery_count=3))
        return True

    assert sim.run_until(sim.sched.spawn(write()), until=30.0)
    for p in procs:
        sim.kill_process(p, P.simulator.KillType.REBOOT)
    sim.run(until=40.0)

    async def read():
        return await CS(sim.net, client.address, addrs, salt=9).read()

    got, state = run(P, sim, read(), 60.0)
    assert got is not None and got.recovery_count == 3
    return P.wire.dumps(got), state


@pytest.mark.parametrize("case", [
    case_cstate_read_write_roundtrip,
    case_cstate_survives_coordinator_minority_failure,
    case_cstate_exclusive_write_conflict,
    case_leader_election_single_winner_and_failover,
    case_cstate_durable_across_coordinator_reboot,
], ids=lambda f: f.__name__[len("case_"):])
def test_coordination_case(case):
    port, jax_ = both(case)
    assert port == jax_


def test_cstate_sequential_writes_survive_reordered_delivery(monkeypatch):
    port, jax_ = both(case_cstate_sequential_writes_survive_reordered_delivery, monkeypatch)
    assert port == jax_
