"""The port's deterministic simulator against the JAX package's.

Every scenario of tests/test_sim_core.py that runs on the simulator alone
(scheduler, futures, combinators, network, kill / clog / partition /
reboot, the durability oracle) is written once as `case(P)` over a
package's modules and run on both packages: the results must be equal.
`trace_of_world(seed)` — a multi-actor run with faults — gives the same
(time, process, reply) trace in both packages for the same seed, so a
seed replays the same world whichever package runs it. SimDisk's crash
semantics, the gauge sampler and the slow-task profiler's default follow.

Every compared value is an int, a string, bytes or a float computed the
same way: tolerance 0. Excluded: the slow-task profiler's wall seconds.
"""
import pytest

from torch_sim_world import BOTH, JAX, PORT, clean_world


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def err(e):
    return (type(e).__name__, e.code, e.name)


# ---------------------------------------------------------------------------
# scheduler, futures and combinators
# ---------------------------------------------------------------------------

def case_virtual_time_and_delay_ordering(P):
    s = P.loop.Scheduler(seed=1)
    P.loop.set_scheduler(s)
    trace = []

    async def actor(name, dt):
        await s.delay(dt)
        trace.append((name, s.time))

    s.spawn(actor("b", 2.0))
    s.spawn(actor("a", 1.0))
    s.run()
    assert trace == [("a", 1.0), ("b", 2.0)]
    return trace, s.tasks_run


def case_priority_breaks_ties_at_equal_time(P):
    s = P.loop.Scheduler(seed=1)
    P.loop.set_scheduler(s)
    trace = []

    async def lo():
        await s.delay(1.0, P.loop.TaskPriority.LOW)
        trace.append("lo")

    async def hi():
        await s.delay(1.0, P.loop.TaskPriority.PROXY_COMMIT)
        trace.append("hi")

    s.spawn(lo())
    s.spawn(hi())
    s.run()
    assert trace == ["hi", "lo"]
    return trace


def case_same_priority_fifo(P):
    s = P.loop.Scheduler(seed=1)
    P.loop.set_scheduler(s)
    trace = []

    async def actor(n):
        trace.append(n)

    for i in range(5):
        s.spawn(actor(i))
    s.run()
    assert trace == [0, 1, 2, 3, 4]
    return trace


def case_future_error_propagates_through_await(P):
    s = P.loop.Scheduler(seed=1)
    P.loop.set_scheduler(s)
    p = P.loop.Promise()

    async def reader():
        return await p.future

    t = s.spawn(reader())

    async def failer():
        await s.delay(0.5)
        p.send_error(P.error.not_committed())

    s.spawn(failer())
    s.run()
    assert t.is_error
    with pytest.raises(P.error.FDBError, match="not_committed") as e:
        t.get()
    return err(e.value), s.time


def case_task_cancel_releases_waiters(P):
    s = P.loop.Scheduler(seed=1)
    P.loop.set_scheduler(s)

    async def hangs():
        await P.loop.Future()

    t = s.spawn(hangs())
    s.run()
    assert not t.is_ready
    t.cancel()
    assert t.is_error
    with pytest.raises(P.error.OperationCancelled) as e:
        t.get()
    return err(e.value)


def case_cancel_forces_through_swallowed_cancellation(P):
    s = P.loop.Scheduler(seed=1)
    P.loop.set_scheduler(s)
    cleaned = []

    async def stubborn():
        try:
            await P.loop.Future()
        except P.error.OperationCancelled:
            cleaned.append("cleanup")
            await s.delay(1.0)
            cleaned.append("unreachable")

    t = s.spawn(stubborn())
    s.run()
    t.cancel()
    assert t.is_ready and t.is_error
    assert cleaned == ["cleanup"]
    return cleaned


def case_combinators(P):
    s = P.loop.Scheduler(seed=1)
    P.loop.set_scheduler(s)
    a, b, c = P.loop.Promise(), P.loop.Promise(), P.loop.Promise()
    all_f = P.actors.all_of([a.future, b.future, c.future])
    any_f = P.actors.any_of([a.future, b.future, c.future])
    q = P.actors.quorum([a.future, b.future, c.future], 2)

    async def do():
        await s.delay(1)
        b.send("B")
        await s.delay(1)
        a.send("A")
        await s.delay(1)
        c.send("C")

    s.spawn(do())
    s.run()
    assert all_f.get() == ["A", "B", "C"]
    assert any_f.get() == (1, "B")
    assert q.is_ready
    return all_f.get(), any_f.get(), s.time


def case_timeout_after(P):
    s = P.loop.Scheduler(seed=1)
    P.loop.set_scheduler(s)
    p = P.loop.Promise()
    t = P.actors.timeout_after(p.future, 5.0, timeout_value="timed-out")
    s.run()
    assert t.get() == "timed-out"
    return t.get(), s.time


def case_promise_stream_fifo_and_close(P):
    s = P.loop.Scheduler(seed=1)
    P.loop.set_scheduler(s)
    ps = P.actors.PromiseStream()
    got = []

    async def consumer():
        while True:
            try:
                got.append(await ps.stream.pop())
            except P.error.FDBError as e:
                got.append(e.name)
                return

    s.spawn(consumer())

    async def producer():
        for i in range(3):
            ps.send(i)
            await s.delay(0.1)
        ps.close()

    s.spawn(producer())
    s.run()
    assert got == [0, 1, 2, "end_of_stream"]
    return got


def case_notified_version_chaining(P):
    s = P.loop.Scheduler(seed=1)
    P.loop.set_scheduler(s)
    nv = P.actors.NotifiedVersion(0)
    order = []

    async def waiter(v):
        await nv.when_at_least(v)
        order.append((v, s.time))

    for v in (10, 5, 7):
        s.spawn(waiter(v))

    async def bump():
        await s.delay(1)
        nv.set(6)
        await s.delay(1)
        nv.set(10)

    s.spawn(bump())
    s.run()
    assert [v for v, _ in order] == [5, 7, 10]
    return order


def case_async_var_and_trigger(P):
    s = P.loop.Scheduler(seed=1)
    P.loop.set_scheduler(s)
    av = P.actors.AsyncVar(1)
    trig = P.actors.AsyncTrigger()
    seen = []

    async def watch():
        while True:
            await av.on_change()
            seen.append(av.get())
            if av.get() == 3:
                return

    async def pulled():
        await trig.on_trigger()
        seen.append(("trigger", s.time))

    s.spawn(watch())
    s.spawn(pulled())

    async def drive():
        await s.delay(1)
        av.set(2)
        await s.delay(1)
        av.set(2)  # no-op: same value
        av.set(3)
        trig.trigger()

    s.spawn(drive())
    s.run()
    assert seen[:2] == [2, 3]
    return seen


def case_actor_collection_and_mutex(P):
    s = P.loop.Scheduler(seed=1)
    P.loop.set_scheduler(s)
    coll = P.actors.ActorCollection()
    mutex = P.actors.AsyncMutex()
    held = []

    async def critical(n):
        async with mutex:
            held.append((n, "in", s.time))
            await s.delay(0.5)
            held.append((n, "out", s.time))

    async def boom():
        await s.delay(3.0)
        raise P.error.io_error("disk")

    for n in range(3):
        coll.add(s.spawn(critical(n)))
    coll.add(s.spawn(boom()))
    s.run()
    assert len(coll) == 0 and coll.error_future.is_error
    with pytest.raises(P.error.FDBError) as e:
        coll.error_future.get()
    return held, err(e.value)


def case_recurring_and_all_of_cancelling(P):
    s = P.loop.Scheduler(seed=1)
    P.loop.set_scheduler(s)
    ticks = []
    tick = s.spawn(P.actors.recurring(lambda: ticks.append(s.time), 0.25))

    async def fails():
        await s.delay(0.6)
        raise P.error.timed_out("x")

    async def long():
        await s.delay(10.0)
        return "never"

    long_t = s.spawn(long())
    outer = s.spawn(P.actors.all_of_cancelling([s.spawn(fails()), long_t]))
    s.run(until=1.1)
    tick.cancel()
    assert outer.is_error and long_t.is_error
    return ticks, err(long_t._error)


SCHEDULER_CASES = [case_virtual_time_and_delay_ordering, case_priority_breaks_ties_at_equal_time,
                   case_same_priority_fifo, case_future_error_propagates_through_await,
                   case_task_cancel_releases_waiters,
                   case_cancel_forces_through_swallowed_cancellation, case_combinators,
                   case_timeout_after, case_promise_stream_fifo_and_close,
                   case_notified_version_chaining, case_async_var_and_trigger,
                   case_actor_collection_and_mutex, case_recurring_and_all_of_cancelling]


@pytest.mark.parametrize("case", SCHEDULER_CASES, ids=lambda c: c.__name__[5:])
def test_scheduler_cases_equal(case):
    assert case(PORT) == case(JAX)


# ---------------------------------------------------------------------------
# network and simulator
# ---------------------------------------------------------------------------

def build_echo_world(P, seed):
    sim = P.simulator.Simulator(seed)
    server = sim.new_process("server")
    client = sim.new_process("client")

    async def echo(msg):
        return ("echo", msg)

    ep = server.register("echo", echo)
    return sim, server, client, ep


def case_request_reply_and_latency(P):
    sim, server, client, ep = build_echo_world(P, 7)
    f = sim.net.request(client.address, ep, 42)
    sim.run_until(f)
    assert f.get() == ("echo", 42)
    assert sim.sched.time > 0
    return f.get(), sim.sched.time


def case_request_to_dead_process_fails(P):
    sim, server, client, ep = build_echo_world(P, 7)
    sim.kill_process(server)
    f = sim.net.request(client.address, ep, 1)
    sim.run()
    with pytest.raises(P.error.FDBError, match="connection_failed") as e:
        f.get()
    return err(e.value), sim.sched.time


def case_kill_mid_flight_breaks_reply(P):
    sim = P.simulator.Simulator(3)
    server = sim.new_process("server")
    client = sim.new_process("client")
    started = []

    async def slow(msg):
        started.append(msg)
        await sim.sched.delay(10.0)
        return "done"

    ep = server.register("slow", slow)
    f = sim.net.request(client.address, ep, "x")

    async def killer():
        await sim.sched.delay(1.0)
        sim.kill_process(server)

    sim.sched.spawn(killer())
    sim.run()
    assert started == ["x"]
    with pytest.raises(P.error.FDBError, match="request_maybe_delivered") as e:
        f.get()
    return err(e.value), sim.sched.time


def case_clog_delays_delivery(P):
    sim, server, client, ep = build_echo_world(P, 7)
    sim.net.clog_pair(client.address, server.address, 5.0)
    f = sim.net.request(client.address, ep, 1)
    sim.run_until(f)
    assert sim.sched.time >= 5.0
    return sim.sched.time


def case_partition_strands_request(P):
    sim, server, client, ep = build_echo_world(P, 7)
    sim.net.partition(client.address, server.address)
    f = sim.net.request(client.address, ep, 1)
    g = sim.net.request(client.address, ep, 2, timeout=2.0)
    sim.run(until=60.0)
    assert not f.is_ready
    with pytest.raises(P.error.FDBError, match="request_maybe_delivered") as e:
        g.get()
    sim.net.heal_partition(client.address, server.address)
    h = sim.net.request(client.address, ep, 3)
    sim.run_until(h)
    return err(e.value), h.get(), sim.sched.time


def case_reboot_restarts_boot_fn(P):
    boots = []

    async def boot(sim, proc):
        boots.append(sim.sched.time)

        async def pong(msg):
            return "pong"

        proc.register("ping", pong)

    sim = P.simulator.Simulator(5)
    proc = sim.new_process("p", boot_fn=boot)
    client = sim.new_process("c")
    sim.run(until=0.1)
    assert len(boots) == 1
    sim.kill_process(proc, P.simulator.KillType.REBOOT)
    sim.run(until=10.0)
    assert len(boots) == 2 and proc.reboots == 1
    f = sim.net.request(client.address, P.network.Endpoint(proc.address, "ping"), None)
    sim.run_until(f)
    assert f.get() == "pong"
    return boots, f.get(), sim.sched.time


def trace_of_world(P, seed):
    """tests/test_sim_core.py's multi-actor run with faults: the
    (time, event) trace."""
    sim = P.simulator.Simulator(seed)
    trace = []
    server = sim.new_process("server")
    clients = [sim.new_process(f"c{i}") for i in range(3)]

    async def serve(msg):
        await sim.sched.delay(sim.sched.rng.random01() * 0.01)
        return msg * 2

    ep = server.register("double", serve)

    async def client_loop(c, n):
        for i in range(n):
            try:
                r = await sim.net.request(c.address, ep, i)
                trace.append((round(sim.sched.time, 9), c.name, r))
            except P.error.FDBError as e:
                trace.append((round(sim.sched.time, 9), c.name, e.name))
            await sim.sched.delay(0.05)

    for i, c in enumerate(clients):
        sim.sched.spawn(client_loop(c, 5 + i))

    async def chaos():
        await sim.sched.delay(0.12)
        sim.clog_process(clients[0], 0.2)
        await sim.sched.delay(0.2)
        sim.kill_process(server)

    sim.sched.spawn(chaos())
    sim.run(until=30.0)
    return trace


NETWORK_CASES = [case_request_reply_and_latency, case_request_to_dead_process_fails,
                 case_kill_mid_flight_breaks_reply, case_clog_delays_delivery,
                 case_partition_strands_request, case_reboot_restarts_boot_fn]


@pytest.mark.parametrize("case", NETWORK_CASES, ids=lambda c: c.__name__[5:])
def test_network_cases_equal(case):
    assert case(PORT) == case(JAX)


@pytest.mark.parametrize("seed", [1, 2, 1234, 2026])
def test_trace_of_world_equal_across_packages(seed):
    """The same seed gives the same world in both packages, and again in
    the port; another seed gives another world."""
    got = trace_of_world(PORT, seed)
    assert len(got) > 5
    assert got == trace_of_world(JAX, seed)
    assert got == trace_of_world(PORT, seed)
    assert got != trace_of_world(PORT, seed + 1)


def case_sim_validation_durability_oracle(P):
    v = P.validation
    g1, g2 = (1, 111), (1, 222)
    out = []
    v.enable()
    v.advance_max_committed(g1, 500)
    v.advance_max_committed(g1, 300)
    out.append(v.max_committed(g1))
    v.check_restored_version(g1, 500)
    v.check_restored_version(g1, 600)
    v.check_restored_version(g2, 3)
    out.append(list(v.violations))
    v.check_restored_version(g1, 499)
    out.append(list(v.violations))
    v.enable()
    v.advance_max_committed(g1, 100)
    v.check_restored_version(g1, 100)
    v.advance_max_committed(g1, 150)
    out.append(list(v.violations))
    v.enable()
    out.append((list(v.violations), v.max_committed(g1)))
    v.disable()
    v.advance_max_committed(g1, 900)
    v.check_restored_version(g1, 1)
    out.append((list(v.violations), v.max_committed(g1)))
    assert out[2] == [(g1, 499, 500)] and out[3] == [(g1, 100, 150)]
    return out


def case_sim_disk_crash_semantics(P):
    """Un-synced writes are applied, lost or torn at a crash, decided by
    the seed; synced bytes survive; renames are durable."""
    sim = P.simulator.Simulator(11)
    proc = sim.new_process("d")
    disk = sim.disk_for(proc.address)
    log = []

    async def work():
        f = disk.open("log")
        await f.write(0, b"durable-head")
        await f.sync()
        for i in range(12):
            await f.write(12 + 8 * i, b"rec%05d" % i)
        await f.truncate(60)
        for i in range(6):
            await f.write(60 + 8 * i, b"tail%04d" % i)
        log.append((sim.sched.time, f.size(), await f.read(0, 20)))
        g = disk.open("tmp")
        await g.write(0, b"snapshot")
        await g.sync()
        disk.rename("tmp", "snap")

    sim.run_until(sim.sched.spawn(work()))
    sim.kill_process(proc)
    files = {n: bytes(disk.open(n, create=False).durable) for n in disk.list()}
    with pytest.raises(P.error.FDBError, match="file_not_found") as e:
        disk.open("missing", create=False)
    return log, files, disk.exists("tmp"), err(e.value)


def case_system_monitor_emits_process_metrics(P):
    sim = P.simulator.Simulator(71)
    procs = [sim.new_process(f"p{i}") for i in range(3)]
    sim.disk_for(procs[0].address).open("f").durable.extend(b"x" * 100)
    events = []
    orig = P.trace.TraceEvent.log

    def spy(self):
        if self._event.get("Type") in ("ProcessMetrics", "MachineMetrics"):
            events.append({k: v for k, v in self._event.items() if k != "Time"})
        return orig(self)

    P.trace.TraceEvent.log = spy
    try:
        sim.start_system_monitor(interval=2.0)
        sim.kill_process(procs[2])
        sim.run(until=9.0)
    finally:
        P.trace.TraceEvent.log = orig
    assert any(e.get("DiskBytes") == 100 for e in events)
    return events


@pytest.mark.parametrize("case", [case_sim_validation_durability_oracle,
                                  case_sim_disk_crash_semantics,
                                  case_system_monitor_emits_process_metrics],
                         ids=lambda c: c.__name__[5:])
def test_simulator_cases_equal(case):
    assert case(PORT) == case(JAX)


def test_simulator_resets_the_globals_it_owns():
    """Simulator() seeds buggify from its rng, arms the durability oracle
    and the fault registry, installs its scheduler and a fresh hub, in
    both packages; the slow-task profiler (the one wall-clock read) stays
    off by default."""
    for P in BOTH:
        old_hub = P.telemetry.hub()
        P.fault.register_engine("before")
        sim = P.simulator.Simulator(3)
        assert P.loop.current_scheduler() is sim.sched
        assert P.buggify.is_enabled() and P.buggify._rng is sim.sched.rng
        assert P.validation._enabled and P.fault._recording
        assert P.fault.registered_engines() == []
        P.fault.register_engine("after")
        assert P.fault.registered_engines() == ["after"]
        assert P.telemetry.hub() is not old_hub
        assert sim.sched.slow_task_threshold == 0.0
        clean_world()


def test_slow_task_profiler_names_the_task():
    """With a threshold set, a step that burns wall time is recorded under
    its task's name (the wall seconds themselves are not compared)."""
    import time as wall

    names = []
    for P in BOTH:
        sim = P.simulator.Simulator(seed=5)
        sim.sched.slow_task_threshold = 0.02

        async def hog():
            t0 = wall.perf_counter()
            while wall.perf_counter() - t0 < 0.05:
                pass
            return True

        assert sim.run_until(sim.sched.spawn(hog(), name="cpuHog"), until=5.0)
        vt, dt, name = sim.sched.slow_tasks[-1]
        assert dt >= 0.02
        names.append((vt, name))
        clean_world()
    assert names[0] == names[1] and "cpuHog" in names[0][1]
