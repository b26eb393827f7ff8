"""The port's device-fault supervisor and injector against the JAX package's.

tests/test_fault_tolerance.py's scenarios (the state machine end to end,
the shadow rebuild, the probe's quarantine, the injector's menagerie, the
degraded pipeline window, and the serial role's typed engine exception
and duplicate wait), each written once over a package namespace
(torch_sim_world) and run on the port's stack and on the JAX stack from
the same seeds. Each run must give the JAX assertions' outcome, and the
two stacks must give equal verdicts, health transitions, stats, flight
records (digests included), journal bytes, and the simulation's random
stream, virtual time and steps after the run.

Beyond the mirror: the port's CPU TorchConflictEngine under the injector
and the supervisor equals the oracle and the JAX stack; a rewarm whose
shadow entry holds more point writes than one transaction may carry
raises client_invalid_operation in both packages alike (the reference's
behaviour, kept).

Verdicts are exact: tolerance 0 everywhere.
"""
import dataclasses
import random

import pytest
import torch

from foundationdb_tpu.ops.conflict_kernel import KernelConfig
from foundationdb_tpu.ops.host_engine import JaxConflictEngine
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine
from torch_sim_world import BOTH, JAX, PORT, clean_world, journal_bytes

torch.set_num_threads(1)

CFG = dict(dispatch_timeout=0.2, retry_budget=2, retry_backoff=0.02, probe_rate=0.0,
           probation_batches=2, failover_min_batches=2)


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def scripted(P, script=()):
    """tests/test_fault_tolerance.py's ScriptedEngine over package P: an
    inner oracle behind a per-dispatch script ('ok' | 'raise' | 'hang' |
    'flip'); past the script's end, always 'ok'."""

    class ScriptedEngine:
        name = "scripted"

        def __init__(self):
            self.inner = P.oracle.OracleConflictEngine()
            self.script = list(script)
            self.calls = 0

        def clear(self, version):
            self.inner.clear(version)

        def rewarm_target(self):
            return self.inner

        async def resolve_async(self, transactions, now_v, new_oldest):
            self.calls += 1
            b = self.script.pop(0) if self.script else "ok"
            if b == "hang":
                await P.loop.never()
            if b == "raise":
                raise P.error.device_fault("scripted dispatch failure")
            verdicts = list(self.inner.resolve(transactions, now_v, new_oldest))
            if b == "flip" and verdicts:
                C = P.types.TransactionCommitResult
                verdicts[0] = C.CONFLICT if int(verdicts[0]) == int(C.COMMITTED) else C.COMMITTED
            return verdicts

    return ScriptedEngine()


def batch_stream(P, seed, n, pool=40, writes=True):
    """tests/test_fault_tolerance.py's batch_stream from package P's types."""
    rng = random.Random(seed)
    v = 0
    out = []
    for _ in range(n):
        v += rng.randrange(20, 100)
        txns = []
        for _ in range(rng.randrange(1, 6)):
            t = P.types.CommitTransaction(read_snapshot=max(0, v - rng.randrange(1, 300)))
            for _ in range(rng.randrange(1, 3)):
                k = b"k/%03d" % rng.randrange(pool)
                t.read_conflict_ranges.append(P.types.KeyRange(k, k + b"\x00"))
            if writes:
                for _ in range(rng.randrange(0, 3)):
                    k = b"k/%03d" % rng.randrange(pool)
                    t.write_conflict_ranges.append(P.types.KeyRange(k, k + b"\x00"))
            txns.append(t)
        out.append((txns, v, max(0, v - 1500)))
    return out


def journal_events(P, directory):
    """A journal's events as (kind, payload fields), the hub label dropped."""
    out = []
    for ev in P.blackbox.read_journal(str(directory)):
        fields = dataclasses.asdict(ev.payload)
        fields.pop("label", None)
        out.append((ev.kind, ev.seq, fields))
    return out


def injector(P, inner, **rates):
    return P.inject.FaultInjectingEngine(inner, rates=P.inject.FaultRates(**rates))


#: scenario -> (device(P), config fields, stream (seed, n), record_journal)
SCENARIOS = {
    "timeout_retry": (lambda P: scripted(P, ["hang"]), CFG, (1, 10), False),
    "retry_exhaustion": (lambda P: scripted(P, ["ok"] * 6 + ["raise"] * 1000), CFG, (2, 18),
                         False),
    "swap_back": (lambda P: scripted(P, ["ok"] * 5 + ["raise"] * 9), CFG, (3, 30), False),
    "probation_relapse": (lambda P: scripted(P, ["raise"] * 13),
                          dict(CFG, retry_budget=0, probation_batches=3, failover_min_batches=1),
                          (4, 14), False),
    "journal": (lambda P: scripted(P, ["ok"] * 4 + ["raise"] * 9), CFG, (7, 20), True),
    "probe_quarantine": (lambda P: injector(P, P.oracle.OracleConflictEngine(), exception=0,
                                            hang=0, slow=0, outage=0, flip=0.5),
                         dict(CFG, retry_budget=0, probe_rate=1.0), (8, 30), False),
    "menagerie": (lambda P: injector(P, P.oracle.OracleConflictEngine(), exception=0.05,
                                     hang=0.03, slow=0.1, outage=0.03, outage_seconds=1.0),
                  dict(CFG, probe_rate=0.1, probation_batches=3), (9, 250), False),
}


def supervised_run(P, device, cfg_fields, stream, record_journal, journal_dir, seed=11):
    """Serve `stream` through ResilientEngine(device) in a Simulator(seed)
    (buggify off, a BlackboxJournal in `journal_dir`), every verdict held
    to a clean oracle. Returns what the two stacks must share."""
    sim = P.simulator.Simulator(seed)
    P.buggify.disable()
    P.trace.g_trace.clear()
    P.blackbox.install(P.blackbox.BlackboxJournal(str(journal_dir), fresh=True))
    dev = device(P)
    eng = P.resilient.ResilientEngine(dev, P.resilient.ResilienceConfig(**cfg_fields),
                                      record_journal=record_journal)
    clean = P.oracle.OracleConflictEngine()
    verdicts = []

    async def go():
        for txns, v, old in stream:
            got = [int(x) for x in await eng.resolve(txns, v, old)]
            assert got == [int(x) for x in clean.resolve(txns, v, old)], v
            verdicts.append(got)

    sim.sched.run_until(sim.sched.spawn(go()), until=100000)
    P.blackbox.uninstall()
    rec = {"verdicts": verdicts, "stats": eng.health_stats(),
           "transitions": [(e["From"], e["To"]) for e in
                           P.trace.g_trace.find("ResolverEngineHealth")],
           "events": [e["Type"] for e in P.trace.g_trace.events],
           "flight": eng.flight.dump(),
           "journal_bytes": journal_bytes(journal_dir),
           "world": (sim.sched.rng.random01(), sim.sched.time, sim.sched.tasks_run),
           "injected": dict(getattr(dev, "injected", {}))}
    P.loop.set_scheduler(None)
    return eng, rec


def run_both(tmp_path, device, cfg_fields, stream_args, record_journal=False):
    out = {}
    for P in BOTH:
        eng, rec = supervised_run(P, device, cfg_fields, batch_stream(P, *stream_args),
                                  record_journal, tmp_path / P.name)
        out[P.name] = (eng, rec)
        clean_world()
    (peng, prec), (_, jrec) = out[PORT.name], out[JAX.name]
    assert prec == jrec
    return peng, prec


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervisor_scenario_equals_jax(tmp_path, name):
    device, cfg_fields, stream_args, record_journal = SCENARIOS[name]
    eng, rec = run_both(tmp_path, device, cfg_fields, stream_args, record_journal)
    st = rec["stats"]
    H = PORT.resilient
    if name == "timeout_retry":
        assert st["state"] == H.HEALTHY
        assert st["dispatch_faults"] == 1 and st["retries"] == 1 and st["failovers"] == 0
        assert rec["flight"] and all(r["dispatch_mode"] == "step" for r in rec["flight"])
        assert all("loop_stats" not in r for r in rec["flight"])
    elif name == "retry_exhaustion":
        assert st["failovers"] >= 1 and st["oracle_batches"] >= 11
        assert st["state"] in (H.FAILED, H.PROBATION) and st["swap_backs"] == 0
    elif name == "swap_back":
        assert st["failovers"] >= 1 and st["swap_backs"] >= 1
        assert st["state"] == H.HEALTHY and eng._failover is None
        assert ("failed", "probation") in rec["transitions"]
    elif name == "probation_relapse":
        assert st["failovers"] >= 1 and st["swap_backs"] == 0
        assert "ResolverEngineProbationFault" in rec["events"]
        assert st["dispatch_faults"] >= 5
    elif name == "journal":
        clean = PORT.oracle.OracleConflictEngine()
        for version, txns, new_oldest, verdicts in eng.journal:
            want = clean.resolve(list(txns), version, new_oldest)
            assert list(verdicts) == [int(v) for v in want]
    elif name == "probe_quarantine":
        assert st["state"] == H.QUARANTINED and st["probe_mismatches"] >= 1
        assert "ResolverEngineQuarantine" in rec["events"]
    elif name == "menagerie":
        assert st["dispatch_faults"] > 0
        assert st["failovers"] >= 1 and st["swap_backs"] >= 1
        assert st["probe_mismatches"] == 0
        # a straggler past the watchdog is a fault too: never fewer faults
        # than the injector's exceptions and hangs
        inj = rec["injected"]
        assert st["dispatch_faults"] >= inj["exceptions"] + inj["hangs"]
    assert rec["journal_bytes"], "the journal recorded nothing"


def test_flight_digest_replays_through_clean_oracle(tmp_path):
    """abort_set_digest of each flight record equals the digest of the
    batch replayed through a clean oracle, and the two packages' digest
    functions agree."""
    eng, rec = run_both(tmp_path, *SCENARIOS["journal"][:3], record_journal=True)
    clean = PORT.oracle.OracleConflictEngine()
    want = {}
    for version, txns, new_oldest, _ in eng.journal:
        v = [int(x) for x in clean.resolve(list(txns), version, new_oldest)]
        want[version] = v
        assert PORT.resilient.abort_set_digest(v) == JAX.resilient.abort_set_digest(v)
    for r in rec["flight"]:
        assert r["digest"] == PORT.resilient.abort_set_digest(want[r["version"]])


def shadow_rebuild(P):
    sim = P.simulator.Simulator(11)
    P.buggify.disable()
    eng = P.resilient.ResilientEngine(scripted(P), P.resilient.ResilienceConfig(**CFG))
    full = P.oracle.OracleConflictEngine()
    history = batch_stream(P, 5, 40)
    last_v = history[-1][1]
    future = [(t, last_v + v, max(0, last_v + v - 1500)) for t, v, _ in batch_stream(P, 6, 25)]
    out = []

    async def go():
        for txns, v, old in history:
            want = full.resolve(txns, v, old)
            got = await eng.resolve(txns, v, old)
            assert [int(x) for x in got] == [int(x) for x in want]
        rebuilt = eng._rebuild_oracle()
        for txns, v, old in future:
            want = [int(x) for x in full.resolve(txns, v, old)]
            got = [int(x) for x in rebuilt.resolve(txns, v, old)]
            assert got == want, v
            out.append(got)

    sim.sched.run_until(sim.sched.spawn(go()), until=100000)
    P.loop.set_scheduler(None)
    return out, len(eng._shadow), len(history), list(eng._shadow)


def test_shadow_rebuild_parity_equals_jax():
    """An oracle rebuilt from the shadow window answers every future batch
    like one that lived through the whole history; the window and its
    entries equal the JAX supervisor's."""
    port = shadow_rebuild(PORT)
    clean_world()
    jax_ = shadow_rebuild(JAX)
    assert port == jax_
    assert port[1] < port[2], "the shadow holds the whole history"


def test_degraded_engine_collapses_pipeline_depth():
    """pipeline/service.py: a degraded engine caps the in-flight window at
    1; a healthy one uses the configured depth — in both packages."""
    peaks = {}
    for P in BOTH:
        sim = P.simulator.Simulator(11)
        P.buggify.disable()

        class Eng:
            degraded = False

            def __init__(self):
                self.inner = P.oracle.OracleConflictEngine()

            def resolve(self, txns, v, old):
                return self.inner.resolve(txns, v, old)

        async def run_window(eng):
            svc = P.service.PipelinedResolverService(
                P.service.PipelineConfig(depth=3, device_ms_per_batch=5.0), eng)
            seen = []

            async def one(t, v, o):
                await svc.acquire()
                seen.append(svc.in_flight)
                await svc.resolve(t, v, o)

            tasks = [sim.sched.spawn(one(t, v, o))
                     for t, v, o in batch_stream(P, 10, 8, writes=False)]
            for t in tasks:
                await t
            return max(seen)

        healthy = sim.sched.run_until(sim.sched.spawn(run_window(Eng())), until=100000)
        sick = Eng()
        sick.degraded = True
        degraded = sim.sched.run_until(sim.sched.spawn(run_window(sick)), until=100000)
        peaks[P.name] = (healthy, degraded, sim.sched.tasks_run)
        clean_world()
    assert peaks[PORT.name] == peaks[JAX.name]
    assert peaks[PORT.name][:2] == (3, 1)


def serial_exception(P):
    sim = P.simulator.Simulator(11)
    P.buggify.disable()

    class FlakyEngine:
        def __init__(self):
            self.inner = P.oracle.OracleConflictEngine()
            self.fail_next = 1

        def resolve(self, txns, v, old):
            if self.fail_next:
                self.fail_next -= 1
                raise ValueError("runtime error")   # deliberately untyped
            return self.inner.resolve(txns, v, old)

    proc, client = sim.new_process("resolver"), sim.new_process("proxy")
    res = P.resolver.Resolver(proc, FlakyEngine(), start_version=0)
    req = P.messages.ResolveTransactionBatchRequest(
        prev_version=0, version=10, last_received_version=0,
        transactions=[P.types.CommitTransaction(read_snapshot=5)])
    ep = P.network.Endpoint(proc.address, res.token)
    pri = P.loop.TaskPriority.PROXY_RESOLVER_REPLY

    async def go():
        try:
            await sim.net.request(client.address, ep, req, pri, timeout=5.0)
        except P.error.FDBError as e:
            first = e.code
        else:
            raise AssertionError("engine exception did not surface")
        assert first == P.error.please_reboot("").code and proc.alive
        reply = await sim.net.request(client.address, ep, req, pri, timeout=5.0)
        return first, list(reply.committed)

    out = sim.sched.run_until(sim.sched.spawn(go()), until=100000)
    P.loop.set_scheduler(None)
    return out, res.stats.counter("resolve_errors").value


def test_serial_engine_exception_is_typed_and_recoverable():
    """The serial role turns an untyped engine exception into a typed
    please_reboot, survives, counts it, and resolves the retried version."""
    port = serial_exception(PORT)
    clean_world()
    assert port == serial_exception(JAX)
    assert port[0][1] == [int(PORT.types.TransactionCommitResult.COMMITTED)] and port[1] == 1


def serial_duplicate(P):
    sim = P.simulator.Simulator(11)
    P.buggify.disable()

    class SlowEngine:
        def __init__(self):
            self.inner = P.oracle.OracleConflictEngine()
            self.dispatches = 0

        async def _run(self, txns, v, old):
            self.dispatches += 1
            await P.loop.delay(0.5)
            return self.inner.resolve(txns, v, old)

        def resolve(self, txns, v, old):
            return self._run(txns, v, old)

        def health_stats(self):
            return {"state": "healthy", "degraded": False}

    proc, client = sim.new_process("resolver"), sim.new_process("proxy")
    eng = SlowEngine()
    res = P.resolver.Resolver(proc, eng, start_version=0)
    req = P.messages.ResolveTransactionBatchRequest(
        prev_version=0, version=10, last_received_version=0,
        transactions=[P.types.CommitTransaction(read_snapshot=5)])
    ep = P.network.Endpoint(proc.address, res.token)

    async def one():
        return await sim.net.request(client.address, ep, req,
                                     P.loop.TaskPriority.PROXY_RESOLVER_REPLY, timeout=5.0)

    async def go():
        a = sim.sched.spawn(one())
        await P.loop.delay(0.1)
        b = sim.sched.spawn(one())   # duplicate while the first is in flight
        ra, rb = await a, await b
        return list(ra.committed), list(rb.committed)

    out = sim.sched.run_until(sim.sched.spawn(go()), until=100000)
    P.loop.set_scheduler(None)
    return out, eng.dispatches, sim.sched.time


def test_serial_duplicate_waits_on_inflight_dispatch():
    """A duplicate delivery of a version in an awaiting dispatch waits for
    the first outcome instead of dispatching the batch twice."""
    port = serial_duplicate(PORT)
    clean_world()
    assert port == serial_duplicate(JAX)
    assert port[0][0] == port[0][1] and port[1] == 1


# -- the port's own engine under the supervisor --------------------------------

SMALL = KernelConfig(key_words=2, capacity=1024, max_reads=64, max_writes=64, max_txns=32)


def port_small():
    return tck.KernelConfig(key_words=2, capacity=1024, max_reads=64, max_writes=64,
                            max_txns=32)


def test_cpu_engine_under_injector_equals_oracle_and_jax_stack(tmp_path):
    """The menagerie over a CPU TorchConflictEngine (its rewarms replay the
    shadow through the engine and ensure_warm) equals the oracle on every
    batch, and the JAX stack over its oracle in everything: the engine
    draws nothing from the simulation's random stream."""
    device, cfg_fields, stream_args, _ = SCENARIOS["menagerie"]
    recs = {}
    # heat off: the engine's heat snapshot would ride its flight records
    for P, inner in ((PORT, lambda: TorchConflictEngine(port_small(), device="cpu",
                                                         heat_buckets=0)),
                     (JAX, JAX.oracle.OracleConflictEngine)):
        eng, rec = supervised_run(
            P, lambda P: injector(P, inner(), exception=0.05, hang=0.03, slow=0.1, outage=0.03,
                                  outage_seconds=1.0),
            cfg_fields, batch_stream(P, *stream_args), False, tmp_path / P.name)
        recs[P.name] = rec
        if P is PORT:
            assert eng.device.inner.perf.compiles > 0
        clean_world()
    prec, jrec = recs[PORT.name], recs[JAX.name]
    # the device name differs by design (the torch engine against the
    # JAX stack's oracle), and so does the supervisor's hub label (the
    # engine registers with the hub first); everything else is equal
    assert prec["stats"].pop("device") == "fault-injecting" == jrec["stats"].pop("device")
    prec.pop("journal_bytes"), jrec.pop("journal_bytes")
    assert prec == jrec
    assert journal_events(PORT, tmp_path / PORT.name) == journal_events(JAX, tmp_path / JAX.name)
    assert prec["stats"]["failovers"] >= 1 and prec["stats"]["swap_backs"] >= 1


def oversized_rewarm(P, engine):
    """A supervised engine whose shadow holds one version with more point
    writes than one transaction may carry (wp): the rewarm puts them in ONE
    synthetic transaction. Returns the rewarm's error code and the stats
    after a supervised run where a retry must rewarm."""
    sim = P.simulator.Simulator(11)
    P.buggify.disable()
    inj = injector(P, engine, exception=0, hang=0, slow=0, outage=0, flip=0)
    eng = P.resilient.ResilientEngine(inj, P.resilient.ResilienceConfig(**CFG))
    T = P.types
    wide = [T.CommitTransaction(read_snapshot=0, write_conflict_ranges=[
        T.KeyRange(b"w/%03d/%d" % (i, j), b"w/%03d/%d\x00" % (i, j)) for j in range(2)])
        for i in range(40)]
    out = {}

    async def go():
        got = await eng.resolve(wide, 100, 0)
        out["committed"] = sum(int(v) == int(T.TransactionCommitResult.COMMITTED) for v in got)
        try:
            eng._rewarm_device()
        except P.error.FDBError as e:
            out["code"] = e.code
        # the dispatch faults once: the retry's rewarm fails the same way,
        # and the batch goes to the oracle after the retry budget
        inj.rates.exception = 1.0
        got = await eng.resolve([T.CommitTransaction(read_snapshot=100, read_conflict_ranges=[
            T.KeyRange(b"w/000/0", b"w/000/0\x00")])], 200, 0)
        out["after"] = [int(v) for v in got]

    sim.sched.run_until(sim.sched.spawn(go()), until=100000)
    P.loop.set_scheduler(None)
    st = eng.health_stats()
    st.pop("device")
    return out, st


def test_oversized_shadow_entry_rewarm_raises_same_code_as_jax():
    """80 committed point writes at one version against wp = 64: the
    rewarm's synthetic transaction exceeds the device's per-transaction
    capacity, in the port as in the JAX package (client_invalid_operation);
    the supervisor counts rewarm_failures and serves from the oracle."""
    port = oversized_rewarm(PORT, TorchConflictEngine(port_small(), device="cpu"))
    clean_world()
    jax_ = oversized_rewarm(JAX, JaxConflictEngine(SMALL))
    assert port == jax_
    out, st = port
    assert out["committed"] == 40
    assert out["code"] == PORT.error.client_invalid_operation("").code
    assert st["rewarm_failures"] >= 1 and st["oracle_batches"] >= 1


def test_maybe_wrap_and_exports():
    """maybe_wrap supervises only when asked and only an unsupervised
    engine; the package exports JAX's names."""
    class Cfg:
        resilient_resolver = True

    sim = PORT.simulator.Simulator(3)
    raw = PORT.oracle.OracleConflictEngine()
    assert PORT.fault.maybe_wrap(raw, object()) is raw
    wrapped = PORT.fault.maybe_wrap(raw, Cfg())
    assert isinstance(wrapped, PORT.resilient.ResilientEngine)
    assert PORT.fault.maybe_wrap(wrapped, Cfg()) is wrapped
    assert PORT.fault.registered_engines() == [wrapped]
    assert PORT.fault.__all__ == JAX.fault.__all__
    del sim
