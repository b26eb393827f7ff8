"""Shared harness of the port's simulator, journal and resolver-role tests.

Each scenario is written once against a namespace of one package's modules
(`JAX` or `PORT`) and run over both, so every comparison is between the same
code path in the two packages. `clean_world()` leaves the process-global
state of both packages as it found it: the current scheduler, buggify, the
durability oracle, the fault registry, the telemetry hub, spans and the
installed journal (and the installed program cache), and the knobs.
`world_state()` is what a simulation leaves behind, compared across the
packages by the dynamic cluster's tests.
"""
import contextlib
import importlib
import random
from pathlib import Path
from types import SimpleNamespace

MODULES = {"buggify": "core.buggify", "error": "core.error", "types": "core.types",
           "wire": "core.wire", "blackbox": "core.blackbox", "trace": "core.trace",
           "stats": "core.stats", "telemetry": "core.telemetry", "tdmetric": "core.tdmetric",
           "loop": "sim.loop", "actors": "sim.actors", "network": "sim.network",
           "disk": "sim.disk", "validation": "sim.validation", "simulator": "sim.simulator",
           "fault": "fault", "messages": "server.messages", "resolver": "server.resolver",
           "pipeline": "pipeline", "oracle": "ops.oracle", "inject": "fault.inject",
           "resilient": "fault.resilient", "handoff": "fault.handoff",
           "recovery": "fault.recovery", "progcache": "core.progcache",
           "keyshard": "core.keyshard", "heatmap": "core.heatmap", "knobs": "core.knobs",
           "rng": "core.rng", "reshard": "server.reshard", "service": "pipeline.service",
           "resolver_pipeline": "pipeline.resolver_pipeline",
           "indexedset": "core.indexedset", "keyrangemap": "core.keyrangemap",
           "disk_queue": "server.disk_queue", "kvstore": "server.kvstore",
           "system_keys": "server.system_keys", "master": "server.master",
           "tlog": "server.tlog", "log_system": "server.log_system",
           "storage": "server.storage", "ratekeeper": "server.ratekeeper",
           "proxy": "server.proxy", "cluster": "server.cluster",
           "database": "client.database", "harness": "pipeline.latency_harness",
           "workload": "testing.workload", "workloads": "testing.workloads",
           "specs": "testing.specs", "runner": "testing.runner",
           "replication_policy": "server.replication_policy",
           "management": "server.management", "coordination": "server.coordination",
           "coordinated_state": "server.coordinated_state",
           "leader_election": "server.leader_election", "worker": "server.worker",
           "cluster_controller": "server.cluster_controller",
           "masterserver": "server.masterserver"}


def package(root):
    return SimpleNamespace(name=root, **{k: importlib.import_module(f"{root}.{v}")
                                         for k, v in MODULES.items()})


JAX = package("foundationdb_tpu")
PORT = package("foundationdb_tpu_torch")
BOTH = (PORT, JAX)


def clean_world():
    """Reset every process-global piece of simulation state in both packages."""
    for P in BOTH:
        P.loop.set_scheduler(None)
        P.buggify.disable()
        P.blackbox.uninstall()
        P.progcache.uninstall()
        P.validation.disable()
        P.fault._registry.clear()
        P.fault._recording = False
        P.telemetry.reset()
        P.trace.g_spans.enabled = False
        P.trace.g_spans.clear()
        P.trace.g_trace.clear()
        P.knobs.reset_all()


def both(case, *args):
    """case(P, *args) on the port, then on JAX, each from a clean world."""
    out = []
    for P in BOTH:
        clean_world()
        out.append(case(P, *args))
    return out


def disk_bytes(sim):
    """Every SimDisk of a simulation: per address, each file's durable
    bytes and its pending (un-synced) writes."""
    return {a: {n: (bytes(f.durable), list(f.pending)) for n, f in sorted(d.files.items())}
            for a, d in sorted(sim.disks.items())}


def world_state(P, sim):
    """What a simulation leaves behind: its virtual time, the tasks its
    scheduler ran, its rng's state, every disk's bytes and package P's
    trace events (their "Time" is the wall clock, so it is dropped)."""
    events = [{k: v for k, v in e.items() if k != "Time"} for e in P.trace.g_trace.events]
    return (sim.sched.time, sim.sched.tasks_run, sim.sched.rng._r.getstate(),
            disk_bytes(sim), events)


@contextlib.contextmanager
def sims_built(P):
    """Collect every Simulator package P builds inside the block (run_spec
    builds its own)."""
    built, init = [], P.simulator.Simulator.__init__

    def recording(self, *a, **kw):
        init(self, *a, **kw)
        built.append(self)

    P.simulator.Simulator.__init__ = recording
    try:
        yield built
    finally:
        P.simulator.Simulator.__init__ = init


def journal_bytes(directory):
    """The raw bytes of every segment of a journal directory, oldest first."""
    return [p.read_bytes() for p in sorted(Path(directory).glob("bbox-*.seg"))]


SMALL_TXNS = 32


def make_batches(P, seed, n_batches=14, pool=96, range_every=5):
    """tests/test_resolver_pipeline.py's deterministic conflicting stream,
    built from package P's types: point reads/writes over a hot pool,
    snapshots lagging enough to abort; with `range_every`, every
    `range_every`-th batch may carry a true range read."""
    rng = random.Random(seed)
    batches = []
    v = 0
    for b in range(n_batches):
        v += rng.randrange(40, 200)
        txns = []
        for _ in range(rng.randrange(3, SMALL_TXNS // 2)):
            t = P.types.CommitTransaction(read_snapshot=max(0, v - rng.randrange(1, 400)))
            for _ in range(rng.randrange(1, 3)):
                k = b"pp/%04d" % rng.randrange(pool)
                t.read_conflict_ranges.append(P.types.KeyRange(k, k + b"\x00"))
            for _ in range(rng.randrange(1, 3)):
                k = b"pp/%04d" % rng.randrange(pool)
                t.write_conflict_ranges.append(P.types.KeyRange(k, k + b"\x00"))
            if range_every and b % range_every == range_every - 1 and rng.random() < 0.5:
                a, z = sorted([b"pp/%04d" % rng.randrange(pool), b"pp/%04d" % rng.randrange(pool)])
                t.read_conflict_ranges.append(P.types.KeyRange(a, z + b"\xff"))
            txns.append(t)
        batches.append((txns, v, max(0, v - 2000)))
    return batches


def drive_resolver_role(P, depth, kill_at=None, seed=902, engine_factory=None,
                        journal_dir=None, range_every=0, **pipeline_kw):
    """tests/test_resolver_pipeline.py's drive_resolver_role over package P.

    The deterministic stream goes through a sim Resolver role; arrival
    jitter is BUGGIFY'd and every 4th version is delivered twice (proxy
    retry). With `kill_at`, the role is killed once version
    `batches[kill_at]` has resolved, with later batches of the window in
    flight, and a fresh role over a fresh engine (token suffix "gen2",
    chain restarted at the kill point) serves every later version. With
    `journal_dir`, a BlackboxJournal is installed there for the run;
    `pipeline_kw` sets more PipelineConfig fields (dispatch_mode, ...).
    Returns ({version: verdicts}, the roles).
    """
    engine_factory = engine_factory or P.oracle.OracleConflictEngine
    TP = P.loop.TaskPriority
    batches = make_batches(P, seed, range_every=range_every)
    sim = P.simulator.Simulator(seed)
    P.buggify.enable(sim.sched.rng)
    if journal_dir is not None:
        P.blackbox.install(P.blackbox.BlackboxJournal(str(journal_dir), fresh=True))
    pipeline = (P.pipeline.PipelineConfig(depth=depth, pack_ms_per_txn=0.02,
                                          device_ms_per_batch=0.4, **pipeline_kw)
                if depth is not None else None)
    proc = sim.new_process("res0")
    res = P.resolver.Resolver(proc, engine_factory(), start_version=0, pipeline=pipeline)
    roles = [res]
    replies = {}
    rng = sim.sched.rng

    def req_for(i):
        txns, v, _old = batches[i]
        prev = batches[i - 1][1] if i else 0
        return P.messages.ResolveTransactionBatchRequest(
            prev_version=prev, version=v, last_received_version=prev, transactions=txns)

    async def send(role, i):
        try:
            reply = await role.resolve_batch(req_for(i))
            replies.setdefault(batches[i][1], list(reply.committed))
        except P.error.FDBError:
            pass   # killed mid-flight; the retry against the new role wins

    async def feeder():
        kill_version = batches[kill_at][1] if kill_at is not None else None
        tasks = []
        for i in range(len(batches)):
            if P.buggify.buggify():
                await P.loop.delay(rng.random01() * 0.01, TP.PROXY_COMMIT)
            tasks.append(sim.sched.spawn(send(res, i), TP.PROXY_COMMIT))
            if i % 4 == 3:
                tasks.append(sim.sched.spawn(send(res, i), TP.PROXY_COMMIT))
            if kill_version is not None and i >= kill_at + (depth or 1):
                while res.version.get() < kill_version:
                    await P.loop.delay(0.005, TP.PROXY_COMMIT)
                for t in tasks:
                    t.cancel()
                res.unregister()
                res2 = P.resolver.Resolver(sim.new_process("res1"), engine_factory(),
                                           start_version=kill_version, token_suffix="gen2",
                                           pipeline=pipeline)
                roles.append(res2)
                for j in range(kill_at + 1, i + 1):
                    replies.pop(batches[j][1], None)
                    sim.sched.spawn(send(res2, j), TP.PROXY_COMMIT)
                return await feeder_rest(res2, i + 1)

    async def feeder_rest(role, start):
        for i in range(start, len(batches)):
            if P.buggify.buggify():
                await P.loop.delay(rng.random01() * 0.01, TP.PROXY_COMMIT)
            sim.sched.spawn(send(role, i), TP.PROXY_COMMIT)
            if i % 4 == 3:
                sim.sched.spawn(send(role, i), TP.PROXY_COMMIT)

    sim.sched.spawn(feeder(), TP.PROXY_COMMIT)
    try:
        sim.run(until=30.0)
    finally:
        P.loop.set_scheduler(None)
        P.blackbox.uninstall()
    assert len(replies) == len(batches), "not every version resolved"
    return replies, roles, sim
