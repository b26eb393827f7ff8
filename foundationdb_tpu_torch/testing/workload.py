"""TestWorkload interface + spec runner.

Port of ``foundationdb_tpu/testing/workload.py``.

reference: fdbserver/workloads/workloads.h:42-85 (description/setup/start/
check + clientId/clientCount), fdbserver/tester.actor.cpp:778-1124 (phase
driving), tests/*.txt (declarative specs composing workloads).

A Spec composes workload classes with options; run_spec builds a simulated
cluster from the seed, runs setup -> start (all workloads and clients
concurrently) -> quiesce -> check, and returns collected metrics. Fault
injectors (clogging etc.) are workloads whose start() runs until the test
phase ends, exactly like the reference's anti-quiescence workloads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Type

from ..core import error
from ..core.rng import DeterministicRandom
from ..client.database import Database
from ..server.cluster import Cluster, ClusterConfig, DynamicCluster, DynamicClusterConfig
from ..sim.actors import all_of
from ..sim.loop import Future, set_scheduler
from ..sim.simulator import Simulator


class WorkloadContext:
    def __init__(
        self,
        cluster: Cluster,
        client_id: int,
        client_count: int,
        rng: DeterministicRandom,
        options: Dict[str, Any],
        shared: Optional[Dict[str, Any]] = None,
    ):
        self.cluster = cluster
        self.client_id = client_id
        self.client_count = client_count
        self.rng = rng
        self.options = options
        self.metrics: Dict[str, float] = {}
        #: one dict per workload entry, shared by all its clients — for
        #: cross-client totals the check phase needs (the reference tester
        #: sums getMetrics across clients before checking)
        self.shared: Dict[str, Any] = shared if shared is not None else {}

    def count(self, key: str, delta: float = 1) -> None:
        self.shared[key] = self.shared.get(key, 0) + delta
        self.metrics[key] = self.metrics.get(key, 0) + delta


class TestWorkload:
    """Subclass and override; every phase gets a fresh Database client."""

    name = "workload"
    #: fault injectors keep running during start and are cancelled at
    #: quiescence instead of awaited (reference: anti-quiescence workloads)
    anti_quiescence = False

    def __init__(self, ctx: WorkloadContext):
        self.ctx = ctx

    async def setup(self, db: Database) -> None:
        pass

    async def start(self, db: Database) -> None:
        pass

    async def check(self, db: Database) -> bool:
        return True


@dataclass
class Spec:
    """One test = cluster config + composed workloads (tests/fast/*.txt)."""

    title: str
    workloads: List[tuple] = field(default_factory=list)  # (cls, options)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    #: when set, the spec runs against a recruitment-era DynamicCluster
    #: (coordinators + workers + recovery) instead of the static assembly —
    #: required for attrition workloads
    dynamic: Optional[DynamicClusterConfig] = None
    client_count: int = 1
    timeout: float = 3600.0
    #: BUGGIFY-randomize the knob registries for this run (always reset
    #: afterwards); the reference randomizes knobs in every sim run
    randomize_knobs: bool = True


@dataclass
class SpecResult:
    ok: bool
    metrics: Dict[str, float]
    seed: int
    virtual_time: float


async def quiet_database(cluster, timeout: float = 120.0) -> None:
    """Wait until every reachable storage replica has caught up to a
    post-workload read version (waitForQuietDatabase reduced to its
    storage-lag core: no checker should race the mutation pipeline)."""
    from ..core import error as _error
    from ..server.ratekeeper import STORAGE_QUEUE_INFO_TOKEN
    from ..sim.loop import TaskPriority, delay, now
    from ..sim.network import Endpoint

    sim = cluster.sim
    db = cluster.new_client()
    tr = db.create_transaction()
    while True:
        try:
            rv = await tr.get_read_version()
            break
        except _error.FDBError as e:
            await tr.on_error(e)
            tr = db.create_transaction()

    deadline = now() + timeout
    while now() < deadline:
        procs = [p for p in getattr(cluster, "worker_procs", [])
                 if p.alive and STORAGE_QUEUE_INFO_TOKEN in p.handlers]
        procs += [getattr(s, "proc") for s in getattr(cluster, "storages", [])
                  if s.proc.alive and STORAGE_QUEUE_INFO_TOKEN in s.proc.handlers]
        lagging = False
        for p in procs:
            try:
                info = await sim.net.request(
                    db.client_addr, Endpoint(p.address, STORAGE_QUEUE_INFO_TOKEN),
                    None, TaskPriority.DEFAULT_ENDPOINT, timeout=2.0,
                )
            except _error.FDBError:
                continue  # dead/unreachable replicas don't gate quiescence
            if info.version < rv:
                lagging = True
                break
        if not lagging:
            return
        await delay(0.5, TaskPriority.DEFAULT_ENDPOINT)
    # Giving up silently would let checks race the mutation pipeline —
    # the exact flakiness this phase exists to prevent. Fail loudly.
    raise _error.timed_out("quiet_database: storage still lagging at deadline")


def run_spec(spec: Spec, seed: int) -> SpecResult:
    """Deterministic: same spec+seed -> same result and metrics."""
    sim = Simulator(seed, randomize_knobs=spec.randomize_knobs)
    if spec.dynamic is not None:
        cluster = DynamicCluster(sim, spec.dynamic)
    else:
        cluster = Cluster(sim, spec.cluster)
    instances: List[TestWorkload] = []
    for cls, options in spec.workloads:
        shared: Dict[str, Any] = {}
        for cid in range(spec.client_count):
            ctx = WorkloadContext(cluster, cid, spec.client_count, sim.sched.rng, dict(options), shared)
            instances.append(cls(ctx))

    metrics: Dict[str, float] = {}
    ok = True

    async def drive():
        nonlocal ok
        # setup: client 0 of each workload only (reference: clientId==0 gates)
        for w in instances:
            if w.ctx.client_id == 0:
                await w.setup(cluster.new_client())
        # start: all clients concurrently; injectors cancelled at quiescence
        main_tasks = []
        injector_tasks = []
        for w in instances:
            t = sim.sched.spawn(w.start(cluster.new_client()), name=f"wl:{w.name}:{w.ctx.client_id}")
            (injector_tasks if w.anti_quiescence else main_tasks).append(t)
        await all_of(main_tasks)
        for t in injector_tasks:
            t.cancel()
        # quiesce, then check (waitForQuietDatabase, QuietDatabase.actor.cpp:304)
        try:
            await quiet_database(cluster)
        except error.FDBError:
            ok = False
            metrics["quiesce_timeout"] = 1
            return
        for w in instances:
            if w.ctx.client_id == 0:
                if not await w.check(cluster.new_client()):
                    ok = False
        for w in instances:
            metrics.update(w.ctx.metrics)

    task = sim.sched.spawn(drive(), name=f"spec:{spec.title}")
    try:
        sim.run_until(task, until=spec.timeout)
    finally:
        set_scheduler(None)
        if spec.randomize_knobs:
            from ..core import knobs
            knobs.reset_all()
    # sim_validation oracle (sim/validation.py): ANY recovery that picked a
    # version below a fully-acked push fails the spec, whatever the
    # workload checks said — acked durability is never up for debate.
    from ..sim import validation as sim_validation

    if sim_validation.violations:
        ok = False
        metrics["durability_violations"] = len(sim_validation.violations)
    return SpecResult(ok=ok, metrics=metrics, seed=seed, virtual_time=sim.sched.time)
