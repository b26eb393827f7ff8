"""Static cluster assembly — the reference's seed mode.

Port of ``foundationdb_tpu/server/cluster.py``: the static assembly
(`ClusterConfig`, `Cluster`, `build_cluster`) and the dynamic one
(`DynamicClusterConfig`, `DynamicCluster`, `build_dynamic_cluster`:
coordinators and workers with boot functions; election, recruitment and
recovery run through server/worker.py and server/masterserver.py).

Builds a complete minimum transaction system inside a Simulator: one master,
one proxy, N resolvers (pluggable conflict engines), one tlog, M storage
servers with a static uniform shard map. The analog of SimulatedCluster's
setup + masterserver.actor.cpp:325 newSeedServers, before dynamic
recruitment/recovery land in a later round.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from ..core.types import KeyRange
from ..core.keyshard import KeyShardMap
from ..ops.oracle import OracleConflictEngine
from ..pipeline.service import PipelineConfig
from ..sim.actors import AsyncVar
from ..sim.network import Endpoint
from ..sim.simulator import Simulator
from ..client.database import Database
from .log_system import LogSystemConfig
from .master import GET_COMMIT_VERSION_TOKEN, Master
from .proxy import Proxy, ProxyConfig
from .resolver import RESOLVE_TOKEN, Resolver
from .storage import StorageServer
from .tlog import TLog


@dataclass
class ClusterConfig:
    n_resolvers: int = 1
    n_proxies: int = 1
    n_storage: int = 2          # number of key-range shards
    storage_replication: int = 1  # replicas per shard (the team size K)
    #: () -> conflict engine; default is the reference-exact oracle. Pass
    #: lambda: TorchConflictEngine(...) for resolvers on the card.
    engine_factory: Callable = OracleConflictEngine
    start_version: int = 1
    #: pipelined resolver service (pipeline/service.py): depth/pack/device
    #: knobs; None keeps the serial one-batch-at-a-time resolver
    resolver_pipeline: Optional["PipelineConfig"] = None
    #: proxy commit batch cap (None = proxy default); size it to the
    #: resolver kernel's compiled T when pipelining
    max_commit_batch: Optional[int] = None
    #: proxy in-flight commit window (None = unbounded)
    commit_pipeline_window: Optional[int] = None
    #: wrap each resolver's engine in the device-fault supervisor
    #: (fault/resilient.py: watchdog, retries, CPU-oracle failover). Off in
    #: the static assembly so engine-level unit suites see the raw engine.
    resilient_resolver: bool = False


class Cluster:
    """Handles to every role plus client factories."""

    def __init__(self, sim: Simulator, cfg: ClusterConfig):
        self.sim = sim
        self.cfg = cfg
        sv = cfg.start_version

        self.master_proc = sim.new_process("master")
        self.master = Master(self.master_proc, start_version=sv)

        self.tlog_proc = sim.new_process("tlog")
        self.tlog = TLog(self.tlog_proc, start_version=sv)
        self.log_config = LogSystemConfig(
            gen_id=(0, 0), tlogs=((self.tlog_proc.address, ""),), start_version=sv
        )
        self.log_view = AsyncVar(self.log_config)

        def make_engine():
            from ..fault import maybe_wrap

            return maybe_wrap(cfg.engine_factory(), cfg)

        self.resolver_shards = KeyShardMap.uniform(cfg.n_resolvers)
        self.resolver_procs = [sim.new_process(f"resolver{i}") for i in range(cfg.n_resolvers)]
        self.resolvers = [
            Resolver(p, make_engine(), start_version=sv, index=i,
                     pipeline=cfg.resolver_pipeline)
            for i, p in enumerate(self.resolver_procs)
        ]

        self.storage_shards = KeyShardMap.uniform(cfg.n_storage)
        # Teams: shard s is stored by `storage_replication` replicas, each
        # its own process + tag (DataDistribution's replica teams reduced
        # to a static seed assignment).
        self.storage_procs = []
        self.storages: List[StorageServer] = []
        self.storage_teams: List[List[tuple]] = []
        tag = 0
        for s in range(cfg.n_storage):
            begin = self.storage_shards.begins[s]
            end = self.storage_shards.span_end(s) or b"\xff\xff\xff"
            team = []
            for r in range(cfg.storage_replication):
                p = sim.new_process(f"storage{s}.{r}")
                self.storage_procs.append(p)
                self.storages.append(
                    StorageServer(
                        p,
                        tag=tag,
                        shard=KeyRange(begin, end),
                        log_view=self.log_view,
                        net=sim.net,
                        start_version=sv,
                    )
                )
                team.append((tag, p.address))
                tag += 1
            self.storage_teams.append(team)

        from .proxy import COMMITTED_VERSION_TOKEN

        self.proxy_procs = [sim.new_process(f"proxy{i}")
                            for i in range(max(1, cfg.n_proxies))]
        peer_grv_eps = [Endpoint(p.address, COMMITTED_VERSION_TOKEN)
                        for p in self.proxy_procs]
        self.proxies = [
            Proxy(
                p,
                sim.net,
                ProxyConfig(
                    master_ep=Endpoint(self.master_proc.address, GET_COMMIT_VERSION_TOKEN),
                    resolver_eps=[Endpoint(q.address, RESOLVE_TOKEN) for q in self.resolver_procs],
                    resolver_shards=self.resolver_shards,
                    log_config=self.log_config,
                    storage_teams=self.storage_teams,
                    storage_shards=self.storage_shards,
                    peer_grv_eps=peer_grv_eps,
                    max_commit_batch=cfg.max_commit_batch,
                    commit_pipeline_window=cfg.commit_pipeline_window,
                ),
                start_version=sv,
            )
            for p in self.proxy_procs
        ]
        self.proxy_proc = self.proxy_procs[0]
        self.proxy = self.proxies[0]
        self._n_clients = 0

    def new_client(self) -> Database:
        self._n_clients += 1
        proc = self.sim.new_process(f"client{self._n_clients}")
        return Database(self.sim.net, proc.address,
                        [p.address for p in self.proxy_procs])


def build_cluster(seed: int = 0, cfg: Optional[ClusterConfig] = None) -> Cluster:
    sim = Simulator(seed)
    return Cluster(sim, cfg or ClusterConfig())


# -- dynamic cluster: coordinators + workers + recovery ----------------------


@dataclass
class DynamicClusterConfig:
    """The recruitment-era cluster shape (reference: DatabaseConfiguration —
    `configure proxies=1 resolvers=2 logs=2`)."""

    n_coordinators: int = 3
    n_workers: int = 5
    n_tlogs: int = 2
    n_resolvers: int = 2
    n_proxies: int = 1
    n_storage: int = 2          # number of key-range shards
    storage_replication: int = 1  # replicas per shard (team size)
    #: per-tag tlog replication factor; 0 = every replica holds every tag
    log_replication_factor: int = 0
    #: resolutionBalancing trigger floor (rows per poll window) and poll
    #: interval; tests lower them to provoke rebalances quickly
    rebalance_min_rows: int = 200
    rebalance_interval: float = 5.0
    #: multi-region (reference: region config in SimulatedCluster:706,
    #: satellite tlogs + DC-preference recovery): workers/coordinators are
    #: spread over n_dcs datacenters; satellite_logs tlog replicas are
    #: placed OUTSIDE the primary DC (synchronous satellites — dc0's total
    #: loss still leaves a complete log); recruitment prefers the DC with
    #: the most live workers, so losing the primary FAILS OVER
    n_dcs: int = 1
    satellite_logs: int = 0
    #: extra one-way latency between processes in different DCs (the
    #: DCN tier; 0 keeps single-region runs byte-identical)
    inter_dc_latency: float = 0.0
    #: pipelined resolver service knobs as a plain dict (wire-friendly for
    #: real-mode recruitment): PipelineConfig(**resolver_pipeline); None
    #: keeps the serial resolver
    resolver_pipeline: Optional[dict] = None
    #: wrap recruited resolver engines in the device-fault supervisor
    #: (fault/resilient.py). Default ON: every dynamic spec — attrition,
    #: clogging, recovery — then exercises the watchdog/retry/failover
    #: machinery for free through its buggify sites, and a misbehaving
    #: device degrades instead of wedging the commit pipeline.
    resilient_resolver: bool = True
    engine_factory: Callable = OracleConflictEngine


import dataclasses as _dc

from ..core import wire as _wire

# wire codec for real-mode recruitment (InitializeMasterRequest carries the
# cluster shape): every field EXCEPT the process-local engine factory — the
# receiving worker constructs engines from its OWN factory
_wire.register_adapter(
    DynamicClusterConfig, "DynamicClusterConfig",
    to_state=lambda c: {f.name: getattr(c, f.name)
                        for f in _dc.fields(c) if f.name != "engine_factory"},
    # filter to known fields: a payload from a version with fields this
    # binary dropped must decode, not TypeError (the record path's
    # schema-evolution contract, wire.py)
    from_state=lambda d: DynamicClusterConfig(
        **{k: v for k, v in d.items()
           if k in {f.name for f in _dc.fields(DynamicClusterConfig)}}),
)


class DynamicCluster:
    """A full bootable cluster: coordinator processes and worker processes
    with boot functions, so kills + reboots re-run the real boot path
    (simulatedFDBDRebooter, SimulatedCluster.actor.cpp:198). Everything
    else — CC election, master recovery, role recruitment — happens through
    the same protocols a live cluster would use."""

    def __init__(self, sim: Simulator, cfg: Optional[DynamicClusterConfig] = None):
        from .coordination import CoordinationServer
        from .worker import Worker

        self.sim = sim
        self.cfg = cfg or DynamicClusterConfig()

        ndc = max(1, self.cfg.n_dcs)
        if self.cfg.inter_dc_latency:
            sim.net.inter_dc_latency = self.cfg.inter_dc_latency

        def coord_boot(simu, proc):
            async def go():
                await CoordinationServer.create(proc, simu.disk_for(proc.address))
            return go()

        # coordinator MAJORITY outside the primary DC (dc0) for ANY
        # coordinator count: losing dc0 entirely must leave a coordination
        # quorum (the reference's 3-site coordinator guidance). The first
        # floor(n/2)+1 coordinators round-robin over the non-primary DCs;
        # the remainder live in dc0.
        nco = self.cfg.n_coordinators
        if ndc > 1:
            maj = nco // 2 + 1
            non_primary = [f"dc{d}" for d in range(1, ndc)]
            coord_dcs = [non_primary[i % len(non_primary)] for i in range(maj)]
            coord_dcs += ["dc0"] * (nco - maj)
        else:
            coord_dcs = ["dc0"] * nco
        self.coord_procs = [
            sim.new_process(f"coord{i}", boot_fn=coord_boot, dc_id=coord_dcs[i])
            for i in range(nco)
        ]
        self.coordinators = [p.address for p in self.coord_procs]

        def worker_boot(index):
            def boot(simu, proc):
                async def go():
                    Worker(simu, proc, self.coordinators, self.cfg.engine_factory,
                           cc_priority=index, cluster_cfg=self.cfg)
                return go()
            return boot

        self.worker_procs = [
            sim.new_process(f"worker{i}", boot_fn=worker_boot(i),
                            dc_id=f"dc{i % ndc}")
            for i in range(self.cfg.n_workers)
        ]
        self._n_clients = 0

    def new_client(self) -> Database:
        self._n_clients += 1
        proc = self.sim.new_process(f"client{self._n_clients}")
        return Database(self.sim.net, proc.address, coordinator_addrs=self.coordinators)


def build_dynamic_cluster(seed: int = 0, cfg: Optional[DynamicClusterConfig] = None) -> DynamicCluster:
    sim = Simulator(seed)
    return DynamicCluster(sim, cfg)
