"""Worker: hosts dynamically recruited roles on one process.

Port of ``foundationdb_tpu/server/worker.py``.

Re-design of fdbserver/worker.actor.cpp (workerServer:481): every cluster
process runs a worker that (1) finds the cluster controller through the
coordinators, (2) registers with it on a heartbeat (registrationClient:253)
and receives ServerDBInfo updates back, (3) constructs roles on Initialize*
requests, keyed by recovery generation so a worker can host the locked
previous tlog generation next to the current one, and (4) retires
generations the master declares dead after a durable cstate hand-over.

Roles die with the process (the sim kill cancels proc.actors and clears
handlers); a rebooted worker re-registers empty — in-memory roles are gone,
which is exactly the reference's behavior for stateless transaction roles.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..core import buggify, error
from ..sim.actors import AsyncVar
from ..sim.loop import TaskPriority, delay, spawn
from ..sim.network import Endpoint, SimProcess
from .coordination import GET_LEADER_TOKEN, GetLeaderRequest, LeaderInfo
from .leader_election import monitor_leader
from .disk_queue import DiskQueue
from .proxy import Proxy, ProxyConfig
from .resolver import Resolver
from .storage import StorageServer
from .tlog import TLog
from .wait_failure import serve_wait_failure

INIT_TLOG_TOKEN = "worker.initTLog"
INIT_RESOLVER_TOKEN = "worker.initResolver"
INIT_PROXY_TOKEN = "worker.initProxy"
INIT_STORAGE_TOKEN = "worker.initStorage"
INIT_MASTER_TOKEN = "worker.initMaster"
RETIRE_TOKEN = "worker.retireGenerations"
RETIRE_STORAGE_TOKEN = "worker.retireStorage"

REGISTER_INTERVAL = 0.5


@dataclass
class ServerDBInfo:
    """reference: ServerDBInfo.h — the broadcast view of the transaction
    system every process tracks. info_version orders updates."""

    info_version: int = 0
    recovery_count: int = 0
    #: orders in-generation map updates (DD moves/splits/merges) from the
    #: same master; one-ways can reorder under clogging
    dd_version: int = 0
    recovery_state: str = "unconfigured"
    master_addr: Optional[str] = None
    proxy_addrs: tuple = ()
    log_config: Any = None                 # LogSystemConfig
    storage_tags: tuple = ()               # (tag, begin, end, address)
    master_status_ep: Any = None           # Endpoint of the master's status


@dataclass
class InitializeTLogRequest:
    gen_id: Tuple[int, int]
    start_version: int
    token_suffix: str
    replica_index: int = 0
    preload: Dict[int, list] = field(default_factory=dict)
    preload_popped: Dict[int, int] = field(default_factory=dict)


@dataclass
class InitializeResolverRequest:
    gen_id: Tuple[int, int]
    start_version: int
    token_suffix: str
    replica_index: int = 0


@dataclass
class InitializeProxyRequest:
    gen_id: Tuple[int, int]
    cfg: ProxyConfig
    start_version: int


@dataclass
class InitializeStorageRequest:
    tag: int
    begin: bytes
    end: bytes
    #: when set, the new replica first copies its shard from these
    #: addresses at fetch_version (MoveKeys' fetchKeys destination)
    fetch_from: Optional[List[str]] = None
    fetch_version: int = 0


@dataclass
class RetireStorageRequest:
    """Drop storage roles whose tag is in `tags` (MoveKeys finish), or —
    with prune=True — any storage role whose tag is NOT in `tags` (the
    master's post-recovery reconcile of orphaned move destinations)."""

    tags: tuple
    prune: bool = False


@dataclass
class InitializeMasterRequest:
    coordinator_addrs: List[str]
    worker_addrs: List[str]
    salt: int
    cc_addr: str
    cluster_cfg: Any                      # DynamicClusterConfig
    #: addr -> (machine_id, dc_id) from worker registrations
    worker_localities: Any = None


@dataclass
class RetireGenerationsRequest:
    """Drop roles of generations with recovery_count < keep_min — sent only
    after the successor generation's cstate write is durable."""

    keep_min: int


class Worker:
    def __init__(self, sim, proc: SimProcess, coordinator_addrs: List[str],
                 engine_factory, cc_priority: Optional[int] = None,
                 cluster_cfg: Any = None):
        self.sim = sim
        self.net = sim.net
        self.proc = proc
        self.coords = list(coordinator_addrs)
        self.engine_factory = engine_factory
        self.cluster_cfg = cluster_cfg
        self.db_info = AsyncVar(ServerDBInfo())
        self.log_view = AsyncVar(None)     # LogSystemConfig for storage
        self.leader = AsyncVar(None)
        #: (kind, recovery_count, salt) -> role object
        self.roles: Dict[Tuple[str, int, int], Any] = {}
        serve_wait_failure(proc)
        proc.register(INIT_TLOG_TOKEN, self.init_tlog)
        proc.register(INIT_RESOLVER_TOKEN, self.init_resolver)
        proc.register(INIT_PROXY_TOKEN, self.init_proxy)
        proc.register(INIT_STORAGE_TOKEN, self.init_storage)
        proc.register(INIT_MASTER_TOKEN, self.init_master)
        proc.register(RETIRE_TOKEN, self.retire_generations)
        proc.register(RETIRE_STORAGE_TOKEN, self.retire_storage)
        proc.actors.add(spawn(
            monitor_leader(self.net, proc.address, self.coords, self.leader),
            TaskPriority.COORDINATION, name=f"monLeader:{proc.name}",
        ))
        proc.actors.add(spawn(self.registration_loop(), TaskPriority.CLUSTER_CONTROLLER,
                              name=f"register:{proc.name}"))
        proc.actors.add(spawn(self.restore_roles(), TaskPriority.CLUSTER_CONTROLLER,
                              name=f"restore:{proc.name}"))
        if cc_priority is not None:
            proc.actors.add(spawn(self.cc_candidacy(cc_priority),
                                  TaskPriority.CLUSTER_CONTROLLER,
                                  name=f"ccCand:{proc.name}"))

    # -- cluster controller candidacy ----------------------------------------
    async def cc_candidacy(self, priority: int) -> None:
        """Every worker may stand for cluster controllership (fdbd():997
        composes candidacy into every process)."""
        from .cluster_controller import ClusterController
        from .leader_election import hold_leadership, try_become_leader

        info = LeaderInfo(self.proc.address,
                          id=self.sim.sched.rng.random_unique_id(),
                          priority=priority)
        while True:
            await try_become_leader(self.net, self.proc.address, self.coords, info)
            cc = ClusterController(self)
            try:
                await hold_leadership(self.net, self.proc.address, self.coords, info)
            finally:
                cc.shutdown()
            await delay(0.5, TaskPriority.CLUSTER_CONTROLLER)

    # -- registration ---------------------------------------------------------
    async def registration_loop(self) -> None:
        """Heartbeat the CC; its replies carry ServerDBInfo
        (registrationClient:253 + the ServerDBInfo broadcast collapsed into
        one request/reply exchange)."""
        from .cluster_controller import CC_REGISTER_TOKEN, WorkerRegisterRequest

        # info_version is scoped to ONE cluster controller instance; a CC
        # failover restarts it at zero, so the known-version watermark must
        # reset when the leader changes or every post-failover broadcast
        # would compare stale-high and be dropped (storage would never learn
        # the new log generation).
        known_version = -1
        last_leader_id = None
        while True:
            leader = self.leader.get()
            if leader is None:
                await self.leader.on_change()
                continue
            if leader.id != last_leader_id:
                last_leader_id = leader.id
                known_version = -1
            try:
                info = await self.net.request(
                    self.proc.address,
                    Endpoint(leader.address, CC_REGISTER_TOKEN),
                    WorkerRegisterRequest(addr=self.proc.address,
                                          known_info_version=known_version,
                                          roles=tuple(sorted({k[0] for k in self.roles})),
                                          locality=(self.proc.machine_id,
                                                    self.proc.dc_id)),
                    TaskPriority.CLUSTER_CONTROLLER,
                    timeout=2.0,
                )
            except error.FDBError:
                await delay(REGISTER_INTERVAL, TaskPriority.CLUSTER_CONTROLLER)
                continue
            if info is not None and info.info_version > known_version:
                if buggify.buggify():
                    # broadcast applied late: roles run a beat behind the
                    # cluster view (stale log_config, stale proxy list)
                    await delay(0.5, TaskPriority.CLUSTER_CONTROLLER)
                known_version = info.info_version
                if info.recovery_count >= self.db_info.get().recovery_count:
                    self.db_info.set(info)
                    if (info.log_config is not None
                            and info.log_config != self.log_view.get()):
                        self.log_view.set(info.log_config)
            interval = REGISTER_INTERVAL
            if buggify.buggify():
                # sluggish registrant: CC liveness/recruitment must not
                # depend on prompt re-registration
                interval = REGISTER_INTERVAL * 6
            await delay(interval, TaskPriority.CLUSTER_CONTROLLER)

    # -- role construction -----------------------------------------------------
    async def init_tlog(self, req: InitializeTLogRequest) -> str:
        if buggify.buggify():
            # slow role construction: recovery must wait, and a competing
            # recovery generation may overtake this one mid-initialize
            await delay(0.3, TaskPriority.CLUSTER_CONTROLLER)
        key = ("tlog", req.gen_id[0], req.gen_id[1], req.replica_index)
        if key not in self.roles:
            disk = self.sim.disk_for(self.proc.address)
            store = f"tlog-{req.gen_id[0]}.{req.gen_id[1]}.{req.replica_index}"
            tlog = TLog(
                self.proc, start_version=req.start_version, gen_id=req.gen_id,
                preload=req.preload, preload_popped=req.preload_popped,
                token_suffix=req.token_suffix,
                queue=DiskQueue(disk, store), store_name=store,
            )
            await tlog.persist_initial(req.token_suffix)
            self.roles[key] = tlog
        return self.proc.address

    async def init_resolver(self, req: InitializeResolverRequest) -> str:
        key = ("resolver", req.gen_id[0], req.gen_id[1], req.replica_index)
        if key not in self.roles:
            pipe = None
            pipe_knobs = getattr(self.cluster_cfg, "resolver_pipeline", None)
            if pipe_knobs is not None:   # {} = pipeline with all defaults
                from ..pipeline.service import PipelineConfig

                pipe = PipelineConfig(**pipe_knobs)
            # device-fault supervisor (fault/resilient.py): watchdog +
            # retries + bit-identical CPU-oracle failover around whatever
            # engine the factory built
            from ..fault import maybe_wrap

            engine = maybe_wrap(self.engine_factory(), self.cluster_cfg)
            self.roles[key] = Resolver(
                self.proc, engine,
                start_version=req.start_version, token_suffix=req.token_suffix,
                index=req.replica_index, pipeline=pipe,
            )
        return self.proc.address

    async def init_proxy(self, req: InitializeProxyRequest) -> str:
        # One proxy per worker: the newcomer replaces any predecessor (its
        # generation is over by construction — recruitment happens after the
        # old generation is locked).
        for key in [k for k in self.roles if k[0] == "proxy"]:
            self.roles.pop(key).shutdown()
        key = ("proxy", req.gen_id[0], req.gen_id[1], 0)
        self.roles[key] = Proxy(self.proc, self.net, req.cfg,
                                start_version=req.start_version)
        return self.proc.address

    async def init_storage(self, req: InitializeStorageRequest) -> str:
        from ..core.types import KeyRange

        key = ("storage", 0, req.tag, 0)
        if key not in self.roles:
            fetch = req.fetch_from is not None
            ss = await StorageServer.create(
                self.proc, tag=req.tag, shard=KeyRange(req.begin, req.end),
                log_view=self.log_view, net=self.net,
                disk=self.sim.disk_for(self.proc.address),
                defer_update_loop=fetch,
            )
            if fetch:
                # MoveKeys destination: copy the shard BEFORE persisting the
                # role (a crash mid-fetch leaves no half-alive replica), then
                # let the update loop drain this tag's buffered mutations.
                if buggify.buggify():
                    # stalled fetch start: the donor team serves reads (and
                    # the tag stream buffers at the tlogs) meanwhile
                    await delay(0.5, TaskPriority.FETCH_KEYS)
                await ss.fetch_keys(req.fetch_from, req.fetch_version)
                await ss.persist_initial()
                ss.start_update_loop()
            else:
                await ss.persist_initial()
            self.roles[key] = ss
        return self.proc.address

    async def retire_storage(self, req: RetireStorageRequest) -> None:
        for key in list(self.roles):
            kind, _z, tag, _i = key
            if kind != "storage":
                continue
            drop = (tag not in req.tags) if req.prune else (tag in req.tags)
            if drop:
                self.roles.pop(key).retire()

    async def init_master(self, req: InitializeMasterRequest):
        from .masterserver import MasterServer

        ms = MasterServer(self, req)
        key = ("master", 0, req.salt, 0)
        self.roles[key] = ms
        wf_token = f"waitFailure:master:{req.salt}"
        serve_wait_failure(self.proc, wf_token)
        task = spawn(ms.run(), TaskPriority.CLUSTER_CONTROLLER, name=f"master:{req.salt}")
        self.proc.actors.add(task)

        def on_done(_f) -> None:
            # Master role over (recovery failed or a role died): watchers of
            # the role-scoped wait-failure endpoint see silence -> failure.
            self.proc.unregister(wf_token)
            self.roles.pop(key, None)

        task.on_ready(on_done)
        return Endpoint(self.proc.address, wf_token)

    async def restore_roles(self) -> None:
        """Re-create durable roles from disk after a reboot (the reference
        worker's DiskStore scan + restorePersistentState,
        worker.actor.cpp:208)."""
        disk = self.sim.disk_for(self.proc.address)
        for name in disk.list():
            if not name.endswith(".meta"):
                continue
            # Identity comes from the FILENAME, checked against live roles
            # BEFORE constructing: role constructors register tokens, so a
            # duplicate would silently steal a live role's handlers and
            # open a second writer on its files.
            base = name[: -len(".meta")]
            if name.startswith("tlog-"):
                try:
                    rc_s, salt_s, idx_s = base[len("tlog-"):].split(".")
                    key = ("tlog", int(rc_s), int(salt_s), int(idx_s))
                except ValueError:
                    continue
                if key in self.roles:
                    continue
                tlog = await TLog.restore(self.proc, disk, name)
                if tlog is not None:
                    self.roles[key] = tlog
            elif name.startswith("storage-"):
                try:
                    key = ("storage", 0, int(base[len("storage-"):]), 0)
                except ValueError:
                    continue
                if key in self.roles:
                    continue
                ss = await StorageServer.restore(
                    self.proc, disk, name, self.log_view, self.net
                )
                if ss is not None:
                    self.roles[key] = ss

    async def retire_generations(self, req: RetireGenerationsRequest) -> None:
        for key in list(self.roles):
            kind, rc, salt, idx = key
            if rc >= req.keep_min:
                continue
            if kind == "tlog":
                role = self.roles.pop(key)
                role.unregister()
                role.delete_files()
            elif kind == "resolver":
                self.roles.pop(key).unregister()
            elif kind == "proxy":
                # A deposed generation's proxy must stop serving GRV, or a
                # client with it cached reads pre-jump versions forever.
                self.roles.pop(key).shutdown()
