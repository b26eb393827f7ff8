"""Cluster controller: the elected singleton that owns recruitment.

Port of ``foundationdb_tpu/server/cluster_controller.py``.

Re-design of fdbserver/ClusterController.actor.cpp, in this scope:

  * worker registry fed by registration heartbeats (registrationClient /
    workerAvailabilityWatch:1272); replies carry the latest ServerDBInfo so
    registration doubles as the broadcast channel.
  * clusterWatchDatabase (:1000): keep exactly one master alive — pick a
    worker, hand it the recovery brief, watch its role-scoped wait-failure
    endpoint, recruit a successor the moment it dies. The master itself
    runs the epoch recovery state machine (masterserver.py) and reports
    back with the recovered ServerDBInfo.
  * openDatabase (:1127): clients fetch the proxy list here.

The CC is pure control plane: killing it stalls recruitment until a new
leader is elected but never blocks the data path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..core import error
from ..core.trace import TraceEvent
from ..sim.actors import ActorCollection
from ..sim.loop import TaskPriority, delay, now, spawn
from ..sim.network import Endpoint
from .wait_failure import wait_failure_client
from .worker import InitializeMasterRequest, ServerDBInfo

CC_REGISTER_TOKEN = "cc.registerWorker"
CC_OPEN_DATABASE_TOKEN = "cc.openDatabase"
CC_MASTER_RECOVERED_TOKEN = "cc.masterRecovered"
CC_STATUS_TOKEN = "cc.status"

#: a worker silent this long is not considered for recruitment
WORKER_STALE_SECONDS = 2.0


@dataclass
class WorkerRegisterRequest:
    addr: str
    known_info_version: int = -1
    #: role kinds this worker currently hosts (for the status document's
    #: machine layer; reference: worker details in Status.actor.cpp)
    roles: tuple = ()
    #: (machine_id, dc_id) — the sim's LocalityData (fdbrpc/Locality.h),
    #: feeding the master's replication policy
    locality: tuple = ("", "")


@dataclass
class OpenDatabaseRequest:
    known_info_version: int = -1


class ClusterController:
    def __init__(self, worker):
        """Constructed by the winning worker's candidacy loop; `worker` is
        the hosting Worker (its process, net, coordinators, cluster_cfg)."""
        self.worker = worker
        self.net = worker.net
        self.proc = worker.proc
        #: addr -> role kinds last reported in registration
        self.worker_roles = {}
        self.worker_locality = {}
        #: (recovery_count, sim time) for every master hand-over seen
        self.recovery_history = []
        self.coords = worker.coords
        self.cluster_cfg = worker.cluster_cfg
        self.workers: Dict[str, float] = {}            # addr -> last_seen
        self.db_info = ServerDBInfo(info_version=0, recovery_state="recruiting")
        self.actors = ActorCollection()
        self._dead = False
        self.proc.register(CC_REGISTER_TOKEN, self.register_worker)
        self.proc.register(CC_OPEN_DATABASE_TOKEN, self.open_database)
        self.proc.register(CC_MASTER_RECOVERED_TOKEN, self.master_recovered)
        self.proc.register(CC_STATUS_TOKEN, self.get_status)
        self._spawn(self.cluster_watch_database(), "clusterWatchDatabase")

    def _spawn(self, coro, name):
        t = spawn(coro, TaskPriority.CLUSTER_CONTROLLER, name=name)
        self.proc.actors.add(t)
        self.actors.add(t)
        return t

    def shutdown(self) -> None:
        """Leadership lost: stop recruiting (a successor CC owns it now)."""
        if self._dead:
            return
        self._dead = True
        for tok in (CC_REGISTER_TOKEN, CC_OPEN_DATABASE_TOKEN,
                    CC_MASTER_RECOVERED_TOKEN, CC_STATUS_TOKEN):
            self.proc.unregister(tok)
        self.actors.cancel_all()

    # -- worker registry ------------------------------------------------------
    async def register_worker(self, req: WorkerRegisterRequest) -> Optional[ServerDBInfo]:
        from ..core import buggify

        self.workers[req.addr] = now()
        self.worker_roles[req.addr] = tuple(req.roles)
        self.worker_locality[req.addr] = tuple(req.locality)
        if buggify.buggify():
            # drop the broadcast piggyback once: the worker stays a beat
            # stale and must pick the view up on its next heartbeat
            return None
        if req.known_info_version < self.db_info.info_version:
            return self.db_info
        return None

    def _alive_workers(self) -> list:
        t = now()
        return [
            a for a, seen in sorted(self.workers.items())
            if t - seen < WORKER_STALE_SECONDS and not self.net.monitor.is_failed(a)
        ]

    # -- client surface -------------------------------------------------------
    async def open_database(self, req: OpenDatabaseRequest) -> ServerDBInfo:
        return self.db_info

    async def get_status(self, _req) -> dict:
        """The machine-readable cluster status document (clusterGetStatus,
        Status.actor.cpp:1759), aggregated live from the master's fragment
        and the storage servers' queue info."""
        from .ratekeeper import STORAGE_QUEUE_INFO_TOKEN

        info = self.db_info
        t = now()
        doc = {
            "cluster": {
                "controller": self.proc.address,
                "recovery_state": info.recovery_state,
                "generation": info.recovery_count,
                "master": info.master_addr,
                "proxies": list(info.proxy_addrs),
                "log_generation": (str(info.log_config.gen_id)
                                   if info.log_config is not None else None),
                "workers": {
                    addr: {
                        "seconds_since_heartbeat": round(t - seen, 3),
                        "roles": sorted(self.worker_roles.get(addr, ())),
                    }
                    for addr, seen in sorted(self.workers.items())
                },
                "recovery_history": list(self.recovery_history),
            },
            "qos": {},
            "storage": [],
            "data": {"shards": []},
        }
        if info.master_status_ep is not None:
            try:
                frag = await self.net.request(
                    self.proc.address, info.master_status_ep, None,
                    TaskPriority.CLUSTER_CONTROLLER, timeout=1.0,
                )
                doc["cluster"]["version"] = frag["version"]
                doc["cluster"]["roles"] = {
                    "tlogs": frag["tlogs"], "resolvers": frag["resolvers"],
                    "proxies": frag["proxies"],
                }
                doc["qos"] = {
                    "transactions_per_second_limit": frag["tps_limit"],
                    "worst_storage_lag_versions": frag["worst_storage_lag_versions"],
                    # stale = every storage poll timed out; worst_lag is a
                    # reset placeholder, not a healthy 0 (ratekeeper.py)
                    "storage_lag_stale": frag.get("storage_lag_stale", False),
                    # conflict-engine health (fault/resilient.py): degraded
                    # = some resolver is retrying/failed over/on probation
                    "resolver_degraded": frag.get("resolvers_degraded", False),
                    "resolver_health": frag.get("resolver_health", {}),
                    # unified resolver telemetry (docs/observability.md):
                    # engine perf counters + budget-batcher EWMAs per
                    # resolver, consumed by `tools/cli.py telemetry`
                    "resolver_telemetry": frag.get("resolver_telemetry", {}),
                }
            except error.FDBError:
                doc["cluster"]["version"] = None
        for addr in info.proxy_addrs:
            try:
                doc.setdefault("proxy_stats", {})[addr] = await self.net.request(
                    self.proc.address, Endpoint(addr, "proxy.stats"), None,
                    TaskPriority.CLUSTER_CONTROLLER, timeout=1.0,
                )
            except error.FDBError:
                pass
        committed = doc["cluster"].get("version")
        shards = {}
        for tag, b, e, addr in info.storage_tags:
            entry = {"tag": tag, "address": addr,
                     "shard_begin": b.hex(), "shard_end": e.hex()}
            try:
                qi = await self.net.request(
                    self.proc.address, Endpoint(addr, STORAGE_QUEUE_INFO_TOKEN),
                    None, TaskPriority.CLUSTER_CONTROLLER, timeout=1.0,
                )
                entry["version"] = qi.version
                entry["durable_version"] = qi.durable_version
                entry["queue_bytes"] = getattr(qi, "queue_bytes", 0)
                if committed is not None:
                    # fetch lag, not durability lag: the durable version
                    # trails by design (storage_durability_lag_versions)
                    entry["lag_versions"] = max(0, committed - qi.version)
                entry["counters"] = await self.net.request(
                    self.proc.address, Endpoint(addr, "storage.stats"), None,
                    TaskPriority.CLUSTER_CONTROLLER, timeout=1.0,
                )
            except error.FDBError:
                entry["unreachable"] = True
            doc["storage"].append(entry)
            shards.setdefault((b, e), []).append(entry)
        doc["data"]["shards"] = [
            {
                "begin": b.hex(), "end": e.hex(),
                "replicas": [x["address"] for x in team],
                "replication": len(team),
                "healthy": all(not x.get("unreachable") for x in team),
            }
            for (b, e), team in sorted(shards.items())
        ]
        return doc

    # -- database watch -------------------------------------------------------
    async def master_recovered(self, info: ServerDBInfo) -> None:
        """The master finished its recovery transaction + cstate write. A
        delayed report from an older, deposed generation must not overwrite
        a newer one (one-ways can reorder under clogging)."""
        cur = (self.db_info.recovery_count, self.db_info.dd_version)
        if (info.recovery_count, getattr(info, "dd_version", 0)) <= cur:
            return
        info.info_version = self.db_info.info_version + 1
        self.db_info = info
        self.recovery_history.append((info.recovery_count, round(now(), 3)))
        del self.recovery_history[:-20]
        TraceEvent("MasterRecoveredToCC").detail("RecoveryCount", info.recovery_count).log()

    async def cluster_watch_database(self) -> None:
        """Keep one master alive (clusterWatchDatabase:1000)."""
        # Enough registered workers to separate storage from transaction
        # roles and spread tlog replicas (the reference waits for a viable
        # RecruitFromConfiguration before starting a master).
        min_workers = min(self.cluster_cfg.n_workers,
                          self.cluster_cfg.n_storage + 2)
        ndc = max(1, getattr(self.cluster_cfg, "n_dcs", 1))
        dc_grace_until = None
        while True:
            candidates = self._alive_workers()
            if len(candidates) < min_workers:
                await delay(0.5, TaskPriority.CLUSTER_CONTROLLER)
                continue
            # placement quality: wait (bounded) for the FULL fleet — and in
            # multi-region, for every DC — to register before recruiting a
            # master; a partial registry places tlogs/satellites/teams
            # blind. The bound keeps dead workers or a dead DC from
            # wedging recovery (failover recruits with whoever is left).
            dcs = {self.worker_locality.get(a, ("", "dc0"))[1]
                   for a in candidates}
            complete = (len(candidates) >= self.cluster_cfg.n_workers
                        and len(dcs) >= ndc)
            if not complete:
                if dc_grace_until is None:
                    dc_grace_until = now() + 5.0
                if now() < dc_grace_until:
                    await delay(0.5, TaskPriority.CLUSTER_CONTROLLER)
                    continue
            dc_grace_until = None
            # Prefer not to co-locate the master with the CC when possible
            # (the reference's fitness preference, reduced to its core).
            others = [a for a in candidates if a != self.proc.address]
            target = (others or candidates)[0]
            from ..core import buggify

            if buggify.buggify() and len(others) > 1:
                # adversarial placement: recruit the master on a different
                # worker than the deterministic preference would pick
                target = others[-1]
            salt = self.worker.sim.sched.rng.random_unique_id()
            from .worker import INIT_MASTER_TOKEN

            try:
                wf_ep = await self.net.request(
                    self.proc.address,
                    Endpoint(target, INIT_MASTER_TOKEN),
                    InitializeMasterRequest(
                        coordinator_addrs=self.coords,
                        worker_addrs=self._alive_workers(),
                        salt=salt,
                        cc_addr=self.proc.address,
                        cluster_cfg=self.cluster_cfg,
                        worker_localities=dict(self.worker_locality),
                    ),
                    TaskPriority.CLUSTER_CONTROLLER,
                    timeout=2.0,
                )
            except error.FDBError:
                self.workers.pop(target, None)
                self.worker_roles.pop(target, None)
                await delay(0.5, TaskPriority.CLUSTER_CONTROLLER)
                continue
            TraceEvent("CCRecruitedMaster").detail("Worker", target).detail("Salt", salt).log()
            # Watch the master role; silence = dead role (or dead process).
            await wait_failure_client(self.net, self.proc.address, wf_ep)
            TraceEvent("CCMasterFailed").detail("Worker", target).log()
            stale = ServerDBInfo(
                info_version=self.db_info.info_version + 1,
                recovery_count=self.db_info.recovery_count,
                recovery_state="recruiting",
                master_addr=None,
                proxy_addrs=(),
                log_config=self.db_info.log_config,
                storage_tags=self.db_info.storage_tags,
            )
            self.db_info = stale
