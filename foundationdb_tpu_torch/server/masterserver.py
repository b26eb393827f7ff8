"""Master server: the epoch recovery state machine + version authority.

Port of ``foundationdb_tpu/server/masterserver.py``.

Re-design of fdbserver/masterserver.actor.cpp (masterCore:1104,
recoverFrom:728, readTransactionSystemState:586). One master owns one
epoch; recovery is:

  READING_CSTATE   read DBCoreState from a coordinator majority
  LOCKING_CSTATE   write it back with a bumped recovery_count — the
                   exclusive-generation write kills any straggling older
                   master's future cstate writes (split-brain guard)
  LOCKING_TLOGS    lock the previous tlog generation; recovery version =
                   min(end) over the locked set (log_system.lock_generation)
  RECRUITING       fetch the un-popped window from a locked replica, then
                   construct the new generation on chosen workers: K tlogs
                   (seeded with the copy), resolvers, the version authority,
                   one proxy; on an empty cstate also seed storage servers
                   (newSeedServers, masterserver.actor.cpp:325)
  WRITING_CSTATE   write the new generation into the coordinated state —
                   the durable hand-over; only after this may clients see
                   the new proxies
  FULLY_RECOVERED  announce ServerDBInfo to the CC, retire generations
                   older than ours on all workers, then watch every
                   recruited role host: any failure ends this master, and
                   the CC recruits a successor (the whole transaction
                   subsystem is disposable, SURVEY.md §5)

The first commit version of a post-crash epoch jumps past the MVCC window
(Master.first_jump) so pre-recovery read snapshots resolve TOO_OLD at the
fresh resolvers instead of silently missing lost conflict history.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from ..core import buggify, error
from ..core.trace import TraceEvent
from ..core.keyshard import KeyShardMap
from ..sim.actors import all_of, any_of
from ..sim.loop import TaskPriority, delay, spawn
from ..sim.network import Endpoint
from . import system_keys
from .coordinated_state import CoordinatedState, DBCoreState, LogGenerationInfo
from .log_system import LogSystemConfig, fetch_recovery_data, lock_generation
from .master import GET_COMMIT_VERSION_TOKEN, Master, RECOVERY_VERSION_JUMP
from .proxy import ProxyConfig, teams_from_storage_tags
from .ratekeeper import GET_RATE_INFO_TOKEN, Ratekeeper
from .resolver import RESOLVE_TOKEN, RESOLVER_HEALTH_TOKEN
from .wait_failure import WAIT_FAILURE_TOKEN, wait_failure_client
from .worker import (
    InitializeProxyRequest,
    InitializeResolverRequest,
    InitializeStorageRequest,
    InitializeTLogRequest,
    INIT_PROXY_TOKEN,
    INIT_RESOLVER_TOKEN,
    INIT_STORAGE_TOKEN,
    INIT_TLOG_TOKEN,
    RETIRE_TOKEN,
    RETIRE_STORAGE_TOKEN,
    RetireGenerationsRequest,
    RetireStorageRequest,
    ServerDBInfo,
)

RECRUIT_TIMEOUT = 2.0
MOVE_SHARD_TOKEN = "master.moveShard"


def _teams_by_begin(storage_tags) -> "Dict[bytes, List[Tuple[int, str]]]":
    out: Dict[bytes, List[Tuple[int, str]]] = {}
    for tag, b, _e, addr in storage_tags:
        out.setdefault(b, []).append((tag, addr))
    return {b: sorted(t) for b, t in out.items()}


@dataclass
class MoveShardRequest:
    """Management request: move the whole shard beginning at `begin` to a
    team on `dest_workers` (one replica each). reference: MoveKeys
    (MoveKeys.actor.cpp:821), driven here by a DD-lite under the master."""

    begin: bytes
    dest_workers: List[str]


EXCLUDE_TOKEN = "master.exclude"


@dataclass
class ExcludeServersRequest:
    """ManagementAPI excludeServers (ManagementAPI.actor.cpp): drain every
    shard replica off `addresses` by moving affected shards to spare
    workers; with exclude=False, re-admit the addresses as move targets."""

    addresses: List[str]
    exclude: bool = True


class MasterServer:
    def __init__(self, worker, req):
        self.worker = worker
        self.net = worker.net
        self.proc = worker.proc
        self.coords = req.coordinator_addrs
        self.workers = list(req.worker_addrs)
        self.salt = req.salt
        self.cc_addr = req.cc_addr
        self.cfg = req.cluster_cfg
        #: addr -> (machine_id, dc_id) for policy-driven team placement
        self.localities = dict(getattr(req, "worker_localities", None) or {})
        self.master: Optional[Master] = None

    def _state(self, s: str, **details) -> None:
        ev = TraceEvent("MasterRecoveryState", id=self.salt).detail("State", s)
        for k, v in details.items():
            ev.detail(k, v)
        ev.log()

    def _init_role(self, addr: str, token: str, req):
        """Future of the role's Initialize reply (awaitable or all_of-able)."""
        return self.net.request(
            self.proc.address, Endpoint(addr, token), req,
            TaskPriority.CLUSTER_CONTROLLER, timeout=RECRUIT_TIMEOUT,
        )

    async def run(self) -> None:
        try:
            await self._recover_and_serve()
        except error.FDBError as e:
            TraceEvent("MasterTerminated", id=self.salt).detail("Reason", e.name).log()
            if self.master is not None:
                self.master.unregister()
            # Falling out ends the role; the worker unregisters our
            # wait-failure token and the CC recruits a successor.

    async def _move_shard(self, req: MoveShardRequest, dd, dd_db, log_client,
                          cstate, ratekeeper):
        """MoveKeys v0 (MoveKeys.actor.cpp:821 reduced to whole shards):

          1. commit keyServers(begin) = old team + new tags — proxies drain
             this through the metadata stream and start double-tagging the
             range, so the log buffers the destinations' history;
          2. recruit destination replicas, which fetchKeys a snapshot at a
             read version taken AFTER step 1 and then drain their tag;
          3. commit keyServers(begin) = new team — reads/writes flip;
          4. persist the new map in cstate (the recovery authority), then
             retire the old replicas and their tags.
        A crash before (4) recovers with the OLD map: the old team was
        never retired, and dd_init prunes the orphaned destinations."""
        tags = dd["storage_tags"]
        team = sorted((t, a) for (t, b, _e, a) in tags if b == req.begin)
        if not team:
            raise error.client_invalid_operation(f"no shard begins at {req.begin!r}")
        end = next(e for (_t, b, e, _a) in tags if b == req.begin)
        dests = list(req.dest_workers)
        if len(dests) != len(team) or len(set(dests)) != len(dests):
            raise error.client_invalid_operation("need one distinct dest per replica")
        busy_addrs = {a for (_t, _b, _e, a) in tags}
        if any(d in busy_addrs for d in dests):
            raise error.client_invalid_operation("dest already hosts storage")
        if any(d in dd["excluded"] for d in dests):
            raise error.client_invalid_operation("dest is excluded")
        next_tag = dd["next_tag"]                 # monotone allocator:
        dd["next_tag"] += len(dests)              # unique across CONCURRENT
        new_team = [(next_tag + i, d) for i, d in enumerate(dests)]
        TraceEvent("MoveShardStart", id=self.salt).detail(
            "Begin", req.begin).detail("NewTeam", str(new_team)).log()

        # (1) old + new tags: destinations' history starts accumulating
        async def ph1(tr):
            tr.set_access_system_keys()
            tr.set(system_keys.key_servers_key(req.begin),
                   system_keys.encode_key_servers(team, tuple(t for t, _ in new_team)))
        await dd_db.run(ph1)

        try:
            # (2) fetch version AFTER (1): the tag stream covers all newer
            tr = dd_db.create_transaction()
            v0 = await tr.get_read_version()
            await all_of([
                self.net.request(
                    self.proc.address, Endpoint(d, INIT_STORAGE_TOKEN),
                    InitializeStorageRequest(
                        tag=nt, begin=req.begin, end=end,
                        fetch_from=[a for _t, a in team], fetch_version=v0,
                    ),
                    TaskPriority.MOVE_KEYS, timeout=60.0,
                )
                for nt, d in new_team
            ])

            # (3) flip
            async def ph2(tr):
                tr.set_access_system_keys()
                tr.set(system_keys.key_servers_key(req.begin),
                       system_keys.encode_key_servers(new_team))
            await dd_db.run(ph2)
        except error.FDBError:
            # Roll back (1): stop double-tagging, retire half-built
            # destinations and their tags. If the rollback commit itself
            # fails, the next epoch's dd_init reseeds keyServers from
            # cstate and prunes the orphans — the backstop.
            TraceEvent("MoveShardAbort", id=self.salt).detail("Begin", req.begin).log()

            async def rollback(tr):
                tr.set_access_system_keys()
                tr.set(system_keys.key_servers_key(req.begin),
                       system_keys.encode_key_servers(team))
            await dd_db.run(rollback)
            for nt, d in new_team:
                self.net.one_way(self.proc.address, Endpoint(d, RETIRE_STORAGE_TOKEN),
                                 RetireStorageRequest(tags=(nt,)),
                                 TaskPriority.MOVE_KEYS)
                log_client.pop(nt, -1)
            raise

        # (4) durable authority + cleanup
        await self._publish_tags(dd, cstate, ratekeeper, lambda cur: (
            [(t, b, e, a) for (t, b, e, a) in cur if b != req.begin]
            + [(nt, req.begin, end, d) for nt, d in new_team]
        ))
        for t, a in team:
            self.net.one_way(self.proc.address, Endpoint(a, RETIRE_STORAGE_TOKEN),
                             RetireStorageRequest(tags=(t,)),
                             TaskPriority.MOVE_KEYS)
            log_client.pop(t, -1)
        TraceEvent("MoveShardDone", id=self.salt).detail("Begin", req.begin).log()
        return {"begin": req.begin, "team": new_team}

    async def _publish_tags(self, dd, cstate, ratekeeper, transform) -> None:
        """Persist a storage-map change in cstate (the recovery authority)
        and fan the new map out to ratekeeper + the CC status document.
        `transform(cur_tags) -> new_tags` is applied to the CURRENT map
        UNDER the publish mutex: concurrent relocations of disjoint shards
        compose instead of overwriting each other's publishes (a
        precomputed list would lose whichever write landed first)."""
        from dataclasses import replace
        from .cluster_controller import CC_MASTER_RECOVERED_TOKEN

        async with dd["publish_mutex"]:
            new_tags = sorted(transform(list(dd["storage_tags"])))
            dd["cstate_val"] = replace(dd["cstate_val"],
                                       storage_tags=tuple(new_tags))
            await cstate.set_exclusive(dd["cstate_val"])
            dd["storage_tags"][:] = new_tags
            ratekeeper.storage_tags = list(new_tags)
            dd["info"] = replace(dd["info"], storage_tags=tuple(new_tags),
                                 dd_version=dd["info"].dd_version + 1)
            self.net.one_way(self.proc.address,
                             Endpoint(self.cc_addr, CC_MASTER_RECOVERED_TOKEN),
                             dd["info"], TaskPriority.CLUSTER_CONTROLLER)

    async def _split_shard(self, begin, split_key, dests, dd, dd_db,
                           log_client, cstate, ratekeeper):
        """DD shard split (DataDistributionTracker's shardSplitter +
        MoveKeys combined): the team keeps [begin, split_key); a fresh team
        is recruited for [split_key, end) — double-tagged, fetched at a
        post-split read version, flipped, then the old replicas SHRINK."""
        from .storage import SHRINK_SHARD_TOKEN, ShrinkShardRequest

        tags = dd["storage_tags"]
        team = sorted((t, a) for (t, b, _e, a) in tags if b == begin)
        if not team:
            raise error.client_invalid_operation(f"no shard begins at {begin!r}")
        end = next(e for (_t, b, e, _a) in tags if b == begin)
        if not (begin < split_key < end):
            raise error.client_invalid_operation("split key outside shard")
        next_tag = dd["next_tag"]                 # monotone allocator
        dd["next_tag"] += len(dests)
        new_team = [(next_tag + i, d) for i, d in enumerate(dests)]
        TraceEvent("ShardSplitStart", id=self.salt).detail(
            "Begin", begin).detail("SplitKey", split_key).log()

        async def ph1(tr):
            tr.set_access_system_keys()
            tr.set(system_keys.key_servers_key(split_key),
                   system_keys.encode_key_servers(
                       team, tuple(t for t, _ in new_team)))
        await dd_db.run(ph1)
        try:
            tr = dd_db.create_transaction()
            v0 = await tr.get_read_version()
            await all_of([
                self.net.request(
                    self.proc.address, Endpoint(d, INIT_STORAGE_TOKEN),
                    InitializeStorageRequest(
                        tag=nt, begin=split_key, end=end,
                        fetch_from=[a for _t, a in team], fetch_version=v0,
                    ),
                    TaskPriority.MOVE_KEYS, timeout=60.0,
                )
                for nt, d in new_team
            ])

            async def ph2(tr):
                tr.set_access_system_keys()
                tr.set(system_keys.key_servers_key(split_key),
                       system_keys.encode_key_servers(new_team))
            await dd_db.run(ph2)
        except error.FDBError:
            TraceEvent("ShardSplitAbort", id=self.salt).detail("Begin", begin).log()

            async def rollback(tr):
                tr.set_access_system_keys()
                tr.set(system_keys.key_servers_key(split_key),
                       system_keys.encode_key_servers([]))   # drop boundary
            await dd_db.run(rollback)
            for nt, d in new_team:
                self.net.one_way(self.proc.address, Endpoint(d, RETIRE_STORAGE_TOKEN),
                                 RetireStorageRequest(tags=(nt,)),
                                 TaskPriority.MOVE_KEYS)
                log_client.pop(nt, -1)
            raise

        # durable authority BEFORE shrinking: a crash after this point
        # recovers with the split map and both teams intact
        await self._publish_tags(dd, cstate, ratekeeper, lambda cur: (
            [(t, b, split_key if b == begin else e, a)
             for (t, b, e, a) in cur]
            + [(nt, split_key, end, d) for nt, d in new_team]
        ))
        await all_of([
            self.net.request(
                self.proc.address, Endpoint(a, SHRINK_SHARD_TOKEN),
                ShrinkShardRequest(tag=t, new_end=split_key),
                TaskPriority.MOVE_KEYS, timeout=10.0,
            )
            for t, a in team
        ])
        TraceEvent("ShardSplitDone", id=self.salt).detail(
            "Begin", begin).detail("SplitKey", split_key).log()
        return {"begin": begin, "split_key": split_key, "new_team": new_team}

    async def _merge_shards(self, begin1, begin2, dd, dd_db, log_client,
                            cstate, ratekeeper):
        """DD shard merge (shardMerger): the lower team absorbs the upper
        range — double-tag the upper shard with the lower team's tags,
        EXTEND the lower replicas (fetch at a post-tag version), remove the
        boundary, retire the upper team."""
        from .storage import EXTEND_SHARD_TOKEN, ExtendShardRequest

        tags = dd["storage_tags"]
        team1 = sorted((t, a) for (t, b, _e, a) in tags if b == begin1)
        team2 = sorted((t, a) for (t, b, _e, a) in tags if b == begin2)
        if not team1 or not team2:
            raise error.client_invalid_operation("merge shards not found")
        end1 = next(e for (_t, b, e, _a) in tags if b == begin1)
        end2 = next(e for (_t, b, e, _a) in tags if b == begin2)
        if end1 != begin2:
            raise error.client_invalid_operation("shards not adjacent")
        TraceEvent("ShardMergeStart", id=self.salt).detail(
            "Begin", begin1).detail("Upper", begin2).log()

        async def ph1(tr):
            tr.set_access_system_keys()
            tr.set(system_keys.key_servers_key(begin2),
                   system_keys.encode_key_servers(
                       team2, tuple(t for t, _ in team1)))
        await dd_db.run(ph1)
        tr = dd_db.create_transaction()
        v0 = await tr.get_read_version()
        await all_of([
            self.net.request(
                self.proc.address, Endpoint(a, EXTEND_SHARD_TOKEN),
                ExtendShardRequest(tag=t, new_end=end2,
                                   fetch_from=[a2 for _t2, a2 in team2],
                                   fetch_version=v0),
                TaskPriority.MOVE_KEYS, timeout=60.0,
            )
            for t, a in team1
        ])

        async def ph2(tr):
            tr.set_access_system_keys()
            tr.set(system_keys.key_servers_key(begin2),
                   system_keys.encode_key_servers([]))   # remove boundary
        await dd_db.run(ph2)

        await self._publish_tags(dd, cstate, ratekeeper, lambda cur: (
            [(t, b, end2 if b == begin1 else e, a)
             for (t, b, e, a) in cur if b != begin2]
        ))
        for t, a in team2:
            self.net.one_way(self.proc.address, Endpoint(a, RETIRE_STORAGE_TOKEN),
                             RetireStorageRequest(tags=(t,)),
                             TaskPriority.MOVE_KEYS)
            log_client.pop(t, -1)
        TraceEvent("ShardMergeDone", id=self.salt).detail("Begin", begin1).log()
        return {"begin": begin1, "end": end2}

    async def _grow_team(self, begin, dest, dd, dd_db, log_client, cstate,
                         ratekeeper) -> None:
        """Add one replica to the shard at `begin` (the replication fixer's
        move toward a raised \\xff/conf/replication): double-tag via
        keyServers, fetch at a post-tag version, flip to the full team —
        the MoveKeys recruit half without a retire half."""
        from .storage import SHRINK_SHARD_TOKEN  # noqa: F401  (parity import)

        tags = dd["storage_tags"]
        team = sorted((t, a) for (t, b, _e, a) in tags if b == begin)
        if not team:
            raise error.client_invalid_operation(f"no shard begins at {begin!r}")
        end = next(e for (_t, b, e, _a) in tags if b == begin)
        nt = dd["next_tag"]                       # monotone allocator
        dd["next_tag"] += 1
        TraceEvent("TeamGrowStart", id=self.salt).detail(
            "Begin", begin).detail("Dest", dest).log()

        async def ph1(tr):
            tr.set_access_system_keys()
            tr.set(system_keys.key_servers_key(begin),
                   system_keys.encode_key_servers(team, (nt,)))
        await dd_db.run(ph1)
        try:
            tr = dd_db.create_transaction()
            v0 = await tr.get_read_version()
            await self.net.request(
                self.proc.address, Endpoint(dest, INIT_STORAGE_TOKEN),
                InitializeStorageRequest(
                    tag=nt, begin=begin, end=end,
                    fetch_from=[a for _t, a in team], fetch_version=v0,
                ),
                TaskPriority.MOVE_KEYS, timeout=60.0,
            )

            async def ph2(tr2):
                tr2.set_access_system_keys()
                tr2.set(system_keys.key_servers_key(begin),
                        system_keys.encode_key_servers(team + [(nt, dest)]))
            await dd_db.run(ph2)
        except error.FDBError:
            TraceEvent("TeamGrowAbort", id=self.salt).detail("Begin", begin).log()

            async def rollback(tr2):
                tr2.set_access_system_keys()
                tr2.set(system_keys.key_servers_key(begin),
                        system_keys.encode_key_servers(team))
            await dd_db.run(rollback)
            self.net.one_way(self.proc.address, Endpoint(dest, RETIRE_STORAGE_TOKEN),
                             RetireStorageRequest(tags=(nt,)),
                             TaskPriority.MOVE_KEYS)
            log_client.pop(nt, -1)
            raise
        await self._publish_tags(
            dd, cstate, ratekeeper,
            lambda cur: list(cur) + [(nt, begin, end, dest)])
        TraceEvent("TeamGrowDone", id=self.salt).detail("Begin", begin).log()

    async def _shrink_team(self, begin, dd, dd_db, log_client, cstate,
                           ratekeeper) -> None:
        """Drop the shard's highest-tag replica (a lowered replication
        factor): flip keyServers to the smaller team, publish, retire."""
        tags = dd["storage_tags"]
        team = sorted((t, a) for (t, b, _e, a) in tags if b == begin)
        if len(team) <= 1:
            raise error.client_invalid_operation("cannot shrink below one replica")
        victim_t, victim_a = team[-1]
        keep = team[:-1]

        async def ph(tr):
            tr.set_access_system_keys()
            tr.set(system_keys.key_servers_key(begin),
                   system_keys.encode_key_servers(keep))
        await dd_db.run(ph)
        await self._publish_tags(
            dd, cstate, ratekeeper,
            lambda cur: [t for t in cur
                         if not (t[0] == victim_t and t[1] == begin)])
        self.net.one_way(self.proc.address, Endpoint(victim_a, RETIRE_STORAGE_TOKEN),
                         RetireStorageRequest(tags=(victim_t,)),
                         TaskPriority.MOVE_KEYS)
        log_client.pop(victim_t, -1)
        TraceEvent("TeamShrinkDone", id=self.salt).detail(
            "Begin", begin).detail("Victim", victim_a).log()

    async def _recover_and_serve(self) -> None:
        cfg = self.cfg
        # -- READING_CSTATE / LOCKING_CSTATE ---------------------------------
        self._state("reading_cstate")
        cstate = CoordinatedState(self.net, self.proc.address, self.coords, self.salt)
        prev: Optional[DBCoreState] = await cstate.read()
        first_boot = prev is None
        prev = prev or DBCoreState()
        rc = prev.recovery_count + 1
        self._state("locking_cstate", RecoveryCount=rc)
        if buggify.buggify():
            # gap between reading and locking the cstate: a competing
            # master can slip its own lock in — ours must then lose cleanly
            await delay(0.3, TaskPriority.CLUSTER_CONTROLLER)
        await cstate.set_exclusive(replace(prev, recovery_count=rc))

        # -- LOCKING_TLOGS: end the previous epoch ---------------------------
        preload: Dict[int, list] = {}
        preload_popped: Dict[int, int] = {}
        if prev.generations:
            old_cfg: LogSystemConfig = prev.generations[-1].config
            self._state("locking_tlogs", OldGen=str(old_cfg.gen_id))
            while True:
                try:
                    recovery_version, locked_reps = await lock_generation(
                        self.net, self.proc.address, old_cfg
                    )
                    # durability oracle: the recovery version must cover
                    # every fully-acked push to the generation we locked
                    # (sim_validation.h:20-50)
                    from ..sim import validation as sim_validation

                    sim_validation.check_restored_version(
                        old_cfg.gen_id, recovery_version)
                    preload, preload_popped = await fetch_recovery_data(
                        self.net, self.proc.address, old_cfg, locked_reps,
                        recovery_version,
                    )
                    break
                except error.FDBError:
                    # Below the tag-coverage lock quorum: some tag's
                    # un-popped window is unrecoverable until a subset
                    # member returns. Wait, not guess.
                    await delay(1.0, TaskPriority.CLUSTER_CONTROLLER)
            first_jump = RECOVERY_VERSION_JUMP
        else:
            recovery_version = 1
            first_jump = 0
        if buggify.buggify():
            # stretch LOCKING->RECRUITING: competing masters and worker
            # failures race the recruitment window harder
            await delay(0.5, TaskPriority.CLUSTER_CONTROLLER)
        self._state("recruiting", RecoveryVersion=recovery_version)

        # -- RECRUITING ------------------------------------------------------
        # Role counts: the committed configuration (DatabaseConfiguration,
        # mirrored into cstate by the conf watcher) overrides the boot-time
        # cluster shape — `configure proxies=3` etc. apply HERE, at the
        # next recovery after the change committed.
        from .management import conf_int

        conf = dict(prev.conf)
        n_tlogs = conf_int(conf, b"logs", cfg.n_tlogs)
        n_resolvers = conf_int(conf, b"resolvers", cfg.n_resolvers)
        conf_proxies = conf_int(conf, b"proxies", getattr(cfg, "n_proxies", 1))
        log_repl = conf_int(conf, b"log_replication",
                            getattr(cfg, "log_replication_factor", 0))
        storage_repl = conf_int(conf, b"replication",
                                max(1, getattr(cfg, "storage_replication", 1)))
        # Storage is stateful: keep it on dedicated workers and recruit the
        # disposable transaction roles on the rest (the reference's
        # process-class fitness, reduced to storage-vs-stateless).
        alive = [w for w in self.workers if not self.net.monitor.is_failed(w)]
        n_storage_workers = cfg.n_storage * storage_repl
        if first_boot or not (prev.storage_tags if prev else ()):
            storage_workers = sorted(alive)[-n_storage_workers:]
        else:
            storage_workers = sorted({t[3] for t in prev.storage_tags})
        # Multi-region (SimulatedCluster:706 region config): the PRIMARY
        # DC is wherever the most live workers are — when dc0 dies
        # wholesale, the next recovery recruits the transaction system in
        # the surviving DC (DC-preference failover); satellites below keep
        # the log reachable across that flip.
        def dc_of(w: str) -> str:
            loc = self.localities.get(w)
            return loc[1] if loc else "dc0"

        txn_pool = [w for w in alive if w not in storage_workers] or alive
        by_dc: Dict[str, List[str]] = {}
        for w in sorted(txn_pool):
            by_dc.setdefault(dc_of(w), []).append(w)
        if not by_dc:
            # typed failure the recovery loop retries — an IndexError here
            # would crash the master actor instead
            raise error.recruitment_failed("no live workers")
        primary_dc = sorted(by_dc, key=lambda d: (-len(by_dc[d]), d))[0]
        primary_workers = by_dc[primary_dc]
        workers = primary_workers + [w for d in sorted(by_dc)
                                     if d != primary_dc for w in by_dc[d]]
        gen_id = (rc, self.salt)
        suffix = f":{rc}.{self.salt}"

        def pick(n: int, offset: int) -> List[str]:
            # wrap WITHIN the primary DC: resolvers/proxies must not spill
            # into the secondary just because tlogs consumed the primary
            # prefix (co-location beats a cross-DC hop on every commit)
            pool = primary_workers or workers
            return [pool[(offset + i) % len(pool)] for i in range(n)]

        tlog_addrs = pick(n_tlogs, 0)
        # satellite tlog replicas OUTSIDE the primary DC: the commit
        # quorum spans DCs, so total primary loss cannot lose acked data
        # (the reference's synchronous satellite logs)
        n_sat = min(int(getattr(cfg, "satellite_logs", 0)),
                    max(n_tlogs - 1, 0))
        if n_sat > 0:
            if log_repl:
                # partitioned tags can exclude the satellite index from a
                # tag's subset, voiding the durability point of satellites;
                # this generation runs unpartitioned instead
                TraceEvent("SatelliteForcesFullLogReplication",
                           id=self.salt).log()
                log_repl = 0
            sat_pool = [w for w in workers
                        if dc_of(w) != primary_dc
                        and w not in tlog_addrs[: n_tlogs - n_sat]]
            sats = sat_pool[:n_sat]
            if len(sats) < n_sat:
                # Thin non-primary pool: backfill the shortfall from the
                # primary so the generation still runs n_tlogs replicas —
                # reduced satellite coverage, never reduced replication.
                TraceEvent("SatelliteRecruitmentShort", id=self.salt).detail(
                    "Requested", n_sat).detail(
                    "Recruited", len(sats)).detail(
                    "BackfilledFromPrimary", n_sat - len(sats)).log()
            # keep enough primary tlogs that kept + sats == n_tlogs
            kept = tlog_addrs[: n_tlogs - len(sats)]
            if sats:
                tlog_addrs = kept + sats
        TraceEvent("RecruitPlacement", id=self.salt).detail(
            "PrimaryDC", primary_dc).detail(
            "TLogDCs", str([dc_of(a) for a in tlog_addrs])).detail(
            "TxnPoolDCs", str(sorted((d, len(ws)) for d, ws in by_dc.items()))).detail(
            "Localities", len(self.localities)).log()
        resolver_addrs = pick(n_resolvers, n_tlogs)
        n_proxies = max(1, conf_proxies)
        proxy_addrs = pick(n_proxies, n_tlogs + n_resolvers)
        if len(set(proxy_addrs)) < n_proxies:
            # proxy tokens are per-process: never co-locate two proxies
            proxy_addrs = list(dict.fromkeys(proxy_addrs))

        # Per-replica token suffixes: duplicate placement (a thin worker
        # pool) degrades fault isolation but must never alias two role
        # instances into one (that would split one version stream).
        tlog_reps = tuple((a, f"{suffix}.{i}") for i, a in enumerate(tlog_addrs))
        new_log = LogSystemConfig(
            gen_id=gen_id, tlogs=tlog_reps, start_version=recovery_version,
            replication_factor=log_repl,
        )
        # Seed each new replica with only the tags it will hold (per-tag
        # subsets), and only tags that still EXIST: a tag retired by a
        # finished move — or minted by an unfinished one — must not ride
        # the recovery copy into the new generation, where nothing would
        # ever pop it (it would pin the disk-queue front forever).
        live_tags = {t for (t, _b, _e, _a) in prev.storage_tags}

        def keep_tag(t: int) -> bool:
            # negative tags (metadata stream, live backup logs) always ride
            # the recovery copy; positive tags only while a storage server
            # still owns them
            return t < 0 or t in live_tags

        await all_of([
            self._init_role(a, INIT_TLOG_TOKEN, InitializeTLogRequest(
                gen_id=gen_id, start_version=recovery_version,
                token_suffix=rep_suffix, replica_index=i,
                preload={t: e for t, e in preload.items()
                         if keep_tag(t) and i in new_log.tag_subset(t)},
                preload_popped={t: v for t, v in preload_popped.items()
                                if keep_tag(t) and i in new_log.tag_subset(t)},
            ))
            for i, (a, rep_suffix) in enumerate(tlog_reps)
        ])
        await all_of([
            self._init_role(a, INIT_RESOLVER_TOKEN, InitializeResolverRequest(
                gen_id=gen_id, start_version=recovery_version,
                token_suffix=f"{suffix}.{i}", replica_index=i,
            ))
            for i, a in enumerate(resolver_addrs)
        ])

        # Seed storage servers on first boot (newSeedServers:325): each
        # shard gets a team of `storage_replication` replicas on distinct
        # workers (storage tokens are per-process, and same-worker replicas
        # would share a fault domain anyway).
        repl = storage_repl
        # seed when there IS no storage map — including the crash window
        # where a previous first-boot master locked the cstate but died
        # before the WRITING_CSTATE hand-over (its seeded servers, if any,
        # are re-initialized idempotently by tag)
        if first_boot or not prev.storage_tags:
            storage_shards = KeyShardMap.uniform(cfg.n_storage)
            if len(storage_workers) < cfg.n_storage * repl:
                raise error.recruitment_failed(
                    f"need {cfg.n_storage * repl} storage workers for "
                    f"{cfg.n_storage} shards x {repl} replicas, have {len(storage_workers)}"
                )
            storage_tags = []
            tag = 0
            # team placement: spread each shard's replicas across DCs when
            # there are several (a dc-wide loss keeps every shard served),
            # else across machines (DDTeamCollection's policy ladder)
            from .replication_policy import PolicyAcross

            field = "dc_id" if getattr(cfg, "n_dcs", 1) > 1 else "machine_id"
            pool = list(storage_workers)
            for s in range(cfg.n_storage):
                begin = storage_shards.begins[s]
                end = storage_shards.span_end(s) or b"\xff\xff\xff"
                team = (PolicyAcross(repl, field).select(pool, self.localities)
                        if repl > 1 else None) or pool[:repl]
                for addr in team:
                    pool.remove(addr)
                    await self._init_role(addr, INIT_STORAGE_TOKEN,
                                          InitializeStorageRequest(tag=tag, begin=begin, end=end))
                    storage_tags.append((tag, begin, end, addr))
                    tag += 1
            storage_tags = tuple(storage_tags)
        else:
            storage_tags = prev.storage_tags

        # -- RECOVERY_TRANSACTION (masterserver.actor.cpp:730-780) -----------
        # The master itself commits the first (empty) transaction of the new
        # epoch, at recovery_version + jump: it drives the version chain —
        # and with it the tlog KCV horizon and the storage servers — past
        # the MVCC-window jump. Without it, a post-recovery cluster
        # deadlocks: reads need storage at the jumped GRV, storage advances
        # only on commits, and every client transaction starts with a read.
        # Resolver key shards: the splits chosen by a previous epoch's
        # resolutionBalancing, else uniform (rebalancing hands over by
        # epoch bounce: fresh resolvers + the MVCC-window version jump
        # make the empty conflict history safe).
        splits = list(prev.resolver_splits)
        if len(splits) == n_resolvers - 1 and splits == sorted(splits) and all(splits):
            resolver_map = KeyShardMap(splits)
            used_splits = tuple(splits)
        else:
            resolver_map = KeyShardMap.uniform(n_resolvers)
            used_splits = ()

        recovery_txn_version = recovery_version + max(first_jump, 1)
        from .log_system import LogSystemClient
        from .messages import ResolveTransactionBatchRequest

        log_client = LogSystemClient(self.net, self.proc.address, new_log)
        self._state("recovery_transaction", Version=recovery_txn_version)
        await all_of([
            self.net.request(
                self.proc.address, Endpoint(a, RESOLVE_TOKEN + f"{suffix}.{i}"),
                ResolveTransactionBatchRequest(
                    prev_version=recovery_version, version=recovery_txn_version,
                    last_received_version=recovery_version, transactions=[],
                ),
                TaskPriority.PROXY_RESOLVER_REPLY, timeout=RECRUIT_TIMEOUT,
            )
            for i, a in enumerate(resolver_addrs)
        ])
        await log_client.push(recovery_version, recovery_txn_version, {},
                              known_committed=recovery_version)

        # Version authority for the new epoch, starting past the recovery
        # transaction.
        self.master = Master(self.proc, start_version=recovery_txn_version,
                             token_suffix=suffix)

        # Admission control for the epoch (the reference's ratekeeper runs
        # under the master's data distribution in 6.0).
        ratekeeper = Ratekeeper(
            self.net, self.proc.address, storage_tags,
            lambda: self.master.version,
            log_config=new_log,
            # degraded conflict engines (device faults, failover to the CPU
            # oracle — fault/resilient.py) are an admission-control signal
            resolver_eps=[
                Endpoint(a, RESOLVER_HEALTH_TOKEN + f"{suffix}.{i}")
                for i, a in enumerate(resolver_addrs)
            ],
        )
        rate_token = GET_RATE_INFO_TOKEN + suffix
        self.proc.register(rate_token, ratekeeper.get_rate_info)
        rk_task = spawn(ratekeeper.run(), TaskPriority.RATEKEEPER,
                        name=f"ratekeeper:{self.salt}")
        self.proc.actors.add(rk_task)

        # Status fragment for the CC's status document (Status.actor.cpp).
        status_token = f"master.status{suffix}"

        async def master_status(_req):
            return {
                "version": self.master.version,
                "recovery_count": rc,
                "recovery_version": recovery_version,
                "tps_limit": ratekeeper.tps_limit,
                "worst_storage_lag_versions": ratekeeper.worst_lag,
                "storage_lag_stale": ratekeeper.lag_stale,
                "resolvers_degraded": ratekeeper.resolver_degraded,
                "resolver_health": dict(ratekeeper.resolver_health),
                "resolver_telemetry": dict(ratekeeper.resolver_telemetry),
                "tlogs": list(tlog_addrs),
                "resolvers": list(resolver_addrs),
                "proxies": list(proxy_addrs),
            }

        self.proc.register(status_token, master_status)

        from .proxy import COMMITTED_VERSION_TOKEN

        storage_shards, storage_teams = teams_from_storage_tags(storage_tags)
        peer_grv_eps = [Endpoint(a, COMMITTED_VERSION_TOKEN) for a in proxy_addrs]
        proxy_cfg = ProxyConfig(
            master_ep=Endpoint(self.proc.address, GET_COMMIT_VERSION_TOKEN + suffix),
            resolver_eps=[Endpoint(a, RESOLVE_TOKEN + f"{suffix}.{i}")
                          for i, a in enumerate(resolver_addrs)],
            resolver_shards=resolver_map,
            log_config=new_log,
            storage_teams=storage_teams,
            storage_shards=storage_shards,
            master_wf_ep=Endpoint(self.proc.address, f"waitFailure:master:{self.salt}"),
            rate_ep=Endpoint(self.proc.address, rate_token),
            peer_grv_eps=peer_grv_eps,
        )
        await all_of([
            self._init_role(a, INIT_PROXY_TOKEN, InitializeProxyRequest(
                gen_id=gen_id, cfg=proxy_cfg, start_version=recovery_txn_version,
            ))
            for a in proxy_addrs
        ])

        # -- WRITING_CSTATE: the durable hand-over ---------------------------
        if buggify.buggify():
            # a slow hand-over widens the window where the old generation
            # is locked but the new one is not yet authoritative
            await delay(0.5, TaskPriority.CLUSTER_CONTROLLER)
        self._state("writing_cstate")
        cstate_val = DBCoreState(
            recovery_count=rc,
            generations=(LogGenerationInfo(config=new_log, end_version=None),),
            storage_tags=storage_tags,
            resolver_splits=used_splits,  # balanced splits survive epochs
            excluded=prev.excluded,       # exclusions survive epochs too
            conf=prev.conf,               # the committed configuration
        )
        await cstate.set_exclusive(cstate_val)

        # -- FULLY_RECOVERED -------------------------------------------------
        info = ServerDBInfo(
            recovery_count=rc, recovery_state="fully_recovered",
            master_addr=self.proc.address, proxy_addrs=tuple(proxy_addrs),
            log_config=new_log, storage_tags=storage_tags,
            master_status_ep=Endpoint(self.proc.address, status_token),
        )
        from .cluster_controller import CC_MASTER_RECOVERED_TOKEN

        self.net.one_way(self.proc.address,
                         Endpoint(self.cc_addr, CC_MASTER_RECOVERED_TOKEN), info,
                         TaskPriority.CLUSTER_CONTROLLER)
        # Predecessor generations are now unreachable from the cstate:
        # retire their roles everywhere (best-effort one-ways).
        for a in self.workers:
            self.net.one_way(self.proc.address, Endpoint(a, RETIRE_TOKEN),
                             RetireGenerationsRequest(keep_min=rc),
                             TaskPriority.CLUSTER_CONTROLLER)
        self._state("fully_recovered", RecoveryCount=rc)

        # -- DD-lite: the shard-movement coordinator -------------------------
        # (DataDistribution reduced to explicit whole-shard MoveKeys; the
        # authoritative map is cstate.storage_tags, mirrored into
        # \xff/keyServers by real transactions at epoch start and on every
        # move, so proxies and clients follow transactionally.)
        from ..client.database import Database as ClientDatabase

        from ..sim.loop import Promise as _Promise

        from ..sim.actors import AsyncMutex as _AsyncMutex

        dd = {
            "storage_tags": list(storage_tags),
            "cstate_val": cstate_val,
            "busy": False,
            "info": info,
            "init_done": _Promise(),
            # monotone storage-tag allocator: concurrent queue relocations
            # taking max(tags)+1 would mint DUPLICATE tags
            "next_tag": max((t for (t, _b, _e, _a) in storage_tags),
                            default=-1) + 1,
            # read-transform-write publishes compose under this
            "publish_mutex": _AsyncMutex(),
        }
        dd_db = ClientDatabase(self.net, self.proc.address, list(proxy_addrs))
        move_token = MOVE_SHARD_TOKEN + suffix

        async def dd_init() -> None:
            # Mirror the authoritative map into the system keyspace and
            # prune orphaned destinations of a move the last epoch never
            # finished (their tags are absent from cstate).
            valid = tuple(t for (t, _b, _e, _a) in dd["storage_tags"])
            for a in self.workers:
                self.net.one_way(
                    self.proc.address, Endpoint(a, RETIRE_STORAGE_TOKEN),
                    RetireStorageRequest(tags=valid, prune=True),
                    TaskPriority.MOVE_KEYS,
                )

            async def seed(tr):
                tr.set_access_system_keys()
                for begin, team in _teams_by_begin(dd["storage_tags"]).items():
                    tr.set(system_keys.key_servers_key(begin),
                           system_keys.encode_key_servers(team))
                # a backup that straddled the recovery: re-advertise its
                # flag so this generation's proxies resume copying into the
                # backup tag (commits between recovery and this rewrite are
                # a known v0 gap; agents should restart on generation turn)
                active = await tr.get(system_keys.BACKUP_ACTIVE_KEY)
                if active:
                    tr.set(system_keys.BACKUP_ACTIVE_KEY, active)
                # a database lock equally straddles recoveries
                locked = await tr.get(system_keys.DB_LOCK_KEY)
                if locked:
                    tr.set(system_keys.DB_LOCK_KEY, locked)
            await dd_db.run(seed)
            dd["init_done"].send(None)

        async def dd_metadata_gc() -> None:
            """Pop METADATA_TAG at the minimum drained version over every
            proxy (the resolver's oldest-proxy-version GC): without this
            the tag pins every tlog's disk-queue front forever."""
            from .proxy import METADATA_VERSION_TOKEN

            while True:
                await delay(2.0, TaskPriority.MOVE_KEYS)
                versions = []
                ok = True
                for a in proxy_addrs:
                    try:
                        versions.append(await self.net.request(
                            self.proc.address, Endpoint(a, METADATA_VERSION_TOKEN),
                            None, TaskPriority.MOVE_KEYS, timeout=1.0,
                        ))
                    except error.FDBError:
                        ok = False
                        break
                if ok and versions:
                    log_client.pop(system_keys.METADATA_TAG, min(versions))

        async def move_shard(req: MoveShardRequest):
            await dd["init_done"].future  # serialize vs the seed transaction
            # the external move joins the DD queue's shard-exclusion
            # discipline: wait (bounded) for any queued relocation of this
            # shard to finish, then hold the shard for the move's duration
            deadline = 120
            while req.begin in dd["busy_shards"] or dd["busy"]:
                deadline -= 1
                if deadline <= 0:
                    raise error.client_invalid_operation(
                        "shard is being relocated; retry later")
                await delay(0.5, TaskPriority.MOVE_KEYS)
            if set(req.dest_workers) & dd["reserved"]:
                raise error.client_invalid_operation(
                    "a destination is reserved by a concurrent relocation")
            dd["busy"] = True
            dd["busy_shards"].add(req.begin)
            dd["reserved"] |= set(req.dest_workers)
            try:
                return await self._move_shard(req, dd, dd_db, log_client, cstate,
                                              ratekeeper)
            finally:
                dd["busy"] = False
                dd["busy_shards"].discard(req.begin)
                dd["reserved"] -= set(req.dest_workers)

        dd["reserved"] = set()   # in-flight relocation destinations

        def pick_spares(n: int):
            """Policy-selected destination workers: alive, not hosting
            storage, not excluded, not already RESERVED by a concurrent
            relocation (two parallel ops landing on one worker would alias
            its per-process storage tokens), spread across machines
            (DDTeamCollection's team builder behind PolicyAcross)."""
            from .replication_policy import PolicyAcross

            hosts = {a for (_t, _b, _e, a) in dd["storage_tags"]}
            cands = sorted(
                w for w in self.workers
                if not self.net.monitor.is_failed(w)
                and w not in hosts and w not in dd["excluded"]
                and w not in dd["reserved"]
            )
            return PolicyAcross(n, "machine_id").select(cands, self.localities)

        # -- DataDistributionQueue (DataDistributionQueue.actor.cpp) ---------
        # A prioritized relocation queue with bounded parallelism: the
        # tracker/fixer DECIDE (fast polls), runner actors EXECUTE (slow
        # fetches overlap across disjoint shards; metadata commits and
        # cstate publishes serialize through their own paths). Lower
        # priority value = more urgent (the reference's move priorities:
        # team health above load balancing above space reclamation).
        PRI_TEAM, PRI_SPLIT, PRI_MERGE = 0, 1, 2
        dd["queue"] = []              # [(priority, seq, key, shards, fn)]
        dd["queued_keys"] = set()     # dedupe: one pending op per key
        dd["busy_shards"] = set()     # shard begins under relocation
        dd["qseq"] = 0

        def dd_enqueue(priority: int, key: tuple, shards: tuple, fn) -> None:
            if key in dd["queued_keys"]:
                return
            dd["qseq"] += 1
            dd["queue"].append((priority, dd["qseq"], key, shards, fn))
            dd["queued_keys"].add(key)

        async def dd_queue_runner(slot: int) -> None:
            await dd["init_done"].future
            while True:
                await delay(0.3, TaskPriority.DATA_DISTRIBUTION_LAUNCH)
                if buggify.buggify():
                    # a stalled runner: the other slots must carry the queue
                    await delay(2.0, TaskPriority.DATA_DISTRIBUTION_LAUNCH)
                best = None
                for item in sorted(dd["queue"]):
                    _p, _s, _k, shards, _fn = item
                    if not (set(shards) & dd["busy_shards"]):
                        best = item
                        break
                if best is None:
                    continue
                dd["queue"].remove(best)
                priority, _seq, key, shards, fn = best
                dd["busy_shards"] |= set(shards)
                try:
                    await fn()
                except error.FDBError as exc:
                    # the op re-validates against the live map; a stale
                    # decision (shard gone, team changed) drops out here
                    TraceEvent("DDQueueOpFailed", id=self.salt).detail(
                        "Key", str(key)).detail("Reason", exc.name).log()
                finally:
                    dd["busy_shards"] -= set(shards)
                    # only NOW may the key re-enqueue: releasing at dequeue
                    # would let the decision loops queue a duplicate that
                    # re-applies a finished op (e.g. growing a team past
                    # the configured replication)
                    dd["queued_keys"].discard(key)

        async def dd_tracker() -> None:
            """Shard size + write-bandwidth tracking and split/merge
            DECISIONS (DataDistributionTracker): poll each team's byte
            sample and applied-write bandwidth; a shard over the size
            threshold OR the bandwidth threshold (a hot-WRITE shard whose
            size alone would never trigger) splits at its sample median
            onto policy-picked spares; adjacent dwarf shards merge.
            Execution goes through the DD queue."""
            from ..core.knobs import SERVER_KNOBS
            from .storage import STORAGE_METRICS_TOKEN

            await dd["init_done"].future
            while True:
                interval = SERVER_KNOBS.dd_tracker_interval
                if buggify.buggify():
                    # frantic tracker: split/merge decisions race fresh
                    # moves and each other's metadata transactions
                    interval = interval / 8
                await delay(interval, TaskPriority.MOVE_KEYS)
                tags = list(dd["storage_tags"])
                teams = _teams_by_begin(tags)
                ranges = sorted({(b, e) for (_t, b, e, _a) in tags})
                metrics = {}
                ok = True
                for b, _e in ranges:
                    _t0, a0 = teams[b][0]
                    try:
                        metrics[b] = await self.net.request(
                            self.proc.address, Endpoint(a0, STORAGE_METRICS_TOKEN),
                            None, TaskPriority.MOVE_KEYS, timeout=1.0,
                        )
                    except error.FDBError:
                        ok = False
                        break
                if not ok:
                    continue
                split_bytes = SERVER_KNOBS.dd_shard_split_bytes
                split_bw = SERVER_KNOBS.dd_shard_split_bandwidth
                for b, e in sorted(ranges, key=lambda r: -metrics[r[0]]["bytes"]):
                    m = metrics[b]
                    k = m.get("split_key")
                    hot = (m["bytes"] > split_bytes
                           or m.get("write_bw", 0.0) > split_bw)
                    if not hot or not k or not (b < k < e):
                        continue
                    n_repl = len(teams[b])

                    def mk_split(b=b, k=k, n_repl=n_repl):
                        async def run():
                            dests = pick_spares(n_repl)
                            if not dests:
                                TraceEvent("ShardSplitNoSpares",
                                           id=self.salt).detail("Begin", b).log()
                                return
                            dd["reserved"] |= set(dests)
                            try:
                                await self._split_shard(b, k, dests, dd, dd_db,
                                                        log_client, cstate,
                                                        ratekeeper)
                            finally:
                                dd["reserved"] -= set(dests)
                        return run
                    dd_enqueue(PRI_SPLIT, ("split", b), (b,), mk_split())
                merge_bytes = SERVER_KNOBS.dd_shard_merge_bytes
                if len(ranges) <= self.cfg.n_storage:
                    # merge only what splitting created: the seeded shard
                    # count is the configured floor (an empty cluster would
                    # otherwise collapse to one shard at boot)
                    continue
                for (b1, e1), (b2, _e2) in zip(ranges, ranges[1:]):
                    if e1 != b2:
                        continue
                    if (metrics[b1]["bytes"] < merge_bytes
                            and metrics[b2]["bytes"] < merge_bytes
                            and metrics[b1]["bytes"] + metrics[b2]["bytes"]
                            < split_bytes // 4):

                        def mk_merge(b1=b1, b2=b2):
                            async def run():
                                await self._merge_shards(b1, b2, dd, dd_db,
                                                         log_client, cstate,
                                                         ratekeeper)
                            return run
                        dd_enqueue(PRI_MERGE, ("merge", b1, b2), (b1, b2),
                                   mk_merge())

        dd["excluded"] = set(cstate_val.excluded)
        exclude_token = EXCLUDE_TOKEN + suffix

        async def persist_excluded():
            dd["cstate_val"] = replace(dd["cstate_val"],
                                       excluded=tuple(sorted(dd["excluded"])))
            await cstate.set_exclusive(dd["cstate_val"])

        async def exclude_servers(req: ExcludeServersRequest):
            """Drain shards off the excluded addresses, one move at a time
            (ManagementAPI excludeServers + DD's trackExcludedServers)."""
            await dd["init_done"].future
            if not req.exclude:
                dd["excluded"] -= set(req.addresses)
                await persist_excluded()
                return {"excluded": sorted(dd["excluded"])}
            dd["excluded"] |= set(req.addresses)
            await persist_excluded()
            moved = []
            while True:
                tags = dd["storage_tags"]
                victim = next(
                    ((t, b, e, a) for (t, b, e, a) in tags
                     if a in dd["excluded"]), None)
                if victim is None:
                    break
                _t, begin, _e, _a = victim
                # join the queue's shard-exclusion discipline (a queued
                # relocation of this shard finishes first)
                deadline = 240
                while begin in dd["busy_shards"] or dd["busy"]:
                    deadline -= 1
                    if deadline <= 0:
                        raise error.client_invalid_operation(
                            "shard is being relocated; retry later")
                    await delay(0.5, TaskPriority.MOVE_KEYS)
                # pick AFTER the wait (the map may have changed) and
                # RESERVE: a concurrent queued relocation must not land on
                # the same spare worker
                team = sorted((t, a) for (t, b2, _e2, a)
                              in dd["storage_tags"] if b2 == begin)
                if not team:
                    continue   # the shard was merged/moved away meanwhile
                dests = pick_spares(len(team))
                if not dests:
                    raise error.recruitment_failed(
                        "not enough non-excluded spare workers to drain onto")
                dd["busy"] = True
                dd["busy_shards"].add(begin)
                dd["reserved"] |= set(dests)
                try:
                    await self._move_shard(
                        MoveShardRequest(begin=begin, dest_workers=dests),
                        dd, dd_db, log_client, cstate, ratekeeper)
                finally:
                    dd["busy"] = False
                    dd["busy_shards"].discard(begin)
                    dd["reserved"] -= set(dests)
                moved.append(begin)
            return {"excluded": sorted(dd["excluded"]), "moved": moved}

        self.proc.register(move_token, move_shard)
        self.proc.register(exclude_token, exclude_servers)
        dd_task = spawn(dd_init(), TaskPriority.MOVE_KEYS, name=f"ddInit:{self.salt}")
        self.proc.actors.add(dd_task)
        dd_gc_task = spawn(dd_metadata_gc(), TaskPriority.MOVE_KEYS,
                           name=f"ddMetaGC:{self.salt}")
        self.proc.actors.add(dd_gc_task)
        dd_tracker_task = spawn(dd_tracker(), TaskPriority.MOVE_KEYS,
                                name=f"ddTracker:{self.salt}")
        self.proc.actors.add(dd_tracker_task)
        from ..core.knobs import SERVER_KNOBS as _SK

        runner_tasks = [
            spawn(dd_queue_runner(i), TaskPriority.DATA_DISTRIBUTION_LAUNCH,
                  name=f"ddQueue:{self.salt}.{i}")
            for i in range(max(1, int(_SK.dd_move_parallelism)))
        ]
        for t in runner_tasks:
            self.proc.actors.add(t)

        # -- resolutionBalancing (masterserver.actor.cpp:919-977) -------------
        # Poll resolver row counts; on sustained imbalance, persist new
        # split keys (quantiles of the resolvers' key samples) in cstate
        # and flip the routing LIVE — zero recoveries: the master (version
        # authority) piggybacks (flip_version, old, new splits) on its
        # version replies, proxies split batches >= flip by the new map,
        # and each resolver seeds a synthetic whole-span write over its
        # gained ranges at its first post-flip batch (conservative
        # conflicts stand in for the donor's unshipped history — the
        # "rebuild past the MVCC window" handoff; exact once snapshots
        # pass the flip). The reference ships state via
        # ResolutionSplitRequest; the conservative seed needs no transfer.
        conf_p = _Promise()

        async def conf_watcher() -> None:
            """Watch the committed \\xff/conf/ map (DatabaseConfiguration):
            a change is mirrored into the coordinated state — where the
            NEXT recovery reads its role counts — and bounces the epoch to
            apply it (the reference's configuration-triggered recovery)."""
            from .management import CONF_END, CONF_PREFIX

            await dd["init_done"].future
            while True:
                await delay(1.0, TaskPriority.MOVE_KEYS)
                try:
                    async def rd(tr):
                        return await tr.get_range(CONF_PREFIX, CONF_END,
                                                  limit=1000, snapshot=True)
                    rows = await dd_db.run(rd)
                except error.FDBError:
                    continue
                committed = tuple(sorted(
                    (k[len(CONF_PREFIX):], v) for k, v in rows))
                if committed == dd["cstate_val"].conf:
                    continue
                TraceEvent("ConfigurationChanged", id=self.salt).detail(
                    "Conf", str(committed)).log()
                dd["cstate_val"] = replace(dd["cstate_val"], conf=committed)
                try:
                    await cstate.set_exclusive(dd["cstate_val"])
                except error.FDBError:
                    return   # a successor owns the cstate
                if not conf_p.is_set:
                    conf_p.send(None)
                return

        async def replication_fixer() -> None:
            """Converge every shard's team size to the configured storage
            replication (the DD side of `configure single|double|triple`):
            DECISIONS here, execution through the DD queue at team
            priority (above load-balancing splits/merges — the reference's
            unhealthy-team precedence)."""
            await dd["init_done"].future
            while True:
                await delay(1.5, TaskPriority.MOVE_KEYS)
                want = storage_repl
                teams = _teams_by_begin(dd["storage_tags"])
                for begin in sorted(teams):
                    team = teams[begin]
                    if len(team) == want:
                        continue
                    grow = len(team) < want

                    def mk_fix(begin=begin, grow=grow):
                        async def run():
                            # re-validate: the decision may be stale by the
                            # time a runner slot frees (another fix ran, a
                            # split re-teamed the shard)
                            cur = _teams_by_begin(dd["storage_tags"]).get(begin)
                            if cur is None or len(cur) == want                                     or (len(cur) < want) != grow:
                                return
                            if grow:
                                dests = pick_spares(1)
                                if not dests:
                                    TraceEvent("TeamGrowNoSpares",
                                               id=self.salt).detail(
                                        "Begin", begin).log()
                                    return
                                dd["reserved"] |= set(dests)
                                try:
                                    await self._grow_team(begin, dests[0], dd,
                                                          dd_db, log_client,
                                                          cstate, ratekeeper)
                                finally:
                                    dd["reserved"] -= set(dests)
                            else:
                                await self._shrink_team(begin, dd, dd_db,
                                                        log_client, cstate,
                                                        ratekeeper)
                        return run
                    dd_enqueue(PRI_TEAM, ("team", begin), (begin,), mk_fix())

        async def resolution_balancing() -> None:
            from .resolver import RESOLUTION_METRICS_TOKEN

            interval = float(cfg.rebalance_interval)
            min_rows = int(cfg.rebalance_min_rows)
            ratio = 3.0
            current_splits = used_splits or tuple(
                KeyShardMap.uniform(n_resolvers).begins[1:])
            while True:
                await delay(interval, TaskPriority.RESOLUTION_METRICS)
                stats = []
                try:
                    for i, a in enumerate(resolver_addrs):
                        stats.append(await self.net.request(
                            self.proc.address,
                            Endpoint(a, RESOLUTION_METRICS_TOKEN + f"{suffix}.{i}"),
                            None, TaskPriority.RESOLUTION_METRICS, timeout=1.0,
                        ))
                except error.FDBError:
                    continue
                rows = [s["rows"] for s in stats]
                if len(rows) < 2 or sum(rows) < min_rows:
                    continue
                if max(rows) <= ratio * (min(rows) + 10):
                    continue
                # new splits: quantiles of the union of key samples, each
                # sample weighted by its resolver's observed rows
                weighted: List[bytes] = []
                for s in stats:
                    sample = [k for k in s["sample"] if k]
                    if not sample:
                        continue
                    w = max(1, s["rows"] // len(sample))
                    for k in sample:
                        weighted.extend([k] * min(w, 64))
                if not weighted:
                    continue
                weighted.sort()
                n = len(resolver_addrs)
                new_splits = []
                for i in range(1, n):
                    new_splits.append(weighted[(len(weighted) * i) // n])
                new_splits = sorted(set(new_splits))
                if len(new_splits) != n - 1 or not all(new_splits):
                    continue
                if tuple(new_splits) == current_splits:
                    # an unsplittable hot spot (e.g. one hot key): identical
                    # splits would churn flips forever
                    continue
                # durable FIRST (the next recovery recruits on the new
                # splits), then flip the live generation with zero downtime
                dd["cstate_val"] = replace(dd["cstate_val"],
                                           resolver_splits=tuple(new_splits))
                try:
                    await cstate.set_exclusive(dd["cstate_val"])
                except error.FDBError:
                    return  # a successor owns the cstate; we are done anyway
                flip = self.master.set_routing_flip(current_splits,
                                                    tuple(new_splits))
                TraceEvent("ResolutionBalancing", id=self.salt).detail(
                    "Rows", str(rows)).detail("NewSplits", str(new_splits)).detail(
                    "FlipVersion", flip).log()
                current_splits = tuple(new_splits)
                # keep watching: further imbalance flips again, live

        balance_task = spawn(resolution_balancing(), TaskPriority.RESOLUTION_METRICS,
                             name=f"resBalance:{self.salt}")
        self.proc.actors.add(balance_task)
        conf_task = spawn(conf_watcher(), TaskPriority.MOVE_KEYS,
                          name=f"confWatch:{self.salt}")
        self.proc.actors.add(conf_task)
        fixer_task = spawn(replication_fixer(), TaskPriority.MOVE_KEYS,
                           name=f"replFixer:{self.salt}")
        self.proc.actors.add(fixer_task)

        # Serve until any recruited role host dies (process-level watch;
        # role death on a live worker only happens when a successor
        # generation replaces us, in which case we are dead already).
        watch_addrs = sorted(set(tlog_addrs + resolver_addrs + list(proxy_addrs)))
        watchers = [
            spawn(
                wait_failure_client(self.net, self.proc.address,
                                    Endpoint(a, WAIT_FAILURE_TOKEN)),
                TaskPriority.FAILURE_MONITOR, name=f"masterWatch:{a}",
            )
            for a in watch_addrs
        ]
        try:
            which, _ = await any_of([conf_p.future] + watchers)
        finally:
            for w in watchers:
                w.cancel()
            rk_task.cancel()
            dd_task.cancel()
            dd_gc_task.cancel()
            dd_tracker_task.cancel()
            balance_task.cancel()
            conf_task.cancel()
            fixer_task.cancel()
            for t in runner_tasks:
                t.cancel()
            self.proc.unregister(rate_token)
            self.proc.unregister(status_token)
            self.proc.unregister(move_token)
            self.proc.unregister(exclude_token)
        self.master.unregister()
        if which == 0:
            # Deliberate epoch bounce: the successor recruits with the new
            # configuration mirrored into cstate by the conf watcher.
            raise error.master_recovery_failed("configuration changed epoch bounce")
        raise error.master_tlog_failed("a transaction-role host failed")
