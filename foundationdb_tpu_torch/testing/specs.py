"""Named test specs (the analog of tests/*.txt).

Port of ``foundationdb_tpu/testing/specs.py``: the specs of the static and
of the dynamic cluster. Each spec composes workloads + cluster config like
the reference's declarative files: tests/fast/CycleTest.txt = Cycle +
RandomClogging + Attrition. Run via the CLI:

    python -m foundationdb_tpu_torch.testing.runner --spec CycleTest --seed 7
    python -m foundationdb_tpu_torch.testing.runner --spec CycleTestAttrition --seed 1
    python -m foundationdb_tpu_torch.testing.runner --list

`CycleTestCUDA` runs its resolvers on the card (the JAX package's
CycleTestTPU). The dynamic specs keep the JAX package's engines (the
oracle; the fault injector over the oracle for DeviceNemesis); set
`spec.dynamic.engine_factory = make_engine_factory()` to recruit card
resolvers in every generation. Not ported yet: BackupCorrectness (it needs
backup/) and the multi-device CycleTestTPU8 / RandomReadWriteTPU8 (ROADMAP
queue 1).
"""
from __future__ import annotations

from typing import Callable, Dict

from ..server.cluster import ClusterConfig, DynamicClusterConfig
from .workload import Spec
from .workloads import (
    AtomicOpsWorkload,
    BulkLoadWorkload,
    ConflictRangeWorkload,
    ConsistencyCheckWorkload,
    CycleWorkload,
    DatacenterKillWorkload,
    DeviceFaultValidationWorkload,
    FullClusterRebootWorkload,
    FuzzApiCorrectnessWorkload,
    IncrementWorkload,
    InventoryWorkload,
    MachineAttritionWorkload,
    QueuePushWorkload,
    RandomCloggingWorkload,
    RandomMoveKeysWorkload,
    RandomReadWriteWorkload,
    SelectorCorrectnessWorkload,
    SerializabilityWorkload,
    ThroughputWorkload,
    VersionStampWorkload,
    WatchesWorkload,
    WriteDuringReadWorkload,
)


def make_engine_factory(device=None, cfg=None) -> Callable[[], object]:
    """A zero-argument factory of the port's conflict engine at the specs'
    KernelConfig (the JAX package's _tpu_engine_factory): each call builds a
    fresh TorchConflictEngine. `device=None` puts it on the card and the
    factory's engines raise where there is none; the CPU tests pass
    device="cpu". `cfg` overrides the KernelConfig."""
    from ..ops.conflict_kernel import KernelConfig
    from ..ops.host_engine import TorchConflictEngine

    cfg = cfg or KernelConfig(key_words=4, capacity=1024, max_reads=256,
                              max_writes=256, max_txns=64)

    def factory():
        return TorchConflictEngine(cfg, device=device)

    return factory


def _nemesis_engine_factory():
    """The device-nemesis resolver engine: the reference oracle behind a
    seed-driven fault injector (exceptions, hangs, slow batches, bursty
    outages at FaultRates defaults; verdict flips off — see fault/inject.py),
    supervised by ResilientEngine, which must keep the emitted abort sets
    bit-identical throughout. The supervisor runs a tightened failover /
    probation cycle: resolver generations only live a few seconds between
    attrition kills, and the campaign needs full failover -> re-warm ->
    swap-back round trips inside one generation, not just the failover
    half."""
    from ..fault import FaultInjectingEngine, ResilienceConfig, ResilientEngine
    from ..ops.oracle import OracleConflictEngine

    return ResilientEngine(
        FaultInjectingEngine(OracleConflictEngine()),
        ResilienceConfig(dispatch_timeout=0.3, retry_budget=1,
                         retry_backoff=0.05, probe_rate=0.1,
                         probation_batches=2, failover_min_batches=2),
        record_journal=True,   # the check replays it for abort-set parity
    )


SPECS: Dict[str, Callable[[], Spec]] = {
    # the device nemesis: machine kills + clogging + a faulting
    # conflict engine, all at once. The check asserts workload invariants,
    # zero durability violations (run_spec's sim_validation gate), and that
    # every supervised engine's journal replays bit-identically through a
    # clean oracle — failover and swap-back included.
    "DeviceNemesis": lambda: Spec(
        title="DeviceNemesis",
        workloads=[
            (CycleWorkload, {"nodes": 8, "transactions": 18, "think_time": 0.8}),
            (MachineAttritionWorkload, {"interval": 9.0, "delay_before": 4.0}),
            (RandomCloggingWorkload, {"scale": 0.02}),
            (DeviceFaultValidationWorkload, {}),
            (ConsistencyCheckWorkload, {}),
        ],
        dynamic=DynamicClusterConfig(n_workers=5, n_tlogs=2, n_resolvers=2,
                                     n_storage=2,
                                     engine_factory=_nemesis_engine_factory),
        client_count=2,
        timeout=900.0,
    ),
    # tests/fast/CycleTest.txt with Attrition: Cycle churn while workers
    # hosting transaction roles are killed + rebooted — every kill forces a
    # full epoch recovery (the reference's core correctness strategy)
    "CycleTestAttrition": lambda: Spec(
        title="CycleTestAttrition",
        workloads=[
            (CycleWorkload, {"nodes": 10, "transactions": 12, "think_time": 1.5}),
            (MachineAttritionWorkload, {"interval": 6.0, "delay_before": 2.0}),
            (RandomCloggingWorkload, {"scale": 0.02}),
            (ConsistencyCheckWorkload, {}),
        ],
        dynamic=DynamicClusterConfig(n_workers=5, n_tlogs=2, n_resolvers=2, n_storage=2),
        client_count=2,
        timeout=900.0,
    ),
    # replicated storage (2 shards x 2 replicas) under kill/reboot churn;
    # the quiescent consistency check diffs every team's replicas
    "CycleReplicated": lambda: Spec(
        title="CycleReplicated",
        workloads=[
            (CycleWorkload, {"nodes": 8, "transactions": 10, "think_time": 1.5}),
            (MachineAttritionWorkload, {"interval": 6.0, "delay_before": 2.0}),
            (ConsistencyCheckWorkload, {}),
        ],
        dynamic=DynamicClusterConfig(n_workers=8, n_tlogs=2, n_resolvers=2,
                                     n_storage=2, storage_replication=2),
        client_count=2,
        timeout=900.0,
    ),
    # shards move between teams while cycle churn runs (MoveKeys v0 through
    # the \xff system keyspace); the cycle + replica checks prove no
    # mutation is lost across either phase of a move
    "MoveKeysCycle": lambda: Spec(
        title="MoveKeysCycle",
        workloads=[
            (CycleWorkload, {"nodes": 8, "transactions": 12, "think_time": 1.5}),
            (RandomMoveKeysWorkload, {"moves": 3, "interval": 4.0}),
            (ConsistencyCheckWorkload, {}),
        ],
        dynamic=DynamicClusterConfig(n_workers=10, n_tlogs=2, n_resolvers=2,
                                     n_storage=2),
        client_count=2,
        timeout=900.0,
    ),
    # three proxies + GRV causality quorum under kill/reboot churn
    "MultiProxyAttrition": lambda: Spec(
        title="MultiProxyAttrition",
        workloads=[
            (CycleWorkload, {"nodes": 8, "transactions": 10, "think_time": 2.0}),
            (MachineAttritionWorkload, {"interval": 6.0, "delay_before": 2.0}),
            (ConsistencyCheckWorkload, {}),
        ],
        dynamic=DynamicClusterConfig(n_workers=8, n_tlogs=2, n_resolvers=2,
                                     n_proxies=3, n_storage=2),
        client_count=3,
        timeout=900.0,
    ),
    # per-tag tlog subsets (R=2 of K=3) under kill/reboot churn: every
    # recovery exercises the lock-coverage quorum + merged per-tag fetch
    "CycleLogSubsets": lambda: Spec(
        title="CycleLogSubsets",
        workloads=[
            (CycleWorkload, {"nodes": 8, "transactions": 10, "think_time": 2.0}),
            (MachineAttritionWorkload, {"interval": 6.0, "delay_before": 2.0}),
        ],
        dynamic=DynamicClusterConfig(n_workers=6, n_tlogs=3,
                                     log_replication_factor=2, n_storage=2),
        client_count=2,
        timeout=900.0,
    ),
    # durability torture: any worker (storage included) can die and reboot;
    # disks with torn un-fsynced writes must always re-form the database
    "DiskAttrition": lambda: Spec(
        title="DiskAttrition",
        workloads=[
            (CycleWorkload, {"nodes": 8, "transactions": 8, "think_time": 2.0}),
            (MachineAttritionWorkload, {"interval": 5.0, "delay_before": 2.0}),
        ],
        dynamic=DynamicClusterConfig(n_workers=6, n_tlogs=2, n_resolvers=2, n_storage=2),
        client_count=2,
        timeout=900.0,
    ),
    # recovery churn without clogging, heavier kill rate
    "AttritionStress": lambda: Spec(
        title="AttritionStress",
        workloads=[
            (CycleWorkload, {"nodes": 8, "transactions": 10, "think_time": 2.5}),
            (MachineAttritionWorkload, {"interval": 4.0, "delay_before": 1.0}),
        ],
        dynamic=DynamicClusterConfig(n_workers=6, n_tlogs=2, n_resolvers=2, n_storage=2),
        client_count=3,
        timeout=900.0,
    ),
    # multi-region: two DCs, a satellite tlog replica outside the
    # primary, cross-DC storage teams, coordinator majority outside dc0,
    # DCN latency on inter-DC hops — then dc0 DIES WHOLESALE mid-load and
    # revives later. The recovery must fail over to dc1 (satellite log =
    # complete acked history; the sim_validation oracle enforces it) and
    # the cycle invariant must hold end to end.
    # reference: TagPartitionedLogSystem satellites, LogRouter's role,
    # region config in SimulatedCluster.actor.cpp:706
    "RegionFailover": lambda: Spec(
        title="RegionFailover",
        workloads=[
            (CycleWorkload, {"nodes": 8, "transactions": 10, "think_time": 2.0}),
            (DatacenterKillWorkload, {"dc": "dc0", "delay_before": 6.0,
                                      "revive_after": 25.0}),
            (ConsistencyCheckWorkload, {}),
        ],
        dynamic=DynamicClusterConfig(n_workers=10, n_coordinators=5,
                                     n_tlogs=3, satellite_logs=1,
                                     n_resolvers=2, n_storage=2,
                                     storage_replication=2, n_dcs=2,
                                     inter_dc_latency=0.003),
        client_count=2,
        timeout=900.0,
    ),
    # the durable-tier grinder: volume through the LSM
    # engines + randomized knobs (eager tlog spill, tiny flush budgets,
    # BUGGIFY crash windows in compaction/manifest/WAL) under kill/reboot
    # churn AND clogging — the composed torture the durable tier shipped
    # without
    "DurableCycleAttrition": lambda: Spec(
        title="DurableCycleAttrition",
        workloads=[
            (CycleWorkload, {"nodes": 8, "transactions": 10, "think_time": 1.8}),
            (BulkLoadWorkload, {"batches": 4, "batch_size": 60}),
            (MachineAttritionWorkload, {"interval": 6.0, "delay_before": 3.0}),
            (RandomCloggingWorkload, {"scale": 0.02}),
            (ConsistencyCheckWorkload, {}),
        ],
        dynamic=DynamicClusterConfig(n_workers=6, n_tlogs=2, n_resolvers=2,
                                     n_storage=2),
        client_count=2,
        timeout=900.0,
    ),
    # DD split/merge under attrition: volume drives the
    # tracker's (randomized-knob) split threshold while workers die and
    # reboot; the replica diff + cycle invariant must hold through
    # relocations racing recoveries
    "DataDistributionAttrition": lambda: Spec(
        title="DataDistributionAttrition",
        workloads=[
            (CycleWorkload, {"nodes": 8, "transactions": 10, "think_time": 1.8}),
            (BulkLoadWorkload, {"batches": 5, "batch_size": 60}),
            (MachineAttritionWorkload, {"interval": 7.0, "delay_before": 4.0,
                                        "spare_storage": True}),
            (ConsistencyCheckWorkload, {}),
        ],
        dynamic=DynamicClusterConfig(n_workers=10, n_tlogs=2, n_resolvers=2,
                                     n_storage=2),
        client_count=2,
        timeout=900.0,
    ),
    # tests/restarting/-class spec: the WHOLE cluster (coordinators
    # included) reboots mid-run; everything re-forms from disk and the
    # invariants hold across the gap
    "CycleTestRestart": lambda: Spec(
        title="CycleTestRestart",
        workloads=[
            (CycleWorkload, {"nodes": 8, "transactions": 12, "think_time": 1.5}),
            (FullClusterRebootWorkload, {"delay_before": 6.0, "rounds": 2,
                                         "interval": 14.0}),
            (ConsistencyCheckWorkload, {}),
        ],
        dynamic=DynamicClusterConfig(n_workers=6, n_tlogs=2, n_resolvers=2,
                                     n_storage=2),
        client_count=2,
        timeout=900.0,
    ),
    # fast/Watches.txt + rare/SelectorCorrectness + VersionStamp
    "WatchesAndSelectors": lambda: Spec(
        title="WatchesAndSelectors",
        workloads=[
            (WatchesWorkload, {"rounds": 5}),
            (SelectorCorrectnessWorkload, {"checks": 25}),
            (VersionStampWorkload, {"rounds": 6}),
        ],
        cluster=ClusterConfig(n_resolvers=2, n_storage=2),
        client_count=2,
        timeout=600.0,
    ),
    # tests/fast/CycleTest.txt: Cycle + RandomClogging ×2 (+ replica check)
    "CycleTest": lambda: Spec(
        title="CycleTest",
        workloads=[
            (CycleWorkload, {"nodes": 12, "transactions": 15}),
            (RandomCloggingWorkload, {"scale": 0.02}),
            (ConsistencyCheckWorkload, {}),
        ],
        cluster=ClusterConfig(n_resolvers=2, n_storage=2, storage_replication=2),
        client_count=3,
    ),
    # the north star: same cycle churn, resolvers on the card
    # (the JAX package's CycleTestTPU)
    "CycleTestCUDA": lambda: Spec(
        title="CycleTestCUDA",
        workloads=[(CycleWorkload, {"nodes": 10, "transactions": 8})],
        cluster=ClusterConfig(n_resolvers=2, n_storage=2, engine_factory=make_engine_factory()),
        client_count=2,
    ),
    # rare/FuzzApiCorrectness.txt: randomized op streams vs the model,
    # with clogging so retry/unknown-result paths actually fire
    "FuzzApiCorrectness": lambda: Spec(
        title="FuzzApiCorrectness",
        workloads=[
            (FuzzApiCorrectnessWorkload, {"transactions": 18}),
            (RandomCloggingWorkload, {"scale": 0.02}),
            (ConsistencyCheckWorkload, {}),
        ],
        cluster=ClusterConfig(n_resolvers=2, n_storage=2, storage_replication=2),
        client_count=3,
    ),
    # write-skew + balance invariants under contention: anomalies snapshot
    # isolation allows and the resolver's read-conflict detection forbids
    "Serializability": lambda: Spec(
        title="Serializability",
        workloads=[
            (SerializabilityWorkload, {"rounds": 10}),
            (RandomCloggingWorkload, {"scale": 0.02}),
        ],
        cluster=ClusterConfig(n_resolvers=2, n_storage=2),
        client_count=4,
    ),
    # Inventory + QueuePush + clogging: conditional RMWs and contended
    # versionstamped appends under transport loss
    "InventoryQueue": lambda: Spec(
        title="InventoryQueue",
        workloads=[
            (InventoryWorkload, {"ops": 12}),
            (QueuePushWorkload, {"pushes": 10}),
            (RandomCloggingWorkload, {"scale": 0.02}),
            (ConsistencyCheckWorkload, {}),
        ],
        cluster=ClusterConfig(n_resolvers=2, n_storage=2, storage_replication=2),
        client_count=3,
    ),
    # sustained sequential loading + a timed 90/10 measurement pass
    "BulkLoadThroughput": lambda: Spec(
        title="BulkLoadThroughput",
        workloads=[
            (BulkLoadWorkload, {"batches": 5, "batch_size": 40}),
            (ThroughputWorkload, {"seconds": 4.0}),
        ],
        cluster=ClusterConfig(n_resolvers=2, n_storage=4),
        client_count=3,
    ),
    "IncrementTest": lambda: Spec(
        title="IncrementTest",
        workloads=[(IncrementWorkload, {"transactions": 12})],
        cluster=ClusterConfig(n_resolvers=2, n_storage=2),
        client_count=3,
    ),
    # tests/rare/ConflictRangeCheck.txt
    "ConflictRangeCheck": lambda: Spec(
        title="ConflictRangeCheck",
        workloads=[(ConflictRangeWorkload, {"rounds": 20})],
        cluster=ClusterConfig(n_resolvers=4, n_storage=2),
        client_count=4,
    ),
    "WriteDuringRead": lambda: Spec(
        title="WriteDuringRead",
        workloads=[(WriteDuringReadWorkload, {"rounds": 12})],
        cluster=ClusterConfig(n_resolvers=2, n_storage=2),
        client_count=2,
    ),
    "AtomicOps": lambda: Spec(
        title="AtomicOps",
        workloads=[(AtomicOpsWorkload, {"transactions": 15})],
        cluster=ClusterConfig(n_resolvers=2, n_storage=2),
        client_count=3,
    ),
    # tests/RandomReadWrite.txt: the 90/10 metric workload + clogging
    "RandomReadWrite": lambda: Spec(
        title="RandomReadWrite",
        workloads=[
            (RandomReadWriteWorkload, {"transactions": 20}),
            (RandomCloggingWorkload, {"scale": 0.02}),
        ],
        cluster=ClusterConfig(n_resolvers=4, n_storage=4),
        client_count=4,
    ),
}
