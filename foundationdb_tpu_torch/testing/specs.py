"""Named test specs (the analog of tests/*.txt).

Port of ``foundationdb_tpu/testing/specs.py``: every spec of the static
cluster. Each spec composes workloads + cluster config like the
reference's declarative files: tests/fast/CycleTest.txt = Cycle +
RandomClogging + Attrition; attrition joins with the dynamic cluster. Run
via the CLI:

    python -m foundationdb_tpu_torch.testing.runner --spec CycleTest --seed 7
    python -m foundationdb_tpu_torch.testing.runner --list

`CycleTestCUDA` runs its resolvers on the card (the JAX package's
CycleTestTPU). The specs of the dynamic cluster and the multi-device
CycleTestTPU8 / RandomReadWriteTPU8 are not ported yet (ROADMAP queue 1
items 5 and 9).
"""
from __future__ import annotations

from typing import Callable, Dict

from ..server.cluster import ClusterConfig
from .workload import Spec
from .workloads import (
    AtomicOpsWorkload,
    BulkLoadWorkload,
    ConflictRangeWorkload,
    ConsistencyCheckWorkload,
    CycleWorkload,
    FuzzApiCorrectnessWorkload,
    IncrementWorkload,
    InventoryWorkload,
    QueuePushWorkload,
    RandomCloggingWorkload,
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


SPECS: Dict[str, Callable[[], Spec]] = {
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
