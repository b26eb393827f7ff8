"""Device-fault tolerance for the resolver's conflict engine.

Port of ``foundationdb_tpu/fault/__init__.py``. The card is not infallible:
a serving path sees launch failures, hung dispatches, runtime errors and
(rarely) silent corruption. The device engine is paired with the
reference-exact CPU oracle (ops/oracle.py), which already pins every
engine bit for bit, so it can serve as a live failover target, not just a
test fixture.

Two pieces:

  * FaultInjectingEngine (inject.py) — a deterministic, seed-driven
    wrapper over any conflict engine that injects dispatch exceptions,
    never-completing hangs, slow batches, bursty outages (the preemption
    model) and flipped verdict bits.
  * ResilientEngine (resilient.py) — the supervisor: per-dispatch
    watchdog, bounded retries with jittered exponential backoff, a
    health state machine (healthy -> suspect -> failed -> probation),
    a host-side shadow of the committed write-history window that
    rebuilds the CPU oracle mid-stream with bit-identical verdicts, and
    a sampled cross-validation probe that quarantines a corrupting
    device.

Crash-stop recovery (recovery.py) and the range handoff of online
resharding (handoff.py) build on the supervisor's shadow.

The module-level registry lets test harnesses find every supervisor a
simulation created (including ones whose processes have since died);
Simulator.__init__ resets it per run, like sim/validation.py.
"""
from __future__ import annotations

from typing import List

from .inject import FaultInjectingEngine, FaultRates
from .resilient import (
    HEALTHY,
    SUSPECT,
    FAILED,
    PROBATION,
    QUARANTINED,
    FlightRecorder,
    ResilienceConfig,
    ResilientEngine,
    abort_set_digest,
)

#: every ResilientEngine constructed since the last reset (sim-wide).
#: Recording is armed by Simulator.__init__ via reset_registry() — a
#: real-mode cluster never arms it, so dead generations' engines are not
#: pinned in memory outside simulation.
_registry: List["ResilientEngine"] = []
_recording = False


def register_engine(engine: "ResilientEngine") -> None:
    if _recording:
        _registry.append(engine)


def registered_engines() -> List["ResilientEngine"]:
    return list(_registry)


def reset_registry() -> None:
    global _recording
    _recording = True
    del _registry[:]


def maybe_wrap(engine, cluster_cfg):
    """The one wrap decision for role wiring: supervise the factory's
    engine when the cluster config asks for it (`resilient_resolver`) and
    the factory didn't already build a supervised engine."""
    if (getattr(cluster_cfg, "resilient_resolver", False)
            and not hasattr(engine, "health_stats")):
        engine = ResilientEngine(engine)
    return engine


__all__ = [
    "FaultInjectingEngine",
    "FaultRates",
    "ResilienceConfig",
    "ResilientEngine",
    "maybe_wrap",
    "HEALTHY",
    "SUSPECT",
    "FAILED",
    "PROBATION",
    "QUARANTINED",
    "register_engine",
    "registered_engines",
    "reset_registry",
]
