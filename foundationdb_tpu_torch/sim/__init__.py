"""Deterministic simulation runtime.

Port of ``foundationdb_tpu/sim/__init__.py``.

The reference's single most load-bearing design decision (SURVEY.md §1, §4)
is that flow/ + fdbrpc/ virtualize the entire world — time, network, disk,
randomness — behind one seam (INetwork / ISimulator), making a whole
multi-datacenter cluster simulable deterministically inside one process.
This package is the framework's version of that seam:

  loop.py       Future/Promise + cooperative scheduler with virtual time and
                task priorities (flow/flow.h, flow/network.h:30-76, Net2/Sim2)
  actors.py     combinator library (flow/genericactors.actor.h)
  network.py    token-addressed endpoints + simulated message bus with
                latency/clogging/partitions (fdbrpc/FlowTransport, Sim2Conn)
  simulator.py  processes/machines/DCs, kill/reboot/clog APIs
                (fdbrpc/simulator.h:35-316)

Determinism contract: given a seed, every run produces the identical event
sequence. All scheduling ties break on (virtual time, -priority, insertion
seq); all randomness flows from one DeterministicRandom; device calls are
dispatched from exactly one logical queue (the engine's stream).
"""
from .loop import (
    Future,
    Promise,
    Scheduler,
    SimError,
    Task,
    TaskPriority,
    current_scheduler,
    delay,
    never,
    now,
    spawn,
    yield_now,
)

__all__ = [
    "Future", "Promise", "Scheduler", "SimError", "Task", "TaskPriority",
    "current_scheduler", "delay", "never", "now", "spawn", "yield_now",
]
