"""Device-fault tolerance for the resolver's conflict engine.

Port of the registry of ``foundationdb_tpu/fault/__init__.py``: the
module-level list that lets test harnesses find every supervisor a
simulation created (including ones whose processes have since died);
Simulator.__init__ resets it per run, like sim/validation.py.

The supervisor and the injector themselves (`ResilientEngine`,
`FaultInjectingEngine`, `maybe_wrap`) are not ported yet: they come with
crash-stop recovery.
"""
from __future__ import annotations

from typing import List

#: every supervisor constructed since the last reset (sim-wide). Recording
#: is armed by Simulator.__init__ via reset_registry() — a real-mode
#: cluster never arms it, so dead generations' engines are not pinned in
#: memory outside simulation.
_registry: List = []
_recording = False


def register_engine(engine) -> None:
    if _recording:
        _registry.append(engine)


def registered_engines() -> List:
    return list(_registry)


def reset_registry() -> None:
    global _recording
    _recording = True
    del _registry[:]


__all__ = ["register_engine", "registered_engines", "reset_registry"]
