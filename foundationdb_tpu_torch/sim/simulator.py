"""The simulator: machines, datacenters, kill/reboot/clog APIs.

Port of ``foundationdb_tpu/sim/simulator.py``.

Re-design of ISimulator/Sim2 (fdbrpc/simulator.h:35-316). One Simulator owns
the scheduler, the network, the process/machine/DC topology and the fault
APIs that anti-quiescence workloads (attrition, clogging) drive. A process
carries an optional boot function so reboots restart its roles, mirroring
simulatedFDBDRebooter (SimulatedCluster.actor.cpp:198).
"""
from __future__ import annotations

import enum
from typing import Any, Callable, Coroutine, Dict, List, Optional

from ..core import buggify
from .disk import SimDisk
from .loop import Scheduler, TaskPriority, set_scheduler
from .network import SimNetwork, SimProcess


class KillType(enum.IntEnum):
    """reference: ISimulator::KillType (simulator.h:40)."""

    KILL_INSTANTLY = 0
    INJECT_FAULTS = 1
    REBOOT_AND_DELETE = 2
    REBOOT = 3


BootFn = Callable[["Simulator", SimProcess], Coroutine]


class Simulator:
    """Deterministic world: everything hangs off one seed."""

    def __init__(self, seed: int = 0, randomize_knobs: bool = False):
        self.seed = seed
        self.sched = Scheduler(seed)
        self.net = SimNetwork(self.sched)
        buggify.enable(self.sched.rng)
        from . import validation

        validation.enable()
        from .. import fault

        fault.reset_registry()
        from ..core import telemetry

        telemetry.reset()
        if randomize_knobs:
            from ..core import knobs
            knobs.randomize_all(self.sched.rng)
        # span collection follows the knob (never force-disabled here: a
        # harness may have enabled collection before building its sim)
        from ..core.knobs import SERVER_KNOBS
        from ..core.trace import g_spans

        if float(getattr(SERVER_KNOBS, "trace_span_sample_rate", 0.0)) > 0:
            g_spans.enabled = True
        self.machines: Dict[str, List[SimProcess]] = {}
        #: address -> its disk; survives kills and reboots (the platters)
        self.disks: Dict[str, SimDisk] = {}
        self._boot_fns: Dict[str, BootFn] = {}
        self._next_addr = 0
        set_scheduler(self.sched)

    def disk_for(self, address: str) -> SimDisk:
        d = self.disks.get(address)
        if d is None:
            d = self.disks[address] = SimDisk(self.sched)
        return d

    # -- topology -------------------------------------------------------------
    def new_process(
        self,
        name: str = "",
        machine_id: Optional[str] = None,
        dc_id: str = "dc0",
        boot_fn: Optional[BootFn] = None,
    ) -> SimProcess:
        self._next_addr += 1
        addr = f"1.0.0.{self._next_addr}:1"
        machine_id = machine_id or f"m{self._next_addr}"
        proc = SimProcess(addr, machine_id, dc_id, name or f"proc{self._next_addr}")
        self.net.add_process(proc)
        self.machines.setdefault(machine_id, []).append(proc)
        if boot_fn is not None:
            self._boot_fns[addr] = boot_fn
            self.boot(proc)
        return proc

    def boot(self, proc: SimProcess) -> None:
        fn = self._boot_fns.get(proc.address)
        if fn is not None:
            proc.actors.add(self.sched.spawn(fn(self, proc), name=f"boot:{proc.name}"))

    # -- fault injection (simulator.h:147-155) --------------------------------
    def kill_process(self, proc: SimProcess, kill_type: KillType = KillType.KILL_INSTANTLY) -> None:
        if not proc.alive:
            return
        proc.alive = False
        proc.handlers.clear()
        proc.actors.cancel_all()
        # Peers learn of the death the way Sim2 peers do — broken connections
        # (instant), mirrored here as failure-monitor state; marking the
        # address failed also errors every outstanding reply against it.
        self.net.monitor.set_status(proc.address, True)
        # The page cache dies with the process: un-synced writes are
        # randomly applied / lost / torn (AsyncFileNonDurable semantics).
        disk = self.disks.get(proc.address)
        if disk is not None:
            disk.crash(self.sched.rng)
        if kill_type in (KillType.REBOOT, KillType.REBOOT_AND_DELETE):
            if kill_type == KillType.REBOOT_AND_DELETE:
                proc.globals.clear()
                self.disks.pop(proc.address, None)
            reboot_delay = 0.5 + self.sched.rng.random01()

            def do_boot() -> None:
                proc.alive = True
                proc.reboots += 1
                self.net.monitor.set_status(proc.address, False)
                self.boot(proc)

            self.sched.at(self.sched.time + reboot_delay, do_boot, TaskPriority.DEFAULT_DELAY)

    def revive_process(self, proc: SimProcess) -> None:
        """Boot a process previously killed with KILL_INSTANTLY (targeted
        down-then-up scenarios; the reference's workloads drive the same
        through reboot requests after a delay)."""
        if proc.alive:
            return
        proc.alive = True
        proc.reboots += 1
        self.net.monitor.set_status(proc.address, False)
        self.boot(proc)

    def kill_machine(self, machine_id: str, kill_type: KillType = KillType.KILL_INSTANTLY) -> None:
        for proc in self.machines.get(machine_id, []):
            self.kill_process(proc, kill_type)

    def clog_pair(self, a: SimProcess, b: SimProcess, seconds: float) -> None:
        self.net.clog_pair(a.address, b.address, seconds)

    def clog_process(self, proc: SimProcess, seconds: float) -> None:
        """Clog every link touching proc (RandomClogging workload's move)."""
        for other in self.net.processes.values():
            if other.address != proc.address:
                self.net.clog_pair(proc.address, other.address, seconds)

    def start_system_monitor(self, interval: float = 5.0):
        """Spawn the per-process gauge sampler (flow/SystemMonitor.cpp's
        role); returns the task."""
        from .system_monitor import system_monitor

        return self.sched.spawn(system_monitor(self, interval),
                                TaskPriority.LOW, name="systemMonitor")

    # -- running --------------------------------------------------------------
    def run(self, until: Optional[float] = None) -> None:
        self.sched.run(until=until)

    def run_until(self, fut, until: Optional[float] = None) -> Any:
        return self.sched.run_until(fut, until=until)
