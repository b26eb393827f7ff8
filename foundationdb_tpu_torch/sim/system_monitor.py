"""SystemMonitor: per-process gauges -> ProcessMetrics trace events.

Port of ``foundationdb_tpu/sim/system_monitor.py``.

Re-design of flow/SystemMonitor.cpp: the reference samples each process's
CPU/memory/network/disk and emits a periodic ProcessMetrics trace event.
The simulation's analog gauges are the quantities that exist in the
simulated world: live actor count, registered handler count, the disk
footprint (durable + page-cache bytes), scheduler tasks executed since
the last sample, and reboot count — enough for the status/trace tooling
to see a hot or leaking process, which is the component's job."""
from __future__ import annotations

from ..core.trace import TraceEvent
from .loop import TaskPriority, delay


async def system_monitor(sim, interval: float = 5.0) -> None:
    """Emit one ProcessMetrics event per alive process per interval
    (spawn on the simulator: sim.start_system_monitor())."""
    last_tasks = 0
    while True:
        await delay(interval, TaskPriority.LOW)
        tasks_now = sim.sched.tasks_run
        TraceEvent("MachineMetrics").detail(
            "TasksRun", tasks_now - last_tasks).detail(
            "Processes", sum(1 for p in sim.net.processes.values() if p.alive)).log()
        last_tasks = tasks_now
        for addr, proc in sorted(sim.net.processes.items()):
            if not proc.alive:
                continue
            disk = sim.disks.get(addr)
            disk_bytes = 0
            if disk is not None:
                disk_bytes = sum(f.size() for f in disk.files.values())
            TraceEvent("ProcessMetrics", id=proc.name).detail(
                "Address", addr).detail(
                "Actors", len(proc.actors)).detail(
                "Handlers", len(proc.handlers)).detail(
                "DiskBytes", disk_bytes).detail(
                "Reboots", proc.reboots).log()
