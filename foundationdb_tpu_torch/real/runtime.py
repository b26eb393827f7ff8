"""Real-mode runtime: the sim seam implemented over wall clock + TCP + disk.

Port of ``foundationdb_tpu/real/runtime.py``.

The whole server stack (worker, master, proxy, resolver, tlog, storage,
coordination) is written against three seams — the cooperative scheduler
(sim/loop.py), the token-addressed network (sim/network.py's surface), and
the async file API (sim/disk.py's surface). In simulation those are
virtual-time and in-process; here the SAME role code runs over:

  * RealScheduler — the identical (time, priority, seq) run loop, but
    `time` is the monotonic wall clock and the loop is driven by an
    asyncio task that sleeps until the next timer and wakes on IO;
  * RealNetClient — request/one_way returning scheduler Futures, bridged
    onto real/transport.py's asyncio TCP frames (with the protocol
    handshake and per-request timeouts);
  * RealDisk — the SimDisk file surface over actual files in a data dir
    (write-through; sync maps to flush+fsync).

This is the reference's architecture inverted: FDB virtualizes the real
world for simulation (INetwork/Sim2); we realize the simulated world for
production (fdbserver/fdbserver.actor.cpp:1607 fdbd() over
FlowTransport.actor.cpp:964). One seam, two worlds, one body of role code.
"""
from __future__ import annotations

import asyncio
import os
import time as _time
from typing import Any, Callable, Dict, List, Optional

from ..core import error, trace
from ..sim.actors import ActorCollection
from ..sim.loop import Future, Scheduler, Task, TaskPriority
from .transport import RealNetwork, RealProcess


class RealScheduler(Scheduler):
    """The cooperative run loop on the wall clock. Single-threaded: it runs
    inside one asyncio task, so scheduler state needs no locks — network
    callbacks fire on the same loop and just push queue entries + wake."""

    def __init__(self, seed: int = 0):
        super().__init__(seed=seed, start_time=_time.monotonic())
        self._wake: Optional[asyncio.Event] = None
        self._running = False

    def at(self, when: float, fn: Callable[[], None], priority: int = TaskPriority.DEFAULT_DELAY) -> None:
        # wall clock: a caller's `self.time + dt` can be marginally behind
        # monotonic now — clamp instead of asserting
        self._seq += 1
        import heapq

        heapq.heappush(self._queue, (max(when, self.time), -int(priority), self._seq, fn))
        if self._wake is not None:
            self._wake.set()

    async def run_async(self) -> None:
        """Drive the queue forever: execute everything due, then sleep
        until the next timer or an external wake (network callback)."""
        import heapq

        self._wake = asyncio.Event()
        self._running = True
        while self._running:
            self.time = max(self.time, _time.monotonic())
            drained = 0
            while self._queue and self._queue[0][0] <= self.time:
                _when, _negp, _seq, fn = heapq.heappop(self._queue)
                self.tasks_run += 1
                fn()
                drained += 1
                if drained >= 10_000:
                    # a zero-delay chain must not starve socket IO
                    await asyncio.sleep(0)
                    drained = 0
                self.time = max(self.time, _time.monotonic())
            self._wake.clear()
            if self._queue:
                dt = self._queue[0][0] - _time.monotonic()
                if dt > 0:
                    try:
                        await asyncio.wait_for(self._wake.wait(), timeout=dt)
                    except asyncio.TimeoutError:
                        pass
            else:
                await self._wake.wait()

    def shutdown(self) -> None:
        self._running = False
        if self._wake is not None:
            self._wake.set()


def sim_to_aio(fut: Future) -> "asyncio.Future":
    """Await a scheduler Future from asyncio (the transport's dispatcher)."""
    af = asyncio.get_running_loop().create_future()

    def done(f: Future) -> None:
        if af.cancelled():
            return
        if f.is_error:
            try:
                f.get()
            except BaseException as e:  # noqa: BLE001 — relay verbatim
                af.set_exception(e)
        else:
            af.set_result(f.get())

    fut.on_ready(done)
    return af


def aio_to_sim(coro, tasks: set) -> Future:
    """Bridge an asyncio coroutine to a scheduler Future (sim_to_aio's
    inverse). `tasks` must outlive the call and holds a strong ref until
    completion — asyncio keeps only weak ones, and a GC'd task would
    strand the Future unresolved forever. FDBErrors relay verbatim;
    anything else surfaces as transport loss."""
    out = Future()

    async def go() -> None:
        try:
            r = await coro
        except error.FDBError as e:
            if not out.is_ready:
                out._set_error(e)
        except Exception as e:  # noqa: BLE001 — surface as transport loss
            if not out.is_ready:
                out._set_error(error.connection_failed(str(e)))
        else:
            if not out.is_ready:
                out._set(r)

    t = asyncio.ensure_future(go())
    tasks.add(t)
    t.add_done_callback(tasks.discard)
    return out


class RealNetClient:
    """The sim network's request/one_way surface over real sockets,
    returning scheduler Futures so role code can await them. One instance
    per OS process."""

    class _Monitor:
        """Failure-monitor stub: real failure detection rides request
        timeouts and the wait-failure protocol; nothing is pre-declared."""

        def is_failed(self, _addr: str) -> bool:
            return False

        def on_failed(self, _addr: str, _cb) -> None:
            return None

    def __init__(self, sched: RealScheduler, name: str = ""):
        self.sched = sched
        self.raw = RealNetwork(name=name)
        self.monitor = RealNetClient._Monitor()
        #: strong refs — asyncio keeps only weak ones; a GC'd RPC task
        #: would leave its scheduler Future unresolved forever
        self._tasks: set = set()

    def _track(self, t) -> None:
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    def request(self, src: str, ep, payload: Any,
                priority: int = TaskPriority.DEFAULT_ENDPOINT,
                timeout: Optional[float] = None) -> Future:
        # None defers to the real_rpc_timeout_s knob (transport default);
        # explicit timeouts also ride the frame as a propagated deadline
        return aio_to_sim(
            self.raw.request(src, ep, payload, priority, timeout=timeout),
            self._tasks)

    def transport_degraded(self) -> bool:
        """Transport-level degradation signal (reconnect backoff active on
        any peer) — the depth-collapse input for wall-clock pipelines."""
        return self.raw.transport_degraded()

    def one_way(self, src: str, ep, payload: Any,
                priority: int = TaskPriority.DEFAULT_ENDPOINT) -> None:
        self._track(asyncio.ensure_future(self.raw.one_way(src, ep, payload, priority)))


class RealFile:
    """sim/disk.py's SimFile surface over one actual file. IO is performed
    inline (the files are small role metadata/logs; a thread-pool tier can
    slot in behind this surface without touching callers)."""

    def __init__(self, path: str):
        self.path = path
        if not os.path.exists(path):
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "wb"):
                pass
        self._f = open(path, "r+b")

    def size(self) -> int:
        self._f.seek(0, os.SEEK_END)
        return self._f.tell()

    async def read(self, offset: int, length: int) -> bytes:
        self._f.seek(offset)
        return self._f.read(length)

    async def write(self, offset: int, data: bytes) -> None:
        self._f.seek(0, os.SEEK_END)
        end = self._f.tell()
        if offset > end:
            self._f.write(b"\x00" * (offset - end))
        self._f.seek(offset)
        self._f.write(data)

    async def truncate(self, size: int) -> None:
        self._f.truncate(size)

    async def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


class RealDisk:
    """sim/disk.py's SimDisk surface over a data directory. File names map
    to path-safe escapes of the role store names."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._open: Dict[str, RealFile] = {}

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name.replace("/", "_").replace(":", "_"))

    def open(self, name: str, create: bool = True) -> RealFile:
        f = self._open.get(name)
        if f is not None:
            return f
        p = self._path(name)
        if not create and not os.path.exists(p):
            raise error.file_not_found(name)
        f = self._open[name] = RealFile(p)
        return f

    def exists(self, name: str) -> bool:
        return name in self._open or os.path.exists(self._path(name))

    def delete(self, name: str) -> None:
        f = self._open.pop(name, None)
        if f is not None:
            f.close()
        try:
            os.unlink(self._path(name))
        except FileNotFoundError:
            pass

    def rename(self, src: str, dst: str) -> None:
        fs = self._open.pop(src, None)
        if fs is not None:
            fs.close()
        fd = self._open.pop(dst, None)
        if fd is not None:
            fd.close()
        os.replace(self._path(src), self._path(dst))

    def list(self, prefix: str = "") -> List[str]:
        esc = prefix.replace("/", "_").replace(":", "_")
        return sorted(n for n in os.listdir(self.root) if n.startswith(esc))


class NodeProcess(RealProcess):
    """The transport listener fleshed out to the SimProcess surface the
    role code expects (handlers registry it already has; actors, locality,
    per-process globals added here)."""

    def __init__(self, host: str, port: int, machine_id: str, dc_id: str):
        super().__init__(host, port)
        self.machine_id = machine_id
        self.dc_id = dc_id
        self.name = f"{host}:{port}"
        self.alive = True
        self.actors = ActorCollection()
        self.globals: Dict[str, Any] = {}
        self.reboots = 0

    def register(self, token: str, handler: Callable):
        super().register(token, handler)
        from ..sim.network import Endpoint

        return Endpoint(self.address, token)


class RealWorld:
    """The `sim` handle roles receive: .net, .sched, .disk_for() — the
    world seam with the real implementations plugged in."""

    def __init__(self, sched: RealScheduler, net: RealNetClient, datadir: str):
        self.sched = sched
        self.net = net
        self.datadir = datadir
        self._disks: Dict[str, RealDisk] = {}

    def disk_for(self, addr: str) -> RealDisk:
        d = self._disks.get(addr)
        if d is None:
            safe = addr.replace("/", "_").replace(":", "_")
            d = self._disks[addr] = RealDisk(os.path.join(self.datadir, safe))
        return d


async def _run_with_trace_context(ctx, handler, body):
    """Install the inbound trace context (possibly None) around a
    scheduler-dispatched handler. Scheduler tasks interleave inside ONE
    asyncio task (run_async drives every step in its own context), so the
    ambient context is only guaranteed during the handler's synchronous
    prefix — the set here runs in the same step as that prefix, and
    handlers capture the context at entry, before their first await
    (core/trace.py's discipline). The finally CLEARS the variable rather
    than token-resetting it: interleaved handlers pop out of LIFO order,
    and a token reset would re-install a completed sibling's context as
    the shared ambient value — a context-less handler dispatched after it
    would then record spans under a foreign trace id."""
    from ..core import trace

    trace.push_trace_context(ctx)
    try:
        return await handler(body)
    finally:
        trace.push_trace_context(None)


def make_dispatcher(sched: RealScheduler):
    """Transport dispatcher: run a role handler on the node's cooperative
    scheduler and hand asyncio an awaitable for the reply. The scheduler
    Task rides on the future as `sim_task` so deadline shedding
    (real/transport.RealProcess._answer) can cancel the HANDLER, not just
    the asyncio bridge — expired work stops running, it doesn't finish
    into a reply nobody awaits. With tracing active every handler is
    wrapped so its synchronous prefix sees exactly its own request's
    inbound context (or None) — never a sibling's leftovers; with spans
    off nothing wraps and nothing allocates."""

    def dispatch(handler, body):
        ctx = trace.current_trace_context()
        coro = (_run_with_trace_context(ctx, handler, body)
                if (ctx is not None or trace.spans_enabled())
                else handler(body))
        t = sched.spawn(coro, TaskPriority.DEFAULT_ENDPOINT,
                        name=f"rpc:{getattr(handler, '__name__', 'handler')}")
        af = sim_to_aio(t)
        af.sim_task = t
        return af

    return dispatch
