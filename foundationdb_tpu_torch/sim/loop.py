"""Futures, promises and the deterministic cooperative scheduler.

Port of ``foundationdb_tpu/sim/loop.py``.

Re-design of the reference's flow runtime: instead of a C# actor
compiler generating state machines from ACTOR functions (flow/actorcompiler/),
plain Python coroutines play the actor role and a virtual-time scheduler
plays Sim2's ordered task queue (fdbrpc/sim2.actor.cpp:1518-1571). The
observable semantics we keep from the reference:

  * single-assignment futures with intrusive callback chains
    (SAV<T>, flow/flow.h:347-480)
  * a global task-priority ladder; ready tasks run in
    (time, priority, insertion-order) order (flow/network.h:30-76)
  * virtual time only advances when the ready queue drains
  * errors are values (flow/Error.h); awaiting a failed future raises

No threads anywhere: determinism comes from cooperative scheduling, exactly
like the reference (SURVEY.md §5 "race detection").
"""
from __future__ import annotations

import enum
import heapq
from typing import Any, Callable, Coroutine, List, Optional

import time as _wall

from ..core import error
from ..core.error import FDBError
from ..core.rng import DeterministicRandom

SimError = FDBError


class TaskPriority(enum.IntEnum):
    """Scheduling priorities (reference: flow/network.h:30-76). Higher runs
    first at equal virtual time."""

    MAX = 1_000_000
    RUN_LOOP = 30_000
    COORDINATION_REPLY = 8810
    COORDINATION = 8800
    FAILURE_MONITOR = 8700
    RESOLUTION_METRICS = 8700
    CLUSTER_CONTROLLER = 8650
    PROXY_COMMIT_DISPATCH = 8640
    MASTER_TLOG_REJOIN = 8646
    PROXY_STORAGE_REJOIN = 8645
    TLOG_QUEUING_METRICS = 8620
    TLOG_POP = 8610
    TLOG_PEEK_REPLY = 8600
    TLOG_PEEK = 8590
    TLOG_COMMIT_REPLY = 8580
    TLOG_COMMIT = 8570
    PROXY_GET_RAW_COMMITTED_VERSION = 8565
    PROXY_RESOLVER_REPLY = 8560
    PROXY_COMMIT_BATCHER = 8550
    PROXY_COMMIT = 8540
    TLOG_CONFIRM_RUNNING_REPLY = 8530
    TLOG_CONFIRM_RUNNING = 8520
    PROXY_GRV_TIMER = 8510
    GET_CONSISTENT_READ_VERSION = 8500
    DEFAULT_PROMISE_ENDPOINT = 8000
    DEFAULT_ON_MAIN_THREAD = 7500
    DEFAULT_ENDPOINT = 7000
    UNKNOWN_ENDPOINT = 6500
    FETCH_KEYS = 3560
    MOVE_KEYS = 3550
    DATA_DISTRIBUTION_LAUNCH = 3530
    RATEKEEPER = 3510
    DATA_DISTRIBUTION = 3500
    STORAGE = 3000
    DEFAULT_DELAY = 7010
    DEFAULT_YIELD = 7990
    UPDATE_STORAGE = 3000
    LOW = 2000
    MIN = 1000
    ZERO = 0


class Future:
    """Single-assignment value-or-error with callbacks (flow/flow.h SAV)."""

    __slots__ = ("_ready", "_value", "_error", "_callbacks")

    def __init__(self) -> None:
        self._ready = False
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._callbacks: List[Callable[["Future"], None]] = []

    # -- inspection ---------------------------------------------------------
    @property
    def is_ready(self) -> bool:
        return self._ready

    @property
    def is_error(self) -> bool:
        return self._ready and self._error is not None

    def get(self) -> Any:
        assert self._ready, "future not ready"
        if self._error is not None:
            raise self._error
        return self._value

    # -- assignment ---------------------------------------------------------
    def _set(self, value: Any) -> None:
        assert not self._ready, "future already set"
        self._ready = True
        self._value = value
        self._fire()

    def _set_error(self, err: BaseException) -> None:
        assert not self._ready, "future already set"
        self._ready = True
        self._error = err
        self._fire()

    def _fire(self) -> None:
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def on_ready(self, cb: Callable[["Future"], None]) -> None:
        """Fires immediately if already ready (callback chain semantics)."""
        if self._ready:
            cb(self)
        else:
            self._callbacks.append(cb)

    def remove_callback(self, cb: Callable[["Future"], None]) -> None:
        """Deregister a pending callback (flow's Callback::remove) — lets a
        race loser detach from a long-lived future instead of leaking."""
        try:
            self._callbacks.remove(cb)
        except ValueError:
            pass

    # -- await protocol -----------------------------------------------------
    def __await__(self):
        if not self._ready:
            yield self
        return self.get()


class Promise:
    """The write end of a Future (flow/flow.h Promise<T>)."""

    __slots__ = ("future",)

    def __init__(self) -> None:
        self.future = Future()

    def send(self, value: Any = None) -> None:
        self.future._set(value)

    def send_error(self, err: BaseException) -> None:
        self.future._set_error(err)

    @property
    def is_set(self) -> bool:
        return self.future._ready

    def break_promise(self) -> None:
        if not self.future._ready:
            self.future._set_error(error.broken_promise())


_READY_FUTURE = None


def ready_future(value: Any = None) -> Future:
    f = Future()
    f._set(value)
    return f


def error_future(err: BaseException) -> Future:
    f = Future()
    f._set_error(err)
    return f


class Task(Future):
    """A spawned coroutine; itself a Future of the coroutine's return value.
    The analog of an ACTOR's implicit return future."""

    __slots__ = ("_coro", "_sched", "priority", "_cancelled", "name")

    def __init__(self, coro: Coroutine, sched: "Scheduler", priority: int, name: str = ""):
        super().__init__()
        self._coro = coro
        self._sched = sched
        self.priority = priority
        self._cancelled = False
        self.name = name or getattr(coro, "__name__", "task")

    def cancel(self) -> None:
        """Cancel the actor (reference: actor_cancelled on future drop)."""
        if self._ready or self._cancelled:
            return
        self._cancelled = True
        if _current is not self._sched:
            # The world has been torn down (set_scheduler(None) after a
            # finished simulation) or belongs to another simulation: drop
            # the coroutine without running its cancellation path, which
            # could touch the dead scheduler.
            try:
                self._coro.close()
            except RuntimeError:
                pass
            self._finish_error(error.operation_cancelled())
            return
        try:
            self._coro.throw(error.operation_cancelled())
            # The coroutine swallowed the cancellation and awaited again.
            # Actors may not wait during cancellation (the reference's
            # actor-compiler enforces this); force it closed.
            self._coro.close()
        except StopIteration as stop:
            self._finish_value(stop.value)
        except error.OperationCancelled as e:
            self._finish_error(e)
        except FDBError as e:
            self._finish_error(e)
        except (RuntimeError, ValueError):
            # RuntimeError: already closed, or ignored GeneratorExit.
            # ValueError: "coroutine already executing" — an actor cancelled
            # itself (e.g. a role's shutdown() cancelling its own actor
            # collection mid-handler); it finishes its current synchronous
            # stretch, then _step's _cancelled guard parks it forever.
            pass
        finally:
            # Whatever happened above, the task is finished now.
            self._finish_error(error.operation_cancelled())

    def _finish_value(self, v: Any) -> None:
        if not self._ready:
            self._set(v)

    def _finish_error(self, e: BaseException) -> None:
        if not self._ready:
            self._set_error(e)

    def _step(self, fut: Optional[Future]) -> None:
        """Advance the coroutine one hop (deliver fut's value/error)."""
        if self._ready or self._cancelled:
            return
        try:
            if fut is not None and fut.is_error:
                try:
                    fut.get()
                except BaseException as e:
                    waited = self._coro.throw(e)
            else:
                waited = self._coro.send(None)
        except StopIteration as stop:
            self._finish_value(stop.value)
            return
        except error.OperationCancelled as e:
            self._finish_error(e)
            return
        except FDBError as e:
            self._finish_error(e)
            return
        # The coroutine yielded a Future it is waiting on.
        assert isinstance(waited, Future), f"actors may only await Futures, got {waited!r}"
        waited.on_ready(lambda f: self._sched._schedule_step(self, f, self.priority))


class Scheduler:
    """Deterministic virtual-time run loop (Sim2's task queue,
    sim2.actor.cpp:1518-1571). Ties break (time, -priority, seq)."""

    def __init__(self, seed: int = 0, start_time: float = 0.0):
        self.time = start_time
        self.rng = DeterministicRandom(seed)
        self._queue: List = []  # (time, -priority, seq, fn)
        self._seq = 0
        self._stopped = False
        self.tasks_run = 0
        #: slow-task profiling (flow/Profiler.actor.cpp's slow-task side):
        #: a single cooperative step burning more WALL time than this
        #: blocks the whole world — trace it. 0 disables.
        self.slow_task_threshold: float = 0.0
        self.slow_tasks: List = []   # (virtual_time, wall_seconds, fn_name)

    # -- core queue ---------------------------------------------------------
    def at(self, when: float, fn: Callable[[], None], priority: int = TaskPriority.DEFAULT_DELAY) -> None:
        assert when >= self.time
        self._seq += 1
        heapq.heappush(self._queue, (when, -int(priority), self._seq, fn))

    def _schedule_step(self, task: Task, fut: Optional[Future], priority: int) -> None:
        self.at(self.time, lambda: task._step(fut), priority)

    # -- public api ---------------------------------------------------------
    def spawn(self, coro: Coroutine, priority: int = TaskPriority.DEFAULT_YIELD, name: str = "") -> Task:
        t = Task(coro, self, int(priority), name)
        self._schedule_step(t, None, int(priority))
        return t

    def delay(self, seconds: float, priority: int = TaskPriority.DEFAULT_DELAY) -> Future:
        f = Future()
        self.at(self.time + max(seconds, 0.0), lambda: (not f.is_ready) and f._set(None), priority)
        return f

    def stop(self) -> None:
        self._stopped = True

    def run(self, until: Optional[float] = None, max_tasks: Optional[int] = None) -> None:
        """Run until the queue drains, `until` virtual seconds pass, or
        max_tasks events execute."""
        self._stopped = False
        while self._queue and not self._stopped:
            when, negp, seq, fn = self._queue[0]
            if until is not None and when > until:
                self.time = until
                return
            heapq.heappop(self._queue)
            self.time = when
            self.tasks_run += 1
            if self.slow_task_threshold > 0.0:
                t0 = _wall.perf_counter()
                fn()
                dt = _wall.perf_counter() - t0
                if dt >= self.slow_task_threshold:
                    self._trace_slow_task(dt, fn)
            else:
                fn()
            if max_tasks is not None and self.tasks_run >= max_tasks:
                return

    def _trace_slow_task(self, wall_seconds: float, fn) -> None:
        """Record + trace a cooperative step that hogged the (real) CPU —
        the deterministic world's analog of the reference's SlowTask
        profiling (FLOW_KNOBS->SLOWTASK_PROFILING_*): one long step stalls
        every simulated process at once."""
        name = getattr(fn, "__qualname__", None) or repr(fn)
        closure = getattr(fn, "__closure__", None)
        code = getattr(fn, "__code__", None)
        if closure and code is not None:
            # the step lambda closes over the RUNNING Task as 'task'; it
            # may also close over 'fut' — which is itself a Task when the
            # step resumed from awaiting one, so match cells by freevar
            # name rather than taking the first Task-typed cell (cells
            # are ordered alphabetically: 'fut' would win)
            for var, cell in zip(code.co_freevars, closure):
                try:
                    obj = cell.cell_contents
                except ValueError:
                    continue   # unbound cell: a crash here would abort
                    #            the whole run loop for a LOG line
                if var == "task" and isinstance(obj, Task):
                    name = f"task:{obj.name}"
                    break
        self.slow_tasks.append((self.time, wall_seconds, name))
        del self.slow_tasks[:-100]
        from ..core.trace import TraceEvent

        TraceEvent("SlowTask").detail("WallSeconds", round(wall_seconds, 4)).detail(
            "Fn", name).log()

    def run_until(self, fut: Future, until: Optional[float] = None) -> Any:
        """Drive the loop until `fut` resolves; returns its value."""
        fut.on_ready(lambda _: self.stop())
        self.run(until=until)
        if not fut.is_ready:
            raise error.timed_out(f"future unresolved at t={self.time}")
        return fut.get()


# -- module-level conveniences (the g_network pattern) -----------------------

_current: Optional[Scheduler] = None


def set_scheduler(s: Optional[Scheduler]) -> None:
    global _current
    _current = s


def current_scheduler() -> Scheduler:
    assert _current is not None, "no Scheduler active (call set_scheduler)"
    return _current


def now() -> float:
    return current_scheduler().time


def delay(seconds: float, priority: int = TaskPriority.DEFAULT_DELAY) -> Future:
    return current_scheduler().delay(seconds, priority)


def yield_now(priority: int = TaskPriority.DEFAULT_YIELD) -> Future:
    """Re-queue at current time (flow: yield())."""
    return current_scheduler().delay(0.0, priority)


def spawn(coro: Coroutine, priority: int = TaskPriority.DEFAULT_YIELD, name: str = "") -> Task:
    return current_scheduler().spawn(coro, priority, name)


def never() -> Future:
    return Future()
