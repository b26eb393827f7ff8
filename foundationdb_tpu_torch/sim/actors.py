"""Actor combinators (reference: flow/genericactors.actor.h, 1634 LoC).

Port of ``foundationdb_tpu/sim/actors.py``.

The subset the transaction system actually leans on: waitForAll, quorum,
timeout, streams (PromiseStream/FutureStream), AsyncVar/AsyncTrigger,
NotifiedVersion (the version-chaining primitive the resolver and tlog use
for `whenAtLeast` sequencing), and actorCollection.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Any, Callable, Deque, Generic, List, Optional, TypeVar

from ..core import error
from .loop import Future, Promise, Task, TaskPriority, delay

T = TypeVar("T")


async def all_of_cancelling(tasks: List[Task]) -> List[Any]:
    """all_of, but a fail-fast error also CANCELS the sibling tasks —
    without this, the survivors keep running (committing, writing)
    underneath the caller's error handling."""
    try:
        return await all_of(tasks)
    except BaseException:
        for t in tasks:
            t.cancel()
        raise


def all_of(futures: List[Future]) -> Future:
    """Resolves with the list of values when every input resolves; errors as
    soon as any input errors (flow: waitForAll)."""
    out = Future()
    n = len(futures)
    if n == 0:
        out._set([])
        return out
    remaining = [n]

    def one(f: Future) -> None:
        if out.is_ready:
            return
        if f.is_error:
            try:
                f.get()
            except BaseException as e:
                out._set_error(e)
            return
        remaining[0] -= 1
        if remaining[0] == 0:
            out._set([x.get() for x in futures])

    for f in futures:
        f.on_ready(one)
    return out


def any_of(futures: List[Future]) -> Future:
    """Resolves with (index, value) of the first input to resolve; errors
    propagate (flow: choose/when)."""
    out = Future()

    def mk(i: int) -> Callable[[Future], None]:
        def one(f: Future) -> None:
            if out.is_ready:
                return
            if f.is_error:
                try:
                    f.get()
                except BaseException as e:
                    out._set_error(e)
            else:
                out._set((i, f.get()))
        return one

    for i, f in enumerate(futures):
        f.on_ready(mk(i))
    return out


def quorum(futures: List[Future], count: int) -> Future:
    """Resolves (None) when `count` inputs have resolved successfully; errors
    if success becomes impossible (flow: quorum)."""
    out = Future()
    state = {"ok": 0, "err": 0}
    n = len(futures)

    def one(f: Future) -> None:
        if out.is_ready:
            return
        if f.is_error:
            state["err"] += 1
            if n - state["err"] < count:
                try:
                    f.get()
                except BaseException as e:
                    out._set_error(e)
        else:
            state["ok"] += 1
            if state["ok"] >= count:
                out._set(None)

    if count <= 0:
        out._set(None)
        return out
    for f in futures:
        f.on_ready(one)
    return out


def timeout_after(f: Future, seconds: float, timeout_value: Any = None) -> Future:
    """f's result, or timeout_value if it doesn't resolve in time
    (flow: timeout)."""
    out = Future()
    t = delay(seconds)

    def on_f(x: Future) -> None:
        if out.is_ready:
            return
        if x.is_error:
            try:
                x.get()
            except BaseException as e:
                out._set_error(e)
        else:
            out._set(x.get())

    def on_t(_: Future) -> None:
        if not out.is_ready:
            out._set(timeout_value)

    f.on_ready(on_f)
    t.on_ready(on_t)
    return out


def success_of(f: Future) -> Future:
    """Discards the value (flow: success)."""
    out = Future()

    def one(x: Future) -> None:
        if x.is_error:
            try:
                x.get()
            except BaseException as e:
                out._set_error(e)
        else:
            out._set(None)

    f.on_ready(one)
    return out


def ready_or_error(f: Future) -> Future:
    """Resolves (None) when f is ready, swallowing errors (flow: errorOr /
    ready)."""
    out = Future()
    f.on_ready(lambda _: out._set(None))
    return out


class FutureStream(Generic[T]):
    """Receive end of an unbounded ordered stream
    (flow/flow.h NotifiedQueue)."""

    def __init__(self) -> None:
        self._queue: Deque[T] = deque()
        self._waiter: Optional[Future] = None
        self._closed: Optional[BaseException] = None

    def pop(self) -> Future:
        """Future of the next element."""
        f = Future()
        if self._queue:
            f._set(self._queue.popleft())
        elif self._closed is not None:
            f._set_error(self._closed)
        else:
            assert self._waiter is None or self._waiter.is_ready, (
                "one consumer at a time"
            )
            self._waiter = f
        return f

    @property
    def size(self) -> int:
        return len(self._queue)

    def is_empty(self) -> bool:
        return not self._queue


class PromiseStream(Generic[T]):
    """Send end (flow: PromiseStream<T>)."""

    def __init__(self) -> None:
        self.stream: FutureStream[T] = FutureStream()

    def send(self, value: T) -> None:
        s = self.stream
        if s._waiter is not None and not s._waiter.is_ready:
            w, s._waiter = s._waiter, None
            w._set(value)
        else:
            s._queue.append(value)

    def send_error(self, err: BaseException) -> None:
        s = self.stream
        s._closed = err
        if s._waiter is not None and not s._waiter.is_ready:
            w, s._waiter = s._waiter, None
            w._set_error(err)

    def close(self) -> None:
        self.send_error(error.end_of_stream())


class AsyncVar(Generic[T]):
    """A variable whose changes can be awaited (flow: AsyncVar<T>)."""

    def __init__(self, value: T = None):
        self._value = value
        self._change = Future()

    def get(self) -> T:
        return self._value

    def on_change(self) -> Future:
        return self._change

    def set(self, value: T) -> None:
        if value == self._value:
            return
        self._value = value
        old, self._change = self._change, Future()
        old._set(value)


class AsyncTrigger:
    """Edge trigger (flow: AsyncTrigger)."""

    def __init__(self) -> None:
        self._f = Future()

    def on_trigger(self) -> Future:
        return self._f

    def trigger(self) -> None:
        old, self._f = self._f, Future()
        old._set(None)


class NotifiedVersion:
    """Monotone value with whenAtLeast waits — the version-chaining primitive
    (reference: NotifiedVersion flow/Notified.h; used at Resolver.actor.cpp:110
    and throughout the TLog)."""

    def __init__(self, value: int = 0):
        self._value = value
        self._waiters: List = []  # heap of (threshold, seq, Future)
        self._seq = 0

    def get(self) -> int:
        return self._value

    def when_at_least(self, threshold: int) -> Future:
        if self._value >= threshold:
            f = Future()
            f._set(None)
            return f
        f = Future()
        self._seq += 1
        heapq.heappush(self._waiters, (threshold, self._seq, f))
        return f

    def set(self, value: int) -> None:
        """Fires satisfied waiters in ascending threshold order (the
        reference's priority queue, flow/Notified.h)."""
        assert value >= self._value, "NotifiedVersion may not go backwards"
        self._value = value
        while self._waiters and self._waiters[0][0] <= value:
            _, _, f = heapq.heappop(self._waiters)
            f._set(None)

    def advance(self, value: int) -> None:
        """set(max(current, value)) — for pipelines where stages may complete
        out of order but the token only gates 'at least this far'."""
        if value > self._value:
            self.set(value)


class ActorCollection:
    """Holds tasks; errors from any of them surface on `error_future`
    (reference: flow/ActorCollection.actor.cpp)."""

    def __init__(self) -> None:
        self._tasks: dict[int, Task] = {}
        self.error_future = Future()

    def add(self, task: Task) -> Task:
        self._tasks[id(task)] = task

        def done(f: Future) -> None:
            # Self-clean like the reference collection, so per-request
            # handler tasks don't accumulate over a long simulation.
            self._tasks.pop(id(task), None)
            if f.is_error and not self.error_future.is_ready:
                try:
                    f.get()
                except BaseException as e:
                    self.error_future._set_error(e)

        task.on_ready(done)
        return task

    def cancel_all(self) -> None:
        tasks, self._tasks = list(self._tasks.values()), {}
        for t in tasks:
            t.cancel()

    def __len__(self) -> int:
        return len(self._tasks)


async def recurring(fn: Callable[[], None], interval: float, priority: int = TaskPriority.DEFAULT_DELAY):
    """Call fn every `interval` seconds forever (flow: recurring)."""
    while True:
        await delay(interval, priority)
        fn()


class AsyncMutex:
    """FIFO mutex for actors (flow: FlowLock with capacity 1): serializes
    critical sections that span awaits, e.g. a durable file's
    write-then-sync cycle against a concurrent compaction."""

    def __init__(self) -> None:
        self._locked = False
        self._waiters: Deque[Promise] = deque()

    async def __aenter__(self) -> "AsyncMutex":
        if self._locked:
            p = Promise()
            self._waiters.append(p)
            await p.future
        self._locked = True
        return self

    async def __aexit__(self, *exc) -> bool:
        self._locked = False
        while self._waiters:
            p = self._waiters.popleft()
            if not p.is_set:
                p.send(None)
                break
        return False
