"""ResolverPipeline: several resolver batches in flight on one engine.

Port of ``foundationdb_tpu/pipeline/resolver_pipeline.py`` (PendingResolve,
_Immediate, ResolverPipeline) without spans, without the BudgetBatcher and
without the conflict scheduler. The serial resolve() path makes the host
wait on every batch: pack, run the device program, wait for the verdicts,
repeat — the card idles while the host packs and the host idles while the
card runs. The pipeline overlaps them:

  * submit() packs a batch on the host (inline, or on an executor thread)
    while the PREVIOUS batch's programs are still running on the card, then
    dispatches it without waiting;
  * at most `depth` dispatched batches stay unforced; submit() forces the
    oldest beyond that, so the window also bounds host memory;
  * results are forced strictly in submission (= commit-version) order, so
    abort sets equal the serial path's: the programs run in the same order
    on the one stream either way, only the host's waiting points move.

Depth 1 is the serial path (each batch is forced before the next is
packed). Engines without the columnar pack/dispatch split (the oracle)
resolve synchronously per batch; the pipeline still keeps the order.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence

from ..core.types import TransactionCommitResult, Version

#: submit-side states of a PendingResolve
_PACKING, _DISPATCHED, _DONE = 0, 1, 2


class PendingResolve:
    """Handle for one submitted batch; result() forces it (and every
    earlier in-flight batch first — commit-version order)."""

    __slots__ = ("pipeline", "version", "n_txns", "_state", "_pack",
                 "_force", "_result", "_error", "_txns")

    def __init__(self, pipeline: "ResolverPipeline", version: Version, n_txns: int):
        self.pipeline = pipeline
        self.version = version
        self.n_txns = n_txns
        self._state = _PACKING
        self._pack = None          # future/immediate of columnar_pack's plan
        self._force = None         # engine.columnar_dispatch force fn
        self._result: Optional[List[TransactionCommitResult]] = None
        self._error: Optional[BaseException] = None
        self._txns = None

    @property
    def is_done(self) -> bool:
        return self._state == _DONE

    def result(self) -> List[TransactionCommitResult]:
        self.pipeline._force_through(self)
        if self._error is not None:
            raise self._error
        return self._result


class _Immediate:
    """Executor-future shim for inline packing."""

    __slots__ = ("_value", "_exc")

    def __init__(self, fn, *args):
        self._value = None
        self._exc = None
        try:
            self._value = fn(*args)
        except BaseException as e:   # re-raised at dispatch, like a Future
            self._exc = e

    def result(self):
        if self._exc is not None:
            raise self._exc
        return self._value


class ResolverPipeline:
    """Single-producer pipeline over one conflict engine.

    `depth`    — max dispatched-but-unforced batches in flight (>= 1).
    `executor` — optional concurrent.futures.Executor; when given, the
                 host pack of batch i+1 runs on it while the main thread
                 returns from submit() and the card runs batch i.
    `batcher`, `conflict_sched` — accepted for the JAX package's signature;
                 only None is supported (the BudgetBatcher and the
                 conflict scheduler are not ported yet).
    """

    def __init__(self, engine, depth: int = 2, executor=None, batcher=None,
                 conflict_sched=None):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        if batcher is not None or conflict_sched is not None:
            raise NotImplementedError(
                "the BudgetBatcher and the conflict scheduler are not ported to "
                "foundationdb_tpu_torch yet; pass batcher=None, conflict_sched=None")
        self.engine = engine
        self.depth = depth
        self._executor = executor
        #: batches in submission order, any mix of states; DONE batches are
        #: popped from the left as the window advances
        self._queue: deque = deque()
        self._can_overlap = hasattr(engine, "columnar_pack")

    @property
    def in_flight(self) -> int:
        return sum(1 for pb in self._queue if not pb.is_done)

    def submit(self, transactions: Sequence, now: Version,
               new_oldest: Version) -> PendingResolve:
        """Accept one batch at commit version `now`. Batches MUST be
        submitted in ascending version order (the resolver's version chain
        guarantees it)."""
        # 1. Dispatch every earlier batch first: packing reads the engine's
        #    base/oldest bookkeeping, which the earlier dispatch advances.
        self._dispatch_pending()
        # 2. Window backpressure: force the oldest beyond depth-1 so this
        #    batch's dispatch keeps at most `depth` unforced.
        while self.in_flight >= self.depth:
            self._force_oldest()
        pb = PendingResolve(self, now, len(transactions))
        if not self._can_overlap:
            # Opaque engine: synchronous resolve, still in version order.
            try:
                pb._result = self.engine.resolve(transactions, now, new_oldest)
            except BaseException as e:
                pb._error = e
            pb._state = _DONE
            self._queue.append(pb)
            return pb
        txns = list(transactions)
        if self._executor is not None:
            pb._pack = self._executor.submit(self.engine.columnar_pack, txns, now, new_oldest)
        else:
            pb._pack = _Immediate(self.engine.columnar_pack, txns, now, new_oldest)
        # batches the general router takes need the raw transactions
        pb._txns = (txns, now, new_oldest)
        self._queue.append(pb)
        return pb

    def drain(self) -> None:
        """Force everything in flight (e.g. before an engine clear())."""
        while self._queue:
            self._force_oldest()

    # -- internals ----------------------------------------------------------
    def _dispatch_pending(self) -> None:
        for pb in self._queue:
            if pb._state == _PACKING:
                self._dispatch(pb)

    def _dispatch(self, pb: PendingResolve) -> None:
        try:
            plan = pb._pack.result()
        except BaseException as e:
            pb._error = e
            pb._state = _DONE
            return
        pb._pack = None
        if plan is None:
            # Range rows / long keys: the general router is synchronous and
            # may couple with the host long-key tier — force everything
            # earlier, then resolve inline.
            for other in self._queue:
                if other is pb:
                    break
                self._force(other)
            txns, now, new_oldest = pb._txns
            try:
                pb._result = self.engine.resolve(txns, now, new_oldest)
            except BaseException as e:
                pb._error = e
            pb._state = _DONE
            return
        pb._force = self.engine.columnar_dispatch(plan)
        pb._state = _DISPATCHED

    def _force(self, pb: PendingResolve) -> None:
        if pb._state == _PACKING:
            self._dispatch(pb)
        if pb._state == _DISPATCHED:
            try:
                pb._result = pb._force()
            except BaseException as e:
                pb._error = e
            pb._force = None
            pb._state = _DONE

    def _force_oldest(self) -> None:
        while self._queue and self._queue[0].is_done:
            self._queue.popleft()
        if self._queue:
            self._force(self._queue[0])

    def _force_through(self, pb: PendingResolve) -> None:
        """Force pb and everything submitted before it, in order."""
        while not pb.is_done:
            # also drops already-done heads
            self._force_oldest()
        while self._queue and self._queue[0].is_done:
            self._queue.popleft()
