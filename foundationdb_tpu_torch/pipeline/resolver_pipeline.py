"""ResolverPipeline: several resolver batches in flight on one engine.

Port of ``foundationdb_tpu/pipeline/resolver_pipeline.py``: the
BudgetBatcher, PendingResolve, _Immediate and ResolverPipeline, with its
`pipeline.force` span, budget-driven batch sizing and conflict-scheduler
feedback. The serial resolve() path makes the host wait on every batch:
pack, run the device program, wait for the verdicts, repeat — the card
idles while the host packs and the host idles while the card runs. The
pipeline overlaps them:

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

import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.trace import g_spans, span_event, span_now
from ..core.types import TransactionCommitResult, Version

#: submit-side states of a PendingResolve
_PACKING, _DISPATCHED, _DONE = 0, 1, 2


class BudgetBatcher:
    """Budget-driven batch sizing over a bucketed kernel ladder.

    Replaces the static production-point choice (a batch size picked once
    from an offline latency curve) with an adaptive target: an EWMA of the
    OBSERVED per-bucket service latency predicts what a client would see
    with `depth` batches in flight — pack(T) + depth * device(T) — and the
    batcher targets the largest ladder bucket whose prediction fits the
    `resolver_p99_budget_ms` knob. When the engine degrades (serving at
    depth 1) the EWMA balloons and the target degrades toward the smallest
    bucket; a degraded engine is additionally clamped there outright.

    The wall-clock ResolverPipeline feeds it force() wall times; seed_ms
    pre-loads measured device times so the first batches are not sized
    blind.

    EWMAs are keyed per (bucket, history-search mode, dispatch mode): the
    two history search modes have genuinely different device-time floors
    for the same bucket shape, and so do the two DISPATCH paths — step
    dispatch pays a per-batch launch+force round trip the device-resident
    loop does not — so flipping either axis (knob
    change, engine rebuild under a different pick, enabling the device
    loop) must never poison the other key's estimate. `bucket_modes` maps
    each bucket to its engine's resolved search mode
    (RoutedConflictEngineBase.history_search_modes()); unmapped buckets
    default to "fused_sort", the pre-ladder behavior. `dispatch_mode` is
    the engine family's serving path ("step" | "loop" | "mesh"), one
    value per batcher (an engine serves through exactly one at a time) —
    a multi-device mesh batch carries collective time a single-chip step
    never pays, so its estimates file under their own key too."""

    def __init__(self, ladder: Sequence[int], budget_ms: Optional[float] = None,
                 pack_ms_per_txn: float = 0.0, alpha: Optional[float] = None,
                 seed_ms: Optional[Dict[int, float]] = None,
                 bucket_modes: Optional[Dict[int, str]] = None,
                 dispatch_mode: str = "step"):
        from ..core.knobs import SERVER_KNOBS

        self.ladder = sorted(set(int(t) for t in ladder))
        if not self.ladder:
            raise ValueError("BudgetBatcher needs a non-empty bucket ladder")
        self.budget_ms = (float(SERVER_KNOBS.resolver_p99_budget_ms)
                          if budget_ms is None else float(budget_ms))
        self.pack_ms_per_txn = pack_ms_per_txn
        self.alpha = (float(SERVER_KNOBS.resolver_latency_ewma_alpha)
                      if alpha is None else float(alpha))
        self.bucket_modes: Dict[int, str] = {
            int(t): str(m) for t, m in (bucket_modes or {}).items()}
        self.dispatch_mode = str(dispatch_mode)
        #: (bucket, search mode, dispatch mode) -> EWMA of observed ms
        self.ewma_ms: Dict[Tuple[int, str, str], float] = {
            self.key_of(int(t)): float(v) for t, v in (seed_ms or {}).items()}
        # unified telemetry (core/telemetry.py): the per-bucket EWMAs the
        # whole cluster steers by become persistable TDMetric series
        from ..core import telemetry

        telemetry.hub().register_batcher(self)

    def mode_of(self, bucket: int) -> str:
        """The history-search mode a bucket's observations file under."""
        return self.bucket_modes.get(bucket, "fused_sort")

    def key_of(self, bucket: int, mode: Optional[str] = None) -> tuple:
        """The full EWMA key a bucket's observations file under."""
        return (bucket, mode if mode is not None else self.mode_of(bucket),
                self.dispatch_mode)

    def set_bucket_modes(self, modes: Dict[int, str]) -> None:
        """Adopt an engine's resolved per-bucket modes. A seed recorded
        under a bucket's PREVIOUS mode migrates iff the new mode has no
        estimate of its own — a seed is 'this bucket's best prior', while
        a real observation under the old mode stays where it belongs."""
        for t, m_new in modes.items():
            t = int(t)
            m_old = self.mode_of(t)
            self.bucket_modes[t] = str(m_new)
            old_key, new_key = self.key_of(t, m_old), self.key_of(t, str(m_new))
            if old_key != new_key and old_key in self.ewma_ms \
                    and new_key not in self.ewma_ms:
                self.ewma_ms[new_key] = self.ewma_ms.pop(old_key)

    def set_dispatch_mode(self, dispatch: str) -> None:
        """Adopt an engine family's dispatch path ("step" | "loop" |
        "mesh") —
        mirrors set_bucket_modes: seeds filed under the previous dispatch
        mode migrate iff the new key has no estimate, so enabling the
        device loop starts from the prior without ever overwriting a real
        step-path observation (and vice versa on failover back to step)."""
        old = self.dispatch_mode
        self.dispatch_mode = str(dispatch)
        if old == self.dispatch_mode:
            return
        for (t, m, d), v in list(self.ewma_ms.items()):
            if d != old:
                continue
            new_key = (t, m, self.dispatch_mode)
            if new_key not in self.ewma_ms:
                self.ewma_ms[new_key] = v

    def bucket_of(self, n_txns: int) -> int:
        """Smallest ladder bucket holding an n_txns batch (top if none)."""
        for t in self.ladder:
            if n_txns <= t:
                return t
        return self.ladder[-1]

    def observe(self, bucket: int, service_ms: float,
                mode: Optional[str] = None) -> None:
        key = self.key_of(bucket, mode)
        cur = self.ewma_ms.get(key)
        self.ewma_ms[key] = (service_ms if cur is None
                             else cur + self.alpha * (service_ms - cur))

    def predicted_ms(self, bucket: int, depth: int,
                     mode: Optional[str] = None) -> Optional[float]:
        """Client-visible latency estimate at `depth` in flight: own pack +
        up to `depth` device services ahead of the verdict (the in-order
        device chain). None until the (bucket, mode) has an observation."""
        dev = self.ewma_ms.get(self.key_of(bucket, mode))
        if dev is None:
            return None
        return self.pack_ms_per_txn * bucket + max(1, depth) * dev

    def target_batch_txns(self, depth: int, degraded: bool = False) -> int:
        """The adaptive production point: largest bucket predicted to fit
        the budget. Unobserved buckets don't qualify (never size batches on
        guesses); if nothing fits — or the engine is degraded — the
        smallest bucket wins (minimum service quantum, fastest drain)."""
        if degraded:
            return self.ladder[0]
        best = None
        for t in self.ladder:
            p = self.predicted_ms(t, depth)
            if p is not None and p <= self.budget_ms:
                best = t
        return best if best is not None else self.ladder[0]

    def as_dict(self) -> dict:
        return {
            "ladder": list(self.ladder),
            "budget_ms": self.budget_ms,
            "pack_ms_per_txn": round(self.pack_ms_per_txn, 6),
            "bucket_modes": {str(t): m
                             for t, m in sorted(self.bucket_modes.items())},
            "dispatch_mode": self.dispatch_mode,
            "ewma_ms": {f"{t}:{m}:{d}": round(v, 4)
                        for (t, m, d), v in sorted(self.ewma_ms.items())},
        }


class PendingResolve:
    """Handle for one submitted batch; result() forces it (and every
    earlier in-flight batch first — commit-version order)."""

    __slots__ = ("pipeline", "version", "n_txns", "_state", "_pack",
                 "_force", "_result", "_error", "_txns", "_buckets")

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
        self._buckets = None       # plan chunk buckets (BudgetBatcher feed)

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
    `batcher`  — optional BudgetBatcher fed each forced batch's wall time.
    `transport_degraded_fn` — optional transport-health probe; while it
                 reports True the pipeline collapses to depth 1.
    `conflict_sched` — optional ConflictScheduler (pipeline/scheduler.py)
                 trained on each forced batch's verdicts.
    """

    def __init__(self, engine, depth: int = 2, executor=None,
                 batcher: Optional[BudgetBatcher] = None,
                 transport_degraded_fn=None, conflict_sched=None):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.engine = engine
        self.depth = depth
        #: optional ConflictScheduler (pipeline/scheduler.py) to train on
        #: every forced batch's verdicts: the wall-clock pipeline is the
        #: resolution point, so its feedback keeps the admission-side doom
        #: model current whichever layer did the scheduling
        self.conflict_sched = conflict_sched
        #: optional transport-health probe (RealNetwork.transport_degraded):
        #: while it reports True the pipeline collapses to depth 1, exactly
        #: as it does for a degraded ResilientEngine — keeping batches in
        #: flight across a flapping link only multiplies the replay/requeue
        #: work when it resets
        self._transport_degraded_fn = transport_degraded_fn
        self._executor = executor
        #: batches in submission order, any mix of states; DONE batches are
        #: popped from the left as the window advances
        self._queue: deque = deque()
        self._can_overlap = hasattr(engine, "columnar_pack")
        #: budget-driven batch sizing: when set, force() wall times feed the
        #: per-(bucket, mode) EWMA and suggested_batch_txns() tracks the
        #: largest in-budget bucket (callers size their submissions to it)
        self.batcher = batcher
        if batcher is not None and hasattr(engine, "history_search_modes"):
            # the engine is the authority on which history-search mode each
            # bucket's compiled program traces; observations file under it
            batcher.set_bucket_modes(engine.history_search_modes())
        if batcher is not None:
            # likewise for the dispatch path (step vs device loop): keyed
            # so enabling the loop never poisons the step path's estimates
            batcher.set_dispatch_mode(getattr(engine, "dispatch_mode", "step"))

    @property
    def degraded(self) -> bool:
        """Engine-degraded OR transport-degraded: either collapses depth."""
        if getattr(self.engine, "degraded", False):
            return True
        fn = self._transport_degraded_fn
        return bool(fn()) if fn is not None else False

    @property
    def effective_depth(self) -> int:
        """`depth` while healthy; 1 while the engine or the transport is
        degraded (mirrors pipeline/service.py's engine-side collapse)."""
        return 1 if self.degraded else self.depth

    def suggested_batch_txns(self) -> Optional[int]:
        if self.batcher is None:
            return None
        return self.batcher.target_batch_txns(
            self.effective_depth, degraded=self.degraded)

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
        #    batch's dispatch keeps at most `effective_depth` unforced
        #    (1 while the engine or transport is degraded).
        while self.in_flight >= self.effective_depth:
            self._force_oldest()
        pb = PendingResolve(self, now, len(transactions))
        txns = list(transactions)
        if not self._can_overlap:
            # Opaque engine: synchronous resolve, still in version order.
            try:
                pb._result = self.engine.resolve(transactions, now, new_oldest)
            except BaseException as e:
                pb._error = e
            pb._state = _DONE
            self._observe(pb, txns)
            self._queue.append(pb)
            return pb
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
            self._observe(pb, txns)
            return
        pb._force = self.engine.columnar_dispatch(plan)
        pb._buckets = plan.get("chunk_buckets")
        pb._state = _DISPATCHED

    def _force(self, pb: PendingResolve) -> None:
        if pb._state == _PACKING:
            self._dispatch(pb)
        if pb._state == _DISPATCHED:
            t0 = time.perf_counter() if self.batcher is not None else 0.0
            t_span = span_now() if g_spans.enabled else 0.0
            try:
                pb._result = pb._force()
            except BaseException as e:
                pb._error = e
            else:
                if self.batcher is not None and pb._buckets:
                    # observed service time split across the batch's chunks
                    # pro-rata by bucket size (device time scales with T):
                    # a flat mean would charge a small-bucket tail chunk a
                    # big chunk's cost and vice versa, skewing the EWMA the
                    # budget target is computed from
                    wall = (time.perf_counter() - t0) * 1e3
                    total = sum(pb._buckets)
                    for t in pb._buckets:
                        self.batcher.observe(t, wall * t / total)
            if g_spans.enabled:
                # the wall-clock analog of the sim service's force segment:
                # host blocked on the dispatched batch's device values
                span_event("pipeline.force", pb.version, t_span, span_now(),
                           txns=pb.n_txns, parent="resolver.queue_wait")
            pb._force = None
            pb._state = _DONE
            self._observe(pb)

    def _observe(self, pb: PendingResolve, txns=None) -> None:
        """Feed one completed batch's verdicts to the conflict predictor
        (no-op without an enabled scheduler or on an errored batch)."""
        cs = self.conflict_sched
        if cs is None or not cs.enabled or pb._error is not None:
            return
        if txns is None:
            txns = pb._txns[0] if pb._txns is not None else None
        if txns:
            cs.observe_batch(txns, pb._result, pb.version)

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
