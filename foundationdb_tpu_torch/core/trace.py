"""Structured event tracing.

Port of ``foundationdb_tpu/core/trace.py``: events, spans, the span
collector and the distributed trace context. `span_now()` keeps the
simulator hook of the JAX package, but the port has no simulator yet, so
it reads the wall clock (`time.perf_counter()`).

Analog of the reference's TraceEvent system (flow/Trace.h, flow/Trace.cpp):
structured events with typed details, severity gating, and machine-readable
output (we use JSON lines rather than the reference's XML). SevError events
fail simulation tests, like the reference harness.
"""
from __future__ import annotations

import contextvars
import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class Severity:
    DEBUG = 5
    INFO = 10
    WARN = 20
    WARN_ALWAYS = 30
    ERROR = 40


class TraceCollector:
    """Collects trace events; in simulation, registered observers (e.g. the
    test harness's SevError watchdog) see every event."""

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []
        self.observers: List[Callable[[Dict[str, Any]], None]] = []
        self.min_severity = Severity.INFO
        self.file = None
        self.buffer_limit = 100_000
        #: observer callbacks that raised (isolated, never re-raised into
        #: the emitting role — telemetry must not take down the commit path)
        self.observer_errors = 0
        self._lock = threading.Lock()

    def emit(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self.events.append(event)
            if len(self.events) > self.buffer_limit:
                del self.events[: self.buffer_limit // 2]
            if self.file is not None:
                try:
                    self.file.write(json.dumps(event, default=str) + "\n")
                    if event.get("Severity", 0) >= Severity.ERROR:
                        # a SevError may be the last thing this process logs:
                        # make sure it reaches the sink before anything dies
                        self.file.flush()
                except (OSError, ValueError):
                    pass
        for obs in list(self.observers):
            # One raising observer must neither break event emission nor
            # starve observers registered after it (the harness's SevError
            # watchdog must see the event even if a metrics bridge raised).
            try:
                obs(event)
            except Exception:
                self.observer_errors += 1

    def clear(self) -> None:
        with self._lock:
            self.events.clear()

    def close(self) -> None:
        """Flush and detach the JSON-lines file sink (events keep
        accumulating in memory)."""
        with self._lock:
            if self.file is not None:
                try:
                    self.file.flush()
                except (OSError, ValueError):
                    pass
                self.file = None

    def find(self, event_type: str) -> List[Dict[str, Any]]:
        with self._lock:
            return [e for e in self.events if e.get("Type") == event_type]


g_trace = TraceCollector()

#: Virtual-time source, installed by the simulator so events carry sim time.
_now: Callable[[], float] = time.monotonic  # wall-mode default; set_time_source() installs a virtual clock


def set_time_source(now: Callable[[], float]) -> None:
    global _now
    _now = now


class TraceEvent:
    """`TraceEvent("Type", id).detail("K", v)...` — logs on destruction or
    explicit .log(), mirroring the reference's builder idiom."""

    def __init__(self, event_type: str, id: Any = None, severity: int = Severity.INFO):
        self._event: Dict[str, Any] = {
            "Severity": severity,
            "Time": round(_now(), 6),
            "Type": event_type,
        }
        if id is not None:
            self._event["ID"] = id
        self._logged = False

    def detail(self, key: str, value: Any) -> "TraceEvent":
        self._event[key] = value
        return self

    def error(self, err: BaseException) -> "TraceEvent":
        self._event["Error"] = str(err)
        if self._event["Severity"] < Severity.WARN:
            self._event["Severity"] = Severity.WARN
        return self

    def log(self) -> None:
        if self._logged:
            return
        self._logged = True
        if self._event["Severity"] >= g_trace.min_severity:
            g_trace.emit(self._event)

    def __del__(self) -> None:
        try:
            self.log()
        except Exception:
            pass

    def __enter__(self) -> "TraceEvent":
        return self

    def __exit__(self, *exc) -> None:
        self.log()


# -- spans -------------------------------------------------------------------
#
# Lightweight latency spans for the commit path (docs/observability.md): a
# span is a named [t0, t1) segment tied to a trace id (the commit version of
# the batch it belongs to), emitted by the proxy's commit phases, the
# resolver's queue/service stages and the engine's pack/force halves, so a
# client-observed commit latency decomposes into named phase segments
# (bench.py `latency_attribution`). Sim-time and wall-time aware: span_now()
# reads the active deterministic scheduler's virtual clock when one is
# installed and the wall clock otherwise, so the same instrumentation serves
# the sim harness and the wall-clock ResolverPipeline.
#
# Cost discipline: collection is OFF unless the `trace_span_sample_rate`
# knob (core/knobs.py) or a harness enables it; disabled call sites pay one
# attribute check and allocate nothing (span() returns a shared null object
# — tests/test_trace_spans.py pins this).

#: the simulator's loop module (its `_current` scheduler carries the
#: virtual clock). The port has no simulator yet, so this stays None and
#: span_now() reads the wall clock; a ported sim installs its module here.
_loop_mod = None


def span_now() -> float:
    """Virtual time under an active sim scheduler, wall time otherwise."""
    s = _loop_mod._current if _loop_mod is not None else None
    return s.time if s is not None else time.perf_counter()


class SpanCollector:
    """Finished spans, bounded like the event buffer. `enabled` is the one
    fast-path gate every instrumented site checks."""

    def __init__(self) -> None:
        self.enabled = False
        self.spans: List[Dict[str, Any]] = []
        self.buffer_limit = 500_000

    def add(self, span: Dict[str, Any]) -> None:
        self.spans.append(span)
        if len(self.spans) > self.buffer_limit:
            del self.spans[: self.buffer_limit // 2]

    def clear(self) -> None:
        self.spans.clear()

    def by_name(self, name: str) -> List[Dict[str, Any]]:
        return [s for s in self.spans if s["Name"] == name]

    def for_trace(self, trace_id: Any) -> List[Dict[str, Any]]:
        return [s for s in self.spans if s.get("Trace") == trace_id]

    def durations_by_trace(self) -> Dict[Any, Dict[str, float]]:
        """trace id -> {span name: summed duration seconds} (+ `<name>.t0`:
        earliest start), the shape the latency-attribution math consumes."""
        out: Dict[Any, Dict[str, float]] = {}
        for s in self.spans:
            d = out.setdefault(s.get("Trace"), {})
            name = s["Name"]
            d[name] = d.get(name, 0.0) + (s["End"] - s["Begin"])
            k0 = name + ".t0"
            if k0 not in d or s["Begin"] < d[k0]:
                d[k0] = s["Begin"]
        return out


g_spans = SpanCollector()

#: spans allocated since process start — the tracing-disabled regression
#: guard asserts this stays flat across an instrumented run with sampling off
span_allocations = [0]


class Span:
    """One named phase segment. Created at its start; finish() records it.
    Only ever constructed when collection is enabled — disabled sites get
    NULL_SPAN from span() and allocate nothing."""

    __slots__ = ("name", "trace_id", "parent", "t0", "details")

    def __init__(self, name: str, trace_id: Any = None,
                 parent: Optional[str] = None, **details: Any):
        span_allocations[0] += 1
        self.name = name
        self.trace_id = trace_id
        self.parent = parent
        self.t0 = span_now()
        self.details = details or None

    def child(self, name: str, **details: Any) -> "Span":
        return Span(name, trace_id=self.trace_id, parent=self.name, **details)

    def finish(self, **details: Any) -> None:
        rec: Dict[str, Any] = {"Name": self.name, "Trace": self.trace_id,
                               "Begin": self.t0, "End": span_now()}
        if self.parent is not None:
            rec["Parent"] = self.parent
        if self.details:
            rec.update(self.details)
        if details:
            rec.update(details)
        if _process_name[0] and "Proc" not in rec:
            rec["Proc"] = _process_name[0]
        g_spans.add(rec)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class _NullSpan:
    """Shared no-op span for disabled collection: no allocation, no clock
    reads, no record."""

    __slots__ = ()

    def child(self, name: str, **details: Any) -> "_NullSpan":
        return self

    def finish(self, **details: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


def span(name: str, trace_id: Any = None, parent: Optional[str] = None,
         **details: Any):
    """Open a span if collection is enabled, else the shared null span."""
    if not g_spans.enabled:
        return NULL_SPAN
    return Span(name, trace_id=trace_id, parent=parent, **details)


def span_event(name: str, trace_id: Any, t0: float, t1: float,
               parent: Optional[str] = None, **details: Any) -> None:
    """Record a completed span retroactively from explicit timestamps
    (callers that only learn the trace id — e.g. the commit version — after
    the phase ran)."""
    if not g_spans.enabled:
        return
    rec: Dict[str, Any] = {"Name": name, "Trace": trace_id,
                           "Begin": t0, "End": t1}
    if parent is not None:
        rec["Parent"] = parent
    if details:
        rec.update(details)
    if _process_name[0] and "Proc" not in rec:
        rec["Proc"] = _process_name[0]
    g_spans.add(rec)


def spans_enabled() -> bool:
    return g_spans.enabled


def set_span_collection(enabled: bool) -> None:
    g_spans.enabled = bool(enabled)


# -- distributed trace context -----------------------------------------------
#
# Cross-process tracing (docs/observability.md "Distributed tracing"): a
# TraceContext is the tiny propagated half of a span — (trace id, parent
# span name, sampling bit) — that rides RPC frames under the "tc" key
# (real/transport.py attaches the caller's ambient context to every
# request/one-way frame; the serving side installs the inbound context
# around the handler), so spans recorded in different OS processes join
# into one causal tree. Trace ids follow the PR 4 convention: BATCH spans
# use the commit version; per-request client/server spans use a
# process-unique request id (next_trace_id), with the serving side's
# request span carrying the resolved commit version as a detail — the
# link the waterfall reconstruction (tools/trace_export.py) joins on.
#
# Ambient propagation is a contextvars.ContextVar: full task-local
# semantics under plain asyncio (each asyncio task runs in its own
# context copy). Handlers dispatched onto the cooperative scheduler
# (real/runtime.make_dispatcher) are wrapped so the inbound context is
# installed when the handler coroutine starts — but scheduler tasks
# interleave inside ONE asyncio task, so there the context is only
# guaranteed during a handler's SYNCHRONOUS PREFIX: capture it at entry
# (`ctx = current_trace_context()`) before the first await, as
# ChaosCommitServer._commit does.
#
# Cost discipline: context attach/install sites are gated on
# `g_spans.enabled` exactly like span sites — with sampling off, frames
# carry no "tc", nothing is installed, and nothing allocates (the
# allocation-counter regression guard covers the propagation sites too).
#
# Clock note: span timestamps are comparable ACROSS processes on one
# machine because time.perf_counter()/time.monotonic() both read
# CLOCK_MONOTONIC on Linux (shared epoch since boot); cross-machine
# traces would need an offset estimate this repo does not attempt.


@dataclasses.dataclass
class TraceContext:
    """The propagated context: trace id + parent span name + sampling bit.
    A wire-registered record, so it rides RPC frames as a typed,
    schema-evolvable payload (core/wire.py named records)."""

    trace_id: Any = None
    parent: Optional[str] = None
    sampled: bool = True


# registered at import (real/transport.py imports this module before any
# frame is built); core/wire.py also lists this module as a lazy
# registrar so a decode-first process resolves the record too
from . import wire as _wire  # noqa: E402  (leaf module; no import cycle)

_wire.register_record(TraceContext, "TraceContext")

#: this process's identity on span records ("Proc"), set once at startup
#: by wall-clock processes (demo_server --trace, nemesis --serve, smoke
#: drivers); "" (the default) stamps nothing
_process_name: List[str] = [""]


def set_process_name(name: str) -> None:
    _process_name[0] = str(name or "")


def process_name() -> str:
    return _process_name[0]


_trace_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "fdbtpu_trace_context", default=None)


def current_trace_context() -> Optional[TraceContext]:
    """The ambient inbound/outbound context (None when not tracing)."""
    return _trace_ctx.get()


def push_trace_context(ctx: Optional[TraceContext]):
    """Install `ctx` as the ambient context; returns the reset token."""
    return _trace_ctx.set(ctx)


def pop_trace_context(token) -> None:
    _trace_ctx.reset(token)


class use_trace_context:
    """`with use_trace_context(ctx): ...` — scoped ambient context."""

    __slots__ = ("ctx", "_token")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx

    def __enter__(self) -> Optional[TraceContext]:
        self._token = _trace_ctx.set(self.ctx)
        return self.ctx

    def __exit__(self, *exc) -> None:
        _trace_ctx.reset(self._token)


_trace_seq = [0]


def next_trace_id(prefix: str = "r") -> str:
    """Process-unique request trace id (`r<pid-hex>.<seq>`): never collides
    with a commit-version (int) trace id, and two processes' ids never
    collide with each other's."""
    _trace_seq[0] += 1
    return f"{prefix}{os.getpid():x}.{_trace_seq[0]}"


#: the ONE RPC token every traced process serves its span ring on
#: (real/demo_server.py, real/nemesis.ChaosCommitServer register it; the
#: fetch side — tools/trace_export.fetch_spans, `cli trace fetch` — pulls
#: it); lives here, next to the ring it exports, so the runtime layer
#: never imports tools/ for a constant
SPANS_TOKEN = "trace.spans"


def export_spans(limit: int = 100_000) -> Dict[str, Any]:
    """This process's bounded span ring, for the `trace.spans` RPC
    endpoint (real/demo_server.py, real/nemesis.ChaosCommitServer) that
    `tools/cli.py trace fetch` and the campaign reconstruction pull:
    {"proc": <process name>, "spans": [span records]}."""
    spans = g_spans.spans
    if limit and len(spans) > limit:
        spans = spans[-limit:]
    return {"proc": _process_name[0], "spans": list(spans)}


class TraceBatch:
    """Latency micro-probes stitched per debug id across roles
    (reference: g_traceBatch, flow/Trace.h:55-60; used by the commit-path
    probes in Resolver.actor.cpp:84-131)."""

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []

    def add_event(self, name: str, debug_id: int, location: str) -> None:
        self.events.append(
            {"Type": name, "ID": debug_id, "Location": location, "Time": _now()}
        )

    def add_attach(self, name: str, from_id: int, to_id: int) -> None:
        self.events.append({"Type": name, "From": from_id, "To": to_id, "Time": _now()})

    def timeline(self, debug_id: int) -> List[Dict[str, Any]]:
        return [e for e in self.events if e.get("ID") == debug_id]


g_trace_batch = TraceBatch()
