"""Cross-process trace reconstruction, tail sampling and Chrome export.

Port of ``foundationdb_tpu/tools/trace_export.py``.

The per-process halves of a distributed trace (core/trace.py): each
process keeps a bounded span ring and serves it on the `trace.spans` RPC
token (real/demo_server.py, real/nemesis.ChaosCommitServer). This module
is the consumer side — `tools/cli.py trace`, the chaos campaign's export
hook (real/nemesis.py) and `make trace-smoke` all drive it:

  * `build_waterfalls` joins a merged span set into per-request commit
    waterfalls: the client's `client.commit` span (trace id = request id),
    the serving process's `server.commit` span (same trace id, carrying
    the resolved commit VERSION as the link detail), and the batch-level
    resolve span keyed by that version (core/trace.py's convention: batch
    trace ids ARE commit versions). Segments telescope — request_net,
    server_queue_wait, server_resolve, server_reply, reply_net — so they
    SUM to the client-observed latency exactly, with residuals named
    (request_net/reply_net/server_reply are genuine network/marshalling/
    promise-delivery shares). A request that never produced a server span
    (partitioned/dropped before arrival) reconstructs honestly as a
    single named `client_unreached` residual and is flagged incomplete.
  * `tail_sample` is the knob-driven retention policy: every waterfall
    with an error (faulted verdicts, throttles, transport failures —
    including retried requests, whose spans share one trace id) is always
    kept; clean acks keep only the slowest `trace_tail_latency_frac`
    (the p99 candidates); `trace_tail_max_traces` bounds the export with
    error traces taking precedence.
  * `chrome_trace` renders spans + injected-fault windows as Chrome
    trace-event JSON (chrome://tracing, Perfetto): one pid per recording
    process, nemesis windows on their own pid, `validate_chrome_trace`
    is the load-time schema check CI runs on every export.

Clock note: cross-process timestamps are comparable because
time.perf_counter()/time.monotonic() both read CLOCK_MONOTONIC on Linux;
single-machine clusters only (core/trace.py's clock note).
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.knobs import SERVER_KNOBS

#: RPC token every traced process serves its span ring on — defined next
#: to the ring itself (core/trace.py), re-exported here for the fetch side
from ..core.trace import SPANS_TOKEN  # noqa: F401  (public re-export)

#: span names of the per-request halves (the campaign/smoke submit path
#: and ChaosCommitServer._commit emit these; demo_server ops emit
#: server.demo.* which only ride the timeline, not waterfalls)
CLIENT_SPAN = "client.commit"
SERVER_SPAN = "server.commit"
#: batch-level resolve span, keyed by commit version
RESOLVE_SPAN = "chaos.resolve"

#: error names that are verdict-bearing acks — their waterfalls MUST be
#: complete (the request reached the resolver); transport-level errors
#: legitimately reconstruct as client-only residuals
ACK_ERRORS = ("not_committed", "transaction_too_old")


def build_waterfalls(spans: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Join span records (possibly fetched from several processes) into
    per-request waterfalls, slowest first. Each waterfall's segments sum
    to the client-observed latency by construction; `complete` means the
    server half joined (and, when the commit version resolved, the batch
    resolve span decomposed the server interval)."""
    client: Dict[Any, Dict] = {}
    server: Dict[Any, Dict] = {}
    resolve_by_version: Dict[Any, Dict] = {}
    for s in spans:
        name = s.get("Name")
        if name == CLIENT_SPAN:
            client[s.get("Trace")] = s
        elif name == SERVER_SPAN:
            server[s.get("Trace")] = s
        elif name == RESOLVE_SPAN:
            resolve_by_version[s.get("Trace")] = s
    out: List[Dict[str, Any]] = []
    for rid, cs in client.items():
        client_ms = (cs["End"] - cs["Begin"]) * 1e3
        ss = server.get(rid)
        w: Dict[str, Any] = {
            "rid": rid,
            "client_ms": round(client_ms, 4),
            "err": cs.get("err"),
            "ok": cs.get("err") is None,
            "version": cs.get("version"),
            "proc_client": cs.get("Proc"),
            "proc_server": ss.get("Proc") if ss is not None else None,
            "complete": ss is not None,
        }
        seg: Dict[str, float] = {}
        if ss is None:
            # never reached the serving process: the whole interval is one
            # named residual (partition/drop/reset before arrival)
            seg["client_unreached"] = client_ms
        else:
            if w["version"] is None:
                w["version"] = ss.get("version")
            seg["request_net"] = (ss["Begin"] - cs["Begin"]) * 1e3
            rs = resolve_by_version.get(ss.get("version"))
            if rs is not None:
                seg["server_queue_wait"] = (rs["Begin"] - ss["Begin"]) * 1e3
                seg["server_resolve"] = (rs["End"] - rs["Begin"]) * 1e3
                seg["server_reply"] = (ss["End"] - rs["End"]) * 1e3
            else:
                # no batch span (throttled before batching, or the ring
                # aged it out): the server interval is one named segment
                seg["server_commit"] = (ss["End"] - ss["Begin"]) * 1e3
            seg["reply_net"] = (cs["End"] - ss["End"]) * 1e3
        w["segments_ms"] = {k: round(v, 4) for k, v in seg.items()}
        w["sum_ms"] = round(sum(seg.values()), 4)
        w["dominant_segment"] = max(seg, key=lambda k: seg[k])
        out.append(w)
    out.sort(key=lambda w: -w["client_ms"])
    return out


def tail_sample(waterfalls: Sequence[Dict[str, Any]],
                latency_frac: Optional[float] = None,
                max_traces: Optional[int] = None) -> List[Dict[str, Any]]:
    """Tail-based retention over reconstructed waterfalls (module
    docstring). Returns the retained set, slowest first within each
    class, error traces first under the cap."""
    if latency_frac is None:
        latency_frac = float(SERVER_KNOBS.trace_tail_latency_frac)
    if max_traces is None:
        max_traces = int(SERVER_KNOBS.trace_tail_max_traces)
    forced = [w for w in waterfalls if w["err"] is not None]
    clean = sorted((w for w in waterfalls if w["err"] is None),
                   key=lambda w: -w["client_ms"])
    n_candidates = max(1, int(len(clean) * latency_frac)) if clean else 0
    retained = forced + clean[:n_candidates]
    retained.sort(key=lambda w: (w["err"] is None, -w["client_ms"]))
    return retained[:max(1, max_traces)]


def trace_summary(waterfalls: Sequence[Dict[str, Any]],
                  retained: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The campaign report's trace section: population counts plus the
    completeness contract — every RETAINED verdict-bearing ack (committed,
    not_committed, too_old — i.e. the request reached the resolver) must
    have a complete waterfall; only transport-failed requests may be
    client-only."""
    ack = [w for w in retained if w["ok"] or w["err"] in ACK_ERRORS]
    return {
        "n_waterfalls": len(waterfalls),
        "n_complete": sum(1 for w in waterfalls if w["complete"]),
        "retained": len(retained),
        "retained_errors": sum(1 for w in retained if w["err"] is not None),
        "retained_acks": len(ack),
        "retained_ack_incomplete": sum(1 for w in ack if not w["complete"]),
        # the sum identity, asserted: segments telescope onto the client
        # interval, so any residual error is rounding (clock-consistency
        # canary across processes)
        "max_sum_err_ms": round(max(
            (abs(w["sum_ms"] - w["client_ms"]) for w in retained),
            default=0.0), 4),
        "worst": [
            {k: w[k] for k in ("rid", "version", "client_ms", "err",
                               "dominant_segment")}
            for w in sorted(retained, key=lambda w: -w["client_ms"])[:3]
        ],
    }


def root_cause(retained: Sequence[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Name the dominant segment of the worst retained trace — what an SLO
    breach report leads with (real/nemesis.assert_slos). Verdict-bearing
    acks take precedence: the p99 SLO is computed over acks, so the worst
    ACK waterfall is the breach's explanation; transport-failed traces
    (client_unreached) only lead when no ack was retained at all."""
    if not retained:
        return None
    acks = [w for w in retained if w["ok"] or w["err"] in ACK_ERRORS]
    worst = max(acks or retained, key=lambda w: w["client_ms"])
    seg = worst["segments_ms"]
    dom = worst["dominant_segment"]
    return {
        "rid": worst["rid"],
        "version": worst["version"],
        "err": worst["err"],
        "client_ms": worst["client_ms"],
        "dominant_segment": dom,
        "dominant_ms": seg.get(dom),
        "segments_ms": dict(seg),
    }


def spans_for_traces(spans: Sequence[Dict[str, Any]],
                     retained: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The tail-sampled span set for export: every span of a retained
    request's trace id, plus the batch spans of the versions those
    requests resolved at (queue_wait/resolve ride along)."""
    keep = set()
    for w in retained:
        keep.add(w["rid"])
        if w["version"] is not None:
            keep.add(w["version"])
    return [s for s in spans if s.get("Trace") in keep]


def _tid_of(trace_id: Any) -> int:
    """Deterministic small tid per trace id (hash() is seed-randomized)."""
    return zlib.crc32(str(trace_id).encode()) % 997 + 1


def _window_track(kind: str) -> str:
    """Which timeline pid a kinded window renders on: nemesis faults,
    reshard handoff arcs and watchdog incidents each get their OWN track,
    so one trace shows faults, incidents and reshards together."""
    if kind.startswith("reshard"):
        return "reshard"
    if kind in ("incident", "alert"):
        return "watchdog"
    return "nemesis"


def chrome_trace(spans: Sequence[Dict[str, Any]],
                 windows: Sequence[Dict[str, Any]] = ()) -> Dict[str, Any]:
    """Render spans + kinded windows as a Chrome trace-event JSON
    document (the `traceEvents` array format chrome://tracing/Perfetto
    load). One pid per recording process ("Proc"); windows land on their
    own per-family pids — injected faults on `nemesis`, reshard
    warm/blackout/arc windows on `reshard`, watchdog incident envelopes
    on `watchdog` — so faults, incidents and reshards share one
    timeline with the commits they disturbed."""
    events: List[Dict[str, Any]] = []
    pid_of: Dict[str, int] = {}

    def pid(proc: str) -> int:
        p = pid_of.get(proc)
        if p is None:
            p = pid_of[proc] = len(pid_of) + 1
            events.append({"name": "process_name", "ph": "M", "pid": p,
                           "tid": 0, "args": {"name": proc}})
        return p

    t0s = [s["Begin"] for s in spans] + [w["t0"] for w in windows]
    base = min(t0s) if t0s else 0.0
    for s in spans:
        args = {k: v for k, v in s.items()
                if k not in ("Name", "Begin", "End", "Proc")}
        proc = s.get("Proc") or "proc"
        if s.get("track") == "device":
            # sampled measured device intervals (ops/host_engine.py's
            # `engine.device_time` spans) render on their own device
            # track next to the process's host spans, so the enqueue->
            # ready interval reads against the host-side segments it
            # overlaps (docs/observability.md "Performance observatory")
            proc = f"{proc} [device]"
        events.append({
            "name": s["Name"], "cat": "span", "ph": "X",
            "ts": round((s["Begin"] - base) * 1e6, 1),
            "dur": round(max(s["End"] - s["Begin"], 0.0) * 1e6, 1),
            "pid": pid(proc),
            "tid": _tid_of(s.get("Trace")),
            "args": args,
        })
    for w in windows:
        kind = w.get("kind", "fault")
        events.append({
            "name": kind, "cat": "chaos", "ph": "X",
            "ts": round((w["t0"] - base) * 1e6, 1),
            "dur": round(max(w.get("t1", w["t0"]) - w["t0"], 0.0) * 1e6, 1),
            "pid": pid(_window_track(kind)), "tid": 1,
            "args": {k: v for k, v in w.items()
                     if k not in ("kind", "t0", "t1")},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(doc: Any) -> int:
    """Schema check for an exported document (CI loads every export back
    through this): returns the number of duration events, raises
    ValueError on any malformed record."""
    if not isinstance(doc, dict):
        raise ValueError("chrome trace: document must be an object")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("chrome trace: traceEvents must be an array")
    n_x = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"chrome trace: event {i} is not an object")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"chrome trace: event {i} lacks a name")
        ph = ev.get("ph")
        if ph not in ("X", "M", "I", "B", "E"):
            raise ValueError(f"chrome trace: event {i} bad phase {ph!r}")
        if not isinstance(ev.get("pid"), int):
            raise ValueError(f"chrome trace: event {i} lacks an int pid")
        if ph == "X":
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"chrome trace: event {i} lacks ts")
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"chrome trace: event {i} bad dur {dur!r}")
            n_x += 1
    return n_x


async def fetch_spans(addrs: Sequence[str],
                      timeout: float = 3.0) -> List[Dict[str, Any]]:
    """Pull the span ring of every address over the `trace.spans` token
    and merge, stamping each record's Proc from the serving process's
    self-reported name (falling back to the address)."""
    from ..real.transport import RealNetwork
    from ..sim.network import Endpoint

    net = RealNetwork(name="trace-fetch")
    merged: List[Dict[str, Any]] = []
    try:
        for addr in addrs:
            ring = await net.request("trace", Endpoint(addr, SPANS_TOKEN),
                                     None, timeout=timeout)
            proc = ring.get("proc") or addr
            for s in ring.get("spans", []):
                s.setdefault("Proc", proc)
                merged.append(s)
    finally:
        net.close()
    return merged
