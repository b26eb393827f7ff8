"""A standalone KV node over the real transport — the two-OS-process
demo: run one of these per terminal, point a client at it over TCP.

Port of ``foundationdb_tpu/real/demo_server.py``.

    python -m foundationdb_tpu_torch.real.demo_server --port 4500

Serves the storage-interface message types (GetValueRequest /
GetKeyValuesRequest) plus set/clear one-ways, all serialized with the
versioned flat wire format over token-addressed frames. With `--trace`
the process records spans for every op, joined to the caller's
propagated trace context (core/trace.py), and serves its bounded span
ring on the `trace.spans` token — the fetch channel `tools/cli.py trace`
and the cross-process waterfall reconstruction pull
(docs/observability.md "Distributed tracing").
"""
from __future__ import annotations

import argparse
import asyncio
import bisect
from typing import Dict, List

from ..core.trace import (
    SPANS_TOKEN,
    current_trace_context,
    g_spans,
    span_event,
    span_now,
)
from ..server.messages import (
    GetKeyValuesReply,
    GetKeyValuesRequest,
    GetValueReply,
    GetValueRequest,
)
from .transport import RealProcess

SET_TOKEN = "demo.set"
GET_TOKEN = "demo.get"
RANGE_TOKEN = "demo.getRange"
PING_TOKEN = "demo.ping"
METRICS_TOKEN = "demo.metrics"


class DemoKV:
    def __init__(self, proc: RealProcess):
        from ..core import telemetry

        self.proc = proc
        self._d: Dict[bytes, bytes] = {}
        #: per-op counters in the unified telemetry hub's TDMetric registry
        #: — served back as a Prometheus-style text exposition on
        #: METRICS_TOKEN (docs/observability.md), alongside whatever engine
        #: perf / batcher series this process registered
        self._td = telemetry.hub().tdmetrics
        proc.register(GET_TOKEN, self.get)
        proc.register(RANGE_TOKEN, self.get_range)
        proc.register(SET_TOKEN, self.set)
        proc.register(PING_TOKEN, self.ping)
        proc.register(METRICS_TOKEN, self.metrics)
        proc.register(SPANS_TOKEN, self.spans)

    @staticmethod
    def _trace_op(op: str, t0: float) -> None:
        """Record this op's server-side span joined to the caller's
        propagated trace (the transport installed the inbound context);
        a context-less or untraced request records nothing."""
        if not g_spans.enabled:
            return
        ctx = current_trace_context()
        if ctx is None:
            return
        span_event("server." + op, ctx.trace_id, t0, span_now(),
                   parent=ctx.parent)

    async def ping(self, body):
        t0 = span_now() if g_spans.enabled else 0.0
        self._trace_op("demo.ping", t0)
        return body

    async def metrics(self, _body) -> str:
        """Prometheus-style text exposition of this process's telemetry."""
        from ..core import telemetry

        return telemetry.hub().prometheus_text()

    async def spans(self, _body):
        """This process's bounded span ring (core/trace.export_spans)."""
        from ..core import trace

        return trace.export_spans()

    async def set(self, body) -> bool:
        t0 = span_now() if g_spans.enabled else 0.0
        k, v = body
        self._td.int64("demo.sets").increment()
        if v is None:
            self._d.pop(k, None)
        else:
            self._d[k] = v
        self._trace_op("demo.set", t0)
        return True

    async def get(self, req: GetValueRequest) -> GetValueReply:
        t0 = span_now() if g_spans.enabled else 0.0
        self._td.int64("demo.gets").increment()
        reply = GetValueReply(value=self._d.get(req.key))
        self._trace_op("demo.get", t0)
        return reply

    async def get_range(self, req: GetKeyValuesRequest) -> GetKeyValuesReply:
        t0 = span_now() if g_spans.enabled else 0.0
        keys = sorted(self._d)
        lo = bisect.bisect_left(keys, req.begin)
        hi = bisect.bisect_left(keys, req.end)
        rows: List = [(k, self._d[k]) for k in keys[lo:hi]]
        more = len(rows) > req.limit
        self._trace_op("demo.getRange", t0)
        return GetKeyValuesReply(data=rows[: req.limit], more=more)


async def serve(host: str, port: int, trace: bool = False) -> None:
    proc = RealProcess(host, port)
    DemoKV(proc)
    await proc.start()
    if trace:
        from ..core.trace import set_process_name, set_span_collection

        set_span_collection(True)
        set_process_name(f"demo:{proc.port}")
    print(f"listening on {proc.address}", flush=True)
    while True:
        await asyncio.sleep(3600)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--trace", action="store_true",
                    help="record spans (joined to propagated trace "
                         "contexts) and serve the ring on trace.spans")
    args = ap.parse_args(argv)
    try:
        asyncio.run(serve(args.host, args.port, trace=args.trace))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
