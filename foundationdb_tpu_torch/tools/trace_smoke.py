"""Distributed-tracing smoke: a 2-OS-process cluster proves the tracing.

Port of ``foundationdb_tpu/tools/trace_smoke.py``. Seconds, oracle engine:
it touches no device, and `--device` is taken only so that every smoke
shares one command line:

    python -m foundationdb_tpu_torch.tools.trace_smoke [--device cpu]

  1. The DISABLED-path guard, with context propagation compiled in: a
     burst of RPCs through the full traced transport with span collection
     off must allocate zero spans and attach no context to any frame
     (the allocation-counter guard, extended over the propagation sites).
  2. Boot a traced commit server (real/nemesis.py --serve) as a CHILD OS
     PROCESS, drive a short commit fleet from this process with one
     propagated TraceContext per request, and fetch the child's span ring
     over the `trace.spans` RPC token. The child is killed by its own
     pid, never by a command-line pattern.
  3. Reconstruct cross-process waterfalls (tools/trace_export.py): at
     least one complete waterfall whose client and server spans were
     recorded by DIFFERENT OS processes, every segment non-negative
     (the shared-CLOCK_MONOTONIC consistency canary) and the named
     segments summing to the client-observed latency within tolerance.
  4. Export Chrome trace-event JSON, load it back, schema-check it
     (validate_chrome_trace).

Prints one JSON line; any failed check exits non-zero.
"""
from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import tempfile
import time

from ..core import error
from ..core.trace import (
    TraceContext,
    g_spans,
    next_trace_id,
    pop_trace_context,
    push_trace_context,
    set_process_name,
    span_allocations,
    span_event,
    span_now,
)
from ..sim.network import Endpoint
from . import trace_export

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

N_COMMITS = 240
WORKERS = 4


def _child_argv(port: int):
    code = ("import sys; sys.path.insert(0, %r); "
            "from foundationdb_tpu_torch.real.nemesis import main; "
            "sys.exit(main(['--serve', '%d']))" % (REPO_ROOT, port))
    return [sys.executable, "-c", code]


async def _disabled_path_guard() -> None:
    """Spans OFF: the traced transport must allocate no spans and carry
    no context, even with a context pushed by the caller."""
    from ..real.transport import RealNetwork, RealProcess

    assert not g_spans.enabled
    proc = RealProcess()
    seen = []

    async def ping(body):
        from ..core.trace import current_trace_context

        seen.append(current_trace_context())
        return body

    proc.register("smoke.ping", ping)
    await proc.start()
    net = RealNetwork(name="smoke-disabled")
    before = span_allocations[0]
    before_spans = len(g_spans.spans)
    try:
        ep = Endpoint(proc.address, "smoke.ping")
        for i in range(200):
            tok = push_trace_context(TraceContext(trace_id=next_trace_id()))
            try:
                assert await net.request("smoke", ep, i) == i
            finally:
                pop_trace_context(tok)
    finally:
        net.close()
        await proc.stop()
    assert span_allocations[0] == before, "disabled path allocated spans"
    assert len(g_spans.spans) == before_spans, "disabled path recorded spans"
    assert all(c is None for c in seen), \
        "disabled path leaked a trace context onto the wire"
    print(f"  disabled-path guard: 200 RPCs, 0 span allocations, "
          f"0 contexts on the wire", flush=True)


async def _traced_fleet(port: int):
    """Drive N_COMMITS traced commits at the child and return local acks."""
    from ..real.nemesis import COMMIT_TOKEN, STATUS_TOKEN
    from ..real.transport import RealNetwork

    net = RealNetwork(name="smoke-client")
    commit_ep = Endpoint(f"127.0.0.1:{port}", COMMIT_TOKEN)
    status_ep = Endpoint(f"127.0.0.1:{port}", STATUS_TOKEN)
    # wait for the child to listen
    up = False
    for _ in range(100):
        try:
            await net.request("smoke", status_ep, None, timeout=0.5)
            up = True
            break
        except (error.FDBError, ConnectionError, OSError):
            await asyncio.sleep(0.1)
    assert up, "traced commit server child never came up"
    version = [0]
    n_err = [0]

    async def one(i: int) -> None:
        rid = next_trace_id()
        ctx = TraceContext(trace_id=rid, parent="client.commit")
        tok = push_trace_context(ctx)
        t0 = span_now()
        key = b"smoke/%06d" % (i % 64)
        try:
            v = await net.request(
                "smoke", commit_ep,
                ("smoke", [key], [key], version[0]), timeout=5.0)
        except error.FDBError as e:
            n_err[0] += 1
            span_event("client.commit", rid, t0, span_now(), err=e.name,
                       Proc="smoke-client")
            return
        finally:
            pop_trace_context(tok)
        version[0] = max(version[0], int(v))
        span_event("client.commit", rid, t0, span_now(), version=int(v),
                   Proc="smoke-client")

    try:
        i = 0
        while i < N_COMMITS:
            burst = [one(i + k) for k in range(min(WORKERS, N_COMMITS - i))]
            await asyncio.gather(*burst)
            i += len(burst)
        server_spans = await trace_export.fetch_spans(
            [f"127.0.0.1:{port}"])
    finally:
        net.close()
    return server_spans, n_err[0]


def check_traced_cluster() -> dict:
    """Checks 1-4; raises AssertionError on a miss. Returns the figures."""
    t_start = time.monotonic()
    print("trace-smoke: 2-process distributed-tracing check", flush=True)

    # 1) disabled-path allocation guard (context propagation compiled in)
    g_spans.enabled = False
    asyncio.run(_disabled_path_guard())

    # 2) the 2-OS-process traced cluster
    from ..real.cluster import free_ports

    (port,) = free_ports(1)
    child = subprocess.Popen(_child_argv(port), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
    try:
        g_spans.enabled = True
        g_spans.clear()
        set_process_name("smoke-client")
        server_spans, n_err = asyncio.run(_traced_fleet(port))
    finally:
        g_spans.enabled = False
        child.kill()
        child.wait(timeout=10)
    client_spans = list(g_spans.spans)
    g_spans.clear()
    procs_server = {s.get("Proc") for s in server_spans}
    print(f"  fleet: {N_COMMITS} commits ({n_err} errored), "
          f"{len(client_spans)} client spans, {len(server_spans)} spans "
          f"fetched from {procs_server}", flush=True)

    # 3) cross-process waterfalls with the sum identity
    waterfalls = trace_export.build_waterfalls(client_spans + server_spans)
    complete = [w for w in waterfalls
                if w["complete"] and w["proc_client"] != w["proc_server"]]
    assert complete, f"no cross-process waterfall reconstructed: " \
                     f"{waterfalls[:3]}"
    decomposed = [w for w in complete
                  if "server_resolve" in w["segments_ms"]]
    assert decomposed, "no waterfall decomposed through the batch " \
                       "resolve span"
    for w in complete:
        assert abs(w["sum_ms"] - w["client_ms"]) <= \
            max(0.05, 0.01 * w["client_ms"]), \
            f"sum identity broken across processes: {w}"
        for name, ms in w["segments_ms"].items():
            assert ms >= -0.5, f"negative segment {name} (clock skew?): {w}"
    retained = trace_export.tail_sample(waterfalls)
    assert retained, "tail sampling retained nothing"
    w0 = decomposed[0]
    print(f"  waterfalls: {len(complete)} cross-process complete "
          f"({len(decomposed)} batch-decomposed), {len(retained)} retained; "
          f"e.g. {w0['client_ms']:.3f}ms = "
          + " + ".join(f"{k} {v:.3f}" for k, v in w0["segments_ms"].items()),
          flush=True)

    # 4) Chrome export loads and validates
    doc = trace_export.chrome_trace(
        trace_export.spans_for_traces(client_spans + server_spans, retained))
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(doc, f, default=str)
        path = f.name
    with open(path) as f:
        n_events = trace_export.validate_chrome_trace(json.load(f))
    os.unlink(path)
    assert n_events >= len(retained)
    print(f"  chrome trace: {n_events} duration events, schema valid",
          flush=True)
    print(f"trace-smoke PASS in {time.monotonic() - t_start:.1f}s",
          flush=True)
    return {"commits": N_COMMITS, "errored": n_err, "client_spans": len(client_spans),
            "server_spans": len(server_spans), "server_procs": sorted(map(str, procs_server)),
            "complete_waterfalls": len(complete), "decomposed": len(decomposed),
            "retained": len(retained), "chrome_events": n_events}


def run(device: str = "host") -> dict:
    """Every check; the result line main prints. `device` is only named
    in the line: the oracle resolves on the host."""
    t0 = time.monotonic()
    failures, out = [], None
    try:
        out = check_traced_cluster()
    except AssertionError as e:
        failures.append(str(e))
    return {"metric": "trace_smoke", "device": str(device), "ok": not failures,
            "failures": failures, "trace": out,
            "seconds": round(time.monotonic() - t0, 3)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="taken for a uniform command line; the oracle "
                         "resolves on the host")
    ap.parse_args(argv)
    out = run("host")
    print(json.dumps(out))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
