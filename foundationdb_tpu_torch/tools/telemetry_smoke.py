"""Telemetry smoke: the span / metric / flight-recorder wiring, in seconds.

Port of ``foundationdb_tpu/tools/telemetry_smoke.py``. Its cluster is the
simulated one with the reference's engines (oracle resolvers) and the
harness injects its device times, so it touches no device; `--device` is
taken only so that every smoke shares one command line:

    python -m foundationdb_tpu_torch.tools.telemetry_smoke [--device cpu]

Four assertions (docs/observability.md):

  * spans — a mini latency-under-load run with span collection on emits
    commit-path spans whose named phase segments sum to the client-observed
    p50/p99 within 5% (the bench `latency_attribution` acceptance);
  * metrics — a dynamic sim cluster's unified telemetry (resolver
    counters, engine health transitions — core/telemetry.py) drains
    through the MetricLogger into the `\\xff/metrics/` keyspace and reads
    back;
  * flight recorder — the supervised resolver engines accumulated
    dispatch records during the traffic;
  * zero-cost off — with collection disabled, instrumented span sites
    allocate nothing (the allocation counter stays flat) and cost under
    SPAN_OFF_NS_BUDGET per call.

Prints one JSON line; any failed check exits non-zero.
"""
from __future__ import annotations

import json
import sys
import time

#: per-call budget for a DISABLED span() site (generous: the real cost is
#: one attribute check, ~100ns even on a slow CI box)
SPAN_OFF_NS_BUDGET = 5_000
ATTRIBUTION_TOL = 0.05


def check_spans(failures) -> dict:
    from ..pipeline.latency_harness import run_latency_under_load

    dev_by_bucket = {64: 0.45, 128: 0.8}
    r = run_latency_under_load(
        depth=2, batch_txns=128, device_ms=dev_by_bucket[128],
        pack_ms_per_txn=0.0006,
        offered_txns_per_sec=0.9 * 128 / (dev_by_bucket[128] / 1e3),
        n_txns=1_500, device_ms_by_bucket=dev_by_bucket,
        collect_spans=True,
    )
    att = r.attribution
    if not att:
        failures.append("no spans attributed under the harness")
        return {}
    for pct in ("p50", "p99"):
        row = att[pct]
        ratio = row.get("sum_over_client")
        if ratio is None or abs(ratio - 1.0) > ATTRIBUTION_TOL:
            failures.append(
                f"{pct} segment sum {row.get('sum_ms')}ms vs client "
                f"{row.get('client_ms')}ms (ratio {ratio})")
        # residual bounds (the non-tautological half: a regressed span site
        # dumps its time into a residual and trips these)
        for residual in ("resolve_overhead", "reply_net"):
            v = row["segments_ms"].get(residual, 0.0)
            if v < -1e-6 or v > 0.15 * row["client_ms"]:
                failures.append(
                    f"{pct} residual {residual}={v}ms out of bounds for "
                    f"client {row['client_ms']}ms")
    for name in ("queue_wait", "host_pack", "device_dispatch", "force",
                 "pipeline_wait"):
        if name not in att["p99"]["segments_ms"]:
            failures.append(f"named segment {name} missing from attribution")
    return {"n_attributed": att["n_attributed"],
            "p50": att["p50"], "p99": att["p99"]}


def check_metrics_and_flight(failures) -> dict:
    from ..client.metric_logger import read_metric
    from ..core import telemetry
    from ..core.trace import g_spans
    from ..fault import registered_engines
    from ..client.metric_logger import run_metric_logger
    from ..server.cluster import (
        DynamicClusterConfig, build_dynamic_cluster)
    from ..sim.loop import delay, set_scheduler, spawn
    from ..core import buggify

    out = {}
    c = build_dynamic_cluster(seed=71, cfg=DynamicClusterConfig())
    buggify.disable()   # exact drain timing, no injected logger lag
    g_spans.enabled = False
    sim = c.sim
    db = c.new_client()
    hub = telemetry.hub()

    async def scenario():
        spawn(run_metric_logger(db, hub.tdmetrics, "telemetry",
                                interval=1.0, sync=hub.sync),
              name="telemetryLogger")
        for i in range(12):
            async def w(tr, i=i):
                tr.set(b"obs%03d" % i, b"v")
            await db.run(w)
            await delay(0.5)
        await delay(8.0)    # past the resolver stats interval + a drain
        # the resolver's counters fed hub.tdmetrics via its
        # CounterCollection hookup; engine health states were recorded at
        # construction. Pick one persisted series of each kind.
        health_names = [n for n in hub.tdmetrics.metrics
                        if n.startswith("resolver.") and n.endswith(".state")]
        if not health_names:
            return {"error": "no health-state series registered"}
        series = await read_metric(db, "telemetry", health_names[0])
        counter_names = [n for n in hub.tdmetrics.metrics
                         if n.startswith("Resolver.")
                         and n.endswith(".batches_resolved")]
        counter_series = []
        if counter_names:
            counter_series = await read_metric(db, "telemetry",
                                               counter_names[0])
        return {"health_series": series, "health_name": health_names[0],
                "counter_series": counter_series,
                "counter_name": counter_names[0] if counter_names else None}

    try:
        res = sim.run_until(sim.sched.spawn(scenario(), name="s"), until=300.0)
    finally:
        set_scheduler(None)
    if not isinstance(res, dict) or res.get("error"):
        failures.append(f"telemetry scenario failed: {res}")
        return out
    if not res["health_series"]:
        failures.append(
            f"health series {res['health_name']} never drained to "
            "\\xff/metrics/")
    if res["counter_name"] and not res["counter_series"]:
        failures.append(
            f"resolver counter series {res['counter_name']} never drained")
    out["persisted_health_entries"] = len(res["health_series"])
    out["persisted_counter_entries"] = len(res["counter_series"])

    engines = registered_engines()
    recorded = sum(len(e.flight) for e in engines)
    if not engines:
        failures.append("no supervised engines registered in the sim")
    elif recorded == 0:
        failures.append("flight recorder never populated under traffic")
    out["engines"] = len(engines)
    out["flight_records"] = recorded
    return out


def check_disabled_overhead(failures) -> dict:
    from ..core.trace import (
        NULL_SPAN, g_spans, span, span_allocations, span_event)

    g_spans.enabled = False
    allocs_before = span_allocations[0]
    spans_before = len(g_spans.spans)
    n = 100_000
    t0 = time.perf_counter()
    for i in range(n):
        span("resolver.device_dispatch", i).finish()
        span_event("resolver.retry", i, 0.0, 1.0)
    per_call_ns = (time.perf_counter() - t0) / (2 * n) * 1e9
    if span("x") is not NULL_SPAN:
        failures.append("disabled span() did not return the shared null span")
    if span_allocations[0] != allocs_before:
        failures.append(
            f"disabled tracing allocated "
            f"{span_allocations[0] - allocs_before} spans")
    if len(g_spans.spans) != spans_before:
        failures.append(
            f"disabled tracing recorded "
            f"{len(g_spans.spans) - spans_before} spans")
    if per_call_ns > SPAN_OFF_NS_BUDGET:
        failures.append(
            f"disabled span call costs {per_call_ns:.0f}ns "
            f"> {SPAN_OFF_NS_BUDGET}ns budget")
    return {"disabled_span_ns_per_call": round(per_call_ns, 1)}


def run(device: str = "host") -> dict:
    """Every check; the result line main prints. `device` is only named
    in the line: nothing here runs on a device."""
    t0 = time.perf_counter()
    failures: list = []
    spans = check_spans(failures)
    metrics = check_metrics_and_flight(failures)
    overhead = check_disabled_overhead(failures)
    return {"metric": "telemetry_smoke", "device": str(device), "ok": not failures,
            "failures": failures, "spans": spans, "metrics": metrics,
            "overhead": overhead, "seconds": round(time.perf_counter() - t0, 3)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="taken for a uniform command line; nothing here "
                         "runs on a device")
    ap.parse_args(argv)
    out = run("host")
    print(json.dumps(out, default=str))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
