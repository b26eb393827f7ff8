"""The port's trace export (foundationdb_tpu_torch/tools/trace_export.py)
against the JAX package's: the same span list gives JSON-equal
waterfalls, tail samples, summaries, root causes and Chrome documents,
and the port's pass tests/test_trace_export.py's assertions."""
import asyncio
import json

import pytest

from torch_sim_world import BOTH, JAX, PORT, clean_world


@pytest.fixture(autouse=True)
def _clean():
    clean_world()
    yield
    clean_world()


def _span(name, trace, t0, t1, proc, **d):
    return {"Name": name, "Trace": trace, "Begin": t0, "End": t1, "Proc": proc, **d}


def trace_set(n_clean=200):
    """tests/test_trace_export.py's four requests (committed, conflicted,
    throttled, unreached) and `n_clean` clean acks of i ms each."""
    spans = [
        _span("client.commit", "r1", 0.000, 0.010, "client-a", version=100),
        _span("server.commit", "r1", 0.001, 0.009, "server", version=100),
        _span("client.commit", "r2", 0.001, 0.011, "client-b", err="not_committed"),
        _span("server.commit", "r2", 0.002, 0.010, "server", version=100,
              err="not_committed"),
        _span("chaos.queue_wait", 100, 0.001, 0.004, "server", txns=2),
        _span("chaos.resolve", 100, 0.004, 0.007, "server", txns=2),
        _span("client.commit", "r3", 0.002, 0.003, "client-a", err="transaction_throttled"),
        _span("server.commit", "r3", 0.0025, 0.0028, "server", err="transaction_throttled"),
        _span("client.commit", "r4", 0.005, 0.055, "client-b", err="connection_failed"),
    ]
    for i in range(n_clean):
        rid = f"c{i}"
        spans.append(_span("client.commit", rid, 1.0 + i, 1.0 + i + i * 1e-3,
                           "client-a", version=100))
        spans.append(_span("server.commit", rid, 1.0 + i + 1e-4,
                           1.0 + i + i * 1e-3 - 1e-4, "server", version=100))
    return spans


WINDOWS = [
    {"kind": "partition", "t0": 0.000, "t1": 0.004, "src": "client-a", "dst": "server"},
    {"kind": "reshard", "t0": 0.001, "t1": 0.002},
    {"kind": "reshard_arc", "t0": 0.001, "t1": 0.003},
    {"kind": "reshard_warm", "t0": 0.000, "t1": 0.001},
    {"kind": "incident", "t0": 0.001, "t1": 0.004, "summary": "s"},
    {"kind": "warmup", "t0": 0.000, "t1": 0.001},
]


def export(P, n_clean=200):
    tx = P.trace_export
    spans = trace_set(n_clean)
    wfs = tx.build_waterfalls(spans)
    out = {"waterfalls": wfs,
           "tail_default": tx.tail_sample(wfs),
           "tail_2pct": tx.tail_sample(wfs, latency_frac=0.02, max_traces=512),
           "tail_capped": tx.tail_sample(wfs, latency_frac=0.5, max_traces=5)}
    retained = tx.tail_sample(wfs, latency_frac=1.0, max_traces=512)
    out["summary"] = tx.trace_summary(wfs, retained)
    out["root_cause"] = tx.root_cause(retained)
    out["root_cause_empty"] = tx.root_cause([])
    out["spans_for_traces"] = tx.spans_for_traces(spans, out["tail_2pct"])
    doc = tx.chrome_trace(spans, WINDOWS)
    out["chrome"] = doc
    out["validated"] = tx.validate_chrome_trace(json.loads(json.dumps(doc, default=str)))
    return json.loads(json.dumps(out, default=str))


@pytest.mark.parametrize("n_clean", [0, 200])
def test_export_json_equal_to_jax(n_clean):
    assert export(PORT, n_clean) == export(JAX, n_clean)


def test_port_export_meets_reference_assertions():
    out = export(PORT)
    wfs = {w["rid"]: w for w in out["waterfalls"]}
    w = wfs["r1"]
    assert w["complete"] and w["version"] == 100 and w["ok"]
    assert set(w["segments_ms"]) == {"request_net", "server_queue_wait", "server_resolve",
                                     "server_reply", "reply_net"}
    assert w["sum_ms"] == pytest.approx(w["client_ms"], abs=1e-6)
    assert wfs["r4"]["segments_ms"] == {"client_unreached": pytest.approx(50.0)}
    rids = {w["rid"] for w in out["tail_2pct"]}
    assert {"r2", "r3", "r4"} <= rids and "c0" not in rids and "c199" in rids
    assert len(out["tail_capped"]) == 5
    assert all(w["err"] is not None for w in out["tail_capped"][:3])
    assert out["root_cause"]["rid"] == "c199" and out["root_cause_empty"] is None
    # without the clean acks the conflicted ack r2 leads: acks take
    # precedence over the slower transport-failed r4
    assert export(PORT, 0)["root_cause"]["rid"] == "r2"
    assert out["validated"] == len(trace_set()) + len(WINDOWS)
    pid_names = {ev["pid"]: ev["args"]["name"] for ev in out["chrome"]["traceEvents"]
                 if ev.get("ph") == "M"}
    track_of = {ev["name"]: pid_names[ev["pid"]] for ev in out["chrome"]["traceEvents"]
                if ev.get("cat") == "chaos"}
    assert track_of == {"partition": "nemesis", "warmup": "nemesis", "reshard": "reshard",
                        "reshard_arc": "reshard", "reshard_warm": "reshard",
                        "incident": "watchdog"}


@pytest.mark.parametrize("doc", [
    {"traceEvents": "nope"},
    {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "ts": 0.0, "dur": -1.0}]},
    {"traceEvents": [{"ph": "X", "pid": 1, "ts": 0, "dur": 0}]},
])
def test_malformed_chrome_documents_refused_as_jax(doc):
    msgs = []
    for P in BOTH:
        with pytest.raises(ValueError) as ei:
            P.trace_export.validate_chrome_trace(doc)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_fetch_spans_from_a_traced_port_server():
    """fetch_spans pulls a live port KV node's span ring over the real
    transport (the `trace.spans` token)."""
    from foundationdb_tpu_torch.core import trace as ptrace
    from foundationdb_tpu_torch.real.demo_server import DemoKV
    from foundationdb_tpu_torch.real.transport import RealProcess

    async def go():
        ptrace.set_span_collection(True)
        proc = RealProcess("127.0.0.1", 0)
        DemoKV(proc)
        await proc.start()
        try:
            ptrace.span_event("demo.op", "t1", 0.0, 0.001)
            return await PORT.trace_export.fetch_spans([proc.address])
        finally:
            await proc.stop()
            ptrace.set_span_collection(False)

    spans = asyncio.run(go())
    assert [(s["Name"], s["Trace"]) for s in spans] == [("demo.op", "t1")]
