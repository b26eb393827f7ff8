"""The port's latency harness against the JAX package's.

`run_latency_under_load` drives open-loop Poisson arrivals through the
static sim cluster (proxy batching, the master's version chain, the
pipelined resolver service, the tlog push, ordered replies) with injected
pack and device figures. At the same arguments the port's harness must
return the same `as_dict()` as JAX's: the oracle engine at depth 1 and 2,
in both dispatch modes, with span collection on (so the attribution's
segments are compared too), and the port's TorchConflictEngine on the CPU
against JAX's oracle run (the virtual time reads only injected figures,
so an engine can change the result only through its verdicts). The
percentile helpers agree on seeded records.

Every compared value is an int, a string or a float computed the same way
in both packages: tolerance 0 (exact equality).
"""
import random

import pytest

from torch_sim_world import JAX, PORT, clean_world

POINT = dict(batch_txns=128, device_ms=0.5, pack_ms_per_txn=0.001,
             offered_txns_per_sec=180_000.0, n_txns=2000,
             device_ms_by_bucket={32: 0.2, 64: 0.3, 128: 0.5})


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def both(**kw):
    out = []
    for P in (PORT, JAX):
        clean_world()
        out.append(P.harness.run_latency_under_load(**kw).as_dict())
    return out


@pytest.mark.parametrize("depth,dispatch_mode", [(1, "step"), (2, "step"), (2, "device_loop")])
def test_oracle_point_with_spans_equals_jax(depth, dispatch_mode):
    port, jax_ = both(depth=depth, dispatch_mode=dispatch_mode, collect_spans=True,
                      queue_enqueue_ms=0.02 if dispatch_mode == "device_loop" else 0.0,
                      result_drain_ms=0.01 if dispatch_mode == "device_loop" else 0.0, **POINT)
    assert port == jax_
    att = port["attribution"]
    assert att["n_attributed"] > 0 and att["segments"] == list(PORT.harness.ATTRIBUTION_SEGMENTS)
    assert port["committed"] + port["conflicted"] == POINT["n_txns"] and port["errors"] == 0
    if dispatch_mode == "device_loop":
        assert att["p50"]["segments_ms"]["device_resident"] > 0
    assert not PORT.trace.g_spans.enabled


def test_depths_differ_under_load():
    """The points above exercise the pipeline: depth changes the result."""
    clean_world()
    d1 = PORT.harness.run_latency_under_load(depth=1, **POINT).as_dict()
    clean_world()
    d2 = PORT.harness.run_latency_under_load(depth=2, **POINT).as_dict()
    assert d1["p99_ms"] != d2["p99_ms"]


def test_cpu_port_engine_point_equals_jax_oracle():
    from foundationdb_tpu_torch.ops.conflict_kernel import KernelConfig
    from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine

    cfg = KernelConfig(key_words=4, capacity=8192, max_reads=512, max_writes=512, max_txns=128)
    engines = []

    def factory():
        engines.append(TorchConflictEngine(cfg, device="cpu"))
        return engines[-1]

    kw = dict(depth=2, **POINT)
    clean_world()
    port = PORT.harness.run_latency_under_load(engine_factory=factory, **kw).as_dict()
    clean_world()
    jax_ = JAX.harness.run_latency_under_load(**kw).as_dict()
    assert port == jax_
    assert len(engines) == 1 and port["errors"] == 0


def test_harness_restores_knobs_and_spans():
    before = PORT.knobs.SERVER_KNOBS.as_dict()
    PORT.harness.run_latency_under_load(depth=1, collect_spans=True, **dict(POINT, n_txns=300))
    assert PORT.knobs.SERVER_KNOBS.as_dict() == before
    assert not PORT.trace.g_spans.enabled
    assert PORT.harness.p99_budget_ms() == JAX.harness.p99_budget_ms()


def test_pipeline_exports_the_harness_lazily():
    assert PORT.pipeline.run_latency_under_load is PORT.harness.run_latency_under_load
    assert PORT.pipeline.latency_harness is PORT.harness


@pytest.mark.parametrize("seed", [3, 4])
def test_percentile_helpers_equal_jax(seed):
    rng = random.Random(seed)
    records = [(rng.random() * 10, rng.random() * 0.01, rng.random() < 0.9, rng.randrange(10**6))
               for _ in range(500)]
    windows = [(1.0, 1.5), (4.0, 6.0)]
    lat = sorted(r[1] * 1e3 for r in records)
    for p in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert PORT.harness.percentile_ms(lat, p) == JAX.harness.percentile_ms(lat, p)
        assert PORT.harness.percentile_outside_windows(records, windows, p) == \
            JAX.harness.percentile_outside_windows(records, windows, p)
        assert PORT.harness.percentile_index(len(lat), p) == JAX.harness.percentile_index(len(lat), p)
    assert PORT.harness.in_any_window(1.2, windows) and not PORT.harness.in_any_window(3.0, windows)
    got = PORT.harness.percentile_outside_windows([], windows)
    assert got[1] == 0 and got[0] != got[0]   # (nan, 0)
    assert PORT.harness.OVERLAY_SEGMENTS == JAX.harness.OVERLAY_SEGMENTS
