"""history_smoke and perf_smoke: the port's against the JAX package's.
The history parity canary's verdicts equal JAX's three engines' and the
oracle's on every batch; the perf smoke's trend gate gives JAX's verdict
over the committed BENCH_r*.json series; both smokes run on the CPU.

history_smoke's check 1 (the tiered apply's speedup against the 1.5x bar)
is timed on the CPU by the host's clock; the port's eager tiered merge
there costs about four monolithic applies, so the bar is reported here,
not asserted, as chip_smoke reports it on the card: the CLI run asserts
it (and exits 1 where it is missed).
"""
import dataclasses

import pytest
import torch

from foundationdb_tpu.ops.host_engine import JaxConflictEngine
from foundationdb_tpu.ops.oracle import OracleConflictEngine as JaxOracle
from foundationdb_tpu.tools import bench_history as jbh
from foundationdb_tpu.tools import history_smoke as jhist
from foundationdb_tpu.tools import perf_smoke as jperf
from foundationdb_tpu.tools import telemetry_smoke as jtele
from foundationdb_tpu_torch.tools import history_smoke as thist
from foundationdb_tpu_torch.tools import perf_smoke as tperf
from foundationdb_tpu_torch.tools import telemetry_smoke as ttele

from torch_sim_world import clean_world

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean():
    clean_world()
    yield
    clean_world()


def test_history_constants_equal_reference():
    assert thist.SWEEP_SHAPE == jhist.SWEEP_SHAPE
    assert thist.CAPACITIES == jhist.CAPACITIES
    assert thist.MIN_SPEEDUP_LARGE == jhist.MIN_SPEEDUP_LARGE
    assert dataclasses.asdict(thist.PARITY_CFG) == {
        k: v for k, v in dataclasses.asdict(jhist.PARITY_CFG).items() if k != "fixpoint"}
    assert ttele.SPAN_OFF_NS_BUDGET == jtele.SPAN_OFF_NS_BUDGET
    assert ttele.ATTRIBUTION_TOL == jtele.ATTRIBUTION_TOL


def test_history_parity_canary_equals_jax_engines_and_oracle():
    rows = []
    thist.check_parity_and_compiles("cpu", verdicts=rows)
    tiered = dataclasses.replace(jhist.PARITY_CFG, history_structure="tiered", history_runs=3)
    engines = {
        "monolithic": JaxConflictEngine(jhist.PARITY_CFG, ladder=()),
        "tiered/fused_sort": JaxConflictEngine(
            dataclasses.replace(tiered, history_search="fused_sort"), ladder=(),
            heat_buckets=16),
        "tiered/bsearch": JaxConflictEngine(
            dataclasses.replace(tiered, history_search="bsearch"), ladder=()),
    }
    oracle = JaxOracle()
    batches = list(jhist._stream(4, batches=30))
    assert len(rows) == len(batches) == 30
    for row, (txns, now, oldest) in zip(rows, batches):
        want = [int(x) for x in oracle.resolve(txns, now, oldest)]
        assert row["oracle"] == want
        for name, eng in engines.items():
            assert [int(x) for x in eng.resolve(txns, now, oldest)] == want
            assert row[name] == want, name


def test_history_smoke_on_cpu_gated_checks_green_and_apply_timed():
    out = thist.run("cpu")
    gated = [f for f in out["failures"] if not f.startswith("apply_scaling:")]
    assert gated == []
    points = out["apply_scaling"]
    assert set(points) == {str(c) for c in thist.CAPACITIES}
    for p in points.values():
        assert p["monolithic_ms"] > 0 and p["tiered_ms"] > 0 and p["tiered_speedup"] > 0
    assert out["ok"] == (not out["failures"])


def test_perf_trend_gate_equals_reference():
    from foundationdb_tpu_torch.tools import bench_history as tbh

    root = jbh.find_repo_root()
    assert tbh.find_repo_root() == root
    jt = jbh.build_trends(jbh.load_series(root))
    tt = tbh.build_trends(tbh.load_series(root))
    assert (tt["ok"], tt["failures"]) == (jt["ok"], jt["failures"])
    assert tt == jt


def test_perf_smoke_runs_green_on_cpu():
    out = tperf.run("cpu")
    assert out["ok"], out["failures"]
    assert out["ledger_rows"] > 0 and out["steady_state_compiles"] == 0
    assert out["trend_gate_ok"] is True and out["artifacts"] > 0
    # on the CPU the ledger has no memory analysis and, by design, no flops
    assert all(b is None for b in out["peak_bytes"]) and len(out["notes"]) == 2


def test_perf_smoke_constants_match_reference_source():
    """The perf smoke keeps the reference's shape, seeds and bars (its
    constants live in main's body there: read from the source)."""
    import inspect

    src = inspect.getsource(jperf.main)
    tsrc = inspect.getsource(tperf.run)
    for token in ("capacity=2048, max_txns=128", "max_point_reads=256, max_point_writes=256",
                  "max_reads=32, max_writes=32", "default_rng(13)", "version = 2_000",
                  "(16, 31, 32, 33, 64, 65, 128, 250)", "0.02 <= ratio <= 50.0",
                  "n_batches=8, pool=256", "ladder=[32, 64], scan_sizes=(2,)"):
        assert token in src and token in tsrc, token
