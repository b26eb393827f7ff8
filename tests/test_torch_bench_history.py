"""The port's bench_history and buggify_coverage
(foundationdb_tpu_torch/tools/) against the JAX package's.

tests/test_perf_ledger.py's bench_history cases run on both packages, and
their trends, failures, tables and exit codes must be equal; the
committed BENCH_r*.json series renders the same table in both; a
synthetic H100 artifact classifies as `gpu` and never gates against a TPU
or CPU round. buggify_coverage's battery at two specs x two seeds must
give JAX's report: the same sites activated and fired, each site named by
its file within the package and its place among the file's call sites
(the port's line numbers differ)."""
import io
import json
import re
from pathlib import Path

import pytest

from torch_sim_world import BOTH, JAX, PORT, clean_world


@pytest.fixture(autouse=True)
def _clean():
    clean_world()
    yield
    clean_world()


def _art(d: Path, n: int, **m):
    m.setdefault("metric", "resolved_txns_per_sec_per_chip")
    (d / f"BENCH_r{n:02d}.json").write_text(json.dumps(m))


def _gate(P, d: Path):
    """Trends, the rendered table and main's exit code over directory d."""
    bh = P.bench_history
    trends = bh.build_trends(bh.load_series(d))
    out = io.StringIO()
    rc = bh.main(["--dir", str(d)], out=out)
    return trends, out.getvalue(), rc


def induced_regression(P, d):
    _art(d, 1, value=1_000_000.0, device="TPU v5 lite0")
    _art(d, 2, value=880_000.0, device="TPU v5 lite0")   # -12%
    trends, text, rc = _gate(P, d)
    assert not trends["ok"] and rc == 1 and "GATE FAILURES" in text
    assert any("value" in f and "regressed" in f and "12" in f for f in trends["failures"])
    return [(trends, text, rc)]


def platform_change(P, d):
    _art(d, 1, value=1_000_000.0, device="TPU v5 lite0")
    _art(d, 2, value=90_000.0, device="TFRT_CPU_0")   # 11x "drop"
    first = _gate(P, d)
    row = next(r for r in first[0]["metrics"] if r["metric"] == "value")
    assert first[0]["ok"] and row["verdict"] == "platform-change"
    assert row["platform"] == "cpu" and row["baseline_round"] is None
    _art(d, 3, value=70_000.0, device="TFRT_CPU_0")   # -22% vs r02
    second = _gate(P, d)
    row = next(r for r in second[0]["metrics"] if r["metric"] == "value")
    assert not second[0]["ok"] and row["verdict"] == "regressed" and row["baseline_round"] == 2
    return [first, second]


def noise_and_improvement(P, d):
    _art(d, 1, value=1_000_000.0, host_pack_ms_per_batch=1.0, device="TPU v5 lite0")
    _art(d, 2, value=950_000.0, host_pack_ms_per_batch=1.2, device="TPU v5 lite0")
    first = _gate(P, d)
    by = {r["metric"]: r for r in first[0]["metrics"]}
    assert first[0]["ok"] and by["value"]["verdict"] == "ok"
    assert by["host_pack_ms_per_batch"]["verdict"] == "ok"
    _art(d, 3, value=1_400_000.0, device="TPU v5 lite0")
    second = _gate(P, d)
    assert next(r for r in second[0]["metrics"]
                if r["metric"] == "value")["verdict"] == "improved"
    return [first, second]


def zero_baseline(P, d):
    _art(d, 1, value=1e6, bucket_ladder={"steady_state_compiles": 0}, device="TPU v5 lite0")
    _art(d, 2, value=1e6, bucket_ladder={"steady_state_compiles": 1}, device="TPU v5 lite0")
    got = _gate(P, d)
    row = next(r for r in got[0]["metrics"] if r["metric"] == "steady_state_compiles")
    assert row["verdict"] == "regressed" and row["change_frac"] is None and got[0]["ok"]
    json.dumps(got[0])
    return [got]


def headline_missing(P, d):
    _art(d, 1, value=1_000_000.0, device="TPU v5 lite0")
    _art(d, 2, device="TPU v5 lite0")
    first = _gate(P, d)
    assert not first[0]["ok"]
    assert any("went missing" in f and "value" in f for f in first[0]["failures"])
    (d / "BENCH_r02.json").unlink()
    _art(d, 2, device="TFRT_CPU_0")
    second = _gate(P, d)
    assert second[0]["ok"], second[0]["failures"]
    return [first, second]


@pytest.mark.parametrize("case", [induced_regression, platform_change, noise_and_improvement,
                                  zero_baseline, headline_missing], ids=lambda f: f.__name__)
def test_bench_history_case_equal_to_jax(case, tmp_path):
    got = []
    for P in BOTH:
        d = tmp_path / P.name
        d.mkdir()
        got.append(case(P, d))
    assert got[0] == got[1]


def test_committed_series_renders_the_same_table():
    got = []
    for P in BOTH:
        bh = P.bench_history
        root = bh.find_repo_root()
        series = bh.load_series(root)
        assert len(series) >= 5
        trends = bh.build_trends(series)
        assert trends["ok"], trends["failures"]
        row = next(r for r in trends["metrics"] if r["metric"] == "value")
        assert all(v is not None for v in row["values"])
        out = io.StringIO()
        bh.render_tables(trends, out)
        got.append((trends, out.getvalue()))
    assert got[0] == got[1]
    assert PORT.bench_history.find_repo_root() == JAX.bench_history.find_repo_root()


def test_h100_artifact_classifies_as_gpu(tmp_path):
    bh = PORT.bench_history
    h100 = {"device": "NVIDIA H100 80GB HBM3", "value": 150_000.0}
    assert bh.platform_of(h100) == "gpu"
    assert bh.platform_of({"device": "cuda:0"}) == "gpu"
    for dev, want in (("TPU v5 lite0", "tpu"), ("TFRT_CPU_0", "cpu"), ("", "unknown")):
        assert bh.platform_of({"device": dev}) == want == JAX.bench_history.platform_of(
            {"device": dev})
    # after the TPU and CPU rounds, a card round is a baseline reset (a 10x
    # "drop" against the TPU does not gate), and a later card round compares
    # with it alone
    _art(tmp_path, 1, value=1_000_000.0, device="TPU v5 lite0")
    _art(tmp_path, 2, value=90_000.0, device="TFRT_CPU_0")
    _art(tmp_path, 3, **h100)
    trends = bh.build_trends(bh.load_series(tmp_path))
    row = next(r for r in trends["metrics"] if r["metric"] == "value")
    assert trends["ok"] and row["verdict"] == "platform-change" and row["platform"] == "gpu"
    _art(tmp_path, 4, device="NVIDIA H100 80GB HBM3", value=120_000.0)   # -20%
    trends = bh.build_trends(bh.load_series(tmp_path))
    row = next(r for r in trends["metrics"] if r["metric"] == "value")
    assert not trends["ok"] and row["verdict"] == "regressed" and row["baseline_round"] == 3


# -- buggify_coverage -----------------------------------------------------------

def _site_names(P):
    """{(file, line): "path/in/package.py#k"}: the k-th call site of its file."""
    bc = P.buggify_coverage
    root = bc.REPO / P.name
    names, seen = {}, {}
    for f, line in bc.static_sites():
        rel = str(Path(f).relative_to(root))
        seen[rel] = seen.get(rel, 0) + 1
        names[(f, line)] = f"{rel}#{seen[rel]}"
    return names


def coverage(P):
    bc = P.buggify_coverage
    names = _site_names(P)
    log = io.StringIO()
    activated, fired, failures = bc.run_battery(["CycleTestRestart", "DiskAttrition"],
                                                [11, 12], out=log)
    out = io.StringIO()
    frac = bc.report(activated, fired, out=out)
    by_path = {}
    for (f, line), name in names.items():
        by_path[f"{Path(f).relative_to(bc.REPO)}:{line}"] = name
    text = re.sub(r"\S+\.py:\d+", lambda m: by_path.get(m.group(0), m.group(0)), out.getvalue())
    return (sorted(names[s] for s in activated if s in names),
            sorted(names[s] for s in fired if s in names), failures, frac, log.getvalue(), text)


def test_buggify_coverage_report_equal_to_jax():
    got = []
    for P in BOTH:
        clean_world()
        got.append(coverage(P))
    assert got[0] == got[1]
    activated, fired, failures, frac, _log, text = got[0]
    assert failures == 0 and fired and set(fired) <= set(activated)
    assert "sim-reachable" in text


def test_static_sites_scan_the_port():
    bc = PORT.buggify_coverage
    sites = bc.static_sites()
    assert len(sites) == len(JAX.buggify_coverage.static_sites()) >= 60
    assert all("/foundationdb_tpu_torch/" in f for f, _ in sites)
    real = bc.real_sites(sites)
    assert len(real) + len(bc.sim_reachable(sites)) == len(sites)
    assert {Path(f).name for f, _ in real} >= {"transport.py", "cluster.py"}
