"""The port's benches (foundationdb_tpu_torch/tools/: skiplist_bench,
ladder_bench, floor_bench, heat_bench, profile_kernel, recovery_bench,
bench_smoke) against the JAX package's and the oracle, on the CPU.

The workload generators give the same transactions as JAX's at the same
seed; the bucket-ladder drive gives the same verdicts, bucket hits and
scan histogram on a CPU port engine as on a JAX engine; the floor and
apply sweeps run at toy sizes with both search modes equal; the heat
sweep gives JAX's concentrations and split points; every profile_kernel
variant runs at its toy size; the bench smoke passes with --device cpu;
and the capture counter counts 0 on the CPU, never None. Timings are
never compared across the packages, and the CPU runs report no device
ms."""
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from foundationdb_tpu.ops.conflict_kernel import KernelConfig as JaxConfig
from foundationdb_tpu.ops.host_engine import JaxConflictEngine
from foundationdb_tpu.tools import heat_bench as jax_heat
from foundationdb_tpu.tools import ladder_bench as jax_ladder
from foundationdb_tpu.tools import skiplist_bench as jax_skiplist
from foundationdb_tpu_torch.ops import conflict_kernel as ck
from foundationdb_tpu_torch.ops import host_engine as he
from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine
from foundationdb_tpu_torch.tools import (bench_smoke, floor_bench, heat_bench, ladder_bench,
                                          profile_kernel, recovery_bench, skiplist_bench)
from torch_sim_world import clean_world

CFG = ck.KernelConfig(key_words=4, capacity=2048, max_txns=128, max_point_reads=256,
                      max_point_writes=256, max_reads=32, max_writes=32)


@pytest.fixture(autouse=True)
def _clean():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    clean_world()
    yield
    clean_world()
    torch.set_num_threads(threads)


def _jax_cfg(cfg):
    return JaxConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
                     fixpoint="xla")


def _txns(txns):
    return [(t.read_snapshot, [(r.begin, r.end) for r in t.read_conflict_ranges],
             [(r.begin, r.end) for r in t.write_conflict_ranges]) for t in txns]


def _batches(batches):
    return [(_txns(txns), now, oldest) for txns, now, oldest in batches]


# -- the workload generators ---------------------------------------------------

@pytest.mark.parametrize("seed", [7, 11])
def test_generators_make_jax_transactions(seed):
    assert _batches(skiplist_bench.make_batches(3, 50, 256, seed)) == \
        _batches(jax_skiplist.make_batches(3, 50, 256, seed))
    assert ladder_bench.drive_batch_sizes([32, 64, 128]) == \
        jax_ladder.drive_batch_sizes([32, 64, 128])
    assert _txns(ladder_bench.make_point_txns(40, 512, np.random.default_rng(seed), 900)) == \
        _txns(jax_ladder.make_point_txns(40, 512, np.random.default_rng(seed), 900))
    perm = np.random.default_rng(seed + 1).permutation(300)
    for s in (0.0, 0.9, 1.2):
        assert _txns(heat_bench.zipf_point_txns(30, 300, s, np.random.default_rng(seed), 500,
                                                perm=perm)) == \
            _txns(jax_heat.zipf_point_txns(30, 300, s, np.random.default_rng(seed), 500,
                                           perm=perm))


def test_skiplist_bench_runs_both_engines_on_the_host():
    for engine in ("oracle", "native"):
        r = skiplist_bench.run(engine, batches=3, txns=100, pool=512)
        assert r["device"] == "cpu" and r["txns_per_sec"] > 0
    out = io.StringIO()
    import contextlib
    with contextlib.redirect_stdout(out):
        assert skiplist_bench.main(["--engine", "oracle", "--batches", "2", "--txns", "50"]) == 0
    assert json.loads(out.getvalue())["engine"] == "oracle"


# -- the bucket ladder -----------------------------------------------------------

def test_bucket_ladder_equal_to_jax_engine():
    got = []
    port = ladder_bench.drive_bucket_ladder(CFG, [32, 64], pool=512, steady_rounds=2,
                                            scan_sizes=(2,), oracle_check=True, device="cpu",
                                            verdicts=got)
    jeng = JaxConflictEngine(_jax_cfg(CFG), ladder=[32, 64], scan_sizes=(2,))
    want = []
    resolve = jeng.resolve

    def recording(txns, now, oldest):
        out = resolve(txns, now, oldest)
        want.append([int(x) for x in out])
        return out

    jeng.resolve = recording
    jax = jax_ladder.drive_bucket_ladder(_jax_cfg(CFG), [32, 64], pool=512, steady_rounds=2,
                                         engine=jeng)
    assert got == want and len(got) == 2 * len(port["driven_batch_sizes"])
    for key in ("ladder", "scan_sizes", "bucket_hits", "scan_dispatches",
                "driven_batch_sizes", "rounds", "compiles_warmup", "steady_state_compiles"):
        assert port[key] == jax[key], key
    assert port["oracle_parity_ok"] and port["scan_dispatches"]["2"] > 0
    assert port["device"] == "cpu"
    assert port["captures_warmup"] == 0 and port["steady_state_captures"] == 0


def test_ladder_bench_main_on_the_cpu(capsys):
    assert ladder_bench.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and out["oracle_parity_ok"]
    assert out["ladder"] == [32, 64, 128]


def test_ladder_bench_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ladder_bench.drive_bucket_ladder(CFG, [32, 64])


# -- the floor and apply sweeps ---------------------------------------------------

def test_floor_sweep_both_modes_at_toy_size():
    cfg = dataclasses.replace(CFG, capacity=1024)
    out = floor_bench.run_floor_sweep(cfg, occupancy_fracs=(0.25, 0.75), scan_steps=3,
                                      device="cpu")
    assert out["card"] == "cpu" and out["auto_pick"] == ck.pick_history_search(cfg)
    assert [p["n"] for p in out["points"]] == [256, 768]
    for p in out["points"]:
        assert p["verdicts_equal"]
        # a CPU run measures no device time
        assert p["fused_sort_ms"] is None and p["bsearch_ms"] is None
    assert out["steady_state_compiles"] == {"fused_sort": 0, "bsearch": 0}


def test_floor_read_batch_commits_everything_in_both_modes():
    """The sweep's synthesized table and read batch: every txn commits in
    either mode, as the oracle says of a read-only batch whose snapshots are
    above every stored version; the table stays at n."""
    cfg = dataclasses.replace(CFG, capacity=1024)
    rng = np.random.default_rng(3)
    n = 300
    arrays = floor_bench._read_batch(cfg, rng, n)
    for mode in ("fused_sort", "bsearch"):
        mcfg = dataclasses.replace(cfg, history_search=mode)
        st, out = ck.resolve_step(mcfg, floor_bench._table_state(cfg, n),
                                  ck.batch_from_numpy(cfg, arrays, "cpu"), False)
        assert int(st["n"]) == n
        assert (out["status"].numpy() == 2).all()


def test_search_modes_equal_the_oracle_on_a_driven_stream():
    engines = {m: he.TorchConflictEngine(CFG, history_search=m, device="cpu", scan_sizes=())
               for m in ("fused_sort", "bsearch")}
    oracle = OracleConflictEngine()
    rng = np.random.default_rng(11)
    version = 500
    for n in (16, 64, 128, 100):
        txns = ladder_bench.make_point_txns(n, 256, rng, version)
        version += 200
        want = [int(x) for x in oracle.resolve(txns, version, version - 400)]
        for m, e in engines.items():
            assert [int(x) for x in e.resolve(txns, version, version - 400)] == want, m


def test_apply_sweep_at_toy_size():
    cfg = dataclasses.replace(CFG, capacity=1024)
    out = floor_bench.run_apply_sweep(cfg, occupancy_fracs=(0.5,), scan_steps=10,
                                      history_runs=4, device="cpu")
    (p,) = out["points"]
    assert p["n"] == 512 and p["monolithic_ms"] is None and p["tiered_ms"] is None
    assert out["steady_state_compiles"] == {"monolithic": 0, "tiered": 0}


def test_scan_program_equals_the_eager_loop():
    """ScanProgram on the CPU is the eager loop over its carry, run after
    run, its outputs in ys."""
    carry = {"x": torch.zeros((), dtype=torch.int64)}
    prog = floor_bench.ScanProgram(lambda c, i: ({"x": c["x"] + i}, c["x"] + i), carry, 4)
    assert prog.run() is None and prog.graph is None
    assert prog.ys.tolist() == [0, 1, 3, 6] and int(carry["x"]) == 6
    prog.run()
    assert prog.ys.tolist() == [6, 7, 9, 12]


def test_capture_counter_contract():
    """The port's _CompileCounter counts graph captures: 0 on the CPU,
    where nothing is captured, and never None."""
    counter = floor_bench._CompileCounter()
    start = he.CAPTURES.n
    eng = he.TorchConflictEngine(CFG, ladder=[64], scan_sizes=(2,), device="cpu").warmup()
    assert eng.perf.compiles == 4 and eng.perf.captures == 0
    assert he.CAPTURES.n == start
    seen = counter.close()
    assert seen == 0 and seen is not None
    # counted captures move it (what a card capture does), close() freezes it
    counter = floor_bench._CompileCounter()
    he.count_capture(eng.perf)
    assert counter.seen() == 1 and eng.perf.captures == 1
    assert counter.close() == 1
    he.count_capture()
    assert counter.close() == 1


# -- heat ------------------------------------------------------------------------

def test_conflict_heat_equal_to_jax():
    """The sweep's concentrations, top shares, abort fractions and the s=0.9
    split points and balance equal JAX's at the same seed (JAX engines
    driven by JAX's drive_zipf_stream at equal heat buckets)."""
    cfg = dataclasses.replace(heat_bench.SMOKE_CFG, capacity=2048)
    port = heat_bench.run_conflict_heat(cfg, n_batches=4, pool=512, heat_buckets=16,
                                        device="cpu", overhead=False)
    assert port["overhead"] is None and port["parity_ok"] and port["device"] == "cpu"
    perm = np.random.default_rng(2029).permutation(512)
    for row in port["sweep"]:
        jeng = JaxConflictEngine(_jax_cfg(cfg), heat_buckets=16, scan_sizes=())
        jax_heat.drive_zipf_stream(jeng, s=row["s"], pool=512, n_batches=4, seed=2028,
                                   perm=perm)
        agg = jeng.heat
        assert row["concentration"] == round(agg.concentration(), 4)
        assert row["top_share"] == round(agg.hot_ranges(top_n=1)[0]["share"], 4)
        assert row["occupancy_frac"] == round(agg.occupancy_frac(), 4)
        if row["s"] == 0.9:
            assert port["split"]["split_points"] == [k.decode("latin-1")
                                                     for k in agg.split_points(8)]
            assert port["split"]["balance"] == [round(f, 4) for f in agg.split_balance(8)]
            assert row["heat"] == json.loads(json.dumps(agg.snapshot()))


def test_heat_overhead_on_the_cpu_reports_no_device_ms():
    cfg = dataclasses.replace(heat_bench.SMOKE_CFG, capacity=1024)
    out = heat_bench.measure_heat_overhead(cfg, scan_steps=2, reps=2, heat_buckets=16,
                                           device="cpu")
    assert out["card"] == "cpu" and out["heat_on_ms"] is None and out["ok"] is None
    assert out["steady_state_compiles"] == 0


# -- profile_kernel ----------------------------------------------------------------

@pytest.mark.parametrize("variants", [
    list(profile_kernel.VARIANTS), ["fixiters", "stacked8"],
    [name for name, *_ in profile_kernel.SHAPES]], ids=["main", "main2", "main3"])
def test_profile_kernel_variants_run_at_toy_size(variants):
    out = io.StringIO()
    p = profile_kernel.run(variants, device="cpu", steps=2, out=out)
    text = out.getvalue()
    assert p.card == "cpu" and p.ms == {}
    assert "ms/iter" not in text
    for v in variants:
        if v != "fixiters":
            assert f"{v:10s} ran 2 iterations [cpu]" in text, v
    if "fixiters" in variants:
        assert p.info["fixiters"]["max"] >= p.info["fixiters"]["min"] >= 0


# -- recovery_bench ------------------------------------------------------------------

def test_rewarm_keeps_the_jax_bar_and_reports_it_unmet(tmp_path):
    """Two fresh processes on the CPU: nothing is stored (a program has no
    serialized form in the port), the warm child rebuilds every program,
    and goal_met, computed as JAX computes it, is False."""
    out = recovery_bench.run_rewarm(str(tmp_path / "pc"), device="cpu")
    assert out["device"] == "cpu"
    cold, warm = out["cold"], out["warm"]
    assert cold["compiles"] == warm["compiles"] > 0 and warm["hits"] == 0
    assert cold["stores"] == 0 and cold["errors"] == cold["compiles"]
    assert out["goal_met"] is False


def test_replay_compare_parity():
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        out = recovery_bench.run_replay_compare(d, n_batches=40, snap_after=30)
    assert out["parity_ok"]
    assert out["snapshot_replay"]["mismatches"] == out["full_replay"]["mismatches"] == 0
    assert out["full_replay"]["replayed"] == 40


# -- bench_smoke ------------------------------------------------------------------------

def test_bench_smoke_on_the_cpu():
    out = bench_smoke.run("cpu")
    assert out["ok"], out["failures"]
    assert out["device"] == "cpu"
    assert out["bucket_ladder"]["oracle_parity_ok"]
    assert out["device_loop"]["parity_ok"] and out["device_loop"]["steady_state_compiles"] == 0
    assert out["history_floor"]["steady_state_compiles"] == {"fused_sort": 0, "bsearch": 0}
