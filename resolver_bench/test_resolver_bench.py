"""CPU tests of the benchmark: the generator, the reference against the
port's CPU engine, the frozen fixpoint bound, the import rules, the result
line, and the check against its control and the faults it must catch.

    python -m pytest resolver_bench -q

The card test (marker `cuda`) decides inside the test whether there is a
card, and skips without one.
"""
from __future__ import annotations

import copy
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from resolver_bench import bound, harness, reference  # noqa: E402
from resolver_bench.traffic import Traffic, sizes  # noqa: E402

#: the configurations under test, each driven through the uniform cell's
#: traffic and metrics
CONFIGS = ("rw90", "rw90_zipf")
#: a size a CPU test holds: 64 txns a batch, 9 batches a write life, a
#: keyspace small enough that every kind of verdict comes
TINY = {"keys": 3000, "cluster_ops_per_s": 147400, "max_write_transaction_life_versions": 60000,
        "long_lived_lag_versions": [0, 90000],
        "engine": {"capacity": 8192, "max_txns": 128, "max_point_reads": 1152,
                   "max_point_writes": 256, "max_reads": 32, "max_writes": 32}}
SEED = 2**31 + 11


def spec_for(config: str) -> harness.Spec:
    spec = harness.load_spec(ROOT, "rw90.uniform")
    spec.config = json.loads((ROOT / "resolver_bench" / "configs" / f"{config}.json").read_text())
    return spec


def tiny_spec(config: str, built_txn_per_s: int = 20000) -> harness.Spec:
    spec = spec_for(config)
    spec.config = dict(copy.deepcopy(spec.config), **copy.deepcopy(TINY))
    spec.mix = dict(spec.mix, built_txn_per_s=built_txn_per_s)
    return spec


def run_tiny(config: str, trace: bool = False, fault=None, seconds: float = 0.6,
             device: str = "cpu") -> dict:
    return harness.run_cell(tiny_spec(config), SEED, seconds, trace, time.perf_counter(),
                            device=device, fault=fault)


# -- the generator ---------------------------------------------------------------

@pytest.mark.parametrize("config", CONFIGS)
def test_generator_is_deterministic_and_matches_its_config(config):
    cfg = spec_for(config).config
    s = sizes(cfg)
    assert (s.txns_per_batch, s.version_step, s.horizon_batches) == (1038, 6667, 750)
    a, b = Traffic(cfg, SEED, 12), Traffic(cfg, SEED, 12)
    for name in ("snap", "r_key", "w_key", "r_off", "w_off"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert a.txns[7] == b.txns[7]
    c = Traffic(cfg, SEED + 1, 12)
    assert not np.array_equal(a.r_key[:1000], c.r_key[:1000])
    assert all(len(batch) == 1038 for batch in a.txns)
    assert [a.now(i + 1) - a.now(i) for i in range(11)] == [6667] * 11
    assert a.new_oldest(5) == a.now(5) - 5_000_000
    # writes a transaction: Binomial(10, 0.1) given at least one
    want_w = 1.0 / (1 - 0.9 ** 10)
    nw = np.diff(a.w_off)
    assert nw.min() >= 1 and abs(nw.mean() / want_w - 1) < 0.02
    nr = np.diff(a.r_off)
    if cfg["key_distribution"] == "uniform":
        assert abs(nr.mean() / (10 - want_w) - 1) < 0.01
    # snapshots: one step plus 0-10,000 versions, 1% of them 0-5.1 s
    lag = np.repeat([a.now(i) for i in range(12)], 1038) - a.snap - 6667
    short = (lag >= 0) & (lag <= 10_000)
    assert short.mean() > 0.985 and lag.min() >= 0 and lag.max() <= 5_100_000
    assert 0.005 < (lag > 10_000).mean() < 0.015


def test_zipf_keys_follow_their_ranks():
    cfg = spec_for("rw90_zipf").config
    t = Traffic(cfg, SEED, 1)
    draws = t.keys.draw(np.random.default_rng(3), 2_000_000)
    for rank in (0, 1):
        share = np.count_nonzero(draws == t.keys.perm[rank]) / len(draws)
        want = t.keys.rank_share(rank)
        assert abs(share - want) < 4 * math.sqrt(want / len(draws)), (rank, share, want)
    assert 0.05 < t.keys.rank_share(0) < 0.06


def test_wire_blocks_hold_the_keys():
    from foundationdb_tpu_torch.core import wire

    t = Traffic(spec_for("rw90").config, SEED, 2)
    for i in (0, 5, 1037, 1038, 2075):
        txn = t.txns[i // t.T][i % t.T]
        block, all_point, longest = txn.conflict_wire_info()
        assert all_point and longest == 16 and txn.read_snapshot == t.snap[i]
        reads, writes = wire.conflict_unwire(block)
        assert reads == [(k, k + b"\0") for k in map(t.key_bytes_of, t.r_key[t.r_off[i]:t.r_off[i + 1]])]
        assert writes == [(k, k + b"\0") for k in map(t.key_bytes_of, t.w_key[t.w_off[i]:t.w_off[i + 1]])]


#: shapes a later cell may take by its configuration alone: ranges through
#: the general router, a ring's fixed reads and writes (upstream Cycle),
#: keys longer than the device window
SHAPES = {
    "ranges": {"range_read_share": 0.3, "range_write_share": 0.2, "range_keys": [2, 12]},
    "cycle": {"ops_per_txn": None, "write_probability": None, "cluster_ops_per_s": None,
              "reads_per_txn": 3, "writes_per_txn": 3, "writes_on_read_keys": True,
              "keys_adjacent": True, "cluster_txn_per_s": 9600, "keys": 400},
    "keys32": {"key_bytes": 32},
}


def shaped(name: str) -> dict:
    cfg = tiny_spec("rw90").config
    for k, v in SHAPES[name].items():
        if v is None:
            cfg.pop(k)
        else:
            cfg[k] = v
    return cfg


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_other_shapes_from_the_configuration_alone(name):
    from foundationdb_tpu_torch.core import wire
    from foundationdb_tpu_torch.ops.conflict_kernel import KernelConfig
    from foundationdb_tpu_torch.ops.host_engine import make_engine

    cfg = shaped(name)
    n = 30
    t = Traffic(cfg, SEED, n)
    assert t.T == 64
    for i in (0, 7, t.T + 3):
        txn = t.txns[i // t.T][i % t.T]
        reads, writes = wire.conflict_unwire(txn.conflict_wire_info()[0])
        assert [tuple(r) for r in txn.read_conflict_ranges] == reads
        assert [tuple(w) for w in txn.write_conflict_ranges] == writes

        def ids(ranges):
            return sorted({k for b, e in ranges
                           for k in range(int.from_bytes(b[-8:], "big"),
                                          int.from_bytes(e[-8:], "big") if len(e) == len(b)
                                          else int.from_bytes(b[-8:], "big") + 1)})
        assert ids(reads) == sorted(set(t.r_key[t.r_off[i]:t.r_off[i + 1]].tolist()))
        assert ids(writes) == sorted(set(t.w_key[t.w_off[i]:t.w_off[i + 1]].tolist()))
    if name == "cycle":
        nr, nw = np.diff(t.r_off), np.diff(t.w_off)
        assert (nr == 3).all() and (nw == 3).all()
        assert np.array_equal(t.r_key, t.w_key)
        keys = t.r_key.reshape(-1, 3)     # each transaction's, sorted: a run round the ring
        run = np.zeros(len(keys), dtype=bool)
        for c in range(3):
            run |= (np.sort((keys[:, [c]] + np.arange(3)) % 400, axis=1) == keys).all(axis=1)
        assert run.all()
    rows = t.rows.sum(axis=0)
    assert (rows[2] > 0 and rows[3] > 0) == (name == "ranges")
    want = reference.resolve(t, n)
    engine = make_engine("torch", KernelConfig(**cfg["engine"]), device="cpu")
    got = [np.array(engine.resolve(t.txns[b], t.now(b), t.new_oldest(b)), dtype=np.int8)
           for b in range(n)]
    assert reference.mismatches(got, want.verdicts) == 0
    assert np.bincount(np.concatenate(want.verdicts), minlength=3).min() > 0


# -- the reference ---------------------------------------------------------------

@pytest.mark.parametrize("config", CONFIGS)
def test_reference_equals_the_port_cpu_engine(config):
    from foundationdb_tpu_torch.ops.conflict_kernel import KernelConfig
    from foundationdb_tpu_torch.ops.host_engine import make_engine

    cfg = tiny_spec(config).config
    n = 40
    t = Traffic(cfg, SEED, n)
    want = reference.resolve(t, n)
    engine = make_engine("torch", KernelConfig(**cfg["engine"]), device="cpu")
    got = [np.array(engine.resolve(t.txns[b], t.now(b), t.new_oldest(b)), dtype=np.int8)
           for b in range(n)]
    assert reference.mismatches(got, want.verdicts) == 0
    counts = np.bincount(np.concatenate(want.verdicts), minlength=3)
    assert counts.min() > 0, counts     # every verdict is judged
    # the rows the reference counts are the table's
    assert int(engine.state["n"]) == want.rows_last


def test_fixpoint_bound_is_chip_smokes():
    import chip_smoke

    from foundationdb_tpu_torch.ops.conflict_kernel import KernelConfig

    cfg = KernelConfig(capacity=1 << 22, max_txns=2048, max_point_reads=18432,
                       max_point_writes=4096, max_reads=64, max_writes=96)
    rng = np.random.default_rng(0)
    batch = {k: rng.random(n) < 0.6 for k, n in (("rp_valid", cfg.rp), ("r_valid", cfg.max_reads),
                                                  ("wp_valid", cfg.wp), ("w_valid", cfg.max_writes))}
    for rounds in (1, 7):
        assert bound.fixpoint_bound(cfg, batch, None, None, rounds) == \
            chip_smoke.fixpoint_bound(cfg, batch, None, None, rounds)
    shape = bound.Shape({"max_txns": 2048, "max_point_reads": 18432, "max_point_writes": 4096,
                         "max_reads": 64, "max_writes": 96})
    assert bound.batch_bound_ms(shape, 8000, 1500) == chip_smoke.fixpoint_bound(
        cfg, {"rp_valid": np.ones(8000), "r_valid": np.zeros(1), "wp_valid": np.ones(1500),
              "w_valid": np.zeros(1)}, None, None, 1)["bound_ms"]


def test_device_trace_reads_busy_idle_and_kernels():
    from resolver_bench.devtrace import DeviceTrace

    class Event:                # the profiler's event as torch 2.11 gives it
        def __init__(self, dev, name, start, dur, card=0):
            self.d, self.n, self.s, self.t, self.c = dev, name, start, dur, card

        def device_index(self):
            return self.c

        def device_type(self):
            return f"DeviceType.{self.d}"

        def name(self):
            return self.n

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.t

    events = [Event("CPU", "cudaGraphLaunch", 100, 50),
              Event("CUDA", "Memcpy HtoD (Pinned -> Device)", 100, 20),
              Event("CUDA", "void commit_fixpoint_kernel(int)", 110, 30),   # overlaps the copy
              Event("CUDA", "void commit_fixpoint_stacked_kernel(int)", 200, 10),
              Event("CUDA", "Memset (Device)", 250, 10),
              Event("CUDA", "void late(int)", 390, 50)]                       # cut at the window
    dev = DeviceTrace(events, 100, 400)
    assert dev.busy() == [(100, 140), (200, 210), (250, 260), (390, 400)]
    assert dev.busy_s() == 70e-9 and dev.window_s == 300e-9
    assert dev.kernel_s("commit_fixpoint_kernel", exclude="stacked") == (30e-9, 1)
    assert dev.kernel_s() == (90e-9, 3)
    idle = dict(dev.idle_by_host({"dispatch": [(140, 220)], "force": [(205, 400)]}))
    assert idle == {"dispatch": 60e-9, "force": 170e-9}
    # two cards: each one's busy time, averaged
    two = DeviceTrace(events + [Event("CUDA", "void other(int)", 120, 100, card=1)], 100, 400, 2)
    assert two.busy_s() == pytest.approx((70e-9 + 100e-9) / 2)


# -- imports ----------------------------------------------------------------------

def test_no_jax_and_a_reference_apart_from_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import resolver_bench.reference, resolver_bench.traffic, resolver_bench.bound,"
            " resolver_bench.devtrace, resolver_bench.control;"
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "flax", "foundationdb_tpu", "foundationdb_tpu_torch",
                         "torch"}
    # a whole run on the CPU loads the port and neither JAX nor the JAX package
    code = ("import sys, time; sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2]);"
            "import test_resolver_bench as t; from resolver_bench import harness;"
            "r = t.run_tiny('rw90', seconds=0.3); assert r['correct'];"
            "print(harness.forbidden_loaded(), 'foundationdb_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), str(ROOT / "resolver_bench")],
                         capture_output=True, text=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "[] True"


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "foundationdb_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.x", sys)
    for name in ("jax", "jaxlib", "flax", "foundationdb_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "foundationdb_tpu.ops", sys)
    assert harness.forbidden_loaded() == ["foundationdb_tpu"]


# -- the run ------------------------------------------------------------------------

def _contract_shape(result: dict, names):
    assert list(result)[0] == "correct" and list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert set(result["metrics"]) == set(names)
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(result))


def test_a_tiny_cpu_run_prints_the_contract_line():
    result = run_tiny("rw90")
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    _contract_shape(result, ("txn_per_s", "setup_s"))
    assert result["checks"]["mismatched_verdicts"] == {"value": 0, "limit": 0}
    traced = run_tiny("rw90_zipf", trace=True)
    # on the CPU there is no device trace: its metrics are left out
    _contract_shape(traced, ("host_pack_ms", "dispatch_host_ms", "force_ms", "pipeline_wait_ms",
                             "batch_p99_ms", "warmup_s", "prefill_s"))


def test_an_open_loop_offers_its_rate_and_times_from_due():
    spec = tiny_spec("rw90")
    spec.mix = dict(spec.mix, loop="open", offered_txn_per_s=640)     # 10 batches a second
    result = harness.run_cell(spec, SEED, 1.0, False, time.perf_counter(), device="cpu")
    assert result["correct"] and result["attempted"] == 10 * 64
    # never more than offered; how much of it is answered inside the
    # window depends on the host's speed
    assert 0 < result["metrics"]["txn_per_s"]["value"] <= 640


@pytest.mark.parametrize("kind", ["subsharded", "sharded"])
def test_the_engine_comes_from_the_configuration(kind):
    spec = tiny_spec("rw90_zipf")
    spec.config.update(engine_kind=kind, shards=2)
    result = harness.run_cell(spec, SEED, 0.3, False, time.perf_counter(), device="cpu")
    assert result["correct"] and result["attempted"] > 0, result["checks"]


def test_one_card_engines_refuse_more_chips():
    spec = tiny_spec("rw90")
    spec.cell = dict(spec.cell, chips=4)
    with pytest.raises(harness.RunFailed, match="runs on one card"):
        harness.run_cell(spec, SEED, 0.3, False, time.perf_counter(), device="cpu")


def test_a_program_built_inside_the_window_fails_the_run():
    def build_late(engine):
        dispatch, calls = engine.columnar_dispatch, []

        def counting(plan):
            calls.append(1)
            if len(calls) == 10 + 1:        # the window's first batch (9 prefill)
                engine.perf.compiles += 1
            return dispatch(plan)
        engine.columnar_dispatch = counting

    with pytest.raises(harness.RunFailed, match="built inside the window"):
        run_tiny("rw90", fault=build_late, seconds=0.3)


def test_run_without_a_card_or_without_the_program_prints_no_result(tmp_path):
    cmd = [sys.executable, "resolver_bench/run.py", "--workload", "rw90.uniform", "--seed",
           str(SEED), "--seconds", "1", "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, env=env)
    assert r.returncode != 0 and r.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "resolver_bench", tmp_path / "resolver_bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    r = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, env=env)
    assert r.returncode != 0 and r.stdout == ""


# -- the check, its control and the faults it catches ------------------------------

@pytest.mark.parametrize("config", CONFIGS)
def test_the_control_fails_the_check(config):
    cfg = tiny_spec(config).config
    t = Traffic(cfg, SEED, 60)
    want = reference.resolve(t, 60)
    control = reference.resolve(t, 60, intra_batch=False)
    assert reference.mismatches(control.verdicts, want.verdicts) > 0


def _state_unchanged(engine):
    scan = engine._scan

    def unchanged(bucket, state, batches, gc_last):
        before = {k: v.clone() for k, v in state.items()}
        _, out = scan(bucket, state, batches, gc_last)
        return before, out

    engine._scan = unchanged


def _half_the_batch(engine):
    from foundationdb_tpu_torch.core.types import TransactionCommitResult

    pack, dispatch = engine.columnar_pack, engine.columnar_dispatch

    def half(txns, now, new_oldest):
        plan = pack(txns[:len(txns) // 2], now, new_oldest)
        plan["all_txns"] = len(txns)
        return plan

    def rest_committed(plan):
        force = dispatch(plan)
        return lambda: force() + [TransactionCommitResult.COMMITTED] * (
            plan["all_txns"] - plan["all_txns"] // 2)

    engine.columnar_pack, engine.columnar_dispatch = half, rest_committed


def _one_verdict_altered(engine):
    from foundationdb_tpu_torch.core.types import TransactionCommitResult as R

    dispatch = engine.columnar_dispatch
    seen = []

    def altered(plan):
        force = dispatch(plan)
        seen.append(plan)

        def out(nth=len(seen)):
            res = force()
            if nth == 3:
                res[0] = R.CONFLICT if res[0] == R.COMMITTED else R.COMMITTED
            return res
        return out

    engine.columnar_dispatch = altered


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _one_verdict_altered],
                         ids=["state_unchanged", "half_the_batch", "one_verdict_altered"])
def test_a_broken_timed_path_reads_not_correct(fault):
    result = run_tiny("rw90", fault=fault, seconds=0.3)
    assert result["correct"] is False
    assert result["checks"]["mismatched_verdicts"]["value"] > 0


# -- the card ------------------------------------------------------------------------

@pytest.mark.cuda
def test_a_tiny_run_on_the_card_equals_the_reference():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    result = run_tiny("rw90_zipf", trace=True, device="cuda", seconds=1.0)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
    assert "fixpoint_roofline" in result["metrics"]
