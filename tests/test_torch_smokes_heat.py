"""heat_smoke: the port's against the JAX package's. Checks 1-2's hot
ranges and split keys equal a JAX engine's at equal heat_buckets (64, as
the smoke builds both), the heat-off step's output key sets equal JAX's
eval_shape trees, and the whole smoke runs green on the CPU.
"""
import jax
import pytest
import torch

from foundationdb_tpu.ops import conflict_kernel as jck
from foundationdb_tpu.ops.host_engine import JaxConflictEngine
from foundationdb_tpu.tools import heat_bench as jheat_bench
from foundationdb_tpu.tools import heat_smoke as jheat
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine
from foundationdb_tpu_torch.tools import heat_smoke as theat

from torch_sim_world import clean_world

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean():
    clean_world()
    yield
    clean_world()


def test_constants_equal_reference():
    assert theat.POOL == jheat.POOL and theat.HOT_KEYS == jheat.HOT_KEYS
    assert theat.HOT_FRAC == jheat.HOT_FRAC and theat.SPLIT_TOLERANCE == jheat.SPLIT_TOLERANCE
    assert {f: getattr(theat.CFG, f) for f in ("key_words", "capacity", "max_txns",
                                                "max_point_reads", "max_point_writes",
                                                "max_reads", "max_writes")} == \
        {f: getattr(jheat.CFG, f) for f in ("key_words", "capacity", "max_txns",
                                             "max_point_reads", "max_point_writes",
                                             "max_reads", "max_writes")}


def test_hot_buckets_and_split_keys_equal_a_jax_engine():
    port_hot = theat.check_hot_buckets("cpu")
    jax_hot = jheat.check_hot_buckets()
    assert port_hot.heat.hot_ranges(top_n=8) == jax_hot.heat.hot_ranges(top_n=8)
    del port_hot, jax_hot

    port_split = theat.check_split_points("cpu")
    eng = JaxConflictEngine(jheat.CFG, heat_buckets=64)
    eng.warmup()
    jheat_bench.drive_zipf_stream(eng, s=0.9, pool=2048, n_batches=12, seed=7)
    splits = eng.heat.split_points(8)
    assert port_split["splits"] == list(splits)
    assert port_split["balance"] == list(eng.heat.split_balance(8, splits))


def test_disabled_path_key_sets_equal_jax_eval_shape():
    port = theat.check_disabled_path("cpu")
    eng = JaxConflictEngine(jheat.CFG, heat_buckets=0)
    out = jax.eval_shape(lambda st, b: jck.resolve_step(eng.cfg, st, b),
                         jck.state_struct(eng.cfg), jck.batch_struct(eng.cfg))
    _hist, edges, _wpos = jax.eval_shape(lambda st, b: jck.local_phases(eng.cfg, st, b),
                                         jck.state_struct(eng.cfg), jck.batch_struct(eng.cfg))
    assert port["resolve"] == sorted(out[1])
    assert port["edges"] == sorted(edges)
    assert port["captured_programs"] == 0      # nothing is captured on the CPU


def test_heat_smoke_runs_green_on_cpu():
    out = theat.run("cpu")
    assert out["ok"], out["failures"]
    assert out["device"] == "cpu" and len(out["hot_buckets"]) == 8
    assert out["split_points"]["max_dev"] <= theat.SPLIT_TOLERANCE


def test_heat_on_engine_resolves_like_the_oracle():
    """The smoke's hot stream through a port engine at 64 buckets equals
    the oracle on every batch (heat changes no verdict)."""
    from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine

    eng = TorchConflictEngine(theat.CFG, heat_buckets=64, device="cpu")
    ora = OracleConflictEngine()
    for txns, v, oldest in theat._hot_stream_batches(4, 5_000):
        assert [int(x) for x in eng.resolve(txns, v, oldest)] == \
            [int(x) for x in ora.resolve(txns, v, oldest)]
