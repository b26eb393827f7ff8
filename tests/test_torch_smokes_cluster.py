"""reshard_smoke and mesh_smoke on the CPU: the port's elastic group of
torch engines splits and merges within the reference's blackout budget
with journal parity, and its mesh engines (8 shards stacked on one
device) keep live and journal parity across an epoch flip. Their
constants equal the reference's.
"""
import pytest
import torch

from foundationdb_tpu.tools import mesh_smoke as jmesh
from foundationdb_tpu.tools import reshard_smoke as jreshard
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
from foundationdb_tpu_torch.tools import mesh_smoke as tmesh
from foundationdb_tpu_torch.tools import reshard_smoke as treshard

from torch_sim_world import clean_world

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean():
    clean_world()
    yield
    clean_world()


def test_constants_equal_reference():
    assert (treshard.POOL, treshard.BATCH, treshard.HOT_FRAC, treshard.HOT_WINDOW) == \
        (jreshard.POOL, jreshard.BATCH, jreshard.HOT_FRAC, jreshard.HOT_WINDOW)
    assert (tmesh.POOL, tmesh.BATCH) == (jmesh.POOL, jmesh.BATCH)
    assert tmesh.MESH_SHARDS == 8
    assert float(SERVER_KNOBS.reshard_blackout_budget_ms) == 250.0


def test_reshard_smoke_runs_green_on_cpu():
    out = treshard.run("cpu")
    out.pop("_group", None)
    assert out["ok"], out["failures"]
    kinds = [op["kind"] for op in out["ops"] if op["state"] == "done"]
    assert "split" in kinds and "merge" in kinds and out["stalled"] == 0
    assert out["parity_checked"] > 0
    assert max(op["blackout_ms"] for op in out["ops"] if op["state"] == "done") \
        <= out["budget_ms"]


def test_mesh_smoke_runs_green_on_cpu():
    knob = SERVER_KNOBS.resolver_mesh_devices
    out = tmesh.run("cpu")
    assert out.pop("group", None) is not None
    assert out["ok"], out["failures"]
    assert SERVER_KNOBS.resolver_mesh_devices == knob     # restored
    assert out["live_checked"] > 0 and out["loop_stats"]["blocking_syncs"] == 0
    assert out["mesh"]["timed_exchanges"] > 0 and len(out["mesh"]["devices"]) == 1
    assert len(out["split_adoption"]) == 3


def test_reshard_smoke_oracle_mode_runs_green():
    """--engine-mode oracle: the same drift with oracle shards (the
    build-discipline check skipped, as the reference skips it)."""
    out = treshard.run("cpu", engine_mode="oracle")
    out.pop("_group", None)
    assert out["ok"], out["failures"]
