"""The wall-clock smokes on the CPU: trace_smoke (a traced commit server
as a child OS process, cross-process waterfalls, the Chrome export),
crash_smoke (a torch-engine child on the CPU killed -9 and recovered
inside the budget, parity across the crash), forensics_smoke (the
black-box journal's explain / replay / strict parse / cli) and
atlas_smoke (two recipes green, every artifact under the directory
given). Their constants equal the reference's.
"""
import os

import pytest
import torch

from foundationdb_tpu.tools import atlas_smoke as jatlas
from foundationdb_tpu.tools import trace_smoke as jtrace
from foundationdb_tpu_torch.tools import atlas_smoke as tatlas
from foundationdb_tpu_torch.tools import crash_smoke as tcrash
from foundationdb_tpu_torch.tools import forensics_smoke as tforensics
from foundationdb_tpu_torch.tools import trace_smoke as ttrace

from torch_sim_world import clean_world

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean():
    clean_world()
    yield
    clean_world()


def test_constants_equal_reference():
    assert (ttrace.N_COMMITS, ttrace.WORKERS) == (jtrace.N_COMMITS, jtrace.WORKERS)
    assert tatlas.SMOKE_BUDGET_MS == jatlas.SMOKE_BUDGET_MS and tatlas.PAIR == jatlas.PAIR
    assert tcrash.SEED == 29
    assert os.path.basename(tatlas.ARTIFACTS) == "_artifacts"


def test_trace_child_is_the_port_server():
    argv = ttrace._child_argv(12345)
    assert "foundationdb_tpu_torch.real.nemesis" in argv[-1] and "'--serve', '12345'" in argv[-1]


def test_trace_smoke_runs_green_on_cpu():
    out = ttrace.run("host")
    assert out["ok"], out["failures"]
    assert out["trace"]["complete_waterfalls"] > 0 and out["trace"]["chrome_events"] > 0


def test_crash_smoke_runs_green_on_cpu(tmp_path):
    out = tcrash.run("cpu", workdir=str(tmp_path))
    assert out["ok"], out["failures"]
    rec = out["recovery"]
    assert rec["mode"] == "complete" and rec["verdict_mismatches"] == 0
    assert rec["blackout_ms"] <= out["budget_ms"] and out["parity_mismatches"] == 0
    assert rec["progcache_hits"] == 0
    assert (tmp_path / "report.json").exists() and (tmp_path / "node0").is_dir()


def test_forensics_smoke_runs_green_on_cpu(tmp_path):
    out = tforensics.run("host", workdir=str(tmp_path))
    assert out["ok"], out["failures"]
    f = out["forensics"]
    assert len(f["sources"]) >= 5 and f["replay"]["mismatches"] == 0


def test_atlas_smoke_runs_green_under_the_given_directory(tmp_path):
    out = tatlas.run("host", str(tmp_path / "art"))
    assert out["ok"], out["failures"]
    assert all(r["slo_pass"] == 1 for r in out["recipes"].values())
    assert os.listdir(tmp_path / "art") == ["atlas_smoke_report.json"]
