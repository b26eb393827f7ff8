"""foundationdb_tpu_torch and chip_smoke.py import neither jax nor anything
of the JAX package, not even through a module name in a string, and the
engine runs on the card unless told otherwise.

tests/conftest.py imports jax into this process, so the import check runs
in a fresh subprocess.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from foundationdb_tpu_torch.ops.conflict_kernel import KernelConfig
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "foundationdb_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "foundationdb_tpu")


def port_modules():
    return sorted(
        "foundationdb_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_subprocess_import_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {port_modules()!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "foundationdb_tpu_torch.ops.host_engine" in loaded
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "foundationdb_tpu_torch.core.wire",
    "foundationdb_tpu_torch.pipeline",
    "foundationdb_tpu_torch.pipeline.resolver_pipeline",
    "foundationdb_tpu_torch.native.fastpack",
    "foundationdb_tpu_torch.core.heatmap",
    "foundationdb_tpu_torch.ops.device_loop",
    "foundationdb_tpu_torch.core.knobs",
    "foundationdb_tpu_torch.core.trace",
    "foundationdb_tpu_torch.core.telemetry",
    "foundationdb_tpu_torch.core.perfledger",
    "foundationdb_tpu_torch.pipeline.scheduler",
    "foundationdb_tpu_torch.sim.simulator",
    "foundationdb_tpu_torch.core.blackbox",
    "foundationdb_tpu_torch.server.resolver",
    "foundationdb_tpu_torch.pipeline.service",
    "foundationdb_tpu_torch.fault",
    "foundationdb_tpu_torch.fault.inject",
    "foundationdb_tpu_torch.fault.resilient",
    "foundationdb_tpu_torch.fault.handoff",
    "foundationdb_tpu_torch.fault.recovery",
    "foundationdb_tpu_torch.core.progcache",
    "foundationdb_tpu_torch.core.keyshard",
    "foundationdb_tpu_torch.server.reshard",
    "foundationdb_tpu_torch.core.indexedset",
    "foundationdb_tpu_torch.core.keyrangemap",
    "foundationdb_tpu_torch.server.kvstore",
    "foundationdb_tpu_torch.server.cluster",
    "foundationdb_tpu_torch.server.proxy",
    "foundationdb_tpu_torch.server.storage",
    "foundationdb_tpu_torch.client",
    "foundationdb_tpu_torch.pipeline.latency_harness",
    "foundationdb_tpu_torch.testing",
    "foundationdb_tpu_torch.testing.specs",
    "foundationdb_tpu_torch.testing.runner",
    "foundationdb_tpu_torch.server.replication_policy",
    "foundationdb_tpu_torch.server.management",
    "foundationdb_tpu_torch.server.coordination",
    "foundationdb_tpu_torch.server.coordinated_state",
    "foundationdb_tpu_torch.server.leader_election",
    "foundationdb_tpu_torch.server.worker",
    "foundationdb_tpu_torch.server.cluster_controller",
    "foundationdb_tpu_torch.server.masterserver",
    "foundationdb_tpu_torch.bindings",
    "foundationdb_tpu_torch.bindings.directory",
    "foundationdb_tpu_torch.bindings.stacktester",
    "foundationdb_tpu_torch.backup",
    "foundationdb_tpu_torch.backup.http_blob",
    "foundationdb_tpu_torch.layers",
    "foundationdb_tpu_torch.core.watchdog",
    "foundationdb_tpu_torch.client.metric_logger",
    "foundationdb_tpu_torch.tools",
    "foundationdb_tpu_torch.tools.trace_export",
    "foundationdb_tpu_torch.tools.forensics",
    "foundationdb_tpu_torch.ops.native_engine",
    "foundationdb_tpu_torch.real",
    "foundationdb_tpu_torch.real.transport",
    "foundationdb_tpu_torch.real.runtime",
    "foundationdb_tpu_torch.real.tls",
    "foundationdb_tpu_torch.real.node",
    "foundationdb_tpu_torch.real.cluster",
    "foundationdb_tpu_torch.real.monitor",
    "foundationdb_tpu_torch.real.demo_server",
    "foundationdb_tpu_torch.real.chaos",
    "foundationdb_tpu_torch.real.workload",
    "foundationdb_tpu_torch.real.nemesis",
    "foundationdb_tpu_torch.real.scenarios",
    "foundationdb_tpu_torch.parallel",
    "foundationdb_tpu_torch.parallel.sharding",
    "foundationdb_tpu_torch.parallel.mesh_engine",
    "foundationdb_tpu_torch.tools.sharded_bench",
    "foundationdb_tpu_torch.tools.mesh_bench",
    "foundationdb_tpu_torch.tools.skiplist_bench",
    "foundationdb_tpu_torch.tools.ladder_bench",
    "foundationdb_tpu_torch.tools.floor_bench",
    "foundationdb_tpu_torch.tools.heat_bench",
    "foundationdb_tpu_torch.tools.profile_kernel",
    "foundationdb_tpu_torch.tools.recovery_bench",
    "foundationdb_tpu_torch.tools.bench_smoke",
    "foundationdb_tpu_torch.tools.bench_history",
    "foundationdb_tpu_torch.tools.buggify_coverage",
    "foundationdb_tpu_torch.tools.fdbbackup",
    "foundationdb_tpu_torch.tools.cli",
    "foundationdb_tpu_torch.tools.heat_smoke",
    "foundationdb_tpu_torch.tools.watch_smoke",
    "foundationdb_tpu_torch.tools.sched_smoke",
    "foundationdb_tpu_torch.tools.history_smoke",
    "foundationdb_tpu_torch.tools.perf_smoke",
    "foundationdb_tpu_torch.tools.telemetry_smoke",
    "foundationdb_tpu_torch.tools.trace_smoke",
    "foundationdb_tpu_torch.tools.forensics_smoke",
    "foundationdb_tpu_torch.tools.crash_smoke",
    "foundationdb_tpu_torch.tools.reshard_smoke",
    "foundationdb_tpu_torch.tools.mesh_smoke",
    "foundationdb_tpu_torch.tools.atlas_smoke",
])
def test_serving_path_modules_load_no_jax(module):
    """The columnar path's modules, each imported alone in a fresh process
    (the packer's loader also builds and loads csrc/fastpack.c there)."""
    code = (
        "import importlib, json, sys\n"
        f"m = importlib.import_module({module!r})\n"
        "if hasattr(m, 'lib'): m.lib()\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert module in loaded
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_source_scan_finds_no_jax_import():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for name in ("core/wire.py", "pipeline/resolver_pipeline.py", "native/fastpack.py",
                 "core/heatmap.py", "ops/device_loop.py", "core/rng.py", "core/knobs.py",
                 "core/buggify.py", "core/trace.py", "core/stats.py", "core/tdmetric.py",
                 "core/perfledger.py", "core/telemetry.py", "pipeline/scheduler.py",
                 "core/error.py", "core/types.py", "core/blackbox.py", "sim/loop.py",
                 "sim/actors.py", "sim/failmon.py", "sim/network.py", "sim/disk.py",
                 "sim/validation.py", "sim/system_monitor.py", "sim/simulator.py",
                 "fault/__init__.py", "server/messages.py", "server/resolver.py",
                 "pipeline/service.py", "fault/inject.py", "fault/resilient.py",
                 "fault/handoff.py", "fault/recovery.py", "core/progcache.py",
                 "core/keyshard.py", "server/reshard.py", "core/indexedset.py",
                 "core/keyrangemap.py", "server/system_keys.py", "server/wait_failure.py",
                 "server/disk_queue.py", "server/kvstore.py", "server/master.py",
                 "server/tlog.py", "server/log_system.py", "server/storage.py",
                 "server/ratekeeper.py", "server/proxy.py", "client/database.py",
                 "client/__init__.py", "server/cluster.py", "pipeline/latency_harness.py",
                 "testing/workload.py", "testing/workloads.py", "testing/specs.py",
                 "testing/runner.py", "testing/__init__.py", "server/__init__.py",
                 "server/replication_policy.py", "server/management.py",
                 "server/coordination.py", "server/coordinated_state.py",
                 "server/leader_election.py", "server/worker.py",
                 "server/cluster_controller.py", "server/masterserver.py",
                 "bindings/__init__.py", "bindings/fdb_tuple.py", "bindings/fdb_api.py",
                 "bindings/directory.py", "bindings/task_bucket.py",
                 "bindings/stacktester.py", "layers/__init__.py", "layers/_util.py",
                 "layers/bulkload.py", "layers/containers.py", "layers/pubsub.py",
                 "backup/__init__.py", "backup/container.py", "backup/http_blob.py",
                 "backup/agent.py", "backup/dr.py", "core/watchdog.py",
                 "client/metric_logger.py", "tools/__init__.py", "tools/trace_export.py",
                 "tools/forensics.py", "ops/native_engine.py", "real/__init__.py",
                 "real/transport.py", "real/runtime.py", "real/tls.py", "real/node.py",
                 "real/cluster.py", "real/monitor.py", "real/demo_server.py",
                 "real/chaos.py", "real/workload.py", "real/nemesis.py",
                 "real/scenarios.py", "parallel/__init__.py", "parallel/sharding.py",
                 "parallel/mesh_engine.py", "tools/sharded_bench.py", "tools/mesh_bench.py",
                 "tools/skiplist_bench.py", "tools/ladder_bench.py", "tools/floor_bench.py",
                 "tools/heat_bench.py", "tools/profile_kernel.py", "tools/recovery_bench.py",
                 "tools/bench_smoke.py", "tools/bench_history.py",
                 "tools/buggify_coverage.py", "tools/fdbbackup.py", "tools/cli.py",
                 "tools/heat_smoke.py", "tools/watch_smoke.py",
                 "tools/sched_smoke.py", "tools/history_smoke.py",
                 "tools/perf_smoke.py", "tools/telemetry_smoke.py",
                 "tools/trace_smoke.py", "tools/forensics_smoke.py",
                 "tools/crash_smoke.py", "tools/reshard_smoke.py",
                 "tools/mesh_smoke.py", "tools/atlas_smoke.py"):
        assert PKG / name in files, name
    for path in files:
        bad = [r for r in imported_roots(path) if r in FORBIDDEN + ("cryptography",)]
        assert not bad, (path, bad)


def named_modules(path: Path):
    """String literals that name a module of the JAX package or jax itself:
    what importlib or __import__ would load at run time, out of sight of an
    import scan (a string starting "foundationdb_tpu." but not
    "foundationdb_tpu_torch.")."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            v = node.value.strip()
            if v in FORBIDDEN or v.startswith(("foundationdb_tpu.", "jax.", "jaxlib.")):
                yield v


def test_source_scan_finds_no_jax_module_name():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        bad = list(named_modules(path))
        assert not bad, (path, bad)


def test_module_name_scan_flags_a_jax_package_string(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text('import importlib\n'
                     'MODS = ("foundationdb_tpu.core.types", "foundationdb_tpu_torch.core.types")\n'
                     'importlib.import_module("jax")\n')
    assert list(named_modules(probe)) == ["foundationdb_tpu.core.types", "jax"]


def test_engine_defaults_to_the_card():
    cfg = KernelConfig(key_words=2, capacity=256, max_reads=8, max_writes=8, max_txns=32)
    if torch.cuda.is_available():
        assert TorchConflictEngine(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchConflictEngine(cfg)
    assert TorchConflictEngine(cfg, device="cpu").state["hkeys"].device.type == "cpu"
    from foundationdb_tpu_torch.ops.device_loop import DeviceLoopEngine

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceLoopEngine(cfg)


def spawned_code(path: Path):
    """The source of every `python -c` program a file builds: string
    literals (or their %-format templates) that import a package module,
    as nemesis builds for its demo server and crash children and
    chip_smoke.py for its real-cluster nodes."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            v = node.value
            if "import" in v and "foundationdb_tpu" in v:
                yield v


def test_spawned_programs_name_only_the_port():
    import re

    found = {}
    for path in [PKG / "real" / "nemesis.py", ROOT / "chip_smoke.py"]:
        found[path.name] = list(spawned_code(path))
        for code in found[path.name]:
            assert not re.search(r"\bfoundationdb_tpu\b(?!_torch)", code), (path, code)
            assert "foundationdb_tpu_torch" in code, (path, code)
            assert "jax" not in code and "cryptography" not in code, (path, code)
    assert len(found["nemesis.py"]) >= 2 and found["chip_smoke.py"]


def test_no_module_loads_cryptography():
    code = (
        "import importlib, json, sys\n"
        f"for m in {port_modules()!r}: importlib.import_module(m)\n"
        "from foundationdb_tpu_torch.real import tls, cluster, nemesis\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m.split(".")[0] == "cryptography"]
