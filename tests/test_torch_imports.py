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
                 "core/keyshard.py", "server/reshard.py"):
        assert PKG / name in files, name
    for path in files:
        bad = [r for r in imported_roots(path) if r in FORBIDDEN]
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
