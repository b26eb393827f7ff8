"""The port's wall-clock cluster (foundationdb_tpu_torch/real/cluster.py
launching real/node.py processes over 127.0.0.1 TCP; the first three also
coordinators): CC election, master recovery, recruitment, commits and
reads cross real sockets between OS processes, as
tests/test_real_cluster.py does for the JAX package. Each run holds the
Cycle workload's ring invariant with the resolvers on the oracle, on the
port's C++ engine, and on the port's torch engine on the CPU (at the
campaigns' small KernelConfig, the node's shape on the CPU; the card run
is chip_smoke.py's); one
backup -> wipe -> restore drill through a blobstore:// container must
restore the keyspace byte for byte. No fallback: a node asked for a card
engine where there is no card exits at boot and the launch fails."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(*args, timeout=220):
    return subprocess.run(
        [sys.executable, "-m", "foundationdb_tpu_torch.real.cluster", "--procs", "4", *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def _ok(r, marker):
    assert r.returncode == 0, f"stdout:\n{r.stdout[-3000:]}\nstderr:\n{r.stderr[-2000:]}"
    assert marker in r.stdout


@pytest.mark.timeout(240)
@pytest.mark.parametrize("engine", [
    ["--engine", "oracle"],
    ["--engine", "native"],
    ["--engine", "torch", "--device", "cpu"],
])
def test_real_cluster_cycle(engine):
    _ok(launch("--keys", "20", "--txns", "30", *engine), "REAL CLUSTER OK")


@pytest.mark.timeout(240)
def test_real_cluster_backup_restore_blobstore():
    _ok(launch("--backup", "--engine", "oracle"),
        "backup->wipe->restore via blobstore verified")


@pytest.mark.timeout(120)
def test_card_engine_without_a_card_fails_the_launch():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    r = launch("--keys", "4", "--txns", "2", timeout=100)
    assert r.returncode == 1
    assert "exited while booting" in r.stdout, r.stdout[-2000:]


def test_node_engine_factories():
    from foundationdb_tpu_torch.ops.native_engine import NativeConflictEngine
    from foundationdb_tpu_torch.ops.oracle import OracleConflictEngine
    from foundationdb_tpu_torch.real import node

    assert node.ENGINE_KINDS == ("auto", "torch", "device_loop", "native", "oracle")
    assert node.make_engine_factory("oracle") is OracleConflictEngine
    assert node.make_engine_factory("native") is NativeConflictEngine
    eng = node.make_engine_factory("torch", "cpu")()
    assert eng.device.type == "cpu" and eng.cfg.capacity == 1024
    assert node.kernel_config().capacity == node.kernel_config("cuda").capacity == 65536
    with pytest.raises(ValueError):
        node.make_engine_factory("jax")
    if not torch.cuda.is_available():
        for kind in ("auto", "torch", "device_loop"):
            with pytest.raises(RuntimeError, match="--device cpu"):
                node.make_engine_factory(kind)
            with pytest.raises(RuntimeError, match="--device cpu"):
                node.make_engine_factory(kind, "cuda")
