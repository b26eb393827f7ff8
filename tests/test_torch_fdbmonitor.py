"""The port's fdbmonitor analog (foundationdb_tpu_torch/real/monitor.py),
tests/test_fdbmonitor.py's cases: the crash-loop counter and backoff of a
fast-crashing child, and a supervised 4-node port cluster that serves,
loses a node to a kill, gets it back from the monitor and serves again.
The monitor's conf names the engine; the nodes default to the card, so
the conf here names the oracle."""
import asyncio
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

import pytest

from torch_sim_world import JAX, PORT, clean_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    clean_world()
    yield
    clean_world()


@pytest.mark.timeout(60)
def test_crash_loop_counter_and_backoff(tmp_path, capsys):
    mon = PORT.monitor
    assert mon.INITIAL_BACKOFF == JAX.monitor.INITIAL_BACKOFF
    child = mon.Child("node.crashy", [sys.executable, "-c", "raise SystemExit(3)"])
    child.backoff = 0.1
    child.spawn(str(tmp_path))
    child.proc.wait(timeout=10)
    mon.poll_children([child], str(tmp_path))
    assert child.proc is None, "respawned hot with no backoff"
    assert child.crash_count == 1 and child.restart_at > 0
    out = capsys.readouterr().out
    assert "crash loop x1" in out and "restart in 0.1s" in out
    assert child.backoff == pytest.approx(0.2)
    mon.poll_children([child], str(tmp_path))
    assert child.proc is None and child.restarts == 0
    time.sleep(0.12)
    mon.poll_children([child], str(tmp_path))
    assert child.restarts == 1 and child.proc is not None
    child.proc.wait(timeout=10)
    mon.poll_children([child], str(tmp_path))
    assert child.crash_count == 2 and child.backoff == pytest.approx(0.4)
    assert "crash loop x2" in capsys.readouterr().out
    child.stop()
    stable = mon.Child("node.stable", [sys.executable, "-c", "import time; time.sleep(60)"])
    stable.spawn(str(tmp_path))
    try:
        stable.crash_count = 3
        stable.backoff = 8.0
        stable.started_at -= 100
        mon.poll_children([stable], str(tmp_path))
        assert stable.crash_count == 0 and stable.backoff == mon.INITIAL_BACKOFF
    finally:
        stable.stop()


def test_parse_conf_spawns_the_ports_node(tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text("[general]\ncoordinators = 127.0.0.1:1\ndatadir = %s\nworkers = 4\n\n"
                    "[node.4500]\ncc_priority = 0\n\n[node.4501]\nengine = native\n" % tmp_path)
    datadir, nodes = PORT.monitor.parse_conf(str(conf))
    jdatadir, jnodes = JAX.monitor.parse_conf(str(conf))
    assert datadir == jdatadir and list(nodes) == list(jnodes)
    for section, argv in nodes.items():
        assert argv[1:3] == ["-m", "foundationdb_tpu_torch.real.node"]
        # a section without an engine takes the node's default: the card
        # in the port ("auto"), JAX's native engine
        want = [("auto" if a == "native" and section == "node.4500" else a)
                for a in jnodes[section][3:]]
        assert argv[3:] == want
    assert nodes["node.4501"][-1] == "native"


def _wait_port(port, deadline, what):
    while True:
        assert time.time() < deadline, what
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1.0):
                return
        except OSError:
            time.sleep(0.3)


@pytest.mark.timeout(300)
def test_monitor_supervises_restarts_and_cluster_serves():
    ports = PORT.real_cluster.free_ports(4)
    coords = [f"127.0.0.1:{p}" for p in ports[:3]]
    tmp = tempfile.mkdtemp(prefix="fdb_tpu_mon_")
    conf = os.path.join(tmp, "cluster.conf")
    with open(conf, "w") as f:
        f.write(f"[general]\ncoordinators = {','.join(coords)}\ndatadir = {tmp}\n")
        f.write("workers = 4\nengine = oracle\n\n")
        for i, p in enumerate(ports):
            f.write(f"[node.{p}]\n" + (f"cc_priority = {i}\n" if i < 3 else "") + "\n")
    mon = subprocess.Popen(
        [sys.executable, "-m", "foundationdb_tpu_torch.real.monitor", "--conf", conf],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    try:
        deadline = time.time() + 120
        for p in ports:
            _wait_port(p, deadline, "nodes never came up")
        asyncio.run(PORT.real_cluster.client_main(coords, 10, 10))
        victim = ports[3]
        out = subprocess.run(["pkill", "-f", f"foundationdb_tpu_torch.real.node --port {victim}"],
                             capture_output=True)
        assert out.returncode == 0, "victim node process not found"
        _wait_port(victim, time.time() + 90, "monitor never restarted the node")
        asyncio.run(PORT.real_cluster.client_main(coords, 10, 10))
    finally:
        mon.send_signal(signal.SIGTERM)
        try:
            mon.wait(timeout=15)
        except subprocess.TimeoutExpired:
            mon.kill()
        for p in ports:
            subprocess.run(["pkill", "-f", f"foundationdb_tpu_torch.real.node --port {p}"],
                           capture_output=True)
