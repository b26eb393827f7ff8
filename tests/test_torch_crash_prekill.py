"""The crash campaign's pre-kill window in the port against the reference.

The port keeps the load running past `warm_s` until the child's status
shows a written snapshot (`real/nemesis.py` `_serve_until_snapshot`,
bounded by `boot_timeout_s`), so that on a slow host the kill never comes
before the first snapshot. Where the first status after `warm_s` already
shows one, the port's campaign runs the reference's sequence exactly.
These tests drive `_crash_campaign` of both packages up to the kill, with
the child, the network, the load and the status RPC stubbed, and record
every sleep, status RPC and the kill in order.
"""
import asyncio

import pytest

from foundationdb_tpu.real import cluster as jcluster
from foundationdb_tpu.real import monitor as jmonitor
from foundationdb_tpu.real import nemesis as jnem
from foundationdb_tpu_torch.real import cluster as tcluster
from foundationdb_tpu_torch.real import monitor as tmonitor
from foundationdb_tpu_torch.real import nemesis as tnem

from torch_sim_world import clean_world

SNAPPED = {"committed_version": 5200, "snapshots": {"written": 1, "bytes": 2120, "errors": 0}}
UNSNAPPED = {"committed_version": 3100, "snapshots": {"written": 0, "bytes": 0, "errors": 0}}


@pytest.fixture(autouse=True)
def clean():
    clean_world()
    yield
    clean_world()


class Killed(Exception):
    """Raised by the stub child's kill(): the campaign stops there."""


def stub_campaign(monkeypatch, nem, cluster, monitor, statuses, log):
    """Stub everything `nem._crash_campaign` touches before the kill. The
    status RPC answers from `statuses` in order (the last one repeats);
    `log` gets ("sleep", s), ("rpc", token) and ("kill",) in order."""
    answers = list(statuses)
    real_sleep = asyncio.sleep

    async def sleep(s, *a, **kw):
        log.append(("sleep", s))
        await real_sleep(0)

    async def child_rpc(port, token, timeout_s=1.5):
        log.append(("rpc", token))
        return dict(answers.pop(0) if len(answers) > 1 else answers[0])

    async def no_load(*a, **kw):
        return None

    class Proc:
        def kill(self):
            log.append(("kill",))
            raise Killed

    class Child:
        def __init__(self, name, argv):
            self.proc, self.restarts, self.backoff = Proc(), 0, 0.0

        def spawn(self, log_dir):
            pass

        def stop(self):
            pass

    class Net:
        def __init__(self, name=None):
            pass

        def close(self):
            pass

    monkeypatch.setattr(nem.asyncio, "sleep", sleep)
    monkeypatch.setattr(nem, "_child_rpc", child_rpc)
    monkeypatch.setattr(nem, "_crash_load", no_load)
    monkeypatch.setattr(nem, "RealNetwork", Net)
    monkeypatch.setattr(cluster, "free_ports", lambda n: [45999])
    monkeypatch.setattr(monitor, "Child", Child)


def run_to_kill(monkeypatch, pkg, statuses, tmp_path):
    nem, cluster, monitor = {"jax": (jnem, jcluster, jmonitor),
                             "torch": (tnem, tcluster, tmonitor)}[pkg]
    log = []
    with monkeypatch.context() as m:
        stub_campaign(m, nem, cluster, monitor, statuses, log)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        cfg = nem.CrashConfig(seed=29, engine_mode="torch", datadir=str(tmp_path / pkg),
                              warm_s=2.0, post_s=1.0, **kw)
        with pytest.raises(Killed):
            asyncio.run(nem._crash_campaign(cfg))
    return log


def test_snapshot_within_warm_s_runs_the_reference_sequence_in_both_packages(
        monkeypatch, tmp_path):
    # the child answers at boot, then shows a written snapshot at warm_s
    statuses = [SNAPPED]
    want = [("rpc", jnem.STATUS_TOKEN), ("sleep", 2.0), ("rpc", jnem.STATUS_TOKEN), ("kill",)]
    assert run_to_kill(monkeypatch, "jax", statuses, tmp_path) == want
    assert run_to_kill(monkeypatch, "torch", statuses, tmp_path) == want
    assert tnem.STATUS_TOKEN == jnem.STATUS_TOKEN


def test_late_snapshot_keeps_serving_in_the_port_where_the_reference_kills(
        monkeypatch, tmp_path):
    # boot, then two statuses without a snapshot, then one with it
    statuses = [UNSNAPPED, UNSNAPPED, UNSNAPPED, SNAPPED]
    token = jnem.STATUS_TOKEN
    jax_log = run_to_kill(monkeypatch, "jax", statuses, tmp_path)
    torch_log = run_to_kill(monkeypatch, "torch", statuses, tmp_path)
    assert jax_log == [("rpc", token), ("sleep", 2.0), ("rpc", token), ("kill",)]
    assert torch_log == [("rpc", token), ("sleep", 2.0), ("rpc", token),
                         ("sleep", 0.1), ("rpc", token), ("sleep", 0.1), ("rpc", token),
                         ("kill",)]


def test_serve_until_snapshot_polls_the_status_until_one_is_written(monkeypatch):
    answers = [UNSNAPPED, UNSNAPPED, SNAPPED]
    calls = []

    async def child_rpc(port, token, timeout_s=1.5):
        calls.append((port, token))
        return dict(answers.pop(0))

    monkeypatch.setattr(tnem, "_child_rpc", child_rpc)
    st, extra = asyncio.run(tnem._serve_until_snapshot(45999, dict(UNSNAPPED), 5.0,
                                                       poll_s=0.01))
    assert st == SNAPPED and calls == [(45999, tnem.STATUS_TOKEN)] * 3
    assert 0.0 < extra < 5.0


def test_serve_until_snapshot_returns_at_once_when_one_is_written(monkeypatch):
    async def child_rpc(port, token, timeout_s=1.5):
        raise AssertionError("no status RPC past the window when a snapshot is written")

    monkeypatch.setattr(tnem, "_child_rpc", child_rpc)
    st, extra = asyncio.run(tnem._serve_until_snapshot(45999, dict(SNAPPED), 5.0))
    assert st == SNAPPED and extra < 0.05


def test_serve_until_snapshot_gives_up_at_its_bound(monkeypatch):
    calls = []

    async def child_rpc(port, token, timeout_s=1.5):
        calls.append(token)
        return None         # a dead or silent child

    monkeypatch.setattr(tnem, "_child_rpc", child_rpc)
    st, extra = asyncio.run(tnem._serve_until_snapshot(45999, {}, 0.2, poll_s=0.02))
    assert st == {} and calls and 0.2 <= extra < 2.0
    assert not tnem._snapshot_written(st)
