"""The port's wall-clock chaos (foundationdb_tpu_torch/real/chaos.py,
workload.py, nemesis.py) against the JAX package's: with the same seed the
network nemesis, the chaos transport, the disk nemesis and the Zipf
samplers take the same decisions; the port passes tests/test_real_chaos.py's
unit cases and its fast oracle campaign, held to its invariants (journal
parity, injected faults, failover and swap-back, the supervised child's
restart), not to a latency."""
import asyncio

import pytest

from torch_sim_world import BOTH, JAX, PORT, both, clean_world


@pytest.fixture(autouse=True)
def _clean():
    clean_world()
    yield
    clean_world()


def run(coro):
    return asyncio.run(coro)


CONFIGS = [None, dict(latency_prob=0.2, latency_ms=3.0, drop_prob=0.1, reset_prob=0.05,
                      handshake_stall_prob=0.3)]


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
@pytest.mark.parametrize("seed", [1, 11, 2026])
def test_network_nemesis_decisions_equal_jax(seed, cfg):
    def case(P):
        c = P.chaos.ChaosConfig(**CONFIGS[cfg]) if CONFIGS[cfg] else None
        nem = P.chaos.NetworkNemesis(seed, c)
        out = [nem.decide(f"client-{i % 3}", "server") for i in range(3000)]
        return out, P.telemetry.hub().chaos_counts()

    port, jax = both(case)
    assert port == jax
    assert any(d is not None for d in port[0])


def test_handshake_stall_decisions_equal_jax():
    def case(P):
        nem = P.chaos.NetworkNemesis(5, P.chaos.ChaosConfig(handshake_stall_prob=0.4,
                                                            stall_s=0.0))
        nem.partition("c1", "server", duration_s=3600.0)

        async def go():
            out = []
            for i in range(200):
                try:
                    await nem.on_connect(f"c{i % 3}", "server")
                    out.append("ok")
                except P.error.FDBError as e:
                    out.append(e.name)
            return out

        return run(go()), [(w["kind"], w["src"], w["dst"]) for w in nem.windows]

    port, jax = both(case)
    assert port == jax
    assert "connection_failed" in port[0] and len(port[1]) > 1


def test_chaos_transport_outcomes_equal_jax():
    """Sequential requests through a ChaosTransport over a loopback echo:
    the same seed gives the same outcome per request and the same
    suffered counts."""
    def case(P):
        async def go():
            proc = P.transport.RealProcess()

            async def ping(body):
                return body

            proc.register("t.ping", ping)
            await proc.start()
            nem = P.chaos.NetworkNemesis(7, P.chaos.ChaosConfig(
                latency_prob=0.1, latency_ms=1.0, drop_prob=0.1, reset_prob=0.1,
                handshake_stall_prob=0.0, drop_detect_s=0.0))
            t = P.chaos.ChaosTransport(P.transport.RealNetwork(), nem, name="client")
            ep = P.network.Endpoint(proc.address, "t.ping")
            out = []
            try:
                for i in range(60):
                    try:
                        out.append(await t.request("c", ep, i, timeout=2.0))
                    except P.error.FDBError as e:
                        out.append(e.name)
            finally:
                t.close()
                await proc.stop()
            return out, dict(t.suffered)

        return run(go())

    port, jax = both(case)
    assert port == jax
    assert set(port[1]) >= {"dropped", "reset"} or len(port[1]) >= 2


def test_disk_nemesis_decisions_equal_jax():
    def case(P):
        rates = P.inject.DiskFaultRates(stall=0.1, stall_ms=0.0, torn=0.1, enospc=0.05,
                                        rot=0.1)
        dn = P.chaos.DiskNemesis(3, rates=rates, surface_rates={
            "journal": P.inject.DiskFaultRates(stall=0.2, stall_ms=0.0)})
        out = []
        for i in range(300):
            surface = ("journal", "snapshot", "progcache")[i % 3]
            try:
                out.append(dn.apply(surface, b"payload-%03d" % i))
            except Exception as e:  # noqa: BLE001 — the fault kind is the outcome
                out.append(type(e).__name__)
        return out, dn.summary(), [(w["kind"], w["surface"]) for w in dn.windows]

    port, jax = both(case)
    assert port == jax
    assert sum(port[1]["injected"].values()) > 0


@pytest.mark.parametrize("s,drift", [(0.0, 0.0), (0.9, 0.0), (1.2, 3.5)])
def test_zipf_sampler_draws_equal_jax(s, drift):
    def case(P):
        w = P.real_workload
        smp = w.ZipfKeySampler(512, s, P.rng.DeterministicRandom(7), drift=drift)
        return w.zipf_cdf(100, s), [smp.sample(t_rel=i * 0.01) for i in range(2000)]

    port, jax = both(case)
    assert port == jax


def test_partition_heal_and_asymmetry():
    P = PORT

    async def go():
        proc = P.transport.RealProcess()

        async def ping(body):
            return body

        proc.register("t.ping", ping)
        await proc.start()
        quiet = P.chaos.ChaosConfig(latency_prob=0, drop_prob=0, reset_prob=0,
                                    handshake_stall_prob=0)
        nem = P.chaos.NetworkNemesis(1, quiet)
        a = P.chaos.ChaosTransport(P.transport.RealNetwork(), nem, name="client-a")
        b = P.chaos.ChaosTransport(P.transport.RealNetwork(), nem, name="client-b")
        ep = P.network.Endpoint(proc.address, "t.ping")
        try:
            assert await a.request("a", ep, 1) == 1
            nem.partition("client-a", proc.address, duration_s=3600.0)
            with pytest.raises(P.error.FDBError) as ei:
                await a.request("a", ep, 2, timeout=1.0)
            assert ei.value.code == P.error.connection_failed("").code
            assert await b.request("b", ep, 3) == 3
            nem.heal("client-a", proc.address)
            assert await a.request("a", ep, 4) == 4
            assert a.suffered.get("partitioned", 0) >= 1
            assert any(w["kind"] == "partition" for w in nem.windows)
            assert P.telemetry.hub().chaos_counts().get("partition") == 1
        finally:
            a.close()
            b.close()
            await proc.stop()

    run(go())


def test_chaos_status_lines_and_degraded_signals():
    P = PORT
    hub = P.telemetry.hub()
    hub.chaos_event("partition", src="a", dst="b", seconds=0.5)
    hub.chaos_event("reset", src="a", dst="b")
    hub.chaos_event("reset", src="c", dst="b")
    lines = "\n".join(P.chaos.chaos_status_lines())
    assert "partition" in lines and "reset" in lines
    assert hub.chaos_counts() == {"partition": 1, "reset": 2}
    P.telemetry.reset()
    assert "no nemesis activity" in P.chaos.chaos_status_lines()[0]
    sim = P.simulator.Simulator(5)
    try:
        flag = {"v": False}
        srv = P.nemesis.ChaosCommitServer(sim.sched, engine_mode="oracle",
                                          transport_degraded_fn=lambda: flag["v"])
        assert not srv.degraded
        flag["v"] = True
        assert srv.degraded
        flag["v"] = False
        srv.engine.state = "failed"
        assert srv.degraded
    finally:
        P.loop.set_scheduler(None)


def test_chaos_engine_modes():
    """make_chaos_engine takes the port's modes: oracle, and torch /
    device_loop / mesh on an explicit device; the JAX package's "jax" is
    an unknown mode."""
    import torch

    PORT.simulator.Simulator(3)   # the supervisor draws its seed from the scheduler
    inner, _inj, sup = PORT.nemesis.make_chaos_engine("oracle")
    assert type(inner).__name__ == "OracleConflictEngine"
    torch.set_num_threads(1)
    for mode, cls in (("torch", "TorchConflictEngine"), ("device_loop", "DeviceLoopEngine"),
                      ("mesh", "MeshShardedConflictEngine")):
        inner, _inj, sup = PORT.nemesis.make_chaos_engine(mode, device="cpu")
        assert type(inner).__name__ == cls and inner.cfg.max_txns == 64
    for mode in ("jax", "sharded"):
        with pytest.raises(ValueError, match="unknown chaos engine mode"):
            PORT.nemesis.make_chaos_engine(mode)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PORT.nemesis.make_chaos_engine("torch")


def test_journal_parity_helper_detects_mismatch():
    T = PORT.types
    txn = T.CommitTransaction(read_snapshot=0,
                              read_conflict_ranges=[T.KeyRange(b"k", b"k\x00")],
                              write_conflict_ranges=[T.KeyRange(b"k", b"k\x00")])
    want = [int(v) for v in PORT.oracle.OracleConflictEngine().resolve([txn], 100, 0)]
    assert PORT.nemesis.replay_journal_parity([(100, (txn,), 0, tuple(want))]) == (1, 0)
    assert PORT.nemesis.replay_journal_parity(
        [(100, (txn,), 0, tuple(1 - v for v in want))]) == (1, 1)


@pytest.mark.timeout(120)
def test_port_fast_seed_campaign(tmp_path):
    """tests/test_real_chaos.py's tier-1 seed on the port's stack with the
    oracle engine, the trace export on: a partition, a process
    kill/restart and a forced device failover/swap-back under Zipfian
    load over real sockets; the journal replays bit-identical through a
    clean oracle and the Chrome trace validates."""
    import json

    path = str(tmp_path / "trace.json")
    cfg = PORT.nemesis.NemesisConfig(seed=11, engine_mode="oracle", duration_s=3.5,
                                     budget_ms=250.0, trace_export=path)
    rep = PORT.nemesis.run_campaign(cfg)
    assert rep.parity_checked > 0 and rep.parity_mismatches == 0
    assert rep.chaos_counts.get("partition", 0) >= 1
    assert rep.chaos_counts.get("device_fault_window", 0) >= 1
    assert rep.chaos_counts.get("process_kill", 0) >= 1
    assert rep.engine_stats.get("failovers", 0) >= 1
    assert rep.engine_stats.get("swap_backs", 0) >= 1
    assert rep.child_restarts >= 1
    assert rep.counts["committed"] > 50
    tr = rep.traces
    assert tr and tr["n_waterfalls"] > 100 and tr["retained"] >= 1
    with open(rep.trace_file) as f:
        doc = json.load(f)
    assert PORT.trace_export.validate_chrome_trace(doc) >= 1
    names = {ev["args"]["name"] for ev in doc["traceEvents"] if ev.get("ph") == "M"}
    assert "nemesis" in names and "server" in names
