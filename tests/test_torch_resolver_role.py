"""The port's resolver role and its pipelined service against the JAX
package's, inside each package's simulator.

  * tests/test_resolver_pipeline.py's drive_resolver_role (BUGGIFY'd
    arrival jitter, duplicate deliveries, a kill and restart mid-window) at
    depth None / 1 / 2 / 3, with and without the kill: the port's role over
    the port's oracle and the JAX role over the JAX oracle give equal reply
    dicts, byte-identical journals, equal role counters and an equal
    simulation random stream afterwards; every depth equals the serial
    role;
  * the port's role over a CPU TorchConflictEngine at a small KernelConfig
    (and over a CPU DeviceLoopEngine at depth 2 in the service's
    device_loop mode) against the JAX role over JaxConflictEngine at the
    same config: equal replies;
  * the engine draws nothing from the simulation's random stream: the
    port's role over its oracle and over a CPU TorchConflictEngine leave
    identical replies and an identical rng state;
  * engine_health key sets, resolution_metrics, and the role's and the
    service's span names and virtual times with spans on;
  * the replay window: a duplicate is answered from it, never resolved
    twice; a version GC'd from it is a typed error; the rebalance handoff's
    synthetic write and an engine fault's typed wrapping behave as in the
    JAX role.

Verdicts are exact: tolerance 0 everywhere.
"""
import dataclasses

import pytest
import torch

from foundationdb_tpu.ops.conflict_kernel import KernelConfig
from foundationdb_tpu.ops.host_engine import JaxConflictEngine
from foundationdb_tpu_torch.ops import conflict_kernel as tck
from foundationdb_tpu_torch.ops import fixpoint_cuda as fc
from foundationdb_tpu_torch.ops.device_loop import DeviceLoopEngine
from foundationdb_tpu_torch.ops.host_engine import TorchConflictEngine
from torch_sim_world import JAX, PORT, clean_world, drive_resolver_role, journal_bytes

torch.set_num_threads(1)

SMALL = KernelConfig(key_words=2, capacity=1024, max_reads=64, max_writes=64, max_txns=32)
#: the JAX engines' compiled programs, built once for the module: a program
#: takes the table as an argument, so engines of one config can share them
_JAX_PROGRAMS = {}


def port_cfg(cfg):
    fields = dataclasses.asdict(cfg)
    fields.pop("fixpoint")
    return tck.KernelConfig(**fields)


def torch_engine():
    return TorchConflictEngine(port_cfg(SMALL), device="cpu")


def loop_engine():
    return DeviceLoopEngine(port_cfg(SMALL), device="cpu")


def jax_engine():
    eng = JaxConflictEngine(SMALL)
    eng._programs = _JAX_PROGRAMS
    return eng


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def run(P, depth, kill_at=None, tmp=None, **kw):
    replies, roles, sim = drive_resolver_role(P, depth, kill_at=kill_at, journal_dir=tmp, **kw)
    state = (sim.sched.rng.random01(), sim.sched.time, sim.sched.tasks_run)
    stats = [r.stats.as_dict() for r in roles]
    clean_world()
    return replies, state, stats


@pytest.mark.parametrize("kill_at", [None, 6], ids=["steady", "kill6"])
@pytest.mark.parametrize("depth", [None, 1, 2, 3], ids=lambda d: f"depth{d}")
def test_role_over_oracles_equal_jax(depth, kill_at, tmp_path):
    got = run(PORT, depth, kill_at, tmp_path / "port")
    want = run(JAX, depth, kill_at, tmp_path / "jax")
    assert got == want
    assert journal_bytes(tmp_path / "port") == journal_bytes(tmp_path / "jax")
    assert journal_bytes(tmp_path / "port")
    # every depth gives the serial role's verdicts
    assert got[0] == run(PORT, None, kill_at)[0]
    # every distinct version resolved once by its role; duplicates from
    # the replay window
    resolved = sum(s["batches_resolved"] for s in got[2])
    assert resolved >= len(got[0])
    if kill_at is None:
        assert got[2][0]["batches_resolved"] == len(got[0])


@pytest.mark.parametrize("depth,kill_at,range_every", [(None, None, 5), (2, None, 0), (3, 6, 0)],
                         ids=["serial-ranges", "depth2", "depth3-kill6"])
def test_role_over_engines_equal_jax(depth, kill_at, range_every):
    """The port's role over CPU TorchConflictEngines against the JAX role
    over JaxConflictEngines at the same KernelConfig (range rows take the
    general router in both), and both against the port's oracle role."""
    kw = dict(range_every=range_every)
    got = run(PORT, depth, kill_at, engine_factory=torch_engine, **kw)
    want = run(JAX, depth, kill_at, engine_factory=jax_engine, **kw)
    assert got[0] == want[0]
    assert got == run(PORT, depth, kill_at, **kw)


def test_loop_engine_role_equals_the_oracle_role():
    """The port's DeviceLoopEngine behind the service's device_loop mode
    gives the oracle role's replies, rng state and counters."""
    kw = dict(dispatch_mode="device_loop", queue_enqueue_ms=0.1, result_drain_ms=0.05)
    assert run(PORT, 2, engine_factory=loop_engine, **kw) == run(PORT, 2, **kw)


@pytest.mark.parametrize("depth", [None, 2])
def test_engine_draws_nothing_from_the_sim_rng(depth):
    """Same seed, oracle engine or card-family engine on the CPU: identical
    replies, an identical rng state and identical virtual time after the
    run, so a card role and a CPU role take the same buggify decisions."""
    assert run(PORT, depth, engine_factory=torch_engine) == run(PORT, depth)


# ---------------------------------------------------------------------------
# health, metrics and spans
# ---------------------------------------------------------------------------

def health_and_metrics(P, engine_factory=None, depth=2):
    """Drive a short stream through a role, then ask it for its health and
    resolution metrics over the network, as the ratekeeper does."""
    from torch_sim_world import make_batches

    sim = P.simulator.Simulator(17)
    proc, client = sim.new_process("res"), sim.new_process("rk")
    pipeline = P.pipeline.PipelineConfig(depth=depth, pack_ms_per_txn=0.01,
                                         device_ms_by_bucket={8: 0.2, 16: 0.3, 32: 0.5})
    engine = (engine_factory or P.oracle.OracleConflictEngine)()
    res = P.resolver.Resolver(proc, engine, pipeline=pipeline)
    prev = 0
    for txns, v, _ in make_batches(P, 5, n_batches=6):
        req = P.messages.ResolveTransactionBatchRequest(prev_version=prev, version=v,
                                                        last_received_version=prev,
                                                        transactions=txns)
        prev = v
        sim.sched.spawn(res.resolve_batch(req))
    sim.run(until=5.0)
    ep = P.network.Endpoint
    health = sim.run_until(sim.net.request(client.address, ep(proc.address, res.health_token),
                                           None), until=10.0)
    metrics = sim.run_until(sim.net.request(client.address, ep(proc.address, res.metrics_token),
                                            None), until=15.0)
    again = sim.run_until(sim.net.request(client.address, ep(proc.address, res.metrics_token),
                                          None), until=20.0)
    clean_world()
    return health, metrics, again


def test_health_and_metrics_equal_jax():
    got, want = health_and_metrics(PORT), health_and_metrics(JAX)
    assert got == want
    health, metrics, again = got
    assert {"state", "degraded", "resolve_errors", "target_batch_txns", "telemetry"} <= set(health)
    assert metrics["rows"] > 0 and len(metrics["sample"]) > 0
    assert again == {"rows": 0, "sample": []}


def test_health_key_sets_over_engines_equal_jax():
    """Over the engines, the health fragment has the JAX role's keys, its
    telemetry the same sections with the same keys (the port's engine perf
    adds two counters); the state bytes are
    the engine's table (the port reads its engine's state, not its
    torch.device); the metrics are equal."""
    got = health_and_metrics(PORT, torch_engine)
    want = health_and_metrics(JAX, jax_engine)
    assert set(got[0]) == set(want[0])
    assert {"state_bytes", "state_memory_pressure", "telemetry"} <= set(got[0])
    tel, jtel = got[0]["telemetry"], want[0]["telemetry"]
    assert set(tel) == set(jtel)
    for section in tel:
        if isinstance(tel[section], dict):
            # EnginePerf of the port also counts its graph captures and merges
            extra = {"captures", "merges"} if section == "engine_perf" else set()
            assert set(tel[section]) == set(jtel[section]) | extra, section
    assert got[0]["state_bytes"] > 0
    assert got[1:] == want[1:]


def spans_of(P, depth, dispatch_mode="step"):
    P.trace.g_spans.clear()
    P.trace.g_spans.enabled = True
    kw = (dict(dispatch_mode=dispatch_mode, queue_enqueue_ms=0.1, result_drain_ms=0.05)
          if depth else {})
    drive_resolver_role(P, depth, **kw)
    spans = [dict(s) for s in P.trace.g_spans.spans]
    clean_world()
    return spans


@pytest.mark.parametrize("depth,mode", [(None, "step"), (2, "step"), (3, "device_loop")])
def test_service_spans_equal_jax(depth, mode):
    """With spans on, the role's and the service's spans — names, trace ids
    (the batch versions), virtual begin and end, details — equal the JAX
    package's span for span."""
    got, want = spans_of(PORT, depth, mode), spans_of(JAX, depth, mode)
    assert got == want
    names = {s["Name"] for s in got}
    assert "resolver.queue_wait" in names
    if depth:
        assert {"resolver.host_pack", "resolver.pipeline_wait", "resolver.force"} <= names
        assert ("resolver.device_resident" if mode == "device_loop"
                else "resolver.device_dispatch") in names



def service(P, **kw):
    return P.pipeline.PipelinedResolverService(
        P.pipeline.PipelineConfig(depth=2, max_batch_txns=32,
                                  device_ms_by_bucket={8: 0.25, 16: 0.5, 32: 1.0}, **kw),
        P.oracle.OracleConflictEngine())


@pytest.mark.parametrize("n_txns,ms", [(1, 0.25), (8, 0.25), (9, 0.5), (32, 1.0), (33, 1.25),
                                       (64, 2.0), (100, 3.25)])
def test_device_ms_charges_each_chunk(n_txns, ms):
    """The injected device time of a batch: up to max_batch_txns (the
    engine's chunk) its bucket's per-chunk figure, as in JAX's service;
    above it, one top figure per full chunk plus its remainder's bucket."""
    assert service(PORT)._device_ms(n_txns) == ms
    if n_txns <= 32:
        assert service(JAX)._device_ms(n_txns) == ms


@pytest.mark.parametrize("mode", ["mesh", "loop"])
def test_service_refuses_a_dispatch_mode_it_lacks(mode):
    """The port's service serves "step" and "device_loop" only: a mode
    it has no path for raises rather than running as another."""
    assert {service(PORT, dispatch_mode=m).cfg.dispatch_mode
            for m in PORT.pipeline.service.DISPATCH_MODES} == {"step", "device_loop"}
    with pytest.raises(ValueError, match="dispatch_mode"):
        service(PORT, dispatch_mode=mode)


# ---------------------------------------------------------------------------
# the role's edge paths
# ---------------------------------------------------------------------------

def edge_paths(P):
    """Replay window GC, the rebalance handoff's synthetic write, and the
    typed wrapping of an engine fault, on one role."""
    T = P.types
    sim = P.simulator.Simulator(23)
    P.buggify.disable()
    proc = sim.new_process("res")
    calls = []

    class Recording(P.oracle.OracleConflictEngine):
        fail_at = None

        def resolve(self, txns, now, new_oldest):
            calls.append((now, new_oldest, [(t.read_snapshot, [(r.begin, r.end) for r in
                                                               t.write_conflict_ranges])
                                            for t in txns]))
            if now == self.fail_at:
                raise RuntimeError("device lost")
            return super().resolve(txns, now, new_oldest)

    eng = Recording()
    res = P.resolver.Resolver(proc, eng, index=1)
    out = []

    def txn(key, snap):
        t = T.CommitTransaction(read_snapshot=snap)
        t.read_conflict_ranges.append(T.KeyRange(key, key + b"\x00"))
        t.write_conflict_ranges.append(T.KeyRange(key, key + b"\x00"))
        return t

    async def go():
        life = T.MAX_WRITE_TRANSACTION_LIFE_VERSIONS
        req = P.messages.ResolveTransactionBatchRequest
        r1 = await res.resolve_batch(req(prev_version=0, version=10, last_received_version=0,
                                         transactions=[txn(b"b", 5)]))
        # a live rebalance flip: this resolver gains [m, \xff\xff\xff\xff\xff)
        r2 = await res.resolve_batch(req(prev_version=10, version=20, last_received_version=10,
                                         transactions=[txn(b"q", 15), txn(b"c", 15)],
                                         routing_version=20, routing_old_splits=(b"x",),
                                         routing_splits=(b"m",)))
        dup = await res.resolve_batch(req(prev_version=0, version=10, last_received_version=0,
                                          transactions=[]))
        r3 = await res.resolve_batch(req(prev_version=20, version=20 + 2 * life,
                                         last_received_version=20, transactions=[txn(b"b", 25)]))
        out.append(([int(v) for v in r1.committed], [int(v) for v in r2.committed],
                    dup is r1, [int(v) for v in r3.committed]))
        try:
            await res.resolve_batch(req(prev_version=0, version=10, last_received_version=0,
                                        transactions=[]))
        except P.error.FDBError as e:
            out.append(("gc'd", e.code, e.name))
        eng.fail_at = 30 + 2 * life
        try:
            await res.resolve_batch(req(prev_version=20 + 2 * life, version=30 + 2 * life,
                                        last_received_version=0, transactions=[txn(b"z", 1)]))
        except P.error.FDBError as e:
            out.append(("fault", e.code, e.name))

    sim.run_until(sim.sched.spawn(go()), until=5.0)
    out.append(calls)
    out.append(res.stats.as_dict())
    out.append(P.resolver.gained_ranges((b"x",), (b"m",), 1))
    clean_world()
    return out


def test_edge_paths_equal_jax():
    got = edge_paths(PORT)
    assert got == edge_paths(JAX)
    assert got[1] == ("gc'd", 1207, "please_reboot")
    assert got[2] == ("fault", 1207, "please_reboot")
    # the engine saw the synthetic whole-span write over the gained span
    # first at the flip, and the reply dropped its verdict
    assert got[5] == [(b"m", b"x")]
    assert got[3][1][2][0] == (20, [(b"m", b"x")]) and len(got[0][1]) == 2
    assert got[4]["resolve_errors"] == 1


def test_chip_smoke_drive_role_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's role phase pieces at a small size with CPU engines
    (the card's sync-debug and synchronize calls stubbed): drive_role over
    the network, journal_read_back, oracle_replay and check_role_run hold
    the serial, the depth-2 and the kill/restart runs to the oracle replay,
    a record the journal shed included; the read-back flags a record on
    disk whose transactions differ from the ring's; the only check that
    fails here is the card's kernel-launch count."""
    import numpy as np

    import chip_smoke as cs

    failed = []
    monkeypatch.setattr(cs, "check", lambda cond, msg: cond or failed.append(msg))
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    cfg = tck.KernelConfig(key_words=4, capacity=16384, max_txns=256, max_reads=16,
                           max_writes=16, max_point_reads=512, max_point_writes=512)
    engines = [TorchConflictEngine(cfg, device="cpu", ladder=(32, 64, 128), scan_sizes=(2, 4))
               for _ in range(2)]
    batches = cs.columnar_traffic(np.random.default_rng(7), [20, 60, 300, 120, 700], {3: 90},
                                  step=cs.role_version_step())
    pipeline = PORT.pipeline.PipelineConfig(depth=2, pack_ms_per_txn=0.001,
                                            device_ms_by_bucket={32: 1.0, 64: 1.5, 128: 2.0})
    runs = []
    for label, kw in (("serial", {}), ("depth2", {"pipeline": pipeline}),
                      ("restart", {"pipeline": pipeline, "kill_at": 2, "engine2": engines[1]})):
        for e in engines:
            e.base = e.oldest_version = 0
            e.clear(0)
        run = cs.drive_role(fc, engines[0], batches, tmp_path / label, label, **kw)
        mismatches, horizons, shed = cs.replay_and_check(run)
        assert mismatches == 0 and len(horizons) >= 5
        run["shed"] = shed
        runs.append(run)
        clean_world()
    assert set(failed) == {f"{label}: 0 kernel launches, 0 plain fixpoints on CUDA tensors"
                           for label in ("serial", "depth2", "restart")}
    assert runs[2]["answered_by"][batches[-1][1]] == 1
    # buggify's short journal write sheds a record in this stream: the
    # replay reads it from the journal's ring, the disk's gap is accounted
    assert sum(r["shed"] for r in runs) >= 1
    assert runs[0]["replies"] == runs[1]["replies"]
    ring = runs[1]["journal"]["batches"]
    disk, differ = cs.journal_read_back(runs[1]["journal_dir"], ring)
    assert not differ and sum(map(len, disk.values())) == len(ring) - runs[1]["shed"]
    proc, b = next((p, b) for p, b in ring
                   if b.version in {v for v, _, _ in disk[p]} and len(b.txns) > 1)
    altered = [(p, dataclasses.replace(x, txns=list(x.txns)[1:]) if x is b else x)
               for p, x in ring]
    assert cs.journal_read_back(runs[1]["journal_dir"], altered)[1] == {proc: [b.version]}
    # drive_role's wrappers are gone again
    assert not any("resolve" in vars(e) or "columnar_dispatch" in vars(e) for e in engines)
