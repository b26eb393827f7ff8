"""The device-nemesis campaign and card engines in the dynamic cluster,
on both packages.

tests/test_device_nemesis.py's smoke test (DeviceNemesis at seeds 31-33:
machine kills, clogging and a resolver engine behind the seed-driven fault
injector under the supervisor) and its bsearch variant (the injector over
the device engine with history_search="bsearch"), run through the port's
run_spec and the JAX package's: the SpecResults (ok, metrics with the
supervisors' health counters and the journal replay's parity, seed,
virtual time) and what the simulation leaves behind (virtual time,
scheduler steps, rng state, disks, trace) must be equal. The device engine
is the port's TorchConflictEngine on the CPU against JaxConflictEngine at
the same KernelConfig. Then CycleTestAttrition with a port engine
recruited in every generation against the JAX engine.

Every compared value is a bool, an int, bytes, a string or a float computed
the same way in both packages: tolerance 0 (exact equality).
"""
import dataclasses
import importlib

import pytest
import torch

from torch_sim_world import JAX, PORT, both, clean_world, sims_built, world_state

torch.set_num_threads(1)

SMOKE_SEEDS = (31, 32, 33)
#: tests/test_device_nemesis.py's bsearch supervisor
SUPERVISOR = dict(dispatch_timeout=0.3, retry_budget=1, retry_backoff=0.05, probe_rate=0.1,
                  probation_batches=2, failover_min_batches=2)


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def device_engine(P, **kw):
    """The specs' KernelConfig on package P's device engine: the port's
    TorchConflictEngine on the CPU, the JAX package's JaxConflictEngine."""
    ck = importlib.import_module(f"{P.name}.ops.conflict_kernel")
    he = importlib.import_module(f"{P.name}.ops.host_engine")
    cfg = ck.KernelConfig(key_words=4, capacity=1024, max_reads=256, max_writes=256,
                          max_txns=64)
    if P is PORT:
        return he.TorchConflictEngine(cfg, device="cpu", **kw)
    return he.JaxConflictEngine(cfg, **kw)




def run(P, spec, seed):
    with sims_built(P) as sims:
        res = P.workload.run_spec(spec, seed)
    return dataclasses.astuple(res), world_state(P, sims[0])


def test_device_nemesis_smoke():
    """Three seeds: each spec passes with bit-identical abort sets in both
    packages and equal results; failover and swap-back each happen."""
    per_seed = []
    for seed in SMOKE_SEEDS:
        port, jax_ = both(lambda P: run(P, P.specs.SPECS["DeviceNemesis"](), seed))
        assert port[0][0], (f"replay: python -m foundationdb_tpu_torch.testing.runner "
                            f"--spec DeviceNemesis --seed {seed}")
        assert port == jax_
        per_seed.append(port[0][1])
    for m in per_seed:
        assert not m.get("parity_mismatches") and not m.get("engine_probe_mismatches"), m
        assert not m.get("flight_digest_mismatches"), m
    assert sum(m.get("engine_dispatch_faults", 0) for m in per_seed) > 0
    assert sum(m.get("engine_failovers", 0) for m in per_seed) >= 1
    assert sum(m.get("engine_swap_backs", 0) for m in per_seed) >= 1
    assert sum(m.get("flight_records", 0) for m in per_seed) > 0


def test_device_nemesis_bsearch_engine():
    """DeviceNemesis once with the injector over each package's device
    engine forced onto the bsearch history path: attrition, clogging and
    dispatch faults, the journal of every supervisor replayed through a
    clean oracle; the port's run equals JAX's."""
    def case(P):
        def factory():
            return P.fault.ResilientEngine(
                P.fault.FaultInjectingEngine(device_engine(P, history_search="bsearch")),
                P.fault.ResilienceConfig(**SUPERVISOR), record_journal=True)

        spec = P.specs.SPECS["DeviceNemesis"]()
        spec.dynamic.engine_factory = factory
        return run(P, spec, SMOKE_SEEDS[0])

    port, jax_ = both(case)
    res = port[0][1]
    assert port[0][0], res
    assert not res.get("parity_mismatches") and not res.get("engine_probe_mismatches"), res
    assert not res.get("flight_digest_mismatches"), res
    assert res.get("engine_dispatch_faults", 0) > 0
    assert port == jax_


def test_dynamic_spec_with_port_engines_on_cpu():
    """CycleTestAttrition with every recruited resolver the port's
    TorchConflictEngine on the CPU (make_engine_factory(device="cpu"))
    equals the JAX package's run with JaxConflictEngine at the same
    KernelConfig; a fresh engine is built in every generation."""
    built = {}

    def case(P):
        make = (PORT.specs.make_engine_factory(device="cpu") if P is PORT
                else JAX.specs._tpu_engine_factory)
        engines = built.setdefault(P.name, [])

        def factory():
            engines.append(make())
            return engines[-1]

        spec = P.specs.SPECS["CycleTestAttrition"]()
        spec.dynamic.engine_factory = factory
        return run(P, spec, 1)

    port, jax_ = both(case)
    assert port[0][0]
    assert port == jax_
    ported = built[PORT.name]
    assert len(ported) == len(built[JAX.name]) > 2
    assert {(type(e).__name__, e.device.type, e.cfg.max_txns) for e in ported} == \
        {("TorchConflictEngine", "cpu", 64)}
