"""The port's spec runner against the JAX package's.

Every spec of the static cluster runs through the port's `run_spec` and
the JAX package's at seeds 1 and 2: the SpecResults (ok, metrics, seed,
virtual time) must be equal. `CycleTestCUDA` with the port's engine on
the CPU (`make_engine_factory(device="cpu")`) must equal JAX's
CycleTestTPU. The runner CLI lists and runs specs, those of the dynamic
cluster too (tests/test_torch_dynamic_specs.py holds each of them against
JAX's). Knob randomization draws the same values from both registries.

Every compared value is a bool, an int, a string or a float computed the
same way in both packages: tolerance 0 (exact equality).
"""
import dataclasses

import pytest

from torch_sim_world import JAX, PORT, both, clean_world, sims_built, world_state

#: the port's name of a spec -> the JAX package's
JAX_NAME = {"CycleTestCUDA": "CycleTestTPU"}
PORTED = sorted(n for n, make in PORT.specs.SPECS.items() if make().dynamic is None)


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def result(res):
    return dataclasses.astuple(res)


def run_both(name, seed):
    spec = PORT.specs.SPECS[name]()
    if name == "CycleTestCUDA":
        spec.cluster.engine_factory = PORT.specs.make_engine_factory(device="cpu")
    clean_world()
    port = PORT.workload.run_spec(spec, seed)
    clean_world()
    jax_ = JAX.workload.run_spec(JAX.specs.SPECS[JAX_NAME.get(name, name)](), seed)
    return port, jax_


def test_every_static_spec_is_ported():
    static = {n for n, make in JAX.specs.SPECS.items() if make().dynamic is None}
    assert {JAX_NAME.get(n, n) for n in PORTED} == static - {"CycleTestTPU8", "RandomReadWriteTPU8"}
    assert len(PORTED) == 12


@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("seed", [1, 2])
def test_spec_equals_jax(name, seed):
    port, jax_ = run_both(name, seed)
    assert port.ok, f"replay: python -m foundationdb_tpu_torch.testing.runner --spec {name} --seed {seed}"
    assert result(port) == result(jax_)


def test_cycle_test_cuda_builds_port_engines_on_cpu():
    built = []
    factory = PORT.specs.make_engine_factory(device="cpu")

    def counting():
        built.append(factory())
        return built[-1]

    spec = PORT.specs.SPECS["CycleTestCUDA"]()
    spec.cluster.engine_factory = counting
    res = PORT.workload.run_spec(spec, 3)
    assert res.ok
    assert [(type(e).__name__, e.device.type, e.cfg.max_txns) for e in built] == \
        [("TorchConflictEngine", "cpu", 64)] * 2


def test_make_engine_factory_defaults_to_the_card():
    import torch

    factory = PORT.specs.make_engine_factory()
    if torch.cuda.is_available():
        assert factory().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factory()


def test_dynamic_spec_is_refused():
    """A spec of the dynamic cluster is no longer refused: run_spec builds
    a DynamicCluster and the run equals JAX's, disks and trace included."""
    def case(P):
        spec = P.workload.Spec(
            title="Dynamic", workloads=[(P.workloads.CycleWorkload, {"nodes": 6,
                                                                    "transactions": 6})],
            dynamic=P.cluster.DynamicClusterConfig(n_workers=4, n_resolvers=1))
        with sims_built(P) as sims:
            res = P.workload.run_spec(spec, 1)
        return result(res), world_state(P, sims[0])

    port, jax_ = both(case)
    assert port[0][0], port[0]
    assert port == jax_


def test_runner_cli(capsys):
    assert PORT.runner.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == sorted(PORT.specs.SPECS)
    assert PORT.runner.main(["--spec", "IncrementTest", "--seed", "3"]) == 0
    out = capsys.readouterr().out
    assert "OK  IncrementTest seed=3" in out
    assert PORT.runner.main(["--spec", "NoSuchSpec"]) == 2
    clean_world()
    assert JAX.runner.main(["--spec", "IncrementTest", "--seed", "3"]) == 0
    assert capsys.readouterr().out == out


@pytest.mark.parametrize("seed", [1, 2, 7])
def test_knob_randomization_draws_equal_values(seed):
    drawn = []
    for P in (PORT, JAX):
        clean_world()
        P.simulator.Simulator(seed, randomize_knobs=True)
        drawn.append((P.knobs.SERVER_KNOBS.as_dict(), P.knobs.CLIENT_KNOBS.as_dict()))
        P.knobs.reset_all()
    assert drawn[0] == drawn[1]
    assert drawn[0][0] != PORT.knobs.SERVER_KNOBS.as_dict()
