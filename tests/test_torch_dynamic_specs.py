"""The dynamic cluster's specs: the port's run_spec against the JAX package's.

Every ported spec of the dynamic cluster (coordinators, election, the
cluster controller, workers, the master's epoch recovery, data
distribution) runs through the port's `run_spec` and the JAX package's at
seeds 1 and 2 with the specs' own engines: the SpecResults (ok, metrics,
seed, virtual time) must be equal, and so must what the simulation leaves
behind (virtual time, scheduler steps, rng state, every disk's bytes: the
coordinators' generation registers, the tlogs' queues and spill, the
storage engines; and the trace events).

Every compared value is a bool, an int, bytes, a string or a float computed
the same way in both packages: tolerance 0 (exact equality).
"""
import dataclasses

import pytest

from torch_sim_world import JAX, PORT, both, clean_world, sims_built, world_state

#: the JAX package's dynamic specs the port does not run yet: BackupCorrectness
#: needs backup/ and the bindings it imports
UNPORTED = {"BackupCorrectness"}
DYNAMIC = [n for n, make in PORT.specs.SPECS.items() if make().dynamic is not None]


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def test_every_dynamic_spec_but_backup_is_ported():
    jax_dynamic = [n for n, make in JAX.specs.SPECS.items() if make().dynamic is not None]
    assert DYNAMIC == [n for n in jax_dynamic if n not in UNPORTED]
    assert len(DYNAMIC) == 12


def run(P, name, seed):
    with sims_built(P) as sims:
        res = P.workload.run_spec(P.specs.SPECS[name](), seed)
    return dataclasses.astuple(res), world_state(P, sims[0])


@pytest.mark.parametrize("name", DYNAMIC)
@pytest.mark.parametrize("seed", [1, 2])
def test_dynamic_spec_equals_jax(name, seed):
    port, jax_ = both(run, name, seed)
    assert port[0][0], (f"replay: python -m foundationdb_tpu_torch.testing.runner --spec {name} "
                        f"--seed {seed}")
    assert port[0] == jax_[0]
    assert port[1] == jax_[1]
