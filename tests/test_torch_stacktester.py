"""The stack-machine conformance tester: the port's against the JAX
package's.

The cases of tests/test_stacktester.py's oracle-vs-kernel conformance
(seeds 201 and 202), on both packages: `generate_stream(seed)` gives the
same instruction list in both; the stream run through the port's static
cluster with oracle resolvers and with CPU `TorchConflictEngine` resolvers
at the specs' KernelConfig gives the same journal, final keyspace and simulation; and
that journal and keyspace, with what the simulation leaves behind (virtual
time, scheduler steps, rng state, disks, trace events), equal the JAX
package's oracle run. The JAX package's mesh case (seed 303, 90
instructions, an 8-shard ShardedConflictEngine in each resolver) runs with
the port's 8-shard engine on the CPU and equals the oracle run and JAX's
8-shard run.

Every compared value is bytes, an int, a string or a float computed the
same way in both packages: tolerance 0 (exact equality).
"""
import pytest
import torch

from torch_sim_world import JAX, PORT, clean_world, world_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def run_with_engine(P, seed, engine_factory, stream):
    c = P.cluster.build_cluster(seed=seed, cfg=P.cluster.ClusterConfig(
        n_resolvers=2, n_storage=2, engine_factory=engine_factory))
    db = c.new_client()

    async def go():
        journal = await P.stacktester.run_stream(db, stream)
        return journal, await P.stacktester.final_state(db)

    out = c.sim.run_until(c.sim.sched.spawn(go(), name="stack"), until=600.0)
    return out, world_state(P, c.sim)


@pytest.mark.parametrize("seed", [201, 202, 303])
def test_streams_equal(seed):
    stream = PORT.stacktester.generate_stream(seed)
    assert stream == JAX.stacktester.generate_stream(seed)
    assert len(stream) > 120 and stream[0] == ("NEW_TRANSACTION",)
    assert PORT.stacktester.generate_stream(seed, n=90) == JAX.stacktester.generate_stream(seed, n=90)


@pytest.mark.parametrize("seed", [201, 202])
def test_oracle_vs_cpu_engine_and_jax_conformance(seed):
    from foundationdb_tpu_torch.testing.specs import make_engine_factory

    stream = PORT.stacktester.generate_stream(seed)
    (j_oracle, s_oracle), w_oracle = run_with_engine(
        PORT, seed, PORT.oracle.OracleConflictEngine, stream)
    clean_world()
    (j_engine, s_engine), w_engine = run_with_engine(
        PORT, seed, make_engine_factory(device="cpu"), stream)
    assert j_engine == j_oracle, "journals diverged between the oracle and the port's engine"
    assert s_engine == s_oracle, "final keyspaces diverged between the oracle and the engine"
    assert w_engine == w_oracle
    clean_world()
    (j_jax, s_jax), w_jax = run_with_engine(JAX, seed, JAX.oracle.OracleConflictEngine,
                                            JAX.stacktester.generate_stream(seed))
    assert j_oracle == j_jax and s_oracle == s_jax
    assert w_oracle == w_jax
    assert any(b"COMMITTED" in entry for entry in j_oracle) and s_oracle


def test_oracle_vs_sharded_mesh_conformance():
    """tests/test_stacktester.py's mesh case: the port's 8-shard
    ShardedConflictEngine resolvers (CPU) give the oracle run's journal,
    keyspace and simulation, and JAX's 8-shard run gives the same
    journal and keyspace."""
    import jax

    from foundationdb_tpu.ops.conflict_kernel import KernelConfig
    from foundationdb_tpu.parallel.sharding import KeyShardMap, ShardedConflictEngine
    from foundationdb_tpu_torch.testing.specs import make_engine_factory

    stream = PORT.stacktester.generate_stream(303, n=90)
    (j_oracle, s_oracle), w_oracle = run_with_engine(
        PORT, 303, PORT.oracle.OracleConflictEngine, stream)
    clean_world()
    (j_mesh, s_mesh), w_mesh = run_with_engine(
        PORT, 303, make_engine_factory(device="cpu", mode="sharded", n_shards=8), stream)
    assert j_mesh == j_oracle, "journals diverged between the oracle and the 8-shard engine"
    assert s_mesh == s_oracle and w_mesh == w_oracle
    clean_world()

    def jax_sharded():
        return ShardedConflictEngine(
            KernelConfig(key_words=4, capacity=1024, max_reads=256, max_writes=256,
                         max_txns=64), KeyShardMap.uniform(len(jax.devices())))

    (j_jax, s_jax), _ = run_with_engine(JAX, 303, jax_sharded,
                                        JAX.stacktester.generate_stream(303, n=90))
    assert j_jax == j_oracle and s_jax == s_oracle
