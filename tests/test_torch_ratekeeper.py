"""Ratekeeper admission control in the dynamic cluster: the port against
the JAX package.

The dynamic cases of tests/test_ratekeeper.py, written once as `case(P)`
and run on both packages: with a tiny cluster-wide TPS limit the
transactions take their admitted virtual time, and unthrottled they do
not; the elapsed virtual time and what the simulation leaves behind
(virtual time, scheduler steps, rng state, disks, trace events) must be
equal. clean_world() resets the knob between packages.

Every compared value is an int, bytes, a string or a float computed the
same way in both packages: tolerance 0 (exact equality).
"""
import pytest

from torch_sim_world import both, clean_world, world_state


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def timed_writes(P, seed, warm):
    c = P.cluster.build_dynamic_cluster(seed=seed, cfg=P.cluster.DynamicClusterConfig())
    sim, db = c.sim, c.new_client()

    async def work():
        for _ in range(warm):
            async def noop(tr):
                await tr.get(b"k")
            await db.run(noop)
        start = sim.sched.time
        for i in range(20):
            async def body(tr, i=i):
                tr.set(b"k%02d" % i, b"v")
            await db.run(body)
        return sim.sched.time - start

    return sim.run_until(sim.sched.spawn(work(), name="w"), until=120.0), world_state(P, sim)


def case_grv_throttle_limits_transaction_rate(P):
    P.knobs.SERVER_KNOBS._values["max_transactions_per_second"] = 10.0
    elapsed, state = timed_writes(P, 91, warm=3)
    assert elapsed > 1.5, elapsed
    return elapsed, state


def case_unthrottled_cluster_is_fast(P):
    elapsed, state = timed_writes(P, 92, warm=1)
    assert elapsed < 1.0, elapsed
    return elapsed, state


@pytest.mark.parametrize("case", [
    case_grv_throttle_limits_transaction_rate,
    case_unthrottled_cluster_is_fast,
], ids=lambda f: f.__name__[len("case_"):])
def test_ratekeeper_case(case):
    port, jax_ = both(case)
    assert port == jax_
