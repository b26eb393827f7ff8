"""Resolution balancing: hot resolver shards trigger a live split-key
move with no recovery; the port against the JAX package.

Every case of tests/test_rebalance.py is written once as `case(P)` and
run on both packages: the coordinated state read before and after, the
splits chosen, the commits counted, the sum read back and what the
simulation leaves behind (virtual time, scheduler steps, rng state, disks,
trace events) must be equal.

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


async def peek_cstate(P, sim, src_addr, coordinators):
    """One coordinator's register, read without advancing its generation."""
    C = P.coordination
    for addr in coordinators:
        try:
            reply = await sim.net.request(
                src_addr, P.network.Endpoint(addr, C.GENERATION_READ_TOKEN),
                C.GenerationReadRequest(P.coordinated_state.CSTATE_KEY, C.ZERO_GEN),
                P.loop.TaskPriority.COORDINATION, timeout=1.0)
            if reply.value is not None:
                return reply.value
        except P.error.FDBError:
            continue
    return None


def boot(P, seed):
    return P.cluster.build_dynamic_cluster(seed=seed, cfg=P.cluster.DynamicClusterConfig(
        n_workers=6, n_tlogs=2, n_resolvers=2, n_storage=2, rebalance_min_rows=60,
        rebalance_interval=2.0))


def case_zipf_load_rebalances_resolvers(P):
    """All load below 0x80 (resolver 0's half) ends with a split key inside
    the hot range after a live flip, zero recoveries, the database exact."""
    c = boot(P, 97)
    sim, db = c.sim, c.new_client()
    state = {"commits": 0, "splits": None}

    async def bump(tr, k):
        v = await tr.get(k)
        tr.set(k, str(int(v or b"0") + 1).encode())

    async def scenario():
        st0 = None
        while st0 is None:
            st0 = await peek_cstate(P, sim, db.client_addr, c.coordinators)
            if st0 is None:
                await P.loop.delay(0.5)
        state["rc_before"] = st0.recovery_count
        for _ in range(12):
            for i in range(80):
                try:
                    await db.run(bump, b"h%03d" % (i % 40))
                    state["commits"] += 1
                except P.error.FDBError:
                    pass
            st = await peek_cstate(P, sim, db.client_addr, c.coordinators)
            if st is not None and st.resolver_splits:
                state["splits"] = st.resolver_splits
                break
        for i in range(10):
            try:
                await db.run(bump, b"h%03d" % (i % 40))
                state["commits"] += 1
            except P.error.FDBError:
                pass
        st1 = await peek_cstate(P, sim, db.client_addr, c.coordinators)
        state["rc_after"] = st1.recovery_count if st1 else None

        async def read_back(tr):
            return sum(int(v) for _, v in await tr.get_range(b"h", b"i"))
        return await db.run(read_back)

    total = sim.run_until(sim.sched.spawn(scenario(), name="s"), until=1200.0)
    (split,) = state["splits"]
    assert split.startswith(b"h") and total == state["commits"]
    assert state["rc_after"] == state["rc_before"]
    return state, total, world_state(P, sim)


def case_balanced_load_never_bounces(P):
    c = boot(P, 101)
    sim, db = c.sim, c.new_client()

    async def scenario():
        for i in range(120):
            async def body(tr, i=i):
                k = bytes([(i * 37) % 256]) + b"k%02d" % (i % 30)
                v = await tr.get(k)
                tr.set(k, str(int(v or b"0") + 1).encode())
            try:
                await db.run(body)
            except P.error.FDBError:
                pass
        await P.loop.delay(6.0)
        return await peek_cstate(P, sim, db.client_addr, c.coordinators)

    st = sim.run_until(sim.sched.spawn(scenario(), name="s"), until=900.0)
    assert st is not None and not st.resolver_splits
    return P.wire.dumps(st), world_state(P, sim)


@pytest.mark.parametrize("case", [
    case_zipf_load_rebalances_resolvers,
    case_balanced_load_never_bounces,
], ids=lambda f: f.__name__[len("case_"):])
def test_rebalance_case(case):
    port, jax_ = both(case)
    assert port == jax_
