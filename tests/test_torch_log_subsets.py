"""Per-tag tlog replica subsets and peek failover: the port against the
JAX package.

Every case of tests/test_log_subsets.py is written once as `case(P)` and
run on both packages: the subset math, which tags each tlog holds, the
versions a peek serves, the errors and what the simulation leaves behind
(virtual time, scheduler steps, rng state, disks, trace events) must be
equal; the last case runs R=2-of-3 subsets through an epoch recovery of
the dynamic cluster.

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


def drive(sim, coro, until):
    return sim.run_until(sim.sched.spawn(coro, name="s"), until=until)


def set_(P, k, v):
    return P.types.Mutation(P.types.MutationType.SET_VALUE, k, v)


def build_log_system(P, sim, n=3, r=2):
    procs = [sim.new_process(f"tlog{i}") for i in range(n)]
    tlogs = [P.tlog.TLog(p, start_version=0, token_suffix=f".{i}") for i, p in enumerate(procs)]
    cfg = P.log_system.LogSystemConfig(
        gen_id=(0, 0), tlogs=tuple((p.address, f".{i}") for i, p in enumerate(procs)),
        replication_factor=r)
    client = P.log_system.LogSystemClient(sim.net, sim.new_process("pusher").address, cfg)
    return procs, tlogs, cfg, client


def case_tag_subset_math(P):
    LS = P.log_system.LogSystemConfig
    cfg = LS(tlogs=(("a", ".0"), ("b", ".1"), ("c", ".2")), replication_factor=2)
    subsets = [cfg.tag_subset(t) for t in range(6)]
    assert all(len(s) == 2 for s in subsets) and len(set(subsets)) == 3
    assert cfg.lock_quorum() == 2
    everything = LS(tlogs=cfg.tlogs)
    assert everything.tag_subset(1) == (0, 1, 2) and everything.lock_quorum() == 1
    msgs = {0: ["m0"], 1: ["m1"], 2: ["m2"]}
    kept = [sorted(cfg.filter_messages_for_replica(i, msgs)) for i in range(3)]
    for i in range(3):
        assert set(kept[i]) == {t for t in msgs if i in cfg.tag_subset(t)}
    return subsets, cfg.lock_quorum(), kept


def case_push_stores_only_subset_tags(P):
    sim = P.simulator.Simulator(seed=5)
    procs, tlogs, cfg, client = build_log_system(P, sim)

    async def push_all():
        for v in range(1, 6):
            await client.push(v - 1, v, {t: [set_(P, b"k%d" % t, b"v")] for t in range(4)},
                              known_committed=v - 1)
        return True

    assert drive(sim, push_all(), 30.0)
    held = [sorted(tl.tag_data) for tl in tlogs]
    for i, tl in enumerate(tlogs):
        assert set(held[i]) == {t for t in range(4) if i in cfg.tag_subset(t)}
        assert tl.version.get() == 5
    return held, world_state(P, sim)


def case_peek_fails_over_to_live_subset_member(P):
    sim = P.simulator.Simulator(seed=6)
    procs, tlogs, cfg, client = build_log_system(P, sim)

    async def push_some():
        for v in range(1, 4):
            await client.push(v - 1, v, {0: [set_(P, b"a", b"%d" % v)]}, known_committed=v - 1)
        return True

    assert drive(sim, push_some(), 30.0)
    subset = cfg.tag_subset(0)
    sim.kill_process(procs[subset[0]], P.simulator.KillType.KILL_INSTANTLY)

    async def peek_tag():
        reply = await client.peek(0, 1, timeout=1.0)
        return [v for v, _ in reply.messages]

    got = drive(sim, peek_tag(), 30.0)
    assert got and got[0] == 1 and len(got) >= 2
    return got, world_state(P, sim)


def case_peek_raises_when_whole_subset_dead(P):
    sim = P.simulator.Simulator(seed=7)
    procs, tlogs, cfg, client = build_log_system(P, sim)

    async def push_one():
        await client.push(0, 1, {0: [set_(P, b"a", b"1")]}, known_committed=0)
        return True

    assert drive(sim, push_one(), 30.0)
    for i in cfg.tag_subset(0):
        sim.kill_process(procs[i], P.simulator.KillType.KILL_INSTANTLY)

    async def peek_tag():
        try:
            await client.peek(0, 1, timeout=1.0)
            return "served"
        except P.error.FDBError as e:
            return e.name

    got = drive(sim, peek_tag(), 30.0)
    assert got != "served"
    return got, world_state(P, sim)


def case_committed_data_survives_tlog_death_with_subsets(P):
    c = P.cluster.build_dynamic_cluster(seed=91, cfg=P.cluster.DynamicClusterConfig(
        n_workers=6, n_tlogs=3, log_replication_factor=2, n_storage=2))
    sim = c.sim
    db = c.new_client()

    async def write_phase():
        async def w(tr):
            for i in range(10):
                tr.set(b"d%02d" % i, b"v%d" % i)
        await db.run(w)
        return True

    assert drive(sim, write_phase(), 60.0)
    victim = next(p for p in c.worker_procs
                  if any(tok.startswith("tlog.commit") for tok in p.handlers))
    sim.kill_process(victim, P.simulator.KillType.REBOOT)
    sim.run(until=30.0)

    async def read_phase():
        async def r(tr):
            return [await tr.get(b"d%02d" % i) for i in range(10)]
        return await db.run(r)

    got = drive(sim, read_phase(), 240.0)
    assert got == [b"v%d" % i for i in range(10)]
    return victim.address, got, world_state(P, sim)


@pytest.mark.parametrize("case", [
    case_tag_subset_math,
    case_push_stores_only_subset_tags,
    case_peek_fails_over_to_live_subset_member,
    case_peek_raises_when_whole_subset_dead,
    case_committed_data_survives_tlog_death_with_subsets,
], ids=lambda f: f.__name__[len("case_"):])
def test_log_subsets_case(case):
    port, jax_ = both(case)
    assert port == jax_
