"""The durable storage tier under the dynamic cluster: the port against
the JAX package.

Both cases of tests/test_durable_storage.py are written once as `case(P)`
and run on both packages with the same tiny pending budget: which storage
servers flushed, their durable versions and overlay sizes, the mutations
replayed after a crash of every process, the rows read and what the
simulation leaves behind (virtual time, scheduler steps, rng state, every
disk's bytes: the LSM engines' tables, manifests and WALs, torn by the
kills; trace events) must be equal.

Every compared value is an int, bytes, a string or a float computed the
same way in both packages: tolerance 0 (exact equality).
"""
import pytest

from torch_sim_world import both, clean_world, world_state

ROWS = 150
VAL = b"v" * 120


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def drive(sim, coro, until=240.0):
    return sim.run_until(sim.sched.spawn(coro), until=until)


def live_storage_servers(cluster):
    return [h.__self__ for p in cluster.worker_procs
            for h in [p.handlers.get("storage.getValue")] if h is not None]


def fill(db):
    async def go():
        for base in range(0, ROWS, 10):
            async def w(tr, base=base):
                for i in range(base, min(base + 10, ROWS)):
                    tr.set(b"big/%04d" % i, VAL + b"%04d" % i)
            await db.run(w)
        return True
    return go()


def read_all(db):
    async def go():
        async def r(tr):
            return await tr.get_range(b"big/", b"big/\xff")
        return await db.run(r)
    return go()


def servers(sses):
    return [(ss.tag, ss.durable_version, len(ss.store._keys),
             ss.stats.as_dict().get("mutations", 0)) for ss in sses]


def case_engine_absorbs_dataset_under_memory_pressure(P, monkeypatch):
    monkeypatch.setattr(P.storage.StorageServer, "PENDING_BYTES", 2048)
    c = P.cluster.build_dynamic_cluster(seed=71, cfg=P.cluster.DynamicClusterConfig())
    sim, db = c.sim, c.new_client()
    assert drive(sim, fill(db))
    sim.run(until=sim.sched.time + 3.0)
    sses = live_storage_servers(c)
    flushed = [ss for ss in sses if ss.kvs is not None and ss.durable_version > 0]
    assert flushed and all(len(ss.store._keys) < ROWS for ss in flushed)
    return servers(sses), world_state(P, sim)


def case_crash_all_recovers_from_engine_without_full_replay(P, monkeypatch):
    monkeypatch.setattr(P.storage.StorageServer, "PENDING_BYTES", 2048)
    c = P.cluster.build_dynamic_cluster(seed=72, cfg=P.cluster.DynamicClusterConfig())
    sim, db = c.sim, c.new_client()
    assert drive(sim, fill(db))
    sim.run(until=sim.sched.time + 3.0)
    pre = live_storage_servers(c)
    pre_mutations = sum(ss.stats.as_dict().get("mutations", 0) for ss in pre)
    pre_durable = {ss.tag: ss.durable_version for ss in pre if ss.durable_version > 0}
    assert pre_durable
    for p in c.coord_procs + c.worker_procs:
        sim.kill_process(p, P.simulator.KillType.REBOOT)
    got = drive(sim, read_all(db), until=sim.sched.time + 300.0)
    assert got == [(b"big/%04d" % i, VAL + b"%04d" % i) for i in range(ROWS)]
    restored = [ss for ss in live_storage_servers(c) if ss.tag in pre_durable]
    assert restored
    for ss in restored:
        assert ss.stats.as_dict().get("mutations", 0) < max(pre_mutations // 2, 1)
    return servers(pre), servers(restored), world_state(P, sim)


@pytest.mark.parametrize("case", [
    case_engine_absorbs_dataset_under_memory_pressure,
    case_crash_all_recovers_from_engine_without_full_replay,
], ids=lambda f: f.__name__[len("case_"):])
def test_durable_storage_case(case, monkeypatch):
    port, jax_ = both(case, monkeypatch)
    assert port == jax_
