"""Data distribution: the byte sample, shard split and merge, write
bandwidth splits and policy-driven team placement in the dynamic cluster;
the port against the JAX package.

Every case of tests/test_data_distribution.py is written once as
`case(P)` and run on both packages with the same knobs: the teams the
policy picks, the shard map the status document reports before and after
the tracker acts, the rows read, the relocation parallelism and what the
simulation leaves behind (virtual time, scheduler steps, rng state, disks,
trace events) must be equal. clean_world() resets the knobs between the
packages.

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


ROWS = 160
VAL = b"h" * 100
DD_KNOBS = dict(dd_shard_split_bytes=6_000, dd_shard_merge_bytes=400, dd_tracker_interval=1.0,
                dd_byte_sample_factor=64)


def set_knobs(P, **kv):
    P.knobs.SERVER_KNOBS._values.update(kv)


def drive(sim, coro, until=240.0):
    return sim.run_until(sim.sched.spawn(coro), until=until)


def shard_ranges(cluster):
    async def go():
        doc = await cluster.new_client().get_status()
        return sorted({(s["shard_begin"], s["shard_end"]) for s in doc.get("storage", [])})
    return go()


def boot(P, seed):
    cfg = P.cluster.DynamicClusterConfig()
    cfg.n_workers += 4
    c = P.cluster.build_dynamic_cluster(seed=seed, cfg=cfg)
    return c, c.sim, c.new_client()


def fill(db):
    async def go():
        for base in range(0, ROWS, 10):
            async def w(tr, base=base):
                for i in range(base, min(base + 10, ROWS)):
                    tr.set(b"hot/%04d" % i, VAL + b"%04d" % i)
            await db.run(w)
        return True
    return go()


def read_range(db, begin, end):
    async def go():
        async def r(tr):
            return await tr.get_range(begin, end)
        return await db.run(r)
    return go()


def case_policy_across_machines(P):
    loc = {f"a{i}": (f"m{i % 3}", "dc0") for i in range(9)}
    p = P.replication_policy.PolicyAcross(3, "machine_id")
    team = p.select(sorted(loc), loc)
    assert len(team) == 3 and len({loc[a][0] for a in team}) == 3 and p.validate(team, loc)
    small = {f"b{i}": ("m0", "dc0") for i in range(3)}
    team2 = p.select(sorted(small), small)
    assert team2 is not None and len(team2) == 3
    assert p.select(["x"], {}) is None
    return team, team2


def case_hot_shard_splits_and_data_survives(P):
    set_knobs(P, **DD_KNOBS)
    c, sim, db = boot(P, 101)
    assert drive(sim, fill(db))
    before = drive(sim, shard_ranges(c))
    sim.run(until=sim.sched.time + 20.0)
    after = drive(sim, shard_ranges(c))
    assert len(after) > len(before)
    assert all(e1 == b2 for (_, e1), (b2, _) in zip(after, after[1:]))
    got = drive(sim, read_range(db, b"hot/", b"hot/\xff"))
    assert got == [(b"hot/%04d" % i, VAL + b"%04d" % i) for i in range(ROWS)]
    return before, after, world_state(P, sim)


def case_cleared_shards_merge_back(P):
    set_knobs(P, **DD_KNOBS)
    c, sim, db = boot(P, 102)
    assert drive(sim, fill(db))
    sim.run(until=sim.sched.time + 20.0)
    split = drive(sim, shard_ranges(c))

    async def clear():
        async def w(tr):
            tr.clear_range(b"hot/", b"hot/\xff")
        await db.run(w)
        return True

    assert drive(sim, clear())
    sim.run(until=sim.sched.time + 25.0)
    merged = drive(sim, shard_ranges(c))
    assert len(split) > 2 and len(merged) < len(split)
    assert drive(sim, read_range(db, b"hot/", b"hot/\xff")) == []
    return split, merged, world_state(P, sim)


def case_hot_write_shard_splits_on_bandwidth(P, monkeypatch):
    """Overwrites keep a shard's bytes flat, but its write bandwidth splits
    it; concurrent relocations stay within the configured parallelism."""
    set_knobs(P, dd_shard_split_bytes=10**9, dd_shard_split_bandwidth=2_000,
              dd_shard_merge_bytes=0, dd_tracker_interval=1.0, dd_byte_sample_factor=64,
              dd_move_parallelism=2)
    MS = P.masterserver.MasterServer
    conc = {"now": 0, "max": 0}
    for name in ("_split_shard", "_merge_shards", "_grow_team"):
        def wrap(orig=getattr(MS, name)):
            async def run(self, *a, **k):
                conc["now"] += 1
                conc["max"] = max(conc["max"], conc["now"])
                try:
                    return await orig(self, *a, **k)
                finally:
                    conc["now"] -= 1
            return run
        monkeypatch.setattr(MS, name, wrap())
    c, sim, db = boot(P, 104)

    async def wait_boot():
        while True:
            doc = await db.get_status()
            if doc is not None and doc.get("data", {}).get("shards"):
                return True
            await P.loop.delay(0.5)

    async def hammer():
        for round_ in range(120):
            async def w(tr, round_=round_):
                for i in range(12):
                    tr.set(b"hotw/%02d" % i, VAL + b"%04d.%03d" % (i, round_))
            await db.run(w)
            await P.loop.delay(0.2)
        return True

    assert drive(sim, wait_boot(), until=120.0)
    before = drive(sim, shard_ranges(c))
    assert sim.run_until(sim.sched.spawn(hammer(), name="hammer"), until=600.0)
    after = drive(sim, shard_ranges(c))
    assert len(after) > len(before) and conc["max"] <= 2
    got = drive(sim, read_range(db, b"hotw/", b"hotw/\xff"))
    assert [k for k, _ in got] == [b"hotw/%02d" % i for i in range(12)]
    return before, after, conc["max"], got, world_state(P, sim)


def case_merge_keeps_writes_committed_during_fetch(P, monkeypatch):
    """Writes committed while a merge's paged fetch is in flight land in
    the absorbed range and survive."""
    set_knobs(P, **DD_KNOBS)
    SS, TP = P.storage.StorageServer, P.loop.TaskPriority
    orig = SS._fetch_range

    async def slow_fetch(self, addrs, begin, end, version, items=None):
        await P.loop.delay(2.0, TP.FETCH_KEYS)
        await orig(self, addrs, begin, end, version, items)
        await P.loop.delay(2.0, TP.FETCH_KEYS)

    monkeypatch.setattr(SS, "_fetch_range", slow_fetch)
    c, sim, db = boot(P, 103)
    assert drive(sim, fill(db))
    sim.run(until=sim.sched.time + 20.0)
    split = drive(sim, shard_ranges(c))
    assert len(split) > 2

    async def clear():
        async def w(tr):
            tr.clear_range(b"hot/0", b"hot/z")
        await db.run(w)
        return True

    assert drive(sim, clear())
    N = 100

    async def writer():
        for i in range(N):
            async def w(tr, i=i):
                tr.set(b"hot/zz%04d" % i, b"p%d" % i)
            await db.run(w)
            await P.loop.delay(0.3)
        return True

    assert sim.run_until(sim.sched.spawn(writer(), name="probe-writer"),
                         until=sim.sched.time + 300.0)
    sim.run(until=sim.sched.time + 10.0)
    got = drive(sim, read_range(db, b"hot/zz", b"hot/zz\xff"))
    assert got == [(b"hot/zz%04d" % i, b"p%d" % i) for i in range(N)]
    return split, drive(sim, shard_ranges(c)), world_state(P, sim)


@pytest.mark.parametrize("case", [
    case_policy_across_machines,
    case_hot_shard_splits_and_data_survives,
    case_cleared_shards_merge_back,
], ids=lambda f: f.__name__[len("case_"):])
def test_data_distribution_case(case):
    port, jax_ = both(case)
    assert port == jax_


@pytest.mark.parametrize("case", [
    case_hot_write_shard_splits_on_bandwidth,
    case_merge_keeps_writes_committed_during_fetch,
], ids=lambda f: f.__name__[len("case_"):])
def test_data_distribution_patched_case(case, monkeypatch):
    port, jax_ = both(case, monkeypatch)
    assert port == jax_
