"""Backup and restore: the port's BackupAgent against the JAX package's.

The cases of tests/test_backup.py, written once as `case(P)` and run on
both packages: a backup taken under load restores into a second cluster
of the same simulation equal to the source read at the backup's end
version; with the container object cap patched to 256 bytes (in each
package's own `backup.agent` module) the snapshot and the log split into
many objects and restore reassembles them; a backup whose log mover died
releases its tag for the next backup; and a finished backup's tag is
retired from the tlogs; and a claim whose commit landed but answered
commit_unknown_result refuses its own tag (a fault of the reference that
the port keeps). Each case returns the restored and source rows,
the end version, the container's objects (names and bytes) and what the
simulation leaves behind (virtual time, scheduler steps, rng state, every
disk's bytes, trace events); the port's must equal the JAX package's.

Every compared value is bytes, an int, a bool, a string or a float
computed the same way in both packages: tolerance 0 (exact equality).
"""
import pytest

from torch_sim_world import both, clean_world, world_state

USER_END = b"\xff"


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def build_two_clusters(P, seed):
    """Source and destination clusters inside one simulation, sharing a
    blob container (tests/test_backup.py's topology)."""
    sim = P.simulator.Simulator(seed)
    shape = dict(n_workers=6, n_tlogs=2, n_resolvers=2, n_storage=2)
    src = P.cluster.DynamicCluster(sim, P.cluster.DynamicClusterConfig(**shape))
    dst = P.cluster.DynamicCluster(sim, P.cluster.DynamicClusterConfig(**shape))
    container = P.blob_container.BlobContainer(sim.new_process("blobstore"))
    return sim, src, dst, container


async def read_all(db, version=None):
    tr = db.create_transaction()
    if version is not None:
        tr.read_version = version
    return await tr.get_range(b"", USER_END, limit=100_000, snapshot=True)


def run(P, sim, container, scenario, until):
    out = sim.run_until(sim.sched.spawn(scenario(), name="s"), until=until)
    return out, sorted(container._objects.items()), world_state(P, sim)


def case_restore_under_load(P):
    sim, src, dst, container = build_two_clusters(P, seed=131)
    db, db2 = src.new_client(), dst.new_client()
    add = P.types.MutationType.ADD_VALUE

    async def scenario():
        async def seed(tr):
            for i in range(40):
                tr.set(b"pre/%03d" % i, b"v%d" % i)
            tr.atomic_op(b"ctr", (5).to_bytes(8, "little"), add)
        await db.run(seed)

        agent = P.backup.BackupAgent(sim, db, container.proc.address)
        await agent.start_backup()

        async def load():
            for i in range(60):
                async def body(tr, i=i):
                    tr.set(b"live/%03d" % (i % 25), b"w%d" % i)
                    if i % 7 == 0:
                        tr.clear_range(b"pre/%03d" % (i % 10), b"pre/%03d\x00" % (i % 10))
                    if i % 5 == 0:
                        tr.atomic_op(b"ctr", (3).to_bytes(8, "little"), add)
                await db.run(body)
                if i % 10 == 9:
                    await P.loop.delay(0.2)
            return True

        load_task = sim.sched.spawn(load(), name="load")
        await agent.snapshot(chunks=6, workers=3)
        assert await load_task
        await agent.finish_backup()

        async def post(tr):
            tr.set(b"after/end", b"not-in-backup")
        await db.run(post)

        vend = await agent.restore(db2)
        assert vend == agent.end_version
        src_rows, dst_rows = await read_all(db, agent.end_version), await read_all(db2)
        assert dst_rows == src_rows, (len(dst_rows), len(src_rows))
        d = dict(dst_rows)
        assert d.get(b"live/000") is not None and b"after/end" not in d
        return (vend, agent.start_version, agent.snapshot_version, agent.tag, dst_rows)

    return run(P, sim, container, scenario, 600.0)


def case_restore_with_tiny_object_cap(P, monkeypatch):
    monkeypatch.setattr(P.backup_agent, "CONTAINER_OBJECT_BYTES", 256)
    sim, src, dst, container = build_two_clusters(P, seed=139)
    db, db2 = src.new_client(), dst.new_client()

    async def scenario():
        async def seed(tr):
            for i in range(30):
                tr.set(b"pre/%03d" % i, b"x" * 40)   # forces many parts
        await db.run(seed)

        agent = P.backup.BackupAgent(sim, db, container.proc.address)
        await agent.start_backup()

        async def live(tr):
            for i in range(20):
                tr.set(b"live/%03d" % i, b"y" * 40)  # forces log groups
        await db.run(live)

        await agent.snapshot(chunks=3, workers=2)
        await agent.finish_backup()
        names = await agent._list("range/")
        assert any(n.endswith("-done") for n in names)
        assert sum(1 for n in names if not n.endswith("-done")) > 3

        vend = await agent.restore(db2)
        assert vend == agent.end_version
        src_rows, dst_rows = await read_all(db, agent.end_version), await read_all(db2)
        assert dst_rows == src_rows, (len(dst_rows), len(src_rows))
        return vend, names, dst_rows

    return run(P, sim, container, scenario, 600.0)


def case_failed_backup_releases_tag(P):
    sim, src, dst, container = build_two_clusters(P, seed=141)
    db = src.new_client()

    async def scenario():
        agent = P.backup.BackupAgent(sim, db, container.proc.address)
        await agent.start_backup()

        async def w(tr):
            for i in range(5):
                tr.set(b"k%d" % i, b"v")
        await db.run(w)

        # a mover that died permanently (an escalated 4xx, say)
        agent._mover.cancel()
        agent._mover_error = P.error.client_invalid_operation("injected")
        agent._log_floor = 0
        with pytest.raises(P.error.FDBError) as raised:
            await agent.finish_backup()

        # the slot is free again: a fresh backup claims, runs, finishes
        agent2 = P.backup.BackupAgent(sim, db, container.proc.address)
        await agent2.start_backup()
        await agent2.snapshot(chunks=2, workers=1)
        await agent2.finish_backup()
        return raised.value.code, agent.tag, agent2.tag, agent2.end_version

    out = run(P, sim, container, scenario, 600.0)
    assert out[0][1] != out[0][2]
    return out


def case_tag_is_retired_after_finish(P):
    sim, src, dst, container = build_two_clusters(P, seed=137)
    db = src.new_client()

    async def scenario():
        agent = P.backup.BackupAgent(sim, db, container.proc.address)

        async def w(tr):
            for i in range(10):
                tr.set(b"k%02d" % i, b"v")
        await db.run(w)
        await agent.start_backup()

        async def w2(tr):
            tr.set(b"k00", b"v2")
        await db.run(w2)
        await agent.snapshot(chunks=2, workers=1)
        await agent.finish_backup()
        await P.loop.delay(3.0)
        client = await agent._log_client()
        try:
            reply = await client.peek(agent.tag, 1, timeout=1.0)
            return "peeked", len(reply.messages)
        except P.error.FDBError as e:
            return "refused", e.code   # nothing served: equally retired

    out = run(P, sim, container, scenario, 300.0)
    assert out[0] == ("peeked", 0) or out[0][0] == "refused"
    return out


def case_maybe_committed_claim_refuses_its_own_tag(P):
    """The reference's tag claim is not idempotent: when the claim's commit
    lands but answers commit_unknown_result, the retry finds its own claim
    and start_backup raises client_invalid_operation, leaving the slot
    claimed. Both packages do this (the port keeps the reference's claim);
    a full-load backup met it when the simulated storage stalled."""
    sim, src, dst, container = build_two_clusters(P, seed=143)
    db = src.new_client()
    make = db.create_transaction
    state = {"lost_replies": 0}

    def losing_the_first_reply():
        tr = make()
        commit = tr.commit

        async def lossy():
            version = await commit()
            if state["lost_replies"] == 0:
                state["lost_replies"] += 1
                raise P.error.commit_unknown_result()
            return version

        tr.commit = lossy
        return tr

    async def scenario():
        agent = P.backup.BackupAgent(sim, db, container.proc.address)
        db.create_transaction = losing_the_first_reply
        with pytest.raises(P.error.FDBError) as raised:
            await agent.start_backup()
        db.create_transaction = make

        async def slot(tr):
            tr.set_access_system_keys()
            return (await tr.get(P.system_keys.BACKUP_ACTIVE_KEY),
                    await tr.get(P.system_keys.BACKUP_SEQ_KEY))
        active, seq = await db.run(slot)
        return raised.value.code, P.system_keys.decode_backup_active(active), seq

    out = run(P, sim, container, scenario, 300.0)
    code, tag, seq = out[0]
    assert code == P.error.client_invalid_operation("").code
    assert tag == P.system_keys.FIRST_BACKUP_TAG and seq == b"1"
    return out


def test_backup_restore_under_load_equal():
    port, jax_ = both(case_restore_under_load)
    assert port == jax_


def test_backup_restore_with_tiny_object_cap_equal(monkeypatch):
    port, jax_ = both(case_restore_with_tiny_object_cap, monkeypatch)
    assert port == jax_
    assert len(port[1]) > 10


@pytest.mark.parametrize("case", [
    case_failed_backup_releases_tag,
    case_tag_is_retired_after_finish,
    case_maybe_committed_claim_refuses_its_own_tag,
], ids=lambda f: f.__name__[len("case_"):])
def test_backup_tag_case(case):
    port, jax_ = both(case)
    assert port == jax_
