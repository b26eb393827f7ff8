"""TaskBucket: the port's transactional task queue against the JAX
package's.

The cases of tests/test_task_bucket.py, written once as `case(P)` and run
on both packages: three concurrent executors run every task exactly once,
and a claim that is never finished times out and is requeued. Each case
returns which executor ran which task, in order, the bucket's final rows
and what the simulation leaves behind (virtual time, scheduler steps, rng
state, disks, trace events); the port's must equal the JAX package's.

Every compared value is bytes, an int, a bool, a string or a float
computed the same way in both packages: tolerance 0 (exact equality).
"""
import pytest

from torch_sim_world import both, clean_world, world_state


@pytest.fixture(autouse=True)
def world():
    clean_world()
    yield
    clean_world()


def drive(c, coro, until=120.0):
    return c.sim.run_until(c.sim.sched.spawn(coro, name="t"), until=until)


async def rows_of(db, ss):
    async def r(tr):
        return await tr.get_range(*ss.range(), limit=10_000, snapshot=True)
    return await db.run(r)


def case_exactly_once_under_concurrent_executors(P):
    c = P.cluster.build_cluster(seed=51, cfg=P.cluster.ClusterConfig(n_resolvers=2, n_storage=2))
    db = c.new_client()
    ss = P.bindings.Subspace(("tb",))
    tb = P.task_bucket.TaskBucket(ss)
    N = 12
    executed = []

    async def executor(eid):
        mydb = c.new_client()
        idle = 0
        while idle < 3:
            async def claim(tr):
                return await tb.get_one(tr)
            task = await mydb.run(claim)
            if task is None:
                idle += 1
                await P.loop.delay(0.05)
                continue
            idle = 0
            executed.append((eid, task.id, sorted(task.params.items())))

            async def fin(tr, task=task):
                tb.finish(tr, task)
            await mydb.run(fin)

    async def main():
        async def add_all(tr):
            for i in range(N):
                tb.add(tr, i, {"op": "work", "n": i})
        await db.run(add_all)
        await P.actors.all_of([P.loop.spawn(executor(e), name=f"exec{e}") for e in range(3)])

        async def empty(tr):
            return await tb.is_empty(tr)
        return await db.run(empty), await rows_of(db, ss)

    empty, rows = drive(c, main())
    assert empty
    assert sorted(t for _, t, _ in executed) == list(range(N))   # every task exactly once
    return executed, rows, world_state(P, c.sim)


def case_timeout_requeue(P):
    c = P.cluster.build_cluster(seed=52, cfg=P.cluster.ClusterConfig(n_resolvers=1, n_storage=1))
    db = c.new_client()
    ss = P.bindings.Subspace(("tb2",))
    tb = P.task_bucket.TaskBucket(ss, timeout_seconds=1.0)

    async def main():
        async def add(tr):
            tb.add(tr, 7, {"op": "x"})
        await db.run(add)

        async def claim(tr):
            return await tb.get_one(tr)
        task = await db.run(claim)
        assert task is not None and task.id == 7
        assert (await db.run(claim)) is None   # nothing available while the claim is live
        claimed = await rows_of(db, ss)

        await P.loop.delay(1.5)

        async def sweep(tr):
            return await tb.check_timeouts(tr)
        moved = await db.run(sweep)
        assert moved == 1
        task2 = await db.run(claim)
        assert task2 is not None and task2.id == 7
        return claimed, moved, await rows_of(db, ss)

    return drive(c, main()), world_state(P, c.sim)


@pytest.mark.parametrize("case", [
    case_exactly_once_under_concurrent_executors,
    case_timeout_requeue,
], ids=lambda f: f.__name__[len("case_"):])
def test_task_bucket_case(case):
    port, jax_ = both(case)
    assert port == jax_
