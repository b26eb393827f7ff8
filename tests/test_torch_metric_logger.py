"""The port's MetricLogger (foundationdb_tpu_torch/client/metric_logger.py)
against the JAX package's: tests/test_tdmetric.py's logger cases, each run
once per package in the static and in the dynamic simulated cluster. The
series read back, the `\\xff/metrics/` keys and bytes the logger wrote, and
the simulated world left behind must be equal."""
import pytest

from torch_sim_world import PORT, both, clean_world, world_state


@pytest.fixture(autouse=True)
def _clean():
    clean_world()
    yield
    clean_world()


def _cluster(P, world, seed):
    if world == "static":
        return P.cluster.build_cluster(seed=seed, cfg=P.cluster.ClusterConfig())
    return P.cluster.build_dynamic_cluster(seed=seed, cfg=P.cluster.DynamicClusterConfig())


async def _metrics_rows(P, db):
    async def read(tr):
        return await P.layers_util.read_all(tr, P.metric_logger.METRICS_PREFIX,
                                            P.metric_logger.METRICS_PREFIX + b"\xff", page=200)
    return [(bytes(k), bytes(v)) for k, v in await db.run(read)]


def level_case(P, world):
    """test_metric_logger_persists_and_reads_back: a level metric set six
    times, drained every 0.5 s, read back whole and from a mid time."""
    c = _cluster(P, world, 61)
    sim = c.sim
    db = c.new_client()
    ml = P.metric_logger

    async def scenario():
        col = P.tdmetric.TDMetricCollection(now=lambda: sim.sched.time)
        m = col.int64("app.level")
        P.loop.spawn(ml.run_metric_logger(db, col, "proc-a", interval=0.5), name="metricLogger")
        for i in range(6):
            m.set((i + 1) * 10)
            await P.loop.delay(0.7)
        await P.loop.delay(2.0)
        series = await ml.read_metric(db, "proc-a", "app.level")
        part = await ml.read_metric(db, "proc-a", "app.level", t0=series[2][0])
        return series, part, await _metrics_rows(P, db)

    out = sim.run_until(sim.sched.spawn(scenario(), name="s"), until=300.0)
    return out, world_state(P, sim)


def drain_race_case(P, world):
    """test_record_during_drain_persists_e2e: events logged at a period
    incommensurate with the drain interval all read back."""
    c = _cluster(P, world, 63)
    sim = c.sim
    db = c.new_client()
    ml = P.metric_logger

    async def scenario():
        col = P.tdmetric.TDMetricCollection(now=lambda: sim.sched.time)
        m = col.continuous("drainrace.events")
        P.loop.spawn(ml.run_metric_logger(db, col, "proc-b", interval=0.4), name="metricLogger")
        for i in range(20):
            m.log(i)
            await P.loop.delay(0.13)
        await P.loop.delay(3.0)
        series = await ml.read_metric(db, "proc-b", "drainrace.events")
        return series, await _metrics_rows(P, db)

    out = sim.run_until(sim.sched.spawn(scenario(), name="s"), until=300.0)
    return out, world_state(P, sim)


@pytest.mark.parametrize("world", ["static", "dynamic"])
def test_level_metric_logger_equals_jax(world):
    port, jax = both(level_case, world)
    assert port == jax
    (series, part, rows), _ = port
    assert [v for _t, v in series] == [10, 20, 30, 40, 50, 60]
    assert [v for _t, v in part] == [30, 40, 50, 60]
    assert rows and all(k.startswith(b"\xff/metrics/proc-a/app.level/") for k, _ in rows)


@pytest.mark.parametrize("world", ["static", "dynamic"])
def test_drain_race_metric_logger_equals_jax(world):
    port, jax = both(drain_race_case, world)
    assert port == jax
    (series, rows), _ = port
    assert [v for _t, v in series] == list(range(20))
    assert rows


def test_block_keys_equal_jax():
    from torch_sim_world import JAX

    for t, seq in ((0.0, 0), (1.2345, 7), (1e6 + 0.5, 65535)):
        assert PORT.metric_logger._block_key("p", "m.x", t, seq) == \
            JAX.metric_logger._block_key("p", "m.x", t, seq)
