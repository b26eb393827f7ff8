"""The port's cluster watchdog (foundationdb_tpu_torch/core/watchdog.py)
against the JAX package's (tests/test_watchdog.py's cases).

Each scenario runs once per package over the same synthetic hub series on
a settable virtual clock; the alert lifecycle states seen at every tick,
the alert ring, the incidents and `snapshot()` must be equal, and the
port's must pass the reference test's own assertions. The campaign cases
run the port's wall-clock nemesis with the oracle engine. Not twinned:
the compile-count case (it hooks jax's compiler) and the fault-seed
campaign case (wall-clock, failing on the reference too)."""
import json
import time

import pytest

from torch_sim_world import BOTH, JAX, PORT, both, clean_world


@pytest.fixture(autouse=True)
def _clean():
    clean_world()
    yield
    clean_world()


def _wd(P, rules, t):
    return P.watchdog.Watchdog(rules, now_fn=lambda: t[0])


def _hub(P):
    h = P.telemetry.TelemetryHub()
    h.attach_watchdog(None)
    return h


def _states(wd):
    return [(a["name"], a["series"], a["state"]) for a in wd.alerts_snapshot()]


def _result(wd, seen):
    """What a scenario leaves: the states seen per tick, the ring, the
    incidents and the snapshot (JSON round trip: tuples and lists alike)."""
    return json.loads(json.dumps({
        "seen": seen, "ring": list(wd.ring), "firing": wd.firing(),
        "incidents": [i.as_dict() for i in wd.incidents],
        "timeline": wd.timeline(), "snapshot": wd.snapshot()}, default=str))


def threshold_case(P):
    t = [0.0]
    hub = _hub(P)
    wd = _wd(P, [P.watchdog.ThresholdRule("q_depth", "loop.*.ring_depth", 5, ">",
                                          hold_s=0.2, clear_s=0.4)], t)
    hub.attach_watchdog(wd)
    m = hub.tdmetrics.int64("loop.eng.ring_depth")
    seen = []
    for dt, v in ((0.1, 3), (0.1, 9), (0.1, 9), (0.15, 9), (0.1, 2), (0.2, 9), (0.1, 2),
                  (0.3, 2), (0.2, 2)):
        t[0] += dt
        m.set(v)
        hub.sync()
        seen.append(_states(wd))
    return _result(wd, seen)


def blip_case(P):
    t = [0.0]
    hub = _hub(P)
    wd = _wd(P, [P.watchdog.ThresholdRule("blip", "x.*.v", 0, ">", hold_s=0.5,
                                          clear_s=0.1)], t)
    hub.attach_watchdog(wd)
    m = hub.tdmetrics.int64("x.a.v")
    seen = []
    for i in range(20):
        t[0] += 0.1
        m.set(1 if i % 4 == 0 else 0)
        hub.sync()
        seen.append(_states(wd))
    return _result(wd, seen)


def staleness_case(P):
    t = [0.0]
    hub = _hub(P)
    wd = _wd(P, [P.watchdog.StalenessRule("stall", "sli.*.total", max_age_s=1.0,
                                          hold_s=0.0, clear_s=0.0)], t)
    hub.attach_watchdog(wd)
    m = hub.tdmetrics.int64("sli.commit.total")
    seen = []
    for i in range(1, 18):
        t[0] = i * 0.2
        if i < 11:
            m.set(i)
        hub.sync()
        seen.append(_states(wd))
    t[0] += 0.2
    m.set(99)
    hub.sync()
    hub.sync()
    seen.append(_states(wd))
    return _result(wd, seen)


def anomaly_case(P):
    t = [0.0]
    hub = _hub(P)
    wd = _wd(P, [P.watchdog.AnomalyRule("shift", "heat.*.concentration_x1000",
                                        z_threshold=3.5, hold_s=0.0, clear_s=0.1)], t)
    hub.attach_watchdog(wd)
    m = hub.tdmetrics.int64("heat.eng.concentration_x1000")
    seen = []
    for i in range(1, 80):
        t[0] = i * 0.1
        m.set(100 + (i % 3) if i < 30 else 700)
        hub.sync()
        seen.append(_states(wd))
    return _result(wd, seen)


def burn_case(P):
    t = [0.0]
    hub = _hub(P)
    wd = _wd(P, [P.watchdog.BurnRateRule("slo", "sli.*.good", "sli.*.bad",
                                         budget_frac=0.1, fast_s=0.5, slow_s=2.0,
                                         threshold=2.0, hold_s=0.0, clear_s=0.1)], t)
    hub.attach_watchdog(wd)
    td = hub.tdmetrics
    counts = [0, 0]
    seen = []
    for n_good, n_bad, reps in ((5, 0, 60), (1, 4, 4), (1, 4, 40), (5, 0, 60)):
        for _ in range(reps):
            t[0] += 0.05
            counts[0] += n_good
            counts[1] += n_bad
            td.int64("sli.c.good").set(counts[0])
            td.int64("sli.c.bad").set(counts[1])
            hub.sync()
            seen.append(_states(wd))
    return _result(wd, seen)


def burn_math_case(P):
    rule = P.watchdog.BurnRateRule("b", "sli.*.good", "sli.*.bad", budget_frac=0.05,
                                   fast_s=1.0, slow_s=4.0, threshold=2.0)
    td = P.telemetry.TelemetryHub().tdmetrics
    good = bad = 0
    t = 0.0
    for i in range(1, 41):
        t = i * 0.1
        good += 9
        bad += 1
        td.int64("sli.commit.good").set(good)
        td.int64("sli.commit.bad").set(bad)
        list(rule.conditions(t, P.watchdog._SeriesView(td.metrics)))
    return (rule.window_burn(("commit",), 1.0, t), rule.window_burn(("commit",), 4.0, t),
            good + bad)


def incident_case(P):
    t = [0.0]
    hub = _hub(P)
    wd = _wd(P, [P.watchdog.ThresholdRule("engine_unhealthy", "resolver.*.state", 1, ">=",
                                          hold_s=0.0, clear_s=0.2)], t)
    hub.attach_watchdog(wd)
    m = hub.tdmetrics.int64("resolver.r1.state")
    for when, value in ((0.1, 0), (0.2, 0), (0.3, 2), (0.4, 2), (0.6, 3), (0.8, 0)):
        t[0] = when
        m.value = value
        m._record(m.value)
        hub.sync()
    t[0] = 1.2
    hub.sync()
    root = {"dominant_segment": "server_resolve", "dominant_ms": 9.1,
            "client_ms": 12.0, "rid": "r1.1"}
    wd.correlate([{"kind": "device_fault", "t0": 0.25, "t1": 0.9}], root_cause=root)
    return _result(wd, [])


def unexplained_case(P):
    t = [0.0]
    hub = _hub(P)
    wd = _wd(P, [P.watchdog.BurnRateRule("slo_p99_burn", "sli.*.good", "sli.*.bad",
                                         budget_frac=0.01, fast_s=0.2, slow_s=0.5,
                                         threshold=2.0, min_events=4, hold_s=0.0),
                 P.watchdog.ThresholdRule("tripwire", "x.*.v", 0, ">", hold_s=0.0)], t)
    hub.attach_watchdog(wd)
    td = hub.tdmetrics
    good = bad = 0
    for i in range(1, 30):
        t[0] = i * 0.1
        good += 3
        bad += 2
        td.int64("sli.c.good").set(good)
        td.int64("sli.c.bad").set(bad)
        td.int64("x.a.v").set(1)
        hub.sync()
    wd.correlate([])
    unexplained = [i.explained for i in wd.incidents]
    wd.correlate([], breached_slo="p99_budget")
    return unexplained, _result(wd, [])


def ring_case(P):
    t = [0.0]
    hub = _hub(P)
    P.knobs.SERVER_KNOBS.set_knob("watchdog_alert_ring", "16")
    wd = _wd(P, [P.watchdog.ThresholdRule("flap", "x.*.v", 0, ">", hold_s=0.0,
                                          clear_s=0.0)], t)
    hub.attach_watchdog(wd)
    m = hub.tdmetrics.int64("x.a.v")
    for i in range(1, 200):
        t[0] = i * 0.1
        m.set(i % 2)
        hub.sync()
    return _result(wd, [])


def default_rules_case(P):
    """The default ruleset over one hub carrying every series family it
    reads: resolver health, engine counters, admission, heat, SLIs."""
    t = [0.0]
    hub = _hub(P)
    wd = _wd(P, P.watchdog.default_rules(), t)
    hub.attach_watchdog(wd)
    td = hub.tdmetrics
    seen = []
    for i in range(1, 60):
        t[0] = i * 0.1
        td.int64("resolver.r1.state").set(2 if 20 <= i < 30 else 0)
        td.int64("engine.e1.blocking_syncs").set(1 if i > 50 else 0)
        td.int64("engine.e1.steady_state_compiles").set(0)
        td.int64("heat.e1.concentration_x1000").set(100 + (i % 3) if i < 35 else 800)
        for ms in ((1.0, 2.0, 400.0) if 25 <= i < 40 else (1.0, 2.0, 3.0)):
            P.watchdog.record_commit_sli(hub, ms, budget_ms=250.0)
        hub.sync()
        seen.append(_states(wd))
    wd.correlate([{"kind": "partition", "t0": 1.9, "t1": 4.2}])
    return _result(wd, seen)


CASES = {"threshold": threshold_case, "blip": blip_case, "staleness": staleness_case,
         "anomaly": anomaly_case, "burn": burn_case, "burn_math": burn_math_case,
         "incident": incident_case, "unexplained": unexplained_case, "ring": ring_case,
         "default_rules": default_rules_case}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rule_scenario_equals_jax(name):
    port, jax = both(CASES[name])
    assert port == jax


def test_threshold_lifecycle_meets_reference_assertions():
    clean_world()
    r = threshold_case(PORT)
    seen = [s[0][2] for s in r["seen"]]
    assert seen == ["ok", "pending", "pending", "firing", "firing", "firing", "firing",
                    "firing", "ok"]
    states = [e["state"] for e in r["ring"]]
    assert states.count("firing") == 1 and states[-1] == "resolved"


def test_blip_staleness_anomaly_burn_meet_reference_assertions():
    r = blip_case(PORT)
    assert not [e for e in r["ring"] if e["state"] == "firing"] and r["incidents"] == []
    r = staleness_case(PORT)
    assert any(s == [["stall", "commit", "firing"]] for s in r["seen"]) or \
        any(st[2] == "firing" for s in r["seen"] for st in s)
    assert r["firing"] == []
    r = anomaly_case(PORT)
    assert any(st[2] == "firing" for s in r["seen"] for st in s)
    assert r["firing"] == [] and [e for e in r["ring"] if e["state"] == "resolved"]
    r = burn_case(PORT)
    assert all(st[2] != "firing" for s in r["seen"][:64] for st in s), \
        "blip fired despite a cold slow window"
    assert any(st[2] == "firing" for st in r["seen"][103])
    (bf, ef), (bs, es), total = burn_math_case(PORT)
    assert bf == pytest.approx(2.0) and bs == pytest.approx(2.0)
    assert ef == pytest.approx(100) and es == pytest.approx(total - 10)


def test_incident_and_breach_naming_meet_reference_assertions():
    r = incident_case(PORT)
    assert len(r["incidents"]) == 1
    d = r["incidents"][0]
    assert d["explained"] and d["windows"][0]["kind"] == "device_fault"
    for part in ("engine_unhealthy firing", "overlaps device_fault window",
                 "dominant=server_resolve", "state=probation"):
        assert part in d["summary"]
    unexplained, r = unexplained_case(PORT)
    assert unexplained and not any(unexplained)
    assert r["incidents"][0]["explained"]
    assert "names the p99_budget breach" in r["incidents"][0]["explanation"]
    assert len(ring_case(PORT)["ring"]) == 16


def test_hub_built_with_the_knob_gets_a_watchdog():
    for P in BOTH:
        assert P.telemetry.TelemetryHub().watchdog is None
        P.knobs.SERVER_KNOBS.set_knob("watchdog_enabled", "true")
        try:
            hub = P.telemetry.TelemetryHub()
            assert isinstance(hub.watchdog, P.watchdog.Watchdog)
            names = [r.name for r in hub.watchdog.rules]
        finally:
            P.knobs.SERVER_KNOBS.set_knob("watchdog_enabled", "false")
        if P is PORT:
            port_names = names
    assert port_names == names


def test_disabled_watchdog_sync_allocates_nothing():
    hub = _hub(PORT)
    hub.tdmetrics.int64("engine.e.compiles").set(3)
    hub.sync()
    before = PORT.watchdog.watchdog_allocations[0]
    for _ in range(200):
        hub.sync()
    assert PORT.watchdog.watchdog_allocations[0] == before
    assert hub.watchdog is None


def test_record_commit_sli_and_exposition_equal_jax():
    def case(P):
        hub = _hub(P)
        t = [0.0]
        wd = _wd(P, P.watchdog.default_rules(), t)
        hub.attach_watchdog(wd)
        for i, ms in enumerate((1.0, 2.0, 300.0)):
            t[0] = 0.1 * (i + 1)
            P.watchdog.record_commit_sli(hub, ms, budget_ms=250.0)
            hub.sync()
        td = hub.tdmetrics
        return ([td.int64(f"sli.commit.{k}").value for k in ("total", "good", "bad")],
                [ln for ln in hub.prometheus_text().splitlines() if "alerts" in ln])

    port, jax = both(case)
    assert port == jax
    assert port[0] == [3, 2, 1]
    assert any("fdbtpu_alerts" in ln for ln in port[1])


def test_ratekeeper_clamps_on_firing_burn_alert_as_jax():
    def case(P):
        rk = P.ratekeeper.Ratekeeper(net=None, src_addr="rk", storage_tags=[],
                                     committed_version_fn=lambda: 0)
        return [rk._update_rate([], None, [{"degraded": d, "burn_alert_firing": b}])
                for d, b in ((False, False), (False, True), (True, True))]

    port, jax = both(case)
    assert port == jax
    k = PORT.knobs.SERVER_KNOBS
    assert port[1] == pytest.approx(k.max_transactions_per_second * k.watchdog_burn_tps_fraction)


def _campaign_cfg(**kw):
    kw.setdefault("budget_ms", 250.0)
    kw.setdefault("engine_mode", "oracle")
    kw.setdefault("watchdog", True)
    return PORT.nemesis.NemesisConfig(seed=kw.pop("seed", 11), **kw)


@pytest.mark.timeout(90)
def test_port_campaign_no_fault_control_zero_incidents():
    """The false-positive guard on the port's campaign: no injected fault,
    nothing fires. Held to invariants, not to a latency: the p99 budget
    is out of reach of a loaded test host, so a slow host cannot fire the
    latency burn."""
    cfg = _campaign_cfg(seed=29, duration_s=2.5, partitions=0, device_faults=False,
                        kill_child=False, dispatch_timeout_s=2.0, budget_ms=10_000.0)
    rep = PORT.nemesis.run_campaign(cfg)
    assert rep.incidents == [], f"control campaign fired incidents: {rep.incidents}"
    assert rep.parity_checked > 0 and rep.parity_mismatches == 0


@pytest.mark.timeout(90)
def test_port_campaign_induced_unexplained_incident_fails_slos():
    """An alert with no overlapping injected window fails assert_slos with
    the alert name leading. Nothing else may fail first or explain it: no
    background network fault draws a window, and the p99 budget (checked
    before the incidents) is out of reach of a loaded test host."""
    tripwire = PORT.watchdog.ThresholdRule("induced_tripwire", "sli.*.total", 0, ">",
                                           hold_s=0.0)
    quiet = PORT.chaos.ChaosConfig(latency_prob=0, drop_prob=0, reset_prob=0,
                                   handshake_stall_prob=0)
    cfg = _campaign_cfg(seed=31, duration_s=2.5, partitions=0, device_faults=False,
                        kill_child=False, warmup_frac=0.0, dispatch_timeout_s=2.0,
                        watchdog_extra_rules=[tripwire], chaos=quiet, budget_ms=10_000.0)
    rep = PORT.nemesis.run_campaign(cfg)
    assert rep.incidents and not rep.incidents[0]["explained"]
    with pytest.raises(AssertionError) as ei:
        PORT.nemesis.assert_slos(rep, cfg)
    assert str(ei.value).startswith("induced_tripwire"), str(ei.value)[:120]


def test_undefined_concentration_is_no_sample():
    """A difference by design: while a heat aggregator's load spans fewer
    than two ranges its concentration index is undefined; the JAX hub
    exports it as 0 and the anomaly band learns that 0 as the level (a
    device engine's cold grid then reads its first real level as a shift:
    the scenario atlas's session_cache recipe on a device engine fires an
    unexplained heat_concentration_shift). The port's hub exports no
    sample until the index is defined, and then the same value as JAX."""
    import random

    def case(P):
        hub = _hub(P)
        agg = P.heatmap.KeyRangeHeatAggregator(key_words=4, capacity=4096, buckets=16,
                                               decay=0.9)
        hub.register_heat(agg, "heat")
        rng = random.Random(5)
        seen = []
        for b in range(6):
            txns = []
            for i in range(8):
                k = b"k%03d" % (0 if b < 3 else rng.randrange(400))
                t = P.types.CommitTransaction(read_snapshot=0)
                t.write_conflict_ranges.append(P.types.KeyRange(k, k + b"\x00"))
                txns.append(t)
            committed = int(P.types.TransactionCommitResult.COMMITTED)
            agg.observe_batch(txns, [committed] * len(txns), version=100 * (b + 1))
            hub.sync()
            m = hub.tdmetrics.metrics.get("heat.heat.1.concentration_x1000")
            seen.append((agg.concentration_defined() if P is PORT else None,
                         None if m is None else m.value))
        return seen

    port, jax = both(case)
    assert any(not d for d, _ in port) and any(d for d, _ in port)
    for (defined, pv), (_, jv) in zip(port, jax):
        assert pv == (jv if defined else None)
        if not defined:
            assert jv == 0
