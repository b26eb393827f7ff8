"""The port's scenario atlas (foundationdb_tpu_torch/real/scenarios.py)
against the JAX package's: the six recipes, their tenant mixes and
campaign configs, the shapers' streams (bit-identical across packages for
every txn shape and seed) and the signature of a fixed report are equal;
one oracle campaign per cheap recipe holds its scorecard's rows and a
bit-identical journal replay (tests/test_scenarios.py's fast case), held
to its invariants, not to a latency."""
import dataclasses
import json

import pytest

from torch_sim_world import BOTH, JAX, PORT, both, clean_world

ATLAS_NAMES = ("flash_sale", "payment_ledger", "secondary_index", "task_queue",
               "timeseries_ingest", "session_cache")


@pytest.fixture(autouse=True)
def _clean():
    clean_world()
    yield
    clean_world()


def _stream(P, shape, seed, n=400, **spec_kw):
    w = P.real_workload
    spec_kw.setdefault("n_keys", 128)
    spec = w.TenantSpec("t", target_tps=10, s=0.9, shape=shape, **spec_kw)
    rng = P.rng.DeterministicRandom(seed)
    sampler = w.ZipfKeySampler(spec.n_keys, spec.s, rng)
    shape_rng = P.rng.DeterministicRandom(seed + 1) if shape != "zipf" else None
    sh = w.TxnShaper(spec, sampler, shape_rng)
    return [sh.build(t_rel=i * 0.01) for i in range(n)]


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("shape", ["zipf", "rmw", "fanout", "monotone", "queue",
                                   "ttl_cache"])
def test_shaper_streams_bit_identical_across_packages(shape, seed):
    assert PORT.real_workload.TXN_SHAPES == JAX.real_workload.TXN_SHAPES
    port = _stream(PORT, shape, seed, ttl_sweep_every=10)
    assert port == _stream(JAX, shape, seed, ttl_sweep_every=10)
    assert port != _stream(PORT, shape, seed + 1, ttl_sweep_every=10)


def _cfg_dict(cfg):
    d = dataclasses.asdict(cfg)
    return json.loads(json.dumps(d, default=repr))


@pytest.mark.parametrize("engine_mode", ["oracle", "device_loop"])
def test_registry_and_configs_equal_jax(engine_mode):
    assert tuple(PORT.scenarios.SCENARIOS) == tuple(JAX.scenarios.SCENARIOS) == ATLAS_NAMES
    for name in ATLAS_NAMES:
        sp, sj = PORT.scenarios.SCENARIOS[name], JAX.scenarios.SCENARIOS[name]
        assert (sp.name, sp.title, sp.blurb) == (sj.name, sj.title, sj.blurb)
        for scale, dur in ((1.0, 3.5), (0.4, 2.5)):
            assert [dataclasses.asdict(t) for t in sp.tenants(scale, dur)] == \
                [dataclasses.asdict(t) for t in sj.tenants(scale, dur)]
        cp = PORT.scenarios.scenario_config(name, seed=7, engine_mode=engine_mode)
        cj = JAX.scenarios.scenario_config(name, seed=7, engine_mode=engine_mode)
        assert _cfg_dict(cp) == _cfg_dict(cj)
        assert cp.scenario == name and cp.elastic and cp.budget_ms > 0
        assert cp.resolved_budget_ms() == cj.resolved_budget_ms()


def _report(P):
    rep = P.nemesis.CampaignReport(cfg_seed=0, engine_mode="oracle")
    rep.heat = {"concentration": 0.42, "top_range": "hot/000001",
                "occupancy": {"frac": 0.25}, "gc_reclaimed": 7,
                "verdicts": {"committed": 80, "conflicts": 20, "too_old": 0},
                "history": {"appends": 3, "merges": 1}}
    rep.counts = {"offered": 100, "committed": 80, "conflicted": 20, "throttled": 10}
    return rep


def test_signature_and_score_equal_jax():
    def case(P):
        rep = _report(P)
        sig = P.scenarios.build_signature(rep)
        bare = P.nemesis.CampaignReport(cfg_seed=0, engine_mode="oracle")
        bare.counts = {"offered": 100, "committed": 80, "conflicted": 20, "throttled": 10}
        return json.loads(json.dumps([sig, P.scenarios.build_signature(bare)], default=repr))

    port, jax = both(case)
    assert port == jax
    assert port[1]["concentration"] == 0.0 and port[1]["abort_frac"] == 0.2


@pytest.mark.timeout(120)
@pytest.mark.parametrize("name", ["task_queue", "session_cache"])
def test_port_scenario_campaign_fast(name):
    """tests/test_scenarios.py's tier-1 seed for the two cheapest recipes
    on the port: the scorecard's abort and throttle rows, journal replay
    bit-identical through the clean serial oracle, every incident
    explained, the signature stamped into the report."""
    S = PORT.scenarios
    # the p99 budget out of reach of a loaded test host: the latency burn
    # must not fire an (unexplained) incident here
    cfg = S.scenario_config(name, seed=4226, duration_s=2.5, budget_ms=10_000.0)
    report = PORT.nemesis.run_campaign(cfg)
    row = S.score(report, cfg)
    assert report.scenario == name
    assert report.signature["concentration"] >= 0.0
    assert report.parity_checked > 0 and report.parity_mismatches == 0
    assert row["parity_mismatches"] == 0 and row["incidents_unexplained"] == 0
    assert all(i["explained"] for i in (report.incidents or []))
