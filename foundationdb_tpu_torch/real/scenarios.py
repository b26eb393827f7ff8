"""The scenario atlas: machine-asserted production workload recipes.

Port of ``foundationdb_tpu/real/scenarios.py``.

"Millions of users" was one knob — a Zipf skew s ∈ {0, 0.9, 1.2} — while
the observability stack (traces, heat, watchdog incidents, the black-box
journal, the trend gate) only ever watched that one shape. This module is
ROADMAP item 6's library of NAMED production scenarios: each a
declarative `ScenarioSpec` (tenant mix, txn shape, drift, nemesis
profile, SLO budget rows) instantiated through the SAME `run_campaign`
machinery every chaos campaign uses, so nothing about a scenario run is
bespoke — the p99-outside-windows math, the journal replay parity, the
watchdog incident correlation and the black-box journal all apply
unchanged (docs/scenarios.md).

The six recipes cover the ordered-store access shapes the SmartNIC
ordered-KV paper catalogs, stressing the concurrency structures Proust's
design-space analysis frames (PAPERS.md):

  * **flash_sale** — a heat spike on a tiny pool: reshard + admission
    interplay under concentrated contention;
  * **payment_ledger** — read-modify-write chains over balance rows:
    the conflict-heavy shape the conflict scheduler earns its keep on;
  * **secondary_index** — every base-row update fans out to index
    entries under disjoint prefixes: multi-range transactions;
  * **task_queue** — append at the tail, claim at the head: the future
    commutative-lane showcase (appends commute, claims contend);
  * **timeseries_ingest** — monotone tail keys: the adversarial case
    for key-range splits (the tail outruns any split chosen from past
    heat);
  * **session_cache** — read-mostly with cadenced TTL RANGE deletes.

Every run produces a **scorecard**: per-scenario SLO verdicts (p99
outside injected windows, abort fraction, throttle share, reshard
blackout budgets, parity, incidents-all-explained) plus a heat/abort
**signature** (concentration, top-range shares, witness mix) stamped
into the report, the `scenario.<name>.*` telemetry gauges
(`fdbtpu_scenario` family) and the black-box journal's `scenario`
event. `cli atlas` renders scorecards live or cluster-less;
`run_scenario_atlas` is bench.py's `scenario_atlas` section, whose
per-scenario headline metrics tools/bench_history.py gates.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..core import telemetry
from ..core.knobs import SERVER_KNOBS
from .workload import TenantSpec
from .nemesis import CampaignReport, NemesisConfig, run_campaign, assert_slos

#: budget multiplier for the atlas serving point, the
#: ELASTIC_BUDGET_FACTOR precedent one notch further: every scenario
#: serves through the elastic resolver group (host-side routing, dedup
#: cache, group-heat accounting) WITH spans, watchdog and the black-box
#: journal all on, and the shaped streams (range deletes, fan-out
#: multi-range txns) pack heavier conflict sets than the classic point
#: stream — on a shared CI box that stacks tens of ms of co-resident
#: scheduler noise onto the 60 ms knob product. The atlas measures
#: SHAPE DISCRIMINATION (does each recipe hold its own contract), not
#: the capacity knee `run_served_under_chaos` prices.
ATLAS_BUDGET_FACTOR = 4.0


@dataclass(frozen=True)
class ScenarioSpec:
    """One named production recipe: how to build its fleet, which
    nemesis profile it runs under, and the SLO budget rows its scorecard
    is judged by."""

    name: str
    title: str
    blurb: str
    #: (scale, duration_s) -> tenant mix. `scale` follows the
    #: NemesisConfig.default_tenants convention (1.0 oracle, 0.4 for
    #: CPU-emulated device modes).
    make_tenants: Callable[[float, float], List[TenantSpec]]
    #: NemesisConfig field overrides applied on top of the atlas
    #: defaults (elastic group, one partition, watchdog + spans on)
    profile: Dict = field(default_factory=dict)
    #: scorecard budget rows
    max_abort_frac: float = 0.30
    max_throttle_frac: float = 0.45
    min_commits: int = 40

    def tenants(self, scale: float, duration_s: float) -> List[TenantSpec]:
        return self.make_tenants(scale, duration_s)


def _flash_sale(scale: float, duration_s: float) -> List[TenantSpec]:
    return [
        # the sale: a severe Zipf head on a tiny pool — the heat spike
        # the reshard controller and admission must absorb together
        TenantSpec("sale", target_tps=55 * scale, s=1.5, n_keys=128),
        TenantSpec("browse", target_tps=30 * scale, s=0.6, n_keys=1024,
                   reads_per_txn=3, writes_per_txn=1),
    ]


def _payment_ledger(scale: float, duration_s: float) -> List[TenantSpec]:
    return [
        # balance rows: every write read first at the same snapshot
        TenantSpec("ledger", target_tps=50 * scale, s=1.1, n_keys=96,
                   writes_per_txn=2, shape="rmw"),
        # read-only audit scans over the same rows
        TenantSpec("audit", target_tps=20 * scale, s=0.3, n_keys=512,
                   reads_per_txn=3, writes_per_txn=0),
    ]


def _secondary_index(scale: float, duration_s: float) -> List[TenantSpec]:
    return [
        # one base-row update -> three index entries, disjoint prefixes
        TenantSpec("index", target_tps=45 * scale, s=0.9, n_keys=256,
                   writes_per_txn=3, shape="fanout"),
        TenantSpec("lookup", target_tps=30 * scale, s=0.9, n_keys=256,
                   reads_per_txn=2, writes_per_txn=0),
    ]


def _task_queue(scale: float, duration_s: float) -> List[TenantSpec]:
    return [
        # producers append at the tail, consumers claim at the head
        TenantSpec("workers", target_tps=55 * scale, s=0.0, n_keys=256,
                   shape="queue"),
        TenantSpec("bg", target_tps=20 * scale, s=0.0, n_keys=512),
    ]


def _timeseries_ingest(scale: float, duration_s: float) -> List[TenantSpec]:
    return [
        # monotone tail appends: the hottest range is always the newest
        TenantSpec("ingest", target_tps=55 * scale, s=0.8, n_keys=512,
                   shape="monotone"),
        TenantSpec("dash", target_tps=20 * scale, s=0.9, n_keys=512,
                   reads_per_txn=3, writes_per_txn=0),
    ]


def _session_cache(scale: float, duration_s: float) -> List[TenantSpec]:
    return [
        # read-mostly point gets; one commit in ttl_sweep_every is a
        # (begin, end) RANGE delete clearing a cold segment
        TenantSpec("sessions", target_tps=60 * scale, s=0.9, n_keys=512,
                   reads_per_txn=3, shape="ttl_cache",
                   ttl_sweep_every=24, ttl_sweep_span=64),
        TenantSpec("writer", target_tps=15 * scale, s=0.9, n_keys=512,
                   reads_per_txn=1, writes_per_txn=1),
    ]


#: the atlas, in scorecard order. Every scenario runs through the
#: elastic resolver group (host-fed heat -> a real signature) with one
#: injected partition, watchdog + spans + the standard parity replay.
SCENARIOS: Dict[str, ScenarioSpec] = {
    s.name: s for s in (
        ScenarioSpec(
            "flash_sale", "flash-sale hotspot",
            "heat spike on a tiny pool: reshard + admission interplay",
            _flash_sale,
            profile={"reshard": True},
            max_abort_frac=0.35, max_throttle_frac=0.50),
        ScenarioSpec(
            "payment_ledger", "payment ledger",
            "read-modify-write chains over balance rows, conflict-heavy",
            _payment_ledger,
            profile={"sched": True},
            max_abort_frac=0.40, max_throttle_frac=0.45),
        ScenarioSpec(
            "secondary_index", "secondary-index maintenance",
            "write fan-out: one base update, multi-range index txns",
            _secondary_index,
            max_abort_frac=0.30, max_throttle_frac=0.45),
        ScenarioSpec(
            "task_queue", "task queue",
            "append/claim streams — the commutative-lane showcase",
            _task_queue,
            profile={"sched": True},
            max_abort_frac=0.35, max_throttle_frac=0.45),
        ScenarioSpec(
            "timeseries_ingest", "time-series ingest",
            "monotone tail keys, adversarial for key-range splits",
            _timeseries_ingest,
            profile={"reshard": True},
            max_abort_frac=0.30, max_throttle_frac=0.45),
        ScenarioSpec(
            "session_cache", "session cache",
            "read-mostly with cadenced TTL range deletes",
            _session_cache,
            # TTL sweeps are exactly the range-deletion GC lane the
            # tiered history structure turns into O(batch) work
            # (docs/perf.md "Incremental history maintenance") — the
            # atlas pins that lane on device engine modes
            profile={"history_structure": "tiered"},
            max_abort_frac=0.20, max_throttle_frac=0.45),
    )
}


def scenario_config(name: str, seed: int, engine_mode: str = "oracle",
                    duration_s: float = 3.5, **kw) -> NemesisConfig:
    """The named recipe as a NemesisConfig: atlas defaults (elastic
    group, one short partition, watchdog + spans), the scenario's tenant
    mix and profile overrides, and the `scenario` stamp that makes
    run_campaign record the signature + black-box event. Explicit `kw`
    wins over the scenario profile (tests pin budgets and toggle layers
    the same way drift_config callers do)."""
    spec = SCENARIOS[name]
    scale = 1.0 if engine_mode == "oracle" else 0.4
    merged = {
        "partitions": 1, "partition_s": 0.4,
        "device_faults": False, "kill_child": False,
        "elastic": True, "watchdog": True,
    }
    merged.update(spec.profile)
    merged.update(kw)
    if merged.get("reshard"):
        merged.setdefault("reshard_spares", 1)
    merged.setdefault(
        "budget_ms",
        float(SERVER_KNOBS.resolver_p99_budget_ms)
        * float(SERVER_KNOBS.real_chaos_budget_factor)
        * ATLAS_BUDGET_FACTOR)
    return NemesisConfig(
        seed=seed, engine_mode=engine_mode, duration_s=duration_s,
        tenants=spec.tenants(scale, duration_s), scenario=name, **merged)


def build_signature(report: CampaignReport) -> dict:
    """The scenario's heat/abort signature, from fields the campaign
    already measured: load concentration and top-range shares (the
    group's host-fed heat snapshot), the verdict mix, witness count, and
    the abort/throttle fractions of the served stream. Engines without
    the heat layer yield an honest all-zero heat half — the scorecard
    rows that read it stay rendered, never KeyError."""
    heat = report.heat or {}
    counts = report.counts or {}
    offered = max(counts.get("offered", 0), 1)
    served = counts.get("committed", 0) + counts.get("conflicted", 0)
    hot = heat.get("hot_ranges") or []
    return {
        "concentration": round(float(heat.get("concentration", 0.0)), 4),
        "top_range": hot[0]["begin"] if hot else None,
        "top_share": round(float(hot[0]["share"]), 4) if hot else 0.0,
        "top_ranges": [{"begin": r.get("begin"),
                        "share": round(float(r.get("share", 0.0)), 4)}
                       for r in hot[:3]],
        "verdicts": dict(heat.get("verdicts") or {}),
        "witnesses": len(heat.get("recent_attribution") or []),
        "abort_frac": round(counts.get("conflicted", 0) / max(served, 1), 4),
        "throttle_frac": round(counts.get("throttled", 0) / offered, 4),
        # GC + history-maintenance half: rows reclaimed by the horizon /
        # TTL range-delete lane, and the tiered structure's append/merge
        # counters (all-zero on monolithic engines — honest, not absent)
        "gc_reclaimed": int(heat.get("gc_reclaimed", 0)),
        "history": {k: int(v) for k, v in
                    (heat.get("history") or {}).items()},
    }


def publish_scenario(name: str, report: CampaignReport) -> None:
    """The scorecard's measured half as `scenario.<name>.*` gauges
    (`fdbtpu_scenario` Prometheus family; fractions x1000 fixed-point,
    the heat-family convention). `score()` adds the verdict gauge."""
    td = telemetry.hub().tdmetrics
    sig = report.signature or {}
    p99 = report.p99_outside_ms
    td.int64(f"scenario.{name}.p99_us").set(
        int(p99 * 1000) if p99 == p99 else -1)
    td.int64(f"scenario.{name}.abort_frac_x1000").set(
        int(sig.get("abort_frac", 0.0) * 1000))
    td.int64(f"scenario.{name}.throttle_frac_x1000").set(
        int(sig.get("throttle_frac", 0.0) * 1000))
    td.int64(f"scenario.{name}.concentration_x1000").set(
        int(sig.get("concentration", 0.0) * 1000))
    td.int64(f"scenario.{name}.committed").set(
        int((report.counts or {}).get("committed", 0)))
    td.int64(f"scenario.{name}.gc_reclaimed").set(
        int(sig.get("gc_reclaimed", 0)))


def score(report: CampaignReport, cfg: NemesisConfig) -> dict:
    """One scorecard row: every SLO budget row of the scenario judged
    against the measured campaign, verdict-first so `cli atlas` renders
    a pass/fail column per contract row. `slo_pass` is the AND of every
    row — the integer the bench section records and the trend gate
    guards per scenario."""
    spec = SCENARIOS[cfg.scenario]
    sig = report.signature or build_signature(report)
    budget = cfg.resolved_budget_ms()
    p99 = report.p99_outside_ms
    p99_ok = bool(p99 == p99 and p99 <= budget)
    abort_ok = bool(sig["abort_frac"] <= spec.max_abort_frac)
    throttle_ok = bool(sig["throttle_frac"] <= spec.max_throttle_frac)
    commits_ok = bool(
        (report.counts or {}).get("committed", 0) >= spec.min_commits)
    parity_ok = bool(report.parity_checked > 0
                     and report.parity_mismatches == 0)
    unexplained = sum(1 for inc in report.incidents or []
                      if not inc.get("explained"))
    rs = report.reshard or {}
    bo_budget = float(SERVER_KNOBS.reshard_blackout_budget_ms)
    blackout_ok = all(
        op.get("blackout_ms", 0.0) <= bo_budget
        for op in rs.get("ops", []) if op.get("state") == "done")
    row = {
        "scenario": cfg.scenario,
        "title": spec.title,
        "seed": cfg.seed,
        "engine_mode": cfg.engine_mode,
        "p99_ms": round(p99, 3) if p99 == p99 else None,
        "budget_ms": round(budget, 1),
        "p99_ok": p99_ok,
        "abort_frac": sig["abort_frac"],
        "max_abort_frac": spec.max_abort_frac,
        "abort_ok": abort_ok,
        "throttle_frac": sig["throttle_frac"],
        "max_throttle_frac": spec.max_throttle_frac,
        "throttle_ok": throttle_ok,
        "committed": (report.counts or {}).get("committed", 0),
        "min_commits": spec.min_commits,
        "commits_ok": commits_ok,
        "sustained_tps": report.sustained_tps,
        "parity_checked": report.parity_checked,
        "parity_mismatches": report.parity_mismatches,
        "parity_ok": parity_ok,
        "incidents_unexplained": unexplained,
        "incidents_ok": unexplained == 0,
        "reshards_executed": rs.get("executed", 0),
        "blackout_ok": blackout_ok,
        "signature": sig,
        "slo_pass": int(p99_ok and abort_ok and throttle_ok and commits_ok
                        and parity_ok and unexplained == 0 and blackout_ok),
    }
    telemetry.hub().tdmetrics.int64(
        f"scenario.{cfg.scenario}.slo_pass").set(row["slo_pass"])
    return row


def assert_scenario_slos(report: CampaignReport, cfg: NemesisConfig,
                         min_outside: int = 50) -> dict:
    """The standard campaign SLO contract (assert_slos) PLUS the
    scenario's own budget rows; returns the scorecard row on success so
    callers assert and render from the same judgment."""
    assert_slos(report, cfg, min_outside=min_outside)
    row = score(report, cfg)
    failed = [k for k in ("p99_ok", "abort_ok", "throttle_ok",
                          "commits_ok", "parity_ok", "incidents_ok",
                          "blackout_ok") if not row[k]]
    assert not failed, (
        f"scenario {cfg.scenario} failed contract rows {failed}: {row}")
    return row


def run_scenario(name: str, seed: int = 4026, engine_mode: str = "oracle",
                 duration_s: float = 3.5, **kw):
    """One named scenario end-to-end: campaign + scorecard. Returns
    (CampaignReport, scorecard row); the row's `slo_pass` is the
    machine verdict (use assert_scenario_slos to raise instead)."""
    cfg = scenario_config(name, seed, engine_mode, duration_s, **kw)
    report = run_campaign(cfg)
    return report, score(report, cfg)


def run_scenario_atlas(seconds: float = 3.5, seed: int = 4026,
                       engine_mode: str = "oracle",
                       names: Optional[List[str]] = None,
                       **kw) -> dict:
    """The whole atlas, one campaign per scenario (bench.py
    `scenario_atlas`, recorded from BENCH_r11 on): per-scenario headline
    metrics under `scenarios.<name>.*` — the dotted paths
    tools/bench_history.py registers so an induced regression in ANY
    one scenario fails the trend gate — plus the full scorecard rows
    `cli atlas` renders from the artifact."""
    names = list(names or SCENARIOS)
    scorecard = []
    for i, name in enumerate(names):
        cfg = scenario_config(name, seed + i * 10, engine_mode, seconds,
                              **kw)
        report = run_campaign(cfg)
        scorecard.append(score(report, cfg))
    return {
        "seconds": seconds,
        "seed": seed,
        "engine_mode": engine_mode,
        "scenarios": {
            row["scenario"]: {
                "slo_pass": row["slo_pass"],
                "p99_ms": row["p99_ms"],
                "budget_ms": row["budget_ms"],
                "sustained_tps": row["sustained_tps"],
                "abort_frac": row["abort_frac"],
                "throttle_frac": row["throttle_frac"],
                "concentration": row["signature"]["concentration"],
                "committed": row["committed"],
                "parity_mismatches": row["parity_mismatches"],
                "incidents_unexplained": row["incidents_unexplained"],
                "reshards_executed": row["reshards_executed"],
            } for row in scorecard},
        "scorecard": scorecard,
        "all_green": int(all(r["slo_pass"] for r in scorecard)),
    }
