"""Cluster-watchdog smoke: every alert rule's lifecycle on a virtual clock.

Port of ``foundationdb_tpu/tools/watch_smoke.py``. The watchdog is pure
host-side evaluation: this smoke touches no device, and `--device` is
taken only so that every smoke shares one command line:

    python -m foundationdb_tpu_torch.tools.watch_smoke [--device cpu]

A SYNTHETIC telemetry replay on a virtual clock drives every rule class
through its full lifecycle, with each check loud on failure
(docs/observability.md "Watchdog, burn rates & incidents"):

  1. EVERY RULE CLASS FIRES AND RESOLVES — the scripted fault phases
     (device arc, SLO burn, throttle wave, abort wave, concentration
     spike, commit stall, sync blip, steady recompile, memory pressure)
     each walk their rule pending -> firing -> resolved; at replay end
     every alert state is back to ok.
  2. BURN-RATE MATH MATCHES A HAND COMPUTATION — a directly-fed
     BurnRateRule's window_burn() must equal the by-hand
     (bad/total)/budget over engineered counters, exactly.
  3. INCIDENTS CORRELATE AND EXPLAIN — every scripted phase carries its
     injected window; after correlate() every incident is EXPLAINED,
     names its window kind, and the timeline is DETERMINISTIC (two
     replays of the same seed produce identical timelines).
  4. `fdbtpu_alerts` EXPOSITION PARSES — the hub text with alert/sli/
     admission series passes the strict line parser.

Prints one JSON line; any failed check exits non-zero.
"""
from __future__ import annotations

import json
import re
import sys
import time
from typing import Dict, List, Tuple

from ..core import telemetry
from ..core.rng import DeterministicRandom
from ..core.watchdog import BurnRateRule, Watchdog, default_rules

#: virtual tick width of the synthetic replay
TICK_S = 0.05

#: one exposition sample line (the strict-parser grammar, the same
#: regression check heat_smoke applies; the reference keeps this copy too)
_SAMPLE_RE = re.compile(
    r'^fdbtpu_[a-zA-Z_][a-zA-Z0-9_]*'
    r'(\{series="(\\.|[^"\\\n])*"\})? -?\d+(\.\d+)?$')


def strict_parse_prometheus(text: str) -> int:
    """Every sample matches the grammar and appears after its family's
    # HELP/# TYPE headers. Returns the sample count."""
    seen = set()
    samples = 0
    for ln in text.strip().split("\n"):
        if ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            fam = ln.split()[2]
            if ln.startswith("# TYPE "):
                assert ln.split()[3] == "gauge", ln
                assert fam in seen, f"TYPE before HELP: {ln!r}"
            seen.add(fam)
            continue
        assert _SAMPLE_RE.match(ln), f"unparseable exposition line: {ln!r}"
        assert ln.split("{")[0].split()[0] in seen, \
            f"sample before its # HELP/# TYPE header: {ln!r}"
        samples += 1
    return samples


def synthetic_replay(seed: int) -> Tuple[telemetry.TelemetryHub, Watchdog,
                                         List[Dict]]:
    """Drive a fresh hub + default-ruleset watchdog through a seeded
    synthetic fault script on a virtual clock. Returns (hub, watchdog,
    injected windows). Pure host-side and fully deterministic: the same
    seed must produce an identical `watchdog.timeline()` — the identity
    the determinism test replays twice."""
    hub = telemetry.TelemetryHub()
    hub.attach_watchdog(None)          # ours, not the knob's
    clock = [0.0]
    wd = Watchdog(default_rules(), now_fn=lambda: clock[0])
    hub.attach_watchdog(wd)
    rng = DeterministicRandom(seed)
    td = hub.tdmetrics
    windows: List[Dict] = []

    def w(kind: str, a: int, b: int) -> Dict:
        return {"kind": kind, "t0": a * TICK_S, "t1": b * TICK_S}

    # the script: disjoint fault phases with healthy gaps wide enough
    # (> the slow burn window + clear time) that each phase drains its
    # burn windows and closes its own incident before the next opens
    windows.append(w("device_fault", 100, 140))
    windows.append(w("slo_burn", 180, 240))
    windows.append(w("overload", 300, 360))
    windows.append(w("abort_wave", 420, 480))
    windows.append(w("hot_shard_shift", 540, 552))
    windows.append(w("commit_stall", 600, 646))
    windows.append(w("sync_blip", 680, 690))
    windows.append(w("recompile", 710, 720))
    windows.append(w("memory_pressure", 740, 750))
    good = bad = admitted = rejected = committed = conflicts = 0
    for step in range(1, 800):
        clock[0] = step * TICK_S

        def in_phase(a: int, b: int) -> bool:
            return a <= step < b

        # baseline healthy traffic (small seeded jitter keeps the
        # series honestly non-constant without tripping any band)
        rate = 4 + rng.random_int(0, 2)
        stalled = in_phase(600, 646)
        burn = in_phase(180, 240)
        if not stalled:
            good += rate if not burn else 3
            bad += 1 if burn else 0          # 25% bad >> the 1% budget
            admitted += rate
            committed += rate
        if in_phase(300, 360):
            rejected += 5                     # ~53% shed >> 20% budget
        if in_phase(420, 480):
            conflicts += 8                    # ~64% aborts >> 25% budget
        td.int64("sli.commit.total").set(good + bad)
        td.int64("sli.commit.good").set(good)
        td.int64("sli.commit.bad").set(bad)
        td.int64("admission.fleet.admitted").set(admitted)
        td.int64("admission.fleet.rejected").set(rejected)
        td.int64("engine.sim.verdicts.committed").set(committed)
        td.int64("engine.sim.verdicts.conflicts").set(conflicts)
        # device arc: healthy -> failed -> probation -> healthy
        state = 0
        if in_phase(100, 120):
            state = 2
        elif in_phase(120, 140):
            state = 3
        td.int64("resolver.sim.1.state").set(state)
        # heat concentration: stable band, then a step shift
        conc = 100 + rng.random_int(0, 3)
        if in_phase(540, 552):
            conc = 600
        td.int64("heat.sim.concentration_x1000").set(conc)
        td.int64("loop.sim.blocking_syncs").set(
            1 if in_phase(680, 690) else 0)
        td.int64("perf.sim.compiles_steady").set(
            1 if in_phase(710, 720) else 0)
        td.int64("resolver.sim.1.state_memory_pressure").set(
            1 if in_phase(740, 750) else 0)
        hub.sync()
    wd.correlate(windows, root_cause={
        "dominant_segment": "server_resolve", "dominant_ms": 4.2,
        "client_ms": 6.9, "rid": "synthetic", "version": 0, "err": None,
        "segments_ms": {"server_resolve": 4.2}})
    return hub, wd, windows


#: rule name -> the scripted phase that must fire it
EXPECTED_FIRINGS = {
    "engine_unhealthy": "device_fault",
    "slo_p99_burn": "slo_burn",
    "tenant_throttle_burn": "overload",
    "abort_frac_burn": "abort_wave",
    "heat_concentration_shift": "hot_shard_shift",
    "commit_flow_stalled": "commit_stall",
    "blocking_syncs": "sync_blip",
    "steady_state_compiles": "recompile",
    "state_memory_pressure": "memory_pressure",
}


def check_lifecycles(failures: List[str]) -> dict:
    hub, wd, _ = synthetic_replay(seed=2026)
    fired = {e["alert"] for e in wd.ring if e["state"] == "firing"}
    resolved = {e["alert"] for e in wd.ring if e["state"] == "resolved"}
    pended = {e["alert"] for e in wd.ring if e["state"] == "pending"}
    for rule, phase in EXPECTED_FIRINGS.items():
        for stage, pop in (("pending", pended), ("firing", fired),
                           ("resolved", resolved)):
            if rule not in pop:
                failures.append(
                    f"rule {rule} (phase {phase}) never reached {stage}")
    still = [a for a in wd.alerts_snapshot() if a["state"] != "ok"]
    if still:
        failures.append(f"alerts not back to ok at replay end: {still}")
    # every scripted incident explained by its injected window
    unexplained = [i.as_dict() for i in wd.incidents if not i.explained]
    if unexplained:
        failures.append(f"unexplained incidents: {unexplained}")
    if len(wd.incidents) < len(EXPECTED_FIRINGS) - 1:
        failures.append(
            f"only {len(wd.incidents)} incidents for "
            f"{len(EXPECTED_FIRINGS)} scripted phases")
    kinds = {w["kind"] for i in wd.incidents for w in i.windows}
    return {"fired": sorted(fired), "incidents": len(wd.incidents),
            "window_kinds": sorted(kinds), "hub": hub}


def check_burn_math(failures: List[str]) -> dict:
    """The burn arithmetic against a by-hand computation: 100 good + 25
    bad events inside a 2s window at a 1% budget burns
    (25/125)/0.01 = 20.0, exactly."""
    from ..core.watchdog import _SeriesView

    rule = BurnRateRule("hand", "sli.*.good", "sli.*.bad",
                        budget_frac=0.01, fast_s=0.5, slow_s=2.0,
                        threshold=2.0)
    hub = telemetry.TelemetryHub()
    hub.attach_watchdog(None)
    td = hub.tdmetrics
    view_t = 0.0
    good = bad = 0
    for i in range(41):                       # 0.05s ticks over 2.0s
        view_t = i * 0.05
        if i > 0:
            good += 5
            if i % 5 == 0:
                bad += 5
        td.int64("sli.commit.good").set(good)
        td.int64("sli.commit.bad").set(bad)
        list(rule.conditions(view_t, _SeriesView(td.metrics)))
    # hand: the whole history sits inside the slow 2s window, so the
    # deltas are good=200, bad=40 -> frac = 40/240,
    # burn = (40/240)/0.01 = 16.666...
    burn_slow, events = rule.window_burn(("commit",), 2.0, view_t)
    want = (bad / (good + bad)) / 0.01
    if abs(burn_slow - want) > 1e-9:
        failures.append(f"burn math: window_burn={burn_slow!r} "
                        f"hand={want!r}")
    if events != good + bad:
        failures.append(f"burn events {events} != {good + bad}")
    return {"burn_slow": round(burn_slow, 4), "hand": round(want, 4),
            "events": events}


def check_determinism(failures: List[str]) -> dict:
    _h1, wd1, _ = synthetic_replay(seed=7)
    _h2, wd2, _ = synthetic_replay(seed=7)
    if wd1.timeline() != wd2.timeline():
        failures.append("same-seed replays produced different timelines")
    _h3, wd3, _ = synthetic_replay(seed=8)
    return {"timeline_events": len(wd1.timeline()),
            "seeds_differ": wd3.timeline() != wd1.timeline()}


def check_exposition(failures: List[str], hub) -> dict:
    text = hub.prometheus_text()
    n = strict_parse_prometheus(text)
    for family in ("fdbtpu_alerts", "fdbtpu_sli", "fdbtpu_admission"):
        if f"# TYPE {family} gauge" not in text:
            failures.append(f"{family} family missing from exposition")
    alert_samples = text.count("fdbtpu_alerts{")
    if alert_samples < len(EXPECTED_FIRINGS):
        failures.append(f"only {alert_samples} fdbtpu_alerts samples")
    return {"samples": n, "alert_samples": alert_samples}


def run(device: str = "host") -> dict:
    """Every check; the result line main prints. `device` is only named
    in the line: the watchdog runs on the host."""
    t0 = time.time()
    failures: List[str] = []
    print("watch-smoke: synthetic lifecycle replay ...", flush=True)
    life = check_lifecycles(failures)
    hub = life.pop("hub")
    print(f"  fired: {', '.join(life['fired'])}")
    print(f"  incidents: {life['incidents']} "
          f"(windows: {', '.join(life['window_kinds'])})")
    print("watch-smoke: burn-rate hand computation ...", flush=True)
    burn = check_burn_math(failures)
    print(f"  window burn {burn['burn_slow']} == hand {burn['hand']} "
          f"over {burn['events']} events")
    print("watch-smoke: same-seed determinism ...", flush=True)
    det = check_determinism(failures)
    print(f"  {det['timeline_events']} timeline events bit-equal across "
          f"replays (different seed differs: {det['seeds_differ']})")
    print("watch-smoke: strict exposition parse ...", flush=True)
    try:
        exp = check_exposition(failures, hub)
    except AssertionError as e:
        failures.append(f"exposition: {e}")
        exp = None
    else:
        print(f"  {exp['samples']} samples parse, "
              f"{exp['alert_samples']} alert samples")
    dt = time.time() - t0
    for f in failures:
        print(f"  - {f}", file=sys.stderr)
    return {"metric": "watch_smoke", "device": str(device), "ok": not failures,
            "failures": failures, "lifecycles": life, "burn": burn,
            "determinism": det, "exposition": exp, "seconds": round(dt, 3)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="taken for a uniform command line; the watchdog "
                         "runs on the host")
    ap.parse_args(argv)
    out = run("host")
    print(json.dumps(out))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
