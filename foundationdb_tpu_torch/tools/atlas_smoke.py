"""Scenario-atlas smoke: two recipes end to end, in under a minute.

Port of ``foundationdb_tpu/tools/atlas_smoke.py``. Its campaigns resolve
on the oracle (scenario_config's default engine mode): it touches no
device, and `--device` is taken only so that every smoke shares one
command line:

    python -m foundationdb_tpu_torch.tools.atlas_smoke [--device cpu]

Five checks, each loud on failure (docs/scenarios.md):

  1. TWO RECIPES RUN GREEN END-TO-END — miniature flash_sale and
     session_cache campaigns through the REAL run_campaign machinery
     (elastic group, one injected partition, watchdog + spans + journal
     parity) with every scorecard contract row asserted: p99 outside
     injected windows inside budget, abort/throttle fractions inside
     the recipe's rows, journal replay bit-identical through the clean
     serial oracle, every firing incident explained.
  2. SIGNATURES DISCRIMINATE — the flash-sale heat signature must be
     measurably more concentrated than the read-mostly session cache's
     (the atlas exists to tell workload shapes apart, not to average
     them away).
  3. SCENARIO STAMPS PERSIST — the written report JSON carries the
     `scenario` and `signature` fields per campaign and `cli atlas`
     renders the scorecard table from the file (and the live gauges
     from this process's hub).
  4. PROMETHEUS EXPOSITION PARSES — the hub text now carries
     `scenario.*` series; the `fdbtpu_scenario` family must be present
     with both recipes' `slo_pass` gauges at 1 and the whole exposition
     must pass the strict line parser (heat_smoke's).
  5. ARTIFACT HYGIENE — everything this smoke writes lands under the
     gitignored `_artifacts/` directory (or the directory the caller
     passes), never at the repo root.

Prints one JSON line; any failed check exits non-zero.
"""
from __future__ import annotations

import io
import json
import os
import sys
import time

from ..core import telemetry
from ..real.scenarios import (SCENARIOS, assert_scenario_slos,
                              publish_scenario, scenario_config, score)
from ..real.nemesis import run_campaign
from .heat_smoke import strict_parse_prometheus

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARTIFACTS = os.path.join(REPO_ROOT, "_artifacts")
#: tier-1-grade serving budget (the reference's): the atlas factor
#: already prices the elastic+watchdog stack, but this smoke must stay
#: green on a noisy shared host
SMOKE_BUDGET_MS = 250.0
PAIR = ("flash_sale", "session_cache")


def check_atlas(artifacts: str = ARTIFACTS) -> dict:
    """Checks 1-5, every artifact under `artifacts`; raises AssertionError
    on a miss. Returns each recipe's scorecard row."""
    t0 = time.time()
    telemetry.reset()
    os.makedirs(artifacts, exist_ok=True)

    # -- 1. two miniature recipes, every contract row asserted ----------
    reports = {}
    rows = {}
    cfgs = {}
    for i, name in enumerate(PAIR):
        cfg = scenario_config(name, seed=4126 + i * 10, duration_s=2.5,
                              budget_ms=SMOKE_BUDGET_MS)
        rep = run_campaign(cfg)
        rows[name] = assert_scenario_slos(rep, cfg)
        reports[name] = rep
        cfgs[name] = cfg
        print(f"[atlas-smoke] {name}: slo_pass={rows[name]['slo_pass']} "
              f"p99={rows[name]['p99_ms']}ms "
              f"abort={rows[name]['abort_frac']} "
              f"conc={rows[name]['signature']['concentration']}")
    assert all(r["slo_pass"] == 1 for r in rows.values()), rows

    # -- 2. the signatures must tell the two shapes apart ---------------
    hot = rows["flash_sale"]["signature"]
    cold = rows["session_cache"]["signature"]
    assert hot["concentration"] > cold["concentration"] + 0.05, (
        "flash-sale heat signature not discriminably hotter than the "
        f"session cache's: {hot['concentration']} vs "
        f"{cold['concentration']}")
    assert hot["top_range"] and hot["top_range"].startswith("sale"), hot

    # -- 3. stamps persist through the report file + both cli renders ---
    path = os.path.join(artifacts, "atlas_smoke_report.json")
    with open(path, "w") as f:
        json.dump({"campaigns": [r.as_dict() for r in reports.values()]},
                  f, default=str)
    from .cli import Cli

    cli = Cli.__new__(Cli)
    cli.out = io.StringIO()
    cli.do_atlas([path])
    text = cli.out.getvalue()
    for name in PAIR:
        assert name in text, f"cli atlas lost {name}:\n{text}"
    assert "—" not in text.split("top range")[1], text
    # run_campaign resets the hub per campaign for isolation, so only
    # the last recipe's gauges survived — re-publish both scorecards the
    # way a long-lived operator process holds them, then render live
    for name in PAIR:
        publish_scenario(name, reports[name])
        score(reports[name], cfgs[name])
    cli.out = io.StringIO()
    cli.do_atlas([])    # live render from this process's gauges
    live = cli.out.getvalue()
    for name in PAIR:
        assert name in live and "ok" in live, f"live atlas:\n{live}"
    print(f"[atlas-smoke] cli atlas renders file + live views")

    # -- 4. strict fdbtpu_scenario exposition ---------------------------
    expo = telemetry.hub().prometheus_text()
    n = strict_parse_prometheus(expo)
    assert "# TYPE fdbtpu_scenario gauge" in expo, expo[:400]
    for name in PAIR:
        assert f'series="{name}.slo_pass"' in expo, (
            f"missing {name}.slo_pass series")
    slo_lines = [ln for ln in expo.splitlines()
                 if "slo_pass" in ln and ln.startswith("fdbtpu_scenario")]
    assert slo_lines and all(ln.rstrip().endswith(" 1")
                             for ln in slo_lines), slo_lines
    print(f"[atlas-smoke] strict prometheus parse: {n} samples, "
          f"{len(slo_lines)} slo_pass gauges all 1")

    # -- 5. nothing landed at the repo root -----------------------------
    for stray in ("chaos_crash_report.json", "atlas_smoke_report.json"):
        assert not os.path.exists(os.path.join(REPO_ROOT, stray)), (
            f"artifact stray at repo root: {stray}")

    print(f"[atlas-smoke] OK in {time.time() - t0:.1f}s "
          f"({len(PAIR)}/{len(SCENARIOS)} recipes at miniature scale)")
    return {name: {k: rows[name].get(k) for k in ("slo_pass", "p99_ms", "abort_frac",
                                                    "signature")}
            for name in PAIR}


def run(device: str = "host", artifacts: str = ARTIFACTS) -> dict:
    """Every check; the result line main prints. `device` is only named
    in the line: the oracle resolves on the host."""
    t0 = time.perf_counter()
    failures, rows = [], None
    try:
        rows = check_atlas(artifacts)
    except AssertionError as e:
        failures.append(str(e))
    return {"metric": "atlas_smoke", "device": str(device), "ok": not failures,
            "failures": failures, "recipes": rows, "artifacts": artifacts,
            "seconds": round(time.perf_counter() - t0, 3)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="taken for a uniform command line; the oracle "
                         "resolves on the host")
    ap.add_argument("--artifacts", default=ARTIFACTS,
                    help="where the report goes (default: _artifacts/)")
    args = ap.parse_args(argv)
    out = run("host", args.artifacts)
    print(json.dumps(out, default=str))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
