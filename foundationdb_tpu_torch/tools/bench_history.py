"""Bench-artifact trend tables and the regression gate.

Port of ``foundationdb_tpu/tools/bench_history.py``, whole, with one
difference by design: `platform_of` classifies an artifact whose device
names an NVIDIA card ("NVIDIA H100 80GB HBM3") as `gpu`, so the port's card
rounds never compare with the TPU or CPU rounds.

The repo commits one `BENCH_rNN.json` per recorded bench run, but nothing
ever read the series: a regression only surfaced if someone eyeballed two
JSON blobs. This module loads the full `BENCH_r*.json` history, builds
per-section trend tables (one row per tracked metric, one column per
round), and renders noise-aware verdicts:

  * **headline metrics** (the txn/s figures a release is judged by) FAIL
    the gate when the newest artifact regresses more than the threshold
    (default 10%) against the previous artifact **on the same platform**;
  * every other tracked metric is informational: the table shows the
    trend arrow and percentage, but only headline regressions gate.

Platform awareness is the load-bearing design point: the artifacts record
the device they ran on (`"TPU v5 lite0"`, a CPU backend, ...), and a
device-time figure measured on a TPU is NOT comparable to one measured on
CPU. A platform change between consecutive artifacts therefore resets the
comparison baseline — the verdict is `platform-change`, never
`regressed` — and the gate compares each artifact against the newest
OLDER artifact of the same platform instead. Noise awareness: each metric
carries a noise fraction (host-side wall timings on a shared box swing
tens of percent; device scan timings are tight), and the verdict fires
only beyond max(threshold, noise).

    python -m foundationdb_tpu_torch.tools.bench_history            # tables
    python -m foundationdb_tpu_torch.tools.bench_history --json
    tools/cli.py bench-history                                 # same
    make bench-history

Exit status is non-zero on any gated regression (naming the section and
metric), so `make bench-history` is a CI gate the same way `make lint`
is.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: gate threshold: a headline metric this much worse than the previous
#: same-platform artifact fails the run
DEFAULT_THRESHOLD = 0.10


class Metric:
    """One tracked (section, dotted path) with its comparison policy."""

    __slots__ = ("section", "path", "label", "higher_is_better", "headline",
                 "noise_frac")

    def __init__(self, section: str, path: str, label: str, *,
                 higher_is_better: bool = True, headline: bool = False,
                 noise_frac: float = 0.05):
        self.section = section
        self.path = path
        self.label = label
        self.higher_is_better = higher_is_better
        self.headline = headline
        self.noise_frac = noise_frac

    @property
    def key(self) -> str:
        return f"{self.section}.{self.path}" if self.path else self.section


#: the tracked metrics, grouped by artifact section. Headline = the
#: figures the README leads with; everything else is informational.
METRICS: Tuple[Metric, ...] = (
    Metric("", "value", "resolved txn/s/chip", headline=True),
    Metric("", "device_ms_per_batch", "device ms/batch",
           higher_is_better=False),
    Metric("", "host_pack_ms_per_batch", "host pack ms/batch",
           higher_is_better=False, noise_frac=0.25),
    Metric("", "native_cpu_txns_per_sec", "native C++ txn/s",
           noise_frac=0.25),
    Metric("sharded_tpu_weak_scale", "v5e8_extrapolated_txns_per_sec",
           "extrapolated v5e-8 txn/s", headline=True),
    # the r05-era ESTIMATED collective: recorded only by chip-era
    # artifacts (the section is absent on CPU profiles), so platform
    # awareness pins it to its own era — it never compares against the
    # MEASURED figures below, which carry the platform they ran on
    Metric("sharded_tpu_weak_scale", "collective_est_ms",
           "estimated ICI collective ms (chip era)",
           higher_is_better=False, noise_frac=0.0),
    Metric("sharded_measured", "collective_ms.8",
           "measured psum ms @8 shards", higher_is_better=False,
           noise_frac=0.5),
    Metric("sharded_measured", "scaling.8.txns_per_s",
           "mesh txn/s @8 shards (total-compute on cpu)", noise_frac=0.25),
    Metric("sharded_measured", "scaling.8.exchange_ms",
           "mesh exchange interval ms @8 shards", higher_is_better=False,
           noise_frac=0.5),
    Metric("sharded_measured", "overlap_ab.speedup",
           "mesh overlapped/serialized speedup", noise_frac=0.25),
    Metric("sharded_measured", "overlap_ab.blocking_syncs",
           "mesh ring blocking syncs", higher_is_better=False,
           noise_frac=0.0),
    Metric("sharded_measured", "scaling.8.parity.mismatches",
           "mesh parity mismatches @8 shards", higher_is_better=False,
           noise_frac=0.0),
    Metric("latency_curve", "production_point.txns_per_sec",
           "serial production txn/s"),
    Metric("latency_under_load", "production_point.sustained_txns_per_sec",
           "pipelined sustained txn/s", headline=True),
    Metric("latency_under_load", "production_point.p99_ms",
           "pipelined p99 ms", higher_is_better=False, noise_frac=0.15),
    Metric("bucket_ladder", "steady_state_compiles",
           "steady-state compiles", higher_is_better=False, noise_frac=0.0),
    Metric("history_floor", "points.-1.bsearch_speedup",
           "bsearch speedup @max occupancy"),
    Metric("history_floor", "apply.points.-1.tiered_speedup",
           "tiered apply speedup @max occupancy"),
    Metric("history_floor", "apply.steady_state_compiles.tiered",
           "tiered apply steady-state compiles", higher_is_better=False,
           noise_frac=0.0),
    Metric("loop_floor", "loop_speedup", "loop host-time speedup",
           noise_frac=0.25),
    Metric("loop_floor", "loop_stats.blocking_syncs", "loop blocking syncs",
           higher_is_better=False, noise_frac=0.0),
    Metric("served_under_chaos", "users_served_per_chip.no_nemesis",
           "users served/chip"),
    Metric("served_while_resharding",
           "users_served_per_chip.while_resharding",
           "users served/chip while resharding", noise_frac=0.25),
    Metric("served_while_resharding", "resharding.blackout_ms_max",
           "worst reshard blackout ms", higher_is_better=False,
           noise_frac=0.5),
    Metric("conflict_heat", "overhead.overhead_pct", "heat overhead %",
           higher_is_better=False, noise_frac=0.5),
    Metric("compile_memory", "peak_hbm_bytes", "peak compiled-program HBM",
           higher_is_better=False, noise_frac=0.15),
    Metric("compile_memory", "steady_state_compiles",
           "post-warmup compiles", higher_is_better=False, noise_frac=0.0),
    Metric("recovery", "rewarm.rewarm_speedup",
           "progcache rewarm speedup", noise_frac=0.5),
    Metric("recovery", "rewarm.warm.compiles",
           "progcache-warm rewarm compiles", higher_is_better=False,
           noise_frac=0.0),
    Metric("recovery", "replay.speedup",
           "snapshot vs full-journal replay", noise_frac=0.5),
    Metric("recovery", "crash.blackout_ms",
           "crash recovery blackout ms", higher_is_better=False,
           noise_frac=0.5),
    # scenario atlas (real/scenarios.py, recorded from BENCH_r11): every
    # scenario's SLO verdict is a zero-noise HEADLINE — a 1 -> 0 drop in
    # ANY recipe fails the gate outright, and a scenario that stops
    # being recorded trips the headline went-missing check. The measured
    # abort fractions ride along informationally at chaos-grade noise.
    *(Metric("scenario_atlas", f"scenarios.{name}.slo_pass",
             f"{name} scenario SLO pass", headline=True, noise_frac=0.0)
      for name in ("flash_sale", "payment_ledger", "secondary_index",
                   "task_queue", "timeseries_ingest", "session_cache")),
    # sustained tps is bounded above by the recipe's fixed offered rate
    # (it can't inflate), so a beyond-noise drop is a real serving
    # regression; the abort/throttle fractions are judged by slo_pass
    # instead of raw trend rows — at ~0.005 absolute they are too
    # ratio-noisy for a relative gate
    *(Metric("scenario_atlas", f"scenarios.{name}.sustained_tps",
             f"{name} scenario sustained txn/s", noise_frac=0.5)
      for name in ("flash_sale", "payment_ledger", "session_cache")),
)


def load_parsed(path: Path) -> dict:
    d = json.loads(path.read_text())
    return d.get("parsed", d)


def load_series(root: Path) -> List[Tuple[int, str, dict]]:
    """Every committed BENCH_r*.json, oldest first: (round, name, parsed)."""
    out = []
    for p in root.glob("BENCH_r*.json"):
        m = re.search(r"r(\d+)", p.stem)
        if not m:
            continue
        out.append((int(m.group(1)), p.name, load_parsed(p)))
    out.sort(key=lambda t: t[0])
    return out


def platform_of(parsed: dict) -> str:
    """Comparison class of an artifact: the device family it measured
    on. Timings from different families never compare."""
    dev = str(parsed.get("device", "")).lower()
    if "tpu" in dev:
        return "tpu"
    if "cpu" in dev or "tfrt" in dev:
        return "cpu"
    if "gpu" in dev or "cuda" in dev or "nvidia" in dev:
        return "gpu"
    return dev.split(" ")[0] if dev else "unknown"


def extract(parsed: dict, metric: Metric) -> Optional[float]:
    return extract_path(parsed, metric.section, metric.path)


def extract_path(parsed: dict, section: str, path: str) -> Optional[float]:
    """A numeric value by (section, dotted path), or None when absent.
    Path components index dicts by key and lists by int (negative ok)."""
    node: Any = parsed.get(section) if section else parsed
    if node is None:
        return None
    for part in path.split("."):
        if isinstance(node, dict):
            node = node.get(part)
        elif isinstance(node, list):
            try:
                node = node[int(part)]
            except (ValueError, IndexError):
                return None
        else:
            return None
        if node is None:
            return None
    if isinstance(node, bool) or not isinstance(node, (int, float)):
        return None
    return float(node)


def pct_change(prev: float, cur: float) -> Optional[float]:
    """Signed fractional change; None on a zero baseline (a percentage
    of zero is meaningless — and an inf here would leak into rendered
    tables and strict-JSON output)."""
    if prev == 0:
        return None
    return (cur - prev) / abs(prev)


def _verdict(metric: Metric, prev: float, cur: float,
             threshold: float) -> Tuple[str, Optional[float]]:
    """(verdict, signed pct change) for a same-platform pair. Verdicts:
    improved | regressed | ok."""
    change = pct_change(prev, cur)
    if change is None:
        # zero baseline: any movement is all signal (the zero-pinned
        # metrics — compile counts, blocking syncs — have 0 noise)
        if cur == prev:
            return "ok", 0.0
        worse = (cur < prev) if metric.higher_is_better else (cur > prev)
        return ("regressed" if worse else "improved"), None
    worse = -change if metric.higher_is_better else change
    tol = max(threshold, metric.noise_frac)
    if worse > tol:
        return "regressed", change
    if -worse > tol:
        return "improved", change
    return "ok", change


def build_trends(series: Sequence[Tuple[int, str, dict]],
                 threshold: float = DEFAULT_THRESHOLD) -> dict:
    """Trend tables + gate verdicts over the artifact series. For each
    metric, the newest artifact recording it is compared against the
    newest OLDER artifact of the same platform recording it."""
    rounds = [{"round": r, "name": name, "platform": platform_of(p)}
              for r, name, p in series]
    metrics_out = []
    failures = []
    for metric in METRICS:
        values = [extract(p, metric) for _, _, p in series]
        recorded = [i for i, v in enumerate(values) if v is not None]
        row: Dict[str, Any] = {
            "section": metric.section or "headline",
            "metric": metric.path,
            "label": metric.label,
            "higher_is_better": metric.higher_is_better,
            "headline": metric.headline,
            "values": values,
        }
        if recorded:
            cur_i = recorded[-1]
            cur_plat = rounds[cur_i]["platform"]
            prev_i = next((i for i in reversed(recorded[:-1])
                           if rounds[i]["platform"] == cur_plat), None)
            prev = values[prev_i] if prev_i is not None else None
            if prev is None:
                # first recording on this platform: a baseline reset
                # (never a regression verdict across device families)
                verdict = ("platform-change" if len(recorded) > 1 else "new")
                change = None
            else:
                verdict, change = _verdict(metric, prev, values[cur_i],
                                           threshold)
            row.update({
                "latest_round": rounds[cur_i]["round"],
                "latest": values[cur_i],
                "baseline_round": (rounds[prev_i]["round"]
                                   if prev_i is not None else None),
                "baseline": prev,
                "platform": cur_plat,
                "verdict": verdict,
                "change_frac": (round(change, 4)
                                if change is not None else None),
            })
            if verdict == "regressed" and metric.headline:
                delta = (f"{abs(change) * 100:.1f}%"
                         if change is not None else "from a zero baseline")
                failures.append(
                    f"{row['section']}.{metric.path or 'value'} "
                    f"({metric.label}) regressed {delta} "
                    f"(r{rounds[prev_i]['round']:02d} {prev:g} -> "
                    f"r{rounds[cur_i]['round']:02d} {values[cur_i]:g}, "
                    f"platform {cur_plat})")
        else:
            row["verdict"] = "never-recorded"
        # a headline metric that the newest artifact STOPPED recording is
        # itself a gate failure: bench.py's sections are exception-guarded
        # (a broken run just omits the section), so without this check a
        # vanished headline figure would re-verdict the old pair and pass
        last = len(series) - 1
        same_plat = [j for j in recorded
                     if rounds[j]["platform"] == rounds[last]["platform"]]
        if metric.headline and values[last] is None and same_plat:
            row["verdict"] = "went-missing"
            failures.append(
                f"{row['section']}.{metric.path or 'value'} "
                f"({metric.label}) went missing: "
                f"r{rounds[last]['round']:02d} "
                f"[{rounds[last]['platform']}] records no value but "
                f"r{rounds[same_plat[-1]]['round']:02d} did")
        metrics_out.append(row)
    return {"rounds": rounds, "metrics": metrics_out,
            "threshold": threshold, "failures": failures,
            "ok": not failures}


def render_tables(trends: dict, out) -> None:
    rounds = trends["rounds"]
    heads = "".join(f"{'r%02d' % r['round']:>14}" for r in rounds)
    print(f"bench history: {len(rounds)} artifacts "
          f"({', '.join(r['name'] + ' [' + r['platform'] + ']' for r in rounds)})",
          file=out)
    print(f"{'metric':<38}{heads}  verdict", file=out)
    cur_section = None
    for row in trends["metrics"]:
        if row["verdict"] == "never-recorded":
            continue
        if row["section"] != cur_section:
            cur_section = row["section"]
            print(f"-- {cur_section}", file=out)
        cells = "".join(
            f"{('%g' % v if v is not None else '·'):>14}"
            for v in row["values"])
        verdict = row["verdict"]
        if row.get("change_frac") is not None:
            verdict += f" ({row['change_frac'] * 100:+.1f}%)"
        flag = " [HEADLINE]" if row["headline"] else ""
        print(f"  {row['label']:<36}{cells}  {verdict}{flag}", file=out)
    if trends["failures"]:
        print("GATE FAILURES:", file=out)
        for f in trends["failures"]:
            print(f"  {f}", file=out)
    else:
        print(f"gate: OK (threshold {trends['threshold'] * 100:.0f}% on "
              "headline metrics, same-platform baselines)", file=out)


def find_repo_root() -> Path:
    p = Path(__file__).resolve()
    for parent in p.parents:
        if (parent / "bench.py").exists() and list(parent.glob("BENCH_r*.json")):
            return parent
    raise SystemExit("repo root with BENCH_r*.json not found")


def main(argv=None, out=None) -> int:
    out = out or sys.stdout
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", type=Path, default=None,
                    help="directory holding BENCH_r*.json (default: repo root)")
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    root = args.dir or find_repo_root()
    series = load_series(root)
    if not series:
        print(f"no BENCH_r*.json under {root}", file=out)
        return 2
    trends = build_trends(series, threshold=args.threshold)
    if args.json:
        print(json.dumps(trends), file=out)
    else:
        render_tables(trends, out)
    return 0 if trends["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
