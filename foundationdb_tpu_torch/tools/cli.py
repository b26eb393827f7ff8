"""Interactive CLI over a cluster — the fdbcli analog.

Port of ``foundationdb_tpu/tools/cli.py``, every command with JAX's text.
The cluster the CLI boots recruits card resolvers by default
(TorchConflictEngine at the specs' KernelConfig, tools/fdbbackup.
engine_factory), so `perf`, `telemetry` and `heat` show a card engine's
ledger rows, device times and heat; `--engine oracle` gives JAX's oracle
resolvers and `--device cpu` runs the torch engines on the CPU. One
difference by design: `perf` renders the ledger's flops and bytes
accessed as None (a captured CUDA graph reports no cost analysis).
`lint` runs the port's own fdbtpu-lint over the port's tree
(tools/lint/).

Re-design of fdbcli/fdbcli.actor.cpp: status + the
get/set/clear/getrange transaction commands, driven against a simulated
cluster (each command spawns its coroutine and drives the deterministic
sim until it resolves — the CLI is the only wall-clock actor, exactly like
an operator at a terminal).

Run interactively:  python -m foundationdb_tpu_torch.tools.cli [--seed N] [--engine E] [--device D]
Scripted:           echo "set k v\nget k\nstatus" | python -m ...
"""
from __future__ import annotations

import json
import shlex
import sys
from typing import List, Optional

from ..core import error
from ..server.cluster import DynamicClusterConfig, build_dynamic_cluster
from .fdbbackup import ENGINE_KINDS, engine_factory

HELP = """\
commands:
  status [json]        cluster status (summary, or the full document)
  get KEY              read a key
  set KEY VALUE        write a key
  clear KEY            clear a key
  clearrange BEGIN END clear a key range
  getrange BEGIN END [LIMIT]   read a range
  shards               shard map + replica teams (from \\xff/keyServers)
  move BEGIN WORKER [WORKER...]  move the shard at BEGIN to new workers
  exclude ADDR [ADDR...]         drain all shard replicas off workers
  include ADDR [ADDR...]         re-admit excluded workers
  configure [single|double|triple] [proxies=N] [resolvers=N] [logs=N]
                       change the database configuration (applies at the
                       next recovery; replication drives DD team growth)
  telemetry [json]     resolver engine telemetry: health, perf counters,
                       abort-cause split, budget-batcher EWMAs
                       (docs/observability.md)
  telemetry read PROCESS METRIC   read a persisted \\xff/metrics/ series
  perf [json]          performance observatory: compile & memory ledger
                       (warmup/steady compile counts + durations, flops,
                       peak compiled-program HBM), the state-memory
                       gauge, and sampled measured device timing — one
                       memory/compile view per resolver
                       (docs/observability.md "Performance observatory")
  bench-history [ARGS...]  BENCH_r*.json trend tables + the noise-aware
                       regression gate (cluster-less; args pass through,
                       e.g. `bench-history --json`)
  heat [json|FILE.json]  keyspace heat & history occupancy: top hot
                       ranges, occupancy headroom, suggested equal-load
                       shard split points — live from the cluster's
                       status doc, or from a campaign report JSON
                       (real/nemesis.py --json) / bench artifact with a
                       conflict_heat section (docs/observability.md)
  sched [json|FILE.json]  conflict-aware admission (pipeline/scheduler.py):
                       predictor hot ranges, serialization lanes,
                       pre-abort / defer / reorder counters and the
                       probe-measured mispredict fraction — live from
                       the cluster status doc, or from a campaign report
                       JSON / bench artifact with a conflict_scheduling
                       section (docs/scheduling.md)
  alerts [json|FILE.json]  cluster-watchdog alert states (core/watchdog.py):
                       rule catalog, pending/firing/resolved lifecycle and
                       burn-rate values — live from the cluster status doc,
                       or cluster-less from a campaign report JSON
                       (docs/observability.md "Watchdog, burn rates &
                       incidents"; per-alert runbook in docs/operations.md)
  incidents [json|FILE.json]  machine-correlated incident timelines:
                       firing alerts grouped and matched against injected
                       fault windows, resolver health transitions and the
                       trace root cause ("p99 burn firing · overlaps
                       partition window · dominant=server_resolve")
  atlas [FILE.json]    scenario-atlas scorecards (docs/scenarios.md):
                       per-scenario SLO verdicts (p99/abort/throttle/
                       parity/incidents) + heat/abort signatures — from
                       a campaign report JSON with scenario stamps, a
                       bench artifact's scenario_atlas section, or this
                       process's scenario.* gauges
  chaos-status [FILE]  nemesis event counts from this process's telemetry
                       hub, or from a campaign report JSON written by
                       `python -m foundationdb_tpu_torch.real.nemesis --json`
  explain VERSION SRC  commit forensics (docs/observability.md "Black-box
                       journal & forensics"): reconstruct one batch
                       version's full causal arc — admission, routing
                       epoch, queue/dispatch spans, verdicts with the
                       first-witness write and ITS committing batch,
                       failover arcs, overlapping incidents and fault
                       windows — from a black-box journal directory or a
                       campaign report JSON that recorded one
  explain --slo REPORT.json   explain the worst retained-ack SLO breach
                       end-to-end (the report's slo_root_cause version)
  blackbox SRC         black-box journal summary (events by kind, version
                       range, epoch flips) for a journal dir / report
  blackbox replay --window v1..v2 SRC
                       differential replay: re-resolve the persisted
                       window through the clean serial oracle and diff
                       verdicts bit-for-bit (works across epoch flips)
  trace FILE.json      validate + summarize an exported Chrome trace
                       (a campaign's --trace-dir output)
  trace fetch ADDR [ADDR...] [OUT.json]
                       fetch live span rings over RPC (trace.spans token),
                       reconstruct per-commit waterfalls, optionally write
                       Chrome trace JSON (docs/observability.md)
  lint [ARGS...]       run fdbtpu-lint, the static invariant checker,
                       over the port's tree (--json, --rules a,b, paths)
  help                 this text
  exit                 quit
Keys/values are text; prefix with 0x for hex bytes."""


def _arg_bytes(tok: str) -> bytes:
    if tok.startswith("0x"):
        return bytes.fromhex(tok[2:])
    return tok.encode()


def _g(v) -> str:
    """A ledger total: 3 significant digits, or "None" where not measured."""
    return "None" if v is None else f"{v:.3g}"


def _fmt(b: Optional[bytes]) -> str:
    if b is None:
        return "<not found>"
    try:
        s = b.decode()
        if s.isascii() and s.isprintable():
            return f"'{s}'"
    except UnicodeDecodeError:
        pass
    return "0x" + b.hex()


class Cli:
    def __init__(self, cluster, out=None):
        self.cluster = cluster
        self.sim = cluster.sim
        self.db = cluster.new_client()
        # sys.stdout as it is at construction (JAX binds it at import)
        self.out = out if out is not None else sys.stdout

    def _drive(self, coro, timeout: float = 60.0):
        return self.sim.run_until(self.sim.sched.spawn(coro, name="cli"),
                                  until=self.sim.sched.time + timeout)

    def _print(self, s: str) -> None:
        print(s, file=self.out)

    # -- commands -------------------------------------------------------------
    def do_status(self, args: List[str]) -> None:
        doc = self._drive(self.db.get_status())
        if doc is None:
            self._print("status unavailable (no cluster controller reachable)")
            return
        if args and args[0] == "json":
            self._print(json.dumps(doc, indent=2, sort_keys=True))
            return
        c = doc["cluster"]
        self._print(f"  recovery state     - {c['recovery_state']}")
        self._print(f"  generation         - {c['generation']}")
        self._print(f"  cluster controller - {c['controller']}")
        self._print(f"  master             - {c.get('master')}")
        self._print(f"  proxies            - {', '.join(c.get('proxies', [])) or '-'}")
        if "version" in c and c["version"] is not None:
            self._print(f"  version            - {c['version']}")
        if doc.get("qos"):
            self._print(f"  tps limit          - {doc['qos'].get('transactions_per_second_limit')}")
            stale = " (STALE — no storage poll answered)" \
                if doc['qos'].get('storage_lag_stale') else ""
            self._print(f"  worst storage lag  - {doc['qos'].get('worst_storage_lag_versions')} versions{stale}")
            health = doc["qos"].get("resolver_health") or {}
            if doc["qos"].get("resolver_degraded"):
                det = ", ".join(f"{a}: {s}" for a, s in sorted(health.items()))
                self._print(f"  resolver engines   - DEGRADED ({det})")
            elif health:
                self._print(f"  resolver engines   - healthy ({len(health)})")
        for s in doc.get("storage", []):
            state = "unreachable" if s.get("unreachable") else f"v={s.get('durable_version')}"
            self._print(f"  storage tag {s['tag']}      - {s['address']} ({state})")
        for sh in doc.get("data", {}).get("shards", []):
            health = "healthy" if sh.get("healthy") else "DEGRADED"
            self._print(f"  shard [{sh['begin'] or chr(39)*2} ...)     - "
                        f"x{sh['replication']} {health}")
        hist = c.get("recovery_history", [])
        if hist:
            self._print(f"  recoveries         - {len(hist)} "
                        f"(latest generation {hist[-1][0]})")
        self._print(f"  workers            - {len(c.get('workers', {}))}")

    def do_telemetry(self, args: List[str]) -> None:
        """Unified resolver telemetry (docs/observability.md): the status
        document's qos.resolver_telemetry fragment (engine perf counters,
        budget-batcher EWMAs, health), or a persisted metric series."""
        if args and args[0] == "read":
            from ..client.metric_logger import read_metric

            process, metric = args[1], args[2]
            series = self._drive(read_metric(self.db, process, metric))
            for t, v in series:
                self._print(f"  {t:12.3f}  {v}")
            self._print(f"{len(series)} entr{'y' if len(series) == 1 else 'ies'}")
            return
        doc = self._drive(self.db.get_status())
        if doc is None:
            self._print("status unavailable (no cluster controller reachable)")
            return
        qos = doc.get("qos") or {}
        tel = qos.get("resolver_telemetry") or {}
        if args and args[0] == "json":
            self._print(json.dumps(
                {"resolver_health": qos.get("resolver_health", {}),
                 "resolver_telemetry": tel},
                indent=2, sort_keys=True))
            return
        health = qos.get("resolver_health") or {}
        if not health and not tel:
            self._print("no resolver telemetry yet (cluster still seeding?)")
            return
        for addr in sorted(set(health) | set(tel)):
            self._print(f"  resolver {addr}: {health.get(addr, '?')}")
            frag = tel.get(addr) or {}
            perf = frag.get("engine_perf")
            if perf:
                hits = ", ".join(f"{k}:{v}" for k, v in
                                 sorted(perf.get("bucket_hits", {}).items()))
                scans = ", ".join(f"{k}:{v}" for k, v in
                                  sorted(perf.get("scan_dispatches",
                                                  {}).items()))
                # warmup_ms + the compile/scan counters on the same
                # line as the bucket histogram, so one
                # glance says what was compiled, when, and what it served
                self._print(f"    engine   - compiles {perf.get('compiles')} "
                            f"(warmup {perf.get('warmup_ms', 0):.0f}ms, "
                            f"warmed {perf.get('warmed')}), "
                            f"bucket hits {{{hits}}}, scans {{{scans}}}")
                dtm = perf.get("device_time_ms") or {}
                if dtm:
                    # bucket keys are stringified ints: sort numerically
                    # or 128 renders before 64
                    sampled = ", ".join(
                        f"{k}:{v}ms" for k, v in
                        sorted(dtm.items(), key=lambda kv: int(kv[0])))
                    ns = sum((perf.get("device_time_samples") or {}).values())
                    self._print(f"    devtime  - sampled {{{sampled}}} "
                                f"({ns} samples)")
                modes = perf.get("search_mode_hits") or {}
                if modes:
                    picks = ", ".join(f"{k}:{v}" for k, v in
                                      sorted(modes.items()))
                    self._print(f"    search   - mode hits {{{picks}}}")
                dmodes = perf.get("dispatch_mode_hits") or {}
                if dmodes:
                    picks = ", ".join(f"{k}:{v}" for k, v in
                                      sorted(dmodes.items()))
                    self._print(f"    dispatch - mode hits {{{picks}}}")
                verdicts = perf.get("verdicts") or {}
                if verdicts:
                    # abort-cause split (docs/observability.md "Keyspace
                    # heat & occupancy"): aggregated, not per batch
                    split = ", ".join(f"{k}:{v}" for k, v in
                                      sorted(verdicts.items()))
                    self._print(f"    verdicts - {{{split}}}")
            b = frag.get("batcher")
            if b:
                ewma = ", ".join(f"{k}:{v}ms" for k, v in
                                 sorted(b.get("ewma_ms", {}).items()))
                disp = b.get("dispatch_mode")
                self._print(f"    batcher  - budget {b.get('budget_ms')}ms"
                            + (f", dispatch {disp}" if disp else "")
                            + f", ewma {{{ewma}}}")
            if "flight_recorder_entries" in frag:
                self._print(f"    flightrec- {frag['flight_recorder_entries']} "
                            "recent dispatch records")

    @staticmethod
    def _mib(n) -> str:
        return f"{n / (1 << 20):.1f} MiB"

    def do_perf(self, args: List[str]) -> None:
        """Performance observatory (docs/observability.md "Performance
        observatory"): the compile & memory ledger, the
        state-memory gauge and the sampled measured device timing,
        joined into one per-resolver view off the status document."""
        from ..core.knobs import SERVER_KNOBS

        doc = self._drive(self.db.get_status())
        if doc is None:
            self._print("status unavailable (no cluster controller reachable)")
            return
        tel = (doc.get("qos") or {}).get("resolver_telemetry") or {}
        if args and args[0] == "json":
            self._print(json.dumps(
                {addr: {"perf_ledger": frag.get("perf_ledger"),
                        "state_bytes": frag.get("state_bytes"),
                        "state_memory_pressure":
                            frag.get("state_memory_pressure"),
                        "device_time_ms": (frag.get("engine_perf") or {})
                            .get("device_time_ms")}
                 for addr, frag in tel.items()},
                indent=2, sort_keys=True))
            return
        rendered = 0
        limit = int(SERVER_KNOBS.resolver_state_memory_limit)
        for addr in sorted(tel):
            frag = tel.get(addr) or {}
            ledger = frag.get("perf_ledger")
            sb = frag.get("state_bytes")
            if ledger is None and sb is None:
                continue
            rendered += 1
            self._print(f"  resolver {addr}:")
            if sb is not None:
                pressure = ("PRESSURE"
                            if frag.get("state_memory_pressure") else "ok")
                line = (f"    memory   - state {self._mib(sb)} / "
                        f"limit {self._mib(limit)} ({pressure})")
                if ledger and ledger.get("peak_bytes"):
                    line += (f", peak compiled-program HBM "
                             f"{self._mib(ledger['peak_bytes'])}")
                self._print(line)
            if ledger:
                comp = ledger.get("compiles") or {}
                ms = ledger.get("compile_ms") or {}
                # a captured graph reports no cost analysis: with no row
                # carrying flops / bytes, the totals are None, not 0
                rows = ledger.get("rows") or []
                flops = (ledger.get("flops_total", 0)
                         if any(r.get("flops") is not None for r in rows) else None)
                nbytes = (ledger.get("bytes_accessed_total", 0)
                          if any(r.get("bytes_accessed") is not None for r in rows) else None)
                self._print(
                    f"    compiles - warmup {comp.get('warmup', 0)} "
                    f"({ms.get('warmup', 0):.0f}ms), "
                    f"steady {comp.get('steady', 0)} "
                    f"({ms.get('steady', 0):.0f}ms), "
                    f"flops {_g(flops)}, "
                    f"bytes {_g(nbytes)}")
                for r in (ledger.get("rows") or [])[-8:]:
                    peak = (self._mib(r["peak_bytes"])
                            if r.get("peak_bytes") else "n/a")
                    self._print(
                        f"      [{r.get('kind'):>6}] T={r.get('bucket')} "
                        f"x{r.get('n_chunks')} {r.get('search_mode')}/"
                        f"{r.get('dispatch_mode')} "
                        f"{r.get('duration_ms', 0):.0f}ms "
                        f"peak {peak}")
            dtm = (frag.get("engine_perf") or {}).get("device_time_ms") or {}
            if dtm:
                sampled = ", ".join(
                    f"{k}:{v}ms" for k, v in
                    sorted(dtm.items(), key=lambda kv: int(kv[0])))
                self._print(f"    devtime  - sampled per-bucket {{{sampled}}}")
        if not rendered:
            self._print("no perf-observatory telemetry yet (oracle engines, "
                        "or the cluster is still seeding)")

    def do_bench_history(self, args: List[str]) -> int:
        """BENCH_r*.json trend tables + regression gate (cluster-less;
        docs/observability.md "Performance observatory"). Args pass
        through to tools/bench_history.py, and the gate's exit status is
        returned so one-shot `cli bench-history` fails CI exactly like
        `make bench-history`."""
        from . import bench_history

        rc = bench_history.main(argv=list(args), out=self.out)
        if rc:
            self._print("bench-history: GATE FAILURES (see above)")
        return rc

    # -- cluster-less report loading (one path for every subcommand that
    # renders a campaign report JSON: heat, alerts, incidents, shards,
    # chaos-status, explain, blackbox) --------------------------------------
    def _report_campaigns(self, path: str):
        """(doc, [(label, campaign dict)]) for a report file; a missing
        or corrupt file prints ONE uniform error and returns (None, []).
        Campaign labels follow the `seed N [mode]` convention
        everywhere, and a field a given report never recorded (an old
        report read by a newer CLI — e.g. `blackbox`) renders as the
        caller's uniform "no X records" line, never a KeyError."""
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            self._print(f"cannot read {path}: {e}")
            return None, []
        rows = [(f"seed {rep.get('cfg_seed')} [{rep.get('engine_mode')}]",
                 rep)
                for rep in doc.get("campaigns", [])]
        return doc, rows

    def _render_campaign_field(self, path: str, fld: str, render,
                               missing_hint: str):
        """Render `render(label, value)` for every campaign carrying
        `fld`; one uniform message when none do. Returns the loaded doc
        (None on a load error)."""
        doc, rows = self._report_campaigns(path)
        if doc is None:
            return None
        rendered = 0
        for label, rep in rows:
            value = rep.get(fld)
            if value:
                render(label, value)
                rendered += 1
        if not rendered:
            self._print(f"no {fld} records in {path} ({missing_hint})")
        return doc

    def _render_heat(self, label: str, heat: dict) -> None:
        """One engine's keyspace-heat snapshot (core/heatmap.py layout)."""
        self._print(f"  {label}:")
        occ = heat.get("occupancy", 0)
        cap = heat.get("capacity", 0) or 1
        frac = heat.get("occupancy_frac", occ / cap)
        verd = heat.get("verdicts") or {}
        self._print(f"    occupancy    - {occ}/{cap} rows "
                    f"({frac * 100:.1f}%, headroom {(1 - frac) * 100:.1f}%), "
                    f"gc reclaimed {heat.get('gc_reclaimed', 0)}")
        self._print(f"    verdicts     - committed {verd.get('committed', 0)}, "
                    f"conflicts {verd.get('conflicts', 0)}, "
                    f"too_old {verd.get('too_old', 0)} "
                    f"over {heat.get('batches', 0)} batches")
        self._print(f"    concentration- {heat.get('concentration', 0):.3f} "
                    "(0 = even load, 1 = one hot range)")
        hot = heat.get("hot_ranges") or []
        if hot:
            self._print("    hot ranges   - (share of write+conflict load)")
            for r in hot:
                end = r.get("end")
                self._print(
                    f"      [{r['begin']!r:<24} .. "
                    f"{(end if end is not None else '+inf')!r:<24}) "
                    f"{r['share'] * 100:5.1f}%  w={r['writes']:.0f} "
                    f"c={r['conflicts']:.0f} r={r['reads']:.0f}")
        splits = heat.get("split_points") or []
        if splits:
            bal = heat.get("split_balance") or []
            shards = heat.get("split_shards", len(splits) + 1)
            self._print(f"    split points - {shards} equal-load shards "
                        "(ROADMAP item 1 input):")
            for s in splits:
                self._print(f"      {s!r}")
            if bal:
                self._print("    shard load   - "
                            + ", ".join(f"{f * 100:.1f}%" for f in bal))
        for a in (heat.get("recent_attribution") or [])[-4:]:
            self._print(
                f"    abort@v{a.get('version')} <- write v"
                f"{a.get('witness_version')} in [{a.get('range_begin')!r} ..)")

    def do_heat(self, args: List[str]) -> None:
        """Keyspace heat & history occupancy (docs/observability.md
        "Keyspace heat & occupancy"): hot key ranges, interval-table
        headroom and suggested equal-load shard split points — live from
        the cluster status doc's qos.resolver_telemetry fragment, or from
        a campaign report / bench JSON artifact."""
        if args and args[0].endswith(".json"):
            doc, rows = self._report_campaigns(args[0])
            if doc is None:
                return
            rendered = 0
            for label, rep in rows:
                heat = rep.get("heat")
                if heat:
                    self._render_heat(label, heat)
                    rendered += 1
            ch = (doc.get("parsed", doc)).get("conflict_heat")
            if ch:
                for row in ch.get("sweep", []):
                    if row.get("heat"):
                        self._render_heat(f"zipf s={row.get('s')}",
                                          row["heat"])
                        rendered += 1
            if not rendered:
                self._print(f"no heat snapshots in {args[0]} (campaign "
                            "engines without the layer, or an old report)")
            return
        doc = self._drive(self.db.get_status())
        if doc is None:
            self._print("status unavailable (no cluster controller reachable)")
            return
        tel = (doc.get("qos") or {}).get("resolver_telemetry") or {}
        if args and args[0] == "json":
            self._print(json.dumps(
                {addr: frag.get("heat") for addr, frag in tel.items()},
                indent=2, sort_keys=True))
            return
        rendered = 0
        for addr in sorted(tel):
            heat = (tel.get(addr) or {}).get("heat")
            if heat:
                self._render_heat(f"resolver {addr}", heat)
                rendered += 1
        if not rendered:
            self._print("no keyspace heat yet (oracle engines, "
                        "resolver_heat_buckets=0, or no traffic)")

    # -- scenario atlas (docs/scenarios.md) ---------------------------------
    def _render_atlas_campaigns(self, path: str, rows) -> int:
        """Cross-campaign scorecard table from report campaigns. Every
        campaign gets a row; fields a pre-atlas report never recorded
        (`scenario`, `signature`) render as `—`, never a KeyError."""
        self._print(f"{len(rows)} campaign(s) in {path}")
        self._print(f"  {'scenario':<18} {'seed':>5} {'mode':<11} "
                    f"{'p99ms':>8} {'abort':>6} {'thrtl':>6} {'conc':>6} "
                    f"{'parity':>9}  top range")
        stamped = 0
        for _label, rep in rows:
            name = rep.get("scenario") or "—"
            sig = rep.get("signature") or {}
            if rep.get("scenario"):
                stamped += 1
            p99 = rep.get("p99_outside_ms")
            def frac(k):
                return f"{sig[k]:.3f}" if k in sig else "—"
            top = (f"{sig['top_range']!r} ({sig.get('top_share', 0) * 100:.0f}%)"
                   if sig.get("top_range") else "—")
            self._print(
                f"  {name:<18} {rep.get('cfg_seed', 0):>5} "
                f"{str(rep.get('engine_mode')):<11} "
                f"{(f'{p99:.2f}' if isinstance(p99, (int, float)) else '—'):>8} "
                f"{frac('abort_frac'):>6} {frac('throttle_frac'):>6} "
                f"{frac('concentration'):>6} "
                f"{rep.get('parity_checked', 0):>5}/{rep.get('parity_mismatches', 0)}mm"
                f"  {top}")
        if not stamped:
            self._print("  (no scenario stamps — pre-atlas report; run "
                        "real/scenarios.py recipes to record signatures)")
        return len(rows)

    def _render_atlas_section(self, sa: dict) -> None:
        """Bench-artifact scenario_atlas section: the full scorecard."""
        self._print(f"scenario atlas — seed {sa.get('seed')} "
                    f"[{sa.get('engine_mode')}], "
                    f"{sa.get('seconds')}s per scenario, "
                    f"{'ALL GREEN' if sa.get('all_green') else 'RED'}")
        self._print(f"  {'scenario':<18} {'slo':<4} {'p99ms':>8} "
                    f"{'budget':>7} {'abort':>12} {'throttle':>12} "
                    f"{'tps':>6} {'commits':>7} {'resh':>4}")
        for row in sa.get("scorecard", []):
            p99 = row.get("p99_ms")
            self._print(
                f"  {row.get('scenario', '—'):<18} "
                f"{'ok' if row.get('slo_pass') else 'RED':<4} "
                f"{(f'{p99:.2f}' if isinstance(p99, (int, float)) else '—'):>8} "
                f"{row.get('budget_ms', 0):>7.0f} "
                f"{row.get('abort_frac', 0):>5.3f}<={row.get('max_abort_frac', 0):<5.2f} "
                f"{row.get('throttle_frac', 0):>5.3f}<={row.get('max_throttle_frac', 0):<5.2f} "
                f"{row.get('sustained_tps', 0):>6.1f} "
                f"{row.get('committed', 0):>7} "
                f"{row.get('reshards_executed', 0):>4}")

    def do_atlas(self, args: List[str]) -> None:
        """Scenario-atlas scorecards (docs/scenarios.md): per-scenario
        SLO verdicts and heat/abort signatures — cluster-less from a
        campaign report JSON (real/nemesis.py --json with scenario
        stamps) or a bench artifact with a scenario_atlas section, or
        live from this process's scenario.* telemetry gauges after an
        in-process run_scenario."""
        if args and args[0].endswith(".json"):
            doc, rows = self._report_campaigns(args[0])
            if doc is None:
                return
            rendered = 0
            if rows:
                rendered += self._render_atlas_campaigns(args[0], rows)
            sa = (doc.get("parsed", doc)).get("scenario_atlas")
            if sa and not sa.get("error"):
                self._render_atlas_section(sa)
                rendered += 1
            if not rendered:
                self._print(f"no scenario records in {args[0]} (neither "
                            "campaign reports nor a scenario_atlas "
                            "bench section)")
            return
        from ..core import telemetry

        metrics = telemetry.hub().tdmetrics.metrics
        by_scenario: dict = {}
        for name, m in metrics.items():
            if name.startswith("scenario."):
                _, scen, metric = name.split(".", 2)
                by_scenario.setdefault(scen, {})[metric] = int(
                    getattr(m, "value", 0))
        if not by_scenario:
            self._print("no scenario gauges in this process "
                        "(run real/scenarios.py run_scenario first, or "
                        "point at a report: atlas REPORT.json)")
            return
        for scen in sorted(by_scenario):
            g = by_scenario[scen]
            verdict = g.get("slo_pass")
            self._print(
                f"  {scen:<18} "
                f"{'ok' if verdict else ('RED' if verdict == 0 else '—'):<4}"
                f" p99={g.get('p99_us', -1) / 1000:.2f}ms"
                f" abort={g.get('abort_frac_x1000', 0) / 1000:.3f}"
                f" throttle={g.get('throttle_frac_x1000', 0) / 1000:.3f}"
                f" conc={g.get('concentration_x1000', 0) / 1000:.3f}"
                f" commits={g.get('committed', 0)}")

    # -- conflict-aware admission (docs/scheduling.md) ----------------------
    def _render_sched(self, label: str, snap: dict) -> None:
        """One scheduler snapshot (pipeline/scheduler.py layout)."""
        c = snap.get("counters") or {}
        self._print(f"  {label}: epoch {snap.get('epoch', -1)}, "
                    f"{c.get('ticks', 0)} ticks, "
                    f"{c.get('examined', 0)} examined")
        self._print(f"    dispatched   - {c.get('dispatched', 0)} "
                    f"(reordered {c.get('reordered', 0)}, "
                    f"forced {c.get('forced', 0)})")
        self._print(f"    deferred     - {c.get('deferred', 0)}  "
                    f"laned {c.get('laned', 0)}  "
                    f"lane_drained {c.get('lane_drained', 0)}")
        self._print(f"    pre-aborts   - {c.get('preaborts', 0)}  "
                    f"probes {c.get('probes', 0)} "
                    f"(ok {c.get('probe_ok', 0)}, "
                    f"mispredict {c.get('mispredicts', 0)}) -> "
                    f"mispredict_frac {snap.get('mispredict_frac', 0.0)}")
        lanes = snap.get("lanes") or []
        if lanes or snap.get("pending_laned"):
            self._print(f"    lanes        - {len(lanes)} open "
                        f"({c.get('lanes_opened', 0)} opened, "
                        f"{c.get('lanes_retired', 0)} retired, "
                        f"{snap.get('pending_laned', 0)} queued, "
                        f"{c.get('epoch_flips', 0)} epoch flips)")
            for lane in lanes[:6]:
                self._print(
                    f"      [{lane.get('range_begin')} ..) "
                    f"{lane.get('state'):<8} depth {lane.get('depth')} "
                    f"captured {lane.get('captured')} "
                    f"drained {lane.get('drained')} "
                    f"epoch {lane.get('epoch')}")
        pred = snap.get("predictor") or {}
        hot = pred.get("hot_ranges") or []
        if hot:
            self._print(f"    predictor    - {pred.get('tracked_ranges', 0)}"
                        " tracked, "
                        f"{pred.get('witnesses_consumed', 0)} witnesses; "
                        "hottest:")
            for r in hot:
                self._print(f"      [{r.get('range_begin')} ..) "
                            f"score {r.get('score')}")

    def _render_sched_ab(self, ab: dict) -> None:
        """A/B section a bench artifact records (conflict_scheduling)."""
        self._print("  A/B (same seed, scheduler off vs on):")
        for arm in ("off", "on"):
            row = ab.get(arm) or {}
            self._print(
                f"    {arm:<3} abort_frac {row.get('abort_frac')}  "
                f"served_tps {row.get('served_tps')}  "
                f"p99 {row.get('p99_ms')} ms  parity_mismatches "
                f"{row.get('parity_mismatches')}")
        self._print(
            f"    abort_frac_reduction "
            f"{ab.get('abort_frac_reduction')}  served_tps_ratio "
            f"{ab.get('served_tps_ratio')}  goal_met {ab.get('goal_met')}")

    def do_sched(self, args: List[str]) -> None:
        """Conflict-aware admission (docs/scheduling.md): predictor hot
        ranges, serialization lanes, pre-abort and mispredict-probe
        counters — live from the cluster status doc's
        qos.resolver_telemetry fragment, or from a campaign report /
        bench JSON artifact."""
        if args and args[0].endswith(".json"):
            doc, rows = self._report_campaigns(args[0])
            if doc is None:
                return
            rendered = 0
            for label, rep in rows:
                snap = rep.get("sched")
                if snap:
                    self._render_sched(label, snap)
                    rendered += 1
            ab = (doc.get("parsed", doc)).get("conflict_scheduling")
            if ab and isinstance(ab, dict) and "on" in ab:
                self._render_sched_ab(ab)
                rendered += 1
            if not rendered:
                self._print(f"no scheduler snapshots in {args[0]} "
                            "(resolver_sched off, or an old report)")
            return
        doc = self._drive(self.db.get_status())
        if doc is None:
            self._print("status unavailable (no cluster controller reachable)")
            return
        tel = (doc.get("qos") or {}).get("resolver_telemetry") or {}
        if args and args[0] == "json":
            self._print(json.dumps(
                {addr: frag.get("sched") for addr, frag in tel.items()},
                indent=2, sort_keys=True))
            return
        rendered = 0
        for addr in sorted(tel):
            snap = (tel.get(addr) or {}).get("sched")
            if snap:
                self._render_sched(f"resolver {addr}", snap)
                rendered += 1
        if not rendered:
            self._print("no conflict-scheduler telemetry yet "
                        "(resolver_sched knob off, or no traffic)")

    # -- cluster watchdog (docs/observability.md "Watchdog, burn rates &
    # incidents"; per-alert runbook table in docs/operations.md) ------------
    def _render_alerts(self, label: str, snap: dict) -> None:
        """One watchdog snapshot's alert table (core/watchdog.py)."""
        evals = snap.get("evaluations")
        self._print(f"  {label}: "
                    + (f"{evals} evaluations, " if evals is not None else "")
                    + f"{len(snap.get('firing') or [])} firing"
                    + (" [BURN ALERT — ratekeeper clamping]"
                       if snap.get("burn_firing") else ""))
        alerts = snap.get("alerts") or []
        if not alerts:
            self._print("    no alert states tracked yet (no matching "
                        "series under the rules)")
        for a in sorted(alerts, key=lambda a: (a["state"] == "ok",
                                               a["name"], a["series"])):
            mark = {"firing": "!!", "pending": " ~"}.get(a["state"], "  ")
            self._print(f"    {mark} {a['name']:<24} {a['state']:<8} "
                        f"{a['series']:<36} v={a['value']} "
                        f"fired x{a.get('fired_count', 0)}  {a['detail']}")

    def _render_incidents(self, label: str, incidents: list,
                          alerts_hint: Optional[list] = None) -> None:
        """One campaign's / watchdog's incident timeline."""
        if not incidents:
            self._print(f"  {label}: no incidents"
                        + ("" if alerts_hint is None else
                           f" ({len(alerts_hint)} alert states all quiet)"))
            return
        self._print(f"  {label}: {len(incidents)} incident(s)")
        for inc in incidents:
            t1 = inc.get("t1")
            span = (f"{inc.get('t0', 0):.2f}s .. "
                    + (f"{t1:.2f}s" if t1 is not None else "OPEN"))
            verdict = ("EXPLAINED" if inc.get("explained")
                       else "UNEXPLAINED")
            self._print(f"    #{inc.get('id')} [{span}] {verdict}"
                        + (f" — {inc.get('explanation')}"
                           if inc.get("explanation") else ""))
            self._print(f"       {inc.get('summary')}")
            for a in inc.get("alerts") or []:
                self._print(f"       alert {a.get('name')} "
                            f"({a.get('kind')}) {a.get('series')} "
                            f"v={a.get('value')}  {a.get('detail')}")
            for h in inc.get("health") or []:
                self._print(f"       health t={h.get('t'):.2f}s "
                            f"{h.get('label')} -> {h.get('state')}")
            rc = inc.get("root_cause")
            if rc:
                self._print(f"       root cause: dominant="
                            f"{rc.get('dominant_segment')} "
                            f"({rc.get('dominant_ms')} ms of "
                            f"{rc.get('client_ms')} ms, trace "
                            f"{rc.get('rid')})")

    def _watchdog_fragments(self, args: List[str]):
        """(label, watchdog snapshot-or-campaign dict) rows from a report
        file (cluster-less) or the live cluster status document."""
        if args and args[0].endswith(".json"):
            _doc, rows = self._report_campaigns(args[0])
            return (rows if _doc is not None else None), True
        doc = self._drive(self.db.get_status())
        if doc is None:
            self._print("status unavailable (no cluster controller reachable)")
            return None, False
        tel = (doc.get("qos") or {}).get("resolver_telemetry") or {}
        return [(f"resolver {addr}", frag.get("watchdog"))
                for addr, frag in sorted(tel.items())
                if frag.get("watchdog") is not None], False

    def do_alerts(self, args: List[str]) -> None:
        """Watchdog alert states, live (status doc watchdog fragment) or
        cluster-less over a campaign report JSON (real/nemesis.py --json
        --watchdog)."""
        rows, from_file = self._watchdog_fragments(args)
        if rows is None:
            return
        if args and args[0] == "json":
            self._print(json.dumps(
                {label: {"alerts": (frag or {}).get("alerts"),
                         "firing": (frag or {}).get("firing")}
                 for label, frag in rows},
                indent=2, sort_keys=True, default=str))
            return
        rendered = 0
        for label, frag in rows:
            if from_file:
                alerts = frag.get("alerts")
                if alerts is None:
                    continue
                snap = {"alerts": alerts,
                        "firing": [a for a in alerts
                                   if a.get("state") == "firing"]}
                self._render_alerts(label, snap)
            else:
                self._render_alerts(label, frag)
            rendered += 1
        if not rendered:
            self._print("no watchdog telemetry (watchdog_enabled off, or "
                        "campaigns run without --watchdog)")

    def do_incidents(self, args: List[str]) -> None:
        """Machine-correlated incident timelines, live or cluster-less
        over a campaign report JSON — what `make chaos-real` renders
        after its campaigns."""
        rows, from_file = self._watchdog_fragments(args)
        if rows is None:
            return
        if args and args[0] == "json":
            self._print(json.dumps(
                {label: (frag.get("incidents") if frag else None)
                 for label, frag in rows},
                indent=2, sort_keys=True, default=str))
            return
        rendered = 0
        for label, frag in rows:
            incidents = (frag or {}).get("incidents")
            if incidents is None:
                continue
            self._render_incidents(label, incidents,
                                   alerts_hint=(frag or {}).get("alerts"))
            rendered += 1
        if not rendered:
            self._print("no incident telemetry (watchdog_enabled off, or "
                        "campaigns run without --watchdog)")

    def do_chaos_status(self, args: List[str]) -> None:
        """Nemesis activity (docs/real_cluster.md): chaos.* counters + the
        recent event ring from the telemetry hub — the live view after an
        in-process campaign — or the aggregated counts of a campaign
        report file (real/nemesis.py --json)."""
        if args:
            doc, rows = self._report_campaigns(args[0])
            if doc is None:
                return
            totals: dict = {}
            campaigns = [rep for _label, rep in rows]
            for rep in campaigns:
                for kind, n in (rep.get("chaos_counts") or {}).items():
                    totals[kind] = totals.get(kind, 0) + n
            self._print(f"{len(campaigns)} campaign(s) in {args[0]}")
            if not totals:
                self._print("no nemesis events recorded")
                return
            self._print("nemesis event counts (all campaigns):")
            for kind in sorted(totals):
                self._print(f"  {kind:<18} {totals[kind]}")
            for rep in campaigns:
                eng = rep.get("engine_stats") or {}
                self._print(
                    f"  seed {rep.get('cfg_seed')} [{rep.get('engine_mode')}]"
                    f" p99_outside={rep.get('p99_outside_ms'):.3f}ms"
                    f" failovers={eng.get('failovers', 0)}"
                    f" swap_backs={eng.get('swap_backs', 0)}"
                    f" parity={rep.get('parity_checked')}"
                    f"/{rep.get('parity_mismatches')}mm")
            return
        from ..real.chaos import chaos_status_lines

        for line in chaos_status_lines():
            self._print(line)

    # -- commit forensics (docs/observability.md "Black-box journal &
    # forensics": core/blackbox.py + tools/forensics.py) --------------------
    def _forensics_rows(self, src: str):
        """[(label, events)] for a journal dir / report path, with the
        uniform operator-speakable error on anything unresolvable."""
        from . import forensics

        try:
            return forensics.load_source(src)
        except forensics.ForensicsError as e:
            self._print(str(e))
            return None

    def _explain_rows(self, rows, version: int) -> None:
        from . import forensics

        last_err = "no journal rows"
        for label, events in rows:
            try:
                info = forensics.explain(events, version)
            except forensics.ForensicsError as e:
                last_err = str(e)
                continue
            if len(rows) > 1:
                self._print(f"[{label}]")
            for line in forensics.render_explain(info):
                self._print(line)
            return
        self._print(last_err)

    def do_explain(self, args: List[str]) -> None:
        """Causal explain of one resolved batch version — admission,
        routing epoch, span segments, verdict + first witness, failover
        arc, incident/fault overlap — from a black-box journal dir or a
        campaign report JSON (`explain --slo REPORT.json` explains the
        worst retained-ack breach end to end)."""
        if not args:
            self._print("usage: explain VERSION DIR_OR_REPORT.json | "
                        "explain --slo REPORT.json")
            return
        if args[0] == "--slo":
            if len(args) < 2:
                self._print("usage: explain --slo REPORT.json")
                return
            doc, rows = self._report_campaigns(args[1])
            if doc is None:
                return
            best = None
            for label, rep in rows:
                rc = rep.get("slo_root_cause") or {}
                bb = rep.get("blackbox") or {}
                if rc.get("version") is None or not bb.get("dir"):
                    continue
                if best is None or (rc.get("client_ms") or 0) > best[2]:
                    best = (label, rep, rc.get("client_ms") or 0)
            if best is None:
                self._print(
                    f"no explainable SLO root cause in {args[1]} "
                    "(campaigns without a blackbox journal, or no "
                    "retained traces)")
                return
            label, rep, _ms = best
            rc = rep["slo_root_cause"]
            self._print(
                f"worst retained ack: {label} trace {rc.get('rid')} "
                f"v{rc.get('version')} {rc.get('client_ms')} ms "
                f"dominant={rc.get('dominant_segment')}")
            frows = self._forensics_rows(rep["blackbox"]["dir"])
            if frows is not None:
                self._explain_rows(frows, int(rc["version"]))
            return
        if len(args) < 2:
            self._print("usage: explain VERSION DIR_OR_REPORT.json")
            return
        try:
            version = int(str(args[0]).lstrip("v"))
        except ValueError:
            self._print("usage: explain VERSION DIR_OR_REPORT.json "
                        "(VERSION is a commit version, e.g. v8600)")
            return
        rows = self._forensics_rows(args[1])
        if rows is not None:
            self._explain_rows(rows, version)

    def do_blackbox(self, args: List[str]) -> None:
        """Black-box journal workflows: `blackbox SRC` summarizes what a
        journal holds; `blackbox replay --window v1..v2 SRC` slices the
        journal, re-resolves the window through the clean serial oracle
        and diffs verdicts bit-for-bit (differential replay — works on
        any persisted window, including across a reshard epoch flip)."""
        from . import forensics

        if not args:
            self._print("usage: blackbox SRC | "
                        "blackbox replay --window v1..v2 SRC")
            return
        if args[0] == "replay":
            rest = list(args[1:])
            spec = None
            if "--window" in rest:
                i = rest.index("--window")
                if i + 1 < len(rest):
                    spec = rest[i + 1]
                del rest[i:i + 2]
            if spec is None or not rest:
                self._print("usage: blackbox replay --window v1..v2 SRC")
                return
            try:
                v1, v2 = forensics.parse_window(spec)
            except (forensics.ForensicsError, ValueError) as e:
                self._print(str(e))
                return
            rows = self._forensics_rows(rest[0])
            if rows is None:
                return
            for label, events in rows:
                try:
                    r = forensics.diff_replay(events, v1, v2)
                except forensics.ForensicsError as e:
                    self._print(f"  {label}: {e}")
                    continue
                verdict = ("VERDICT-IDENTICAL" if r["mismatches"] == 0
                           else f"{r['mismatches']} MISMATCHED BATCHES")
                self._print(
                    f"  {label}: replayed {r['window_batches']} batch(es)"
                    f" in v{v1}..v{v2} (+{r['prefix_batches']} prefix) "
                    f"through the clean serial oracle — {verdict}; "
                    f"epochs {r['epochs']}, coverage "
                    f"{'ok' if r['coverage_ok'] else 'PARTIAL (rotated)'}")
                if r.get("duplicate_versions"):
                    self._print(
                        f"    WARNING: versions {r['duplicate_versions']} "
                        "recorded more than once in one stream (appended "
                        "runs in one directory?) — duplicates skipped, "
                        "not double-applied")
                for mm in r["mismatch_detail"]:
                    self._print(f"    v{mm.get('version')}: got "
                                f"{mm.get('got')} want {mm.get('want')}")
            return
        rows = self._forensics_rows(args[0])
        if rows is None:
            return
        for label, events in rows:
            for line in forensics.summarize(label, events):
                self._print(line)

    def do_recovery(self, args: List[str]) -> None:
        """Crash-stop recovery workflows (docs/fault_tolerance.md
        "Crash-stop recovery"): render the durable recovery arc — the
        snapshot cadence, the last restart's mode/coverage/replay, its
        blackout against the resolver_recovery_budget_ms knob and the
        progcache rewarm — from a black-box journal directory or a
        crash-campaign report JSON (the journaled `snapshot` /
        `recovery` events ARE the source; nothing is recomputed)."""
        from ..core.knobs import SERVER_KNOBS

        if not args:
            self._print("usage: recovery DIR_OR_REPORT.json")
            return
        rows = self._forensics_rows(args[0])
        if rows is None:
            return
        budget = float(SERVER_KNOBS.resolver_recovery_budget_ms)
        for label, events in rows:
            snaps = [e for e in events if e.kind == "snapshot"]
            recs = [e for e in events if e.kind == "recovery"]
            self._print(f"  {label}: {len(snaps)} snapshot(s), "
                        f"{len(recs)} recovery arc(s)")
            if snaps:
                s = snaps[-1].payload
                ent = "entry" if s.entries == 1 else "entries"
                self._print(
                    f"    last snapshot v{s.version} (oldest {s.oldest}, "
                    f"{s.entries} coalesced {ent}, {s.bytes} B, "
                    f"{s.ms}ms)")
            if not recs:
                self._print("    no recovery recorded (the node never "
                            "restarted into this journal)")
                continue
            r = recs[-1].payload
            cov = ("ok" if r.coverage_ok
                   else "DEGRADED (rotation ate the horizon)")
            self._print(
                f"    last recovery: mode={r.mode} coverage={cov} "
                f"snapshot v{r.snapshot_version} + {r.replayed_batches} "
                f"replayed batch(es) -> v{r.recovered_version}")
            over = "" if r.blackout_ms <= budget else "  ** OVER BUDGET **"
            self._print(
                f"    blackout {r.blackout_ms}ms (budget {budget}ms"
                f"{over}), warm {r.warm_ms}ms, progcache "
                f"{r.progcache_hits} hit(s) / {r.progcache_misses} "
                f"miss(es)")
            if r.verdict_mismatches:
                self._print(f"    ** {r.verdict_mismatches} VERDICT "
                            "MISMATCH(ES) during replay **")
            if r.error:
                self._print(f"    ** recovery error: {r.error} **")

    def do_lint(self, args: List[str]) -> int:
        """Static invariant check: run the port's fdbtpu-lint checkers over
        the port's tree — cluster-less, pure AST (never imports torch or
        jax), args pass straight through to the lint CLI. Returns the lint
        exit status so one-shot `cli lint` fails CI exactly like
        `python -m foundationdb_tpu_torch.tools.lint` does."""
        from .lint import CHECKERS
        from .lint.core import main as lint_main

        rc = lint_main(CHECKERS, argv=list(args), out=self.out)
        if rc:
            self._print("lint: FINDINGS (see above)")
        return rc

    def do_trace(self, args: List[str]) -> None:
        """Distributed-trace workflows (docs/observability.md "Distributed
        tracing"): validate+summarize an exported Chrome trace JSON, or
        fetch live span rings over the `trace.spans` RPC token and
        reconstruct cross-process per-commit waterfalls."""
        import asyncio

        from . import trace_export as tx

        if not args:
            self._print("usage: trace FILE.json | "
                        "trace fetch ADDR [ADDR...] [OUT.json]")
            return
        if args[0] == "fetch":
            addrs = [a for a in args[1:] if ":" in a]
            out = next((a for a in args[1:] if a.endswith(".json")), None)
            if not addrs:
                self._print("trace fetch: need at least one HOST:PORT")
                return
            spans = asyncio.run(tx.fetch_spans(addrs))
            waterfalls = tx.build_waterfalls(spans)
            retained = tx.tail_sample(waterfalls)
            self._print(f"{len(spans)} spans from {len(addrs)} process(es); "
                        f"{len(waterfalls)} waterfalls, "
                        f"{len(retained)} retained by tail sampling")
            for w in retained[:20]:
                path = (f"{w.get('proc_client') or '?'} -> "
                        f"{w.get('proc_server') or 'UNREACHED'}")
                err = f" err={w['err']}" if w["err"] else ""
                self._print(
                    f"  {str(w['rid']):<16} v={w['version']} "
                    f"{w['client_ms']:>9.3f}ms "
                    f"dominant={w['dominant_segment']}{err}  [{path}]")
            if out is not None:
                doc = tx.chrome_trace(tx.spans_for_traces(spans, retained))
                with open(out, "w") as f:
                    json.dump(doc, f, default=str)
                self._print(f"chrome trace -> {out}")
            return
        with open(args[0]) as f:
            doc = json.load(f)
        n = tx.validate_chrome_trace(doc)
        events = doc.get("traceEvents", [])
        # args is optional per the trace-event format: a metadata event
        # without it is valid, it just leaves the pid unnamed
        procs = {ev["pid"]: ev.get("args", {}).get("name", str(ev["pid"]))
                 for ev in events if ev.get("ph") == "M"
                 and ev.get("name") == "process_name"}
        per_proc: dict = {}
        for ev in events:
            if ev.get("ph") == "X":
                name = procs.get(ev["pid"], str(ev["pid"]))
                per_proc[name] = per_proc.get(name, 0) + 1
        self._print(f"{args[0]}: valid Chrome trace, {n} duration events "
                    f"across {len(procs)} process(es)")
        for name in sorted(per_proc):
            self._print(f"  {name:<24} {per_proc[name]} events")
        slowest = sorted((ev for ev in events if ev.get("ph") == "X"
                          and ev.get("cat") == "span"),
                         key=lambda e: -e.get("dur", 0))[:5]
        if slowest:
            self._print("slowest spans:")
            for ev in slowest:
                ev_args = ev.get("args") or {}
                self._print(f"  {ev['name']:<24} {ev['dur'] / 1e3:>9.3f}ms "
                            f"trace={ev_args.get('Trace')}")

    def do_get(self, args: List[str]) -> None:
        (key,) = args

        async def go(tr):
            return await tr.get(_arg_bytes(key))

        self._print(f"`{key}' is {_fmt(self._drive(self.db.run(go)))}")

    def do_set(self, args: List[str]) -> None:
        key, value = args

        async def go(tr):
            tr.set(_arg_bytes(key), _arg_bytes(value))

        self._drive(self.db.run(go))
        self._print("committed")

    def do_clear(self, args: List[str]) -> None:
        (key,) = args

        async def go(tr):
            tr.clear(_arg_bytes(key))

        self._drive(self.db.run(go))
        self._print("committed")

    def do_clearrange(self, args: List[str]) -> None:
        begin, end = args

        async def go(tr):
            tr.clear_range(_arg_bytes(begin), _arg_bytes(end))

        self._drive(self.db.run(go))
        self._print("committed")

    def do_getrange(self, args: List[str]) -> None:
        begin, end = args[0], args[1]
        limit = int(args[2]) if len(args) > 2 else 25

        async def go(tr):
            return await tr.get_range(_arg_bytes(begin), _arg_bytes(end), limit=limit)

        rows = self._drive(self.db.run(go))
        for k, v in rows:
            self._print(f"  {_fmt(k)} -> {_fmt(v)}")
        self._print(f"{len(rows)} row(s)")

    def _render_reshard(self, label: str, rs: dict) -> None:
        """One campaign's online-resharding record (server/reshard.py
        ReshardController.snapshot layout)."""
        sm = rs.get("shard_map") or {}
        self._print(f"  {label}: epoch {sm.get('epoch', rs.get('epoch'))}, "
                    f"{sm.get('n_shards', '?')} shard(s), "
                    f"{rs.get('executed', 0)} reshard(s) executed, "
                    f"{rs.get('stalled', 0)} stalled")
        splits = sm.get("splits") or []
        begins = ["''"] + [repr(s) for s in splits]
        for i, b in enumerate(begins):
            e = begins[i + 1] if i + 1 < len(begins) else "+inf"
            self._print(f"    shard {i}: [{b} .. {e})")
        # mesh-backed slots: device placement per shard (absent in
        # pre-mesh reports and single-chip engine modes — render nothing)
        dview = rs.get("device_view") or []
        if dview:
            self._print("    device placement:")
            for row in dview:
                ms = row.get("last_collective_ms")
                self._print(
                    f"      slot {row.get('sid')} shard {row.get('shard')}"
                    f" -> {row.get('platform', '?')}:{row.get('device')}"
                    f"  [{row.get('span_begin', '')!r} ...)"
                    f"  table {row.get('table_bytes', 0)} B"
                    + (f"  exchange {ms:.3f} ms" if ms else ""))
        hist = sm.get("history") or []
        if len(hist) > 1:
            self._print("    epoch history:")
            for h in hist:
                self._print(f"      epoch {h.get('epoch')} @ v"
                            f"{h.get('flip_version')}: "
                            f"{len(h.get('splits') or []) + 1} shard(s)")
        ops = rs.get("ops") or []
        if ops:
            self._print(f"    blackout budget {rs.get('blackout_budget_ms')}"
                        f" ms, worst {rs.get('blackout_ms_max')} ms, "
                        f"{rs.get('blackout_over_budget', 0)} over")
            for op in ops:
                end = op.get("end") if op.get("end") is not None else "+inf"
                self._print(
                    f"    #{op.get('id')} {op.get('kind'):<5} "
                    f"[{op.get('begin')!r} .. {end!r}) {op.get('state'):<8}"
                    f" blackout={op.get('blackout_ms', 0):.2f}ms"
                    f" precopy={op.get('precopied')} delta={op.get('delta')}"
                    + (" (prewarmed)" if op.get("prewarmed") else "")
                    + (f" ERR {op.get('error')}" if op.get("error") else ""))
        inflight = rs.get("in_flight")
        if inflight:
            self._print(f"    IN FLIGHT: #{inflight.get('id')} "
                        f"{inflight.get('kind')} state="
                        f"{inflight.get('state')}")

    def do_shards(self, args: List[str]) -> None:
        """Resolver epoch/shard map + executed reshards from a campaign
        report JSON (cluster-less, like `heat`), or the storage shard map
        of the live simulated cluster."""
        if args and args[0].endswith(".json"):
            self._render_campaign_field(
                args[0], "reshard", self._render_reshard,
                "campaigns run without --drift / reshard=True?")
            return
        from ..server import system_keys

        async def go(tr):
            return await tr.get_range(system_keys.KEY_SERVERS_PREFIX,
                                      system_keys.KEY_SERVERS_PREFIX + b"\xff")

        rows = self._drive(self.db.run(go))
        if not rows:
            self._print("no shard metadata (cluster still seeding?)")
            return
        for k, v in rows:
            begin = system_keys.shard_begin_of(k)
            team, extra = system_keys.decode_key_servers(v)
            label = _fmt(begin) if begin else "''"
            dests = ", ".join(f"tag {t} @ {a}" for t, a in team)
            moving = f"  (moving: +tags {list(extra)})" if extra else ""
            self._print(f"  [{label} ...) -> {dests}{moving}")

    def _find_master_ep(self, token_prefix: str):
        from ..sim.network import Endpoint

        for p in self.cluster.worker_procs:
            for tok in p.handlers:
                if tok.startswith(token_prefix):
                    return Endpoint(p.address, tok)
        return None

    def do_move(self, args: List[str]) -> None:
        from ..server.masterserver import MOVE_SHARD_TOKEN, MoveShardRequest
        from ..sim.loop import TaskPriority

        begin, dests = _arg_bytes(args[0]) if args[0] != "''" else b"", args[1:]
        ep = self._find_master_ep(MOVE_SHARD_TOKEN)
        if ep is None:
            self._print("no master reachable")
            return

        async def go():
            return await self.sim.net.request(
                self.db.client_addr, ep,
                MoveShardRequest(begin=begin, dest_workers=list(dests)),
                TaskPriority.MOVE_KEYS, timeout=120.0,
            )

        reply = self._drive(go(), timeout=240.0)
        self._print(f"moved shard at {_fmt(begin) if begin else chr(39)*2}: "
                    f"new team {reply['team']}")

    def _exclude_cmd(self, addrs: List[str], exclude: bool) -> None:
        from ..server.masterserver import EXCLUDE_TOKEN, ExcludeServersRequest
        from ..sim.loop import TaskPriority

        if not addrs:
            raise ValueError("need at least one address")
        ep = self._find_master_ep(EXCLUDE_TOKEN)
        if ep is None:
            self._print("no master reachable")
            return

        async def go():
            return await self.sim.net.request(
                self.db.client_addr, ep,
                ExcludeServersRequest(addresses=list(addrs), exclude=exclude),
                TaskPriority.MOVE_KEYS, timeout=240.0,
            )

        reply = self._drive(go(), timeout=480.0)
        verb = "excluded" if exclude else "included"
        self._print(f"{verb}: now excluding {reply['excluded'] or 'nothing'}"
                    + (f"; moved shards {reply['moved']}" if reply.get("moved") else ""))

    def do_configure(self, args: List[str]) -> None:
        from ..server.management import REDUNDANCY_MODES, change_configuration

        if not args:
            raise ValueError("configure what?")
        mode = None
        counts = {}
        for tok in args:
            if tok in REDUNDANCY_MODES:
                mode = tok
            elif "=" in tok:
                k, v = tok.split("=", 1)
                counts[k] = int(v)
            else:
                raise ValueError(f"bad configure token {tok!r}")
        self._drive(change_configuration(self.db, mode=mode, **counts),
                    timeout=120.0)
        self._print("configuration committed (applies at the next recovery)")

    def do_exclude(self, args: List[str]) -> None:
        self._exclude_cmd(args, exclude=True)

    def do_include(self, args: List[str]) -> None:
        self._exclude_cmd(args, exclude=False)

    # -- loop -----------------------------------------------------------------
    def run_command(self, line: str) -> bool:
        """Returns False on exit. Errors print, never crash the shell."""
        try:
            parts = shlex.split(line)
        except ValueError as e:
            self._print(f"parse error: {e}")
            return True
        if not parts:
            return True
        cmd, args = parts[0].lower().replace("-", "_"), parts[1:]
        if cmd in ("exit", "quit"):
            return False
        if cmd == "help":
            self._print(HELP)
            return True
        fn = getattr(self, f"do_{cmd}", None)
        if fn is None:
            self._print(f"unknown command `{cmd}' (try help)")
            return True
        try:
            fn(args)
        except (ValueError, TypeError, IndexError):
            self._print(f"usage error (try help)")
        except error.FDBError as e:
            self._print(f"error: {e}")
        return True

    def repl(self, stream=sys.stdin) -> None:
        interactive = stream.isatty()
        while True:
            if interactive:
                print("fdb> ", end="", flush=True)
            line = stream.readline()
            if not line:
                break
            if not self.run_command(line.strip()):
                break


def main(argv=None) -> int:
    import argparse

    raw = list(sys.argv[1:] if argv is None else argv)
    if raw and raw[0].replace("-", "_") == "lint":
        # before argparse: lint owns its own flags (--json, --rules, ...)
        # and never needs a cluster
        cli = Cli.__new__(Cli)
        cli.out = sys.stdout
        return cli.do_lint(raw[1:])
    if raw and raw[0].replace("-", "_") == "bench_history":
        # same pre-argparse pass-through: the trend gate owns its flags
        # (--json, --threshold, --dir) and reads artifacts, not a cluster
        cli = Cli.__new__(Cli)
        cli.out = sys.stdout
        return cli.do_bench_history(raw[1:])
    if raw and raw[0].replace("-", "_") in ("explain", "blackbox",
                                            "recovery"):
        # pre-argparse pass-through: forensics owns its own flags
        # (--slo, --window) and reads journals/reports, never a cluster
        cli = Cli.__new__(Cli)
        cli.out = sys.stdout
        if raw[0].replace("-", "_") == "explain":
            cli.do_explain(raw[1:])
        elif raw[0].replace("-", "_") == "recovery":
            cli.do_recovery(raw[1:])
        else:
            cli.do_blackbox(raw[1:])
        return 0

    ap = argparse.ArgumentParser(description="cli over a simulated cluster")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="torch", choices=ENGINE_KINDS,
                    help="the cluster's resolver engines (oracle: the JAX tool's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the card engines (cpu to run them on the CPU)")
    ap.add_argument("command", nargs="*", default=[],
                    help="run one command and exit (e.g. "
                         "`chaos-status reports.json`, `status`)")
    args = ap.parse_args(argv)
    cmd0 = args.command[0].replace("-", "_") if args.command else ""
    if cmd0 in ("chaos_status", "trace", "atlas") or (
            cmd0 in ("heat", "sched", "alerts", "incidents", "shards")
            and len(args.command) > 1
            and args.command[1].endswith(".json")):
        # no cluster needed: renders the hub / a report, trace or heat
        # artifact file / a live span-ring fetch over RPC / campaign
        # alert+incident timelines
        cli = Cli.__new__(Cli)
        cli.out = sys.stdout
        if cmd0 == "chaos_status":
            cli.do_chaos_status(args.command[1:])
        elif cmd0 == "atlas":
            cli.do_atlas(args.command[1:])
        elif cmd0 == "heat":
            cli.do_heat(args.command[1:])
        elif cmd0 == "sched":
            cli.do_sched(args.command[1:])
        elif cmd0 == "alerts":
            cli.do_alerts(args.command[1:])
        elif cmd0 == "incidents":
            cli.do_incidents(args.command[1:])
        elif cmd0 == "shards":
            cli.do_shards(args.command[1:])
        else:
            cli.do_trace(args.command[1:])
        return 0
    cluster = build_dynamic_cluster(seed=args.seed, cfg=DynamicClusterConfig(
        engine_factory=engine_factory(args.engine, args.device)))
    if args.command:
        # one-shot mode: boot, run the single command, exit
        cli = Cli(cluster)
        cli.sim.run(until=3.0)
        cli.run_command(shlex.join(args.command))
        return 0
    cli = Cli(cluster)
    cli.sim.run(until=3.0)   # let the cluster bootstrap
    print("connected to simulated cluster (seed %d); `help' for commands" % args.seed)
    cli.repl()
    return 0


if __name__ == "__main__":
    sys.exit(main())
